// Serving attention with an additive relative-position bias (the windowed
// attention of the segmentation backbone):
//     out = core(qkv, bias)   qkv [B, N, 3C] bf16, bias [H, N, N] bf16
// and, further down, the max-subtracted softmax attention of K13 and K14 on
// the same block shape and key-tile ring (mha_softmax_kernel).
//
// Replaces the TPU kernel dynamic_tuning_tpu/ops/mha_serving.py::
// mha_windowed_fused (_mha_windowed_kernel).  Per query row of each head:
//   q' = bf16(q * scale);  s = q' . k (fp32) + fp32(bias)
//   e = exp(clip(s, -60, 80) - 20);  l = sum(e) in fp32
//   o = (bf16(e) @ v in fp32) * (1 / l) -> bf16
//
// What bounds it on an H100.  At the segmentation path's shape (B = 1,
// N = 1025, 12 heads of 64) the bias is the largest operand: 12 * 1025^2 *
// 2 B = 25.2 MB, shared over the batch, against 6.3 MB of qkv and 1.6 MB of
// output -- ~10 us at 3.35 TB/s.  The products are 4 * N^2 * hd * H =
// 3.2 GFLOP, ~3.3 us at the bf16 peak.  So at batch 1 the kernel is
// byte-bound on paper; with mma.sync (no wgmma yet) and one N^2 expf per
// head it is the products and the exp that take the time in practice.
//
// What the design does about it.  At N = 1025 a head's K and V (2 * 1040 *
// 72 * 2 B = 300 KB with the bank skew) do not fit the 227 KB a block may
// use, so unlike attn_core_kernel (attention_sublayer.cu) K and V are not
// held whole: each block owns 64 query rows of one (sample, head) and walks
// the keys in tiles of 64, staging the K tile, the V tile and the matching
// 64 x 64 bias tile through a two-stage cp.async ring (55 KB at hd = 64),
// so the next tile's bytes are in flight while the warps compute on this
// one.  The serving softmax has no row max, so each key chunk is final when
// it is computed: no rescaling, scores and probabilities stay in registers.
// The bias tile is read once per (query tile, head) from device memory with
// 16-byte copies, so its rows must start on 16 bytes: the wrapper passes a
// bias whose row stride is a multiple of 8 elements (the layer builds it
// padded that way).  The grid runs the batch fastest, so the blocks that
// share a bias tile run side by side and the second reads it from L2.
// 64-row query tiles give 17 x 12 = 204 blocks at B = 1 on 132 SMs
// (128-row tiles would give 108, fewer than the SMs); four such blocks fit
// an SM (55 KB of shared memory, 126 registers a thread at hd = 64).
#include "common.cuh"

namespace dyt {

constexpr int WIN_WARPS = 4;                  // 16 query rows per warp
constexpr int WIN_ROWS = WIN_WARPS * 16;      // query rows per block
constexpr int WIN_KEYS = 64;                  // keys per staged tile

template <int HD>
struct WinLayout {
  static constexpr int LDK = HD + 8;          // K/V row stride (bank skew)
  static constexpr int LDB = WIN_KEYS + 8;    // bias row stride
  static constexpr int KV = WIN_KEYS * LDK;   // elements of a K or V tile
  static constexpr int BIAS = WIN_ROWS * LDB;
  static constexpr int STAGE = 2 * KV + BIAS;
  static constexpr int SMEM = 2 * STAGE * 2;  // two stages, in bytes
};

// Block (b, query tile, h): thread (g = lane/4, t = lane%4) of warp w holds
// query rows w*16 + g and w*16 + g + 8 of the tile in every accumulator.
template <int HD>
__global__ void __launch_bounds__(WIN_WARPS * 32)
mha_windowed_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                    bf16* __restrict__ out, int N, int H,
                    long long bias_head_stride, int bias_row_stride,
                    float scale) {
  using L = WinLayout<HD>;
  constexpr int CPR = HD / 8;    // 16-byte chunks per head row
  constexpr int DK = HD / 16;    // k16 steps of Q K^T
  constexpr int OT = HD / 8;     // n8 tiles of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int b = blockIdx.x, q0 = blockIdx.y * WIN_ROWS, h = blockIdx.z;
  const int C = H * HD, C3 = 3 * C;
  const bf16* base = qkv + (size_t)b * N * C3;
  const bf16* bh = bias + (size_t)h * bias_head_stride;
  const int tid = threadIdx.x;

  // K and V rows k0..k0+63 of head h and the bias block [q0.., k0..]; rows
  // past N are zero-filled.  A bias chunk that starts before N may run past
  // it into the row's padding (the wrapper guarantees the row stride
  // covers it); those columns are masked below.
  auto load_tile = [&](int stage, int k0) {
    bf16* Ks = smem + stage * L::STAGE;
    bf16* Vs = Ks + L::KV;
    bf16* Bs = Vs + L::KV;
    for (int i = tid; i < WIN_KEYS * CPR; i += WIN_WARPS * 32) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const bool ok = k0 + r < N;
      const bf16* row = base + (size_t)(ok ? k0 + r : 0) * C3 + h * HD + c;
      cp_async16(Ks + r * L::LDK + c, row + C, ok ? 16 : 0);
      cp_async16(Vs + r * L::LDK + c, row + 2 * C, ok ? 16 : 0);
    }
    for (int i = tid; i < WIN_ROWS * (WIN_KEYS / 8); i += WIN_WARPS * 32) {
      const int r = i / (WIN_KEYS / 8), c = (i % (WIN_KEYS / 8)) * 8;
      const bool ok = q0 + r < N && k0 + c < N;
      const bf16* src =
          ok ? bh + (size_t)(q0 + r) * bias_row_stride + k0 + c : bh;
      cp_async16(Bs + r * L::LDB + c, src, ok ? 16 : 0);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  // ldmatrix row addresses as in attn_core_kernel: K as the col-major B of
  // Q K^T, V transposed for P V
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = lane & 15, v_col = (lane >> 4) * 8;
  const int r_lo = warp * 16 + g;               // row within the block tile
  const int n_lo = q0 + r_lo, n_hi = n_lo + 8;

  // q rows scaled in fp32 and rounded to bf16 before Q K^T, loaded straight
  // into the A-operand layout
  unsigned qf[DK][4];
#pragma unroll
  for (int d = 0; d < DK; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = (e & 1) ? n_hi : n_lo;
      const int col = d * 16 + t2 + (e >> 1) * 8;
      float2 q = make_float2(0.f, 0.f);
      if (n < N) q = load2(base + (size_t)n * C3 + h * HD + col);
      qf[d][e] = pack_bf16x2(q.x * scale, q.y * scale);
    }
  }
  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float l_lo = 0.f, l_hi = 0.f;

  const int ntiles = (N + WIN_KEYS - 1) / WIN_KEYS;
  load_tile(0, 0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();      // tile t has landed ...
    __syncthreads();         // ... and every warp is done with tile t - 1
    if (t + 1 < ntiles) load_tile((t + 1) & 1, (t + 1) * WIN_KEYS);
    cp_async_commit();
    const bf16* Ks = smem + (t & 1) * L::STAGE;
    const bf16* Vs = Ks + L::KV;
    const bf16* Bs = Vs + L::KV;
    const int k0 = t * WIN_KEYS;

#pragma unroll
    for (int kc = 0; kc < WIN_KEYS / 16; ++kc) {
      if (k0 + kc * 16 >= N) break;          // the same for every warp
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        unsigned r[4];
        ldmatrix_x4(r, Ks + (kc * 16 + k_row) * L::LDK + d * 16 + k_col);
        mma_bf16_16816(s[0], qf[d], r[0], r[1]);
        mma_bf16_16816(s[1], qf[d], r[2], r[3]);
      }
      // s + bias, then e = exp(clip(s, -60, 80) - 20); padded keys add 0
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int cb = kc * 16 + j * 8 + t2;       // column in the tile
        const float2 b_lo = load2(Bs + r_lo * L::LDB + cb);
        const float2 b_hi = load2(Bs + (r_lo + 8) * L::LDB + cb);
        const float bv[4] = {b_lo.x, b_lo.y, b_hi.x, b_hi.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + cb + (e & 1);
          s[j][e] = col < N
              ? expf(fminf(fmaxf(s[j][e] + bv[e], -60.f), 80.f) - 20.f)
              : 0.f;
        }
        l_lo += s[j][0] + s[j][1];     // l sums the fp32 e, not bf16(e)
        l_hi += s[j][2] + s[j][3];
      }
      const unsigned pf[4] = {pack_bf16x2(s[0][0], s[0][1]),
                              pack_bf16x2(s[0][2], s[0][3]),
                              pack_bf16x2(s[1][0], s[1][1]),
                              pack_bf16x2(s[1][2], s[1][3])};
#pragma unroll
      for (int j = 0; j < OT; j += 2) {
        unsigned r[4];
        ldmatrix_x4_trans(r, Vs + (kc * 16 + v_row) * L::LDK + j * 8 + v_col);
        mma_bf16_16816(o[j], pf, r[0], r[1]);
        mma_bf16_16816(o[j + 1], pf, r[2], r[3]);
      }
    }
  }

  // each row's l is spread over the four lanes of its quad
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, m);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, m);
  }
  const float inv_lo = 1.0f / l_lo, inv_hi = 1.0f / l_hi;
#pragma unroll
  for (int j = 0; j < OT; ++j) {
    const int col = h * HD + j * 8 + t2;
    if (n_lo < N)
      store2(out + ((size_t)b * N + n_lo) * C + col, o[j][0] * inv_lo,
             o[j][1] * inv_lo);
    if (n_hi < N)
      store2(out + ((size_t)b * N + n_hi) * C + col, o[j][2] * inv_hi,
             o[j][3] * inv_hi);
  }
}

template <int HD>
static cudaError_t launch_windowed(const bf16* qkv, const bf16* bias,
                                   bf16* out, int B, int N, int H,
                                   long long head_stride, int row_stride,
                                   float scale, cudaStream_t s) {
  constexpr int smem = WinLayout<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      mha_windowed_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (N + WIN_ROWS - 1) / WIN_ROWS, H);
  mha_windowed_kernel<HD><<<grid, WIN_WARPS * 32, smem, s>>>(
      qkv, bias, out, N, H, head_stride, row_stride, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Max-subtracted softmax attention with an optional fp32 [H, N, N] bias:
// TPU kernels flash_attention (K13, dynamic_tuning_tpu/ops/
// flash_attention.py::_kernel and _kernel_per_head: [B, H, N, D] q, k, v)
// and packed_attention (K14, dynamic_tuning_tpu/ops/packed_attention.py::
// _kernel: the raw [B, N, 3C] qkv buffer), per query row of each head:
//   s = f32(bf16(q) . bf16(k)) * scale (+ bias);  keys >= N never visited
//   m = max(s);  l = sum(exp(s - m));  p = bf16(exp(s - m) / l)
//   o = f32(p @ bf16(v)) -> the input dtype
// The TPU kernels pad N to 128 or 256 and mask the padded keys to -inf; here
// the key loop ends at N.  The row max must be known before any p is
// rounded (the reference normalises p before its bf16 rounding), so a
// one-pass flash rescale of the output would round other p: the block walks
// the key tiles twice, first for m and l (l rescaled online in fp32), then
// for p and P V.
//
// What bounds it.  At K13's main shape (B=128, N=197, 12 heads of 64, bf16)
// it moves 4 * 128 * 12 * 197 * 64 * 2 B = 155 MB (0.046 ms) for 15.3
// GFLOP of products (0.015 ms); the second pass recomputes Q K^T and the
// exp, so the work is 1.5x the products and 2x the exps of one pass.  At
// B=1, N=1025 with the bias, the fp32 bias (50 MB) is the largest operand
// and is read in both passes.  The design: K9's block shape (64 query rows
// of one (sample, head), 64-key K and V tiles through a two-stage ring; the
// ring runs on across the two passes, the first of which stages K only);
// the bias is read from device memory by each thread for its own scores
// (its rows start on 4-byte boundaries at odd N); fp32 q, k, v are read with
// 16-byte loads and rounded to bf16 on their way into shared memory.

struct SoftmaxArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const float* bias;          // null: no bias
  long long sq[3], sk[3], sv[3], so[3];
  long long bias_head_stride, bias_row_stride;
  int N, H;
  float scale;
};

// 8 consecutive elements of a K or V row into shared memory as bf16; rows
// past N are zero-filled (``src`` is then any valid row).
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src, bool ok) {
  cp_async16(dst, src, ok ? 16 : 0);
}
__device__ __forceinline__ void stage8(bf16* dst, const float* src, bool ok) {
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (ok) load8(src, v);
  store8(dst, v);
}

template <int HD, typename TI>
__global__ void __launch_bounds__(WIN_WARPS * 32)
mha_softmax_kernel(const SoftmaxArgs a) {
  using L = WinLayout<HD>;       // its K and V tiles; no bias tile
  constexpr int CPR = HD / 8;    // 8-element chunks per head row
  constexpr int DK = HD / 16;    // k16 steps of Q K^T
  constexpr int OT = HD / 8;     // n8 tiles of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int b = blockIdx.x, q0 = blockIdx.y * WIN_ROWS, h = blockIdx.z;
  const int N = a.N, tid = threadIdx.x;
  const TI* qb = static_cast<const TI*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const TI* kb = static_cast<const TI*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const TI* vb = static_cast<const TI*>(a.v) + b * a.sv[0] + h * a.sv[1];
  TI* ob = static_cast<TI*>(a.o) + b * a.so[0] + h * a.so[1];

  // K rows k0..k0+63 of head h, and V's with ``with_v``
  auto load_tile = [&](int stage, int k0, bool with_v) {
    bf16* Ks = smem + stage * 2 * L::KV;
    bf16* Vs = Ks + L::KV;
    for (int i = tid; i < WIN_KEYS * CPR; i += WIN_WARPS * 32) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const bool ok = k0 + r < N;
      const long long n = ok ? k0 + r : 0;
      stage8(Ks + r * L::LDK + c, kb + n * a.sk[2] + c, ok);
      if (with_v) stage8(Vs + r * L::LDK + c, vb + n * a.sv[2] + c, ok);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = lane & 15, v_col = (lane >> 4) * 8;
  const int n_lo = q0 + warp * 16 + g, n_hi = n_lo + 8;
  const float* bias_lo = a.bias == nullptr || n_lo >= N ? nullptr
      : a.bias + h * a.bias_head_stride + n_lo * a.bias_row_stride;
  const float* bias_hi = a.bias == nullptr || n_hi >= N ? nullptr
      : a.bias + h * a.bias_head_stride + n_hi * a.bias_row_stride;

  // q rows rounded to bf16 (unscaled: the scale multiplies the fp32
  // product), loaded straight into the A-operand layout
  unsigned qf[DK][4];
#pragma unroll
  for (int d = 0; d < DK; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = (e & 1) ? n_hi : n_lo;
      const int col = d * 16 + t2 + (e >> 1) * 8;
      float2 q = make_float2(0.f, 0.f);
      if (n < N) q = load2(qb + n * a.sq[2] + col);
      qf[d][e] = pack_bf16x2(q.x, q.y);
    }
  }

  // the scores of one 16-key chunk: s[j][e] is key col(j, e) of row lo
  // (e < 2) or hi; keys past N come out as -inf
  auto scores = [&](const bf16* Ks, int kc, int k0, float (&s)[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int d = 0; d < DK; ++d) {
      unsigned r[4];
      ldmatrix_x4(r, Ks + (kc * 16 + k_row) * L::LDK + d * 16 + k_col);
      mma_bf16_16816(s[0], qf[d], r[0], r[1]);
      mma_bf16_16816(s[1], qf[d], r[2], r[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + kc * 16 + j * 8 + t2 + (e & 1);
        const float* br = e < 2 ? bias_lo : bias_hi;
        float v = mul(s[j][e], a.scale);
        if (br != nullptr && col < N) v = add(v, __ldg(br + col));
        s[j][e] = col < N ? v : -INFINITY;
      }
    }
  };

  // exp(s - m) of a score, 0 for a key past N (s = -inf, perhaps m too)
  auto exp_past = [](float sv, float m) {
    return sv == -INFINITY ? 0.f : expf(sub(sv, m));
  };
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  const int ntiles = (N + WIN_KEYS - 1) / WIN_KEYS;
  load_tile(0, 0, false);
  cp_async_commit();
  for (int t = 0; t < 2 * ntiles; ++t) {
    const bool second = t >= ntiles;
    cp_async_wait<0>();      // step t's tile has landed ...
    __syncthreads();         // ... and every warp is done with step t - 1
    if (t + 1 < 2 * ntiles) {
      const bool nxt_second = t + 1 >= ntiles;
      load_tile((t + 1) & 1, ((t + 1) % ntiles) * WIN_KEYS, nxt_second);
    }
    cp_async_commit();
    if (t == ntiles) {
      // the first pass is done: each row's (m, l) from its quad's four
      // lanes, l rescaled to the common max
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        const float om_lo = __shfl_xor_sync(0xffffffffu, m_lo, sh);
        const float ol_lo = __shfl_xor_sync(0xffffffffu, l_lo, sh);
        const float om_hi = __shfl_xor_sync(0xffffffffu, m_hi, sh);
        const float ol_hi = __shfl_xor_sync(0xffffffffu, l_hi, sh);
        const float nm_lo = fmaxf(m_lo, om_lo), nm_hi = fmaxf(m_hi, om_hi);
        l_lo = add(mul(l_lo, expf(sub(m_lo, nm_lo))),
                   mul(ol_lo, expf(sub(om_lo, nm_lo))));
        l_hi = add(mul(l_hi, expf(sub(m_hi, nm_hi))),
                   mul(ol_hi, expf(sub(om_hi, nm_hi))));
        m_lo = nm_lo;
        m_hi = nm_hi;
      }
    }
    const bf16* Ks = smem + (t & 1) * 2 * L::KV;
    const bf16* Vs = Ks + L::KV;
    const int k0 = (t % ntiles) * WIN_KEYS;

#pragma unroll
    for (int kc = 0; kc < WIN_KEYS / 16; ++kc) {
      if (k0 + kc * 16 >= N) break;          // the same for every warp
      float s[2][4];
      scores(Ks, kc, k0, s);
      if (!second) {
        // running max and sum; a lane whose keys are all past N keeps
        // m = -inf and l = 0
        const float c_lo = fmaxf(fmaxf(s[0][0], s[0][1]),
                                 fmaxf(s[1][0], s[1][1]));
        const float c_hi = fmaxf(fmaxf(s[0][2], s[0][3]),
                                 fmaxf(s[1][2], s[1][3]));
        if (c_lo > m_lo) {
          l_lo = mul(l_lo, expf(sub(m_lo, c_lo)));
          m_lo = c_lo;
        }
        if (c_hi > m_hi) {
          l_hi = mul(l_hi, expf(sub(m_hi, c_hi)));
          m_hi = c_hi;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          l_lo = add(l_lo, add(exp_past(s[j][0], m_lo),
                               exp_past(s[j][1], m_lo)));
          l_hi = add(l_hi, add(exp_past(s[j][2], m_hi),
                               exp_past(s[j][3], m_hi)));
        }
        continue;
      }
      // p = bf16(exp(s - m) / l): an IEEE division, as the reference's
      // p / l; keys past N give exp(-inf) = 0
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][0] = __fdiv_rn(expf(sub(s[j][0], m_lo)), l_lo);
        s[j][1] = __fdiv_rn(expf(sub(s[j][1], m_lo)), l_lo);
        s[j][2] = __fdiv_rn(expf(sub(s[j][2], m_hi)), l_hi);
        s[j][3] = __fdiv_rn(expf(sub(s[j][3], m_hi)), l_hi);
      }
      const unsigned pf[4] = {pack_bf16x2(s[0][0], s[0][1]),
                              pack_bf16x2(s[0][2], s[0][3]),
                              pack_bf16x2(s[1][0], s[1][1]),
                              pack_bf16x2(s[1][2], s[1][3])};
#pragma unroll
      for (int j = 0; j < OT; j += 2) {
        unsigned r[4];
        ldmatrix_x4_trans(r, Vs + (kc * 16 + v_row) * L::LDK + j * 8 + v_col);
        mma_bf16_16816(o[j], pf, r[0], r[1]);
        mma_bf16_16816(o[j + 1], pf, r[2], r[3]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < OT; ++j) {
    const int col = j * 8 + t2;
    if (n_lo < N) store2(ob + n_lo * a.so[2] + col, o[j][0], o[j][1]);
    if (n_hi < N) store2(ob + n_hi * a.so[2] + col, o[j][2], o[j][3]);
  }
}

template <int HD, typename TI>
static cudaError_t launch_softmax(const SoftmaxArgs& a, int B, cudaStream_t s) {
  constexpr int smem = 2 * 2 * WinLayout<HD>::KV * 2;  // 2 stages of K, V
  cudaError_t err = cudaFuncSetAttribute(
      mha_softmax_kernel<HD, TI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (a.N + WIN_ROWS - 1) / WIN_ROWS, a.H);
  mha_softmax_kernel<HD, TI><<<grid, WIN_WARPS * 32, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace dyt

extern "C" {

// qkv [B, N, 3C] bf16 contiguous ([q|k|v] x head x hd columns); bias
// [H, N, N] bf16 with unit column stride, row stride ``row_stride`` and head
// stride ``head_stride`` (elements; both multiples of 8, row stride at
// least N rounded up to 8); out [B, N, C] bf16.  head_dim 64 or 128.
// Returns a cudaError_t value.
int dyt_mha_windowed(const void* qkv, const void* bias, void* out, int B,
                     int N, int C, int H, long long head_stride,
                     int row_stride, float scale, void* stream) {
  using dyt::bf16;
  auto* q = static_cast<const bf16*>(qkv);
  auto* b = static_cast<const bf16*>(bias);
  auto* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 64 * H)
    return dyt::launch_windowed<64>(q, b, o, B, N, H, head_stride, row_stride,
                                    scale, s);
  if (C == 128 * H)
    return dyt::launch_windowed<128>(q, b, o, B, N, H, head_stride,
                                     row_stride, scale, s);
  return cudaErrorInvalidValue;
}

// K13 / K14: q, k, v and out all fp32 (in_f32) or all bf16, given by 12
// element strides (batch, head, row of q, k, v and out) with unit stride
// along hd and rows on 16 bytes; bias null or fp32 with unit column stride
// and the given head and row strides.  hd 64 or 128.  Returns a cudaError_t
// value.
int dyt_mha_softmax(const void* q, const void* k, const void* v, void* out,
                    const long long* strides, const float* bias,
                    long long bias_head_stride, long long bias_row_stride,
                    int B, int N, int H, int hd, float scale, int in_f32,
                    void* stream) {
  dyt::SoftmaxArgs a{q, k, v, out, bias, {}, {}, {}, {},
                     bias_head_stride, bias_row_stride, N, H, scale};
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0) return cudaErrorInvalidValue;
  if (hd == 64)
    return in_f32 ? dyt::launch_softmax<64, float>(a, B, s)
                  : dyt::launch_softmax<64, dyt::bf16>(a, B, s);
  if (hd == 128)
    return in_f32 ? dyt::launch_softmax<128, float>(a, B, s)
                  : dyt::launch_softmax<128, dyt::bf16>(a, B, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
