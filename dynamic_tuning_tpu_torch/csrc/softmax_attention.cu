// Max-subtracted softmax attention with an optional fp32 [H, N, N] bias:
// TPU kernels flash_attention (K13, dynamic_tuning_tpu/ops/
// flash_attention.py::_kernel and _kernel_per_head: [B, H, N, D] q, k, v)
// and packed_attention (K14, dynamic_tuning_tpu/ops/packed_attention.py::
// _kernel: the raw [B, N, 3C] qkv buffer), per query row of each head:
//   s = f32(bf16(q) . bf16(k)) * scale (+ bias);  keys >= N never visited
//   m = max(s);  l = sum(exp(s - m));  p = bf16(exp(s - m) * (1 / l))
//   o = f32(p @ bf16(v)) -> the input dtype
// The row max and l must be final before any p is rounded (the reference
// normalises p before its bf16 rounding), so a one-pass flash rescale of
// the output would round other p.  The TPU kernels hold a whole [N, N]
// score tile in VMEM; here the scores live in registers (N <= 256) or in a
// shared-memory slab (N up to ~1.3k), and only past that are they
// recomputed.
//
// What bounds it on an H100.  At B=128, N=197, 12 heads of 64, bf16, the
// kernel moves 4 * 128 * 12 * 197 * 64 * 2 B = 155 MB (0.046 ms) for 15.3
// GFLOP of products (0.015 ms) and 60 M exps (~0.016 ms of the SFUs): bytes
// first, the exp and the products close behind.  At B=1, N=1025 with the
// fp32 bias, the bias (50 MB, 0.015 ms) is most of the bytes.
//
// What the design does about it.
// * N <= 256 (K14's whole domain, K13 at ViT lengths): sa_resident_kernel.
//   One block, one warpgroup, per (sample, head) stages the head's K and V
//   into shared memory once (2 * 208 * 128 B = 53 KB at N=197, hd 64) and
//   walks 64-row query tiles (the next tile's Q in flight while it
//   computes).  Q K^T and P V are wgmma chains; each warp keeps its 16 rows'
//   whole score row in registers (13 chunks of 16 keys at N=197, 104 fp32 a
//   thread), so Q K^T and the exp run once per score, m is exact from a
//   quad shuffle, and p is rounded to bf16 in the registers P V reads.  The
//   chunk count is a template argument (13, the ViT length's, or 16; N
//   padded up), so every loop over the row unrolls without a guard.
// * N > 256: sa_walk_kernel.  A block owns 32 query rows of one (sample,
//   head); its 8 warps split them into two 16-row halves and each 64-key
//   tile into four 16-key chunks.  K, the fp32 bias tile and V stream
//   through a three-stage cp.async ring.  With a slab (SLAB, when 32 rows x
//   N fp32 fit beside the ring: N <= 1280 at hd 64, 1088 at hd 128), pass 1
//   computes each score once -- Q K^T, the scale, the bias read once from
//   device memory -- into a thread-private fp32 slab and tracks the max;
//   l is summed over the slab; pass 2 streams V only and forms p from the
//   slab.  Without a slab, pass 2 recomputes Q K^T and reads the bias
//   again, with l rescaled online in pass 1.  The four chunks' m, l and
//   partial outputs meet through shared memory.
// * exp(x) is ex2.approx of x * log2 e (one FFMA with the row max in the
//   resident kernel), and p multiplies by one IEEE reciprocal of l per row
//   where the reference divides: both move an fp32 p by an ulp or so, which
//   changes its bf16 rounding only where it sits on a boundary.  The card's
//   checks (chip_smoke.py, tests/test_torch_port_cuda.py) hold the result
//   to the plain version's: within two bf16 ulps of the largest output and
//   99% of outputs within one ulp of their own (ops/flash_attention.py::
//   ulp_share).
// * The walk stays on mma.sync m16n8k16 (a 64-row wgmma tile would need a
//   slab of 64 rows); fp32 accumulators throughout; fp32 q, k, v are
//   rounded to bf16 on their way into shared memory.
#include "wgmma.cuh"

namespace dyt {

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
  int in_f32;                 // q, k, v, out fp32 (else bf16)
};

// exp(x) for x <= 0 (or -inf -> 0)
__device__ __forceinline__ float exp_le0(float x) { return ex2(x * LOG2E); }

// rows r0 .. r0 + rows - 1 of a [N, HD] head (row stride ``ld`` elements)
// into shared memory rows of stride LDS; rows past N are zero-filled
template <int HD, int LDS, typename TI>
__device__ __forceinline__ void stage_rows_t(bf16* dst, const TI* src,
                                             long long ld, int r0, int rows,
                                             int N, int tid, int nthreads) {
  constexpr int CPR = HD / 8;
  for (int i = tid; i < rows * CPR; i += nthreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r0 + r < N;
    stage8(dst + r * LDS + c, src + (ok ? r0 + r : 0) * ld + c, ok);
  }
}
template <int HD, int LDS>
__device__ __forceinline__ void stage_rows(bf16* dst, const void* src,
                                           bool f32, long long ld, int r0,
                                           int rows, int N, int tid,
                                           int nthreads) {
  if (f32)
    stage_rows_t<HD, LDS>(dst, static_cast<const float*>(src), ld, r0, rows,
                          N, tid, nthreads);
  else
    stage_rows_t<HD, LDS>(dst, static_cast<const bf16*>(src), ld, r0, rows,
                          N, tid, nthreads);
}

// (sample, head) base of a strided operand
__device__ __forceinline__ const void* head_base(const void* p,
                                                 const long long (&st)[3],
                                                 int b, int h, bool f32) {
  const long long off = b * st[0] + h * st[1];
  return f32 ? static_cast<const void*>(static_cast<const float*>(p) + off)
             : static_cast<const void*>(static_cast<const bf16*>(p) + off);
}

// thread (g = lane / 4, t2 = 2 * (lane % 4)) of a warp holds rows g and
// g + 8 of its 16-row tile in every m16n8 accumulator: element e of tile j
// is row g + 8 * (e >> 1), column j * 8 + t2 + (e & 1)
struct Lane {
  int g, t2, a_row, a_k, k_row, k_col, v_row, v_col;
  __device__ __forceinline__ explicit Lane(int lane)
      : g(lane >> 2), t2((lane & 3) * 2), a_row(lane & 15),
        a_k((lane >> 4) * 8), k_row((lane & 7) + ((lane >> 4) << 3)),
        k_col(((lane >> 3) & 1) * 8), v_row(lane & 15),
        v_col((lane >> 4) * 8) {}
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v = add(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return add(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// the A fragment of P V for one 16-key chunk from its two n8 score tiles
__device__ __forceinline__ void pack_p(unsigned (&pf)[4],
                                       const float (&e)[2][4], float inv_lo,
                                       float inv_hi) {
  pf[0] = pack_bf16x2(e[0][0] * inv_lo, e[0][1] * inv_lo);
  pf[1] = pack_bf16x2(e[0][2] * inv_hi, e[0][3] * inv_hi);
  pf[2] = pack_bf16x2(e[1][0] * inv_lo, e[1][1] * inv_lo);
  pf[3] = pack_bf16x2(e[1][2] * inv_hi, e[1][3] * inv_hi);
}

// s (16 x 16) = q (16 x HD, A fragments) . K rows kr .. kr + 15
template <int HD, int LDK>
__device__ __forceinline__ void qk_chunk(float (&s)[2][4],
                                         const unsigned (&qf)[HD / 16][4],
                                         const bf16* Ks, int kr,
                                         const Lane& L) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int d = 0; d < HD / 16; ++d) {
    unsigned r[4];
    ldmatrix_x4(r, Ks + (kr + L.k_row) * LDK + d * 16 + L.k_col);
    mma_bf16_16816(s[0], qf[d], r[0], r[1]);
    mma_bf16_16816(s[1], qf[d], r[2], r[3]);
  }
}

// o (16 x HD) += p (16 x 16) . V rows vr .. vr + 15
template <int HD, int LDK>
__device__ __forceinline__ void pv_chunk(float (&o)[HD / 8][4],
                                         const unsigned (&pf)[4],
                                         const bf16* Vs, int vr,
                                         const Lane& L) {
#pragma unroll
  for (int j = 0; j < HD / 8; j += 2) {
    unsigned r[4];
    ldmatrix_x4_trans(r, Vs + (vr + L.v_row) * LDK + j * 8 + L.v_col);
    mma_bf16_16816(o[j], pf, r[0], r[1]);
    mma_bf16_16816(o[j + 1], pf, r[2], r[3]);
  }
}

// rows n_lo and n_lo + 8 (those below N) of a head's output
template <int HD>
__device__ __forceinline__ void store_rows(void* ob, bool f32, long long ld,
                                           const float (&o)[HD / 8][4],
                                           int n_lo, int N, const Lane& L) {
  const int n_hi = n_lo + 8;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = j * 8 + L.t2;
    if (f32) {
      float* p = static_cast<float*>(ob);
      if (n_lo < N) store2(p + n_lo * ld + col, o[j][0], o[j][1]);
      if (n_hi < N) store2(p + n_hi * ld + col, o[j][2], o[j][3]);
    } else {
      bf16* p = static_cast<bf16*>(ob);
      if (n_lo < N) store2(p + n_lo * ld + col, o[j][0], o[j][1]);
      if (n_hi < N) store2(p + n_hi * ld + col, o[j][2], o[j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// N <= 256: one block (one warpgroup of 4 warps) per (sample, head), K and V
// resident, score rows in registers.  Per 64-row query tile, Q K^T is one
// wgmma chain (A = Q, B = K, both from shared memory in the 128-byte
// swizzled K-major layout) and P V another (A = P from each warp's
// registers, B = V read N-major from the same kind of tile): the tensor
// cores read K and V once a tile, where four mma.sync warps with ldmatrix
// read them four times.  NC (13 or 16) is the number of 16-key chunks, N
// padded up: keys past N are zero in shared memory and -inf as scores.

// The wgmma helpers (descriptors of the 128-byte swizzled tiles, wgmma_ss,
// wgmma_rs) and stage_sw128 are shared with the serving core and the GEMM:
// wgmma.cuh.

// stage_sw128 on fp32 or bf16 rows
template <int HD>
__device__ __forceinline__ void stage_sw128(unsigned char* dst,
                                            const void* src, bool f32,
                                            long long ld, int r0, int rows,
                                            int N, int tid, int nthreads) {
  if (f32)
    stage_sw128<HD>(dst, static_cast<const float*>(src), ld, r0, rows, N, tid,
                    nthreads);
  else
    stage_sw128<HD>(dst, static_cast<const bf16*>(src), ld, r0, rows, N, tid,
                    nthreads);
}

constexpr int SA_RES_THREADS = 128;        // one warpgroup

template <int HD, int NC>
struct ResLayout {
  static constexpr int NK = NC * 16;
  static constexpr int K = NK * HD * 2;    // swizzled K (and V), bytes
  static constexpr int Q = 64 * HD * 2;    // swizzled 64-row Q tile
  static constexpr int SMEM = 1024 + 2 * K + Q;   // + alignment slack
};

template <int HD, int NC>
__global__ void __launch_bounds__(SA_RES_THREADS,
                                  HD == 64 && NC <= 13 ? 3 : 2)
sa_resident_kernel(const SoftmaxArgs a) {
  using RL = ResLayout<HD, NC>;
  constexpr int DK = HD / 16, OT = HD / 8, NK = RL::NK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Kt = align1024(smem_raw);
  unsigned char* Vt = Kt + RL::K;
  unsigned char* Qt = Vt + RL::K;
  const int N = a.N, nq = (N + 63) / 64;
  const bool f32 = a.in_f32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, h = blockIdx.x;
  const void* qb = head_base(a.q, a.sq, b, h, f32);
  const void* kb = head_base(a.k, a.sk, b, h, f32);
  const void* vb = head_base(a.v, a.sv, b, h, f32);
  void* ob = const_cast<void*>(head_base(a.o, a.so, b, h, f32));

  // groups: K, the first Q tile, V -- so that waiting for all but the
  // newest leaves only V in flight
  stage_sw128<HD>(Kt, kb, f32, a.sk[2], 0, NK, N, tid, SA_RES_THREADS);
  cp_async_commit();
  stage_sw128<HD>(Qt, qb, f32, a.sq[2], 0, 64, N, tid, SA_RES_THREADS);
  cp_async_commit();
  stage_sw128<HD>(Vt, vb, f32, a.sv[2], 0, NK, N, tid, SA_RES_THREADS);
  cp_async_commit();

  const Lane L(lane);
  const float* bias_h = a.bias == nullptr ? nullptr
                                          : a.bias + h * a.bias_head_stride;
  for (int qt = 0; qt < nq; ++qt) {
    if (qt == 0)
      cp_async_wait<1>();          // K and this Q tile have landed
    else
      cp_async_wait<0>();          // the Q tile prefetched last time
    fence_proxy_async();           // ... visible to the tensor cores
    __syncthreads();

    // S = Q K^T for the tile's 64 rows over every key chunk
    float s[NC][2][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][j][e] = 0.f;
    float (&sf)[NK / 2] = *reinterpret_cast<float(*)[NK / 2]>(&s[0][0][0]);
    wgmma_fence();
#pragma unroll
    for (int d = 0; d < DK; ++d) {
      const int kb64 = d / 4, ko = (d % 4) * 32;
      wgmma_ss<NK>(sf, desc_sw128(Qt + kb64 * 64 * 128 + ko),
                   desc_sw128(Kt + kb64 * NK * 128 + ko), d > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();               // the warpgroup has read this Q tile
    if (qt + 1 < nq)
      stage_sw128<HD>(Qt, qb, f32, a.sq[2], (qt + 1) * 64, 64, N, tid,
                      SA_RES_THREADS);
    cp_async_commit();

    const int r0 = qt * 64 + warp * 16;
    // a warp whose 16 rows all lie past N gives P = 0 and stores nothing
    const bool live = r0 < N;
    const int n_lo = r0 + L.g, n_hi = n_lo + 8;
    float inv_lo = 0.f, inv_hi = 0.f;
    if (live) {
      // with a bias, s = f32(q.k) * scale + bias (rows past N read row
      // N - 1, keys past N key N - 1: neither is kept) and exp(s - m) =
      // 2^(s log2e - m log2e); without one s stays q.k and the scale joins
      // log2e (max(q.k) * scale is max(q.k * scale)).  Keys past N: -inf.
      float kl = a.scale * LOG2E;
      if (bias_h != nullptr) {
        kl = LOG2E;
        const float* b_lo = bias_h + min(n_lo, N - 1) * a.bias_row_stride;
        const float* b_hi = bias_h + min(n_hi, N - 1) * a.bias_row_stride;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = min(c * 16 + j * 8 + L.t2 + (e & 1), N - 1);
              s[c][j][e] = add(mul(s[c][j][e], a.scale),
                               __ldg((e < 2 ? b_lo : b_hi) + col));
            }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c * 16 + 16 > N) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (c * 16 + j * 8 + L.t2 + (e & 1) >= N) s[c][j][e] = -INFINITY;
        }
      }

      // the exact row max, then e = exp(s - m) in place and l = sum(e), each
      // over four independent partials
      float mx[4][2], sm[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mx[i][0] = mx[i][1] = -INFINITY;
        sm[i][0] = sm[i][1] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        mx[c & 3][0] = fmaxf(mx[c & 3][0],
                             fmaxf(fmaxf(s[c][0][0], s[c][0][1]),
                                   fmaxf(s[c][1][0], s[c][1][1])));
        mx[c & 3][1] = fmaxf(mx[c & 3][1],
                             fmaxf(fmaxf(s[c][0][2], s[c][0][3]),
                                   fmaxf(s[c][1][2], s[c][1][3])));
      }
      const float mk_lo = kl * quad_max(fmaxf(fmaxf(mx[0][0], mx[1][0]),
                                              fmaxf(mx[2][0], mx[3][0])));
      const float mk_hi = kl * quad_max(fmaxf(fmaxf(mx[0][1], mx[1][1]),
                                              fmaxf(mx[2][1], mx[3][1])));
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[c][j][e] = ex2(fmaf(s[c][j][e], kl, -(e < 2 ? mk_lo : mk_hi)));
        sm[c & 3][0] = add(sm[c & 3][0], add(add(s[c][0][0], s[c][0][1]),
                                             add(s[c][1][0], s[c][1][1])));
        sm[c & 3][1] = add(sm[c & 3][1], add(add(s[c][0][2], s[c][0][3]),
                                             add(s[c][1][2], s[c][1][3])));
      }
      inv_lo = __frcp_rn(quad_sum(
          add(add(sm[0][0], sm[1][0]), add(sm[2][0], sm[3][0]))));
      inv_hi = __frcp_rn(quad_sum(
          add(add(sm[0][1], sm[1][1]), add(sm[2][1], sm[3][1]))));
    }
    if (qt == 0) {
      cp_async_wait<1>();      // V (the newest group is the next Q tile)
      fence_proxy_async();
      __syncthreads();         // every warp's copies of V
    }
    // O = P V for the tile's 64 rows: P from registers, V read N-major
    // from its swizzled tile, 16 keys a step
    unsigned pf[NC][4];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (live) {
        pack_p(pf[c], s[c], inv_lo, inv_hi);
      } else {
        pf[c][0] = pf[c][1] = pf[c][2] = pf[c][3] = 0u;
      }
    }
    float o[OT][4];
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    float (&of)[HD / 2] = *reinterpret_cast<float(*)[HD / 2]>(&o[0][0]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wgmma_rs<HD, true>(of, pf[c], desc_sw128_mn(Vt + c * 2048, NK * 128),
                         c > 0);
    wgmma_commit();
    wgmma_wait<0>();
    if (!live) continue;
    store_rows<HD>(ob, f32, a.so[2], o, n_lo, N, L);
  }
}

// ---------------------------------------------------------------------------
// N > 256: 32 query rows a block, keys walked in 64-key tiles; warp w takes
// rows 16 * (w % 2) .. + 15 and the 16-key chunk w / 2 of every tile.

constexpr int SA_WALK_WARPS = 8;
constexpr int SA_WALK_THREADS = SA_WALK_WARPS * 32;
constexpr int SA_WALK_ROWS = 32;
constexpr int SA_WALK_KEYS = 64;
constexpr int SA_WALK_KW = SA_WALK_KEYS / 16;    // key chunks (warps) a tile
constexpr int SA_STAGES = 3;

template <int HD, bool SLAB>
struct WalkLayout {
  static constexpr int LDK = HD + 8;
  static constexpr int LDB = SA_WALK_KEYS + 8;   // fp32 bias row stride
                                                 // (64 keys + a 0..3 offset)
  static constexpr int KV = SA_WALK_KEYS * LDK * 2;           // bytes
  static constexpr int BIAS = SA_WALK_ROWS * LDB * 4;         // bytes
  // pass 1 stages K + bias; pass 2 stages V (with a slab) or all three
  static constexpr int STAGE = SLAB ? KV + BIAS : 2 * KV + BIAS;
  static constexpr int OFF_V = SLAB ? 0 : KV + BIAS;
  static constexpr int Q = SA_WALK_ROWS * LDK * 2;
  static constexpr int RED = 2 * SA_WALK_KW * SA_WALK_ROWS * 4;  // m, l
  static constexpr int FIXED = Q + SA_STAGES * STAGE + RED;
  // the slab: per warp and tile, 32 lanes x 8 fp32 (1 KB)
  static constexpr int SLAB_PER_TILE = SA_WALK_WARPS * 1024;
  static constexpr int smem(int ntiles) {
    return FIXED + (SLAB ? ntiles * SLAB_PER_TILE : 0);
  }
  static_assert((SA_WALK_KW - 1) * SA_WALK_ROWS * HD * 4 <=
                    SA_STAGES * STAGE,
                "the output exchange reuses the ring");
};

template <int HD, bool SLAB>
__global__ void __launch_bounds__(SA_WALK_THREADS)
sa_walk_kernel(const SoftmaxArgs a) {
  using WL = WalkLayout<HD, SLAB>;
  constexpr int LDK = WL::LDK, LDB = WL::LDB, DK = HD / 16, OT = HD / 8;
  constexpr int KW = SA_WALK_KW, ROWS = SA_WALK_ROWS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int N = a.N, ntiles = (N + SA_WALK_KEYS - 1) / SA_WALK_KEYS;
  const bool f32 = a.in_f32;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* ring = smem_raw + WL::Q;
  float* red_m = reinterpret_cast<float*>(ring + SA_STAGES * WL::STAGE);
  float* red_l = red_m + KW * ROWS;
  float* slab = red_l + KW * ROWS;

  const int b = blockIdx.x, q0 = blockIdx.y * ROWS, h = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rw = warp & 1, kw = warp >> 1;   // row half, key chunk
  const void* qb = head_base(a.q, a.sq, b, h, f32);
  const void* kb = head_base(a.k, a.sk, b, h, f32);
  const void* vb = head_base(a.v, a.sv, b, h, f32);
  void* ob = const_cast<void*>(head_base(a.o, a.so, b, h, f32));
  const float* bh = a.bias == nullptr ? nullptr
                                      : a.bias + h * a.bias_head_stride;
  // the bias rows start anywhere on 4 bytes (row stride N at odd N): each
  // row is copied in 16-byte chunks from its tile start rounded down to 16
  // bytes (inside the bias, whose base is on 16 bytes) and read at that
  // offset, 0..3 elements
  auto b_off = [&](int r) {
    return static_cast<int>((reinterpret_cast<size_t>(
        bh + (long long)(q0 + r) * a.bias_row_stride) >> 2) & 3);
  };

  // step t < ntiles: K (+ bias) of tile t; t >= ntiles: V of tile
  // t - ntiles (with K and the bias again without a slab)
  auto load_step = [&](int t) {
    unsigned char* st = ring + (t % SA_STAGES) * WL::STAGE;
    const bool second = t >= ntiles;
    const int k0 = (second ? t - ntiles : t) * SA_WALK_KEYS;
    if (!SLAB || !second) {
      stage_rows<HD, LDK>(reinterpret_cast<bf16*>(st), kb, f32, a.sk[2], k0,
                          SA_WALK_KEYS, N, tid, SA_WALK_THREADS);
      if (bh != nullptr) {
        float* Bs = reinterpret_cast<float*>(st + WL::KV);
        constexpr int CH = SA_WALK_KEYS / 4 + 1;     // chunks a row
        for (int i = tid; i < ROWS * CH; i += SA_WALK_THREADS) {
          const int r = i / CH, ch = i % CH;
          const int c0 = k0 - b_off(r) + ch * 4;       // its first key
          const int bytes = q0 + r < N && c0 < N ? min(16, (N - c0) * 4) : 0;
          cp_async16(Bs + r * LDB + ch * 4,
                     bytes ? bh + (q0 + r) * a.bias_row_stride + c0 : a.bias,
                     bytes);
        }
      }
    }
    if (second)
      stage_rows<HD, LDK>(reinterpret_cast<bf16*>(st + WL::OFF_V), vb, f32,
                          a.sv[2], k0, SA_WALK_KEYS, N, tid, SA_WALK_THREADS);
  };

  stage_rows<HD, LDK>(Qs, qb, f32, a.sq[2], q0, ROWS, N, tid,
                      SA_WALK_THREADS);
#pragma unroll
  for (int t = 0; t < SA_STAGES - 1; ++t) {
    if (t < 2 * ntiles) load_step(t);
    cp_async_commit();           // Q joins the first group
  }

  const Lane L(lane);
  const int r_lo = rw * 16 + L.g;                 // row within the block
  const int bo_lo = b_off(r_lo), bo_hi = b_off(r_lo + 8);
  unsigned qf[DK][4];
  float* my_slab = slab + warp * ntiles * 256 + lane * 4;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float inv_lo = 0.f, inv_hi = 0.f;
  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  // the scores of this warp's chunk (keys k0 + kw * 16 ...) of a staged tile
  auto scores = [&](const unsigned char* st, int k0, float (&s)[2][4]) {
    qk_chunk<HD, LDK>(s, qf, reinterpret_cast<const bf16*>(st), kw * 16, L);
    const float* Bs = reinterpret_cast<const float*>(st + WL::KV);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int cb = kw * 16 + j * 8 + L.t2;      // column in the tile
      float bv[4] = {0.f, 0.f, 0.f, 0.f};
      if (bh != nullptr) {
        const float* b_lo = Bs + r_lo * LDB + bo_lo + cb;
        const float* b_hi = Bs + (r_lo + 8) * LDB + bo_hi + cb;
        bv[0] = b_lo[0];
        bv[1] = b_lo[1];
        bv[2] = b_hi[0];
        bv[3] = b_hi[1];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = mul(s[j][e], a.scale);
        if (bh != nullptr) v = add(v, bv[e]);
        s[j][e] = k0 + cb + (e & 1) < N ? v : -INFINITY;
      }
    }
  };

  const int nsteps = 2 * ntiles;
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<SA_STAGES - 2>();   // step t has landed ...
    __syncthreads();                  // ... and step t - 1 is done
    if (t + SA_STAGES - 1 < nsteps) load_step(t + SA_STAGES - 1);
    cp_async_commit();
    if (t == 0) {
#pragma unroll
      for (int d = 0; d < DK; ++d)
        ldmatrix_x4(qf[d], Qs + (rw * 16 + L.a_row) * LDK + d * 16 + L.a_k);
    }
    const bool second = t >= ntiles;
    if (t == ntiles) {
      // pass 1 is done: each row's m and l over the four key chunks, in
      // one order in every warp
      const float qm_lo = quad_max(m_lo), qm_hi = quad_max(m_hi);
      if (!SLAB) {
        // each lane's l was summed against its own running max
        l_lo = quad_sum(l_lo == 0.f ? 0.f
                                    : mul(l_lo, exp_le0(sub(m_lo, qm_lo))));
        l_hi = quad_sum(l_hi == 0.f ? 0.f
                                    : mul(l_hi, exp_le0(sub(m_hi, qm_hi))));
      }
      m_lo = qm_lo;
      m_hi = qm_hi;
      if ((lane & 3) == 0) {
        red_m[kw * ROWS + r_lo] = m_lo;
        red_m[kw * ROWS + r_lo + 8] = m_hi;
        if (!SLAB) {
          red_l[kw * ROWS + r_lo] = l_lo;
          red_l[kw * ROWS + r_lo + 8] = l_hi;
        }
      }
      __syncthreads();
      float mk_lo[KW], mk_hi[KW];
      float nm_lo = -INFINITY, nm_hi = -INFINITY;
#pragma unroll
      for (int k = 0; k < KW; ++k) {
        mk_lo[k] = red_m[k * ROWS + r_lo];
        mk_hi[k] = red_m[k * ROWS + r_lo + 8];
        nm_lo = fmaxf(nm_lo, mk_lo[k]);
        nm_hi = fmaxf(nm_hi, mk_hi[k]);
      }
      if (SLAB) {
        m_lo = nm_lo;
        m_hi = nm_hi;
        // l over this warp's slab, then over the four chunks
        l_lo = l_hi = 0.f;
        for (int i = 0; i < ntiles; ++i) {
          if (i * SA_WALK_KEYS + kw * 16 >= N) break;
          const float4 x = *reinterpret_cast<const float4*>(my_slab + i * 256);
          const float4 y =
              *reinterpret_cast<const float4*>(my_slab + i * 256 + 128);
          l_lo = add(l_lo, add(add(exp_le0(sub(x.x, m_lo)),
                                   exp_le0(sub(x.y, m_lo))),
                               add(exp_le0(sub(y.x, m_lo)),
                                   exp_le0(sub(y.y, m_lo)))));
          l_hi = add(l_hi, add(add(exp_le0(sub(x.z, m_hi)),
                                   exp_le0(sub(x.w, m_hi))),
                               add(exp_le0(sub(y.z, m_hi)),
                                   exp_le0(sub(y.w, m_hi)))));
        }
        l_lo = quad_sum(l_lo);
        l_hi = quad_sum(l_hi);
        if ((lane & 3) == 0) {
          red_l[kw * ROWS + r_lo] = l_lo;
          red_l[kw * ROWS + r_lo + 8] = l_hi;
        }
        __syncthreads();
        l_lo = l_hi = 0.f;
#pragma unroll
        for (int k = 0; k < KW; ++k) {
          l_lo = add(l_lo, red_l[k * ROWS + r_lo]);
          l_hi = add(l_hi, red_l[k * ROWS + r_lo + 8]);
        }
      } else {
        // each chunk's l was rescaled to its own max; bring all to the
        // common one (a chunk with no key has m = -inf and l = 0)
        l_lo = l_hi = 0.f;
#pragma unroll
        for (int k = 0; k < KW; ++k) {
          const float lk_lo = red_l[k * ROWS + r_lo];
          const float lk_hi = red_l[k * ROWS + r_lo + 8];
          l_lo = add(l_lo, lk_lo == 0.f ? 0.f
                           : mul(lk_lo, exp_le0(sub(mk_lo[k], nm_lo))));
          l_hi = add(l_hi, lk_hi == 0.f ? 0.f
                           : mul(lk_hi, exp_le0(sub(mk_hi[k], nm_hi))));
        }
        m_lo = nm_lo;
        m_hi = nm_hi;
      }
      inv_lo = __frcp_rn(l_lo);
      inv_hi = __frcp_rn(l_hi);
    }

    const unsigned char* st = ring + (t % SA_STAGES) * WL::STAGE;
    const int tile = second ? t - ntiles : t;
    const int k0 = tile * SA_WALK_KEYS;
    if (k0 + kw * 16 >= N) continue;           // the same for the warp
    float s[2][4];
    float* cs = my_slab + tile * 256;
    if (!second) {
      scores(st, k0, s);
      const float c_lo = fmaxf(fmaxf(s[0][0], s[0][1]),
                               fmaxf(s[1][0], s[1][1]));
      const float c_hi = fmaxf(fmaxf(s[0][2], s[0][3]),
                               fmaxf(s[1][2], s[1][3]));
      if (SLAB) {
        *reinterpret_cast<float4*>(cs) =
            make_float4(s[0][0], s[0][1], s[0][2], s[0][3]);
        *reinterpret_cast<float4*>(cs + 128) =
            make_float4(s[1][0], s[1][1], s[1][2], s[1][3]);
        m_lo = fmaxf(m_lo, c_lo);
        m_hi = fmaxf(m_hi, c_hi);
      } else {
        // running max and sum per lane; l is rescaled when m grows
        if (c_lo > m_lo) {
          l_lo = l_lo == 0.f ? 0.f : mul(l_lo, exp_le0(sub(m_lo, c_lo)));
          m_lo = c_lo;
        }
        if (c_hi > m_hi) {
          l_hi = l_hi == 0.f ? 0.f : mul(l_hi, exp_le0(sub(m_hi, c_hi)));
          m_hi = c_hi;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          l_lo = add(l_lo, add(exp_le0(sub(s[j][0], m_lo)),
                               exp_le0(sub(s[j][1], m_lo))));
          l_hi = add(l_hi, add(exp_le0(sub(s[j][2], m_hi)),
                               exp_le0(sub(s[j][3], m_hi))));
        }
      }
      continue;
    }
    if (SLAB) {
      const float4 x = *reinterpret_cast<const float4*>(cs);
      const float4 y = *reinterpret_cast<const float4*>(cs + 128);
      s[0][0] = x.x; s[0][1] = x.y; s[0][2] = x.z; s[0][3] = x.w;
      s[1][0] = y.x; s[1][1] = y.y; s[1][2] = y.z; s[1][3] = y.w;
    } else {
      scores(st, k0, s);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = exp_le0(sub(s[j][e], e < 2 ? m_lo : m_hi));
    unsigned pf[4];
    pack_p(pf, s, inv_lo, inv_hi);
    pv_chunk<HD, LDK>(o, pf, reinterpret_cast<const bf16*>(st + WL::OFF_V),
                      kw * 16, L);
  }

  // the four chunks' partial outputs meet in the (now idle) ring
  cp_async_wait<0>();
  __syncthreads();
  float* xo = reinterpret_cast<float*>(ring);
  if (kw > 0) {
    float* mine = xo + ((kw - 1) * 2 + rw) * OT * 128 + lane * 4;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<float4*>(mine + j * 128) =
          make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);
  }
  __syncthreads();
  if (kw == 0) {
#pragma unroll
    for (int k = 1; k < KW; ++k) {
      const float* theirs = xo + ((k - 1) * 2 + rw) * OT * 128 + lane * 4;
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(theirs + j * 128);
        o[j][0] = add(o[j][0], x.x);
        o[j][1] = add(o[j][1], x.y);
        o[j][2] = add(o[j][2], x.z);
        o[j][3] = add(o[j][3], x.w);
      }
    }
    store_rows<HD>(ob, f32, a.so[2], o, q0 + r_lo, N, L);
  }
}

template <int HD, int NC>
static cudaError_t launch_resident(const SoftmaxArgs& a, int B,
                                   cudaStream_t s) {
  constexpr int smem = ResLayout<HD, NC>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      sa_resident_kernel<HD, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  sa_resident_kernel<HD, NC><<<dim3(a.H, B), SA_RES_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <int HD, bool SLAB>
static cudaError_t launch_walk(const SoftmaxArgs& a, int B, int smem,
                              cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      sa_walk_kernel<HD, SLAB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (a.N + SA_WALK_ROWS - 1) / SA_WALK_ROWS, a.H);
  sa_walk_kernel<HD, SLAB><<<grid, SA_WALK_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <int HD>
static cudaError_t launch_softmax(const SoftmaxArgs& a, int B,
                                  cudaStream_t s) {
  const int nc = (a.N + 15) / 16;
  if (nc <= 13) return launch_resident<HD, 13>(a, B, s);
  if (nc <= 16) return launch_resident<HD, 16>(a, B, s);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  const int ntiles = (a.N + SA_WALK_KEYS - 1) / SA_WALK_KEYS;
  const int slab_smem = WalkLayout<HD, true>::smem(ntiles);
  if (slab_smem <= optin) return launch_walk<HD, true>(a, B, slab_smem, s);
  return launch_walk<HD, false>(a, B, WalkLayout<HD, false>::smem(ntiles), s);
}

}  // namespace dyt

extern "C" {

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
                     bias_head_stride, bias_row_stride, N, H, scale, in_f32};
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0) return cudaErrorInvalidValue;
  if (hd == 64) return dyt::launch_softmax<64>(a, B, s);
  if (hd == 128) return dyt::launch_softmax<128>(a, B, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
