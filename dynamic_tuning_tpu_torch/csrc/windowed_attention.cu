// Serving attention with an additive relative-position bias (the windowed
// attention of the segmentation backbone):
//     out = core(qkv, bias)   qkv [B, N, 3C] bf16, bias [H, N, N] bf16
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

}  // extern "C"
