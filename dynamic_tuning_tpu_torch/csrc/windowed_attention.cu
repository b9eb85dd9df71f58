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
// 3.2 GFLOP, ~3.3 us at the bf16 peak, and there are 12.6 M expf.  So on
// paper the bytes bound it; in practice the per-score instructions (the
// bias add, the clamp, an accurate expf, l, the bf16 packing) and how many
// warps an SM has to hide them decide.  The mma.sync form this replaces
// (a two-stage cp.async ring, 17 x 12 = 204 blocks of four warps at B = 1)
// took 0.055 ms, slower than SDPA with the bias as its mask.
//
// What the design does about it.  At N = 1025 a head's K and V (262 KB) do
// not fit a block's 227 KB, so they are streamed: a block is one warpgroup
// owning 64 query rows of one (sample, head), and walks key tiles of 64.
//   * TMA brings each tile's K, V and 64 x 64 bias block into a ring of
//     two 128-byte swizzled stages, paced by a full and an empty mbarrier a
//     stage; thread 0 issues each tile's loads while the tile before it is
//     computed, and the other blocks on the SM hide what is left.
//     The bias rows keep their 16-byte-aligned padded stride (TMA needs
//     it); the swizzle also spreads a warp's bias reads over the banks.
//   * Q K^T and P V run on wgmma: q' as register A fragments against K
//     K-major, then p = bf16(e) as register fragments against V read
//     N-major through the transposing descriptor (as the serving core).
//   * The serving softmax has no row max, so each key tile is final when
//     it is computed: no rescaling, scores and p stay in registers.
//   * Four blocks fit an SM at hd 64 (49 KB of shared memory, at most 128
//     registers a thread), so the 204 blocks of B = 1 (17 query tiles x 12
//     heads) run in one wave, and the grid runs the batch fastest, so the
//     blocks that share a bias tile run side by side and the later ones
//     read it from L2.  A cluster of two blocks splitting each query tile's
//     keys (their partial (o, l) added through distributed shared memory)
//     measured no faster: the busiest SM holds as much work either way.
//     More stages fit fewer blocks an SM (utils/core_ablation.py).
// Keys past N arrive as zeros (TMA's fill) and are masked to p = 0; query
// rows past N compute and are not stored.
#include "gemm.cuh"

extern "C" int dyt_mha_windowed_wide(const void* qkv, const void* bias,
                                     void* out, int B, int N, int C, int H,
                                     long long head_stride, int row_stride,
                                     float scale, void* stream);

namespace dyt {

constexpr int WIN_THREADS = 128;   // one warpgroup: 64 query rows
constexpr int WIN_ROWS = 64;       // query rows a block
constexpr int WIN_KEYS = 64;       // keys a tile

template <int HD>
struct WinLayout {
  static constexpr int KV = WIN_KEYS * HD * 2;            // a K or V tile
  static constexpr int BIAS = WIN_ROWS * WIN_KEYS * 2;    // 8 KB
  static constexpr int STAGE = 2 * KV + BIAS;
  static constexpr int STAGES = 2;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = 1024 + RING + 2 * STAGES * 8;
  static constexpr int BLOCKS = HD == 64 ? 4 : 2;         // an SM
};

// Block (b, query tile, h): thread (g = lane/4, t = lane%4) of warp w holds
// query rows w*16 + g and w*16 + g + 8 of the tile in every accumulator.
template <int HD>
__global__ void __launch_bounds__(WIN_THREADS, WinLayout<HD>::BLOCKS)
mha_windowed_kernel(const __grid_constant__ CUtensorMap map_qkv,
                    const __grid_constant__ CUtensorMap map_bias,
                    const bf16* __restrict__ qkv, bf16* __restrict__ out,
                    int N, int H, float scale) {
  using L = WinLayout<HD>;
  constexpr int DK = HD / 16;    // k16 steps of Q K^T
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::RING);
  uint64_t* empty = full + L::STAGES;

  const int b = blockIdx.x, q0 = blockIdx.y * WIN_ROWS, h = blockIdx.z;
  const int C = H * HD, C3 = 3 * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int nt = (N + WIN_KEYS - 1) / WIN_KEYS;     // key tiles

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);                     // thread 0's arrive
      mbar_init(&empty[s], WIN_THREADS / 32);     // lane 0 of each warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // key tile i into stage i % STAGES: K and V rows k0.. of head h (hd in
  // 64-column boxes) and the bias block [q0.., k0..]
  auto issue = [&](int i) {
    const int st = i % L::STAGES, k0 = i * WIN_KEYS;
    unsigned char* dst = ring + st * L::STAGE;
    mbar_expect_tx(&full[st], L::STAGE);
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {
      tma_load_3d(dst + c * WIN_KEYS * 128, &map_qkv, &full[st],
                  C + h * HD + 64 * c, k0, b);
      tma_load_3d(dst + L::KV + c * WIN_KEYS * 128, &map_qkv, &full[st],
                  2 * C + h * HD + 64 * c, k0, b);
    }
    tma_load_3d(dst + 2 * L::KV, &map_bias, &full[st], k0, q0, h);
  };
  if (tid == 0)
    for (int i = 0; i < nt && i < L::STAGES; ++i) issue(i);

  // q rows scaled in fp32 and rounded to bf16 before Q K^T, loaded straight
  // into the A-operand layout
  const int n_lo = q0 + warp * 16 + g, n_hi = n_lo + 8;
  const bool live = q0 + warp * 16 < N;           // the same for the warp
  const bf16* base = qkv + (size_t)b * N * C3;
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
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float l_lo = 0.f, l_hi = 0.f;

  for (int i = 0; i < nt; ++i) {
    const int st = i % L::STAGES, k0 = i * WIN_KEYS;
    mbar_wait(&full[st], (i / L::STAGES) & 1);
    const unsigned char* Kt = ring + st * L::STAGE;
    const unsigned char* Vt = Kt + L::KV;
    const unsigned char* Bt = Vt + L::KV;
    float s[WIN_KEYS / 2];
    wgmma_fence();
#pragma unroll
    for (int d = 0; d < DK; ++d)
      wgmma_rs<WIN_KEYS, false>(
          s, qf[d], desc_sw128(Kt + (d / 4) * WIN_KEYS * 128 + (d % 4) * 32),
          d > 0);
    wgmma_commit();
    wgmma_wait<0>();               // these scores, and the last tile's P V
    if (i > 0) {
      // tile i - 1's stage is free: each warp is past its bias reads and
      // its P V; thread 0 refills it with tile i - 1 + STAGES
      const int prev = (i - 1) % L::STAGES;
      if (lane == 0) mbar_arrive(&empty[prev]);
      if (tid == 0 && i - 1 + L::STAGES < nt) {
        mbar_wait(&empty[prev], ((i - 1) / L::STAGES) & 1);
        issue(i - 1 + L::STAGES);
      }
    }
    // s + bias, then e = exp(clip(s, -60, 80) - 20); keys past N add 0.
    // Element 4 j + e of s is key k0 + 8 j + t2 + (e & 1) of row g + 8 (e
    // >> 1): its bias sits in the block's swizzled row at chunk j ^ g.
    unsigned pf[WIN_KEYS / 16][4];
    if (live) {
      const bool last = k0 + WIN_KEYS > N;
#pragma unroll
      for (int j = 0; j < WIN_KEYS / 8; ++j) {
        const bf16* brow = reinterpret_cast<const bf16*>(
            Bt + (warp * 16 + g) * 128 + ((j ^ g) << 4)) + t2;
        const float2 b_lo = load2(brow), b_hi = load2(brow + 8 * 64);
        const float bv[4] = {b_lo.x, b_lo.y, b_hi.x, b_hi.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p =
              expf(fminf(fmaxf(s[4 * j + e] + bv[e], -60.f), 80.f) - 20.f);
          if (last && k0 + j * 8 + t2 + (e & 1) >= N) p = 0.f;
          s[4 * j + e] = p;
        }
        l_lo += s[4 * j] + s[4 * j + 1];     // l sums the fp32 e, not bf16(e)
        l_hi += s[4 * j + 2] + s[4 * j + 3];
      }
#pragma unroll
      for (int k = 0; k < WIN_KEYS / 16; ++k) {
        pf[k][0] = pack_bf16x2(s[8 * k], s[8 * k + 1]);
        pf[k][1] = pack_bf16x2(s[8 * k + 2], s[8 * k + 3]);
        pf[k][2] = pack_bf16x2(s[8 * k + 4], s[8 * k + 5]);
        pf[k][3] = pack_bf16x2(s[8 * k + 6], s[8 * k + 7]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < WIN_KEYS / 16; ++k)
        pf[k][0] = pf[k][1] = pf[k][2] = pf[k][3] = 0u;
    }
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < WIN_KEYS / 16; ++k)
      wgmma_rs<HD, true>(o, pf[k],
                         desc_sw128_mn(Vt + k * 16 * 128, WIN_KEYS * 128), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();

  if (!live) return;

  // each row's l is spread over the four lanes of its quad
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, m);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, m);
  }
  const float inv_lo = 1.0f / l_lo, inv_hi = 1.0f / l_hi;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = h * HD + j * 8 + t2;
    if (n_lo < N)
      store2(out + ((size_t)b * N + n_lo) * C + col, o[4 * j] * inv_lo,
             o[4 * j + 1] * inv_lo);
    if (n_hi < N)
      store2(out + ((size_t)b * N + n_hi) * C + col, o[4 * j + 2] * inv_hi,
             o[4 * j + 3] * inv_hi);
  }
}

template <int HD>
static cudaError_t launch_windowed(const bf16* qkv, const bf16* bias,
                                   bf16* out, int B, int N, int H,
                                   long long head_stride, int row_stride,
                                   float scale, cudaStream_t s) {
  using L = WinLayout<HD>;
  if (B <= 0 || N <= 0 || H <= 0 || row_stride % 8 || head_stride % 8 ||
      row_stride < N ||
      (reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(bias)) %
          16)
    return cudaErrorInvalidValue;
  const long long C3 = 3LL * H * HD;
  // qkv as [B][N][3C] and the bias as [H][N][N] with its padded strides,
  // both read in 64 x 64 boxes
  CUtensorMap map_qkv, map_bias;
  const cuuint64_t qdims[3] = {static_cast<cuuint64_t>(C3),
                               static_cast<cuuint64_t>(N),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t qstrides[2] = {static_cast<cuuint64_t>(C3) * 2,
                                  static_cast<cuuint64_t>(C3) * N * 2};
  const cuuint64_t bdims[3] = {static_cast<cuuint64_t>(N),
                               static_cast<cuuint64_t>(N),
                               static_cast<cuuint64_t>(H)};
  const cuuint64_t bstrides[2] = {static_cast<cuuint64_t>(row_stride) * 2,
                                  static_cast<cuuint64_t>(head_stride) * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  cudaError_t err = tensor_map(&map_qkv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                               qkv, 3, qdims, qstrides, box);
  if (err != cudaSuccess) return err;
  err = tensor_map(&map_bias, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, bias, 3,
                   bdims, bstrides, box);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mha_windowed_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (N + WIN_ROWS - 1) / WIN_ROWS, H);
  mha_windowed_kernel<HD><<<grid, WIN_THREADS, L::SMEM, s>>>(
      map_qkv, map_bias, qkv, out, N, H, scale);
  return cudaGetLastError();
}

}  // namespace dyt

extern "C" {

// qkv [B, N, 3C] bf16 contiguous ([q|k|v] x head x hd columns) on 16 bytes;
// bias [H, N, N] bf16 on 16 bytes with unit column stride, row stride
// ``row_stride`` and head stride ``head_stride`` (elements; both multiples
// of 8, row stride at least N rounded up to 8); out [B, N, C] bf16.
// head_dim 64 or 128 here; 192, 256 and past them up to 768 on the wgmma
// cores with bias blocks (attention_sublayer.cu).  Returns a cudaError_t
// value.
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
  if (H > 0 && C % H == 0 && C / H > 128)
    return dyt_mha_windowed_wide(qkv, bias, out, B, N, C, H, head_stride,
                                 row_stride, scale, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
