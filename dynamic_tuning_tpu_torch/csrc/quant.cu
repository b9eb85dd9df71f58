// Int8 (W8A8) serving kernels.
//
// Replaces the TPU kernels of dynamic_tuning_tpu/ops/quant.py:
//   K4  q8_ln_mlp (_q8_mlp_kernel):            LN -> int8 fc1 -> GELU -> int8 fc2
//   K5  attention_sublayer_serving_q8 (_attn_sublayer_q8_kernel):
//       x + proj(core(qkv(LN(x)))) with int8 qkv and proj
//   K6  dyt_prologue_serving_q8 (_dyt_prologue_q8_kernel): K5's x_mid, then
//       the adapter/router kernel of dyt_prologue.cu unchanged
//   K10 attn_core_pairs_q8:                    the core with an int8 QK^T
//   K12 q8_dispatch_mlp (_q8_dispatch_mlp_kernel): the top-K rows of each
//       sample gathered through an index into K4's chain, the MLP rows
//       scattered back to their tokens (zeros elsewhere), and the gate
// and computes the GEMMs of scripts/profile_int8.py::make_mm (K16, the int8
// / bf16 matmul probe): int8 x int8 -> int32 and bf16 x bf16 -> fp32, stored
// raw.  The int8 GEMM's epilogues are q8_gemm.cuh's; the int8 patch-embed
// stem (XLA's q8_conv there) is q8_stem.cu.
//
// Scheme: per-output-channel int8 weights (quantized once at load by the
// caller) times dynamic per-row int8 activations,
//     out[m, n] = ((float)sum_k qa[m,k] qw[n,k] * row_scale[m]) * col_scale[n]
//
// What bounds it on an H100.  At ViT-B/16 serving shapes (M = 128*197 rows,
// C = 768) the sublayer does 119 G int8 ops in qkv/proj (60 us at the
// 1979 TOPS int8 peak) and the MLP 238 G (120 us); the bf16 attention core
// adds 15 GFLOP.  Moving the activations through device memory -- int8
// codes, the bf16 qkv buffer, the fp32 GELU output that fc2's row
// quantization needs -- costs more: ~0.25 GB for the sublayer and ~0.5 GB
// for the MLP at dense rows (75 and 150 us at 3.35 TB/s).  The GEMMs were
// an Ampere-style mma.sync form (a cp.async ring and ldmatrix) at 300-420
// TOPS, under torch._int_mm's 510-720: the tensor-core rate, not the bytes,
// decided.  Fusing the quantizers into the GEMMs is later work.
//
// What the design does about it.  Short chains of kernels on the caller's
// stream, each following the TPU kernel's rounding points exactly:
//   ln_quant_kernel   one warp per row: fp32 LN (eps 1e-6), row amax,
//                     codes rint(v * 127/amax) clipped to +-127, scale
//                     amax * (1/127); the LN output never leaves registers;
//                     K12 reads its rows through the selection's index and
//                     writes the gate and the rows' scatter targets;
//   row_quant_kernel  the same quantization of a bf16 or fp32 row;
//   gemm_nt_kernel<int8_t> (gemm.cuh, the bf16 GEMM's design on int8: a
//                     persistent grid, a TMA ring of 128-deep k tiles fed by
//                     one producer thread, two consumer warpgroups on wgmma
//                     m64nNk32 s8 x s8 -> s32) with EpiQ8 (q8_gemm.cuh),
//                     an epilogue that dequantizes and applies the
//                     caller's bias / GELU / residual arithmetic in fp32
//                     and stores whole 16-byte
//                     pieces of rows staged through shared memory (K12's fc2
//                     stores each row at its token), or stores the int32
//                     sums as they are (K16);
//   attn_core_q8_kernel (K10) one warpgroup per (sample, head), the two
//                     heads of a pair a cluster: the k lane means and codes
//                     (quantized over the pair's 2*hd lanes, the TPU's one
//                     128-lane row, the row amaxes traded in the cluster)
//                     built in shared memory, q quantized per head row in
//                     registers, s32 Q K^T on wgmma, then the clamped exp
//                     and the bf16 P V of the bf16 core; at head dims 64 to
//                     256 while the pair's codes and V fit a block.  Past
//                     that N, and at head dims 320 to 768, K10 runs on
//                     q8_ring.cu's wgmma key ring (the codes from
//                     q8_codes.cuh, keys in 32-row tiles by TMA); on fp32
//                     qkv at head dims 64 to 256 on exact_core.cu's
//                     int8-score mode (IMMA scores, DMMA P V), past that
//                     and past 768 on simt_core_q8.cu's SIMT form.
// Every rounding step uses the _rn intrinsics (mul/add/sub of common.cuh):
// nvcc would otherwise contract a * b + c into one FMA, which rounds once
// where the TPU kernel rounds twice.
#include <type_traits>

#include "q8_gemm.cuh"

extern "C" int dyt_attn_core(const void* qkv, void* out, int B, int N, int C,
                             int H, float scale, void* stream);
extern "C" int dyt_exact_core(const float* qkv, float* out, int B, int N,
                              int C, int H, float scale, void* stream);
extern "C" int dyt_exact_core_q8(const float* qkv, float* out, void* scratch,
                                 int B, int N, int C, int H, float scale,
                                 void* stream);
extern "C" int dyt_simt_core_exact(const float* qkv, float* out, int B,
                                   int N, int C, int H, float scale,
                                   void* stream);
extern "C" int dyt_simt_core_q8(const void* qkv, void* out, void* scratch,
                                int B, int N, int C, int H, float scale,
                                int t_f32, void* stream);
extern "C" int dyt_attn_core_q8_ring(const void* qkv, void* out,
                                     void* scratch, int B, int N, int C,
                                     int H, float scale, void* stream);
extern "C" int dyt_simt_core_qkv(const void* qkv, void* out, int B, int N,
                                 int C, int H, float scale, int t_f32,
                                 void* stream);

namespace dyt {

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// where(amax > 0, 127 / amax, 0), an IEEE division (no fast math)
__device__ __forceinline__ float inv127(float amax) {
  return amax > 0.f ? 127.f / amax : 0.f;
}
__device__ __forceinline__ float row_scale(float amax) {
  return mul(amax, F32C(1.0 / 127.0));
}
// round half to even, clip to +-127
__device__ __forceinline__ int q8(float v, float inv) {
  return static_cast<int>(fminf(fmaxf(rintf(mul(v, inv)), -127.f), 127.f));
}
__device__ __forceinline__ unsigned pack_s8x4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) |
         (static_cast<unsigned>(d & 0xff) << 24);
}
__device__ __forceinline__ void store_codes8(int8_t* p, const float* v,
                                             float inv) {
  uint2 u;
  u.x = pack_s8x4(q8(v[0], inv), q8(v[1], inv), q8(v[2], inv), q8(v[3], inv));
  u.y = pack_s8x4(q8(v[4], inv), q8(v[5], inv), q8(v[6], inv), q8(v[7], inv));
  *reinterpret_cast<uint2*>(p) = u;
}

// ---------------------------------------------------------------------------
// Row quantizers: one warp per row, each lane on 8-element chunks (C % 8 == 0).

constexpr int MAX_CHUNKS = 4;   // LN rows of up to 32 * 8 * 4 = 1024 columns

// K12's selection, read by ln_quant_kernel: row m = b * cap + k of the LN
// rows is token idx[m] of sample b.  With idx null, row m is x's row m.
template <typename TX>
struct RowGather {
  const int64_t* idx = nullptr;   // [B * cap] token of each row
  const uint8_t* keep = nullptr;  // [B * cap] 1 where the row's MLP output
                                  // is kept (score above the threshold)
  int cap = 0, tokens = 0;        // rows and tokens per sample
  int* dst = nullptr;             // out [B * cap]: the x row a kept row's
                                  // output goes to, -1 for a dropped one
  TX* gate = nullptr;             // out [B, tokens]: keep at each selected
                                  // token (the caller zeroes the rest)
};

template <typename TX>
__global__ void __launch_bounds__(256)
ln_quant_kernel(const TX* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ b, int8_t* __restrict__ q,
                float* __restrict__ rs, int M, int C, RowGather<TX> sel) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  size_t src = row;
  if (sel.idx != nullptr) {
    src = (size_t)(row / sel.cap) * sel.tokens + sel.idx[row];
    if (lane == 0) {
      const bool kept = sel.keep[row] != 0;
      sel.dst[row] = kept ? static_cast<int>(src) : -1;
      sel.gate[src] = from_f32<TX>(kept ? 1.f : 0.f);
    }
  }
  const TX* xr = x + src * C;
  const int nch = C / 8;
  float v[MAX_CHUNKS][8];
  // both means summed in float64, one rounding to fp32 after the division:
  // independent of the summation order, so the plain version
  // (mha_serving.py::layernorm_f32) gets the same bits
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (lane + 32 * i < nch) {
      load8(xr + c, v[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[i][e];
    }
  }
  const float mu = static_cast<float>(warp_sum_f64(s) / C);
  double var = 0.0;
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    if (lane + 32 * i < nch) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = sub(v[i][e], mu);
        var += mul(d, d);
      }
    }
  }
  const float r =
      rsqrtf(add(static_cast<float>(warp_sum_f64(var) / C), F32C(1e-6)));
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (lane + 32 * i < nch) {
      float gg[8], bb[8];
      load8(g + c, gg);
      load8(b + c, bb);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        // ((x - mu) * r) * gamma + beta, each op rounded
        v[i][e] = add(mul(mul(sub(v[i][e], mu), r), gg[e]), bb[e]);
        amax = fmaxf(amax, fabsf(v[i][e]));
      }
    }
  }
  amax = warp_max(amax);
  const float inv = inv127(amax);
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (lane + 32 * i < nch) store_codes8(q + (size_t)row * C + c, v[i], inv);
  }
  if (lane == 0) rs[row] = row_scale(amax);
}

// amax_in: the rows' amax when a GEMM epilogue has already taken it (one
// pass over x instead of two), else nullptr
template <typename TI>
__global__ void __launch_bounds__(256)
row_quant_kernel(const TI* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ rs, int M, int K,
                 const float* __restrict__ amax_in) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const TI* xr = x + (size_t)row * K;
  float amax = 0.f;
  if (amax_in != nullptr) {
    amax = amax_in[row];
  } else {
    for (int c = lane * 8; c < K; c += 256) {
      float v[8];
      load8(xr + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
    amax = warp_max(amax);
  }
  const float inv = inv127(amax);
  for (int c = lane * 8; c < K; c += 256) {
    float v[8];
    load8(xr + c, v);
    store_codes8(q + (size_t)row * K + c, v, inv);
  }
  if (lane == 0) rs[row] = row_scale(amax);
}

template <typename TI>
static cudaError_t launch_row_quant(const TI* x, int8_t* q, float* rs, int M,
                                    int K, const float* amax_in,
                                    cudaStream_t s) {
  row_quant_kernel<TI><<<(M + 7) / 8, 256, 0, s>>>(x, q, rs, M, K, amax_in);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K10: the attention core with an int8 Q K^T, on the raw [B, N, 3C] bf16 qkv
// buffer, writing [B, N, C] bf16 (H even, hd 64, 128, 192 or 256).  Per
// sample b and
// head h of the pair p = h / 2:
//   kc = k_p - mean_n(k_p)   per lane of the pair's 2 hd lanes (the mean
//                            summed in float64, rounded once)
//   kq, ks = row quant of kc over the 2 hd lanes (one scale a pair row)
//   qq, qs = row quant of fp32 q * scale over the head's hd lanes
//   s = (float(qq . kq_h) * qs) * ks;  e = expf(clip(s, -60, 80) - 20)
//   l = sum(e) in fp32;  o = (bf16(e) @ v in fp32) * (1 / l) -> bf16
//
// What bounds it on an H100.  At ViT-B/16 serving shapes (B = 128, N = 197,
// 12 heads of 64) it moves 155 MB (q, k and v read, the output written:
// 0.046 ms at 3.35 TB/s) for 7.6 G int8 and 7.6 GFLOP bf16 of products, and
// takes one exp a score (60 M).  The mma.sync form this replaces wrote the
// k codes and scales to device memory in a kernel of its own and read them
// back (116 MB more), and its core staged V and the codes with plain loads
// behind one barrier, overlapping nothing: 0.20 ms.
//
// What the design does about it.  One kernel, the bf16 serving core's
// (attention_sublayer.cu, attn_core_kernel) with int8 scores; one warpgroup
// per (sample, head), the two heads of a pair a cluster of two blocks:
//   * the key codes never leave the cluster, and each key is read once: a
//     block copies its head's k rows (cp.async, all in flight at once) into
//     the shared memory V will take later, sums its lanes' means in float64
//     and takes each centred row's amax over its lanes; the two blocks
//     trade those row amaxes through distributed shared memory, so each
//     quantizes its lanes with the pair row's scale, straight into the
//     K-major 128-byte swizzle that 8-bit wgmma takes (a row of 128 bytes:
//     the head's 64 codes at its half of the pair row at hd 64, its 128 at
//     hd 128).  (A block that read the whole pair's keys twice, from L2,
//     spent 70 us of 0.21 ms there: utils/core_ablation.py, PERF.md);
//   * then V comes into the same shared memory by cp.async, while the first
//     query tile's Q K^T and exp run;
//   * per 64-row query tile, q is loaded and quantized per head row straight
//     into the A layout in registers; Q K^T runs on wgmma m64nNk32 s8 (A
//     from registers), the scores are dequantized, exponentiated and summed
//     into l in registers, and P V runs on bf16 wgmma with p from registers
//     against V read N-major.  Up to 256 keys the whole score row is one
//     chunk (208 or 256 keys); past that 64-key chunks are
//     software-pipelined over two score buffers, as in the bf16 core.
// The means are exact float64 sums and every rounding step the parent's,
// so the codes and scales are its bits; the scores are exact int32 sums,
// l sums the fp32 e in the mma.sync form's order (8-key groups in key
// order, then across the quad), and the exp is expf (ex2.approx moved the
// int8 gates under chip_smoke.py's bound in the bf16 core).  Only P V's
// fp32 sums could round otherwise; PERF.md has the comparison.
//
// Head dims 192 and 256 (dynamic_tuning_tpu/ops/quant.py:309 is generic in
// hd; the SIMT int8-score form served them before, at 7% of its bound).
// The codes of a head row take two 128-byte column blocks, each its own
// K-major swizzled tile that Q K^T's k32 steps walk; a k row of the k pass
// is a warp.  The whole-row chunk's 104-128 score registers beside o's 96
// or 128 would pass 255, so the chunks are the wide bf16 core's: 64 keys
// pipelined over two buffers at hd 192, 32 keys one by one at hd 256.  One
// block an SM (its layout takes 160-202 KB at N = 197); past the N whose
// layout fits (~300 at hd 192, ~240 at 256) the route is
// q8_ring.cu's key ring.

constexpr int Q8C_THREADS = 128;         // one warpgroup a block
constexpr int Q8C_STREAM_KEYS = 64;      // keys a chunk past 256 keys

// Shared memory: the key codes [CB][code_rows][128 B] (CB column blocks of
// 128 codes; rows past N zero), V's 128-byte swizzled tile [HD / 64][rows]
// [64] bf16 (first the head's k rows, [N][HD] bf16), the key scales, this
// head's row amaxes and the pair's row amaxes [code_rows] fp32 each, the
// head's lane means [HD] and a 64-row query tile in rows of HD + 8 bf16,
// from a 1024-byte boundary.  The codes span every row the last KC-wide
// chunk reads.  The float64 partial sums of the means [RG][HD] (8 KB) use
// the codes' room before the codes are written.  A k row is TPR threads of
// the k pass: its CPR 8-lane pieces, and at head dims 192 and 256 a whole
// warp (24 or 32 pieces; the rest idle), so a row's shuffles stay in it.
template <int HD, int KC>
struct CoreQ8Layout {
  static constexpr int CPR = HD / 8;                // 8-lane pieces a k row
  static constexpr int TPR = HD <= 128 ? CPR : 32;  // threads a k row
  static constexpr int CB = HD <= 128 ? 1 : (HD + 127) / 128;
  static constexpr int LDQ = HD + 8;                // query tile row, elements
  static constexpr int RG = Q8C_THREADS / TPR;      // k rows a pass takes
  __host__ __device__ static int rows(int N) { return (N + 15) / 16 * 16; }
  __host__ __device__ static int code_rows(int N) {
    const int kr = (N + KC - 1) / KC * KC;
    return kr > rows(N) ? kr : rows(N);
  }
  __host__ __device__ static int v_off(int N) {
    return CB * code_rows(N) * 128;
  }
  __host__ __device__ static int ks_off(int N) {
    return v_off(N) + rows(N) * HD * 2;
  }
  __host__ __device__ static int mean_off(int N) {
    return ks_off(N) + 3 * code_rows(N) * 4;
  }
  __host__ __device__ static int q_off(int N) { return mean_off(N) + HD * 4; }
  static int smem_bytes(int N) { return 1024 + q_off(N) + 64 * LDQ * 2; }
};

// the cluster's barrier, in two halves
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the float at ``p``'s offset in the shared memory of cluster block ``rank``
__device__ __forceinline__ float ld_cluster(const float* p, unsigned rank) {
  unsigned a;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(a)
               : "memory");
  return v;
}

template <int HD, int KC>
__global__ void __cluster_dims__(2, 1, 1)
__launch_bounds__(Q8C_THREADS, HD == 64 && KC <= 208 ? 3 : HD <= 128 ? 2 : 1)
attn_core_q8_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                    int N, int H, float scale) {
  using L = CoreQ8Layout<HD, KC>;
  constexpr bool STREAM = KC == Q8C_STREAM_KEYS;     // two score buffers
  constexpr int DK = HD / 32;          // k32 steps of Q K^T
  constexpr int NS = KC / 2;           // score accumulators a thread
  constexpr int PS = KC / 16;          // k16 steps of P V a chunk
  constexpr int CPR = L::CPR, TPR = L::TPR, RG = L::RG;
  extern __shared__ unsigned char smem_raw[];
  const int np = L::rows(N), kr = L::code_rows(N);
  const int nkc = (N + KC - 1) / KC, nq = (N + 63) / 64;
  unsigned char* Kq = align1024(smem_raw);
  unsigned char* Vt = Kq + L::v_off(N);
  const bf16* Kraw = reinterpret_cast<const bf16*>(Vt);
  float* ks = reinterpret_cast<float*>(Kq + L::ks_off(N));
  float* ramax = ks + kr;             // this head's lanes
  float* pamax = ramax + kr;          // the pair's
  float* mean = reinterpret_cast<float*>(Kq + L::mean_off(N));
  bf16* Qs = reinterpret_cast<bf16*>(Kq + L::q_off(N));
  double* part = reinterpret_cast<double*>(Kq);

  const int C = H * HD, C3 = 3 * C;
  // the cluster's two blocks are the pair's heads: h's rank is h & 1
  const int b = blockIdx.x / H, h = blockIdx.x % H, hh = h & 1;
  const bf16* base = qkv + (size_t)b * N * C3;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, t2 = t * 2;

  // rows qt * 64 .. + 63 of this head's q into Qs (zeros past N)
  auto stage_q = [&](int qt) {
    for (int i = tid; i < 64 * CPR; i += Q8C_THREADS) {
      const int r = i / CPR, c = i % CPR, n = qt * 64 + r;
      cp_async16(Qs + r * L::LDQ + c * 8,
                 n < N ? base + (size_t)n * C3 + h * HD + c * 8 : base,
                 n < N ? 16 : 0);
    }
  };
  // groups: this head's k rows (row-major, all in flight at once), then the
  // first query tile
  for (int i = tid; i < N * CPR; i += Q8C_THREADS) {
    const int n = i / CPR, c = i % CPR;
    cp_async16(Vt + i * 16, base + (size_t)n * C3 + C + h * HD + c * 8, 16);
  }
  cp_async_commit();
  stage_q(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // lanes c * 8 .. c * 8 + 7 of rows rg, rg + RG, ... (c < CPR)
  const int c = tid % TPR, rg = tid / TPR;
  const bool piece = c < CPR;
  if (piece) {
    double acc[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    for (int n = rg; n < N; n += RG) {
      float v[8];
      load8(Kraw + n * HD + c * 8, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += v[e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) part[rg * HD + c * 8 + e] = acc[e];
  }
  __syncthreads();
  for (int l = tid; l < HD; l += Q8C_THREADS) {
    double sum = 0.0;
#pragma unroll
    for (int r = 0; r < RG; ++r) sum += part[r * HD + l];
    mean[l] = static_cast<float>(sum / N);
  }
  __syncthreads();
  float mu[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) mu[e] = piece ? mean[c * 8 + e] : 0.f;
  // the centred row n, these 8 lanes
  auto centred = [&](int n, float (&v)[8]) {
    load8(Kraw + n * HD + c * 8, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = sub(v[e], mu[e]);
  };

  // each row's amax over this head's lanes (TPR threads a row; every
  // thread runs the same trips, for the shuffles)
  for (int n0 = 0; n0 < N; n0 += RG) {
    const int n = n0 + rg;
    float amax = 0.f;
    if (n < N && piece) {
      float v[8];
      centred(n, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (c == 0 && n < N) ramax[n] = amax;
  }
  // the pair row's amax: this head's and the partner block's
  cluster_arrive();
  cluster_wait();
  for (int n = tid; n < N; n += Q8C_THREADS) {
    const float amax = fmaxf(ramax[n], ld_cluster(ramax + n, hh ^ 1));
    pamax[n] = amax;
    ks[n] = row_scale(amax);
  }
  cluster_arrive();                // this block has read the partner's
  __syncthreads();

  // the codes, at the head's bytes of each 128-byte row (of column block
  // byte / 128 past hd 128)
  const int koff = HD == 64 ? hh * 64 : 0;
  for (int n = rg; n < N && piece; n += RG) {
    float v[8];
    centred(n, v);
    const int byte = koff + c * 8, cb = byte >> 7, wb = byte & 127;
    store_codes8(reinterpret_cast<int8_t*>(Kq + cb * kr * 128 + n * 128 +
                                           ((((wb >> 4) ^ n) & 7) << 4) +
                                           (wb & 15)),
                 v, inv127(pamax[n]));
  }
  // rows past N: zero codes and scales (their scores are masked)
  for (int i = tid; i < L::CB * (kr - N) * 8; i += Q8C_THREADS) {
    const int cb = i / ((kr - N) * 8), j = i % ((kr - N) * 8);
    *reinterpret_cast<uint4*>(Kq + cb * kr * 128 + (N + j / 8) * 128 +
                              (j % 8) * 16) = make_uint4(0, 0, 0, 0);
  }
  for (int n = N + tid; n < kr; n += Q8C_THREADS) ks[n] = 0.f;
  fence_proxy_async();             // the codes visible to the tensor cores
  __syncthreads();                 // and the k rows read: V replaces them
  stage_sw128<HD>(Vt, base + 2 * C + h * HD, C3, 0, np, N, tid,
                  Q8C_THREADS);
  cp_async_commit();

  for (int qt = 0; qt < nq; ++qt) {
    const int n_lo = qt * 64 + warp * 16 + g, n_hi = n_lo + 8;
    const bool live = qt * 64 + warp * 16 < N;     // the same for the warp
    if (qt == 0) {
      cp_async_wait<1>();          // this Q tile (V may be in flight)
    } else {
      cp_async_wait<0>();          // the Q tile copied in last time
    }
    __syncthreads();
    // q * scale in fp32 (not rounded), quantized per head row straight in
    // the A layout: register e of k step d holds row (e & 1 ? hi : lo),
    // bytes d * 32 + t * 4 + (e >> 1) * 16 .. + 3 (the four bf16 values
    // held packed, scaled once for the amax and once more, the same
    // product, for the codes)
    uint2 qr[DK][4];
#pragma unroll
    for (int d = 0; d < DK; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        qr[d][e] = *reinterpret_cast<const uint2*>(
            Qs + (warp * 16 + g + (e & 1) * 8) * L::LDQ + d * 32 + t * 4 +
            (e >> 1) * 16);
    __syncthreads();               // every warp has read this Q tile
    if (qt + 1 < nq) stage_q(qt + 1);
    cp_async_commit();
    auto scaled = [&](int d, int e, float (&v)[4]) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&qr[d][e].x));
      const float2 cc = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&qr[d][e].y));
      v[0] = mul(a.x, scale); v[1] = mul(a.y, scale);
      v[2] = mul(cc.x, scale); v[3] = mul(cc.y, scale);
    };
    float am_lo = 0.f, am_hi = 0.f;
#pragma unroll
    for (int d = 0; d < DK; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v[4];
        scaled(d, e, v);
        float m = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) m = fmaxf(m, fabsf(v[i]));
        if (e & 1) am_hi = fmaxf(am_hi, m); else am_lo = fmaxf(am_lo, m);
      }
    // each row is spread over the four lanes of its quad
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      am_lo = fmaxf(am_lo, __shfl_xor_sync(0xffffffffu, am_lo, m));
      am_hi = fmaxf(am_hi, __shfl_xor_sync(0xffffffffu, am_hi, m));
    }
    const float inv_lo = inv127(am_lo), inv_hi = inv127(am_hi);
    const float qs_lo = row_scale(am_lo), qs_hi = row_scale(am_hi);
    unsigned qf[DK][4];
#pragma unroll
    for (int d = 0; d < DK; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float inv = (e & 1) ? inv_hi : inv_lo;
        float v[4];
        scaled(d, e, v);
        qf[d][e] = pack_s8x4(q8(v[0], inv), q8(v[1], inv), q8(v[2], inv),
                             q8(v[3], inv));
      }
    float o[HD / 2];
    float l_lo = 0.f, l_hi = 0.f;

    // Q K^T of key chunk kc into s (int32)
    auto qk = [&](int (&s)[NS], int kc) {
#pragma unroll
      for (int d = 0; d < DK; ++d)
        wgmma_rs_s8<KC>(s, qf[d],
                        desc_sw128(Kq + (d / 4) * kr * 128 + kc * KC * 128 +
                                   koff + (d % 4) * 32),
                        d > 0);
    };
    // chunk kc, its scores in s: (streaming) the next chunk's Q K^T issued,
    // then e = expf(clip(s * qs * ks, -60, 80) - 20) in place as fp32 bits
    // (keys past N give 0), l, and P V issued.  Element 4 j + e of s is key
    // kc * KC + 8 j + t2 + (e & 1).
    auto chunk = [&](int (&s)[NS], int (&nxt)[NS], int kc) {
      if (STREAM && kc + 1 < nkc) {
        wgmma_fence();
        qk(nxt, kc + 1);
        wgmma_commit();
        wgmma_wait<1>();           // this chunk's scores (and P V before)
      } else {
        wgmma_wait<0>();
      }
      unsigned pf[PS][4];
      if (live) {
        const bool last = kc * KC + KC > N;
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) {
          // keys past the padded rows: P V never reads them
          if (last && kc * KC + j * 8 >= np) continue;
          const int k0 = kc * KC + j * 8 + t2;
          const float2 kscl = *reinterpret_cast<const float2*>(ks + k0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float sv = mul(mul(__int2float_rn(s[4 * j + e]),
                                     e < 2 ? qs_lo : qs_hi),
                                 (e & 1) ? kscl.y : kscl.x);
            float p = expf(fminf(fmaxf(sv, -60.f), 80.f) - 20.f);
            if (last && k0 + (e & 1) >= N) p = 0.f;
            s[4 * j + e] = __float_as_int(p);
          }
          l_lo += __int_as_float(s[4 * j]) + __int_as_float(s[4 * j + 1]);
          l_hi += __int_as_float(s[4 * j + 2]) + __int_as_float(s[4 * j + 3]);
        }
        // the A fragments of P V, one per 16 keys (two n8 score tiles)
#pragma unroll
        for (int st = 0; st < PS; ++st)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pf[st][i] = pack_bf16x2(__int_as_float(s[8 * st + 2 * i]),
                                    __int_as_float(s[8 * st + 2 * i + 1]));
      } else {
#pragma unroll
        for (int st = 0; st < PS; ++st)
          pf[st][0] = pf[st][1] = pf[st][2] = pf[st][3] = 0u;
      }
      if (qt == 0 && kc == 0) {
        cp_async_wait<1>();        // V (the newest group is the next Q tile)
        fence_proxy_async();
        __syncthreads();
      }
      // P V over this chunk's 16-key steps inside the padded rows
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < PS; ++st) {
        const int r = kc * KC + st * 16;
        if (r < np)
          wgmma_rs<HD, true>(o, pf[st], desc_sw128_mn(Vt + r * 128, np * 128),
                             r > 0);
      }
      wgmma_commit();
    };

    if constexpr (STREAM) {
      int sa[NS], sb[NS];
      wgmma_fence();
      qk(sa, 0);
      wgmma_commit();
      for (int kc = 0; kc < nkc; kc += 2) {
        chunk(sa, sb, kc);
        if (kc + 1 < nkc) chunk(sb, sa, kc + 1);
      }
    } else if constexpr (KC == 32) {
      // hd 256: 32-key chunks one by one (the wide core's plan)
      int s[NS];
      for (int kc = 0; kc < nkc; ++kc) {
        wgmma_fence();
        qk(s, kc);
        wgmma_commit();
        chunk(s, s, kc);
      }
    } else {
      int s[NS];
      wgmma_fence();
      qk(s, 0);
      wgmma_commit();
      chunk(s, s, 0);
    }
    wgmma_wait<0>();
    if (!live) continue;

#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, m);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, m);
    }
    const float inv_l_lo = __frcp_rn(l_lo), inv_l_hi = __frcp_rn(l_hi);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = h * HD + j * 8 + t2;
      if (n_lo < N)
        store2(out + ((size_t)b * N + n_lo) * C + col, o[4 * j] * inv_l_lo,
               o[4 * j + 1] * inv_l_lo);
      if (n_hi < N)
        store2(out + ((size_t)b * N + n_hi) * C + col,
               o[4 * j + 2] * inv_l_hi, o[4 * j + 3] * inv_l_hi);
    }
  }
  cluster_wait();                  // the partner has read this block's amaxes
}

template <int HD, int KC>
static cudaError_t launch_core_q8_kc(const bf16* qkv, bf16* out, int B,
                                     int N, int H, float scale,
                                     cudaStream_t s) {
  const int smem = CoreQ8Layout<HD, KC>::smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      attn_core_q8_kernel<HD, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attn_core_q8_kernel<HD, KC><<<B * H, Q8C_THREADS, smem, s>>>(qkv, out, N,
                                                               H, scale);
  return cudaGetLastError();
}

// the chunk width for N, as the bf16 core: the whole row (13 or 16 chunks of
// 16 keys) up to 256 keys, else 64-key chunks; at head dims 192 and 256 the
// wide core's chunks at every N (64 keys pipelined, 32 one by one), whose
// score registers leave room for o's 96 or 128
template <int HD>
static cudaError_t launch_attn_core_q8(const bf16* qkv, bf16* out, int B,
                                       int N, int H, float scale,
                                       cudaStream_t s) {
  if constexpr (HD > 128) {
    return launch_core_q8_kc<HD, HD <= 192 ? 64 : 32>(qkv, out, B, N, H,
                                                      scale, s);
  } else {
    const int nc = (N + 15) / 16;
    if (nc <= 13)
      return launch_core_q8_kc<HD, 208>(qkv, out, B, N, H, scale, s);
    if (nc <= 16)
      return launch_core_q8_kc<HD, 256>(qkv, out, B, N, H, scale, s);
    return launch_core_q8_kc<HD, Q8C_STREAM_KEYS>(qkv, out, B, N, H, scale,
                                                  s);
  }
}

template <int HD>
static int core_q8_smem_bytes(int N) {
  if constexpr (HD > 128) {
    return CoreQ8Layout<HD, HD <= 192 ? 64 : 32>::smem_bytes(N);
  } else {
    const int nc = (N + 15) / 16;
    if (nc <= 13) return CoreQ8Layout<HD, 208>::smem_bytes(N);
    if (nc <= 16) return CoreQ8Layout<HD, 256>::smem_bytes(N);
    return CoreQ8Layout<HD, Q8C_STREAM_KEYS>::smem_bytes(N);
  }
}

static cudaError_t attn_core_q8(const bf16* qkv, bf16* out, int B, int N,
                                int C, int H, float scale, cudaStream_t s) {
  if (H <= 0 || H % 2 || N <= 0 || B <= 0) return cudaErrorInvalidValue;
  if (C == 64 * H)
    return launch_attn_core_q8<64>(qkv, out, B, N, H, scale, s);
  if (C == 128 * H)
    return launch_attn_core_q8<128>(qkv, out, B, N, H, scale, s);
  if (C == 192 * H)
    return launch_attn_core_q8<192>(qkv, out, B, N, H, scale, s);
  if (C == 256 * H)
    return launch_attn_core_q8<256>(qkv, out, B, N, H, scale, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The chains

// the chain's core forms (the caller's route, ops/mha_serving.py::core_of)
constexpr int CORE_TENSOR = 0, CORE_SIMT = 1, CORE_Q8_RING = 2;

// The chain with its qkv and core-output scratch in TS: bf16 (K5, and K6 /
// K8 with bf16 adapters) or fp32 (K6 / K8 with fp32 adapters, JAX's
// ``adtype``: the int8 GEMM's epilogue stores the fp32 qkv, the exact core
// runs on it with its sums in float64, as the plain version's, so its fp32
// output is row-quantized for proj into the plain version's codes).
// ``core`` selects the core's form: CORE_TENSOR (0) the tensor-core one,
// CORE_SIMT (1) the SIMT core's, CORE_Q8_RING (2) the int8-score wgmma key
// ring.  With int8 scores (attn_q8) on a bf16 scratch: K10's staged wgmma
// form, the SIMT int8-score form or the ring; on an fp32 scratch the exact
// core's int8-score mode (exact_core.cu, IMMA scores and DMMA P V, head
// dims 64 to 256) or the SIMT int8-score form (past 256); on an
// fp32 scratch without them the exact SIMT slices kernel (simt_core.cu, past
// head dim 256) over the DMMA exact core (exact_core.cu, head dims 64 to
// 256); on a bf16 scratch without them the SIMT core over
// attention_sublayer.cu's wgmma core.  The caller decides.
// ``core_scratch`` holds the codes of every int8-score form but K10's
// staged one (attn_q8 with CORE_SIMT or CORE_Q8_RING, or on an fp32
// scratch).
template <typename TX, typename TS>
static cudaError_t sublayer_q8(const TX* x, const float* gamma,
                               const float* beta, const int8_t* wqkv,
                               const float* sqkv, const float* bqkv,
                               const int8_t* wproj, const float* sproj,
                               const float* bproj, TX* out, float* xm32,
                               int8_t* a8, float* rs, TS* qkv_buf,
                               TS* attn_buf, void* core_scratch, int B, int N,
                               int C, int H, float scale, int attn_q8,
                               int core, cudaStream_t s) {
  constexpr bool F32 = std::is_same<TS, float>::value;
  if (core < CORE_TENSOR || core > CORE_Q8_RING ||
      (core == CORE_Q8_RING && (F32 || !attn_q8)))
    return cudaErrorInvalidValue;
  const bool simt_core = core == CORE_SIMT;
  const int M = B * N;
  if (C % 8 || C > 32 * 8 * MAX_CHUNKS) return cudaErrorInvalidValue;
  ln_quant_kernel<TX><<<(M + 7) / 8, 256, 0, s>>>(x, gamma, beta, a8, rs, M,
                                                  C, RowGather<TX>{});
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_gemm_s8<Q8_OUT, TS>(a8, wqkv, rs, sqkv, bqkv, M, 3 * C, C,
                                   qkv_buf, nullptr, nullptr, nullptr, s);
  if (err != cudaSuccess) return err;
  if constexpr (F32) {
    if (attn_q8)
      err = static_cast<cudaError_t>(
          simt_core ? dyt_simt_core_q8(qkv_buf, attn_buf, core_scratch, B, N,
                                       C, H, scale, 1, s)
                    : dyt_exact_core_q8(qkv_buf, attn_buf, core_scratch, B,
                                        N, C, H, scale, s));
    else
      err = static_cast<cudaError_t>(
          simt_core ? dyt_simt_core_exact(qkv_buf, attn_buf, B, N, C, H,
                                          scale, s)
                    : dyt_exact_core(qkv_buf, attn_buf, B, N, C, H, scale,
                                     s));
  } else if (attn_q8) {
    err = core == CORE_Q8_RING
              ? static_cast<cudaError_t>(dyt_attn_core_q8_ring(
                    qkv_buf, attn_buf, core_scratch, B, N, C, H, scale, s))
          : simt_core ? static_cast<cudaError_t>(dyt_simt_core_q8(
                            qkv_buf, attn_buf, core_scratch, B, N, C, H,
                            scale, 0, s))
                      : attn_core_q8(qkv_buf, attn_buf, B, N, C, H, scale,
                                     s);
  } else {
    err = static_cast<cudaError_t>(
        simt_core ? dyt_simt_core_qkv(qkv_buf, attn_buf, B, N, C, H, scale, 0,
                                      s)
                  : dyt_attn_core(qkv_buf, attn_buf, B, N, C, H, scale, s));
  }
  if (err != cudaSuccess) return err;
  err = launch_row_quant<TS>(attn_buf, a8, rs, M, C, nullptr, s);
  if (err != cudaSuccess) return err;
  return launch_gemm_s8<Q8_RESID, TX>(a8, wproj, rs, sproj, bproj, M, C, C,
                                      out, x, xm32, nullptr, s);
}

// K4 on M rows of x; with sel.idx (K12) on the M = B * cap selected rows,
// fc2 storing each kept row at its token of out (which the caller zeroed)
template <typename TX>
static cudaError_t ln_mlp_q8(const TX* x, const float* gamma,
                             const float* beta, const int8_t* w1,
                             const float* s1, const float* b1,
                             const int8_t* w2, const float* s2,
                             const float* b2, TX* out, int8_t* a8, float* rs,
                             float* h, float* hmax, int M, int C, int Hd,
                             int approx, cudaStream_t s,
                             RowGather<TX> sel = {}) {
  if (M == 0) return cudaSuccess;
  if (C % 8 || C > 32 * 8 * MAX_CHUNKS) return cudaErrorInvalidValue;
  ln_quant_kernel<TX><<<(M + 7) / 8, 256, 0, s>>>(x, gamma, beta, a8, rs, M,
                                                  C, sel);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // fc1's epilogue takes the GELU rows' amax, so their quantization reads
  // the fp32 rows once
  err = cudaMemsetAsync(hmax, 0, sizeof(float) * M, s);
  if (err != cudaSuccess) return err;
  err = approx ? launch_gemm_s8<Q8_GELU_TANH, float>(a8, w1, rs, s1, b1, M,
                                                     Hd, C, h, nullptr,
                                                     nullptr, hmax, s)
               : launch_gemm_s8<Q8_GELU_ERF, float>(a8, w1, rs, s1, b1, M, Hd,
                                                    C, h, nullptr, nullptr,
                                                    hmax, s);
  if (err != cudaSuccess) return err;
  err = launch_row_quant<float>(h, a8, rs, M, Hd, hmax, s);
  if (err != cudaSuccess) return err;
  if (sel.idx != nullptr)
    return launch_gemm_s8<Q8_SCATTER, TX>(a8, w2, rs, s2, b2, M, C, Hd, out,
                                          nullptr, nullptr, nullptr, s,
                                          sel.dst);
  return launch_gemm_s8<Q8_OUT, TX>(a8, w2, rs, s2, b2, M, C, Hd, out,
                                    nullptr, nullptr, nullptr, s);
}

// K12: zero out and gate, then K4's chain on the selected rows
template <typename TX>
static cudaError_t dispatch_mlp_q8(const TX* x, const int64_t* idx,
                                   const uint8_t* keep, const float* gamma,
                                   const float* beta, const int8_t* w1,
                                   const float* s1, const float* b1,
                                   const int8_t* w2, const float* s2,
                                   const float* b2, TX* out, TX* gate,
                                   int8_t* a8, float* rs, float* h,
                                   float* hmax, int* row_map, int B, int N,
                                   int cap, int C, int Hd, int approx,
                                   cudaStream_t s) {
  cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(TX) * (size_t)B * N * C, s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(gate, 0, sizeof(TX) * (size_t)B * N, s);
  if (err != cudaSuccess) return err;
  return ln_mlp_q8<TX>(x, gamma, beta, w1, s1, b1, w2, s2, b2, out, a8, rs, h,
                       hmax, B * cap, C, Hd, approx, s,
                       RowGather<TX>{idx, keep, cap, N, row_map, gate});
}

// One EpiQ8 form on its own, chosen at run time (dyt_gemm_s8)
template <typename TO>
static cudaError_t gemm_s8_form(int epi, const int8_t* a, const int8_t* w,
                                const float* rs, const float* cs,
                                const float* bias, int M, int N, int K,
                                TO* out, const TO* resid, float* out_f32,
                                float* row_amax, const int* row_map,
                                cudaStream_t s) {
  switch (epi) {
    case Q8_OUT:
      return launch_gemm_s8<Q8_OUT, TO>(a, w, rs, cs, bias, M, N, K, out,
                                        nullptr, nullptr, nullptr, s);
    case Q8_RESID:
      return launch_gemm_s8<Q8_RESID, TO>(a, w, rs, cs, bias, M, N, K, out,
                                          resid, out_f32, nullptr, s);
    case Q8_SCATTER:
      return launch_gemm_s8<Q8_SCATTER, TO>(a, w, rs, cs, bias, M, N, K, out,
                                            nullptr, nullptr, nullptr, s,
                                            row_map);
    default:
      break;
  }
  if constexpr (std::is_same<TO, bf16>::value) {
    if (epi == Q8_STEM)
      return launch_gemm_s8<Q8_STEM, TO>(a, w, rs, cs, bias, M, N, K, out,
                                         nullptr, nullptr, nullptr, s);
  }
  if constexpr (std::is_same<TO, float>::value) {
    if (epi == Q8_GELU_ERF)
      return launch_gemm_s8<Q8_GELU_ERF, TO>(a, w, rs, cs, bias, M, N, K,
                                             out, nullptr, nullptr, row_amax,
                                             s);
    if (epi == Q8_GELU_TANH)
      return launch_gemm_s8<Q8_GELU_TANH, TO>(a, w, rs, cs, bias, M, N, K,
                                              out, nullptr, nullptr,
                                              row_amax, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace dyt

extern "C" {

// Shared-memory bytes of the int8 attention core at (N, hd); 0 when hd is
// not supported.
int dyt_attn_core_q8_smem_bytes(int N, int hd) {
  if (N <= 0) return 0;
  if (hd == 64) return dyt::core_q8_smem_bytes<64>(N);
  if (hd == 128) return dyt::core_q8_smem_bytes<128>(N);
  if (hd == 192) return dyt::core_q8_smem_bytes<192>(N);
  if (hd == 256) return dyt::core_q8_smem_bytes<256>(N);
  return 0;
}

// K10 alone: qkv [B, N, 3C] bf16 -> out [B, N, C] bf16 (H even).
int dyt_attn_core_q8(const void* qkv, void* out, int B, int N, int C, int H,
                     float scale, void* stream) {
  return dyt::attn_core_q8(static_cast<const dyt::bf16*>(qkv),
                           static_cast<dyt::bf16*>(out), B, N, C, H, scale,
                           static_cast<cudaStream_t>(stream));
}

// K5's chain; with xm32 also K6's first part.  x, out: [B, N, C] in the
// residual dtype (x_f32 selects fp32 over bf16); gamma/beta/biases/scales
// fp32; wqkv [3C, C], wproj [C, C] int8; xm32 an optional fp32 copy of out;
// a8 [B*N, C] int8, rs [B*N] fp32, qkv_buf [B*N, 3C] and attn_buf [B*N, C]
// scratch in bf16, or fp32 with scratch_f32; attn_q8 selects the K10 core;
// core its form (0 the tensor-core one, 1 the SIMT core's, 2 the
// int8-score key ring, bf16 with attn_q8 only); core_scratch
// dyt_simt_core_q8_scratch_bytes on 16 bytes with attn_q8 and core 1 or 2,
// or with attn_q8 on an fp32 scratch, else unused.  Returns a cudaError_t
// value.
int dyt_attention_sublayer_q8(const void* x, int x_f32, const float* gamma,
                              const float* beta, const void* wqkv,
                              const float* sqkv, const float* bqkv,
                              const void* wproj, const float* sproj,
                              const float* bproj, void* out, float* xm32,
                              void* a8, float* rs, void* qkv_buf,
                              void* attn_buf, int scratch_f32,
                              void* core_scratch, int B, int N, int C, int H,
                              float scale, int attn_q8, int core,
                              void* stream) {
  using dyt::bf16;
  auto* wq = static_cast<const int8_t*>(wqkv);
  auto* wp = static_cast<const int8_t*>(wproj);
  auto* a = static_cast<int8_t*>(a8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto* qb, auto* ab) {
    if (x_f32)
      return dyt::sublayer_q8(static_cast<const float*>(x), gamma, beta, wq,
                              sqkv, bqkv, wp, sproj, bproj,
                              static_cast<float*>(out), xm32, a, rs, qb, ab,
                              core_scratch, B, N, C, H, scale, attn_q8,
                              core, s);
    return dyt::sublayer_q8(static_cast<const bf16*>(x), gamma, beta, wq,
                            sqkv, bqkv, wp, sproj, bproj,
                            static_cast<bf16*>(out), xm32, a, rs, qb, ab,
                            core_scratch, B, N, C, H, scale, attn_q8,
                            core, s);
  };
  if (scratch_f32)
    return run(static_cast<float*>(qkv_buf), static_cast<float*>(attn_buf));
  return run(static_cast<bf16*>(qkv_buf), static_cast<bf16*>(attn_buf));
}

// K4: x, out [M, C] (x_f32 selects fp32 over bf16); w1 [Hd, C], w2 [C, Hd]
// int8 with fp32 scales and biases; a8 [M, max(C, Hd)] int8, rs and hmax
// [M] fp32, h [M, Hd] fp32 scratch; approx selects the tanh GELU.
int dyt_q8_ln_mlp(const void* x, int x_f32, const float* gamma,
                  const float* beta, const void* w1, const float* s1,
                  const float* b1, const void* w2, const float* s2,
                  const float* b2, void* out, void* a8, float* rs, float* h,
                  float* hmax, int M, int C, int Hd, int approx,
                  void* stream) {
  auto* q1 = static_cast<const int8_t*>(w1);
  auto* q2 = static_cast<const int8_t*>(w2);
  auto* a = static_cast<int8_t*>(a8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return dyt::ln_mlp_q8<float>(static_cast<const float*>(x), gamma, beta,
                                 q1, s1, b1, q2, s2, b2,
                                 static_cast<float*>(out), a, rs, h, hmax, M, C,
                                 Hd, approx, s);
  return dyt::ln_mlp_q8<dyt::bf16>(
      static_cast<const dyt::bf16*>(x), gamma, beta, q1, s1, b1, q2, s2, b2,
      static_cast<dyt::bf16*>(out), a, rs, h, hmax, M, C, Hd, approx, s);
}

// K12: x [B, N, C] (x_f32 selects fp32 over bf16); idx [B, cap] int64 and
// keep [B, cap] uint8, the top-cap selection per sample; weights as for
// dyt_q8_ln_mlp; out [B, N, C] and gate [B, N] in x's dtype; a8 [B*cap,
// max(C, Hd)] int8, rs and hmax [B*cap] fp32, h [B*cap, Hd] fp32 and
// row_map [B*cap] int32 scratch.
int dyt_q8_dispatch_mlp(const void* x, int x_f32, const void* idx,
                        const void* keep, const float* gamma,
                        const float* beta, const void* w1, const float* s1,
                        const float* b1, const void* w2, const float* s2,
                        const float* b2, void* out, void* gate, void* a8,
                        float* rs, float* h, float* hmax, void* row_map,
                        int B, int N, int cap, int C, int Hd, int approx,
                        void* stream) {
  auto* ix = static_cast<const int64_t*>(idx);
  auto* kp = static_cast<const uint8_t*>(keep);
  auto* q1 = static_cast<const int8_t*>(w1);
  auto* q2 = static_cast<const int8_t*>(w2);
  auto* a = static_cast<int8_t*>(a8);
  auto* rm = static_cast<int*>(row_map);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return dyt::dispatch_mlp_q8<float>(
        static_cast<const float*>(x), ix, kp, gamma, beta, q1, s1, b1, q2, s2,
        b2, static_cast<float*>(out), static_cast<float*>(gate), a, rs, h,
        hmax, rm, B, N, cap, C, Hd, approx, s);
  return dyt::dispatch_mlp_q8<dyt::bf16>(
      static_cast<const dyt::bf16*>(x), ix, kp, gamma, beta, q1, s1, b1, q2,
      s2, b2, static_cast<dyt::bf16*>(out), static_cast<dyt::bf16*>(gate), a,
      rs, h, hmax, rm, B, N, cap, C, Hd, approx, s);
}

// The int8 GEMM with any one Q8Epilogue form ``epi`` (its value), for the
// tests: a [M, K] and w [N, K] int8 (K % 16 == 0, N % 8 == 0); rs [M], cs [N], bias [N] fp32; out [M, N] of ``out_type`` (0 bf16,
// 1 fp32, 2 int32), or for Q8_SCATTER [rows, N] with row m at row_map[m]
// (int32 [M], none where < 0); resid [M, N] as out (Q8_RESID) and out_f32
// [M, N] fp32 or null (Q8_RESID); row_amax [M] fp32, zeroed by the caller,
// or null (the GELU forms).  Q8_RAW takes int32 out only, the GELU forms
// fp32, Q8_STEM bf16.  Returns a cudaError_t value.
int dyt_gemm_s8(int epi, int out_type, const void* a, const void* w,
                const float* rs, const float* cs, const float* bias, int M,
                int N, int K, void* out, const void* resid, float* out_f32,
                float* row_amax, const void* row_map, void* stream) {
  auto* qa = static_cast<const int8_t*>(a);
  auto* qw = static_cast<const int8_t*>(w);
  auto* rm = static_cast<const int*>(row_map);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_type == 0)
    return dyt::gemm_s8_form<dyt::bf16>(
        epi, qa, qw, rs, cs, bias, M, N, K, static_cast<dyt::bf16*>(out),
        static_cast<const dyt::bf16*>(resid), out_f32, row_amax, rm, s);
  if (out_type == 1)
    return dyt::gemm_s8_form<float>(
        epi, qa, qw, rs, cs, bias, M, N, K, static_cast<float*>(out),
        static_cast<const float*>(resid), out_f32, row_amax, rm, s);
  if (out_type == 2 && epi == dyt::Q8_RAW)
    return dyt::launch_gemm_s8<dyt::Q8_RAW, int>(
        qa, qw, nullptr, nullptr, nullptr, M, N, K, static_cast<int*>(out),
        nullptr, nullptr, nullptr, s);
  return cudaErrorInvalidValue;
}

// K16, int8: out [M, N] int32 = a [M, K] int8 . w [N, K]^T int8, the exact
// int32 sums (K % 16 == 0, N % 8 == 0).
int dyt_gemm_s8_s32(const void* a, const void* w, int M, int N, int K,
                    void* out, void* stream) {
  return dyt::launch_gemm_s8<dyt::Q8_RAW, int>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w), nullptr,
      nullptr, nullptr, M, N, K, static_cast<int*>(out), nullptr, nullptr,
      nullptr, static_cast<cudaStream_t>(stream));
}

// K16, bf16: out [M, N] fp32 = a [M, K] bf16 . w [N, K]^T bf16, fp32 sums
// (K % 8 == 0, N % 8 == 0, a and w on 16 bytes).
int dyt_gemm_bf16_f32(const void* a, const void* w, int M, int N, int K,
                      float* out, void* stream) {
  return dyt::launch_gemm_nt<dyt::EPI_F32, float>(
      static_cast<const dyt::bf16*>(a), static_cast<const dyt::bf16*>(w),
      nullptr, M, N, K, nullptr, nullptr, nullptr, out,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
