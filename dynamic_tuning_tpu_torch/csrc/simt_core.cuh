// The serving attention core on the CUDA cores (SIMT), for what the other
// cores do not take (its entries: simt_core.cu, and simt_core_q8.cu for the
// int8-score form):
//   * the exact fp32 route: the fp32 core inside the int8 chains of K6 and
//     K8 with an fp32 qkv scratch (fp32 adapters), whose output is
//     requantized, so its scores, l and o are summed in float64 (Acc) as
//     the plain version sums them, and land on its bits;
//   * the int8-score form of K10 (dynamic_tuning_tpu/ops/quant.py::
//     attn_core_pairs_q8) on fp32 qkv, on bf16 qkv at head dims 192 and 256
//     and past the N whose layout fits quant.cu's wgmma form: the k lane
//     means, the k codes of each head pair's 2 hd lanes and the per-head q
//     codes come from two small kernels (k_lane_mean_kernel,
//     q8_codes_kernel), the exact int32 Q K^T from dp4a;
//   * bf16 K9 at head dims 192 and 256 (windowed_attention.cu is built for
//     64 and 128), its bf16 [H, N, N] bias upcast at the score add.
// The fp32 cores of K1, K2, K3, K7 and K9 are f32_core.cu's register-tiled
// kernel, and bf16 K1, K15 and the cores of K2, K3, K5-K8 at every head dim
// attention_sublayer.cu's wgmma core.  These replace the same TPU kernels
// as the cores they stand in for (dynamic_tuning_tpu/ops/mha_serving.py::
// attn_core_pairs inside quant.py's int8 chains K6 and K8; quant.py::
// attn_core_pairs_q8; mha_serving.py::mha_windowed_fused), at the dtypes
// and head dims those are generic in.
//
// Per query row of each head (K1's rounding; T the operands' type):
//   q' = T(q * scale);  s = q' . k (fp32) [+ fp32(bias)]
//   e = exp(clip(s, -60, 80) - 20);  l = sum(e) in fp32 (the unrounded e)
//   o = (T(e) @ v in fp32) * (1 / l) -> T
// and in the int8-score form s = (float(qq . kq) * qs) * ks.
// The serving softmax has no row max, so each key tile's e is final when
// computed: the walk over keys carries only l and o, never rescales.
//
// What bounds it on an H100.  The exact route at ViT-B/16 (B = 32, N = 197,
// 12 heads of 64) does 1.9 G multiply-adds in float64: 0.11 ms at the FP64
// rate (half the FFMA rate); the bf16 forms at head dim 192 do 7.6 GFLOP
// that the tensor cores would take in 0.008 ms, against 0.012 ms of bytes.
//
// What the design does about it (a simple form: exactness first, and the
// shapes it serves are off the main paths' hot loop).  A block of 256
// threads owns 64 query rows of one (sample, head): the scaled q' rows sit
// in shared memory as fp32 (or int8 codes, four to a word), and the block
// walks the keys in tiles of KT (64 at hd <= 128, 32 past it):
//   * the tile's K (or codes) and V come into shared memory as fp32 rows
//     padded by four words, so float4 reads of eight consecutive threads
//     fall on distinct banks;
//   * thread (ty, tx) computes the scores of rows ty + 16 i and keys
//     tx + 16 j from float4 (or int4 of codes, dp4a) reads along hd, adds the
//     bias, takes the clamped expf, adds e to its rows' l and writes T(e) to
//     a score tile in shared memory;
//   * then it accumulates o for rows ty + 16 i and columns 4 tx + 64 c ..
//     + 3 from the score tile (a broadcast) and V (float4 reads): the output
//     row is split over the sixteen threads of a half warp, so at hd 256 a
//     thread holds 64 sums, not 256;
//   * l is summed over the half warp at the end, o * (1 / l) stored in T.
// Acc is float64 on the exact route and in the int8-score form on fp32 qkv
// (the kernel then gives the plain version's bits, at the FP64 rate and
// twice the registers), fp32 elsewhere.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace dyt {

constexpr int SC_THREADS = 256;
constexpr int SC_QT = 64;                  // query rows a block

__host__ __device__ constexpr int sc_kt(int hd) { return hd <= 128 ? 64 : 32; }

// Shared memory of the SIMT core (fp32 words): Q [QT][QW], K [KT][QW],
// V [KT][HD + 4], scores [QT][KT + 4], then (int8 scores) the q scales [QT]
// and k scales [KT].  QW is HD + 4 words, or HD / 4 + 4 for packed codes.
template <int HD, bool Q8>
struct ScLayout {
  static constexpr int KT = sc_kt(HD);
  static constexpr int QW = Q8 ? HD / 4 + 4 : HD + 4;
  static constexpr int VW = HD + 4;
  static constexpr int SW = KT + 4;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + SC_QT * QW;
  static constexpr int V_OFF = K_OFF + KT * QW;
  static constexpr int S_OFF = V_OFF + KT * VW;
  static constexpr int QS_OFF = S_OFF + SC_QT * SW;
  static constexpr int KS_OFF = QS_OFF + (Q8 ? SC_QT : 0);
  static constexpr int WORDS = KS_OFF + (Q8 ? KT : 0);
  static constexpr int BYTES = WORDS * 4;
};

// Element strides (batch, head, row) of q, k, v and out, unit stride along
// hd.  In the int8-score form q and k are the codes ([B, N, C] int8, head h
// at column h * hd for both: the k codes of a pair row cover its two heads'
// lanes), qs [B, N, H] and ks [B, N, H / 2] their row scales.
template <typename T>
struct ScArgs {
  const void* q;
  const void* k;
  const T* v;
  T* o;
  long long sq[3], sk[3], sv[3], so[3];
  const bf16* bias;          // [H, N, N] (strides bh, br, unit) or null
  long long bh, br;
  const float* qs;
  const float* ks;
  int N, H;
  float scale;
};

// Acc, the sums' type: fp32, or float64 where the output is requantized
// (the plain version sums the scores, l and o in float64 and rounds once;
// the products of two fp32 values are exact in float64, so the kernel
// lands on its bits but where a sum of another order rounds across a float
// boundary, and the int8 codes downstream then agree).
__device__ __forceinline__ float sc_fma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double sc_fma(float a, float b, double c) {
  return fma(static_cast<double>(a), static_cast<double>(b), c);
}
__device__ __forceinline__ float sc_f32(float v) { return v; }
__device__ __forceinline__ float sc_f32(double v) {
  return __double2float_rn(v);
}

// fp32 sums: two blocks an SM (at most 128 registers a thread; left to
// itself ptxas took 138 for the bf16 int8-score form at hd 256: one block
// an SM, a third slower)
template <typename T, int HD, bool Q8, typename Acc>
__global__ void __launch_bounds__(SC_THREADS, 2)
simt_core_kernel(const ScArgs<T> a) {
#include "simt_core_body.cuh"
}

// float64 sums: one block an SM whatever ptxas picks (141-254 registers);
// the body stays in the kernel itself, where ptxas's register choice for
// it is the one measured
template <typename T, int HD, bool Q8, typename Acc>
__global__ void __launch_bounds__(SC_THREADS)
simt_core_kernel_f64(const ScArgs<T> a) {
#include "simt_core_body.cuh"
}

template <typename T, int HD, bool Q8, typename Acc>
static cudaError_t launch_sc(const ScArgs<T>& a, int B, cudaStream_t s) {
  using L = ScLayout<HD, Q8>;
  void (*kernel)(const ScArgs<T>);
  if constexpr (std::is_same<Acc, double>::value)
    kernel = simt_core_kernel_f64<T, HD, Q8, Acc>;
  else
    kernel = simt_core_kernel<T, HD, Q8, Acc>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + SC_QT - 1) / SC_QT, a.H, B);
  kernel<<<grid, SC_THREADS, L::BYTES, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool Q8, typename Acc = float>
static cudaError_t simt_core(const ScArgs<T>& a, int B, int hd,
                             cudaStream_t s) {
  if (a.N <= 0 || B <= 0 || a.H <= 0 || B > 65535 || a.H > 65535)
    return cudaErrorInvalidValue;
  switch (hd) {
    case 64: return launch_sc<T, 64, Q8, Acc>(a, B, s);
    case 128: return launch_sc<T, 128, Q8, Acc>(a, B, s);
    case 192: return launch_sc<T, 192, Q8, Acc>(a, B, s);
    case 256: return launch_sc<T, 256, Q8, Acc>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dyt
