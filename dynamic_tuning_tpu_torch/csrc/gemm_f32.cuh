// The NT GEMM of the fp32 serving forms, on the CUDA cores (FFMA):
//     out[m, n] = epilogue(sum_k A[m, k] * W[n, k])
// both operands K-contiguous (W in torch's [out, in] layout), read as fp32
// or bf16 and multiplied in fp32 with fp32 sums.  It is the qkv and proj
// product of the fp32 sublayer chain (K2, K3 and K7 with fp32 weights,
// simt_chain.cu) and both products of the SIMT adapter and MoE tails (bf16
// weights at widths the wgmma tails do not take).  The tails with fp32
// weights, which sum in float64, are f64_tail.cu's DMMA kernel.
//
// Not TF32: the tensor cores' fp32 input keeps a 10-bit mantissa (about
// three decimal digits), and the fp32 forms are held to the JAX package's
// fp32 on the CPU at 1e-5 of the largest output.
//
// What bounds it on an H100.  The fp32 qkv product of ViT-B/16 at batch 128
// (M = 25216, N = 2304, K = 768) is 89 GFLOP: 1.33 ms at the 67 TFLOP/s
// FFMA peak against ~0.13 ms of bytes, so the operations bound it, and the
// CUDA cores reach their rate only when every thread issues FMAs from
// registers with few shared-memory loads between them.
//
// What the design does about it (the classic register-blocked SGEMM; its
// speed is later work: 3xTF32 on wgmma would split each operand into a
// TF32 high and low part on the tensor cores).
//   * a block of 256 threads owns a 128 x 128 output tile and walks k in
//     steps of 16: each thread loads 8 consecutive k of one A row and one W
//     row (16-byte vector loads where K and the operands allow it, else
//     element loads with zeros past every edge), converts them to fp32 and
//     stores them k-major into shared memory, double-buffered, so the next
//     step's global loads are in flight while this step computes;
//   * each thread computes an 8 x 8 micro-tile from registers: rows
//     4 ty .. 4 ty + 3 and 64 + 4 ty .. + 3, columns likewise from tx, read
//     as float4s, so eight consecutive threads read 128 consecutive bytes
//     (no bank conflicts) and every loaded value feeds eight FMAs;
//   * the epilogue applies the caller's arithmetic to each output at its
//     rounding points (bias, residual, relu and the expert gate, the
//     adapter's scale) and stores it in the output type.
#pragma once

#include "common.cuh"

namespace dyt {

constexpr int GF_BM = 128, GF_BN = 128, GF_BK = 16;
constexpr int GF_THREADS = 256;
constexpr int GF_LD = GF_BM + 4;          // a k row of the A / W tiles

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 8 consecutive elements of a row from k0 as fp32, zeros past K; ``vec``:
// the row start is on 16 bytes and K % 8 == 0, so 16-byte loads serve
template <typename T>
__device__ __forceinline__ void gf_load8(const T* row, int k0, int K,
                                         bool vec, float* v) {
  if (vec && k0 + 8 <= K) {
    load8(row + k0, v);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = k0 + i < K ? to_f32(row[k0 + i]) : 0.f;
  }
}

// One k step's A (or W) tile: thread t loads 8 k of row t / 2 of the tile
// (k half t % 2) into ``v``; zeros for rows past ``rows``.
template <typename T, bool ROUND>
__device__ __forceinline__ void gf_fetch(const T* __restrict__ P, int r0,
                                         int rows, int K, int k0, bool vec,
                                         float (&v)[8]) {
  const int r = r0 + (threadIdx.x >> 1), kk = k0 + (threadIdx.x & 1) * 8;
  if (r < rows) {
    gf_load8(P + (size_t)r * K, kk, K, vec, v);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.f;
  }
  if constexpr (ROUND) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = round_bf16(v[i]);
  }
}

__device__ __forceinline__ void gf_stash(float* tile, const float (&v)[8]) {
  const int r = threadIdx.x >> 1, kk = (threadIdx.x & 1) * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) tile[(kk + i) * GF_LD + r] = v[i];
}

// A [M, K] of TA (rounded to bf16 first when ROUND_A: the adapter's bf16(x)
// of an fp32 x_mid), W [N, K] of TW; each output (m, n) goes to
// ``epi(m, n, acc)``, its fp32 sum.
template <typename TA, typename TW, bool ROUND_A, class Epi>
__global__ void __launch_bounds__(GF_THREADS)
gemm_f32_kernel(const TA* __restrict__ A, const TW* __restrict__ W, int M,
                int N, int K, bool vec_a, bool vec_w, const Epi epi) {
  __shared__ __align__(16) float As[2][GF_BK * GF_LD];
  __shared__ __align__(16) float Ws[2][GF_BK * GF_LD];
  const int m0 = blockIdx.y * GF_BM, n0 = blockIdx.x * GF_BN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nk = (K + GF_BK - 1) / GF_BK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  float va[8], vw[8];
  gf_fetch<TA, ROUND_A>(A, m0, M, K, 0, vec_a, va);
  gf_fetch<TW, false>(W, n0, N, K, 0, vec_w, vw);
  gf_stash(As[0], va);
  gf_stash(Ws[0], vw);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      gf_fetch<TA, ROUND_A>(A, m0, M, K, (kt + 1) * GF_BK, vec_a, va);
      gf_fetch<TW, false>(W, n0, N, K, (kt + 1) * GF_BK, vec_w, vw);
    }
    const float* as = As[cur];
    const float* ws = Ws[cur];
#pragma unroll
    for (int k = 0; k < GF_BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * GF_LD +
                                                         4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * GF_LD +
                                                         64 + 4 * ty);
      const float4 w0 = *reinterpret_cast<const float4*>(ws + k * GF_LD +
                                                         4 * tx);
      const float4 w1 = *reinterpret_cast<const float4*>(ws + k * GF_LD +
                                                         64 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    if (more) {
      gf_stash(As[cur ^ 1], va);
      gf_stash(Ws[cur ^ 1], vw);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (n < N) epi(m, n, acc[i][j]);
    }
  }
}

// --- epilogues ----------------------------------------------------------------

// out = acc  (the product alone: dyt_gemm_f32)
struct GfStore {
  float* out;
  int N;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    out[(size_t)m * N + n] = acc;
  }
};

// out = acc + bias[n]  (the qkv product: fp32 qkv)
template <typename TO>
struct GfBias {
  const float* bias;
  TO* out;
  int N;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    out[(size_t)m * N + n] = from_f32<TO>(__fadd_rn(acc, bias[n]));
  }
};

// xm = (resid + acc) + bias[n]; out = TX(xm); out_f32 = xm when given
template <typename TX>
struct GfResid {
  const float* bias;
  const TX* resid;
  TX* out;
  float* out_f32;
  int N;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    const size_t i = (size_t)m * N + n;
    const float v = __fadd_rn(__fadd_rn(to_f32(resid[i]), acc), bias[n]);
    out[i] = from_f32<TX>(v);
    if (out_f32 != nullptr) out_f32[i] = v;
  }
};

// h = relu(acc + bias[n]), times the expert gate gates[m, n / b] when
// given (the MoE mixture), stored in TH (one rounding for bf16)
template <typename TH>
struct GfReluGate {
  const float* bias;
  const float* gates;      // [M, E] or null
  TH* out;
  int N, E, b;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    float h = fmaxf(__fadd_rn(acc, bias[n]), 0.f);
    if (gates != nullptr) h = __fmul_rn(h, gates[(size_t)m * E + n / b]);
    out[(size_t)m * N + n] = from_f32<TH>(h);
  }
};

// adapt = (acc + bias) * scale, the bias bu[n], or with ``gates`` the MoE
// up bias sum_e gates[m, e] * bu[e, n] (summed in float64, rounded once)
template <typename TO>
struct GfUp {
  const float* bias;       // [N], or [E, N] with gates
  const float* gates;      // [M, E] or null
  const float* scale;      // [1]
  TO* out;
  int N, E;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    float b;
    if (gates != nullptr) {
      double s = 0.0;
      for (int e = 0; e < E; ++e)
        s = fma((double)gates[(size_t)m * E + e],
                (double)bias[(size_t)e * N + n], s);
      b = (float)s;
    } else {
      b = bias[n];
    }
    out[(size_t)m * N + n] = from_f32<TO>(__fmul_rn(__fadd_rn(acc, b),
                                                    scale[0]));
  }
};

template <typename T>
inline bool gf_vec(const T* p, int K) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && K % 8 == 0;
}

template <typename TA, typename TW, bool ROUND_A, class Epi>
cudaError_t launch_gemm_f32(const TA* A, const TW* W, int M, int N, int K,
                            const Epi& epi, cudaStream_t s) {
  if (M < 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  const dim3 grid((N + GF_BN - 1) / GF_BN, (M + GF_BM - 1) / GF_BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  gemm_f32_kernel<TA, TW, ROUND_A, Epi><<<grid, GF_THREADS, 0, s>>>(
      A, W, M, N, K, gf_vec(A, K), gf_vec(W, K), epi);
  return cudaGetLastError();
}

}  // namespace dyt
