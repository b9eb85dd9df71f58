// Shared helpers of the serving kernels: bf16 conversions, round-to-nearest
// fp32 arithmetic (and a division by one rounded reciprocal), ex2, the fp32
// GELUs, cp.async, warp reductions, the bf16 mma.sync primitives (the
// long-sequence softmax walk runs on them), paired and 8-wide loads and
// stores, and the bf16 LayerNorm rows.  The bf16 / int8 GEMM lives in gemm.cuh and the wgmma /
// TMA building blocks in wgmma.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dyt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
// round to nearest even, as XLA's astype(bfloat16)
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// fp32 constants as the TPU kernels and the plain versions see them: a
// Python float (double) rounded to fp32
#define F32C(x) (static_cast<float>(x))

// Each op rounded on its own: nvcc would otherwise contract a * b + c into
// one FMA, which rounds once where the TPU kernels round twice.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// GELU on fp32, as the TPU kernels (ops/quant.py::_gelu_f32,
// ops/fused_mlp.py::_kernel).  Abramowitz & Stegun 7.1.26 erf
// (mha_serving.py::erf_f32).
__device__ __forceinline__ float erf_as(float x) {
  const float a = fabsf(x);
  const float t = __fdiv_rn(1.f, add(1.f, mul(F32C(0.3275911), a)));
  float p = add(F32C(-1.453152027), mul(t, F32C(1.061405429)));
  p = add(F32C(1.421413741), mul(t, p));
  p = add(F32C(-0.284496736), mul(t, p));
  p = mul(t, add(F32C(0.254829592), mul(t, p)));
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return mul(sign, sub(1.f, mul(p, expf(mul(-a, a)))));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return mul(mul(0.5f, x), add(1.f, erf_as(mul(x, F32C(0.7071067811865476)))));
}

// jax.nn.gelu(approximate=True): x * (0.5 * (1 + tanh(c * (x + k x^3))))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = mul(mul(x, x), x);
  const float inner = mul(F32C(0.7978845608028654),
                          add(x, mul(F32C(0.044715), x3)));
  return mul(x, mul(0.5f, add(1.f, tanhf(inner))));
}

// x / l rounded to nearest, given r = __frcp_rn(l): one product and one
// correction (Markstein: with r the rounded reciprocal and q within an ulp
// of x / l, q + (x - l q) r rounds to the IEEE quotient, the residual
// being exact in an FMA), for normal operands and quotients; cheaper than
// __fdiv_rn where one l divides many x
__device__ __forceinline__ float div_rn_by(float x, float l, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-l, q, x), r, q);
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x (-inf -> 0): the SFU's approximation, ~2 ulp
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16-byte global -> shared copy; src_bytes == 0 writes zeros (ragged edges).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Tensor-core primitives: ldmatrix from shared memory and the bf16
// m16n8k16 mma with fp32 accumulators.

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// c += a (16x16, row) * b (16x8, col)
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Paired and 8-wide loads and stores of fp32 or bf16 elements, converted to
// and from fp32 (one rounding to nearest even on the way to bf16).

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  __nv_bfloat162 h;
  h.x = from_f32<bf16>(a);
  h.y = from_f32<bf16>(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = h;
}
__device__ __forceinline__ void store2(int* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

// 8 consecutive elements <-> fp32 (16-byte bf16 / 32-byte fp32 accesses)
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float* v) {
  __align__(16) bf16 h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = from_f32<bf16>(v[e]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

// ---------------------------------------------------------------------------
// LayerNorm rows to bf16: one warp per row, fp32 two-pass LN (mean, then the
// mean of the centred squares, eps 1e-6) and the fp32 affine, rounded once.

template <typename TX>
__global__ void __launch_bounds__(256)
layernorm_bf16_kernel(const TX* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ b, bf16* __restrict__ out,
                      int M, int C) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const TX* xr = x + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f32(xr[c]) - mu;
    v += d * d;
  }
  const float rs = rsqrtf(warp_sum(v) / C + 1e-6f);
  bf16* orow = out + (size_t)row * C;
  for (int c = lane; c < C; c += 32)
    orow[c] = from_f32<bf16>((to_f32(xr[c]) - mu) * rs * g[c] + b[c]);
}

template <typename TX>
cudaError_t launch_layernorm_bf16(const TX* x, const float* g, const float* b,
                                  bf16* out, int M, int C, cudaStream_t s) {
  layernorm_bf16_kernel<TX><<<(M + 7) / 8, 256, 0, s>>>(x, g, b, out, M, C);
  return cudaGetLastError();
}

}  // namespace dyt
