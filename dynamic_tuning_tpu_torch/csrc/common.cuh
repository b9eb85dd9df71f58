// Shared helpers of the serving kernels: bf16 conversions, round-to-nearest
// fp32 arithmetic, the fp32 GELUs, cp.async, warp reductions, the bf16 and
// int8 mma.sync primitives, the bf16 LayerNorm rows, and the NT tensor-core
// GEMM that the attention sublayer chain (attention_sublayer.cu) and the
// fused LN+MLP chain (fused_mlp.cu) run twice each (quant.cu's int8 GEMM
// keeps its ring and tiling).
//
// The GEMM is the plain Ampere-style form: 128x128x32 block tiles fed by a
// four-stage cp.async ring, eight warps of 64x32 tiles of mma.sync bf16
// m16n8k16 products with fp32 accumulators (operands through ldmatrix), and
// an epilogue that applies the caller's bias / GELU / gate / residual
// arithmetic in fp32 before the one rounding to the output type.  wgmma and
// TMA are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace dyt {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

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

// c = c + a * b as an IEEE round-to-nearest add of the tensor core's product
// of this k16 step.  Chained mma accumulation rounds inside the tensor core
// at every step; over the 48 steps of a K = 768 product that drifts further
// from the exact sum (which the plain versions form in float64) than one
// round-to-nearest add per step does.
__device__ __forceinline__ void mma_bf16_16816_rn(float (&c)[4],
                                                  const unsigned (&a)[4],
                                                  unsigned b0, unsigned b1) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16_16816(p, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], p[e]);
}

// c += a (16x32, row) * b (32x8, col) in int8 with int32 accumulators.  Its
// fragments hold the same bytes per thread as the bf16 m16n8k16 ones, so
// the bf16 ldmatrix addressing serves with k counted in bytes.
__device__ __forceinline__ void mma_s8_16832(int (&c)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// out[m, n] = epilogue(sum_k A[m, k] * W[n, k]) -- both operands K-contiguous
// ("NT"), W in torch's [out, in] layout.  Requires K % 8 == 0 and N % 8 == 0
// (16-byte row chunks, paired epilogue columns); M may be ragged.
//
// Block tile BM x BN x BK fed by a STAGES-deep cp.async ring; WM x WN warps,
// each owning a (BM/WM) x (BN/WN) tile of m16n8 accumulators, fed by
// ldmatrix.  The smem row stride BK + 8 (80 bytes) puts the eight 16-byte
// rows of every ldmatrix phase in distinct banks.
template <int BM_, int BN_, int BK_, int STAGES_, int WM_, int WN_>
struct GemmCfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int WM = WM_, WN = WN_, THREADS = 32 * WM * WN;
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;  // mma tiles/warp
  static constexpr int LD = BK + 8;
  static constexpr int STAGE = (BM + BN) * LD;   // bf16 elements per stage
  static constexpr int SMEM = STAGES * STAGE * 2;
  static_assert(BM % (16 * WM) == 0 && BN % (16 * WN) == 0 && BK % 16 == 0,
                "tile shape");
};
using GemmDefault = GemmCfg<128, 128, 32, 4, 2, 4>;

enum GemmEpilogue {
  EPI_BIAS_BF16 = 0,   // out_bf16 = bf16(acc + bias[n])
  EPI_RESIDUAL = 1,    // xm = (resid + acc) + bias[n]; out_x = TX(xm);
                       // out_f32 = xm when given
  EPI_GELU_ERF = 2,    // out_bf16 = bf16(gelu_erf(acc + bias[n]))
  EPI_GELU_TANH = 3,   // out_bf16 = bf16(gelu_tanh(acc + bias[n]))
  EPI_GATE = 4,        // out_x = TX((acc + bias[n]) * gate[m]), or
                       // TX(acc + bias[n]) when gate is null
};

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

template <class G, int EPI, typename TX>
__global__ void __launch_bounds__(G::THREADS)
gemm_nt_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
               const float* __restrict__ bias, int M, int N, int K,
               bf16* __restrict__ out_bf16, const TX* __restrict__ resid,
               TX* __restrict__ out_x, float* __restrict__ out_f32,
               const float* __restrict__ gate) {
  constexpr int BM = G::BM, BN = G::BN, BK = G::BK, LD = G::LD;
  constexpr int MT = G::MT, NT = G::NT;
  extern __shared__ __align__(128) unsigned char gsmem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(gsmem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm0 = (warp / G::WN) * MT * 16, wn0 = (warp % G::WN) * NT * 8;

  // rows [0, BM) of a stage hold A, rows [BM, BM + BN) hold W
  auto load_stage = [&](int stage, int k0) {
    bf16* st = smem + stage * G::STAGE;
#pragma unroll
    for (int i = tid; i < (BM + BN) * (BK / 8); i += G::THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int gk = k0 + c;
      const bool is_a = r < BM;
      const int g = is_a ? m0 + r : n0 + r - BM;
      const bool ok = g < (is_a ? M : N) && gk < K;
      const bf16* src = is_a ? A : W;
      cp_async16(st + r * LD + c, ok ? src + (size_t)g * K + gk : src,
                 ok ? 16 : 0);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix lane addressing: A rows lane%16, k half lane/16; W rows
  // lane%8 (+8 for lanes 16..31), k half (lane/8)%2
  const int a_row = lane & 15, a_k = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) * 8;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<G::STAGES - 2>();   // stage kt has landed
    __syncthreads();                  // ... and stage kt-1 is free again
    const int nxt = kt + G::STAGES - 1;
    if (nxt < nk) load_stage(nxt % G::STAGES, nxt * BK);
    cp_async_commit();
    const bf16* sa = smem + (kt % G::STAGES) * G::STAGE;
    const bf16* sb = sa + BM * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[MT][4], bfr[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], sa + (wm0 + i * 16 + a_row) * LD + kk + a_k);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned r[4];
        ldmatrix_x4(r, sb + (wn0 + j * 8 + b_row) * LD + kk + b_k);
        bfr[j][0] = r[0]; bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2]; bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16_16816(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue straight from the accumulators: element pairs (row, col..col+1)
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn0 + j * 8 + t2;
      if (col >= N) continue;
      const float2 b = load2(bias + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm0 + i * 16 + g + h * 8;
        if (row >= M) continue;
        const size_t o = (size_t)row * N + col;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if constexpr (EPI == EPI_BIAS_BF16) {
          store2(out_bf16 + o, v0 + b.x, v1 + b.y);
        } else if constexpr (EPI == EPI_GELU_ERF) {
          store2(out_bf16 + o, gelu_erf(add(v0, b.x)), gelu_erf(add(v1, b.y)));
        } else if constexpr (EPI == EPI_GELU_TANH) {
          store2(out_bf16 + o, gelu_tanh(add(v0, b.x)),
                 gelu_tanh(add(v1, b.y)));
        } else if constexpr (EPI == EPI_GATE) {
          v0 = add(v0, b.x);
          v1 = add(v1, b.y);
          if (gate != nullptr) {
            const float gm = gate[row];
            v0 = mul(v0, gm);
            v1 = mul(v1, gm);
          }
          store2(out_x + o, v0, v1);
        } else {
          const float2 x = load2(resid + o);
          v0 = (x.x + v0) + b.x;
          v1 = (x.y + v1) + b.y;
          store2(out_x + o, v0, v1);
          if (out_f32 != nullptr) store2(out_f32 + o, v0, v1);
        }
      }
    }
  }
}

template <int EPI, typename TX, class G = GemmDefault>
cudaError_t launch_gemm_nt(const bf16* A, const bf16* W, const float* bias,
                           int M, int N, int K, bf16* out_bf16,
                           const TX* resid, TX* out_x, float* out_f32,
                           cudaStream_t s, const float* gate = nullptr) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_nt_kernel<G, EPI, TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((N + G::BN - 1) / G::BN, (M + G::BM - 1) / G::BM);
  gemm_nt_kernel<G, EPI, TX><<<grid, G::THREADS, G::SMEM, s>>>(
      A, W, bias, M, N, K, out_bf16, resid, out_x, out_f32, gate);
  return cudaGetLastError();
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
