// DyT block prologue epilogue: the parallel adapter and the router head on
// the post-attention activation x_mid,
//     adapt  = (relu(bf16(x_mid) @ Wd^T + bd) @ Wu^T + bu) * scale
//     logits = x_mid @ wsel + bsel          (fp32 x_mid, fp32 wsel)
//
// Replaces, together with the attention sublayer chain of
// attention_sublayer.cu, the TPU kernel dynamic_tuning_tpu/ops/
// mha_serving.py::dyt_prologue_serving (_dyt_prologue_kernel).
//
// What bounds it on an H100.  The adapter is 4*M*C*F = 10 GFLOP at ViT-B
// serving shapes (M = 128*197 rows, C = 768, F = 64) -- nothing for the
// tensor cores -- while it reads the fp32 x_mid (77 MB) and writes adapt
// (39 MB in bf16): it is bound by device-memory bytes, ~35 us at 3.35 TB/s.
// The TPU kernel computed both heads while x_mid sat in VMEM.
//
// What the design does about it.  One pass over x_mid: a block owns 64
// rows, streams them in 64-column chunks through shared memory (coalesced
// 256-byte row segments), rounds each chunk to bf16 for the down GEMM (WMMA,
// fp32 accumulation) and in the same pass accumulates the router dot in fp32
// from the unrounded values, so x_mid is read once.  The bottleneck
// activations never leave shared memory: relu(down + bd) is rounded to bf16
// in place and each warp runs the up GEMM over its own 16 rows, applying
// (+ bu) * scale in fp32 before the one rounding to the residual dtype.  The
// weights (98 KB each, L2-resident) pass through shared memory in 64-row
// chunks that the block's four warps share.
#include "common.cuh"

namespace dyt {

constexpr int AR_ROWS = 64;          // rows per block, 16 per warp
constexpr int AR_CHUNK = 64;         // x_mid columns / Wu rows per smem chunk
constexpr int AR_LDA = AR_CHUNK + 8;
constexpr int AR_LDS = 20;

template <int NF>
struct ArLayout {
  static constexpr int F = NF * 16;
  static constexpr int LDH = F + 8;
  // weight chunk: Wd[0:F][k0:k0+64] (row stride AR_LDA) or Wu[n0:n0+64][0:F]
  // (row stride LDH)
  static constexpr int W_ELEMS =
      F * AR_LDA > AR_CHUNK * LDH ? F * AR_LDA : AR_CHUNK * LDH;
  static constexpr int A_OFF = 0;
  static constexpr int W_OFF = A_OFF + AR_ROWS * AR_LDA * 2;
  static constexpr int H_OFF = W_OFF + W_ELEMS * 2;
  static constexpr int S_OFF = H_OFF + AR_ROWS * LDH * 2;
  static constexpr int BYTES = S_OFF + 4 * 16 * AR_LDS * 4;
};

template <int NF, typename TO>
__global__ void __launch_bounds__(128)
adapter_router_kernel(const float* __restrict__ xm, int M, int C,
                      const bf16* __restrict__ wd, const float* __restrict__ bd,
                      const bf16* __restrict__ wu, const float* __restrict__ bu,
                      const float* __restrict__ ascale,
                      const float* __restrict__ wsel,
                      const float* __restrict__ bsel, TO* __restrict__ adapt,
                      float* __restrict__ logits) {
  using L = ArLayout<NF>;
  constexpr int F = L::F, LDH = L::LDH;
  extern __shared__ __align__(128) unsigned char ar_smem[];
  bf16* As = reinterpret_cast<bf16*>(ar_smem + L::A_OFF);
  bf16* Ws = reinterpret_cast<bf16*>(ar_smem + L::W_OFF);
  bf16* Hs = reinterpret_cast<bf16*>(ar_smem + L::H_OFF);
  float* Stg = reinterpret_cast<float*>(ar_smem + L::S_OFF);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * AR_ROWS;

  // x_mid loader: pass p reads row p*8 + tid/16, columns (tid%16)*4..+3 of
  // the chunk -- each half-warp one contiguous 256-byte row segment.  The
  // router partial of each of the thread's 8 rows stays in a register.
  const int lrow = tid >> 4, lcol = (tid & 15) * 4;
  float rpart[AR_ROWS / 8];
#pragma unroll
  for (int p = 0; p < AR_ROWS / 8; ++p) rpart[p] = 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dacc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(dacc[j], 0.0f);

  for (int k0 = 0; k0 < C; k0 += AR_CHUNK) {
    float w4[4] = {0.f, 0.f, 0.f, 0.f};
    if (wsel != nullptr) {
      const float4 w = *reinterpret_cast<const float4*>(wsel + k0 + lcol);
      w4[0] = w.x; w4[1] = w.y; w4[2] = w.z; w4[3] = w.w;
    }
#pragma unroll
    for (int p = 0; p < AR_ROWS / 8; ++p) {
      const int r = p * 8 + lrow, gm = m0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gm < M)
        v = *reinterpret_cast<const float4*>(xm + (size_t)gm * C + k0 + lcol);
      rpart[p] += v.x * w4[0];
      rpart[p] += v.y * w4[1];
      rpart[p] += v.z * w4[2];
      rpart[p] += v.w * w4[3];
      __align__(8) bf16 h[4] = {from_f32<bf16>(v.x), from_f32<bf16>(v.y),
                                from_f32<bf16>(v.z), from_f32<bf16>(v.w)};
      *reinterpret_cast<uint2*>(As + r * AR_LDA + lcol) =
          *reinterpret_cast<const uint2*>(h);
    }
    // Wd[0:F][k0:k0+64] -> Ws, 16-byte chunks
    for (int i = tid; i < F * (AR_CHUNK / 8); i += 128) {
      const int f = i / (AR_CHUNK / 8), c = (i % (AR_CHUNK / 8)) * 8;
      *reinterpret_cast<uint4*>(Ws + f * AR_LDA + c) =
          *reinterpret_cast<const uint4*>(wd + (size_t)f * C + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < AR_CHUNK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, As + warp * 16 * AR_LDA + kk, AR_LDA);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        // B (k x f) col-major: element (k, f) at Ws[f][k]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(bfr, Ws + j * 16 * AR_LDA + kk, AR_LDA);
        wmma::mma_sync(dacc[j], af, bfr, dacc[j]);
      }
    }
    __syncthreads();
  }

  if (wsel != nullptr) {
#pragma unroll
    for (int p = 0; p < AR_ROWS / 8; ++p) {
      float v = rpart[p];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const int gm = m0 + p * 8 + lrow;
      if ((tid & 15) == 0 && gm < M) logits[gm] = v + bsel[0];
    }
  }

  // bottleneck: relu(down + bd) -> bf16, each warp on its own 16 rows
  float* stg = Stg + warp * 16 * AR_LDS;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  bf16* hw = Hs + warp * 16 * LDH;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(stg, dacc[j], AR_LDS, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int f = j * 16 + c0 + e;
      hw[r * LDH + f] =
          from_f32<bf16>(fmaxf(stg[r * AR_LDS + c0 + e] + bd[f], 0.f));
    }
    __syncwarp();
  }
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> hf[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::load_matrix_sync(hf[j], hw + j * 16, LDH);

  // up projection, 64 output columns per chunk of Wu staged in smem
  const float s = ascale[0];
  const int gm = m0 + warp * 16 + r;
  for (int n0 = 0; n0 < C; n0 += AR_CHUNK) {
    for (int i = tid; i < AR_CHUNK * (F / 8); i += 128) {
      const int n = i / (F / 8), c = (i % (F / 8)) * 8;
      *reinterpret_cast<uint4*>(Ws + n * LDH + c) =
          *reinterpret_cast<const uint4*>(wu + (size_t)(n0 + n) * F + c);
    }
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> uf[AR_CHUNK / 16];
#pragma unroll
    for (int t = 0; t < AR_CHUNK / 16; ++t) {
      wmma::fill_fragment(uf[t], 0.0f);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        // B (k x n) col-major: element (k, n) at Ws[n][k]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(bfr, Ws + t * 16 * LDH + j * 16, LDH);
        wmma::mma_sync(uf[t], hf[j], bfr, uf[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < AR_CHUNK / 16; ++t) {
      wmma::store_matrix_sync(stg, uf[t], AR_LDS, wmma::mem_row_major);
      __syncwarp();
      if (gm < M) {
        const int n = n0 + t * 16 + c0;
        float v[8], b[8];
        load8(bu + n, b);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = (stg[r * AR_LDS + c0 + e] + b[e]) * s;
        store8(adapt + (size_t)gm * C + n, v);
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

template <int NF, typename TO>
static cudaError_t launch_ar(const float* xm, int M, int C, const bf16* wd,
                             const float* bd, const bf16* wu, const float* bu,
                             const float* ascale, const float* wsel,
                             const float* bsel, TO* adapt, float* logits,
                             cudaStream_t s) {
  constexpr int bytes = ArLayout<NF>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      adapter_router_kernel<NF, TO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  adapter_router_kernel<NF, TO>
      <<<(M + AR_ROWS - 1) / AR_ROWS, 128, bytes, s>>>(
          xm, M, C, wd, bd, wu, bu, ascale, wsel, bsel, adapt, logits);
  return cudaGetLastError();
}

template <typename TO>
static cudaError_t adapter_router(const float* xm, int M, int C,
                                  const bf16* wd, const float* bd,
                                  const bf16* wu, const float* bu,
                                  const float* ascale, const float* wsel,
                                  const float* bsel, TO* adapt, float* logits,
                                  int F, cudaStream_t s) {
  switch (F) {
    case 16: return launch_ar<1, TO>(xm, M, C, wd, bd, wu, bu, ascale, wsel, bsel, adapt, logits, s);
    case 32: return launch_ar<2, TO>(xm, M, C, wd, bd, wu, bu, ascale, wsel, bsel, adapt, logits, s);
    case 48: return launch_ar<3, TO>(xm, M, C, wd, bd, wu, bu, ascale, wsel, bsel, adapt, logits, s);
    case 64: return launch_ar<4, TO>(xm, M, C, wd, bd, wu, bu, ascale, wsel, bsel, adapt, logits, s);
    case 96: return launch_ar<6, TO>(xm, M, C, wd, bd, wu, bu, ascale, wsel, bsel, adapt, logits, s);
    case 128: return launch_ar<8, TO>(xm, M, C, wd, bd, wu, bu, ascale, wsel, bsel, adapt, logits, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dyt

extern "C" {

// Bottleneck widths the adapter kernel is instantiated for.
int dyt_adapter_width_supported(int F) {
  return F == 16 || F == 32 || F == 48 || F == 64 || F == 96 || F == 128;
}

// xm: fp32 [M, C] x_mid (C % 64 == 0); wd [F, C], wu [C, F] bf16; bd [F],
// bu [C], ascale [1] fp32; wsel [C] and bsel [1] fp32, or wsel == NULL to
// skip the router; adapt [M, C] in the residual dtype (adapt_f32 selects fp32
// over bf16); logits fp32 [M].  Returns a cudaError_t value.
int dyt_adapter_router(const float* xm, int M, int C, const void* wd,
                       const float* bd, const void* wu, const float* bu,
                       const float* ascale, const float* wsel,
                       const float* bsel, void* adapt, int adapt_f32,
                       float* logits, int F, void* stream) {
  using dyt::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* d = static_cast<const bf16*>(wd);
  auto* u = static_cast<const bf16*>(wu);
  if (adapt_f32)
    return dyt::adapter_router<float>(xm, M, C, d, bd, u, bu, ascale, wsel,
                                      bsel, static_cast<float*>(adapt), logits,
                                      F, s);
  return dyt::adapter_router<bf16>(xm, M, C, d, bd, u, bu, ascale, wsel, bsel,
                                   static_cast<bf16*>(adapt), logits, F, s);
}

}  // extern "C"
