// The int8 patch-embed stem (the JAX package's XLA ``q8_conv`` at stride =
// kernel, a patch matmul): q8_gemm.cuh's Q8_STEM epilogue on the int8 GEMM,
// storing bf16 or fp32, in a translation unit of its own so that its
// instantiations build in parallel with quant.cu's.
#include "q8_gemm.cuh"

extern "C" {

// The int8 stem: a [M, K] int8 patch rows with per-row (per-image) scales
// rs, w [N, K] int8 with scales cs, bias [N] -> out [M, N] bf16, or fp32
// with out_f32, = acc * (rs * cs) + bias.
int dyt_q8_stem_gemm(const void* a, const void* w, const float* rs,
                     const float* cs, const float* bias, int M, int N, int K,
                     void* out, int out_f32, void* stream) {
  auto* qa = static_cast<const int8_t*>(a);
  auto* qw = static_cast<const int8_t*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return dyt::launch_gemm_s8<dyt::Q8_STEM, float>(
        qa, qw, rs, cs, bias, M, N, K, static_cast<float*>(out), nullptr,
        nullptr, nullptr, s);
  return dyt::launch_gemm_s8<dyt::Q8_STEM, dyt::bf16>(
      qa, qw, rs, cs, bias, M, N, K, static_cast<dyt::bf16*>(out), nullptr,
      nullptr, nullptr, s);
}

}  // extern "C"
