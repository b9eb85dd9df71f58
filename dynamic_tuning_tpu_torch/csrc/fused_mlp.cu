// Fused LayerNorm + MLP of the speed-test model's blocks:
//     out = gate * fc2(gelu(fc1(LN(x))))
//
// Replaces the TPU kernel dynamic_tuning_tpu/ops/fused_mlp.py::fused_ln_mlp
// (K11, _kernel), which the speed-test forward (models/fast_inference.py)
// runs in every block with use_pallas=True.
//
// What bounds it on an H100.  At the forward's rows (M = 128 * 99 = 12672
// dispatched rows, or 128 * 197 = 25216 in mask and dense mode; C = 768,
// H = 3072) the two products are 4 * M * C * H = 120 GFLOP (0.12 ms at the
// 989 TFLOP/s bf16 peak) and 240 GFLOP (0.24 ms); the function's own bytes
// (x in, weights, out) are ~40 MB (0.015 ms at 3.35 TB/s).  It is bound by
// operations.  The TPU kernel kept the [tile_m, 3072] hidden in VMEM with
// both weights resident; a 64-row hidden tile is 384 KB of bf16, more than a
// block's 227 KB of shared memory, so that layout does not carry over.
//
// What the design does about it.  Three kernels on the caller's stream, the
// rounding points of the TPU kernel kept exactly:
//   1. layernorm_bf16_kernel (common.cuh) -- fp32 two-pass LN, eps 1e-6,
//      the fp32 affine, one rounding of xn to bf16;
//   2. gemm_nt_kernel<EPI_GELU_ERF|EPI_GELU_TANH> (gemm.cuh: a TMA ring,
//      wgmma, a persistent grid) -- xn x W1^T with fp32 accumulation, + b1
//      in fp32, GELU in fp32 (the A&S erf or the tanh form), one rounding of
//      h to bf16, written to device memory (78 MB at the dispatch rows,
//      another ~0.05 ms of traffic each way);
//   3. gemm_nt_kernel<EPI_GATE> -- h x W2^T, + b2, times the row's fp32 gate
//      when there is one, one rounding to x's dtype.
// So the GEMM's tensor-core rate and its epilogues decide, with the hidden's
// round trip beside them.  A single kernel that streams hidden chunks
// through shared memory is later work.
#include "gemm.cuh"

namespace dyt {

template <typename TX>
static cudaError_t ln_mlp(const TX* x, const float* gamma, const float* beta,
                          const bf16* w1, const float* b1, const bf16* w2,
                          const float* b2, const float* gate, TX* out,
                          bf16* ln_buf, bf16* h_buf, int M, int C, int H,
                          int gelu_approx, cudaStream_t s) {
  cudaError_t err = launch_layernorm_bf16<TX>(x, gamma, beta, ln_buf, M, C, s);
  if (err != cudaSuccess) return err;
  err = gelu_approx
      ? launch_gemm_nt<EPI_GELU_TANH, TX>(ln_buf, w1, b1, M, H, C, h_buf,
                                          nullptr, nullptr, nullptr, s)
      : launch_gemm_nt<EPI_GELU_ERF, TX>(ln_buf, w1, b1, M, H, C, h_buf,
                                         nullptr, nullptr, nullptr, s);
  if (err != cudaSuccess) return err;
  return launch_gemm_nt<EPI_GATE, TX>(h_buf, w2, b2, M, C, H, nullptr,
                                      nullptr, out, nullptr, s, gate);
}

}  // namespace dyt

extern "C" {

// x, out: [M, C] in x's dtype (x_f32 selects fp32 over bf16); gamma, beta,
// b2 [C] and b1 [H] fp32; w1 [H, C] and w2 [C, H] bf16 (torch's [out, in]);
// gate: fp32 [M] or null; ln_buf [M, C] and h_buf [M, H] bf16 scratch.
// C and H multiples of 8.  Returns a cudaError_t value.
int dyt_fused_ln_mlp(const void* x, int x_f32, const float* gamma,
                     const float* beta, const void* w1, const float* b1,
                     const void* w2, const float* b2, const float* gate,
                     void* out, void* ln_buf, void* h_buf, int M, int C, int H,
                     int gelu_approx, void* stream) {
  using dyt::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* w1b = static_cast<const bf16*>(w1);
  auto* w2b = static_cast<const bf16*>(w2);
  auto* lb = static_cast<bf16*>(ln_buf);
  auto* hb = static_cast<bf16*>(h_buf);
  if (x_f32)
    return dyt::ln_mlp<float>(static_cast<const float*>(x), gamma, beta, w1b,
                              b1, w2b, b2, gate, static_cast<float*>(out), lb,
                              hb, M, C, H, gelu_approx, s);
  return dyt::ln_mlp<bf16>(static_cast<const bf16*>(x), gamma, beta, w1b, b1,
                           w2b, b2, gate, static_cast<bf16*>(out), lb, hb, M,
                           C, H, gelu_approx, s);
}

}  // extern "C"
