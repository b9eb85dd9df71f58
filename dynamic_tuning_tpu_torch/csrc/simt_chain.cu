// The fp32 forms of the serving sublayer and of the DyT prologue's tails,
// and the SIMT forms of the tails at widths the wgmma tails do not take:
//   * the fp32 attention sublayer chain, x + proj(core(qkv(LN(x)))) with
//     fp32 weights: LN to fp32 rows, the fp32 GEMM (gemm_f32.cuh) for qkv
//     (+ bias), the fp32 core (f32_core.cu) on the fp32 qkv, the fp32 GEMM
//     for proj with the residual epilogue; the first four steps of K2, K3
//     and K7 with fp32 weights (dynamic_tuning_tpu/ops/mha_serving.py::
//     attention_sublayer_serving, dyt_prologue_serving,
//     dyt_prologue_serving_moe, whose products run in the weights' dtype);
//   * the adapter/router tail with bf16 weights, (relu(bf16(x) . Wd^T +
//     bd) . Wu^T + bu) * s and x . wsel + bsel, and the MoE tail
//     (dyt_prologue_serving_moe's moe_adapter_rows: gates = softmax((x .
//     Wr) * (1 / tau)), the gated bottleneck, the gated up bias) at any F
//     and any E * b (past 1024, where the wgmma tails stop, and at C % 64
//     != 0; moe_adapter.cu takes F from 129 to 1024 gate-free): a
//     router kernel (one warp a row: the router dots in float64, the expert
//     softmax, the token-router logit) and two fp32 GEMMs with the mixture
//     in their epilogues; the bottleneck is stored in bf16 (MoE: bf16(h *
//     gate)), as the wgmma tails store it.  With fp32 weights the tail
//     sums in float64 on the FP64 tensor cores (f64_tail.cu).
//
// What bounds it on an H100.  The fp32 sublayer of ViT-B/16 at batch 128 is
// 119 GFLOP of qkv and proj products (1.8 ms at the 67 TFLOP/s FFMA peak)
// and 15 GFLOP in the core: bound by FFMA operations.
//
// What the design does about it: the simple form -- each step a kernel of
// its own on the caller's stream, the intermediates (LN rows, qkv, core
// output, bottleneck) through device memory; the GEMMs are gemm_f32.cuh's
// register-blocked SGEMM.  Fusing and the tensor cores (3xTF32) are later
// work.
#include "gemm_f32.cuh"

extern "C" int dyt_f32_core_qkv(const float* qkv, float* out, int B, int N,
                                int C, int H, float scale, void* stream);
extern "C" int dyt_simt_core_qkv(const void* qkv, void* out, int B, int N,
                                 int C, int H, float scale, int t_f32,
                                 void* stream);

namespace dyt {

// LayerNorm rows to fp32: one warp a row, the mean and the mean of the
// centred fp32 squares summed in float64 and rounded once (as
// ops/mha_serving.py::layernorm_f32), eps 1e-6, the fp32 affine.
template <typename TX>
__global__ void __launch_bounds__(256)
layernorm_f32_kernel(const TX* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ b, float* __restrict__ out,
                     int M, int C) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const TX* xr = x + (size_t)row * C;
  double s = 0.0;
  for (int c = lane; c < C; c += 32) s += (double)to_f32(xr[c]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mu = __double2float_rn(s / C);
  double v = 0.0;
  for (int c = lane; c < C; c += 32) {
    const float d = __fsub_rn(to_f32(xr[c]), mu);
    v += (double)__fmul_rn(d, d);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const float var = __double2float_rn(v / C);
  const float rs = __frcp_rn(__fsqrt_rn(__fadd_rn(var, 1e-6f)));
  float* orow = out + (size_t)row * C;
  for (int c = lane; c < C; c += 32)
    orow[c] = __fadd_rn(
        __fmul_rn(__fmul_rn(__fsub_rn(to_f32(xr[c]), mu), rs), g[c]), b[c]);
}

template <typename TX>
static cudaError_t sublayer_f32(const TX* x, const float* gamma,
                               const float* beta, const float* wqkv,
                               const float* bqkv, const float* wproj,
                               const float* bproj, TX* out, float* xm32,
                               float* ln_buf, float* qkv_buf, float* attn_buf,
                               int B, int N, int C, int H, float scale,
                               int simt_core, cudaStream_t s) {
  const int M = B * N;
  if (M <= 0 || C <= 0) return cudaErrorInvalidValue;
  layernorm_f32_kernel<TX><<<(M + 7) / 8, 256, 0, s>>>(x, gamma, beta, ln_buf,
                                                       M, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_gemm_f32<float, float, false>(
      ln_buf, wqkv, M, 3 * C, C, GfBias<float>{bqkv, qkv_buf, 3 * C}, s);
  if (err != cudaSuccess) return err;
  err = static_cast<cudaError_t>(
      simt_core ? dyt_simt_core_qkv(qkv_buf, attn_buf, B, N, C, H, scale, 1, s)
                : dyt_f32_core_qkv(qkv_buf, attn_buf, B, N, C, H, scale, s));
  if (err != cudaSuccess) return err;
  return launch_gemm_f32<float, float, false>(
      attn_buf, wproj, M, C, C, GfResid<TX>{bproj, x, out, xm32, C}, s);
}

// --- the tails -----------------------------------------------------------------

// One warp a row of the fp32 x_mid: with E > 0 the expert gates
// softmax((x . Wr_e) * inv_tau) (dots summed in float64 and rounded once,
// the row max subtracted, an IEEE division by the sum); with wsel the
// token-router logit x . wsel + bsel (float64 sum, rounded once).  The
// gates' sum over the experts is summed in float64 and rounded once too, so
// that it does not depend on the order of the sum.
__global__ void __launch_bounds__(256)
tail_router_kernel(const float* __restrict__ xm, int M, int C,
                   const float* __restrict__ wr, int E, float inv_tau,
                   float* __restrict__ gates, const float* __restrict__ wsel,
                   const float* __restrict__ bsel,
                   float* __restrict__ logits) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* xr = xm + (size_t)row * C;
  auto dot = [&](const float* w) {
    double acc = 0.0;
    for (int c = lane; c < C; c += 32)
      acc = fma((double)xr[c], (double)w[c], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    return __double2float_rn(acc);
  };
  if (E > 0) {
    float* gr = gates + (size_t)row * E;
    float rmax = __int_as_float(0xff800000);   // -inf
    for (int e = 0; e < E; ++e) {
      const float r = __fmul_rn(dot(wr + (size_t)e * C), inv_tau);
      if (lane == 0) gr[e] = r;
      rmax = fmaxf(rmax, r);
    }
    __syncwarp();
    if (lane == 0) {
      double sum = 0.0;
      for (int e = 0; e < E; ++e) {
        gr[e] = expf(__fsub_rn(gr[e], rmax));
        sum += (double)gr[e];
      }
      const float den = __double2float_rn(sum);
      for (int e = 0; e < E; ++e) gr[e] = __fdiv_rn(gr[e], den);
    }
  }
  if (wsel != nullptr) {
    const float lg = dot(wsel);
    if (lane == 0) logits[row] = __fadd_rn(lg, bsel[0]);
  }
}

// The bf16-weight tail on the fp32 x_mid xm [M, C]: with E == 0 the
// adapter (wd [F, C], bd [F], wu [C, F], bu [C]), else the MoE tail (F = E
// * b columns; wr [E, C], wd [W, C], bd [W], wu [C, W], bu [E, C]); TO
// adapt's type.  h [M, F] bf16 and gates [M, E] fp32 are scratch.
template <typename TO>
static cudaError_t tail(const float* xm, int M, int C, const float* wr,
                        const bf16* wd, const float* bd, const bf16* wu,
                        const float* bu, const float* ascale,
                        const float* wsel, const float* bsel, TO* adapt,
                        float* logits, int F, int E, int b, float inv_tau,
                        bf16* h, float* gates, cudaStream_t s) {
  if (M < 0 || C <= 0 || F <= 0 || (E > 0 && (b <= 0 || F != E * b)))
    return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  if (E > 0 || wsel != nullptr) {
    tail_router_kernel<<<(M + 7) / 8, 256, 0, s>>>(
        xm, M, C, wr, E, inv_tau, gates, wsel, bsel, logits);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const float* g = E > 0 ? gates : nullptr;
  cudaError_t err = launch_gemm_f32<float, bf16, true>(
      xm, wd, M, F, C, GfReluGate<bf16>{bd, g, h, F, E > 0 ? E : 1,
                                        E > 0 ? b : 1},
      s);
  if (err != cudaSuccess) return err;
  return launch_gemm_f32<bf16, bf16, false>(
      h, wu, M, C, F, GfUp<TO>{bu, g, ascale, adapt, C, E}, s);
}

}  // namespace dyt

extern "C" {

// The fp32 sublayer chain: x, out [B, N, C] in the residual dtype (x_f32
// selects fp32 over bf16); gamma/beta/bqkv/bproj fp32; wqkv [3C, C] and
// wproj [C, C] fp32; xm32 an optional fp32 [B, N, C] copy of out; ln_buf
// [B*N, C], qkv_buf [B*N, 3C] and attn_buf [B*N, C] fp32 scratch; the core
// the fp32 core (head dims up to 768) or, with simt_core, the SIMT core
// (past 768), as the caller routes it.  Returns a cudaError_t value.
int dyt_attention_sublayer_f32(const void* x, int x_f32, const float* gamma,
                               const float* beta, const float* wqkv,
                               const float* bqkv, const float* wproj,
                               const float* bproj, void* out, float* xm32,
                               float* ln_buf, float* qkv_buf, float* attn_buf,
                               int B, int N, int C, int H, float scale,
                               int simt_core, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return dyt::sublayer_f32<float>(
        static_cast<const float*>(x), gamma, beta, wqkv, bqkv, wproj, bproj,
        static_cast<float*>(out), xm32, ln_buf, qkv_buf, attn_buf, B, N, C, H,
        scale, simt_core, s);
  return dyt::sublayer_f32<dyt::bf16>(
      static_cast<const dyt::bf16*>(x), gamma, beta, wqkv, bqkv, wproj, bproj,
      static_cast<dyt::bf16*>(out), xm32, ln_buf, qkv_buf, attn_buf, B, N, C,
      H, scale, simt_core, s);
}

// The fp32 GEMM alone: out [M, N] fp32 = a [M, K] . w [N, K]^T, fp32
// operands and sums (the product of the fp32 sublayer chain, timed beside
// torch.matmul).  Returns a cudaError_t value.
int dyt_gemm_f32(const float* a, const float* w, int M, int N, int K,
                 float* out, void* stream) {
  return dyt::launch_gemm_f32<float, float, false>(
      a, w, M, N, K, dyt::GfStore{out, N}, static_cast<cudaStream_t>(stream));
}

// The SIMT adapter/router tail (E == 0) or MoE tail (E >= 1, F = E * b)
// with bf16 weights on the fp32 x_mid xm [M, C]: wd [F, C], wu [C, F] bf16;
// bd [F], bu [C] (adapter) or [E, C] (MoE), wr [E, C] (MoE), ascale [1]
// fp32; wsel [C] and bsel [1] fp32, or wsel == NULL to skip the token
// router; adapt [M, C] fp32 (adapt_f32) or bf16; logits [M] fp32; scratch
// h [M, F] bf16 and gates [M, E] fp32 (MoE).  Returns a cudaError_t value.
int dyt_tail_simt(const float* xm, int M, int C, const float* wr,
                  const void* wd, const float* bd, const void* wu,
                  const float* bu, const float* ascale, const float* wsel,
                  const float* bsel, void* adapt, int adapt_f32,
                  float* logits, int F, int E, int b, float inv_tau, void* h,
                  float* gates, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* d = static_cast<const dyt::bf16*>(wd);
  auto* u = static_cast<const dyt::bf16*>(wu);
  auto* hh = static_cast<dyt::bf16*>(h);
  if (adapt_f32)
    return dyt::tail<float>(xm, M, C, wr, d, bd, u, bu, ascale, wsel, bsel,
                            static_cast<float*>(adapt), logits, F, E, b,
                            inv_tau, hh, gates, s);
  return dyt::tail<dyt::bf16>(xm, M, C, wr, d, bd, u, bu, ascale, wsel, bsel,
                              static_cast<dyt::bf16*>(adapt), logits, F, E,
                              b, inv_tau, hh, gates, s);
}

}  // extern "C"
