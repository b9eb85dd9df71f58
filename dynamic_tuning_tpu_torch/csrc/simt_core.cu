// The SIMT attention core's entries on fp32 or bf16 q, k, v: the exact fp32
// route (float64 sums) on raw qkv past head dim 256, and the core on
// strided q, k, v (K1's or K15's rounding, K9's bias); the design is
// simt_core.cuh's.  The
// int8-score form is simt_core_q8.cu, its own translation unit so that the
// two build in parallel.
#include "simt_core.cuh"

extern "C" {

// The exact fp32 core on raw qkv [B, N, 3C] -> out [B, N, C], both fp32 and
// contiguous, its sums in float64, on the slices kernel: the exact route
// past head dim 256 (quant.cu's fp32 chain with simt_core set; the DMMA
// exact core, exact_core.cu, takes 64 to 256).  Returns a cudaError_t
// value.
int dyt_simt_core_exact(const float* qkv, float* out, int B, int N, int C,
                        int H, float scale, void* stream) {
  if (H <= 0 || C % H) return cudaErrorInvalidValue;
  const long long hd = C / H, C3 = 3LL * C, rows = (long long)N * C3;
  const dyt::ScArgs<float> a{qkv, qkv + C, qkv + 2 * C, out,
                             {rows, hd, C3}, {rows, hd, C3}, {rows, hd, C3},
                             {(long long)N * C, hd, C}, nullptr, 0, 0,
                             nullptr, nullptr, N, H, scale, 0};
  return dyt::simt_core<float, false, double>(
      a, B, (int)hd, static_cast<cudaStream_t>(stream));
}

// The core on strided q, k, v [B, H, N, hd] -> out, bf16 or fp32 (t_f32),
// with K1's rounding or K15's (k15, bf16): every core past head dim 768
// (K1, K15, K9 in either dtype and the cores of the bf16 and fp32 sublayer
// chains), where the wgmma and fp32 cores' layouts no longer fit.
// ``strides`` as dyt_mha_core's (batch, head, row of q, k, v and out; unit
// stride along hd; every stride a multiple of 8 elements and the operands
// on 16 bytes); bias null or bf16 [H, N, N] with head stride ``bias_head``
// and row stride ``bias_row`` (unit column stride).  hd any multiple of
// 64.
int dyt_simt_core(const void* q, const void* k, const void* v, void* out,
                  const long long* strides, int B, int N, int H, int hd,
                  float scale, const void* bias,
                  long long bias_head, long long bias_row, int t_f32,
                  int k15, void* stream) {
  auto run = [&](auto* vp) {
    using T = std::remove_cv_t<std::remove_pointer_t<decltype(vp)>>;
    dyt::ScArgs<T> a{q, k, vp, static_cast<T*>(out), {}, {}, {}, {},
                     static_cast<const dyt::bf16*>(bias), bias_head,
                     bias_row, nullptr, nullptr, N, H, scale, k15};
    for (int i = 0; i < 3; ++i) {
      a.sq[i] = strides[i];
      a.sk[i] = strides[3 + i];
      a.sv[i] = strides[6 + i];
      a.so[i] = strides[9 + i];
    }
    return dyt::simt_core<T, false>(a, B, hd,
                                    static_cast<cudaStream_t>(stream));
  };
  if (t_f32) {
    if (k15) return cudaErrorInvalidValue;
    return run(static_cast<const float*>(v));
  }
  return run(static_cast<const dyt::bf16*>(v));
}

// The core with K1's rounding on raw qkv [B, N, 3C] -> out [B, N, C],
// bf16 or fp32 (t_f32), both contiguous: the core of the bf16, fp32 and
// int8 sublayer chains past head dim 768.  Returns a cudaError_t value.
int dyt_simt_core_qkv(const void* qkv, void* out, int B, int N, int C, int H,
                      float scale, int t_f32, void* stream) {
  if (H <= 0 || C % H) return cudaErrorInvalidValue;
  const long long hd = C / H, C3 = 3LL * C, rows = (long long)N * C3;
  const long long st[12] = {rows, hd, C3, rows, hd, C3, rows, hd, C3,
                            (long long)N * C, hd, C};
  const size_t el = t_f32 ? 4 : 2;
  auto* base = static_cast<const unsigned char*>(qkv);
  return dyt_simt_core(base, base + C * el, base + 2 * C * el, out, st, B, N,
                       H, (int)hd, scale, nullptr, 0, 0, t_f32, 0, stream);
}

}  // extern "C"
