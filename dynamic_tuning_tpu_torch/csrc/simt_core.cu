// The SIMT attention core's entries on fp32 or bf16 q, k, v: the exact fp32
// route (float64 sums) on raw qkv, and the bf16 core on strided q, k, v
// (K1's rounding, K9's bias); the design is simt_core.cuh's.  The
// int8-score form is simt_core_q8.cu, its own translation unit so that the
// two build in parallel.
#include "simt_core.cuh"

extern "C" {

// The exact fp32 core on raw qkv [B, N, 3C] -> out [B, N, C], both fp32 and
// contiguous, its sums in float64: the core of the int8 chains with fp32
// adapters (quant.cu), whose output is requantized.  Returns a cudaError_t
// value.
int dyt_simt_core_exact(const float* qkv, float* out, int B, int N, int C,
                        int H, float scale, void* stream) {
  if (H <= 0 || C % H) return cudaErrorInvalidValue;
  const long long hd = C / H, C3 = 3LL * C, rows = (long long)N * C3;
  const dyt::ScArgs<float> a{qkv, qkv + C, qkv + 2 * C, out,
                             {rows, hd, C3}, {rows, hd, C3}, {rows, hd, C3},
                             {(long long)N * C, hd, C}, nullptr, 0, 0,
                             nullptr, nullptr, N, H, scale};
  return dyt::simt_core<float, false, double>(
      a, B, (int)hd, static_cast<cudaStream_t>(stream));
}

// The bf16 core on strided q, k, v [B, H, N, hd] -> out, with K1's
// rounding (K9 at head dims 192 and 256); ``strides`` as dyt_mha_core's
// (batch, head, row of q, k, v and out; unit stride along hd; every stride
// a multiple of 8 elements and the operands on 16 bytes); bias null or
// bf16 [H, N, N] with head stride ``bias_head`` and row stride ``bias_row``
// (unit column stride).
int dyt_simt_core(const void* q, const void* k, const void* v, void* out,
                  const long long* strides, int B, int N, int H, int hd,
                  float scale, const void* bias,
                  long long bias_head, long long bias_row, void* stream) {
  dyt::ScArgs<dyt::bf16> a{q, k, static_cast<const dyt::bf16*>(v),
                           static_cast<dyt::bf16*>(out), {}, {}, {}, {},
                           static_cast<const dyt::bf16*>(bias), bias_head,
                           bias_row, nullptr, nullptr, N, H, scale};
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  return dyt::simt_core<dyt::bf16, false>(a, B, hd,
                                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
