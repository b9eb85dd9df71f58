// The SIMT attention core's entries on fp32 or bf16 q, k, v (K1's and
// K15's rounding, the K9 bias): the design is simt_core.cuh's.  The
// int8-score form is simt_core_q8.cu, its own translation unit so that the
// two build in parallel.
#include "simt_core.cuh"

namespace dyt {

template <typename T, typename Acc>
static cudaError_t simt_core_qkv(const T* qkv, T* out, int B, int N, int C,
                                 int H, float scale, cudaStream_t s) {
  if (H <= 0 || C % H) return cudaErrorInvalidValue;
  const long long hd = C / H, C3 = 3LL * C, rows = (long long)N * C3;
  ScArgs<T> a{qkv, qkv + C, qkv + 2 * C, out,
              {rows, hd, C3}, {rows, hd, C3}, {rows, hd, C3},
              {(long long)N * C, hd, C}, nullptr, 0, 0, nullptr, nullptr, N,
              H, scale, 0};
  return simt_core<T, false, Acc>(a, B, (int)hd, s);
}

}  // namespace dyt

extern "C" {

// The core on raw qkv [B, N, 3C] -> out [B, N, C], both fp32 (t_f32) or
// bf16, contiguous; fp32 with ``exact``: its sums in float64 (the int8
// chain's core, whose output is requantized).  Returns a cudaError_t
// value.
int dyt_simt_core_qkv(const void* qkv, void* out, int B, int N, int C, int H,
                      float scale, int t_f32, int exact, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* qf = static_cast<const float*>(qkv);
  auto* of = static_cast<float*>(out);
  if (t_f32 && exact)
    return dyt::simt_core_qkv<float, double>(qf, of, B, N, C, H, scale, s);
  if (t_f32)
    return dyt::simt_core_qkv<float, float>(qf, of, B, N, C, H, scale, s);
  return dyt::simt_core_qkv<dyt::bf16, float>(
      static_cast<const dyt::bf16*>(qkv), static_cast<dyt::bf16*>(out), B, N,
      C, H, scale, s);
}

// The core on strided q, k, v [B, H, N, hd] -> out, fp32 (t_f32) or bf16,
// with K1's rounding or (k15) K15's; ``strides`` as dyt_mha_core's (batch,
// head, row of q, k, v and out; unit stride along hd; every stride a
// multiple of 8 elements and the operands on 16 bytes); bias null or bf16
// [H, N, N] with head stride ``bias_head`` and row stride ``bias_row`` (unit
// column stride).
int dyt_simt_core(const void* q, const void* k, const void* v, void* out,
                  const long long* strides, int B, int N, int H, int hd,
                  float scale, int t_f32, int k15, const void* bias,
                  long long bias_head, long long bias_row, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fill = [&](auto& a) {
    for (int i = 0; i < 3; ++i) {
      a.sq[i] = strides[i];
      a.sk[i] = strides[3 + i];
      a.sv[i] = strides[6 + i];
      a.so[i] = strides[9 + i];
    }
  };
  const auto* bb = static_cast<const dyt::bf16*>(bias);
  if (t_f32) {
    dyt::ScArgs<float> a{q, k, static_cast<const float*>(v),
                         static_cast<float*>(out), {}, {}, {}, {}, bb,
                         bias_head, bias_row, nullptr, nullptr, N, H, scale,
                         k15};
    fill(a);
    return dyt::simt_core<float, false>(a, B, hd, s);
  }
  dyt::ScArgs<dyt::bf16> a{q, k, static_cast<const dyt::bf16*>(v),
                           static_cast<dyt::bf16*>(out), {}, {}, {}, {}, bb,
                           bias_head, bias_row, nullptr, nullptr, N, H,
                           scale, k15};
  fill(a);
  return dyt::simt_core<dyt::bf16, false>(a, B, hd, s);
}

}  // extern "C"
