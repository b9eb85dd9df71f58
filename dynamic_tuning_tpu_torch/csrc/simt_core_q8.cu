// The SIMT attention core's int8-score form (K10's function,
// dynamic_tuning_tpu/ops/quant.py::attn_core_pairs_q8): what it still
// serves is fp32 qkv past head dim 256 (K10 and K6/K8 with fp32 adapters,
// float64 sums; up to 256 exact_core.cu's int8-score mode takes them) and
// bf16 past head dim 768 (ops/mha_serving.py::WIDE_MAX_HD), where the wgmma
// key ring of q8_ring.cu stops.  The k lane means and the q and k codes come
// from q8_codes.cuh's two kernels (the ring reads the same codes), then
// simt_core.cuh's kernel with dp4a scores.
#include "q8_codes.cuh"
#include "simt_core.cuh"

namespace dyt {

template <typename T>
static cudaError_t simt_core_q8_qkv(const T* qkv, T* out, void* scratch,
                                    int B, int N, int C, int H, float scale,
                                    cudaStream_t s) {
  if (B <= 0 || N <= 0 || H <= 0 || H % 2 || C % H || C % 16)
    return cudaErrorInvalidValue;
  const int hd = C / H;
  const ScQ8Scratch L(B, N, C, H);
  cudaError_t err = q8_codes(qkv, scratch, B, N, C, H, scale, s);
  if (err != cudaSuccess) return err;
  auto* base = static_cast<unsigned char*>(scratch);
  auto* qc = reinterpret_cast<int8_t*>(base + L.qc);
  auto* kc = reinterpret_cast<int8_t*>(base + L.kc);
  auto* qs = reinterpret_cast<float*>(base + L.qs);
  auto* ks = reinterpret_cast<float*>(base + L.ks);
  const long long NC = (long long)N * C, C3 = 3LL * C;
  ScArgs<T> a{qc, kc, qkv + 2 * C, out,
              {NC, hd, C}, {NC, hd, C}, {(long long)N * C3, hd, C3},
              {NC, hd, C}, nullptr, 0, 0, qs, ks, N, H, scale, 0, L.np};
  // fp32: its output feeds proj's int8 quantization (sums in float64)
  using Acc = typename std::conditional<std::is_same<T, float>::value,
                                        double, float>::type;
  return simt_core<T, true, Acc>(a, B, hd, s);
}

}  // namespace dyt

extern "C" {

// Bytes of scratch dyt_simt_core_q8 takes.
long long dyt_simt_core_q8_scratch_bytes(int B, int N, int C, int H) {
  return (long long)dyt::ScQ8Scratch(B, N, C, H).bytes;
}

// The int8-score core (K10's function) on raw qkv [B, N, 3C] -> out
// [B, N, C], fp32 (t_f32) or bf16, H even; scratch of
// dyt_simt_core_q8_scratch_bytes on 16 bytes.  Returns a cudaError_t value.
int dyt_simt_core_q8(const void* qkv, void* out, void* scratch, int B, int N,
                     int C, int H, float scale, int t_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_f32)
    return dyt::simt_core_q8_qkv(static_cast<const float*>(qkv),
                                 static_cast<float*>(out), scratch, B, N, C,
                                 H, scale, s);
  return dyt::simt_core_q8_qkv(static_cast<const dyt::bf16*>(qkv),
                               static_cast<dyt::bf16*>(out), scratch, B, N,
                               C, H, scale, s);
}

}  // extern "C"
