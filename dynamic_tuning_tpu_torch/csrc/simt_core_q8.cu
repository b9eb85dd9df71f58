// The SIMT attention core's int8-score form (K10's function,
// dynamic_tuning_tpu/ops/quant.py::attn_core_pairs_q8) on fp32 qkv and on
// bf16 qkv at head dims 192 and 256: the k lane means and the q and k codes
// from two small kernels, then simt_core.cuh's kernel with dp4a scores.
#include "simt_core.cuh"

namespace dyt {

// --- the int8-score form's codes ------------------------------------------------

// mean[b, c] = mean over the N rows of k[b, :, c] (c < C), summed in float64
// and rounded once (the plain version's order-free form)
template <typename T>
__global__ void __launch_bounds__(256)
k_lane_mean_kernel(const T* __restrict__ qkv, float* __restrict__ mean, int N,
                   int C) {
  const int b = blockIdx.y, c = blockIdx.x * 256 + threadIdx.x;
  if (c >= C) return;
  const T* kb = qkv + (size_t)b * N * 3 * C + C + c;
  double acc = 0.0;
  for (int n = 0; n < N; ++n) acc += (double)to_f32(kb[(size_t)n * 3 * C]);
  mean[(size_t)b * C + c] = __double2float_rn(acc / (double)N);
}

// where(amax > 0, 127 / amax, 0) (IEEE), codes rint(v * inv) clipped to
// +-127, the row scale amax * (1 / 127): quant.cu's rounding
__device__ __forceinline__ float sc_inv127(float amax) {
  return amax > 0.f ? __fdiv_rn(127.f, amax) : 0.f;
}
__device__ __forceinline__ int8_t sc_code(float v, float inv) {
  return static_cast<int8_t>(
      fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f));
}

// One warp a row job of one token: jobs 0 .. H-1 quantize q of head j
// (scaled in fp32) over its hd lanes, jobs H .. H + H/2 - 1 the centred k
// of head pair j - H over its 2 hd lanes.
template <typename T>
__global__ void __launch_bounds__(256)
q8_codes_kernel(const T* __restrict__ qkv, const float* __restrict__ mean,
                int8_t* __restrict__ qc, int8_t* __restrict__ kc,
                float* __restrict__ qs, float* __restrict__ ks, int N, int C,
                int H, float scale) {
  const int row = blockIdx.x;                  // b * N + n
  const int b = row / N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = C / H, jobs = H + H / 2;
  const T* xr = qkv + (size_t)row * 3 * C;
  for (int j = warp; j < jobs; j += 8) {
    const bool isq = j < H;
    const int w = isq ? hd : 2 * hd;                       // lanes
    const int c0 = isq ? j * hd : (j - H) * 2 * hd;        // first column
    const T* src = xr + (isq ? 0 : C) + c0;
    const float* mu = mean + (size_t)b * C + c0;
    auto value = [&](int d) {
      const float v = to_f32(src[d]);
      return isq ? __fmul_rn(v, scale) : __fsub_rn(v, mu[d]);
    };
    float amax = 0.f;
    for (int d = lane; d < w; d += 32) amax = fmaxf(amax, fabsf(value(d)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float inv = sc_inv127(amax);
    int8_t* dst = (isq ? qc : kc) + (size_t)row * C + c0;
    for (int d = lane; d < w; d += 32) dst[d] = sc_code(value(d), inv);
    if (lane == 0) {
      const float rs = __fmul_rn(amax, F32C(1.0 / 127.0));
      if (isq)
        qs[(size_t)row * H + j] = rs;
      else
        ks[(size_t)row * (H / 2) + (j - H)] = rs;
    }
  }
}

// Scratch of the int8-score form: q and k codes [B*N, C] int8, their scales
// [B*N, H] and [B*N, H/2], the k lane means [B, C] fp32; each piece on 16
// bytes.
struct ScQ8Scratch {
  size_t qc, kc, qs, ks, mean, bytes;
  ScQ8Scratch(int B, int N, int C, int H) {
    auto up = [](size_t v) { return (v + 15) / 16 * 16; };
    const size_t M = (size_t)B * N;
    qc = 0;
    kc = up(M * C);
    qs = kc + up(M * C);
    ks = qs + up(M * H * 4);
    mean = ks + up(M * (H / 2) * 4);
    bytes = mean + up((size_t)B * C * 4);
  }
};

template <typename T>
static cudaError_t simt_core_q8_qkv(const T* qkv, T* out, void* scratch,
                                    int B, int N, int C, int H, float scale,
                                    cudaStream_t s) {
  if (B <= 0 || N <= 0 || H <= 0 || H % 2 || C % H || C % 16)
    return cudaErrorInvalidValue;
  const int hd = C / H;
  const ScQ8Scratch L(B, N, C, H);
  auto* base = static_cast<unsigned char*>(scratch);
  auto* qc = reinterpret_cast<int8_t*>(base + L.qc);
  auto* kc = reinterpret_cast<int8_t*>(base + L.kc);
  auto* qs = reinterpret_cast<float*>(base + L.qs);
  auto* ks = reinterpret_cast<float*>(base + L.ks);
  auto* mean = reinterpret_cast<float*>(base + L.mean);
  k_lane_mean_kernel<T><<<dim3((C + 255) / 256, B), 256, 0, s>>>(qkv, mean,
                                                                 N, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q8_codes_kernel<T><<<B * N, 256, 0, s>>>(qkv, mean, qc, kc, qs, ks, N, C, H,
                                           scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long NC = (long long)N * C, C3 = 3LL * C;
  ScArgs<T> a{qc, kc, qkv + 2 * C, out,
              {NC, hd, C}, {NC, hd, C}, {(long long)N * C3, hd, C3},
              {NC, hd, C}, nullptr, 0, 0, qs, ks, N, H, scale, 0};
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
