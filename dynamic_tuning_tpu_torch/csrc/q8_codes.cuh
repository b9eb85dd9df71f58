// The codes of K10's int8 scores (dynamic_tuning_tpu/ops/quant.py::
// attn_core_pairs_q8) written to device memory by two small kernels, shared
// by the three forms that read them: the SIMT int8-score form
// (simt_core_q8.cu: fp32 qkv past head dim 256, bf16 past 768), the wgmma
// key ring (q8_ring.cu: bf16 past the staged core's N and past head dim
// 256) and the exact core's int8-score mode (exact_core.cu: fp32 qkv at
// head dims 64 to 256).
//   * k_lane_mean_kernel: each key lane's mean over the N tokens, summed in
//     float64 and rounded once to fp32, the plain version's form: float64
//     holds such a sum of bf16 or fp32 values exactly, or within far less
//     than the fp32 rounding sees, in any order (the staged core sums the
//     same means in another one); eight warps a block each sum 32 lanes
//     over an eighth of the tokens, then one adds the eight partials;
//   * q8_codes_kernel: a group of lanes a row job (hd / 8 lanes rounded up
//     to a power of two, at most a warp: at hd 64 four jobs a warp; jobs
//     of all rows spread over the warps of the grid in row order): q
//     of one head scaled in fp32 and quantized over its hd lanes, or the
//     centred k of one head pair quantized over its 2 hd lanes (one scale
//     a pair row), IEEE 127/amax, half to even, clipped to +-127; each
//     lane 8 lanes of the row a step, its 8 codes stored as one 8-byte
//     word.
// Every other step is elementwise (the amax a max), so the codes and scales
// do not depend on how the work is split.
// The codes land at the columns of their head: q codes [B*N, C], k codes
// [B*N, C] (head h at columns h*hd .. h*hd + hd - 1 of its pair's row), the
// q scales [B*N, H], the k scales [B, H/2, Np] (Np = N rounded up to 4: each
// pair's scales are a row the ring's TMA reads in 128-byte boxes).
#pragma once

#include "common.cuh"

namespace dyt {

constexpr int Q8M_SLICES = 8;       // token slices (warps) a block

// mean[b, c] = mean over the N rows of k[b, :, c] (c < C), summed in float64
// and rounded once; block (b, 32 lanes), warp w the w-th eighth of the rows
template <typename T>
__global__ void __launch_bounds__(32 * Q8M_SLICES)
k_lane_mean_kernel(const T* __restrict__ qkv, float* __restrict__ mean, int N,
                   int C) {
  __shared__ double part[Q8M_SLICES][32];
  const int b = blockIdx.y, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int per = (N + Q8M_SLICES - 1) / Q8M_SLICES;
  const int n0 = w * per, n1 = min(N, n0 + per);
  double acc = 0.0;
  if (c < C) {
    const T* kb = qkv + (size_t)b * N * 3 * C + C + c;
#pragma unroll 8
    for (int n = n0; n < n1; ++n) acc += (double)to_f32(kb[(size_t)n * 3 * C]);
  }
  part[w][lane] = acc;
  __syncthreads();
  if (w == 0 && c < C) {
    double sum = 0.0;
#pragma unroll
    for (int i = 0; i < Q8M_SLICES; ++i) sum += part[i][lane];
    mean[(size_t)b * C + c] = __double2float_rn(sum / (double)N);
  }
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

constexpr int Q8C_JOB_WARPS = 8;    // warps a block of the codes kernel

// The lanes a row job takes: hd / 8 rounded up to a power of two, at most
// a warp (a k job, 2 hd wide, takes twice the steps)
__host__ __device__ inline int q8c_group(int hd) {
  int g = 1;
  while (g < 32 && 8 * g < hd) g <<= 1;
  return g;
}

// A group of G lanes (q8c_group) a row job, 32 / G consecutive jobs a
// warp: job j of token row (b * N + n) quantizes, for j < H, q of head j
// (scaled in fp32) over its hd lanes, else the centred k of head pair
// j - H over its 2 hd lanes (hd a multiple of 8).  Each lane takes 8
// lanes of the row a step.
template <typename T, int G>
__global__ void __launch_bounds__(32 * Q8C_JOB_WARPS)
q8_codes_kernel(const T* __restrict__ qkv, const float* __restrict__ mean,
                int8_t* __restrict__ qc, int8_t* __restrict__ kc,
                float* __restrict__ qs, float* __restrict__ ks, int M, int N,
                int C, int H, int np, float scale) {
  const int hd = C / H;
  const int jobs = H + H / 2;
  const long long warp =
      (long long)blockIdx.x * Q8C_JOB_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31, sub = lane & (G - 1);
  const long long job = warp * (32 / G) + lane / G;
  if (warp * (32 / G) >= (long long)M * jobs) return;   // the whole warp
  const bool valid = job < (long long)M * jobs;
  const int row = valid ? static_cast<int>(job / jobs) : 0;
  const int j = valid ? static_cast<int>(job % jobs) : 0;
  const int b = row / N, n = row % N;
  const bool isq = j < H;
  const int w = isq ? hd : 2 * hd;                         // lanes
  const int c0 = isq ? j * hd : (j - H) * 2 * hd;          // first column
  const T* src = qkv + (size_t)row * 3 * C + (isq ? 0 : C) + c0;
  const float* mu = mean + (size_t)b * C + c0;
  // lanes d .. d + 7 of the row, scaled (q) or centred (k)
  auto values = [&](int d, float (&v)[8]) {
    load8(src + d, v);
    if (isq) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(v[e], scale);
    } else {
      float m[8];
      load8(mu + d, m);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __fsub_rn(v[e], m[e]);
    }
  };
  float amax = 0.f;
  if (valid) {
    for (int d = sub * 8; d < w; d += 8 * G) {
      float v[8];
      values(d, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
  }
  for (int o = G / 2; o > 0; o >>= 1)          // within the lane group
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (!valid) return;
  const float inv = sc_inv127(amax);
  int8_t* dst = (isq ? qc : kc) + (size_t)row * C + c0;
  for (int d = sub * 8; d < w; d += 8 * G) {
    float v[8];
    values(d, v);
    unsigned u[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      u[e >> 2] |= (static_cast<unsigned>(sc_code(v[e], inv)) & 0xffu)
                   << (8 * (e & 3));
    *reinterpret_cast<uint2*>(dst + d) = make_uint2(u[0], u[1]);
  }
  if (sub == 0) {
    const float rs = __fmul_rn(amax, F32C(1.0 / 127.0));
    if (isq)
      qs[(size_t)row * H + j] = rs;
    else
      ks[((size_t)b * (H / 2) + (j - H)) * np + n] = rs;
  }
}

// Scratch of the codes: q and k codes [B*N, C] int8, their scales [B*N, H]
// and [B, H/2, Np], the k lane means [B, C] fp32; each piece on 128 bytes.
struct ScQ8Scratch {
  size_t qc, kc, qs, ks, mean, bytes;
  int np;                                      // N rounded up to 4
  ScQ8Scratch(int B, int N, int C, int H) {
    auto up = [](size_t v) { return (v + 127) / 128 * 128; };
    const size_t M = (size_t)B * N;
    np = (N + 3) / 4 * 4;
    qc = 0;
    kc = up(M * C);
    qs = kc + up(M * C);
    ks = qs + up(M * H * 4);
    mean = ks + up((size_t)B * (H / 2) * np * 4);
    bytes = mean + up((size_t)B * C * 4);
  }
};

// The codes of raw qkv [B, N, 3C] into ``scratch`` (ScQ8Scratch's layout):
// two launches on ``s``.
template <typename T>
static cudaError_t q8_codes(const T* qkv, void* scratch, int B, int N, int C,
                            int H, float scale, cudaStream_t s) {
  const ScQ8Scratch L(B, N, C, H);
  auto* base = static_cast<unsigned char*>(scratch);
  auto* mean = reinterpret_cast<float*>(base + L.mean);
  if (C % H || (C / H) % 8) return cudaErrorInvalidValue;
  k_lane_mean_kernel<T><<<dim3((C + 31) / 32, B), 32 * Q8M_SLICES, 0, s>>>(
      qkv, mean, N, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int M = B * N, G = q8c_group(C / H);
  const long long warps = ((long long)M * (H + H / 2) * G + 31) / 32;
  void (*kernel)(const T*, const float*, int8_t*, int8_t*, float*, float*,
                 int, int, int, int, int, float);
  switch (G) {
    case 1: kernel = q8_codes_kernel<T, 1>; break;
    case 2: kernel = q8_codes_kernel<T, 2>; break;
    case 4: kernel = q8_codes_kernel<T, 4>; break;
    case 8: kernel = q8_codes_kernel<T, 8>; break;
    case 16: kernel = q8_codes_kernel<T, 16>; break;
    default: kernel = q8_codes_kernel<T, 32>; break;
  }
  kernel<<<static_cast<unsigned>((warps + Q8C_JOB_WARPS - 1) /
                                 Q8C_JOB_WARPS),
           32 * Q8C_JOB_WARPS, 0, s>>>(
      qkv, mean, reinterpret_cast<int8_t*>(base + L.qc),
      reinterpret_cast<int8_t*>(base + L.kc),
      reinterpret_cast<float*>(base + L.qs),
      reinterpret_cast<float*>(base + L.ks), M, N, C, H, L.np, scale);
  return cudaGetLastError();
}

}  // namespace dyt
