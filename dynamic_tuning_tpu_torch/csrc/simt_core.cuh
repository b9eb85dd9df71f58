// The serving attention core on the CUDA cores (SIMT), for the operands the
// tensor-core cores of attention_sublayer.cu, windowed_attention.cu and
// quant.cu do not take (its entries: simt_core.cu, and simt_core_q8.cu for
// the int8-score form):
//   * fp32 q, k, v (fp32 compute: K1's function, the core inside the fp32
//     sublayer chain of K2, K3 and K7, and K5, K6 and K8 with an fp32 qkv
//     scratch), with an optional bf16 [H, N, N] bias upcast at the score add
//     (K9 in an fp32 model);
//   * bf16 q, k, v at head dims 192 and 256, which the JAX package fuses
//     ((2 hd) % 128 == 0) and the wgmma cores are not instantiated for;
//   * the int8-score form of K10 (dynamic_tuning_tpu/ops/quant.py::
//     attn_core_pairs_q8) on fp32 qkv, and on bf16 qkv at head dims 192 and
//     256: the k lane means, the k codes of each head pair's 2 hd lanes and
//     the per-head q codes come from two small kernels (k_lane_mean_kernel,
//     q8_codes_kernel), the exact int32 Q K^T from dp4a.
// They replace the same TPU kernels as the cores they stand in for
// (dynamic_tuning_tpu/ops/mha_serving.py::attn_core_pairs inside
// attention_sublayer_serving, dyt_prologue_serving and
// dyt_prologue_serving_moe; mha_serving_fused; mha_windowed_fused;
// quant.py::attn_core_pairs_q8), at the dtypes and head dims those are
// generic in.
//
// Per query row of each head (K1's rounding; T the operands' type):
//   q' = T(q * scale);  s = q' . k (fp32) [+ fp32(bias)]
//   e = exp(clip(s, -60, 80) - 20);  l = sum(e) in fp32 (the unrounded e)
//   o = (T(e) @ v in fp32) * (1 / l) -> T
// or K15's (dynamic_tuning_tpu/ops/mha_serving.py::mha_serving, the
// speed-test forward's attention, at head dims 192 and 256): the scale
// rounded to T first, l the sum of the rounded p = T(e), o / l.
// and in the int8-score form s = (float(qq . kq) * qs) * ks.  The serving
// softmax has no row max, so each key tile's e is final when computed: the
// walk over keys carries only l and o, never rescales.
//
// What bounds it on an H100.  At ViT-B/16 in fp32 (B = 128, N = 197, 12
// heads of 64) the products are 15.3 GFLOP: 0.23 ms at the 67 TFLOP/s FFMA
// peak against 0.11 ms of bytes (q, k, v read, the output written, in fp32),
// so the FMAs bound it; there are 60 M expf.
//
// What the design does about it (a simple form; its speed is later work).
// A block of 256 threads owns 64 query rows of one (sample, head): the scaled
// q' rows sit in shared memory as fp32 (or int8 codes, four to a word), and
// the block walks the keys in tiles of KT (64 at hd <= 128, 32 past it):
//   * the tile's K (or codes) and V come into shared memory as fp32 rows
//     padded by four words, so float4 reads of eight consecutive threads
//     fall on distinct banks;
//   * thread (ty, tx) computes the scores of rows ty + 16 i and keys
//     tx + 16 j from float4 (or int4 of codes, dp4a) reads along hd, adds the
//     bias, takes the clamped expf, adds e to its rows' l and writes T(e) to
//     a score tile in shared memory;
//   * then it accumulates o for rows ty + 16 i and columns 4 tx + 64 c ..
//     + 3 from the score tile (a broadcast) and V (float4 reads): the output
//     row is split over the sixteen threads of a half warp, so at hd 256 a
//     thread holds 64 sums, not 256;
//   * l is summed over the half warp at the end, o * (1 / l) stored in T.
// Where an int8 requantization follows (the fp32 core inside K6 and K8,
// and K10 on fp32 qkv) the scores, l and o are summed in float64 (Acc):
// the kernel then gives the plain version's bits, at the FP64 rate (half
// the FFMA rate on an H100, and twice the registers); elsewhere fp32.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace dyt {

constexpr int SC_THREADS = 256;
constexpr int SC_QT = 64;                  // query rows a block

__host__ __device__ constexpr int sc_kt(int hd) { return hd <= 128 ? 64 : 32; }

// Shared memory of the SIMT core (fp32 words): Q [QT][QW], K [KT][QW],
// V [KT][HD + 4], scores [QT][KT + 4], then (int8 scores) the q scales [QT]
// and k scales [KT].  QW is HD + 4 words, or HD / 4 + 4 for packed codes.
template <int HD, bool Q8>
struct ScLayout {
  static constexpr int KT = sc_kt(HD);
  static constexpr int QW = Q8 ? HD / 4 + 4 : HD + 4;
  static constexpr int VW = HD + 4;
  static constexpr int SW = KT + 4;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + SC_QT * QW;
  static constexpr int V_OFF = K_OFF + KT * QW;
  static constexpr int S_OFF = V_OFF + KT * VW;
  static constexpr int QS_OFF = S_OFF + SC_QT * SW;
  static constexpr int KS_OFF = QS_OFF + (Q8 ? SC_QT : 0);
  static constexpr int WORDS = KS_OFF + (Q8 ? KT : 0);
  static constexpr int BYTES = WORDS * 4;
};

// Element strides (batch, head, row) of q, k, v and out, unit stride along
// hd.  In the int8-score form q and k are the codes ([B, N, C] int8, head h
// at column h * hd for both: the k codes of a pair row cover its two heads'
// lanes), qs [B, N, H] and ks [B, N, H / 2] their row scales.
template <typename T>
struct ScArgs {
  const void* q;
  const void* k;
  const T* v;
  T* o;
  long long sq[3], sk[3], sv[3], so[3];
  const bf16* bias;          // [H, N, N] (strides bh, br, unit) or null
  long long bh, br;
  const float* qs;
  const float* ks;
  int N, H;
  float scale;
  int k15;                   // K15's rounding (bf16 scale, l over T(e), o / l)
};

// Acc, the sums' type: fp32, or float64 where the output is requantized
// (the plain version sums the scores, l and o in float64 and rounds once;
// the products of two fp32 values are exact in float64, so the kernel
// lands on its bits but where a sum of another order rounds across a float
// boundary, and the int8 codes downstream then agree).
__device__ __forceinline__ float sc_fma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double sc_fma(float a, float b, double c) {
  return fma(static_cast<double>(a), static_cast<double>(b), c);
}
__device__ __forceinline__ float sc_f32(float v) { return v; }
__device__ __forceinline__ float sc_f32(double v) {
  return __double2float_rn(v);
}

template <typename T, int HD, bool Q8, typename Acc>
__global__ void __launch_bounds__(SC_THREADS)
simt_core_kernel(const ScArgs<T> a) {
  using L = ScLayout<HD, Q8>;
  constexpr int KT = L::KT;
  constexpr int NJ = KT / 16;            // keys a thread scores per tile
  constexpr int NC = HD / 64;            // float4 output groups a row
  extern __shared__ __align__(16) float sc_smem[];
  float* Qs = sc_smem + L::Q_OFF;
  float* Ks = sc_smem + L::K_OFF;
  float* Vs = sc_smem + L::V_OFF;
  float* Ss = sc_smem + L::S_OFF;
  float* qsc = sc_smem + L::QS_OFF;
  float* ksc = sc_smem + L::KS_OFF;

  const int N = a.N, q0 = blockIdx.x * SC_QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // --- the query tile: q' = T(q * scale) as fp32, or the codes ------------
  if constexpr (Q8) {
    const int8_t* qb = static_cast<const int8_t*>(a.q) + b * a.sq[0] +
                       h * a.sq[1];
    int* Qi = reinterpret_cast<int*>(Qs);
    for (int i = tid; i < SC_QT * (HD / 16); i += SC_THREADS) {
      const int r = i / (HD / 16), c = (i % (HD / 16)) * 16;
      const int n = q0 + r;
      int4 v = make_int4(0, 0, 0, 0);
      if (n < N) v = *reinterpret_cast<const int4*>(qb + n * a.sq[2] + c);
      *reinterpret_cast<int4*>(Qi + r * L::QW + c / 4) = v;
    }
    for (int r = tid; r < SC_QT; r += SC_THREADS) {
      const int n = q0 + r;
      qsc[r] = n < N ? a.qs[((long long)b * N + n) * a.H + h] : 0.f;
    }
  } else {
    const T* qb = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
    // K15 takes the scale as XLA does a weak-typed Python float times a
    // bf16 array: rounded to the operands' type first
    const float scale = a.k15 ? to_f32(from_f32<T>(a.scale)) : a.scale;
    for (int i = tid; i < SC_QT * (HD / 8); i += SC_THREADS) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      const int n = q0 + r;
      float v[8];
      if (n < N) {
        load8(qb + n * a.sq[2] + c, v);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = to_f32(from_f32<T>(__fmul_rn(v[e], scale)));
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
      store8(Qs + r * L::QW + c, v);
    }
  }

  Acc o[4][NC][4];
  Acc l[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][c][e] = 0;

  const T* vb = a.v + b * a.sv[0] + h * a.sv[1];
  const bf16* bb = a.bias != nullptr ? a.bias + h * a.bh : nullptr;
  const int nt = (N + KT - 1) / KT;
  for (int t = 0; t < nt; ++t) {
    const int k0 = t * KT;
    __syncthreads();                     // the last tile's K, V, S are read
    // --- the key tile's K (or codes and scales) and V --------------------
    if constexpr (Q8) {
      const int8_t* kb = static_cast<const int8_t*>(a.k) + b * a.sk[0] +
                         h * a.sk[1];
      int* Ki = reinterpret_cast<int*>(Ks);
      for (int i = tid; i < KT * (HD / 16); i += SC_THREADS) {
        const int r = i / (HD / 16), c = (i % (HD / 16)) * 16;
        const int n = k0 + r;
        int4 v = make_int4(0, 0, 0, 0);
        if (n < N) v = *reinterpret_cast<const int4*>(kb + n * a.sk[2] + c);
        *reinterpret_cast<int4*>(Ki + r * L::QW + c / 4) = v;
      }
      for (int r = tid; r < KT; r += SC_THREADS) {
        const int n = k0 + r;
        ksc[r] = n < N ? a.ks[((long long)b * N + n) * (a.H / 2) + h / 2]
                       : 0.f;
      }
    } else {
      const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
      for (int i = tid; i < KT * (HD / 8); i += SC_THREADS) {
        const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
        const int n = k0 + r;
        float v[8];
        if (n < N) {
          load8(kb + n * a.sk[2] + c, v);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = 0.f;
        }
        store8(Ks + r * L::QW + c, v);
      }
    }
    for (int i = tid; i < KT * (HD / 8); i += SC_THREADS) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      const int n = k0 + r;
      float v[8];
      if (n < N) {
        load8(vb + n * a.sv[2] + c, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;   // 0 * 0 past N, no NaN
      }
      store8(Vs + r * L::VW + c, v);
    }
    __syncthreads();

    // --- scores, e, l: rows ty + 16 i, keys tx + 16 j ----------------------
    float s[4][NJ];
    if constexpr (Q8) {
      int acc[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0;
      const int* Qi = reinterpret_cast<const int*>(Qs);
      const int* Ki = reinterpret_cast<const int*>(Ks);
#pragma unroll 4
      for (int d = 0; d < HD / 4; d += 4) {
        int4 qv[4], kv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const int4*>(Qi + (ty + 16 * i) * L::QW +
                                                 d);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          kv[j] = *reinterpret_cast<const int4*>(Ki + (tx + 16 * j) * L::QW +
                                                 d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            acc[i][j] = __dp4a(qv[i].x, kv[j].x, acc[i][j]);
            acc[i][j] = __dp4a(qv[i].y, kv[j].y, acc[i][j]);
            acc[i][j] = __dp4a(qv[i].z, kv[j].z, acc[i][j]);
            acc[i][j] = __dp4a(qv[i].w, kv[j].w, acc[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          s[i][j] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]),
                                        qsc[ty + 16 * i]),
                              ksc[tx + 16 * j]);
    } else {
      Acc sa[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) sa[i][j] = 0;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        float4 qv[4], kv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) *
                                                   L::QW + d);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) *
                                                   L::QW + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            sa[i][j] = sc_fma(qv[i].x, kv[j].x, sa[i][j]);
            sa[i][j] = sc_fma(qv[i].y, kv[j].y, sa[i][j]);
            sa[i][j] = sc_fma(qv[i].z, kv[j].z, sa[i][j]);
            sa[i][j] = sc_fma(qv[i].w, kv[j].w, sa[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = sc_f32(sa[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, n = q0 + r;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int key = tx + 16 * j;
        float e = 0.f;
        if (k0 + key < N && n < N) {
          float v = s[i][j];
          if (bb != nullptr)
            v = __fadd_rn(v, __bfloat162float(bb[n * a.br + k0 + key]));
          e = expf(__fsub_rn(fminf(fmaxf(v, -60.f), 80.f), 20.f));
        }
        const float p = to_f32(from_f32<T>(e));
        l[i] += a.k15 ? p : e;          // K15's l sums the rounded p
        Ss[r * L::SW + key] = p;
      }
    }
    __syncthreads();

    // --- o += T(e) @ v: rows ty + 16 i, columns 4 tx + 64 c .. + 3 ---------
    const int kn = N - k0 < KT ? N - k0 : KT;
    for (int key = 0; key < kn; ++key) {
      float4 vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        vv[c] = *reinterpret_cast<const float4*>(Vs + key * L::VW + 64 * c +
                                                 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ss[(ty + 16 * i) * L::SW + key];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          o[i][c][0] = sc_fma(p, vv[c].x, o[i][c][0]);
          o[i][c][1] = sc_fma(p, vv[c].y, o[i][c][1]);
          o[i][c][2] = sc_fma(p, vv[c].z, o[i][c][2]);
          o[i][c][3] = sc_fma(p, vv[c].w, o[i][c][3]);
        }
      }
    }
  }

  // --- l over the half warp, o * (1 / l) ---------------------------------
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 1; m < 16; m <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], m);
  T* ob = a.o + b * a.so[0] + h * a.so[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty + 16 * i;
    if (n >= N) continue;
    const float li = sc_f32(l[i]), inv = __frcp_rn(li);
    // K1: o * (1 / l); K15: o / l, the IEEE quotient
    auto out = [&](Acc x) {
      return a.k15 ? __fdiv_rn(sc_f32(x), li) : __fmul_rn(sc_f32(x), inv);
    };
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      T* p = ob + n * a.so[2] + 64 * c + 4 * tx;
      store2(p, out(o[i][c][0]), out(o[i][c][1]));
      store2(p + 2, out(o[i][c][2]), out(o[i][c][3]));
    }
  }
}

template <typename T, int HD, bool Q8, typename Acc>
static cudaError_t launch_sc(const ScArgs<T>& a, int B, cudaStream_t s) {
  using L = ScLayout<HD, Q8>;
  cudaError_t err = cudaFuncSetAttribute(
      simt_core_kernel<T, HD, Q8, Acc>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + SC_QT - 1) / SC_QT, a.H, B);
  simt_core_kernel<T, HD, Q8, Acc><<<grid, SC_THREADS, L::BYTES, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool Q8, typename Acc = float>
static cudaError_t simt_core(const ScArgs<T>& a, int B, int hd,
                             cudaStream_t s) {
  if (a.N <= 0 || B <= 0 || a.H <= 0 || B > 65535 || a.H > 65535)
    return cudaErrorInvalidValue;
  switch (hd) {
    case 64: return launch_sc<T, 64, Q8, Acc>(a, B, s);
    case 128: return launch_sc<T, 128, Q8, Acc>(a, B, s);
    case 192: return launch_sc<T, 192, Q8, Acc>(a, B, s);
    case 256: return launch_sc<T, 256, Q8, Acc>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dyt
