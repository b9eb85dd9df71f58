// The serving attention core on the CUDA cores (SIMT), for what the other
// cores do not take (its entries: simt_core.cu, and simt_core_q8.cu for the
// int8-score form):
//   * the int8-score form of K10 (dynamic_tuning_tpu/ops/quant.py::
//     attn_core_pairs_q8) on fp32 qkv past head dim 256 (up to it
//     exact_core.cu's int8-score mode) and on bf16 qkv past head dim 768
//     (up to it quant.cu's and q8_ring.cu's wgmma forms): the k lane means,
//     the k codes of each head pair's 2 hd lanes and the per-head q codes
//     come from two small kernels (k_lane_mean_kernel, q8_codes_kernel),
//     the exact int32 Q K^T from dp4a;
//   * the exact fp32 route past head dim 256 (the core of K6 and K8 with
//     fp32 adapters, whose output is requantized, so its sums are float64
//     as the plain version's; up to 256 it is exact_core.cu's DMMA kernel);
//   * past head dim 768 every core: bf16 and fp32, K1's and K15's rounding,
//     K9's bias (where the wgmma and fp32 cores' q tile and two stages of K
//     no longer fit a block).
// Up to head dim 768 the fp32 cores of K1, K2, K3, K7 and K9 are
// f32_core.cu's register-tiled kernels, and bf16 K1, K15, K9 and the cores
// of K2, K3, K5-K8 without int8 scores attention_sublayer.cu's and
// windowed_attention.cu's wgmma cores.  These replace the same TPU kernels
// as the cores they stand in for (dynamic_tuning_tpu/ops/mha_serving.py::
// attn_core_pairs inside quant.py's int8 chains K6 and K8; quant.py::
// attn_core_pairs_q8; mha_serving.py::mha_windowed_fused), at the dtypes
// and head dims those are generic in.
//
// Per query row of each head (K1's rounding; T the operands' type; K15's is
// the kernel's note below):
//   q' = T(q * scale);  s = q' . k (fp32) [+ fp32(bias)]
//   e = exp(clip(s, -60, 80) - 20);  l = sum(e) in fp32 (the unrounded e)
//   o = (T(e) @ v in fp32) * (1 / l) -> T
// and in the int8-score form s = (float(qq . kq) * qs) * ks.
// The serving softmax has no row max, so each key tile's e is final when
// computed: the walk over keys carries only l and o, never rescales.
//
// What bounds it on an H100.  The fp32 int8-score form at 2 heads of 384
// (B = 32, N = 197) sums its P V in float64: 0.95 G multiply-adds, 0.057 ms
// at the FP64 rate (half the FFMA rate); its scores are recomputed for
// every 64-column slice of o (below).
//
// What the design does about it (a simple form: exactness first, and the
// shapes it serves are off the main paths: no model the repository ships
// has a head dim past 256).  simt_core_slices_kernel takes hd at run time
// (every hd with (2 hd) % 128 == 0 that the JAX package fuses: a list of
// template instances would stop at its last entry).  A block of 256
// threads owns 64 query rows of one (sample, head); Q, K and V rows would
// not fit a block past hd ~ 400, nor o a thread's registers, so it walks
// hd in 64-column slices:
//   * o is built one 64-column slice at a time (four sums a row a thread);
//   * for each slice the block walks the key tiles (32 keys) and sums each
//     tile's q . k over the 64-column slices of q and k (or of their codes)
//     brought into shared memory in turn, then V's slice;
//   * so each output slice recomputes the scores.  The serving softmax has
//     no row max, so the recomputed e and l are the same bits each time.
// Acc is float64 in the int8-score form on fp32 qkv and on the exact route
// (the kernel then gives the plain version's bits, at the FP64 rate and
// twice the registers), fp32 elsewhere.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace dyt {

constexpr int SC_THREADS = 256;
constexpr int SC_QT = 64;                  // query rows a block

// Element strides (batch, head, row) of q, k, v and out, unit stride along
// hd.  In the int8-score form q and k are the codes ([B, N, C] int8, head h
// at column h * hd for both: the k codes of a pair row cover its two heads'
// lanes), qs [B, N, H] and ks [B, H / 2, ks_n] their row scales.
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
  int k15;                   // K15's rounding (the slices kernel only)
  int ks_n;                  // a pair's row of ks (N rounded up to 4)
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

// --- any head dim that is a multiple of 64, in 64-column slices -------------

constexpr int SS_KT = 32;                  // keys a tile
constexpr int SS_W = 64;                   // columns a slice

// Shared memory of the slices kernel (fp32 words): a Q slice [QT][QW], a K
// slice [KT][QW] (QW = 68, or 20 for a slice's 64 packed codes), a V slice
// [KT][68], scores [QT][KT + 4], then (int8 scores) the q and k scales.
template <bool Q8>
struct SsLayout {
  static constexpr int QW = Q8 ? SS_W / 4 + 4 : SS_W + 4;
  static constexpr int VW = SS_W + 4;
  static constexpr int SW = SS_KT + 4;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + SC_QT * QW;
  static constexpr int V_OFF = K_OFF + SS_KT * QW;
  static constexpr int S_OFF = V_OFF + SS_KT * VW;
  static constexpr int QS_OFF = S_OFF + SC_QT * SW;
  static constexpr int KS_OFF = QS_OFF + SC_QT;
  static constexpr int BYTES = (KS_OFF + SS_KT) * 4;
};

// Block (query tile, head, sample), 256 threads: thread (ty, tx) scores rows
// ty + 16 i against keys tx + 16 j and sums o for rows ty + 16 i at columns
// 4 tx .. 4 tx + 3 of the slice.  K15 (a.k15, bf16): q' = T(q * T(scale)),
// p = T(e), l the sum of p and o = (p @ v) / l, the IEEE quotient.
template <typename T, bool Q8, typename Acc>
__global__ void __launch_bounds__(SC_THREADS, 2)
simt_core_slices_kernel(const ScArgs<T> a, int hd) {
  using L = SsLayout<Q8>;
  constexpr int KT = SS_KT, NJ = KT / 16;
  extern __shared__ __align__(16) float ss_smem[];
  float* Qs = ss_smem + L::Q_OFF;
  float* Ks = ss_smem + L::K_OFF;
  float* Vs = ss_smem + L::V_OFF;
  float* Ss = ss_smem + L::S_OFF;
  float* qsc = ss_smem + L::QS_OFF;
  float* ksc = ss_smem + L::KS_OFF;

  const int N = a.N, q0 = blockIdx.x * SC_QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nt = (N + KT - 1) / KT, ns = hd / SS_W;
  const bool k15 = !Q8 && a.k15;
  const float scale =
      k15 ? to_f32(from_f32<T>(a.scale)) : a.scale;
  const T* vb = a.v + b * a.sv[0] + h * a.sv[1];
  const bf16* bb = a.bias != nullptr ? a.bias + h * a.bh : nullptr;
  if constexpr (Q8) {
    for (int r = tid; r < SC_QT; r += SC_THREADS) {
      const int n = q0 + r;
      qsc[r] = n < N ? a.qs[((long long)b * N + n) * a.H + h] : 0.f;
    }
  }

  // the 64-column slice d0 of this tile's q' (or codes) and of key tile
  // k0's k (or codes and scales)
  auto load_qk = [&](int d0, int k0) {
    if constexpr (Q8) {
      const int8_t* qb = static_cast<const int8_t*>(a.q) + b * a.sq[0] +
                         h * a.sq[1] + d0;
      const int8_t* kb = static_cast<const int8_t*>(a.k) + b * a.sk[0] +
                         h * a.sk[1] + d0;
      int* Qi = reinterpret_cast<int*>(Qs);
      int* Ki = reinterpret_cast<int*>(Ks);
      for (int i = tid; i < (SC_QT + KT) * (SS_W / 16); i += SC_THREADS) {
        const bool isq = i < SC_QT * (SS_W / 16);
        const int j = isq ? i : i - SC_QT * (SS_W / 16);
        const int r = j / (SS_W / 16), c = (j % (SS_W / 16)) * 16;
        const int n = (isq ? q0 : k0) + r;
        int4 v = make_int4(0, 0, 0, 0);
        if (n < N)
          v = *reinterpret_cast<const int4*>(
              isq ? qb + n * a.sq[2] + c : kb + n * a.sk[2] + c);
        *reinterpret_cast<int4*>((isq ? Qi : Ki) + r * L::QW + c / 4) = v;
      }
      const float* ksb = a.ks + ((long long)b * (a.H / 2) + h / 2) * a.ks_n;
      for (int r = tid; r < KT; r += SC_THREADS) {
        const int n = k0 + r;
        ksc[r] = n < N ? ksb[n] : 0.f;
      }
    } else {
      const T* qb = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1] +
                    d0;
      const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1] +
                    d0;
      for (int i = tid; i < (SC_QT + KT) * (SS_W / 8); i += SC_THREADS) {
        const bool isq = i < SC_QT * (SS_W / 8);
        const int j = isq ? i : i - SC_QT * (SS_W / 8);
        const int r = j / (SS_W / 8), c = (j % (SS_W / 8)) * 8;
        const int n = (isq ? q0 : k0) + r;
        float v[8];
        if (n < N) {
          load8((isq ? qb + n * a.sq[2] : kb + n * a.sk[2]) + c, v);
          if (isq) {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[e] = to_f32(from_f32<T>(__fmul_rn(v[e], scale)));
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = 0.f;
        }
        store8((isq ? Qs : Ks) + r * L::QW + c, v);
      }
    }
  };

  for (int c0 = 0; c0 < hd; c0 += SS_W) {
    Acc o[4][4];
    Acc l[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] = 0;

    for (int t = 0; t < nt; ++t) {
      const int k0 = t * KT;
      // --- s = q' . k over the hd slices ---------------------------------
      Acc sa[4][NJ];
      int si[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          sa[i][j] = 0;
          si[i][j] = 0;
        }
      for (int d = 0; d < ns; ++d) {
        __syncthreads();                 // the last slice's reads are done
        load_qk(d * SS_W, k0);
        if (d == 0) {
          // V's slice c0 of this key tile (zeros past N: 0 * 0, no NaN)
          for (int i = tid; i < KT * (SS_W / 8); i += SC_THREADS) {
            const int r = i / (SS_W / 8), c = (i % (SS_W / 8)) * 8;
            const int n = k0 + r;
            float v[8];
            if (n < N) {
              load8(vb + n * a.sv[2] + c0 + c, v);
            } else {
#pragma unroll
              for (int e = 0; e < 8; ++e) v[e] = 0.f;
            }
            store8(Vs + r * L::VW + c, v);
          }
        }
        __syncthreads();
        if constexpr (Q8) {
          const int* Qi = reinterpret_cast<const int*>(Qs);
          const int* Ki = reinterpret_cast<const int*>(Ks);
#pragma unroll
          for (int w = 0; w < SS_W / 4; w += 4) {
            int4 qv[4], kv[NJ];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              qv[i] = *reinterpret_cast<const int4*>(
                  Qi + (ty + 16 * i) * L::QW + w);
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              kv[j] = *reinterpret_cast<const int4*>(
                  Ki + (tx + 16 * j) * L::QW + w);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < NJ; ++j) {
                si[i][j] = __dp4a(qv[i].x, kv[j].x, si[i][j]);
                si[i][j] = __dp4a(qv[i].y, kv[j].y, si[i][j]);
                si[i][j] = __dp4a(qv[i].z, kv[j].z, si[i][j]);
                si[i][j] = __dp4a(qv[i].w, kv[j].w, si[i][j]);
              }
          }
        } else {
#pragma unroll 4
          for (int w = 0; w < SS_W; w += 4) {
            float4 qv[4], kv[NJ];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              qv[i] = *reinterpret_cast<const float4*>(
                  Qs + (ty + 16 * i) * L::QW + w);
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              kv[j] = *reinterpret_cast<const float4*>(
                  Ks + (tx + 16 * j) * L::QW + w);
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
        }
      }
      // --- e, l, the score tile -------------------------------------------
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, n = q0 + r;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int key = tx + 16 * j;
          float e = 0.f;
          if (k0 + key < N && n < N) {
            float v;
            if constexpr (Q8)
              v = __fmul_rn(__fmul_rn(__int2float_rn(si[i][j]), qsc[r]),
                            ksc[key]);
            else
              v = sc_f32(sa[i][j]);
            if (bb != nullptr)
              v = __fadd_rn(v, __bfloat162float(bb[n * a.br + k0 + key]));
            e = expf(__fsub_rn(fminf(fmaxf(v, -60.f), 80.f), 20.f));
          }
          const float p = to_f32(from_f32<T>(e));
          l[i] += k15 ? p : e;
          Ss[r * L::SW + key] = p;
        }
      }
      __syncthreads();
      // --- o += T(e) @ v over this slice's columns ------------------------
      const int kn = N - k0 < KT ? N - k0 : KT;
      for (int key = 0; key < kn; ++key) {
        const float4 vv =
            *reinterpret_cast<const float4*>(Vs + key * L::VW + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ss[(ty + 16 * i) * L::SW + key];
          o[i][0] = sc_fma(p, vv.x, o[i][0]);
          o[i][1] = sc_fma(p, vv.y, o[i][1]);
          o[i][2] = sc_fma(p, vv.z, o[i][2]);
          o[i][3] = sc_fma(p, vv.w, o[i][3]);
        }
      }
    }

    // --- l over the half warp, this slice of o / l ------------------------
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
      const float lf = sc_f32(l[i]);
      const float inv = __frcp_rn(lf);
      auto out = [&](Acc x) {
        return k15 ? __fdiv_rn(sc_f32(x), lf) : __fmul_rn(sc_f32(x), inv);
      };
      T* p = ob + n * a.so[2] + c0 + 4 * tx;
      store2(p, out(o[i][0]), out(o[i][1]));
      store2(p + 2, out(o[i][2]), out(o[i][3]));
    }
  }
}

template <typename T, bool Q8, typename Acc>
static cudaError_t launch_ss(const ScArgs<T>& a, int B, int hd,
                             cudaStream_t s) {
  using L = SsLayout<Q8>;
  auto kernel = simt_core_slices_kernel<T, Q8, Acc>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + SC_QT - 1) / SC_QT, a.H, B);
  kernel<<<grid, SC_THREADS, L::BYTES, s>>>(a, hd);
  return cudaGetLastError();
}

// Every form on the slices kernel, hd a multiple of 64 given at run time.
template <typename T, bool Q8, typename Acc = float>
static cudaError_t simt_core(const ScArgs<T>& a, int B, int hd,
                             cudaStream_t s) {
  if (a.N <= 0 || B <= 0 || a.H <= 0 || B > 65535 || a.H > 65535 || hd <= 0 ||
      hd % SS_W)
    return cudaErrorInvalidValue;
  return launch_ss<T, Q8, Acc>(a, B, hd, s);
}

}  // namespace dyt
