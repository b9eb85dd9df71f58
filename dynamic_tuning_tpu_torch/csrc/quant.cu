// Int8 (W8A8) serving kernels.
//
// Replaces the TPU kernels of dynamic_tuning_tpu/ops/quant.py:
//   K4  q8_ln_mlp (_q8_mlp_kernel):            LN -> int8 fc1 -> GELU -> int8 fc2
//   K5  attention_sublayer_serving_q8 (_attn_sublayer_q8_kernel):
//       x + proj(core(qkv(LN(x)))) with int8 qkv and proj
//   K6  dyt_prologue_serving_q8 (_dyt_prologue_q8_kernel): K5's x_mid, then
//       the adapter/router kernel of dyt_prologue.cu unchanged
//   K10 attn_core_pairs_q8:                    the core with an int8 QK^T
//   K12 q8_dispatch_mlp (_q8_dispatch_mlp_kernel): the top-K rows of each
//       sample gathered through an index into K4's chain, the MLP rows
//       scattered back to their tokens (zeros elsewhere), and the gate
// and computes the int8 patch-embed stem (XLA's q8_conv there), and the
// GEMMs of scripts/profile_int8.py::make_mm (K16, the int8 / bf16 matmul
// probe): int8 x int8 -> int32 and bf16 x bf16 -> fp32, stored raw.
//
// Scheme: per-output-channel int8 weights (quantized once at load by the
// caller) times dynamic per-row int8 activations,
//     out[m, n] = ((float)sum_k qa[m,k] qw[n,k] * row_scale[m]) * col_scale[n]
//
// What bounds it on an H100.  At ViT-B/16 serving shapes (M = 128*197 rows,
// C = 768) the sublayer does 119 G int8 ops in qkv/proj (60 us at the
// 1979 TOPS int8 peak) and the MLP 238 G (120 us); the bf16 attention core
// adds 15 GFLOP.  Moving the activations through device memory -- int8
// codes, the bf16 qkv buffer, the fp32 GELU output that fc2's row
// quantization needs -- costs more: ~0.25 GB for the sublayer and ~0.5 GB
// for the MLP at dense rows (75 and 150 us at 3.35 TB/s).  The GEMMs were
// an Ampere-style mma.sync form (a cp.async ring and ldmatrix) at 300-420
// TOPS, under torch._int_mm's 510-720: the tensor-core rate, not the bytes,
// decided.  Fusing the quantizers into the GEMMs is later work.
//
// What the design does about it.  Short chains of kernels on the caller's
// stream, each following the TPU kernel's rounding points exactly:
//   ln_quant_kernel   one warp per row: fp32 LN (eps 1e-6), row amax,
//                     codes rint(v * 127/amax) clipped to +-127, scale
//                     amax * (1/127); the LN output never leaves registers;
//                     K12 reads its rows through the selection's index and
//                     writes the gate and the rows' scatter targets;
//   row_quant_kernel  the same quantization of a bf16 or fp32 row;
//   gemm_nt_kernel<int8_t> (gemm.cuh, the bf16 GEMM's design on int8: a
//                     persistent grid, a TMA ring of 128-deep k tiles fed by
//                     one producer thread, two consumer warpgroups on wgmma
//                     m64nNk32 s8 x s8 -> s32) with EpiQ8, an epilogue that
//                     dequantizes and applies the caller's bias / GELU /
//                     residual arithmetic in fp32 and stores whole 16-byte
//                     pieces of rows staged through shared memory (K12's fc2
//                     stores each row at its token), or stores the int32
//                     sums as they are (K16);
//   k_quant_kernel    (K10) one block per (sample, head pair): k's lane
//                     means, the centred k rows quantized over the pair's
//                     2*hd lanes (the TPU's one 128-lane row);
//   attn_core_q8_kernel (K10) one block per (sample, head): q quantized per
//                     head row in registers, s32 QK^T on mma.sync against
//                     the head's k codes in shared memory, then the clamped
//                     exp and the bf16 AV of the bf16 core.
// Every rounding step uses the _rn intrinsics (mul/add/sub of common.cuh):
// nvcc would otherwise contract a * b + c into one FMA, which rounds once
// where the TPU kernel rounds twice.
#include <type_traits>

#include "gemm.cuh"

extern "C" int dyt_attn_core(const void* qkv, void* out, int B, int N, int C,
                             int H, float scale, void* stream);

namespace dyt {

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// where(amax > 0, 127 / amax, 0), an IEEE division (no fast math)
__device__ __forceinline__ float inv127(float amax) {
  return amax > 0.f ? 127.f / amax : 0.f;
}
__device__ __forceinline__ float row_scale(float amax) {
  return mul(amax, F32C(1.0 / 127.0));
}
// round half to even, clip to +-127
__device__ __forceinline__ int q8(float v, float inv) {
  return static_cast<int>(fminf(fmaxf(rintf(mul(v, inv)), -127.f), 127.f));
}
__device__ __forceinline__ unsigned pack_s8x4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) |
         (static_cast<unsigned>(d & 0xff) << 24);
}
template <int V>   // V = 4 or 8 consecutive bf16 -> fp32
__device__ __forceinline__ void load_bf16s(const bf16* p, float* v) {
  if constexpr (V == 8) {
    load8(p, v);
  } else {
    static_assert(V == 4, "4 or 8 values");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
}
__device__ __forceinline__ void store_codes8(int8_t* p, const float* v,
                                             float inv) {
  uint2 u;
  u.x = pack_s8x4(q8(v[0], inv), q8(v[1], inv), q8(v[2], inv), q8(v[3], inv));
  u.y = pack_s8x4(q8(v[4], inv), q8(v[5], inv), q8(v[6], inv), q8(v[7], inv));
  *reinterpret_cast<uint2*>(p) = u;
}

// ---------------------------------------------------------------------------
// Row quantizers: one warp per row, each lane on 8-element chunks (C % 8 == 0).

constexpr int MAX_CHUNKS = 4;   // LN rows of up to 32 * 8 * 4 = 1024 columns

// K12's selection, read by ln_quant_kernel: row m = b * cap + k of the LN
// rows is token idx[m] of sample b.  With idx null, row m is x's row m.
template <typename TX>
struct RowGather {
  const int64_t* idx = nullptr;   // [B * cap] token of each row
  const uint8_t* keep = nullptr;  // [B * cap] 1 where the row's MLP output
                                  // is kept (score above the threshold)
  int cap = 0, tokens = 0;        // rows and tokens per sample
  int* dst = nullptr;             // out [B * cap]: the x row a kept row's
                                  // output goes to, -1 for a dropped one
  TX* gate = nullptr;             // out [B, tokens]: keep at each selected
                                  // token (the caller zeroes the rest)
};

template <typename TX>
__global__ void __launch_bounds__(256)
ln_quant_kernel(const TX* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ b, int8_t* __restrict__ q,
                float* __restrict__ rs, int M, int C, RowGather<TX> sel) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  size_t src = row;
  if (sel.idx != nullptr) {
    src = (size_t)(row / sel.cap) * sel.tokens + sel.idx[row];
    if (lane == 0) {
      const bool kept = sel.keep[row] != 0;
      sel.dst[row] = kept ? static_cast<int>(src) : -1;
      sel.gate[src] = from_f32<TX>(kept ? 1.f : 0.f);
    }
  }
  const TX* xr = x + src * C;
  const int nch = C / 8;
  float v[MAX_CHUNKS][8];
  // both means summed in float64, one rounding to fp32 after the division:
  // independent of the summation order, so the plain version
  // (mha_serving.py::layernorm_f32) gets the same bits
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (lane + 32 * i < nch) {
      load8(xr + c, v[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[i][e];
    }
  }
  const float mu = static_cast<float>(warp_sum_f64(s) / C);
  double var = 0.0;
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    if (lane + 32 * i < nch) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = sub(v[i][e], mu);
        var += mul(d, d);
      }
    }
  }
  const float r =
      rsqrtf(add(static_cast<float>(warp_sum_f64(var) / C), F32C(1e-6)));
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (lane + 32 * i < nch) {
      float gg[8], bb[8];
      load8(g + c, gg);
      load8(b + c, bb);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        // ((x - mu) * r) * gamma + beta, each op rounded
        v[i][e] = add(mul(mul(sub(v[i][e], mu), r), gg[e]), bb[e]);
        amax = fmaxf(amax, fabsf(v[i][e]));
      }
    }
  }
  amax = warp_max(amax);
  const float inv = inv127(amax);
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (lane + 32 * i < nch) store_codes8(q + (size_t)row * C + c, v[i], inv);
  }
  if (lane == 0) rs[row] = row_scale(amax);
}

// amax_in: the rows' amax when a GEMM epilogue has already taken it (one
// pass over x instead of two), else nullptr
template <typename TI>
__global__ void __launch_bounds__(256)
row_quant_kernel(const TI* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ rs, int M, int K,
                 const float* __restrict__ amax_in) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const TI* xr = x + (size_t)row * K;
  float amax = 0.f;
  if (amax_in != nullptr) {
    amax = amax_in[row];
  } else {
    for (int c = lane * 8; c < K; c += 256) {
      float v[8];
      load8(xr + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
    amax = warp_max(amax);
  }
  const float inv = inv127(amax);
  for (int c = lane * 8; c < K; c += 256) {
    float v[8];
    load8(xr + c, v);
    store_codes8(q + (size_t)row * K + c, v, inv);
  }
  if (lane == 0) rs[row] = row_scale(amax);
}

template <typename TI>
static cudaError_t launch_row_quant(const TI* x, int8_t* q, float* rs, int M,
                                    int K, const float* amax_in,
                                    cudaStream_t s) {
  row_quant_kernel<TI><<<(M + 7) / 8, 256, 0, s>>>(x, q, rs, M, K, amax_in);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The int8 GEMM: gemm.cuh's TMA + wgmma kernel on int8 operands (A [M, K]
// and W [N, K], K-contiguous; K % 16 == 0, N % 8 == 0, M ragged) with one
// of these epilogues.  The int32 sums are exact in any order, and each
// epilogue rounds at the points q8_epilogue gives, so the outputs are the
// bits the plain versions compute.

enum Q8Epilogue {
  Q8_OUT = 0,        // out = TO((acc * rs[m]) * cs[n] + bias[n])
  Q8_GELU_ERF = 1,   // out (fp32) = gelu_erf((acc * rs) * cs + bias), and
                     // the rows' amax |out| into row_amax when given
  Q8_GELU_TANH = 2,  // out (fp32) = gelu_tanh((acc * rs) * cs + bias), idem
  Q8_RESID = 3,      // xm = (resid + (acc * rs) * cs) + bias; out = TO(xm);
                     // out_f32 = xm when given
  Q8_STEM = 4,       // out = TO(acc * (rs[m] * cs[n]) + bias)  (q8_conv)
  Q8_SCATTER = 5,    // Q8_OUT's value into row row_map[m] of out, none
                     // where row_map[m] < 0  (K12's fc2)
  Q8_RAW = 6,        // out (int32) = acc  (K16)
};

template <int EPI>
__device__ __forceinline__ float q8_epilogue(int acc, float r, float c,
                                             float b, float resid) {
  const float a = __int2float_rn(acc);
  if constexpr (EPI == Q8_STEM) return add(mul(a, mul(r, c)), b);
  const float v = mul(mul(a, r), c);
  if constexpr (EPI == Q8_OUT || EPI == Q8_SCATTER) return add(v, b);
  if constexpr (EPI == Q8_GELU_ERF) return gelu_erf(add(v, b));
  if constexpr (EPI == Q8_GELU_TANH) return gelu_tanh(add(v, b));
  return add(add(resid, v), b);                  // Q8_RESID
}

// A 64-row consumer warpgroup's int32 accumulators of the 128 x BN tile at
// (m0, n0), dequantized and stored through gemm.cuh's staged stores.  The
// GELU forms also take each row's amax |out| over the tile's columns (the
// quad's lanes, then an atomic max across column tiles: bit order is value
// order for non-negative floats).
template <int EPI, typename TO>
struct EpiQ8 {
  const float* rs;
  const float* cs;
  const float* bias;
  TO* out;
  const TO* resid;
  float* out_f32;
  float* row_amax;
  const int* row_map;

  bool aligned() const {
    return (reinterpret_cast<uintptr_t>(out) |
            reinterpret_cast<uintptr_t>(out_f32)) % 16 == 0;
  }

  template <int NA>
  __device__ __forceinline__ void operator()(const int (&acc)[NA],
                                             unsigned char* stage, int m0,
                                             int n0, int M, int N) const {
    constexpr int BN = 2 * NA;
    constexpr bool GELU = EPI == Q8_GELU_ERF || EPI == Q8_GELU_TANH;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t2 = (lane & 3) * 2;
    const int row0 = gemm_warp_row0(m0);
    float r[2] = {0.f, 0.f}, rmax[2] = {0.f, 0.f};
    if constexpr (EPI != Q8_RAW) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row0 + g + 8 * h < M) r[h] = rs[row0 + g + 8 * h];
    }
#pragma unroll
    for (int c = 0; c < BN / GEMM_OUT_COLS; ++c) {
      const int col0 = n0 + c * GEMM_OUT_COLS;
      if constexpr (EPI == Q8_RAW) {
        int v[4][2][2];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[jj][e >> 1][e & 1] = acc[4 * (c * 4 + jj) + e];
        gemm_store_chunk<TO>(v, out, stage, row0, col0, M, N, lane);
      } else {
        float v[4][2][2];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = c * 4 + jj, col = n0 + j * 8 + t2;
          float2 cc = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
          if (col < N) {
            cc = load2(cs + col);
            b = load2(bias + col);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + g + 8 * h;
            float2 x = make_float2(0.f, 0.f);
            if constexpr (EPI == Q8_RESID)
              if (row < M && col < N) x = load2(resid + (size_t)row * N + col);
            const float v0 =
                q8_epilogue<EPI>(acc[4 * j + 2 * h], r[h], cc.x, b.x, x.x);
            const float v1 =
                q8_epilogue<EPI>(acc[4 * j + 2 * h + 1], r[h], cc.y, b.y, x.y);
            v[jj][h][0] = v0;
            v[jj][h][1] = v1;
            if constexpr (GELU)
              if (col < N)
                rmax[h] = fmaxf(rmax[h], fmaxf(fabsf(v0), fabsf(v1)));
          }
        }
        gemm_store_chunk<TO>(v, out, stage, row0, col0, M, N, lane,
                             EPI == Q8_SCATTER ? row_map : nullptr);
        if constexpr (EPI == Q8_RESID)
          if (out_f32 != nullptr)
            gemm_store_chunk<float>(v, out_f32, stage, row0, col0, M, N,
                                    lane);
      }
    }
    if constexpr (GELU) {
      if (row_amax != nullptr) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = rmax[h];
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          const int row = row0 + g + 8 * h;
          if ((lane & 3) == 0 && row < M)
            atomicMax(reinterpret_cast<unsigned*>(row_amax) + row,
                      __float_as_uint(m));
        }
      }
    }
  }
};

template <int EPI, typename TO>
static cudaError_t launch_gemm_s8(const int8_t* A, const int8_t* W,
                                  const float* rs, const float* cs,
                                  const float* bias, int M, int N, int K,
                                  TO* out, const TO* resid, float* out_f32,
                                  float* row_amax, cudaStream_t s,
                                  const int* row_map = nullptr) {
  return launch_gemm(A, W, M, N, K,
                     EpiQ8<EPI, TO>{rs, cs, bias, out, resid, out_f32,
                                    row_amax, row_map},
                     s);
}

// ---------------------------------------------------------------------------
// K10: attention core with an int8 QK^T on the raw [B, N, 3C] bf16 qkv
// buffer, writing [B, N, C] bf16.  Two kernels:
//   k_quant_kernel, one block per (sample, head pair p):
//     kc = k_pair - mean_n(k_pair)   per lane, over the pair's 2*hd lanes
//     kq, ks = row quant of kc over the 2*hd lanes (one scale per pair row)
//   attn_core_q8_kernel, one block per (sample, head h):
//     qq, qs = row quant of fp32 q * scale over the head's hd lanes
//     s = ((float)(qq . kq_h) * qs) * ks;  e = exp(clip(s, -60, 80) - 20)
//     o = (bf16(e) @ v in fp32) * (1 / sum(e)) -> bf16
// The k pass runs once per pair, fully parallel, instead of once per head
// inside the core's blocks (measured: a core that centred and quantized
// its own keys took 0.24-0.28 ms at ViT-B shapes, its k pass unhidden).

constexpr int ATTQ_WARPS = 8;

// kq [B, N, C] int8 (k's column layout), ks [B, N, H/2] fp32
template <int HD>
__global__ void __launch_bounds__(ATTQ_WARPS * 32)
k_quant_kernel(const bf16* __restrict__ qkv, int8_t* __restrict__ kq,
               float* __restrict__ ks, int N, int H) {
  constexpr int PL = 2 * HD;      // lanes of a head pair
  constexpr int VPL = PL / 32;    // pair lanes per thread
  __shared__ double part[ATTQ_WARPS][PL];
  __shared__ float mean[PL];
  const int C = H * HD, C3 = 3 * C, P = H / 2;
  const int b = blockIdx.x / P, p = blockIdx.x % P;
  const bf16* kpair = qkv + (size_t)b * N * C3 + C + p * PL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l0 = lane * VPL;

  // lane means over the N tokens, summed in float64 (one rounding after
  // the division: the plain version gets the same bits whatever its order)
  double acc[VPL];
#pragma unroll
  for (int e = 0; e < VPL; ++e) acc[e] = 0.0;
  for (int n = warp; n < N; n += ATTQ_WARPS) {
    float kv[VPL];
    load_bf16s<VPL>(kpair + (size_t)n * C3 + l0, kv);
#pragma unroll
    for (int e = 0; e < VPL; ++e) acc[e] += kv[e];
  }
#pragma unroll
  for (int e = 0; e < VPL; ++e) part[warp][l0 + e] = acc[e];
  __syncthreads();
  for (int l = threadIdx.x; l < PL; l += blockDim.x) {
    double sum = 0.0;
#pragma unroll
    for (int w = 0; w < ATTQ_WARPS; ++w) sum += part[w][l];
    mean[l] = static_cast<float>(sum / N);
  }
  __syncthreads();

  // centred rows: one warp per row, amax over the pair's lanes
  for (int n = warp; n < N; n += ATTQ_WARPS) {
    float kc[VPL];
    load_bf16s<VPL>(kpair + (size_t)n * C3 + l0, kc);
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < VPL; ++e) {
      kc[e] = sub(kc[e], mean[l0 + e]);
      amax = fmaxf(amax, fabsf(kc[e]));
    }
    amax = warp_max(amax);
    const float inv = inv127(amax);
    int8_t* row = kq + ((size_t)b * N + n) * C + p * PL + l0;
#pragma unroll
    for (int e = 0; e < VPL; e += 4)
      *reinterpret_cast<unsigned*>(row + e) =
          pack_s8x4(q8(kc[e], inv), q8(kc[e + 1], inv), q8(kc[e + 2], inv),
                    q8(kc[e + 3], inv));
    if (lane == 0) ks[((size_t)b * N + n) * P + p] = row_scale(amax);
  }
}

template <int HD>
struct AttnQ8Layout {
  static constexpr int LDQ = HD + 16;   // int8 k row stride, bytes
  static constexpr int LDV = HD + 8;    // bf16 v row stride, elements
  // v, then k codes, then k scales
  static int smem_bytes(int N) {
    const int np = (N + 15) / 16 * 16;
    return np * LDV * 2 + np * LDQ + np * 4;
  }
};

template <int HD>
__global__ void __launch_bounds__(ATTQ_WARPS * 32)
attn_core_q8_kernel(const bf16* __restrict__ qkv,
                    const int8_t* __restrict__ kq,
                    const float* __restrict__ kscale,
                    bf16* __restrict__ out, int N, int H, float scale) {
  using L = AttnQ8Layout<HD>;
  constexpr int LDQ = L::LDQ, LDV = L::LDV;
  constexpr int DK = HD / 32;     // k32 steps of QK^T
  constexpr int OT = HD / 8;      // n8 tiles of the output
  constexpr int CPV = HD / 8;     // 16-byte chunks per v row
  constexpr int CPK = HD / 16;    // 16-byte chunks per k code row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int np = (N + 15) / 16 * 16;
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw);
  int8_t* Kq = reinterpret_cast<int8_t*>(smem_raw + np * LDV * 2);
  float* ks = reinterpret_cast<float*>(smem_raw + np * LDV * 2 + np * LDQ);

  const int C = H * HD, C3 = 3 * C;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const bf16* base = qkv + (size_t)b * N * C3;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // v and the head's k codes and scales; padded rows zero (codes 0 and
  // scale 0: their keys are masked below anyway)
  for (int i = tid; i < np * CPV; i += blockDim.x) {
    const int r = i / CPV, c = (i % CPV) * 8;
    uint4 vv = make_uint4(0, 0, 0, 0);
    if (r < N)
      vv = *reinterpret_cast<const uint4*>(base + (size_t)r * C3 + 2 * C +
                                           h * HD + c);
    *reinterpret_cast<uint4*>(Vs + r * LDV + c) = vv;
  }
  for (int i = tid; i < np * CPK; i += blockDim.x) {
    const int r = i / CPK, c = (i % CPK) * 16;
    uint4 kk = make_uint4(0, 0, 0, 0);
    if (r < N)
      kk = *reinterpret_cast<const uint4*>(kq + ((size_t)b * N + r) * C +
                                           h * HD + c);
    *reinterpret_cast<uint4*>(Kq + r * LDQ + c) = kk;
  }
  for (int r = tid; r < np; r += blockDim.x)
    ks[r] = r < N ? kscale[((size_t)b * N + r) * (H / 2) + h / 2] : 0.f;
  __syncthreads();

  const int g = lane >> 2, t = lane & 3, t2 = t * 2;
  // ldmatrix row addresses: k codes as the col-major B of QK^T (bytes),
  // v transposed for PV, as in attn_core_kernel
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 16;
  const int v_row = lane & 15, v_col = (lane >> 4) * 8;
  const int nchunks = np / 16;

  for (int qc = warp; qc < nchunks; qc += ATTQ_WARPS) {
    const int n_lo = qc * 16 + g, n_hi = n_lo + 8;
    // q * scale in fp32 (not rounded), straight in the A-operand layout:
    // register e of k step d holds row (e & 1 ? hi : lo), bytes
    // d*32 + t*4 + (e >> 1)*16 .. +3
    float qv[DK][4][4];
    float am_lo = 0.f, am_hi = 0.f;
#pragma unroll
    for (int d = 0; d < DK; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = (e & 1) ? n_hi : n_lo;
        const int col = d * 32 + t * 4 + (e >> 1) * 16;
        float2 a = make_float2(0.f, 0.f), c = make_float2(0.f, 0.f);
        if (n < N) {
          const bf16* p = base + (size_t)n * C3 + h * HD + col;
          a = load2(p);
          c = load2(p + 2);
        }
        qv[d][e][0] = mul(a.x, scale); qv[d][e][1] = mul(a.y, scale);
        qv[d][e][2] = mul(c.x, scale); qv[d][e][3] = mul(c.y, scale);
        float m = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) m = fmaxf(m, fabsf(qv[d][e][i]));
        if (e & 1) am_hi = fmaxf(am_hi, m); else am_lo = fmaxf(am_lo, m);
      }
    }
    // each row is spread over the four lanes of its quad
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      am_lo = fmaxf(am_lo, __shfl_xor_sync(0xffffffffu, am_lo, m));
      am_hi = fmaxf(am_hi, __shfl_xor_sync(0xffffffffu, am_hi, m));
    }
    const float inv_lo = inv127(am_lo), inv_hi = inv127(am_hi);
    const float qs_lo = row_scale(am_lo), qs_hi = row_scale(am_hi);
    unsigned qf[DK][4];
#pragma unroll
    for (int d = 0; d < DK; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float inv = (e & 1) ? inv_hi : inv_lo;
        qf[d][e] = pack_s8x4(q8(qv[d][e][0], inv), q8(qv[d][e][1], inv),
                             q8(qv[d][e][2], inv), q8(qv[d][e][3], inv));
      }

    float o[OT][4];
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    float l_lo = 0.f, l_hi = 0.f;

    for (int kc = 0; kc < nchunks; ++kc) {
      int si[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        unsigned r[4];
        ldmatrix_x4(r, Kq + (kc * 16 + k_row) * LDQ + d * 32 + k_col);
        mma_s8_16832(si[0], qf[d], r[0], r[1]);
        mma_s8_16832(si[1], qf[d], r[2], r[3]);
      }
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kc * 16 + j * 8 + t2 + (e & 1);
          if (col < N) {
            const float sv = mul(mul(__int2float_rn(si[j][e]),
                                     e < 2 ? qs_lo : qs_hi), ks[col]);
            s[j][e] = expf(fminf(fmaxf(sv, -60.f), 80.f) - 20.f);
          } else {
            s[j][e] = 0.f;               // padded keys contribute nothing
          }
        }
        l_lo += s[j][0] + s[j][1];       // l sums the fp32 e
        l_hi += s[j][2] + s[j][3];
      }
      const unsigned pf[4] = {pack_bf16x2(s[0][0], s[0][1]),
                              pack_bf16x2(s[0][2], s[0][3]),
                              pack_bf16x2(s[1][0], s[1][1]),
                              pack_bf16x2(s[1][2], s[1][3])};
#pragma unroll
      for (int j = 0; j < OT; j += 2) {
        unsigned r[4];
        ldmatrix_x4_trans(r, Vs + (kc * 16 + v_row) * LDV + j * 8 + v_col);
        mma_bf16_16816(o[j], pf, r[0], r[1]);
        mma_bf16_16816(o[j + 1], pf, r[2], r[3]);
      }
    }

#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, m);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, m);
    }
    const float inv_l_lo = 1.0f / l_lo, inv_l_hi = 1.0f / l_hi;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int col = h * HD + j * 8 + t2;
      if (n_lo < N)
        store2(out + ((size_t)b * N + n_lo) * C + col, o[j][0] * inv_l_lo,
               o[j][1] * inv_l_lo);
      if (n_hi < N)
        store2(out + ((size_t)b * N + n_hi) * C + col, o[j][2] * inv_l_hi,
               o[j][3] * inv_l_hi);
    }
  }
}

template <int HD>
static cudaError_t launch_attn_core_q8(const bf16* qkv, int8_t* kq, float* ks,
                                       bf16* out, int B, int N, int H,
                                       float scale, cudaStream_t s) {
  k_quant_kernel<HD><<<B * (H / 2), ATTQ_WARPS * 32, 0, s>>>(qkv, kq, ks, N,
                                                             H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = AttnQ8Layout<HD>::smem_bytes(N);
  err = cudaFuncSetAttribute(attn_core_q8_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  attn_core_q8_kernel<HD><<<B * H, ATTQ_WARPS * 32, smem, s>>>(
      qkv, kq, ks, out, N, H, scale);
  return cudaGetLastError();
}

// kq [B*N, C] int8 and ks [B*N, H/2] fp32 scratch
static cudaError_t attn_core_q8(const bf16* qkv, int8_t* kq, float* ks,
                                bf16* out, int B, int N, int C, int H,
                                float scale, cudaStream_t s) {
  if (H % 2) return cudaErrorInvalidValue;
  if (C == 64 * H)
    return launch_attn_core_q8<64>(qkv, kq, ks, out, B, N, H, scale, s);
  if (C == 128 * H)
    return launch_attn_core_q8<128>(qkv, kq, ks, out, B, N, H, scale, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The chains

template <typename TX>
static cudaError_t sublayer_q8(const TX* x, const float* gamma,
                               const float* beta, const int8_t* wqkv,
                               const float* sqkv, const float* bqkv,
                               const int8_t* wproj, const float* sproj,
                               const float* bproj, TX* out, float* xm32,
                               int8_t* a8, float* rs, bf16* qkv_buf,
                               bf16* attn_buf, float* kscale, int B, int N,
                               int C, int H, float scale, int attn_q8,
                               cudaStream_t s) {
  const int M = B * N;
  if (C % 8 || C > 32 * 8 * MAX_CHUNKS) return cudaErrorInvalidValue;
  ln_quant_kernel<TX><<<(M + 7) / 8, 256, 0, s>>>(x, gamma, beta, a8, rs, M,
                                                  C, RowGather<TX>{});
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_gemm_s8<Q8_OUT, bf16>(a8, wqkv, rs, sqkv, bqkv, M, 3 * C, C,
                                     qkv_buf, nullptr, nullptr, nullptr, s);
  if (err != cudaSuccess) return err;
  // a8 is free again once the qkv GEMM has read it: K10 keeps its k codes
  // there
  err = attn_q8 ? attn_core_q8(qkv_buf, a8, kscale, attn_buf, B, N, C, H,
                               scale, s)
                : static_cast<cudaError_t>(
                      dyt_attn_core(qkv_buf, attn_buf, B, N, C, H, scale, s));
  if (err != cudaSuccess) return err;
  err = launch_row_quant<bf16>(attn_buf, a8, rs, M, C, nullptr, s);
  if (err != cudaSuccess) return err;
  return launch_gemm_s8<Q8_RESID, TX>(a8, wproj, rs, sproj, bproj, M, C, C,
                                      out, x, xm32, nullptr, s);
}

// K4 on M rows of x; with sel.idx (K12) on the M = B * cap selected rows,
// fc2 storing each kept row at its token of out (which the caller zeroed)
template <typename TX>
static cudaError_t ln_mlp_q8(const TX* x, const float* gamma,
                             const float* beta, const int8_t* w1,
                             const float* s1, const float* b1,
                             const int8_t* w2, const float* s2,
                             const float* b2, TX* out, int8_t* a8, float* rs,
                             float* h, float* hmax, int M, int C, int Hd,
                             int approx, cudaStream_t s,
                             RowGather<TX> sel = {}) {
  if (M == 0) return cudaSuccess;
  if (C % 8 || C > 32 * 8 * MAX_CHUNKS) return cudaErrorInvalidValue;
  ln_quant_kernel<TX><<<(M + 7) / 8, 256, 0, s>>>(x, gamma, beta, a8, rs, M,
                                                  C, sel);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // fc1's epilogue takes the GELU rows' amax, so their quantization reads
  // the fp32 rows once
  err = cudaMemsetAsync(hmax, 0, sizeof(float) * M, s);
  if (err != cudaSuccess) return err;
  err = approx ? launch_gemm_s8<Q8_GELU_TANH, float>(a8, w1, rs, s1, b1, M,
                                                     Hd, C, h, nullptr,
                                                     nullptr, hmax, s)
               : launch_gemm_s8<Q8_GELU_ERF, float>(a8, w1, rs, s1, b1, M, Hd,
                                                    C, h, nullptr, nullptr,
                                                    hmax, s);
  if (err != cudaSuccess) return err;
  err = launch_row_quant<float>(h, a8, rs, M, Hd, hmax, s);
  if (err != cudaSuccess) return err;
  if (sel.idx != nullptr)
    return launch_gemm_s8<Q8_SCATTER, TX>(a8, w2, rs, s2, b2, M, C, Hd, out,
                                          nullptr, nullptr, nullptr, s,
                                          sel.dst);
  return launch_gemm_s8<Q8_OUT, TX>(a8, w2, rs, s2, b2, M, C, Hd, out,
                                    nullptr, nullptr, nullptr, s);
}

// K12: zero out and gate, then K4's chain on the selected rows
template <typename TX>
static cudaError_t dispatch_mlp_q8(const TX* x, const int64_t* idx,
                                   const uint8_t* keep, const float* gamma,
                                   const float* beta, const int8_t* w1,
                                   const float* s1, const float* b1,
                                   const int8_t* w2, const float* s2,
                                   const float* b2, TX* out, TX* gate,
                                   int8_t* a8, float* rs, float* h,
                                   float* hmax, int* row_map, int B, int N,
                                   int cap, int C, int Hd, int approx,
                                   cudaStream_t s) {
  cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(TX) * (size_t)B * N * C, s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(gate, 0, sizeof(TX) * (size_t)B * N, s);
  if (err != cudaSuccess) return err;
  return ln_mlp_q8<TX>(x, gamma, beta, w1, s1, b1, w2, s2, b2, out, a8, rs, h,
                       hmax, B * cap, C, Hd, approx, s,
                       RowGather<TX>{idx, keep, cap, N, row_map, gate});
}

// One EpiQ8 form on its own, chosen at run time (dyt_gemm_s8)
template <typename TO>
static cudaError_t gemm_s8_form(int epi, const int8_t* a, const int8_t* w,
                                const float* rs, const float* cs,
                                const float* bias, int M, int N, int K,
                                TO* out, const TO* resid, float* out_f32,
                                float* row_amax, const int* row_map,
                                cudaStream_t s) {
  switch (epi) {
    case Q8_OUT:
      return launch_gemm_s8<Q8_OUT, TO>(a, w, rs, cs, bias, M, N, K, out,
                                        nullptr, nullptr, nullptr, s);
    case Q8_RESID:
      return launch_gemm_s8<Q8_RESID, TO>(a, w, rs, cs, bias, M, N, K, out,
                                          resid, out_f32, nullptr, s);
    case Q8_SCATTER:
      return launch_gemm_s8<Q8_SCATTER, TO>(a, w, rs, cs, bias, M, N, K, out,
                                            nullptr, nullptr, nullptr, s,
                                            row_map);
    default:
      break;
  }
  if constexpr (std::is_same<TO, bf16>::value) {
    if (epi == Q8_STEM)
      return launch_gemm_s8<Q8_STEM, TO>(a, w, rs, cs, bias, M, N, K, out,
                                         nullptr, nullptr, nullptr, s);
  }
  if constexpr (std::is_same<TO, float>::value) {
    if (epi == Q8_GELU_ERF)
      return launch_gemm_s8<Q8_GELU_ERF, TO>(a, w, rs, cs, bias, M, N, K,
                                             out, nullptr, nullptr, row_amax,
                                             s);
    if (epi == Q8_GELU_TANH)
      return launch_gemm_s8<Q8_GELU_TANH, TO>(a, w, rs, cs, bias, M, N, K,
                                              out, nullptr, nullptr,
                                              row_amax, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace dyt

extern "C" {

// Shared-memory bytes of the int8 attention core at (N, hd); 0 when hd is
// not supported.
int dyt_attn_core_q8_smem_bytes(int N, int hd) {
  if (hd == 64) return dyt::AttnQ8Layout<64>::smem_bytes(N);
  if (hd == 128) return dyt::AttnQ8Layout<128>::smem_bytes(N);
  return 0;
}

// K10 alone: qkv [B, N, 3C] bf16 -> out [B, N, C] bf16 (H even); kq
// [B*N, C] int8 and ks [B*N, H/2] fp32 scratch.
int dyt_attn_core_q8(const void* qkv, void* out, void* kq, float* ks, int B,
                     int N, int C, int H, float scale, void* stream) {
  return dyt::attn_core_q8(static_cast<const dyt::bf16*>(qkv),
                           static_cast<int8_t*>(kq), ks,
                           static_cast<dyt::bf16*>(out), B, N, C, H, scale,
                           static_cast<cudaStream_t>(stream));
}

// K5's chain; with xm32 also K6's first part.  x, out: [B, N, C] in the
// residual dtype (x_f32 selects fp32 over bf16); gamma/beta/biases/scales
// fp32; wqkv [3C, C], wproj [C, C] int8; xm32 an optional fp32 copy of out;
// a8 [B*N, C] int8, rs [B*N] fp32, qkv_buf [B*N, 3C] and attn_buf [B*N, C]
// bf16 scratch; attn_q8 selects the K10 core, with kscale [B*N, H/2] fp32
// scratch.  Returns a cudaError_t value.
int dyt_attention_sublayer_q8(const void* x, int x_f32, const float* gamma,
                              const float* beta, const void* wqkv,
                              const float* sqkv, const float* bqkv,
                              const void* wproj, const float* sproj,
                              const float* bproj, void* out, float* xm32,
                              void* a8, float* rs, void* qkv_buf,
                              void* attn_buf, float* kscale, int B, int N,
                              int C, int H, float scale, int attn_q8,
                              void* stream) {
  using dyt::bf16;
  auto* wq = static_cast<const int8_t*>(wqkv);
  auto* wp = static_cast<const int8_t*>(wproj);
  auto* a = static_cast<int8_t*>(a8);
  auto* qb = static_cast<bf16*>(qkv_buf);
  auto* ab = static_cast<bf16*>(attn_buf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return dyt::sublayer_q8<float>(
        static_cast<const float*>(x), gamma, beta, wq, sqkv, bqkv, wp, sproj,
        bproj, static_cast<float*>(out), xm32, a, rs, qb, ab, kscale, B, N, C,
        H, scale, attn_q8, s);
  return dyt::sublayer_q8<bf16>(
      static_cast<const bf16*>(x), gamma, beta, wq, sqkv, bqkv, wp, sproj,
      bproj, static_cast<bf16*>(out), xm32, a, rs, qb, ab, kscale, B, N, C, H,
      scale, attn_q8, s);
}

// K4: x, out [M, C] (x_f32 selects fp32 over bf16); w1 [Hd, C], w2 [C, Hd]
// int8 with fp32 scales and biases; a8 [M, max(C, Hd)] int8, rs and hmax
// [M] fp32, h [M, Hd] fp32 scratch; approx selects the tanh GELU.
int dyt_q8_ln_mlp(const void* x, int x_f32, const float* gamma,
                  const float* beta, const void* w1, const float* s1,
                  const float* b1, const void* w2, const float* s2,
                  const float* b2, void* out, void* a8, float* rs, float* h,
                  float* hmax, int M, int C, int Hd, int approx,
                  void* stream) {
  auto* q1 = static_cast<const int8_t*>(w1);
  auto* q2 = static_cast<const int8_t*>(w2);
  auto* a = static_cast<int8_t*>(a8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return dyt::ln_mlp_q8<float>(static_cast<const float*>(x), gamma, beta,
                                 q1, s1, b1, q2, s2, b2,
                                 static_cast<float*>(out), a, rs, h, hmax, M, C,
                                 Hd, approx, s);
  return dyt::ln_mlp_q8<dyt::bf16>(
      static_cast<const dyt::bf16*>(x), gamma, beta, q1, s1, b1, q2, s2, b2,
      static_cast<dyt::bf16*>(out), a, rs, h, hmax, M, C, Hd, approx, s);
}

// The int8 stem: a [M, K] int8 patch rows with per-row (per-image) scales
// rs, w [N, K] int8 with scales cs, bias [N] -> out [M, N] bf16 =
// acc * (rs * cs) + bias.
int dyt_q8_stem_gemm(const void* a, const void* w, const float* rs,
                     const float* cs, const float* bias, int M, int N, int K,
                     void* out, void* stream) {
  return dyt::launch_gemm_s8<dyt::Q8_STEM, dyt::bf16>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w), rs, cs,
      bias, M, N, K, static_cast<dyt::bf16*>(out), nullptr, nullptr, nullptr,
      static_cast<cudaStream_t>(stream));
}

// K12: x [B, N, C] (x_f32 selects fp32 over bf16); idx [B, cap] int64 and
// keep [B, cap] uint8, the top-cap selection per sample; weights as for
// dyt_q8_ln_mlp; out [B, N, C] and gate [B, N] in x's dtype; a8 [B*cap,
// max(C, Hd)] int8, rs and hmax [B*cap] fp32, h [B*cap, Hd] fp32 and
// row_map [B*cap] int32 scratch.
int dyt_q8_dispatch_mlp(const void* x, int x_f32, const void* idx,
                        const void* keep, const float* gamma,
                        const float* beta, const void* w1, const float* s1,
                        const float* b1, const void* w2, const float* s2,
                        const float* b2, void* out, void* gate, void* a8,
                        float* rs, float* h, float* hmax, void* row_map,
                        int B, int N, int cap, int C, int Hd, int approx,
                        void* stream) {
  auto* ix = static_cast<const int64_t*>(idx);
  auto* kp = static_cast<const uint8_t*>(keep);
  auto* q1 = static_cast<const int8_t*>(w1);
  auto* q2 = static_cast<const int8_t*>(w2);
  auto* a = static_cast<int8_t*>(a8);
  auto* rm = static_cast<int*>(row_map);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return dyt::dispatch_mlp_q8<float>(
        static_cast<const float*>(x), ix, kp, gamma, beta, q1, s1, b1, q2, s2,
        b2, static_cast<float*>(out), static_cast<float*>(gate), a, rs, h,
        hmax, rm, B, N, cap, C, Hd, approx, s);
  return dyt::dispatch_mlp_q8<dyt::bf16>(
      static_cast<const dyt::bf16*>(x), ix, kp, gamma, beta, q1, s1, b1, q2,
      s2, b2, static_cast<dyt::bf16*>(out), static_cast<dyt::bf16*>(gate), a,
      rs, h, hmax, rm, B, N, cap, C, Hd, approx, s);
}

// The int8 GEMM with any one Q8Epilogue form ``epi`` (its value), for the
// tests: a [M, K] and w [N, K] int8 (K % 16 == 0, N % 8 == 0); rs [M], cs [N], bias [N] fp32; out [M, N] of ``out_type`` (0 bf16,
// 1 fp32, 2 int32), or for Q8_SCATTER [rows, N] with row m at row_map[m]
// (int32 [M], none where < 0); resid [M, N] as out (Q8_RESID) and out_f32
// [M, N] fp32 or null (Q8_RESID); row_amax [M] fp32, zeroed by the caller,
// or null (the GELU forms).  Q8_RAW takes int32 out only, the GELU forms
// fp32, Q8_STEM bf16.  Returns a cudaError_t value.
int dyt_gemm_s8(int epi, int out_type, const void* a, const void* w,
                const float* rs, const float* cs, const float* bias, int M,
                int N, int K, void* out, const void* resid, float* out_f32,
                float* row_amax, const void* row_map, void* stream) {
  auto* qa = static_cast<const int8_t*>(a);
  auto* qw = static_cast<const int8_t*>(w);
  auto* rm = static_cast<const int*>(row_map);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_type == 0)
    return dyt::gemm_s8_form<dyt::bf16>(
        epi, qa, qw, rs, cs, bias, M, N, K, static_cast<dyt::bf16*>(out),
        static_cast<const dyt::bf16*>(resid), out_f32, row_amax, rm, s);
  if (out_type == 1)
    return dyt::gemm_s8_form<float>(
        epi, qa, qw, rs, cs, bias, M, N, K, static_cast<float*>(out),
        static_cast<const float*>(resid), out_f32, row_amax, rm, s);
  if (out_type == 2 && epi == dyt::Q8_RAW)
    return dyt::launch_gemm_s8<dyt::Q8_RAW, int>(
        qa, qw, nullptr, nullptr, nullptr, M, N, K, static_cast<int*>(out),
        nullptr, nullptr, nullptr, s);
  return cudaErrorInvalidValue;
}

// K16, int8: out [M, N] int32 = a [M, K] int8 . w [N, K]^T int8, the exact
// int32 sums (K % 16 == 0, N % 8 == 0).
int dyt_gemm_s8_s32(const void* a, const void* w, int M, int N, int K,
                    void* out, void* stream) {
  return dyt::launch_gemm_s8<dyt::Q8_RAW, int>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w), nullptr,
      nullptr, nullptr, M, N, K, static_cast<int*>(out), nullptr, nullptr,
      nullptr, static_cast<cudaStream_t>(stream));
}

// K16, bf16: out [M, N] fp32 = a [M, K] bf16 . w [N, K]^T bf16, fp32 sums
// (K % 8 == 0, N % 8 == 0, a and w on 16 bytes).
int dyt_gemm_bf16_f32(const void* a, const void* w, int M, int N, int K,
                      float* out, void* stream) {
  return dyt::launch_gemm_nt<dyt::EPI_F32, float>(
      static_cast<const dyt::bf16*>(a), static_cast<const dyt::bf16*>(w),
      nullptr, M, N, K, nullptr, nullptr, nullptr, out,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
