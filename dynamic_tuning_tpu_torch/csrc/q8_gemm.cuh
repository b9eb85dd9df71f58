// The int8 GEMM's epilogues (gemm.cuh's TMA + wgmma kernel on int8
// operands): the dequantizing forms of the int8 chains (quant.cu) and of the
// int8 stem (q8_stem.cu), shared so that the stem builds in a translation
// unit of its own, in parallel with quant.cu.
#pragma once

#include "gemm.cuh"

namespace dyt {

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

}  // namespace dyt
