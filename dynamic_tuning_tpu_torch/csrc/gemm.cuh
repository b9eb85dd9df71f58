// The bf16 NT GEMM of the serving kernels, on TMA and wgmma:
//     out[m, n] = epilogue(sum_k A[m, k] * W[n, k])
// both operands K-contiguous bf16 ("NT", W in torch's [out, in] layout),
// fp32 accumulation, and an epilogue that applies the caller's bias / GELU /
// gate / residual arithmetic in fp32 before the one rounding to the output
// type.  The attention sublayer chain (attention_sublayer.cu: qkv and proj,
// inside K2, K3 and K7) and the fused LN+MLP chain (fused_mlp.cu, K11: fc1
// and fc2) run it twice each; quant.cu's dyt_gemm_bf16_f32 (K16's bf16
// probe) runs its raw-store epilogue.  Requires K % 8 == 0 and N % 8 == 0
// (16-byte rows for TMA and for the stores) and A, W and the outputs on 16
// bytes; M may be ragged.
//
// What bounds it on an H100.  At the serving shapes (M = 25216 or 12672
// rows, K = 768 or 3072, N = 768 to 3072) the products are operation
// bound: qkv is 89 GFLOP (0.090 ms at the 989 TFLOP/s bf16 peak) against
// ~0.04 ms of bytes.  The tensor cores reach that rate only through wgmma,
// fed from shared memory faster than ldmatrix + mma.sync can (the
// Ampere-style form this replaces stopped at ~220 TFLOP/s).  At K = 768 a
// tile is only 12 k-steps, so the epilogue's stores weigh as much as the
// loads.
//
// What the design does about it.  A persistent grid, one 384-thread block
// an SM, walks 128 x BN output tiles (BN = 256 or 128, n fastest so the
// blocks in flight share their A rows in L2):
//   * one producer thread (warpgroup 2, its registers given up with
//     setmaxnreg) keeps a ring of STAGES 64-deep k tiles of A and W in
//     flight with TMA, into 128-byte swizzled shared memory; the full and
//     empty mbarriers of each stage pace it;
//   * two consumer warpgroups each own 64 rows of the tile: per k tile four
//     wgmma m64nBNk16 products read A and W straight from the swizzled
//     stage (no transposes: W is already [N, K]), one group kept in flight
//     while the previous stage is released;
//   * the epilogue runs from the accumulators (mma.sync's m16n8 order per
//     warp) while the producer already loads the next tile's first stages;
//     each warp passes its values through 16 x 32 staging rows in shared
//     memory and stores whole 16-byte pieces of rows (written straight
//     from the m16n8 pairs, a bf16 tile half-fills every sector a store
//     touches, and the qkv product's stores took ~3x its bytes' time).
// TMA zero-fills rows past M or N and the K tail past a multiple of 64, so
// the main loop has no guard.  The host encodes two tensor maps a call
// (cuTensorMapEncodeTiled, looked up in libcuda at run time through the
// runtime's entry-point query: the library does not link libcuda).
#pragma once

#include "wgmma.cuh"

namespace dyt {

enum GemmEpilogue {
  EPI_BIAS_BF16 = 0,   // out_bf16 = bf16(acc + bias[n])
  EPI_RESIDUAL = 1,    // xm = (resid + acc) + bias[n]; out_x = TX(xm);
                       // out_f32 = xm when given
  EPI_GELU_ERF = 2,    // out_bf16 = bf16(gelu_erf(acc + bias[n]))
  EPI_GELU_TANH = 3,   // out_bf16 = bf16(gelu_tanh(acc + bias[n]))
  EPI_GATE = 4,        // out_x = TX((acc + bias[n]) * gate[m]), or
                       // TX(acc + bias[n]) when gate is null
  EPI_F32 = 5,         // out_f32 = acc, no bias (the matmul probe, K16)
};

constexpr int GEMM_THREADS = 384;   // two consumer warpgroups + a producer
constexpr int GEMM_CONSUMER_WARPS = 8;
// the epilogue stages 16 rows x 32 columns a consumer warp at a time, rows
// padded by 16 bytes (fp32: 144 bytes, so 2304 a warp)
constexpr int GEMM_OUT_COLS = 32;
constexpr int GEMM_OUT_STAGE = 16 * (GEMM_OUT_COLS * 4 + 16);

template <int BN_>
struct GemmTile {
  static constexpr int BM = 128, BN = BN_, BK = 64;
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr int A_BYTES = BM * BK * 2;    // 16 KB
  static constexpr int B_BYTES = BN * BK * 2;    // 32 or 16 KB
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // the ring on 1024 bytes, the epilogue's staging, then a full and an
  // empty barrier a stage
  static constexpr int OUT = STAGES * STAGE;
  static constexpr int BARS = OUT + GEMM_CONSUMER_WARPS * GEMM_OUT_STAGE;
  static constexpr int SMEM = 1024 + BARS + 2 * STAGES * 8;
};
// N from which 128 x 256 tiles are used, below it 128 x 128: chosen per N
// by timing both widths at the serving shapes (utils/core_ablation.py's
// "GEMM 128x128 only" and "GEMM 128x256 only" variants)
constexpr int GEMM_WIDE_N = 2048;

// One warp's 16 x 32 chunk of output values (v[jj][h][p]: column 8 jj +
// t2 + p, row g + 8 h of the chunk) to out[row0.., col0..] as TO: through
// the warp's staging rows in shared memory, then 16-byte stores, each row
// of the chunk written whole (the m16n8 pairs alone would write half
// sectors).  Rows past M and columns past N are not stored.
template <typename TO>
__device__ __forceinline__ void gemm_store_chunk(const float (&v)[4][2][2],
                                                 TO* __restrict__ out,
                                                 unsigned char* stage,
                                                 int row0, int col0, int M,
                                                 int N, int lane) {
  constexpr int LDS = GEMM_OUT_COLS * sizeof(TO) + 16;    // bytes a row
  constexpr int CH = 16 / sizeof(TO);                     // elements / 16 B
  constexpr int PER_ROW = GEMM_OUT_COLS / CH;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store2(reinterpret_cast<TO*>(stage + (g + 8 * h) * LDS) + jj * 8 + t2,
             v[jj][h][0], v[jj][h][1]);
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * PER_ROW; i += 32) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * CH;
    if (row0 + r < M && col0 + c < N)
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * N + col0 + c) =
          *reinterpret_cast<const uint4*>(stage + r * LDS + c * sizeof(TO));
  }
  __syncwarp();
}

template <int BN, int EPI, typename TX>
__device__ __forceinline__ void gemm_epilogue(
    const float (&acc)[BN / 2], unsigned char* stage, int m0, int n0, int M,
    int N, const float* __restrict__ bias, bf16* __restrict__ out_bf16,
    const TX* __restrict__ resid, TX* __restrict__ out_x,
    float* __restrict__ out_f32, const float* __restrict__ gate) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  // this warp's 16 rows: warpgroup 64-row half, then the warp's 16
  const int row0 = m0 + (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3)
                   * 16;
  float gm[2] = {1.f, 1.f};
  if constexpr (EPI == EPI_GATE) {
    if (gate != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row0 + g + 8 * h < M) gm[h] = gate[row0 + g + 8 * h];
    }
  }
#pragma unroll
  for (int c = 0; c < BN / GEMM_OUT_COLS; ++c) {
    float v[4][2][2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = c * 4 + jj, col = n0 + j * 8 + t2;
      float2 b = make_float2(0.f, 0.f);
      if constexpr (EPI != EPI_F32)
        if (col < N) b = load2(bias + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + g + 8 * h;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if constexpr (EPI == EPI_BIAS_BF16) {
          v0 = v0 + b.x;
          v1 = v1 + b.y;
        } else if constexpr (EPI == EPI_GELU_ERF) {
          v0 = gelu_erf(add(v0, b.x));
          v1 = gelu_erf(add(v1, b.y));
        } else if constexpr (EPI == EPI_GELU_TANH) {
          v0 = gelu_tanh(add(v0, b.x));
          v1 = gelu_tanh(add(v1, b.y));
        } else if constexpr (EPI == EPI_GATE) {
          v0 = add(v0, b.x);
          v1 = add(v1, b.y);
          if (gate != nullptr) {
            v0 = mul(v0, gm[h]);
            v1 = mul(v1, gm[h]);
          }
        } else if constexpr (EPI == EPI_RESIDUAL) {
          float2 x = make_float2(0.f, 0.f);
          if (row < M && col < N) x = load2(resid + (size_t)row * N + col);
          v0 = (x.x + v0) + b.x;
          v1 = (x.y + v1) + b.y;
        }
        v[jj][h][0] = v0;
        v[jj][h][1] = v1;
      }
    }
    const int col0 = n0 + c * GEMM_OUT_COLS;
    if constexpr (EPI == EPI_F32) {
      gemm_store_chunk<float>(v, out_f32, stage, row0, col0, M, N, lane);
    } else if constexpr (EPI == EPI_GATE || EPI == EPI_RESIDUAL) {
      gemm_store_chunk<TX>(v, out_x, stage, row0, col0, M, N, lane);
      if constexpr (EPI == EPI_RESIDUAL)
        if (out_f32 != nullptr)
          gemm_store_chunk<float>(v, out_f32, stage, row0, col0, M, N, lane);
    } else {
      gemm_store_chunk<bf16>(v, out_bf16, stage, row0, col0, M, N, lane);
    }
  }
}

template <int BN, int EPI, typename TX>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_nt_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_w,
               const float* __restrict__ bias, int M, int N, int K,
               bf16* __restrict__ out_bf16, const TX* __restrict__ resid,
               TX* __restrict__ out_x, float* __restrict__ out_f32,
               const float* __restrict__ gate) {
  using T = GemmTile<BN>;
  extern __shared__ unsigned char gsmem_raw[];
  unsigned char* ring = align1024(gsmem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::BARS);
  uint64_t* empty = full + T::STAGES;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_n * ((M + T::BM - 1) / T::BM);
  const int nk = (K + T::BK - 1) / T::BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);                      // the producer's arrive
      mbar_init(&empty[s], GEMM_CONSUMER_WARPS);   // lane 0 of each warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int stage = 0, phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * T::BM, n0 = t % tiles_n * BN;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * T::STAGE;
          mbar_expect_tx(&full[stage], T::STAGE);
          tma_load_2d(st, &map_a, &full[stage], kt * T::BK, m0);
          tma_load_2d(st + T::A_BYTES, &map_w, &full[stage], kt * T::BK, n0);
          if (++stage == T::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups 0 and 1: rows 64 * wg .. + 63 of each tile
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int stage = 0, phase = 0, prev = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * T::BM, n0 = t % tiles_n * BN;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[stage], phase);
        const unsigned char* st = ring + stage * T::STAGE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T::BK / 16; ++kk)
          wgmma_ss<BN>(acc, desc_sw128(st + wg * 64 * 128 + kk * 32),
                       desc_sw128(st + T::A_BYTES + kk * 32),
                       kt > 0 || kk > 0);
        wgmma_commit();
        // the previous k tile's products are done: release its stage
        wgmma_wait<1>();
        if (kt > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[prev]);
      gemm_epilogue<BN, EPI, TX>(
          acc, ring + T::OUT + (threadIdx.x >> 5) * GEMM_OUT_STAGE, m0, n0, M,
          N, bias, out_bf16, resid, out_x, out_f32, gate);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: the tensor maps and the launch

typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda (null if it has none)
inline TensorMapEncodeTiled tensor_map_encoder() {
  static const TensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a [rows, K] row-major bf16 matrix read in boxes of 64 (k) x box_rows,
// 128-byte swizzled, zeros past its edges
inline cudaError_t tensor_map_bf16(CUtensorMap* map, const bf16* p, int rows,
                                   int K, int box_rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(p), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the GEMM with 128 x BN tiles
template <int BN, int EPI, typename TX>
cudaError_t launch_gemm_tiles(const bf16* A, const bf16* W, const float* bias,
                              int M, int N, int K, bf16* out_bf16,
                              const TX* resid, TX* out_x, float* out_f32,
                              cudaStream_t s, const float* gate) {
  using T = GemmTile<BN>;
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8 ||
      (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(W) |
       reinterpret_cast<uintptr_t>(out_bf16) |
       reinterpret_cast<uintptr_t>(out_x) |
       reinterpret_cast<uintptr_t>(out_f32)) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_w;
  cudaError_t err = tensor_map_bf16(&map_a, A, M, K, T::BM);
  if (err != cudaSuccess) return err;
  err = tensor_map_bf16(&map_w, W, N, K, BN);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gemm_nt_kernel<BN, EPI, TX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = ((N + BN - 1) / BN) * ((M + T::BM - 1) / T::BM);
  const int grid = tiles < sms ? tiles : sms;
  gemm_nt_kernel<BN, EPI, TX><<<grid, GEMM_THREADS, T::SMEM, s>>>(
      map_a, map_w, bias, M, N, K, out_bf16, resid, out_x, out_f32, gate);
  return cudaGetLastError();
}

template <int EPI, typename TX>
cudaError_t launch_gemm_nt(const bf16* A, const bf16* W, const float* bias,
                           int M, int N, int K, bf16* out_bf16,
                           const TX* resid, TX* out_x, float* out_f32,
                           cudaStream_t s, const float* gate = nullptr) {
  if (N >= GEMM_WIDE_N)
    return launch_gemm_tiles<256, EPI, TX>(A, W, bias, M, N, K, out_bf16,
                                           resid, out_x, out_f32, s, gate);
  return launch_gemm_tiles<128, EPI, TX>(A, W, bias, M, N, K, out_bf16,
                                         resid, out_x, out_f32, s, gate);
}

}  // namespace dyt
