// The NT GEMM of the serving kernels, on TMA and wgmma:
//     out[m, n] = epilogue(sum_k A[m, k] * W[n, k])
// both operands K-contiguous ("NT", W in torch's [out, in] layout), one
// kernel for two operand types:
//   * bf16 x bf16 with fp32 accumulation (EpiBf16): the attention sublayer
//     chain (attention_sublayer.cu: qkv and proj, inside K2, K3 and K7) and
//     the fused LN+MLP chain (fused_mlp.cu, K11: fc1 and fc2) run it twice
//     each; quant.cu's dyt_gemm_bf16_f32 (K16's bf16 probe) its raw store;
//   * int8 x int8 with int32 accumulation (quant.cu's EpiQ8, the
//     dequantizing epilogues): qkv and proj of K5, K6 and K8, fc1 (GELU and
//     the rows' amax) and fc2 of K4, K12's scattered fc2, the int8 patch
//     stem and K16's int8 probe (int32 stored as it is).
// Requires K * sizeof(T) % 16 == 0 (TMA's row stride: K % 8 for bf16,
// K % 16 for int8), N % 8 == 0 (the 16-byte stores) and A, W and the outputs
// on 16 bytes; M may be ragged.
//
// What bounds it on an H100.  At the serving shapes (M = 25216 or 12672
// rows, K = 768 or 3072, N = 768 to 3072) the products are operation bound:
// bf16 qkv is 89 GFLOP (0.090 ms at the 989 TFLOP/s peak) against ~0.04 ms
// of bytes; int8 runs at twice that rate (1979 TOPS), so there the fp32 or
// int32 outputs weigh as much (K16's int8 probe at (12672, 768, 3072) is
// bound by its 156 MB of int32 output, 0.050 ms, against 0.030 of
// operations).  The tensor cores reach their rate only through wgmma, fed
// from shared memory faster than ldmatrix + mma.sync can (the Ampere-style
// forms this replaces stopped at ~220 TFLOP/s bf16 and 300-420 TOPS int8).
// At K = 768 a tile is only 12 (bf16) or 6 (int8) k tiles, so the
// epilogue's stores weigh as much as the loads.
//
// What the design does about it.  A persistent grid, one 384-thread block
// an SM, walks 128 x BN output tiles (BN = 256 or 128, by N; n fastest so
// the blocks in flight share their A rows in L2):
//   * one producer thread (warpgroup 2, its registers given up with
//     setmaxnreg) keeps a ring of STAGES k tiles of A and W in flight with
//     TMA, into 128-byte swizzled shared memory; a k tile is one 128-byte
//     row deep (64 bf16 or 128 int8 values), so both types move the same
//     bytes a stage; the full and empty mbarriers of each stage pace it;
//   * two consumer warpgroups each own 64 rows of the tile: per k tile four
//     wgmma products (m64nBNk16 bf16 or m64nBNk32 s8, 32 bytes of k each)
//     read A and W straight from the swizzled stage (no transposes: W is
//     already [N, K], and 8-bit wgmma takes K-major operands only), one
//     group kept in flight while the previous stage is released;
//   * the epilogue runs from the accumulators (mma.sync's m16n8 order per
//     warp, fp32 or int32 alike) while the producer already loads the next
//     tile's first stages; each warp passes its values through 16 x 32
//     staging rows in shared memory and stores whole 16-byte pieces of rows
//     (written straight from the m16n8 pairs, a bf16 tile half-fills every
//     sector a store touches, and the qkv product's stores took ~3x its
//     bytes' time).  A row map sends each row elsewhere or nowhere (K12).
// TMA zero-fills rows past M or N and the K tail past a multiple of the k
// tile, so the main loop has no guard (and int8 sums stay exact).  The host
// encodes two tensor maps a call (cuTensorMapEncodeTiled, looked up in
// libcuda at run time through the runtime's entry-point query: the library
// does not link libcuda).
#pragma once

#include "wgmma.cuh"

namespace dyt {

constexpr int GEMM_THREADS = 384;   // two consumer warpgroups + a producer
constexpr int GEMM_CONSUMER_WARPS = 8;
// the epilogue stages 16 rows x 32 columns a consumer warp at a time, rows
// padded by 16 bytes (fp32 / int32: 144 bytes, so 2304 a warp)
constexpr int GEMM_OUT_COLS = 32;
constexpr int GEMM_OUT_STAGE = 16 * (GEMM_OUT_COLS * 4 + 16);

// The operand type: its accumulator, k tile (one 128-byte swizzle row),
// TMA element type, wgmma, and the N from which 128 x 256 tiles are used
// (below it 128 x 128), chosen per type by timing both widths at the
// serving shapes (utils/core_ablation.py's tile-width variants).
template <typename T> struct GemmOperand;
template <> struct GemmOperand<bf16> {
  using Acc = float;
  static constexpr int BK = 64;
  static constexpr CUtensorMapDataType TMA_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int WIDE_N = 2048;
  template <int BN>
  static __device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da,
                                             uint64_t db, int acc) {
    wgmma_ss<BN>(d, da, db, acc);
  }
};
template <> struct GemmOperand<int8_t> {
  using Acc = int;
  static constexpr int BK = 128;
  static constexpr CUtensorMapDataType TMA_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr int WIDE_N = 2048;
  template <int BN>
  static __device__ __forceinline__ void mma(int (&d)[BN / 2], uint64_t da,
                                             uint64_t db, int acc) {
    wgmma_ss_s8<BN>(d, da, db, acc);
  }
};

template <int BN_>
struct GemmTile {
  static constexpr int BM = 128, BN = BN_;
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr int A_BYTES = BM * 128;      // 16 KB
  static constexpr int B_BYTES = BN * 128;      // 32 or 16 KB
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // the ring on 1024 bytes, the epilogue's staging, then a full and an
  // empty barrier a stage
  static constexpr int OUT = STAGES * STAGE;
  static constexpr int BARS = OUT + GEMM_CONSUMER_WARPS * GEMM_OUT_STAGE;
  static constexpr int SMEM = 1024 + BARS + 2 * STAGES * 8;
};

// One warp's 16 x 32 chunk of output values (v[jj][h][p]: column 8 jj +
// t2 + p, row g + 8 h of the chunk) to out[row0.., col0..] as TO: through
// the warp's staging rows in shared memory, then 16-byte stores, each row
// of the chunk written whole (the m16n8 pairs alone would write half
// sectors).  Rows past M and columns past N are not stored; with a row map,
// row m goes to row row_map[m] of out, or nowhere where that is < 0.
template <typename TO, typename TV>
__device__ __forceinline__ void gemm_store_chunk(
    const TV (&v)[4][2][2], TO* __restrict__ out, unsigned char* stage,
    int row0, int col0, int M, int N, int lane,
    const int* __restrict__ row_map = nullptr) {
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
    if (row0 + r < M && col0 + c < N) {
      const int dst = row_map != nullptr ? row_map[row0 + r] : row0 + r;
      if (dst >= 0)
        *reinterpret_cast<uint4*>(out + (size_t)dst * N + col0 + c) =
            *reinterpret_cast<const uint4*>(stage + r * LDS + c * sizeof(TO));
    }
  }
  __syncwarp();
}

// The first output row of this consumer warp's 16 in the tile at m0:
// warpgroup 64-row half, then the warp's 16
__device__ __forceinline__ int gemm_warp_row0(int m0) {
  return m0 + (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16;
}

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

// The bf16 products' epilogues: a 64-row consumer warpgroup's accumulators
// of the 128 x BN tile at (m0, n0) through the staged stores.
template <int EPI, typename TX>
struct EpiBf16 {
  const float* bias;
  bf16* out_bf16;
  const TX* resid;
  TX* out_x;
  float* out_f32;
  const float* gate;

  bool aligned() const {
    return (reinterpret_cast<uintptr_t>(out_bf16) |
            reinterpret_cast<uintptr_t>(out_x) |
            reinterpret_cast<uintptr_t>(out_f32)) % 16 == 0;
  }

  template <int NA>
  __device__ __forceinline__ void operator()(const float (&acc)[NA],
                                             unsigned char* stage, int m0,
                                             int n0, int M, int N) const {
    constexpr int BN = 2 * NA;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t2 = (lane & 3) * 2;
    const int row0 = gemm_warp_row0(m0);
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
            gemm_store_chunk<float>(v, out_f32, stage, row0, col0, M, N,
                                    lane);
      } else {
        gemm_store_chunk<bf16>(v, out_bf16, stage, row0, col0, M, N, lane);
      }
    }
  }
};

template <typename T, int BN, class Epi>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_nt_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_w, int M, int N, int K,
               const Epi epi) {
  using Op = GemmOperand<T>;
  using Tl = GemmTile<BN>;
  extern __shared__ unsigned char gsmem_raw[];
  unsigned char* ring = align1024(gsmem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Tl::BARS);
  uint64_t* empty = full + Tl::STAGES;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_n * ((M + Tl::BM - 1) / Tl::BM);
  const int nk = (K + Op::BK - 1) / Op::BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Tl::STAGES; ++s) {
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
        const int m0 = t / tiles_n * Tl::BM, n0 = t % tiles_n * BN;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * Tl::STAGE;
          mbar_expect_tx(&full[stage], Tl::STAGE);
          tma_load_2d(st, &map_a, &full[stage], kt * Op::BK, m0);
          tma_load_2d(st + Tl::A_BYTES, &map_w, &full[stage], kt * Op::BK,
                      n0);
          if (++stage == Tl::STAGES) {
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
    typename Op::Acc acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int stage = 0, phase = 0, prev = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * Tl::BM, n0 = t % tiles_n * BN;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[stage], phase);
        const unsigned char* st = ring + stage * Tl::STAGE;
        wgmma_fence();
        // four 32-byte k steps of the 128-byte stage row
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Op::template mma<BN>(acc, desc_sw128(st + wg * 64 * 128 + kk * 32),
                               desc_sw128(st + Tl::A_BYTES + kk * 32),
                               kt > 0 || kk > 0);
        wgmma_commit();
        // the previous k tile's products are done: release its stage
        wgmma_wait<1>();
        if (kt > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == Tl::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[prev]);
      epi(acc, ring + Tl::OUT + (threadIdx.x >> 5) * GEMM_OUT_STAGE, m0, n0,
          M, N);
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

// A tensor of ``rank`` dimensions (dims innermost first, the byte strides of
// dims 1.. in ``strides``) read in 128-byte swizzled boxes of ``box``
// elements (or unswizzled, row after row, with ``swizzle`` NONE), zeros
// past its edges.
inline cudaError_t tensor_map(
    CUtensorMap* map, CUtensorMapDataType type, const void* p, int rank,
    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, type, rank, const_cast<void*>(p), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a [rows, K] row-major matrix of T read in boxes of one 128-byte row of k
// by box_rows
template <typename T>
inline cudaError_t tensor_map_rows(CUtensorMap* map, const T* p, int rows,
                                   int K, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * sizeof(T)};
  const cuuint32_t box[2] = {GemmOperand<T>::BK,
                             static_cast<cuuint32_t>(box_rows)};
  return tensor_map(map, GemmOperand<T>::TMA_TYPE, p, 2, dims, strides, box);
}

// the GEMM with 128 x BN tiles
template <typename T, int BN, class Epi>
cudaError_t launch_gemm_tiles(const T* A, const T* W, int M, int N, int K,
                              const Epi& epi, cudaStream_t s) {
  using Tl = GemmTile<BN>;
  if (M <= 0 || N <= 0 || K <= 0 || K * sizeof(T) % 16 || N % 8 ||
      (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(W)) %
          16 ||
      !epi.aligned())
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_w;
  cudaError_t err = tensor_map_rows(&map_a, A, M, K, Tl::BM);
  if (err != cudaSuccess) return err;
  err = tensor_map_rows(&map_w, W, N, K, BN);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gemm_nt_kernel<T, BN, Epi>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tl::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = ((N + BN - 1) / BN) * ((M + Tl::BM - 1) / Tl::BM);
  const int grid = tiles < sms ? tiles : sms;
  gemm_nt_kernel<T, BN, Epi><<<grid, GEMM_THREADS, Tl::SMEM, s>>>(
      map_a, map_w, M, N, K, epi);
  return cudaGetLastError();
}

// The GEMM of T operands with the epilogue ``epi``: 128 x 256 tiles from
// N = GemmOperand<T>::WIDE_N, else 128 x 128.
template <typename T, class Epi>
cudaError_t launch_gemm(const T* A, const T* W, int M, int N, int K,
                        const Epi& epi, cudaStream_t s) {
  if (N >= GemmOperand<T>::WIDE_N)
    return launch_gemm_tiles<T, 256>(A, W, M, N, K, epi, s);
  return launch_gemm_tiles<T, 128>(A, W, M, N, K, epi, s);
}

// The bf16 GEMM with one of the GemmEpilogue forms.
template <int EPI, typename TX>
cudaError_t launch_gemm_nt(const bf16* A, const bf16* W, const float* bias,
                           int M, int N, int K, bf16* out_bf16,
                           const TX* resid, TX* out_x, float* out_f32,
                           cudaStream_t s, const float* gate = nullptr) {
  return launch_gemm(A, W, M, N, K,
                     EpiBf16<EPI, TX>{bias, out_bf16, resid, out_x, out_f32,
                                      gate},
                     s);
}

}  // namespace dyt
