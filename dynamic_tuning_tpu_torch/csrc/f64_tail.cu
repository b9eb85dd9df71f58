// The float64 tail on the FP64 tensor cores (DMMA): the adapter/router tail
// (E == 0) and the MoE tail (E >= 1 experts of width b, F = E * b) with
// fp32 weights, on the fp32 x_mid, with or without the token router.  It
// is the tail of K3, K6, K7 and K8 with fp32 adapters or experts
// (dynamic_tuning_tpu/ops/mha_serving.py::dyt_prologue_serving and
// dyt_prologue_serving_moe, quant.py::dyt_prologue_serving_q8 and
// dyt_prologue_serving_q8_moe, whose products run in the weights' dtype):
// in K6 and K8 its output feeds the next block's int8 quantization, so
// every sum is float64, rounded once to fp32, as the plain versions
// (ops/mha_serving.py::adapter_router_plain, moe_adapter_router_plain) sum
// them:
//   r_e = fp32(x . wr_e) * inv_tau;  gates = exp(r - max r) / fp32(sum64)
//   logit = fp32(x . wsel) + bsel
//   h = relu(fp32(x . wd_f) + bd_f) [* gates_(f / b)]      (fp32)
//   adapt = (fp32(h . wu_c) + bias_c) * scale,  bias_c = bu_c, or for MoE
//           fp32(sum64_e gates_e * bu_(e, c))
//
// What bounds it on an H100.  At B = 32 (M = 6304 rows, C = 768) the
// adapter (F = 64) is 0.62 G multiply-adds and the MoE tail (4 x 64) 2.5 G:
// 0.019 and 0.074 ms at the 67 TFLOP/s of the FP64 tensor cores, against
// 0.012 ms for x_mid's read and adapt's write.  Each operand is converted
// to float64 as its fragment is formed, and each fragment feeds several
// products: an fp32 -> float64 conversion issues 16 a clock an SM, an
// eighth of the FP32 rate.
//
// What the design does about it.  One block of 8 warps owns 48 rows
// (three m16 tiles: 132 blocks at M = 6304, one a SM):
//   * pass 1 computes [router columns | down columns] = x . [wr; wsel; wd]^T
//     on m16n8k8 DMMA, the router's E + 1 dots an n-tile of the down
//     product's weight, so x_mid is read once; it walks C in chunks of 32
//     through a three-stage cp.async ring of fp32 x and weight rows (each
//     thread's source rows found once a round), each warp holding two or
//     three n-tiles of all three m-tiles (rounds of 128 or 192 columns:
//     more accumulators than that leave ptxas no room to schedule);
//   * its epilogue takes the router logit, the expert softmax (one thread
//     a row, after the round that holds the last router column: the router
//     columns come first and take as many rounds as E asks) and h =
//     relu(. + bd) * gate; the gates and h go to fp32 scratch rows [M, E]
//     and [M, F] that the block reads straight back (L1 and L2), so any E
//     fits;
//   * pass 2 computes h . wu^T over F, 128 or 192 columns of C a round,
//     with the scale in its epilogue and the MoE's gated up bias, gates .
//     bu, a product over the experts on DMMA of its own.
// One launch; a block's operands stay in L2 between the passes.
#include "dmma.cuh"

namespace dyt {

constexpr int FT_TM = 48;                  // rows a block
constexpr int FT_MT = FT_TM / 16;          // m-tiles a block
constexpr int FT_WARPS = 8;
constexpr int FT_THREADS = 32 * FT_WARPS;
constexpr int FT_KC = 32;                  // k a chunk
constexpr int FT_LD = FT_KC + 4;           // floats a staged row
constexpr int FT_STAGES = 3;

// NR n-tiles a warp a round.  Shared memory (floats): the ring of [x rows |
// weight rows] x [FT_LD] stages.
template <int NR>
struct FtPlan {
  static constexpr int RT = FT_WARPS * NR;   // n-tiles a round
  static constexpr int RN = 8 * RT;          // columns (weight rows) a round
  static constexpr int STAGE = (FT_TM + RN) * FT_LD;
  static constexpr int BYTES = FT_STAGES * STAGE * 4;
};

struct FtArgs {
  const float* xm;                 // [M, C]
  int M, C;
  const float* wr;                 // [E, C] (E > 0)
  int E, b;
  float inv_tau;
  const float* wsel;               // [C] or null (no token router)
  const float* bsel;               // [1]
  float* logits;                   // [M]
  const float* wd;                 // [F, C]
  const float* bd;                 // [F]
  const float* wu;                 // [C, F]
  const float* bu;                 // [C], or [E, C] (E > 0)
  const float* ascale;             // [1]
  void* adapt;                     // [M, C] of TO
  float* h;                        // [M, F] scratch
  float* gates;                    // [M, E] scratch (E > 0)
  int F;
  int vec1, vec2;                  // 16-byte copies in pass 1 / pass 2
};

template <int NR>
using FtAcc = double[FT_MT][NR][4];

// acc += A[m0 .., :K] . B[rows of this round, :K]^T: A's row r at
// rowA(r) (null past M), the round's weight row j at rowB(j) (null for a
// zero row), both K-contiguous; nt the round's n-tiles; ``dummy`` a global
// address for the copies that write zeros.  Leaves the ring free.
template <int NR, class RowA, class RowB>
__device__ __forceinline__ void ft_gemm(FtAcc<NR>& acc, float* ring, RowA rowA,
                                        RowB rowB, int K, bool vec, int nt,
                                        const float* dummy) {
  using P = FtPlan<NR>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nk = (K + FT_KC - 1) / FT_KC;
  // this thread's 16-byte pieces of a chunk (row r, columns 4q .. 4q + 3),
  // their sources found once: a chunk's copies are then pointer + k0
  constexpr int PIECES = FT_KC / 4;
  constexpr int PER = ((FT_TM + P::RN) * PIECES + FT_THREADS - 1) /
                      FT_THREADS;
  const int npiece = (FT_TM + 8 * nt) * PIECES;
  const float* src[PER];
  int dsto[PER], kq[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * FT_THREADS;
    const int r = i / PIECES;
    kq[j] = (i % PIECES) * 4;
    dsto[j] = r * FT_LD + kq[j];
    src[j] = i >= npiece ? nullptr : r < FT_TM ? rowA(r) : rowB(r - FT_TM);
  }
  auto load = [&](int kc, int st) {
    float* dst = ring + st * P::STAGE;
    const int k0 = kc * FT_KC;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (tid + j * FT_THREADS >= npiece) break;
      const int k = k0 + kq[j];
      if (vec) {
        const bool ok = src[j] != nullptr && k < K;
        cp_async16(dst + dsto[j], ok ? src[j] + k : dummy, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = src[j] != nullptr && k + e < K;
          cp_async4(dst + dsto[j] + e, ok ? src[j] + k + e : dummy,
                    ok ? 4 : 0);
        }
      }
    }
  };
  // FT_STAGES - 1 chunks in flight ahead of the one computed
#pragma unroll
  for (int c = 0; c < FT_STAGES - 1; ++c) {
    if (c < nk) load(c, c);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<FT_STAGES - 2>();
    __syncthreads();                // chunk kc everywhere; kc - 1's stage free
    const int next = kc + FT_STAGES - 1;
    if (next < nk) load(next, next % FT_STAGES);
    cp_async_commit();
    const float* As = ring + (kc % FT_STAGES) * P::STAGE;
    const float* Bs = As + FT_TM * FT_LD;
#pragma unroll
    for (int ks = 0; ks < FT_KC / 8; ++ks) {
      double af[FT_MT][4];
#pragma unroll
      for (int mt = 0; mt < FT_MT; ++mt) {
        const float* p = As + (16 * mt + g) * FT_LD + 8 * ks + t;
        af[mt][0] = p[0];
        af[mt][1] = p[8 * FT_LD];
        af[mt][2] = p[4];
        af[mt][3] = p[8 * FT_LD + 4];
      }
#pragma unroll
      for (int sl = 0; sl < NR; ++sl) {
        const int lt = sl * FT_WARPS + warp;    // the round's n-tile
        if (lt >= nt) continue;
        const float* p = Bs + (8 * lt + g) * FT_LD + 8 * ks + t;
        const double b0 = p[0], b1 = p[4];
#pragma unroll
        for (int mt = 0; mt < FT_MT; ++mt)
          dmma_16x8x8(acc[mt][sl], af[mt], b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <int NR>
__device__ __forceinline__ void ft_zero(FtAcc<NR>& acc) {
#pragma unroll
  for (int mt = 0; mt < FT_MT; ++mt)
#pragma unroll
    for (int sl = 0; sl < NR; ++sl)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][sl][i] = 0.0;
}

template <typename TO, int NR>
__global__ void __launch_bounds__(FT_THREADS, 1)
f64_tail_kernel(const FtArgs a) {
  using P = FtPlan<NR>;
  extern __shared__ __align__(16) float ft_smem[];
  float* ring = ft_smem;
  float* gates = a.gates;
  const int m0 = blockIdx.x * FT_TM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int M = a.M, C = a.C, F = a.F, E = a.E;
  const int R = E + (a.wsel != nullptr);      // router columns
  const int RC = 8 * ((R + 7) / 8);           // ... padded to n-tiles
  const int NT1 = RC / 8 + (F + 7) / 8;
  const int NT2 = (C + 7) / 8;
  FtAcc<NR> acc;

  // the output (row, column) of accumulator i of (mt, sl), round n0
  auto row_of = [&](int mt, int i) { return m0 + 16 * mt + g + 8 * (i >> 1); };
  auto col_of = [&](int n0, int sl, int i) {
    return n0 + 8 * (sl * FT_WARPS + warp) + 2 * t + (i & 1);
  };
  auto xrow = [&](int r) -> const float* {
    return m0 + r < M ? a.xm + (size_t)(m0 + r) * C : nullptr;
  };

  // --- pass 1: router and down product -------------------------------------
  for (int n0 = 0; n0 < 8 * NT1; n0 += P::RN) {
    ft_zero<NR>(acc);
    ft_gemm<NR>(acc, ring, xrow,
            [&](int j) -> const float* {
              const int col = n0 + j;
              if (col < E) return a.wr + (size_t)col * C;
              if (col < R) return a.wsel;
              if (col < RC) return nullptr;
              return col - RC < F ? a.wd + (size_t)(col - RC) * C : nullptr;
            },
            C, a.vec1, min(P::RT, NT1 - n0 / 8), a.xm);
    if (n0 < RC) {
      // the router columns: r_e * inv_tau to the gates' rows, the
      // token-router logit
#pragma unroll
      for (int sl = 0; sl < NR; ++sl)
#pragma unroll
        for (int mt = 0; mt < FT_MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int m = row_of(mt, i), col = col_of(n0, sl, i);
            if (col >= R || m >= M) continue;
            const float v = __double2float_rn(acc[mt][sl][i]);
            if (col < E)
              gates[(size_t)m * E + col] = __fmul_rn(v, a.inv_tau);
            else
              a.logits[m] = __fadd_rn(v, a.bsel[0]);
          }
      if (E > 0 && n0 + P::RN >= RC) {
        // the round with the last router column: every r_e of the block's
        // rows is written
        __syncthreads();
        if (tid < FT_TM && m0 + tid < M) {
          // softmax over the experts: the max subtracted, the sum in
          // float64 rounded once, an IEEE division
          float* gr = gates + (size_t)(m0 + tid) * E;
          float rmax = __int_as_float(0xff800000);     // -inf
          for (int e = 0; e < E; ++e) rmax = fmaxf(rmax, gr[e]);
          double sum = 0.0;
          for (int e = 0; e < E; ++e) {
            gr[e] = expf(__fsub_rn(gr[e], rmax));
            sum += (double)gr[e];
          }
          const float den = __double2float_rn(sum);
          for (int e = 0; e < E; ++e) gr[e] = __fdiv_rn(gr[e], den);
        }
        __syncthreads();
      }
    }
    // the down columns: h = relu(. + bd) [* gate]
#pragma unroll
    for (int sl = 0; sl < NR; ++sl)
#pragma unroll
      for (int mt = 0; mt < FT_MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = row_of(mt, i), f = col_of(n0, sl, i) - RC;
          if (f < 0 || f >= F || m >= M) continue;
          float v = fmaxf(__fadd_rn(__double2float_rn(acc[mt][sl][i]),
                                    a.bd[f]), 0.f);
          if (E > 0) v = __fmul_rn(v, gates[(size_t)m * E + f / a.b]);
          a.h[(size_t)m * F + f] = v;
        }
  }
  __syncthreads();                      // the block's h rows written

  // --- pass 2: the up product ----------------------------------------------
  const float scale = a.ascale[0];
  TO* out = static_cast<TO*>(a.adapt);
  for (int n0 = 0; n0 < 8 * NT2; n0 += P::RN) {
    ft_zero<NR>(acc);
    ft_gemm<NR>(acc, ring,
            [&](int r) -> const float* {
              return m0 + r < M ? a.h + (size_t)(m0 + r) * F : nullptr;
            },
            [&](int j) -> const float* {
              return n0 + j < C ? a.wu + (size_t)(n0 + j) * F : nullptr;
            },
            F, a.vec2, min(P::RT, NT2 - n0 / 8), a.xm);
    const int nt = min(P::RT, NT2 - n0 / 8);
#pragma unroll
    for (int sl = 0; sl < NR; ++sl) {
      const int lt = sl * FT_WARPS + warp;
      if (lt >= nt) continue;
      // the MoE up bias of this n-tile, gates . bu (k = the experts) on
      // DMMA: its accumulator has acc's layout
      double ub[FT_MT][4];
#pragma unroll
      for (int mt = 0; mt < FT_MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) ub[mt][i] = 0.0;
      const int cb = n0 + 8 * lt + g;       // B's column
      for (int e0 = 0; e0 < E; e0 += 8) {
        const int e1 = e0 + t, e2 = e0 + t + 4;
        const double b0 = e1 < E && cb < C ? a.bu[(size_t)e1 * C + cb] : 0.f;
        const double b1 = e2 < E && cb < C ? a.bu[(size_t)e2 * C + cb] : 0.f;
#pragma unroll
        for (int mt = 0; mt < FT_MT; ++mt) {
          // A's rows r and r + 8 (zero past M: their outputs are not stored)
          const int r = m0 + 16 * mt + g;
          const float* g0 = gates + (size_t)r * E;
          const float* g1 = g0 + 8 * (size_t)E;
          const bool ok0 = r < M, ok1 = r + 8 < M;
          const double af[4] = {ok0 && e1 < E ? g0[e1] : 0.f,
                                ok1 && e1 < E ? g1[e1] : 0.f,
                                ok0 && e2 < E ? g0[e2] : 0.f,
                                ok1 && e2 < E ? g1[e2] : 0.f};
          dmma_16x8x8(ub[mt], af, b0, b1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < FT_MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = row_of(mt, i), c = col_of(n0, sl, i);
          if (c >= C || m >= M) continue;
          const float bias = E > 0 ? __double2float_rn(ub[mt][i]) : a.bu[c];
          out[(size_t)m * C + c] = from_f32<TO>(__fmul_rn(
              __fadd_rn(__double2float_rn(acc[mt][sl][i]), bias), scale));
        }
    }
  }
}

inline bool ft_aligned(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename TO, int NR>
static cudaError_t launch_f64_tail_nr(const FtArgs& a, cudaStream_t s) {
  auto kernel = f64_tail_kernel<TO, NR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FtPlan<NR>::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<(a.M + FT_TM - 1) / FT_TM, FT_THREADS, FtPlan<NR>::BYTES, s>>>(a);
  return cudaGetLastError();
}

// two n-tiles a warp where pass 1 has at most 16 (the adapter up to F =
// 120), three past it (MoE 4 x 64: 33 n-tiles in two rounds), the faster
// of the two on an H100 for each
template <typename TO>
static cudaError_t launch_f64_tail(FtArgs a, cudaStream_t s) {
  if (a.M < 0 || a.C <= 0 || a.F <= 0 || a.E < 0 ||
      (a.E > 0 && (a.b <= 0 || a.F != a.E * a.b || a.gates == nullptr)))
    return cudaErrorInvalidValue;
  if (a.M == 0) return cudaSuccess;
  a.vec1 = a.C % 4 == 0 && ft_aligned(a.xm) && ft_aligned(a.wr) &&
           ft_aligned(a.wsel) && ft_aligned(a.wd);
  a.vec2 = a.F % 4 == 0 && ft_aligned(a.h) && ft_aligned(a.wu);
  const int R = a.E + (a.wsel != nullptr);
  const int nt1 = (R + 7) / 8 + (a.F + 7) / 8;
  return nt1 <= 2 * FT_WARPS ? launch_f64_tail_nr<TO, 2>(a, s)
                             : launch_f64_tail_nr<TO, 3>(a, s);
}

}  // namespace dyt

extern "C" {

// The float64 tail with fp32 weights on the fp32 x_mid xm [M, C]: the
// adapter (E == 0: wd [F, C], bd [F], wu [C, F], bu [C]) or the MoE tail
// (E experts of width b, F = E * b: wr [E, C], wd [F, C], bd [F], wu [C, F],
// bu [E, C]); ascale [1]; wsel [C] and bsel [1], or wsel == NULL to skip
// the token router; adapt [M, C] fp32 (adapt_f32) or bf16; logits [M]
// fp32; scratch h [M, F] fp32 and gates [M, E] fp32 (MoE; else unused).
// Returns a cudaError_t value.
int dyt_tail_f64(const float* xm, int M, int C, const float* wr,
                 const float* wd, const float* bd, const float* wu,
                 const float* bu, const float* ascale, const float* wsel,
                 const float* bsel, void* adapt, int adapt_f32,
                 float* logits, int F, int E, int b, float inv_tau, float* h,
                 float* gates, void* stream) {
  const dyt::FtArgs a{xm, M, C, wr, E, b, inv_tau, wsel, bsel, logits, wd,
                      bd, wu, bu, ascale, adapt, h, gates, F, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return adapt_f32 ? dyt::launch_f64_tail<float>(a, s)
                   : dyt::launch_f64_tail<dyt::bf16>(a, s);
}

}  // extern "C"
