// DyT block prologue epilogue: the parallel adapter and the router head on
// the post-attention activation x_mid,
//     adapt  = (relu(bf16(x_mid) @ Wd^T + bd) @ Wu^T + bu) * scale
//     logits = x_mid @ wsel + bsel          (fp32 x_mid, fp32 wsel)
//
// Replaces, together with the attention sublayer chain of
// attention_sublayer.cu (K3) or quant.cu (K6), the tail of the TPU kernels
// dynamic_tuning_tpu/ops/mha_serving.py::dyt_prologue_serving
// (_dyt_prologue_kernel) and dynamic_tuning_tpu/ops/quant.py::
// dyt_prologue_serving_q8.
//
// What bounds it on an H100.  The adapter is 4*M*C*F = 10 GFLOP at ViT-B
// serving shapes (M = 128*197 rows, C = 768, F = 64) -- nothing for the
// tensor cores -- while it reads the fp32 x_mid (77 MB) and writes adapt
// (39 MB in bf16): it is bound by device-memory bytes, 35 us at 3.35 TB/s.
// The TPU kernel computed both heads while x_mid sat in VMEM.  The WMMA form
// this replaces loaded each 64-column chunk of x_mid with plain loads behind
// a barrier, overlapping nothing, and staged both weight matrices again in
// every 64-row block: ~97 us.
//
// What the design does about it (the MoE tail's, moe_adapter.cu).  A
// persistent grid, one 384-thread block an SM, walks tiles of 64 rows:
//   * one producer thread (warpgroup 2, its registers given to the
//     consumers with setmaxnreg) keeps a ring of up to eight stages in
//     flight with TMA: for each 64-column chunk of x_mid the fp32 rows (two
//     32-column boxes, 128-byte swizzled) and the matching 64 columns of Wd
//     (all F rows); then for each 64-column chunk of the output the Wu rows
//     over all of F.  A full and an empty mbarrier a stage pace it, and the
//     next tile's x_mid loads while this one's up product runs.  The weights
//     come from L2, once a tile;
//   * the router dots run on the fp32 stage: sixteen lanes a row, four
//     columns each a chunk, chained FMAs and a butterfly over the sixteen
//     (the WMMA form's order, so the logits are its bits); the router
//     weights and the biases are copied into shared memory once a block
//     (read from global memory in every chunk, their latency held the
//     consumers ~8 us);
//   * two consumer warpgroups run both products on wgmma: the down product
//     with bf16(x) as register A fragments (from the same fp32 stage,
//     rounded once) against Wd's rows K-major, each warpgroup F / 2 of the
//     columns over all 64 rows, accumulated through the tensor core in k16
//     order (as the WMMA chain); relu(down + bd) goes to a 128-byte swizzled
//     bf16 H tile; the up product reads H and the Wu rows from shared
//     memory, each warpgroup 32 of a chunk's 64 output columns;
//   * the epilogue, (up + bu) * scale, stores whole 16-byte pieces of rows
//     through each warp's staging rows (gemm.cuh's gemm_store_chunk).
// Where its time goes: utils/core_ablation.py's adapter variants (PERF.md).
#include "gemm.cuh"

namespace dyt {

constexpr int AR_THREADS = 384;      // two consumer warpgroups + a producer
constexpr int AR_CONSUMERS = 256;
constexpr int AR_ROWS = 64;          // rows a tile
constexpr int AR_CHUNK = 64;         // x_mid / output columns a step
constexpr int AR_XBOX = AR_ROWS * 128;     // one [64 rows][32 fp32] x box
constexpr int AR_MAX_STAGES = 8;
constexpr int AR_SMEM_LIMIT = 232448;      // a block's shared memory on sm_90

// Shared memory for bottleneck F and width C: the ring (a stage: the fp32 x
// chunk [2][64 rows][32] and the Wd box [F rows][64], or a Wu item [FP / 64]
// [64 rows][64], all 128-byte swizzled; as many stages as fit, at most
// AR_MAX_STAGES), the H tile [FP / 64][64 rows][64] bf16, each consumer
// warp's output staging rows, wsel [C], bu [C] and bd [F] fp32, then a full
// and an empty barrier a stage; offsets from the first 1024-byte boundary.
template <int F>
struct ArLayout {
  static constexpr int FP = (F + 63) / 64 * 64;
  static constexpr int STAGE = 2 * AR_XBOX + F * 128;     // >= FP * 128
  static constexpr int H_BYTES = AR_ROWS * FP * 2;
  static constexpr int OS_BYTES = AR_CONSUMERS / 32 * GEMM_OUT_STAGE;
  int stages, h_off, os_off, vec_off, bar_off, smem;
  __host__ __device__ explicit ArLayout(int C) {
    const int vec = ((2 * C + F) * 4 + 15) / 16 * 16;
    const int fits = (AR_SMEM_LIMIT - 1024 - H_BYTES - OS_BYTES - vec -
                      16 * AR_MAX_STAGES) / STAGE;
    stages = fits < AR_MAX_STAGES ? fits : AR_MAX_STAGES;
    h_off = stages * STAGE;
    os_off = h_off + H_BYTES;
    vec_off = os_off + OS_BYTES;
    bar_off = vec_off + vec;
    smem = 1024 + bar_off + 2 * stages * 8;
  }
};

template <int F, typename TO>
__global__ void __launch_bounds__(AR_THREADS, 1)
adapter_router_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_wd,
                      const __grid_constant__ CUtensorMap map_wu, int M,
                      int C, const float* __restrict__ bd,
                      const float* __restrict__ bu,
                      const float* __restrict__ ascale,
                      const float* __restrict__ wsel,
                      const float* __restrict__ bsel, TO* __restrict__ adapt,
                      float* __restrict__ logits) {
  using L = ArLayout<F>;
  constexpr int FH = F / 2;        // down-product columns a warpgroup takes
  const L lay(C);
  const int stages = lay.stages;
  extern __shared__ unsigned char ar_smem_raw[];
  unsigned char* base = align1024(ar_smem_raw);
  unsigned char* Hs = base + lay.h_off;
  unsigned char* OS = base + lay.os_off;
  float* ws = reinterpret_cast<float*>(base + lay.vec_off);    // wsel or 0
  float* bus = ws + C;
  float* bds = bus + C;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + lay.bar_off);
  uint64_t* empty = full + stages;
  const int tiles = (M + AR_ROWS - 1) / AR_ROWS, nk = C / AR_CHUNK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);                       // the producer's arrive
      mbar_init(&empty[s], AR_CONSUMERS / 32);      // lane 0 of each warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= AR_CONSUMERS) {
    // producer warpgroup: one thread issues every load, in the order the
    // consumers take them
    setmaxnreg_dec<40>();
    if (threadIdx.x == AR_CONSUMERS) {
      int stage = 0, phase = 0;
      auto slot = [&](int bytes) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], bytes);
        return base + stage * L::STAGE;
      };
      auto advance = [&] {
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      };
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t * AR_ROWS;
        for (int k = 0; k < nk; ++k) {
          unsigned char* st = slot(L::STAGE);
          tma_load_2d(st, &map_x, &full[stage], k * AR_CHUNK, m0);
          tma_load_2d(st + AR_XBOX, &map_x, &full[stage], k * AR_CHUNK + 32,
                      m0);
          tma_load_2d(st + 2 * AR_XBOX, &map_wd, &full[stage], k * AR_CHUNK,
                      0);
          advance();
        }
        for (int n = 0; n < nk; ++n) {
          unsigned char* st = slot(L::FP * 128);
          for (int kb = 0; kb < L::FP / 64; ++kb)
            tma_load_2d(st + kb * 64 * 128, &map_wu, &full[stage], kb * 64,
                        n * AR_CHUNK);
          advance();
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = threadIdx.x, cg = ctid >> 7, warp = (ctid >> 5) & 3;
  const int lane = ctid & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  const int r0 = warp * 16 + g;            // this thread's rows r0, r0 + 8
  // router: lane ri of a sixteen takes columns 4 ri .. 4 ri + 3 of every
  // chunk, of rows rq, rq + 16, rq + 32, rq + 48
  const int ri = ctid & 15, rq = ctid >> 4;
  const bool router = wsel != nullptr;
  const float s_ad = ascale[0], b_sel = router ? bsel[0] : 0.f;
  // the router weights and both biases, read in every chunk, from shared
  // memory
  for (int i = ctid; i < C; i += AR_CONSUMERS) {
    ws[i] = router ? wsel[i] : 0.f;
    bus[i] = bu[i];
  }
  for (int i = ctid; i < F; i += AR_CONSUMERS) bds[i] = bd[i];
  consumer_sync();
  // stages are taken (wait_full) one ahead of their release: a product
  // stays in flight while the next chunk's work runs
  int wst = 0, wphase = 0, rst = 0;
  auto wait_full = [&] {
    mbar_wait(&full[wst], wphase);
    const unsigned char* st = base + wst * L::STAGE;
    if (++wst == stages) {
      wst = 0;
      wphase ^= 1;
    }
    return st;
  };
  auto release = [&] {
    if (lane == 0) mbar_arrive(&empty[rst]);
    if (++rst == stages) rst = 0;
  };

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t * AR_ROWS;

    // --- down product and router dots, chunk by chunk --------------------
    float acc[FH / 2];
    float rpart[4] = {0.f, 0.f, 0.f, 0.f};
    // chunk k: the router dots, bf16(x) of this thread's rows as wgmma A
    // fragments (one per k16 step) in ``af``, the products issued; then
    // chunk k - 1's stage released once its products are done
    auto down = [&](int k, unsigned (&af)[4][4]) {
      const unsigned char* st = wait_full();
      if (router) {
        const float4 w =
            *reinterpret_cast<const float4*>(ws + k * AR_CHUNK + 4 * ri);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float4 v = *reinterpret_cast<const float4*>(
              st + (ri >> 3) * AR_XBOX + sw128(rq + 16 * p, (4 * ri) & 31, 4));
          rpart[p] = fmaf(v.x, w.x, rpart[p]);
          rpart[p] = fmaf(v.y, w.y, rpart[p]);
          rpart[p] = fmaf(v.z, w.z, rpart[p]);
          rpart[p] = fmaf(v.w, w.w, rpart[p]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + (e & 1) * 8, c = kk * 16 + t2 + (e >> 1) * 8;
          const float2 v = *reinterpret_cast<const float2*>(
              st + (c >> 5) * AR_XBOX + sw128(r, c & 31, 4));
          af[kk][e] = pack_bf16x2(v.x, v.y);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<FH, false>(
            acc, af[kk],
            desc_sw128(st + 2 * AR_XBOX + cg * FH * 128 + kk * 32),
            k > 0 || kk > 0);
      wgmma_commit();
      if (k > 0) {
        wgmma_wait<1>();
        release();
      }
    };
    unsigned afa[4][4], afb[4][4];
    for (int k = 0; k < nk; k += 2) {
      down(k, afa);
      if (k + 1 < nk) down(k + 1, afb);
    }
    wgmma_wait<0>();
    release();

    if (router) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float v = rpart[p];
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        const int r = m0 + rq + 16 * p;
        if (ri == 0 && r < M) logits[r] = __fadd_rn(v, b_sel);
      }
    }

    // bottleneck: bf16(relu(down + bd)) -> H, this warpgroup's columns
#pragma unroll
    for (int j = 0; j < FH / 8; ++j) {
      const int f = cg * FH + j * 8 + t2;
      const float2 b = load2(bds + f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        store2(reinterpret_cast<bf16*>(Hs + (f >> 6) * AR_ROWS * 128 +
                                       sw128(r0 + 8 * hh, f & 63, 2)),
               fmaxf(__fadd_rn(acc[4 * j + 2 * hh], b.x), 0.f),
               fmaxf(__fadd_rn(acc[4 * j + 2 * hh + 1], b.y), 0.f));
    }
    fence_proxy_async();            // H visible to the tensor cores
    consumer_sync();

    // --- up product per 64 output columns: (H . Wu^T + bu) * scale --------
    // chunk n's products issued into u, its bias loaded into bq
    auto up = [&](int n, float (&u)[16], float2 (&bq)[4]) {
      const unsigned char* wu = wait_full();
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < F / 16; ++s)
        wgmma_ss<32>(u,
                     desc_sw128(Hs + (s >> 2) * AR_ROWS * 128 + (s & 3) * 32),
                     desc_sw128(wu + (s >> 2) * 64 * 128 + cg * 32 * 128 +
                                (s & 3) * 32),
                     s > 0);
      wgmma_commit();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        bq[jj] = load2(bus + n * AR_CHUNK + cg * 32 + jj * 8 + t2);
    };
    // chunk n, its products done: the stage released, the outputs stored
    // as whole 16-byte pieces of rows
    auto store = [&](int n, const float (&u)[16], const float2 (&bq)[4]) {
      release();
      float v[4][2][2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          v[jj][hh][0] =
              __fmul_rn(__fadd_rn(u[4 * jj + 2 * hh], bq[jj].x), s_ad);
          v[jj][hh][1] =
              __fmul_rn(__fadd_rn(u[4 * jj + 2 * hh + 1], bq[jj].y), s_ad);
        }
      gemm_store_chunk<TO>(v, adapt, OS + (ctid >> 5) * GEMM_OUT_STAGE,
                           m0 + warp * 16, n * AR_CHUNK + cg * 32, M, C,
                           lane);
    };
    float ua[16], ub[16];
    float2 ba[4], bb[4];
    up(0, ua, ba);
    for (int n = 0; n < nk; n += 2) {
      if (n + 1 < nk) {
        up(n + 1, ub, bb);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      store(n, ua, ba);
      if (n + 1 < nk) {
        if (n + 2 < nk) {
          up(n + 2, ua, ba);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        store(n + 1, ub, bb);
      }
    }
    consumer_sync();                // H free for the next tile
  }
}

template <int F, typename TO>
static cudaError_t launch_ar(const float* xm, int M, int C, const bf16* wd,
                             const float* bd, const bf16* wu, const float* bu,
                             const float* ascale, const float* wsel,
                             const float* bsel, TO* adapt, float* logits,
                             cudaStream_t s) {
  const ArLayout<F> lay(C);
  if (lay.stages < 2) return cudaErrorInvalidValue;
  if (M <= 0) return cudaSuccess;
  // x_mid in [32 columns, 64 rows] fp32 boxes, Wd in [64, F] and Wu in
  // [64, 64] bf16 boxes, all 128-byte swizzled; zeros past each edge
  CUtensorMap map_x, map_wd, map_wu;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(C),
                               static_cast<cuuint64_t>(M)};
  const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(C) * 4};
  const cuuint32_t xbox[2] = {32, AR_ROWS};
  cudaError_t err = tensor_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, xm, 2,
                               xdims, xstride, xbox);
  if (err != cudaSuccess) return err;
  const cuuint64_t ddims[2] = {static_cast<cuuint64_t>(C),
                               static_cast<cuuint64_t>(F)};
  const cuuint64_t dstride[1] = {static_cast<cuuint64_t>(C) * 2};
  const cuuint32_t dbox[2] = {64, F};
  err = tensor_map(&map_wd, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, wd, 2, ddims,
                   dstride, dbox);
  if (err != cudaSuccess) return err;
  const cuuint64_t udims[2] = {static_cast<cuuint64_t>(F),
                               static_cast<cuuint64_t>(C)};
  const cuuint64_t ustride[1] = {static_cast<cuuint64_t>(F) * 2};
  const cuuint32_t ubox[2] = {64, 64};
  err = tensor_map(&map_wu, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, wu, 2, udims,
                   ustride, ubox);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(adapter_router_kernel<F, TO>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             lay.smem);
  if (err != cudaSuccess) return err;
  const int tiles = (M + AR_ROWS - 1) / AR_ROWS;
  adapter_router_kernel<F, TO>
      <<<tiles < sms ? tiles : sms, AR_THREADS, lay.smem, s>>>(
          map_x, map_wd, map_wu, M, C, bd, bu, ascale, wsel, bsel, adapt,
          logits);
  return cudaGetLastError();
}

template <typename TO>
static cudaError_t adapter_router(const float* xm, int M, int C,
                                  const bf16* wd, const float* bd,
                                  const bf16* wu, const float* bu,
                                  const float* ascale, const float* wsel,
                                  const float* bsel, TO* adapt, float* logits,
                                  int F, cudaStream_t s) {
  if (C <= 0 || C % AR_CHUNK) return cudaErrorInvalidValue;
  switch (F) {
    case 16: return launch_ar<16, TO>(xm, M, C, wd, bd, wu, bu, ascale, wsel, bsel, adapt, logits, s);
    case 32: return launch_ar<32, TO>(xm, M, C, wd, bd, wu, bu, ascale, wsel, bsel, adapt, logits, s);
    case 48: return launch_ar<48, TO>(xm, M, C, wd, bd, wu, bu, ascale, wsel, bsel, adapt, logits, s);
    case 64: return launch_ar<64, TO>(xm, M, C, wd, bd, wu, bu, ascale, wsel, bsel, adapt, logits, s);
    case 96: return launch_ar<96, TO>(xm, M, C, wd, bd, wu, bu, ascale, wsel, bsel, adapt, logits, s);
    case 128: return launch_ar<128, TO>(xm, M, C, wd, bd, wu, bu, ascale, wsel, bsel, adapt, logits, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dyt

extern "C" {

// Bottleneck widths the adapter kernel is instantiated for (the wrappers'
// AR_WIDTHS, held to this list on the card by the tests).
int dyt_adapter_width_supported(int F) {
  return F == 16 || F == 32 || F == 48 || F == 64 || F == 96 || F == 128;
}

// xm: fp32 [M, C] x_mid (C % 64 == 0); wd [F, C], wu [C, F] bf16; bd [F],
// bu [C], ascale [1] fp32; wsel [C] and bsel [1] fp32, or wsel == NULL to
// skip the router; adapt [M, C] in the residual dtype (adapt_f32 selects fp32
// over bf16); logits fp32 [M].  xm, wd, wu, wsel and adapt on 16 bytes.
// Returns a cudaError_t value.
int dyt_adapter_router(const float* xm, int M, int C, const void* wd,
                       const float* bd, const void* wu, const float* bu,
                       const float* ascale, const float* wsel,
                       const float* bsel, void* adapt, int adapt_f32,
                       float* logits, int F, void* stream) {
  using dyt::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* d = static_cast<const bf16*>(wd);
  auto* u = static_cast<const bf16*>(wu);
  if (adapt_f32)
    return dyt::adapter_router<float>(xm, M, C, d, bd, u, bu, ascale, wsel,
                                      bsel, static_cast<float*>(adapt), logits,
                                      F, s);
  return dyt::adapter_router<bf16>(xm, M, C, d, bd, u, bu, ascale, wsel, bsel,
                                   static_cast<bf16*>(adapt), logits, F, s);
}

}  // extern "C"
