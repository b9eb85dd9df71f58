// MoE-enhanced adapter and router head on the post-attention activation
// x_mid (fp32 rows xm of width C; E experts of bottleneck b, W = E*b):
//     gates  = softmax_e((xm . Wr) * fp32(1/tau))         max-subtracted, fp32
//     h      = max(bf16(xm) . Wd^T + bd, 0)                fp32 [rows, W]
//     hg     = bf16(h * gates[:, col / b])                 one rounding
//     adapt  = ((hg . Wu^T) + gates . Bu) * scale           -> residual dtype
//     logits = xm . wsel + bsel                            (fp32 xm and wsel)
// Wd [W, C] row e*b+j = down_kernel[e, :, j]; Wu [C, W] = up_kernel viewed as
// [W, C], transposed; Wr [E, C] fp32; Bu [E, C] fp32.
//
// Replaces, together with the attention sublayer chain (attention_sublayer.cu
// or quant.cu), the tail moe_adapter_rows of the TPU kernels
// dynamic_tuning_tpu/ops/mha_serving.py::dyt_prologue_serving_moe and
// dynamic_tuning_tpu/ops/quant.py::dyt_prologue_serving_q8_moe.
//
// Its gate-free mode (wr == NULL: one "expert" of width F, gate 1, bu one
// row) is the dense adapter/router tail at bf16 widths 128 < F <= 1024,
// padded to a multiple of 16 (ops/mha_serving.py::adapter_kernel_width):
//     adapt = (relu(bf16(xm) . Wd^T + bd) . Wu^T + bu) * scale,
//     logits = xm . wsel + bsel,  the bottleneck stored in bf16;
// with the sublayer chains it replaces the tail of the TPU kernels
// dynamic_tuning_tpu/ops/mha_serving.py::dyt_prologue_serving
// (_dyt_prologue_kernel) and quant.py::dyt_prologue_serving_q8 past the
// widths dyt_prologue.cu's kernel is built for (up to 128), its k16 steps
// chained in the tensor core as that kernel's (CHAIN).  There too the
// bytes bound it (at B = 32, F = 256: 29 MB of fp32 x_mid and bf16 adapt,
// 0.009 ms, against 5 GFLOP of bf16 products, 0.005 ms); the down pass of
// up to 256 columns and the H tile up to 1024 are the layouts below, and
// the router dots shrink to the token router's one.
//
// What bounds it on an H100.  At ViT-B serving shapes (M = 128*197 rows,
// C = 768, E = 4, b = 64) the two expert products are 4*M*C*W = 19.8 GFLOP of
// bf16 tensor work (~20 us at peak) while the kernel reads the fp32 x_mid
// (77 MB) and writes adapt (39 MB in bf16): ~35 us at 3.35 TB/s, bound by
// device-memory bytes.  Each block also pulls both expert stacks (2 * W * C
// bf16, 786 KB at W = 256) from L2 through shared memory.  The numerics add
// work of their own: every k16 tensor-core product is added to its sum with
// a round-to-nearest fp32 add (the sums then sit near the exact float64
// ones the plain version forms, and the int8 moe4 forward's gates agree with
// its plain version's; chained accumulation inside the tensor core took
// that agreement under 0.995), so both products cost one fp32 add per
// output element per 16 of depth (~620 M adds), and the router dots are
// summed in float64 (~100 M fp64 FMAs).
//
// What the design does about it.  The mma.sync form this replaces ran 24
// rounds of load -> __syncthreads -> compute a block, each round's latency
// in full view.  Now a persistent grid, one 384-thread block an SM, walks
// tiles of 64 rows, and:
//   * one producer thread (warpgroup 2, its registers given to the
//     consumers with setmaxnreg) keeps a ring of 2 to 4 stages (as
//     many as fit) in flight with TMA: for each 64-column chunk of x_mid,
//     the fp32 rows (two 32-column boxes, 128-byte swizzled) and the
//     matching 64 columns of up to 256 expert rows of Wd; then for each
//     64-column chunk of the output, the Wu rows over up to 256 of W; a
//     full and an empty mbarrier a stage pace it, and the next tile's
//     first chunks load while this one's up product runs;
//   * two consumer warpgroups share the tile's rows and run both products
//     on wgmma: the down product with bf16(x) as register A fragments (read
//     from the fp32 stage, rounded once) against the Wd rows K-major, each
//     warpgroup 128 of a pass's 256 columns of W; the up product with hg
//     from a 128-byte swizzled bf16 H tile in shared memory against the Wu
//     rows K-major, each warpgroup 32 of a chunk's 64 output columns.  Each
//     k16 step goes into a zeroed partial, added to its sum with __fadd_rn
//     in step order.  A warpgroup issues a batch of products (both pieces'
//     of one down step, four up steps), waits for all of them, then adds;
//     the other warpgroup's products run meanwhile (two alternating
//     partials, each read after a wait<1>, made ptxas serialize the wgmma
//     pipeline).  Past W = 256 the down product runs in passes over the
//     re-streamed x_mid;
//   * the router dots run on the fp32 stage in float64: four lanes a row,
//     16 columns each, up to 8 dots interleaved, added pairwise across the
//     quad, then to the row's sum (the mma.sync kernel's order, so gates
//     and logits are its bits).  The chunk's router weights, and in the
//     epilogue the Bu rows of the output chunk, are loaded one chunk ahead
//     and converted to float64 once a block into shared memory (loaded and
//     converted in every thread that reads them, the dots took 127 us of
//     the kernel's 308); the gates stay in float64 for the epilogue;
//   * the epilogue stores whole 16-byte pieces of rows through each warp's
//     staging rows (gemm.cuh's gemm_store_chunk).
// 64 rows a tile, not 128: a consumer thread then holds 64 down sums at
// W = 256 beside its partials and A fragments (128 rows took 128 sums,
// past the 232 registers setmaxnreg gives a consumer thread: that form
// spilled and ran slower than the mma.sync kernel), and 25216 rows make
// 394 tiles, three an SM.  The price is twice the expert stacks' L2
// traffic (~310 MB a call at W = 256).
// Past W = 512, up to 1024 (4 experts of 192, say, which the JAX kernels
// take as they take any ffn_num x moe_experts), the H tile alone takes 96
// to 128 KB, and the 256-column pass's 48 KB stages fit two at most up to
// W = 768.  Past that (or for many experts) the wide layout narrows the
// pass to 128 columns of W (a piece of 64 a warpgroup: 32 KB stages, x_mid
// re-streamed twice as often) and keeps one converted-weight buffer behind
// one more barrier a refill (MoePlan; the order is measured).  Every
// layout adds the same k16 products in the same order.
// The arithmetic is the mma.sync kernel's, step for step: the same k16
// products in the same order, one round-to-nearest add each, the same
// float64 sums and __fadd_rn / __fmul_rn rounding points, so nvcc contracts
// no rounding point away; the outputs are that kernel's bits.  Where it
// spends its time: utils/moe_tail_ablation.py (PERF.md).
#include "gemm.cuh"

namespace dyt {

constexpr int MOE_THREADS = 384;      // two consumer warpgroups + a producer
constexpr int MOE_CONSUMERS = 256;
constexpr int MOE_ROWS = 64;          // rows a tile
constexpr int MOE_CHUNK = 64;         // x_mid columns / output columns a step
constexpr int MOE_PASS = 256;         // columns of W a down pass covers up
                                      // to E*b = 512, and an up item
constexpr int MOE_MAX_STAGES = 4;
constexpr int MOE_NARROW_W = 512;     // past it the wide layouts (MoePlan)
constexpr int MOE_MAX_W = 1024;
constexpr int MOE_SMEM_LIMIT = 232448;   // a block's shared memory on sm_90

// rows of float64 weights converted at a time (router weights of the
// dots, Bu rows of the epilogue), in two alternating buffers (one with the
// 128-column pass)
constexpr int MOE_CVT = 8;
// a converted row: 64 values, 2 of padding after each 16 (the four lanes of
// a row read 16 columns each, on other banks)
constexpr int MOE_CV_ROW = 72;
__device__ __forceinline__ int cv_col(int c) { return c + (c >> 4) * 2; }

// The layout's free choices: the columns of W a down pass covers (its Wd
// box: 256, each consumer warpgroup two 64-column pieces of it, with two
// alternating converted-weight buffers; or 128, one piece each, with one
// buffer behind one more barrier a refill) and the ring's stages (2 to 4).
struct MoePlan {
  int pass, stages;
};

// Shared-memory layout for E experts, W columns and a plan: the ring (a
// stage: the fp32 x chunk [2][64 rows][32], then a Wd box [wbox][64] bf16
// or a Wu item [<= 4][64][64] bf16, all 128-byte swizzled), the H tile
// [w64 / 64][64 rows][64] bf16 (swizzled), the float64 router dots [E + 1]
// [64] (the first E rows then hold the gates, as float64), the converted
// weights [cv_bufs][MOE_CVT][MOE_CV_ROW] float64, each consumer warp's
// output staging rows (gemm.cuh's), then a full and an empty barrier a stage;
// offsets from the first 1024-byte boundary.  A stage holds an up item (up
// to four 64-column pieces of W: 32 KB) at either pass width.
struct MoeLayout {
  int w64, wbox, npass, nup, cv_bufs, stage, h_off, rd_off, cv_off, os_off,
      bar_off, bytes;
  __host__ __device__ MoeLayout(int E, int W, const MoePlan& plan) {
    w64 = (W + 63) / 64 * 64;
    wbox = w64 < plan.pass ? w64 : plan.pass;
    npass = (w64 + plan.pass - 1) / plan.pass;
    nup = (w64 + MOE_PASS - 1) / MOE_PASS;
    cv_bufs = plan.pass == MOE_PASS ? 2 : 1;
    stage = MOE_ROWS * MOE_CHUNK * 4 + wbox * 128;
    h_off = plan.stages * stage;
    rd_off = h_off + MOE_ROWS * w64 * 2;
    cv_off = rd_off + (E + 1) * MOE_ROWS * 8;
    os_off = cv_off + cv_bufs * MOE_CVT * MOE_CV_ROW * 8;
    bar_off = os_off + MOE_CONSUMERS / 32 * GEMM_OUT_STAGE;
    bytes = 1024 + bar_off + 2 * plan.stages * 8;
  }
};

template <int N>
__device__ __forceinline__ void add_rn(float (&acc)[N], const float (&p)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = __fadd_rn(acc[e], p[e]);
}

// PW: the 64-column pieces of W a consumer warpgroup takes a down pass (2:
// the 256-column pass, 1: the 128-column one).  CHAIN (the gate-free mode):
// the k16 steps of a stage chained in the tensor core, one wait a stage,
// as dyt_prologue.cu's adapter kernel sums, instead of each step's
// partial added round-to-nearest.
template <typename TO, int PW, bool CHAIN>
__global__ void __launch_bounds__(MOE_THREADS, 1)
moe_adapter_router_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_wd,
                          const __grid_constant__ CUtensorMap map_wu, int M,
                          int C, const float* __restrict__ wr,
                          const float* __restrict__ bd,
                          const float* __restrict__ bu,
                          const float* __restrict__ ascale,
                          const float* __restrict__ wsel,
                          const float* __restrict__ bsel,
                          TO* __restrict__ adapt, float* __restrict__ logits,
                          int E, int b, float inv_tau, MoePlan plan) {
  constexpr int XB = MOE_ROWS * 128;       // one 32-column x box
  constexpr int PPP = 2 * PW;              // 64-column pieces a pass
  const int W = E * b, stages = plan.stages;
  const MoeLayout L(E, W, plan);
  extern __shared__ unsigned char moe_smem_raw[];
  unsigned char* base = align1024(moe_smem_raw);
  unsigned char* Hs = base + L.h_off;
  double* Rd = reinterpret_cast<double*>(base + L.rd_off);   // [E+1][64]
  double* CV = reinterpret_cast<double*>(base + L.cv_off);   // [2][8][72]
  unsigned char* OS = base + L.os_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bar_off);
  uint64_t* empty = full + stages;
  const int tiles = (M + MOE_ROWS - 1) / MOE_ROWS, nk = C / MOE_CHUNK;
  const int npiece = L.w64 / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);                        // the producer's arrive
      mbar_init(&empty[s], MOE_CONSUMERS / 32);      // lane 0 of each warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= MOE_CONSUMERS) {
    // producer warpgroup: one thread issues every load, in the order the
    // consumers take them; its registers go to the consumers
    setmaxnreg_dec<40>();
    if (threadIdx.x == MOE_CONSUMERS) {
      int stage = 0, phase = 0;
      auto slot = [&](int bytes) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], bytes);
        return base + stage * L.stage;
      };
      auto advance = [&] {
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      };
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t * MOE_ROWS;
        for (int p = 0; p < L.npass; ++p)
          for (int k = 0; k < nk; ++k) {
            unsigned char* st = slot(2 * XB + L.wbox * 128);
            tma_load_2d(st, &map_x, &full[stage], k * MOE_CHUNK, m0);
            tma_load_2d(st + XB, &map_x, &full[stage], k * MOE_CHUNK + 32,
                        m0);
            tma_load_2d(st + 2 * XB, &map_wd, &full[stage], k * MOE_CHUNK,
                        p * PPP * 64);
            advance();
          }
        for (int n = 0; n < nk; ++n)
          for (int it = 0; it < L.nup; ++it) {
            const int nkb = min(4, npiece - 4 * it);
            unsigned char* st = slot(nkb * 64 * 128);
            for (int kb = 0; kb < nkb; ++kb)
              tma_load_2d(st + kb * 64 * 128, &map_wu, &full[stage],
                          it * MOE_PASS + kb * 64, n * MOE_CHUNK);
            advance();
          }
      }
    }
    return;
  }

  // consumer warpgroups: cg takes columns [64 PW cg, 64 PW (cg + 1)) of
  // each down pass and [32 cg, 32 cg + 32) of each output chunk
  setmaxnreg_inc<232>();
  const int ctid = threadIdx.x, cg = ctid >> 7, warp = (ctid >> 5) & 3;
  const int lane = ctid & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  const int r0 = warp * 16 + g;             // this thread's rows r0, r0 + 8
  const int NR = E + (wsel != nullptr);     // router dots a row
  const int R0 = wr != nullptr ? 0 : E;     // its first (gate-free: wsel)
  const int dr = ctid >> 2, dpart = ctid & 3;   // router: row, 16 columns
  const float s_ad = ascale[0];
  // Weights converted to float64 once a block: rows e0 .. e0 + n - 1
  // (n <= MOE_CVT) of a chunk's 64 columns of the router weights (row E is
  // wsel) or of Bu, two values a thread, loaded ahead (load_w, load_b) and
  // stored to the next CV buffer behind a barrier (store_cv)
  auto load_w = [&](int kc, int e0, int n, float (&v)[2]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = ctid + j * MOE_CONSUMERS, e = e0 + i / MOE_CHUNK;
      v[j] = i < n * MOE_CHUNK
                 ? __ldg((e < E ? wr + (size_t)e * C : wsel) +
                         kc * MOE_CHUNK + i % MOE_CHUNK)
                 : 0.f;
    }
  };
  auto load_b = [&](int nc, int e0, int n, float (&v)[2]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = ctid + j * MOE_CONSUMERS;
      v[j] = i < n * MOE_CHUNK
                 ? __ldg(bu + (size_t)(e0 + i / MOE_CHUNK) * C +
                         nc * MOE_CHUNK + i % MOE_CHUNK)
                 : 0.f;
    }
  };
  int cvb = 0;
  auto store_cv = [&](const float (&v)[2], int n) {
    double* buf = CV + cvb * MOE_CVT * MOE_CV_ROW;
    if (PW == 1)
      consumer_sync();            // one buffer: every reader is done with it
    else
      cvb ^= 1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = ctid + j * MOE_CONSUMERS;
      if (i < n * MOE_CHUNK)
        buf[i / MOE_CHUNK * MOE_CV_ROW + cv_col(i % MOE_CHUNK)] = v[j];
    }
    consumer_sync();
    return static_cast<const double*>(buf);
  };
  float wpre[2], bpre[2];
  int stage = 0, phase = 0;
  auto wait_full = [&] {
    mbar_wait(&full[stage], phase);
    return static_cast<const unsigned char*>(base + stage * L.stage);
  };
  auto release = [&] {
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  };

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t * MOE_ROWS;
    if (dpart == 0)
      for (int e = 0; e < NR; ++e) Rd[e * MOE_ROWS + dr] = 0.0;

    // --- down product (+ router dots on the first pass) -------------------
    for (int p = 0; p < L.npass; ++p) {
      // acc[q]: piece PPP p + PW cg + q of W (64 columns); a piece past W
      // is computed on piece 0's rows and dropped
      float acc[PW][32];
#pragma unroll
      for (int q = 0; q < PW; ++q)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[q][e] = 0.f;
      int wd_row[PW];
#pragma unroll
      for (int q = 0; q < PW; ++q)
        wd_row[q] = PPP * p + PW * cg + q < npiece ? PW * cg + q : 0;
      for (int k = 0; k < nk; ++k) {
        const unsigned char* st = wait_full();
        const unsigned char* wd = st + 2 * XB;
        // router dots in float64 over the fp32 chunk (fp32 products are
        // exact there): this lane's 16 columns of its row against the
        // chunk's router weights (converted once a block, loaded a chunk
        // ahead), up to 8 dots interleaved; the four lanes of the row add
        // up pairwise, then to the row's sum
        auto dots = [&] {
          if (k == 0) load_w(0, R0, min(MOE_CVT, NR - R0), wpre);
          double xd[16];
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const float4 v = *reinterpret_cast<const float4*>(
                st + (dpart >> 1) * XB +
                sw128(dr, (dpart & 1) * 16 + 4 * f, 4));
            xd[4 * f] = v.x;
            xd[4 * f + 1] = v.y;
            xd[4 * f + 2] = v.z;
            xd[4 * f + 3] = v.w;
          }
          for (int e0 = R0; e0 < NR; e0 += MOE_CVT) {
            const int n = min(MOE_CVT, NR - e0);
            if (e0 > R0) load_w(k, e0, n, wpre);
            const double* w = store_cv(wpre, n) + dpart * 18;
            double sd[MOE_CVT];
#pragma unroll
            for (int i = 0; i < MOE_CVT; ++i) sd[i] = 0.0;
#pragma unroll
            for (int c = 0; c < 8; ++c)
#pragma unroll
              for (int i = 0; i < MOE_CVT; ++i)
                if (i < n) {
                  const double2 w2 = *reinterpret_cast<const double2*>(
                      w + i * MOE_CV_ROW + 2 * c);
                  sd[i] = fma(xd[2 * c], w2.x, sd[i]);
                  sd[i] = fma(xd[2 * c + 1], w2.y, sd[i]);
                }
#pragma unroll
            for (int i = 0; i < MOE_CVT; ++i) {
              if (i < n) {
                sd[i] += __shfl_xor_sync(0xffffffffu, sd[i], 1);
                sd[i] += __shfl_xor_sync(0xffffffffu, sd[i], 2);
                if (dpart == 0) Rd[(e0 + i) * MOE_ROWS + dr] += sd[i];
              }
            }
          }
          if (k + 1 < nk) load_w(k + 1, R0, min(MOE_CVT, NR - R0), wpre);
        };
        if (p == 0 && NR > R0) dots();
        // bf16(x) of this thread's rows as wgmma A fragments, one per k16
        // step of the chunk
        unsigned af[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + (e & 1) * 8, c = kk * 16 + t2 + (e >> 1) * 8;
            const float2 v = *reinterpret_cast<const float2*>(
                st + (c >> 5) * XB + sw128(r, c & 31, 4));
            af[kk][e] = pack_bf16x2(v.x, v.y);
          }
        // per k16 step, both pieces' products into zeroed partials, then
        // each added to its sum once they are done (CHAIN: the chunk's four
        // steps chained into the sums)
        float pd[PW][32];
        if constexpr (CHAIN) {
#pragma unroll
          for (int q = 0; q < PW; ++q) fence_regs(acc[q]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int q = 0; q < PW; ++q)
              wgmma_rs<64, false>(
                  acc[q], af[kk],
                  desc_sw128(wd + wd_row[q] * 64 * 128 + kk * 32), 1);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int q = 0; q < PW; ++q) fence_regs(acc[q]);
        }
#pragma unroll
        for (int kk = 0; kk < (CHAIN ? 0 : 4); ++kk) {
#pragma unroll
          for (int q = 0; q < PW; ++q) fence_regs(pd[q]);
          wgmma_fence();
#pragma unroll
          for (int q = 0; q < PW; ++q)
            wgmma_rs<64, false>(
                pd[q], af[kk],
                desc_sw128(wd + wd_row[q] * 64 * 128 + kk * 32), 0);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int q = 0; q < PW; ++q) fence_regs(pd[q]);
#pragma unroll
          for (int q = 0; q < PW; ++q) add_rn(acc[q], pd[q]);
        }
        release();
      }

      if (p == 0) {
        // expert softmax per row (max-subtracted, IEEE exp and division)
        // by the lane that summed the row's dots; the fp32 steps kept in
        // the row's float64 slots, the gates left there (gate-free: one
        // gate of 1)
        if (dpart == 0) {
          if (wsel != nullptr && m0 + dr < M)
            logits[m0 + dr] =
                __fadd_rn((float)Rd[E * MOE_ROWS + dr], bsel[0]);
          if (wr == nullptr) Rd[dr] = 1.0;
        }
        if (dpart == 0 && wr != nullptr) {
          float mx = -INFINITY;
          for (int e = 0; e < E; ++e) {
            const float v = __fmul_rn((float)Rd[e * MOE_ROWS + dr], inv_tau);
            Rd[e * MOE_ROWS + dr] = v;
            mx = fmaxf(mx, v);
          }
          float sum = 0.f;
          for (int e = 0; e < E; ++e) {
            const float ex =
                expf(__fadd_rn((float)Rd[e * MOE_ROWS + dr], -mx));
            Rd[e * MOE_ROWS + dr] = ex;
            sum = __fadd_rn(sum, ex);
          }
          for (int e = 0; e < E; ++e)
            Rd[e * MOE_ROWS + dr] =
                __fdiv_rn((float)Rd[e * MOE_ROWS + dr], sum);
        }
        consumer_sync();
      }

      // bottleneck: bf16(relu(down + bd) * gate) -> H
#pragma unroll
      for (int q = 0; q < PW; ++q) {
        const int P = PPP * p + PW * cg + q;
        if (P >= npiece) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = P * 64 + j * 8 + t2;
          if (c >= W) continue;
          const float b0 = bd[c], b1 = bd[c + 1];
          const int e0 = c / b, e1 = (c + 1) / b;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = r0 + hh * 8;
            const float h0 = fmaxf(__fadd_rn(acc[q][4 * j + 2 * hh], b0), 0.f);
            const float h1 =
                fmaxf(__fadd_rn(acc[q][4 * j + 2 * hh + 1], b1), 0.f);
            store2(reinterpret_cast<bf16*>(Hs + P * MOE_ROWS * 128 +
                                           sw128(r, c & 63, 2)),
                   __fmul_rn(h0, (float)Rd[e0 * MOE_ROWS + r]),
                   __fmul_rn(h1, (float)Rd[e1 * MOE_ROWS + r]));
          }
        }
      }
    }
    fence_proxy_async();          // H visible to the tensor cores
    consumer_sync();

    // --- up product per 64 output columns: (H . Wu^T + gates . Bu) * scale
    const int nks = W / 16;       // k16 steps over W
    for (int n = 0; n < nk; ++n) {
      float u[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) u[e] = 0.f;
      load_b(n, 0, min(MOE_CVT, E), bpre);     // under the products
      for (int it = 0; it < L.nup; ++it) {
        const unsigned char* wu = wait_full();
        const int ks0 = it * 16, cnt = min(16, nks - ks0);
        // four k16 steps at a time: H's steps ks0 + s against the item's
        // Wu rows of this warpgroup's 32 columns, into zeroed partials,
        // added in order once all four are done (a step past W reads the
        // H tile's unwritten columns against zero rows of Wu, and is not
        // added)
        float pu[4][16];
        if constexpr (CHAIN) {        // the item's steps chained into u
          fence_regs(u);
          wgmma_fence();
          for (int s = 0; s < cnt; ++s) {
            const int ks = ks0 + s;
            wgmma_ss<32>(
                u, desc_sw128(Hs + (ks >> 2) * MOE_ROWS * 128 + (ks & 3) * 32),
                desc_sw128(wu + (s >> 2) * 64 * 128 + cg * 32 * 128 +
                           (s & 3) * 32),
                1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(u);
        }
        for (int s0 = 0; s0 < (CHAIN ? 0 : cnt); s0 += 4) {
#pragma unroll
          for (int i = 0; i < 4; ++i) fence_regs(pu[i]);
          wgmma_fence();
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int s = s0 + i, ks = ks0 + s;
            wgmma_ss<32>(
                pu[i],
                desc_sw128(Hs + (ks >> 2) * MOE_ROWS * 128 + (ks & 3) * 32),
                desc_sw128(wu + (s >> 2) * 64 * 128 + cg * 32 * 128 +
                           (s & 3) * 32),
                0);
          }
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            fence_regs(pu[i]);
            if (s0 + i < cnt) add_rn(u, pu[i]);
          }
        }
        release();
      }
      // gates . Bu: E products summed in float64 (Bu rows converted once a
      // block, the gates kept in float64), rounded once
      double ub[4][2][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) ub[j][hh][0] = ub[j][hh][1] = 0.0;
      for (int e0 = 0; e0 < E; e0 += MOE_CVT) {
        const int ne = min(MOE_CVT, E - e0);
        if (e0 > 0) load_b(n, e0, ne, bpre);
        const double* bw = store_cv(bpre, ne);
        for (int i = 0; i < ne; ++i) {
          const double g0 = Rd[(e0 + i) * MOE_ROWS + r0];
          const double g1 = Rd[(e0 + i) * MOE_ROWS + r0 + 8];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const double2 bb = *reinterpret_cast<const double2*>(
                bw + i * MOE_CV_ROW + cv_col(cg * 32 + j * 8 + t2));
            ub[j][0][0] = fma(g0, bb.x, ub[j][0][0]);
            ub[j][0][1] = fma(g0, bb.y, ub[j][0][1]);
            ub[j][1][0] = fma(g1, bb.x, ub[j][1][0]);
            ub[j][1][1] = fma(g1, bb.y, ub[j][1][1]);
          }
        }
      }
      // (u + gates . Bu) * scale, out through the warp's staging rows as
      // whole 16-byte pieces of rows
      float v[4][2][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            v[j][hh][q] = __fmul_rn(
                __fadd_rn(u[4 * j + 2 * hh + q], (float)ub[j][hh][q]), s_ad);
      gemm_store_chunk<TO>(v, adapt, OS + (ctid >> 5) * GEMM_OUT_STAGE,
                           m0 + warp * 16, n * MOE_CHUNK + cg * 32, M, C,
                           lane);
    }
    consumer_sync();              // H, Rd and CV free for the next tile
  }
}

// The plan for E experts and W columns: the 256-column pass with the most
// stages (2 to 4) whose layout fits a block; past E*b = MOE_NARROW_W, where
// none does (W = 1024, or many experts), the 128-column pass likewise; false
// where none fits.  Measured once with the layout forced (PERF.md): the
// 256-column pass ran ~10% under the 128-column one at W = 768; the stage
// count (2 or 3) and a second converted-weight buffer made no difference
// past 1% for the 128-column pass.
inline bool moe_plan(int E, int W, MoePlan* plan) {
  const int passes[2] = {MOE_PASS, 128};
  for (const int pass : passes) {
    if (pass != MOE_PASS && W <= MOE_NARROW_W) break;
    for (int s = MOE_MAX_STAGES; s >= 2; --s) {
      const MoePlan p{pass, s};
      if (MoeLayout(E, W, p).bytes <= MOE_SMEM_LIMIT) {
        *plan = p;
        return true;
      }
    }
  }
  return false;
}

template <typename TO>
static cudaError_t moe(const float* xm, int M, int C, const float* wr,
                       const bf16* wd, const float* bd, const bf16* wu,
                       const float* bu, const float* ascale, const float* wsel,
                       const float* bsel, TO* adapt, float* logits, int E,
                       int b, float inv_tau, cudaStream_t st) {
  const int W = E * b;
  MoePlan plan;
  if (!moe_plan(E, W, &plan)) return cudaErrorInvalidValue;
  if (M <= 0) return cudaSuccess;
  const MoeLayout L(E, W, plan);
  // x_mid read in [32 columns, 64 rows] fp32 boxes, Wd in [64, wbox] and Wu
  // in [64, 64] bf16 boxes, all 128-byte swizzled; zeros past each edge
  CUtensorMap map_x, map_wd, map_wu;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(C),
                               static_cast<cuuint64_t>(M)};
  const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(C) * 4};
  const cuuint32_t xbox[2] = {32, MOE_ROWS};
  cudaError_t err = tensor_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, xm, 2,
                               xdims, xstride, xbox);
  if (err != cudaSuccess) return err;
  const cuuint64_t ddims[2] = {static_cast<cuuint64_t>(C),
                               static_cast<cuuint64_t>(W)};
  const cuuint64_t dstride[1] = {static_cast<cuuint64_t>(C) * 2};
  const cuuint32_t dbox[2] = {64, static_cast<cuuint32_t>(L.wbox)};
  err = tensor_map(&map_wd, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, wd, 2, ddims,
                   dstride, dbox);
  if (err != cudaSuccess) return err;
  const cuuint64_t udims[2] = {static_cast<cuuint64_t>(W),
                               static_cast<cuuint64_t>(C)};
  const cuuint64_t ustride[1] = {static_cast<cuuint64_t>(W) * 2};
  const cuuint32_t ubox[2] = {64, 64};
  err = tensor_map(&map_wu, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, wu, 2, udims,
                   ustride, ubox);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  auto kernel =
      wr == nullptr
          ? (plan.pass == MOE_PASS ? moe_adapter_router_kernel<TO, 2, true>
                                   : moe_adapter_router_kernel<TO, 1, true>)
          : (plan.pass == MOE_PASS ? moe_adapter_router_kernel<TO, 2, false>
                                   : moe_adapter_router_kernel<TO, 1, false>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L.bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (M + MOE_ROWS - 1) / MOE_ROWS;
  kernel<<<tiles < sms ? tiles : sms, MOE_THREADS, L.bytes, st>>>(
      map_x, map_wd, map_wu, M, C, wr, bd, bu, ascale, wsel, bsel, adapt,
      logits, E, b, inv_tau, plan);
  return cudaGetLastError();
}

}  // namespace dyt

extern "C" {

// Expert counts and widths the MoE kernel takes: E >= 2, W = E*b a multiple
// of 16 and at most 1024 (where a layout fits: dyt_moe_smem_bytes).
int dyt_moe_width_supported(int E, int b) {
  const int W = E * b;
  return E >= 2 && b >= 1 && W % 16 == 0 && W <= dyt::MOE_MAX_W;
}

// Dynamic shared memory of one block of the layout the kernel takes for E
// experts of width b; where none fits, of the smallest (past the card's
// 227 KB: the wrapper checks it).
int dyt_moe_smem_bytes(int E, int b) {
  const int W = E * b;
  dyt::MoePlan plan;
  if (dyt::moe_plan(E, W, &plan)) return dyt::MoeLayout(E, W, plan).bytes;
  return dyt::MoeLayout(E, W, W <= dyt::MOE_NARROW_W
                                  ? dyt::MoePlan{dyt::MOE_PASS, 2}
                                  : dyt::MoePlan{128, 2})
      .bytes;
}

// xm: fp32 [M, C] x_mid (C % 64 == 0); wr [E, C] fp32; wd [E*b, C] and
// wu [C, E*b] bf16; bd [E*b], bu [E, C], ascale [1] fp32; wsel [C] and
// bsel [1] fp32, or wsel == NULL to skip the router head; adapt [M, C] in the
// residual dtype (adapt_f32 selects fp32 over bf16); logits fp32 [M];
// inv_tau the fp32 value of 1/tau.  xm, wd, wu, wr, wsel and bu on 16 bytes.
// wr == NULL is the gate-free mode, the dense adapter's tail past the
// widths of dyt_prologue.cu's kernel: E == 1, b = F a multiple of 16 up to
// 1024, bu [C], every row's one gate 1 (inv_tau unused), the k16 steps
// chained in the tensor core.  Returns a cudaError_t value.
int dyt_moe_adapter_router(const float* xm, int M, int C, const float* wr,
                           const void* wd, const float* bd, const void* wu,
                           const float* bu, const float* ascale,
                           const float* wsel, const float* bsel, void* adapt,
                           int adapt_f32, float* logits, int E, int b,
                           float inv_tau, void* stream) {
  using dyt::bf16;
  const bool ok = wr != nullptr ? dyt_moe_width_supported(E, b)
                                : E == 1 && b > 0 && b % 16 == 0 &&
                                      b <= dyt::MOE_MAX_W;
  if (!ok || C % 64) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* d = static_cast<const bf16*>(wd);
  auto* u = static_cast<const bf16*>(wu);
  if (adapt_f32)
    return dyt::moe<float>(xm, M, C, wr, d, bd, u, bu, ascale, wsel, bsel,
                           static_cast<float*>(adapt), logits, E, b, inv_tau,
                           s);
  return dyt::moe<bf16>(xm, M, C, wr, d, bd, u, bu, ascale, wsel, bsel,
                        static_cast<bf16*>(adapt), logits, E, b, inv_tau, s);
}

}  // extern "C"
