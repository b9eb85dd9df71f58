// Pre-norm attention sublayer of the serving path:
//     out = x + proj(attn_core(qkv(LN(x))))
//
// Replaces the TPU kernel dynamic_tuning_tpu/ops/mha_serving.py::
// attention_sublayer_serving (_attn_sublayer_kernel, with its shared core
// attn_core_pairs) and forms the first four steps of dyt_prologue_serving
// (see dyt_prologue.cu).  Its core kernel, entered alone through
// dyt_mha_core, also replaces two more TPU kernels of that file:
// mha_serving_fused (K1, _mha_fused_kernel: raw qkv in, [B, N, C] out) and
// mha_serving (K15, _mha_kernel: pre-split [B, H, N, hd] q, k, v, with the
// unfused branch's rounding); quant.cu's int8 chains (K5, K6, K8) run it
// through dyt_attn_core.  The core reads q, k and v through element
// strides, so K1 and K15 need no transposes around them, and K15 writes
// [B, N, H, hd] memory that the output projection reads as [B, N, C].
//
// What bounds it on an H100.  At ViT-B/16 serving shapes (B=128, N=197,
// C=768, 12 heads of 64) the sublayer does ~0.12 TFLOP of qkv/proj GEMM and
// ~0.015 TFLOP of attention products per block (0.12 ms at the 989 TFLOP/s
// bf16 peak), plus one exp per score (60 M per block).  The TPU kernel
// kept every intermediate in VMEM; the chain below moves the bf16 LN rows,
// qkv buffer and core output through device memory, ~0.5 GB per block
// (0.15 ms at 3.35 TB/s).  Alone, the core moves 155 MB (0.046 ms) for
// 15.3 GFLOP (0.015 ms): bytes bound it on paper; on the card the
// per-score instructions (clamp, an accurate expf, l, the bf16 packing) and
// the loads each block waits for at its start take as long.
//
// What the design does about it.  Four kernels on the caller's stream,
// each following the TPU kernel's rounding points exactly:
//   1. layernorm_bf16_kernel (common.cuh) -- one warp per row, fp32
//      two-pass LN (mean, then mean of centred squares, eps 1e-6), rounded
//      once to bf16;
//   2. gemm_nt_kernel<EPI_BIAS_BF16> (gemm.cuh: TMA ring, wgmma, a
//      persistent grid) -- LN rows x Wqkv^T, fp32 accumulation, + bqkv in
//      fp32, one rounding to bf16;
//   3. attn_core_kernel -- one warpgroup per (sample, head): the head's K
//      and V are staged once into 128-byte swizzled shared-memory tiles,
//      then each 64-row query tile takes its keys in chunks: S = Q K^T on
//      wgmma with q' in registers, the clamped exp and l in registers,
//      P V on wgmma with p as register fragments against V read N-major.
//      The serving softmax has no row max (e = exp(clip(s, -60, 80) - 20)),
//      so each key chunk is final when it is computed: no rescaling, no
//      [N, N] tile anywhere.  Up to 256 keys the whole row is one chunk
//      (one Q K^T and one P V chain a tile: fewer waits than 64-key chunks,
//      measured faster); past that, 64-key chunks are software-pipelined.
//      Past the N whose K and V fit a block's shared memory (864 at hd 64,
//      416 at hd 128), attn_core_ring_kernel runs instead: one warpgroup a
//      (query tile, head, sample) walking 64-key tiles of K and V that TMA
//      brings into a ring, with the same per-chunk math and order;
//   4. gemm_nt_kernel<EPI_RESIDUAL> -- core x Wproj^T + x + bproj in fp32,
//      written in the residual dtype (and as an fp32 copy for the DyT
//      prologue's adapter/router, which read x_mid in fp32).
// Fusing the chain (the core inside the qkv GEMM's epilogue) is later work.
#include "gemm.cuh"

extern "C" int dyt_simt_core(const void* q, const void* k, const void* v,
                             void* out, const long long* strides, int B,
                             int N, int H, int hd, float scale, int t_f32,
                             int k15, const void* bias, long long bias_head,
                             long long bias_row, void* stream);

namespace dyt {

// ---------------------------------------------------------------------------
// The attention core, one (sample, head) per block, on q, k and v given by
// element strides in (batch, head, row) with unit stride along hd: the raw
// [B, N, 3C] qkv buffer ([q|k|v] x head x hd columns), pre-split
// [B, H, N, hd] tensors or views of either.  The output has strides of its
// own: [B, N, C] for the sublayer chain and K1, [B, N, H, hd] memory for
// K15.  Per query row, in the K1 mode (the TPU kernels' core, K15 = false):
//   q' = bf16(q * scale);  s = q' . k (fp32);  e = exp(clip(s,-60,80) - 20)
//   l = sum(e) in fp32;    o = (bf16(e) @ v in fp32) * (1 / l) -> bf16
// and in the K15 mode (ops/mha_serving.py::mha_serving, the rounding of the
// unfused XLA branch and of the speed-test forward):
//   q' = bf16(q * bf16(scale));  p = bf16(e);  l = sum(p) in fp32;
//   o = (p @ v in fp32) / l (an IEEE division) -> bf16

constexpr int CORE_THREADS = 128;   // one warpgroup a block
constexpr int CORE_STREAM_KEYS = 64;   // keys a chunk past 256 keys

// K and V of a head in 128-byte swizzled tiles [HD / 64][rows][64], rows =
// N rounded up to 16 (zeros past N), then a 64-row Q tile in rows of
// HD + 8 elements (the bank skew of its fragment reads).  Q K^T runs over
// chunks of KC keys (208 or 256: the whole row at N <= 256; else 64): the
// last chunk reads rows past the end of K's last 64-column block, which
// land in V, or in slack past it for short heads, and give scores that are
// masked.
template <int HD, int KC>
struct CoreLayout {
  static constexpr int LDQ = HD + 8;
  __host__ __device__ static int rows(int N) { return (N + 15) / 16 * 16; }
  __host__ __device__ static int tile(int N) { return rows(N) * HD * 2; }
  // bytes from K's start to the Q tile's
  __host__ __device__ static int q_offset(int N) {
    const int over = ((N + KC - 1) / KC * KC - rows(N)) * 128;
    return tile(N) + (tile(N) > over ? tile(N) : over);
  }
  static int smem_bytes(int N) { return 1024 + q_offset(N) + 64 * LDQ * 2; }
};

// Element strides (batch, head, row) of q, k, v and out.
struct CoreArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  long long sq[3], sk[3], sv[3], so[3];
  int N, H;
  float scale;
};

// One warpgroup per (sample, head), K and V staged once.  Per 64-row query
// tile, warp w owns rows 16 w .. 16 w + 15 and thread (g = lane/4, t =
// lane%4) rows g and g + 8: q' is built in registers straight in wgmma's A
// layout from the tile's rows in shared memory (the next tile's rows are
// copied in while this one computes).  Then, per chunk of KC keys, S = q'
// K^T (wgmma, A from registers, K K-major), the clamped exp and l in
// registers, and P V (wgmma, p from registers, V N-major).  At N <= 256
// (KC = 208 or 256) a tile's whole score row is one chunk: one Q K^T chain
// and one P V chain a tile.  Past 256 keys (KC = 64) the chunks are
// software-pipelined over two score buffers: chunk kc + 1's Q K^T runs
// while chunk kc's exp runs, and chunk kc's P V while the next scores are
// awaited.  Only the last chunk masks keys past N, and skips its 8-key
// tiles past the padded rows.  A warp whose 16 rows lie past N skips the
// exp and feeds P = 0.  The exp is expf: ex2.approx of x log2 e (K13's
// form) is ~10% faster here but its rounded argument moves e by ~20 fp32
// ulps, and the int8 dispatch forward's gate agreement with its plain
// version then fell under chip_smoke.py's 0.995.
template <int HD, int KC, bool K15>
__global__ void __launch_bounds__(CORE_THREADS,
                                  HD == 64 && KC <= 208 ? 3 : 2)
attn_core_kernel(const CoreArgs a) {
  using L = CoreLayout<HD, KC>;
  constexpr bool STREAM = KC == CORE_STREAM_KEYS;
  constexpr int DK = HD / 16;          // k16 steps of Q K^T
  constexpr int NS = KC / 2;           // score accumulators a thread
  constexpr int PS = KC / 16;          // k16 steps of P V a chunk
  extern __shared__ unsigned char smem_raw[];
  const int N = a.N, np = L::rows(N);
  const int nkc = (N + KC - 1) / KC, nq = (N + 63) / 64;
  unsigned char* Kt = align1024(smem_raw);
  unsigned char* Vt = Kt + L::tile(N);
  bf16* Qs = reinterpret_cast<bf16*>(Kt + L::q_offset(N));

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const bf16* qb = a.q + b * a.sq[0] + h * a.sq[1];
  const bf16* kb = a.k + b * a.sk[0] + h * a.sk[1];
  const bf16* vb = a.v + b * a.sv[0] + h * a.sv[1];
  bf16* ob = a.o + b * a.so[0] + h * a.so[1];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;

  // rows qt * 64 .. + 63 of q into Qs (zeros past N)
  auto stage_q = [&](int qt) {
    for (int i = tid; i < 64 * (HD / 8); i += CORE_THREADS) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      const int n = qt * 64 + r;
      cp_async16(Qs + r * L::LDQ + c, n < N ? qb + n * a.sq[2] + c : qb,
                 n < N ? 16 : 0);
    }
  };
  // groups: K, the first Q tile, V -- so that waiting for all but the
  // newest leaves only V in flight
  stage_sw128<HD>(Kt, kb, a.sk[2], 0, np, N, tid, CORE_THREADS);
  cp_async_commit();
  stage_q(0);
  cp_async_commit();
  stage_sw128<HD>(Vt, vb, a.sv[2], 0, np, N, tid, CORE_THREADS);
  cp_async_commit();
  // K15 takes the scale as XLA does a weak-typed Python float times a bf16
  // array: rounded to bf16 first
  const float scale =
      K15 ? __bfloat162float(__float2bfloat16_rn(a.scale)) : a.scale;

  for (int qt = 0; qt < nq; ++qt) {
    const int n_lo = qt * 64 + warp * 16 + g, n_hi = n_lo + 8;
    const bool live = qt * 64 + warp * 16 < N;     // the same for the warp
    if (qt == 0) {
      cp_async_wait<1>();          // K and this Q tile (V may be in flight)
      fence_proxy_async();         // K visible to the tensor cores
    } else {
      cp_async_wait<0>();          // the Q tile copied in last time
    }
    __syncthreads();
    // q rows scaled in fp32 and rounded to bf16 before Q K^T, read straight
    // into the A-operand layout
    unsigned qf[DK][4];
#pragma unroll
    for (int d = 0; d < DK; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = warp * 16 + g + (e & 1) * 8;
        const float2 q =
            load2(Qs + r * L::LDQ + d * 16 + t2 + (e >> 1) * 8);
        qf[d][e] = pack_bf16x2(q.x * scale, q.y * scale);
      }
    }
    __syncthreads();               // every warp has read this Q tile
    if (qt + 1 < nq) stage_q(qt + 1);
    cp_async_commit();
    float o[HD / 2];
    float l_lo = 0.f, l_hi = 0.f;

    // Q K^T of key chunk kc into s
    auto qk = [&](float (&s)[NS], int kc) {
#pragma unroll
      for (int d = 0; d < DK; ++d)
        wgmma_rs<KC, false>(s, qf[d],
                            desc_sw128(Kt + (d / 4) * np * 128 +
                                       kc * KC * 128 + (d % 4) * 32),
                            d > 0);
    };
    // chunk kc, its scores in s: (streaming) the next chunk's Q K^T issued,
    // then e = exp(clip(s, -60, 80) - 20) in place (keys past N give 0), l,
    // and P V issued.  Element 4 j + e of s is key kc * KC + 8 j + t2 +
    // (e & 1).
    auto chunk = [&](float (&s)[NS], float (&nxt)[NS], int kc) {
      if (STREAM && kc + 1 < nkc) {
        wgmma_fence();
        qk(nxt, kc + 1);
        wgmma_commit();
        wgmma_wait<1>();           // this chunk's scores (and P V before)
      } else {
        wgmma_wait<0>();
      }
      unsigned pf[PS][4];
      if (live) {
        const bool last = kc * KC + KC > N;
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) {
          // keys past the padded rows: P V never reads them
          if (last && kc * KC + j * 8 >= np) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = expf(fminf(fmaxf(s[4 * j + e], -60.f), 80.f) - 20.f);
            if (last && kc * KC + j * 8 + t2 + (e & 1) >= N) p = 0.f;
            // K15's l sums the bf16 p that the AV product reads; K1's the
            // fp32 e
            if constexpr (K15) p = __bfloat162float(__float2bfloat16_rn(p));
            s[4 * j + e] = p;
          }
          l_lo += s[4 * j] + s[4 * j + 1];
          l_hi += s[4 * j + 2] + s[4 * j + 3];
        }
        // the A fragments of P V, one per 16 keys (two n8 score tiles)
#pragma unroll
        for (int st = 0; st < PS; ++st) {
          pf[st][0] = pack_bf16x2(s[8 * st], s[8 * st + 1]);
          pf[st][1] = pack_bf16x2(s[8 * st + 2], s[8 * st + 3]);
          pf[st][2] = pack_bf16x2(s[8 * st + 4], s[8 * st + 5]);
          pf[st][3] = pack_bf16x2(s[8 * st + 6], s[8 * st + 7]);
        }
      } else {
#pragma unroll
        for (int st = 0; st < PS; ++st)
          pf[st][0] = pf[st][1] = pf[st][2] = pf[st][3] = 0u;
      }
      if (qt == 0 && kc == 0) {
        cp_async_wait<1>();        // V (the newest group is the next Q tile)
        fence_proxy_async();
        __syncthreads();
      }
      // P V over this chunk's 16-key steps inside the padded rows
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < PS; ++st) {
        const int r = kc * KC + st * 16;
        if (r < np)
          wgmma_rs<HD, true>(o, pf[st], desc_sw128_mn(Vt + r * 128, np * 128),
                             r > 0);
      }
      wgmma_commit();
    };

    if constexpr (STREAM) {
      float sa[NS], sb[NS];
      wgmma_fence();
      qk(sa, 0);
      wgmma_commit();
      for (int kc = 0; kc < nkc; kc += 2) {
        chunk(sa, sb, kc);
        if (kc + 1 < nkc) chunk(sb, sa, kc + 1);
      }
    } else {
      float s[NS];
      wgmma_fence();
      qk(s, 0);
      wgmma_commit();
      chunk(s, s, 0);
    }
    wgmma_wait<0>();
    if (!live) continue;

    // each row's l is spread over the four lanes of its quad
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, m);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, m);
    }
    // K1: o * (1 / l); K15: o / l, the IEEE quotient from the rounded
    // reciprocal (div_rn_by)
    const float inv_lo = __frcp_rn(l_lo), inv_hi = __frcp_rn(l_hi);
    auto out = [&](float x, float l, float r) {
      return K15 ? div_rn_by(x, l, r) : x * r;
    };
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = j * 8 + t2;
      if (n_lo < N)
        store2(ob + n_lo * a.so[2] + col, out(o[4 * j], l_lo, inv_lo),
               out(o[4 * j + 1], l_lo, inv_lo));
      if (n_hi < N)
        store2(ob + n_hi * a.so[2] + col, out(o[4 * j + 2], l_hi, inv_hi),
               out(o[4 * j + 3], l_hi, inv_hi));
    }
  }
}

// ---------------------------------------------------------------------------
// The core past the N whose K and V fit shared memory (the staged kernel's
// layout needs more than a block's 227 KB from N = 865 at hd 64, 417 at hd
// 128).  A block is one warpgroup owning 64 query rows of one (sample,
// head); it walks K and V in tiles of CORE_STREAM_KEYS keys, in the order
// and with the per-chunk math of the staged kernel's 64-key chunks: Q K^T
// on wgmma (q' in registers), e = exp(clip(s, -60, 80) - 20) with expf,
// l over the fp32 e (K1) or the bf16 p (K15), P V on wgmma with the first
// 16-key step of the first tile starting the sum.  So l and o sum in the
// same order as the staged kernel's.
//   * TMA brings each tile's K and V ([HD / 64][64 keys][64], 128-byte
//     swizzled, as the staged kernel's chunks lie) into a ring of two
//     stages paced by a full and an empty mbarrier a stage; thread 0 issues
//     tile i + 2 once every warp is past tile i (K9's ring,
//     windowed_attention.cu, without the bias block).  TMA rather than
//     cp.async: one thread issues a tile, the warps spend no instructions
//     or registers on addresses, and the tensor map keeps strides: K and V
//     are read through 4-D maps [B][H][N][HD] (innermost last) built from
//     the element strides, so the raw [B, N, 3C] qkv, views of it and
//     contiguous [B, H, N, hd] tensors all go through the same map, and no
//     tile reads past its own (sample, head).
//   * TMA fills keys past N with zeros; their p is masked to 0, so they add
//     exact zeros to l and o.
//   * The grid is (query tile, head, sample): at B = 32, N = 901, 12 heads
//     5760 blocks, four an SM at hd 64 (33 KB of shared memory, at most
//     128 registers a thread), two at hd 128 (65 KB).  The blocks of one
//     (sample, head) run side by side and share its K and V in L2.
// Query rows past N compute and are not stored.  What bounds it: at
// B = 32, N = 901, 12 heads of 64 the products are 79.8 GFLOP (0.081 ms at
// the bf16 peak) against 0.053 ms of bytes, and there are 312 M exps; as in
// K9, each tile's Q K^T wait, exp and P V run in turn (PERF.md).
template <int HD>
struct RingLayout {
  static constexpr int KV = CORE_STREAM_KEYS * HD * 2;      // a K or V tile
  static constexpr int STAGE = 2 * KV;
  static constexpr int STAGES = 2;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = 1024 + RING + 2 * STAGES * 8;
  static constexpr int BLOCKS = HD == 64 ? 4 : 2;           // an SM
};

template <int HD, bool K15>
__global__ void __launch_bounds__(CORE_THREADS, RingLayout<HD>::BLOCKS)
attn_core_ring_kernel(const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const CoreArgs a) {
  using L = RingLayout<HD>;
  constexpr int KT = CORE_STREAM_KEYS;
  constexpr int DK = HD / 16;          // k16 steps of Q K^T
  constexpr int PS = KT / 16;          // k16 steps of P V a tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::RING);
  uint64_t* empty = full + L::STAGES;

  const int N = a.N, q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int nt = (N + KT - 1) / KT;                 // key tiles
  const bf16* qb = a.q + b * a.sq[0] + h * a.sq[1];
  bf16* ob = a.o + b * a.so[0] + h * a.so[1];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);                       // thread 0's arrive
      mbar_init(&empty[s], CORE_THREADS / 32);      // lane 0 of each warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // key tile i into stage i % STAGES: K, then V, in 64-column boxes
  auto issue = [&](int i) {
    const int st = i % L::STAGES;
    unsigned char* dst = ring + st * L::STAGE;
    mbar_expect_tx(&full[st], L::STAGE);
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {
      tma_load_4d(dst + c * KT * 128, &map_k, &full[st], 64 * c, i * KT, h,
                  b);
      tma_load_4d(dst + L::KV + c * KT * 128, &map_v, &full[st], 64 * c,
                  i * KT, h, b);
    }
  };
  if (tid == 0)
    for (int i = 0; i < nt && i < L::STAGES; ++i) issue(i);

  // K15 takes the scale rounded to bf16 first (as the staged kernel)
  const float scale =
      K15 ? __bfloat162float(__float2bfloat16_rn(a.scale)) : a.scale;
  const int n_lo = q0 + warp * 16 + g, n_hi = n_lo + 8;
  const bool live = q0 + warp * 16 < N;             // the same for the warp
  // q rows scaled in fp32 and rounded to bf16 before Q K^T, loaded straight
  // into the A-operand layout (zeros past N)
  unsigned qf[DK][4];
#pragma unroll
  for (int d = 0; d < DK; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = (e & 1) ? n_hi : n_lo;
      float2 q = make_float2(0.f, 0.f);
      if (n < N) q = load2(qb + n * a.sq[2] + d * 16 + t2 + (e >> 1) * 8);
      qf[d][e] = pack_bf16x2(q.x * scale, q.y * scale);
    }
  }
  float o[HD / 2];
  float l_lo = 0.f, l_hi = 0.f;

  for (int i = 0; i < nt; ++i) {
    const int st = i % L::STAGES, k0 = i * KT;
    mbar_wait(&full[st], (i / L::STAGES) & 1);
    const unsigned char* Kt = ring + st * L::STAGE;
    const unsigned char* Vt = Kt + L::KV;
    float s[KT / 2];
    wgmma_fence();
#pragma unroll
    for (int d = 0; d < DK; ++d)
      wgmma_rs<KT, false>(
          s, qf[d], desc_sw128(Kt + (d / 4) * KT * 128 + (d % 4) * 32),
          d > 0);
    wgmma_commit();
    wgmma_wait<0>();               // these scores, and the last tile's P V
    if (i > 0) {
      // tile i - 1's stage is free: each warp is past its P V; thread 0
      // refills it with tile i - 1 + STAGES
      const int prev = (i - 1) % L::STAGES;
      if (lane == 0) mbar_arrive(&empty[prev]);
      if (tid == 0 && i - 1 + L::STAGES < nt) {
        mbar_wait(&empty[prev], ((i - 1) / L::STAGES) & 1);
        issue(i - 1 + L::STAGES);
      }
    }
    // e = exp(clip(s, -60, 80) - 20) in place, keys past N masked to 0.
    // Element 4 j + e of s is key k0 + 8 j + t2 + (e & 1).
    unsigned pf[PS][4];
    if (live) {
      const bool last = k0 + KT > N;
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = expf(fminf(fmaxf(s[4 * j + e], -60.f), 80.f) - 20.f);
          if (last && k0 + j * 8 + t2 + (e & 1) >= N) p = 0.f;
          // K15's l sums the bf16 p that the AV product reads; K1's the
          // fp32 e
          if constexpr (K15) p = __bfloat162float(__float2bfloat16_rn(p));
          s[4 * j + e] = p;
        }
        l_lo += s[4 * j] + s[4 * j + 1];
        l_hi += s[4 * j + 2] + s[4 * j + 3];
      }
#pragma unroll
      for (int st2 = 0; st2 < PS; ++st2) {
        pf[st2][0] = pack_bf16x2(s[8 * st2], s[8 * st2 + 1]);
        pf[st2][1] = pack_bf16x2(s[8 * st2 + 2], s[8 * st2 + 3]);
        pf[st2][2] = pack_bf16x2(s[8 * st2 + 4], s[8 * st2 + 5]);
        pf[st2][3] = pack_bf16x2(s[8 * st2 + 6], s[8 * st2 + 7]);
      }
    } else {
#pragma unroll
      for (int st2 = 0; st2 < PS; ++st2)
        pf[st2][0] = pf[st2][1] = pf[st2][2] = pf[st2][3] = 0u;
    }
    wgmma_fence();
#pragma unroll
    for (int st2 = 0; st2 < PS; ++st2)
      wgmma_rs<HD, true>(o, pf[st2],
                         desc_sw128_mn(Vt + st2 * 16 * 128, KT * 128),
                         i > 0 || st2 > 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  if (!live) return;

#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, m);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, m);
  }
  const float inv_lo = __frcp_rn(l_lo), inv_hi = __frcp_rn(l_hi);
  auto out = [&](float x, float l, float r) {
    return K15 ? div_rn_by(x, l, r) : x * r;
  };
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = j * 8 + t2;
    if (n_lo < N)
      store2(ob + n_lo * a.so[2] + col, out(o[4 * j], l_lo, inv_lo),
             out(o[4 * j + 1], l_lo, inv_lo));
    if (n_hi < N)
      store2(ob + n_hi * a.so[2] + col, out(o[4 * j + 2], l_hi, inv_hi),
             out(o[4 * j + 3], l_hi, inv_hi));
  }
}

template <int HD, bool K15>
static cudaError_t launch_core_ring(const CoreArgs& a, int B, cudaStream_t s) {
  using L = RingLayout<HD>;
  // K and V as [B][H][N][HD] (dims innermost first, byte strides of the
  // outer three), read in 64 x 64 boxes; rows past N arrive as zeros
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(a.N),
                              static_cast<cuuint64_t>(a.H),
                              static_cast<cuuint64_t>(B)};
  const cuuint32_t box[4] = {64, CORE_STREAM_KEYS, 1, 1};
  CUtensorMap maps[2];
  const bf16* src[2] = {a.k, a.v};
  const long long* st[2] = {a.sk, a.sv};
  for (int i = 0; i < 2; ++i) {
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[i][2]) * 2,
                                   static_cast<cuuint64_t>(st[i][1]) * 2,
                                   static_cast<cuuint64_t>(st[i][0]) * 2};
    const cudaError_t err = tensor_map(
        &maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, src[i], 4, dims, strides,
        box);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      attn_core_ring_kernel<HD, K15>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + 63) / 64, a.H, B);
  attn_core_ring_kernel<HD, K15><<<grid, CORE_THREADS, L::SMEM, s>>>(
      maps[0], maps[1], a);
  return cudaGetLastError();
}

template <int HD, int KC, bool K15>
static cudaError_t launch_core_kc(const CoreArgs& a, int B, cudaStream_t s) {
  const int smem = CoreLayout<HD, KC>::smem_bytes(a.N);
  cudaError_t err = cudaFuncSetAttribute(
      attn_core_kernel<HD, KC, K15>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attn_core_kernel<HD, KC, K15><<<B * a.H, CORE_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

// a block's dynamic shared memory on sm_90 (H100, H200)
constexpr int CORE_SMEM_LIMIT = 232448;

// the chunk width for N: the whole row (13 or 16 chunks of 16 keys) up to
// 256 keys, else 64-key chunks; the ring once K and V do not fit
template <int HD, bool K15>
static cudaError_t launch_attn_core(const CoreArgs& a, int B, cudaStream_t s) {
  if (a.N <= 0 || B <= 0 || a.H <= 0) return cudaErrorInvalidValue;
  const int nc = (a.N + 15) / 16;
  if (nc <= 13) return launch_core_kc<HD, 208, K15>(a, B, s);
  if (nc <= 16) return launch_core_kc<HD, 256, K15>(a, B, s);
  if (CoreLayout<HD, CORE_STREAM_KEYS>::smem_bytes(a.N) <= CORE_SMEM_LIMIT)
    return launch_core_kc<HD, CORE_STREAM_KEYS, K15>(a, B, s);
  return launch_core_ring<HD, K15>(a, B, s);
}

// The SIMT core (simt_core.cu) when the caller asks for it (``simt``: the
// wrappers route the head dims the wgmma cores are not built for, 192 and
// 256, there), else the wgmma core at head dims 64 and 128; either mode.
static cudaError_t attn_core_strided(const CoreArgs& a, int B, int hd,
                                     bool k15, bool simt, cudaStream_t s) {
  if (simt) {
    long long st[12];
    for (int i = 0; i < 3; ++i) {
      st[i] = a.sq[i];
      st[3 + i] = a.sk[i];
      st[6 + i] = a.sv[i];
      st[9 + i] = a.so[i];
    }
    return static_cast<cudaError_t>(dyt_simt_core(a.q, a.k, a.v, a.o, st, B,
                                                  a.N, a.H, hd, a.scale, 0,
                                                  k15, nullptr, 0, 0, s));
  }
  if (hd == 64)
    return k15 ? launch_attn_core<64, true>(a, B, s)
               : launch_attn_core<64, false>(a, B, s);
  if (hd == 128)
    return k15 ? launch_attn_core<128, true>(a, B, s)
               : launch_attn_core<128, false>(a, B, s);
  return cudaErrorInvalidValue;
}

// The K1 mode on the raw qkv buffer [B, N, 3C] -> out [B, N, C].
static cudaError_t attn_core(const bf16* qkv, bf16* out, int B, int N, int C,
                             int H, float scale, bool simt, cudaStream_t s) {
  if (H <= 0 || C % H) return cudaErrorInvalidValue;
  const long long hd = C / H, C3 = 3LL * C, rows = (long long)N * C3;
  const CoreArgs a{qkv, qkv + C, qkv + 2 * C, out,
                   {rows, hd, C3}, {rows, hd, C3}, {rows, hd, C3},
                   {(long long)N * C, hd, C}, N, H, scale};
  return attn_core_strided(a, B, (int)hd, false, simt, s);
}

template <typename TX>
static cudaError_t sublayer(const TX* x, const float* gamma, const float* beta,
                            const bf16* wqkv, const float* bqkv,
                            const bf16* wproj, const float* bproj, TX* out,
                            float* xm32, bf16* ln_buf, bf16* qkv_buf,
                            bf16* attn_buf, int B, int N, int C, int H,
                            float scale, bool simt, cudaStream_t s) {
  const int M = B * N;
  cudaError_t err = launch_layernorm_bf16<TX>(x, gamma, beta, ln_buf, M, C, s);
  if (err != cudaSuccess) return err;

  err = launch_gemm_nt<EPI_BIAS_BF16, TX>(ln_buf, wqkv, bqkv, M, 3 * C, C,
                                          qkv_buf, nullptr, nullptr,
                                          nullptr, s);
  if (err != cudaSuccess) return err;

  err = attn_core(qkv_buf, attn_buf, B, N, C, H, scale, simt, s);
  if (err != cudaSuccess) return err;

  return launch_gemm_nt<EPI_RESIDUAL, TX>(attn_buf, wproj, bproj, M, C, C,
                                          nullptr, x, out, xm32, s);
}

}  // namespace dyt

extern "C" {

// The bf16 attention core alone: qkv [B, N, 3C] -> out [B, N, C], both bf16
// (the int8 sublayer chain of quant.cu runs it between its int8 GEMMs);
// simt selects the SIMT core over the wgmma core (head dims 64, 128).
int dyt_attn_core(const void* qkv, void* out, int B, int N, int C, int H,
                  float scale, int simt, void* stream) {
  return dyt::attn_core(static_cast<const dyt::bf16*>(qkv),
                        static_cast<dyt::bf16*>(out), B, N, C, H, scale,
                        simt != 0, static_cast<cudaStream_t>(stream));
}

// The attention core on strided bf16 q, k, v [B, H, N, hd] -> out (K1 with
// k15 = 0, K15 with k15 = 1).  ``strides`` holds 12 element strides: batch,
// head and row of q, k, v and out, in that order; hd has unit stride, and
// every stride is a multiple of 8 elements (rows, heads and samples on 16
// bytes: the ring's tensor maps need it).  hd 64 or 128 on the wgmma core,
// or with simt any head dim of the SIMT core (64 to 256, a multiple of 64);
// any N.  Returns a cudaError_t value.
int dyt_mha_core(const void* q, const void* k, const void* v, void* out,
                 const long long* strides, int B, int N, int H, int hd,
                 float scale, int k15, int simt, void* stream) {
  using dyt::bf16;
  dyt::CoreArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<bf16*>(out),
                  {}, {}, {}, {}, N, H, scale};
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  return dyt::attn_core_strided(a, B, hd, k15 != 0, simt != 0,
                                static_cast<cudaStream_t>(stream));
}

// x, out: [B, N, C] in the residual dtype (x_f32 selects fp32 over bf16);
// gamma/beta/bqkv/bproj fp32; wqkv [3C, C], wproj [C, C] bf16; xm32 an
// optional fp32 [B, N, C] copy of out; ln_buf [B*N, C], qkv_buf [B*N, 3C],
// attn_buf [B*N, C] bf16 scratch; simt_core as dyt_attn_core's simt.
// Returns a cudaError_t value.
int dyt_attention_sublayer(const void* x, int x_f32, const float* gamma,
                           const float* beta, const void* wqkv,
                           const float* bqkv, const void* wproj,
                           const float* bproj, void* out, float* xm32,
                           void* ln_buf, void* qkv_buf, void* attn_buf, int B,
                           int N, int C, int H, float scale, int simt_core,
                           void* stream) {
  using dyt::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* wq = static_cast<const bf16*>(wqkv);
  auto* wp = static_cast<const bf16*>(wproj);
  auto* lb = static_cast<bf16*>(ln_buf);
  auto* qb = static_cast<bf16*>(qkv_buf);
  auto* ab = static_cast<bf16*>(attn_buf);
  if (x_f32)
    return dyt::sublayer<float>(static_cast<const float*>(x), gamma, beta, wq,
                                bqkv, wp, bproj, static_cast<float*>(out),
                                xm32, lb, qb, ab, B, N, C, H, scale,
                                simt_core != 0, s);
  return dyt::sublayer<bf16>(static_cast<const bf16*>(x), gamma, beta, wq,
                             bqkv, wp, bproj, static_cast<bf16*>(out), xm32,
                             lb, qb, ab, B, N, C, H, scale, simt_core != 0,
                             s);
}

const char* dyt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
