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
//
// Head dims 192 and 256 (the JAX package fuses every head dim with
// (2 hd) % 128 == 0; dynamic_tuning_tpu/models/layers.py::_attention_fusable)
// take attn_core_wide_kernel (K and V staged by TMA, two warpgroups, q' read
// from shared memory; its note below) while a head's K and V fit, and
// attn_core_wide_ring_kernel past that, in place of the TPU kernels'
// generic forms (dynamic_tuning_tpu/ops/mha_serving.py:31 _mha_kernel, :110
// _mha_fused_kernel and :409 attn_core_pairs).  At B = 32, N = 197 in 4
// heads of 192 the core moves 38.7 MB (0.012 ms at 3.35 TB/s) for 7.6
// GFLOP (0.008 ms at the bf16 peak), with 5 M exps.  The ring with K9's
// bias blocks in its stages is K9 at these head dims (dyt_mha_windowed
// forwards to dyt_mha_windowed_wide).  Past head dim 256, up to 768, the
// core is attn_core_xwide_kernel (o's columns split between warpgroups and
// blocks, hd a run-time count; its note below), K9 too; past 768 the
// chain's core is simt_core.cu's, where the caller routes it
// (``simt_core``).
#include "gemm.cuh"

extern "C" int dyt_simt_core_qkv(const void* qkv, void* out, int B, int N,
                                 int C, int H, float scale, int t_f32,
                                 void* stream);

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

// q, k or v (``p``, element strides ``st`` of batch, head, row) as
// [B][H][N][hd] (dims innermost first, byte strides of the outer three),
// read in boxes of 64 columns by ``box_rows`` rows; rows past N arrive as
// zeros
static cudaError_t head_map(CUtensorMap* map, const bf16* p,
                            const long long* st, const CoreArgs& a, int B,
                            int hd, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(a.N),
                              static_cast<cuuint64_t>(a.H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, 4, dims,
                    strides, box);
}

// K's and V's maps, boxes of ``box_rows`` keys
static cudaError_t core_maps(const CoreArgs& a, int B, int hd, int box_rows,
                             CUtensorMap (&maps)[2]) {
  const cudaError_t err = head_map(&maps[0], a.k, a.sk, a, B, hd, box_rows);
  if (err != cudaSuccess) return err;
  return head_map(&maps[1], a.v, a.sv, a, B, hd, box_rows);
}

template <int HD, bool K15>
static cudaError_t launch_core_ring(const CoreArgs& a, int B, cudaStream_t s) {
  using L = RingLayout<HD>;
  CUtensorMap maps[2];
  cudaError_t err = core_maps(a, B, HD, CORE_STREAM_KEYS, maps);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      attn_core_ring_kernel<HD, K15>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + 63) / 64, a.H, B);
  attn_core_ring_kernel<HD, K15><<<grid, CORE_THREADS, L::SMEM, s>>>(
      maps[0], maps[1], a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head dims 192 and 256 with a head's K and V staged (up to N = 224 at hd
// 192, 160 at hd 256; the ring past that).  The TPU kernels are generic in
// the head dim; the port's staged kernel above is not instantiated here,
// because its whole-row scores (104 registers at N = 197) and q' in the A
// layout (48 or 64) beside o (96 or 128) pass 255 registers, and one block
// an SM (K and V take 2 x 80 KB at N = 197, hd 192) would leave the tensor
// cores idle while its one warpgroup runs the exps.  So:
//   * two warpgroups a block, each its own 64-row query tiles (qt = wg, wg
//     + 2, ...): one's exps run while the other's products do;
//   * K and V come by TMA, one box of 64 columns by all the head's rows a
//     column block (the staged kernel's 128-byte swizzled layout), on two
//     mbarriers, so that Q K^T starts when K is in and P V waits for V;
//   * each warpgroup's q tile comes by TMA too, in the swizzle Q K^T reads
//     (the first ones before K and V, each next one as soon as the tile is
//     free), and is scaled and rounded in place: Q K^T reads q' from
//     shared memory (wgmma's SS form), so no register holds it;
//   * at hd 192 the output is staged, rounded, in the same tile and stored
//     in whole 16-byte chunks of each row (the fragments' own stores write
//     16 bytes a row a warp, and took longer than the products);
//   * the keys go in chunks: at hd 192 64 keys, 32 score registers
//     double-buffered (the next chunk's Q K^T runs under this chunk's
//     exps); at hd 256, where o alone takes 128 registers, 32 keys in one
//     buffer;
//   * P V is one m64n192k16 or m64n256k16 product a 16-key step, so the
//     output columns stay in one warpgroup.
// The per-chunk math, masks and order are those of the staged kernel's
// 64-key chunks (32-key at hd 256): l over the fp32 e in K1's mode, over
// the bf16 p in K15's, the first P V step of the first chunk starting the
// sum.
constexpr int WIDE_THREADS = 256;

template <int HD>
struct WideLayout {
  __host__ __device__ static int rows(int N) { return (N + 15) / 16 * 16; }
  __host__ __device__ static int tile(int N) { return rows(N) * HD * 2; }
  static constexpr int QW = 64 * HD * 2;        // a warpgroup's q' tile
  // K, V (which also catches the last chunk's reads past K's last column
  // block), the two q' tiles, the K, V and two q mbarriers
  __host__ __device__ static int qw_offset(int N) { return 2 * tile(N); }
  __host__ __device__ static int bar_offset(int N) {
    return qw_offset(N) + 2 * QW;
  }
  static int smem_bytes(int N) { return 1024 + bar_offset(N) + 32; }
};

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// q' = bf16(q * scale) in place in a warpgroup's raw q tile (as TMA wrote
// it, in the 128-byte swizzle), each 16-byte chunk by one of its threads
template <int HD>
__device__ __forceinline__ void wide_scale_q(unsigned char* Qw, int wt,
                                             float scale) {
  for (int i = wt; i < 64 * (HD / 8); i += 128) {
    uint4* p = reinterpret_cast<uint4*>(Qw + i * 16);
    float v[8];
    load8(reinterpret_cast<const bf16*>(p), v);
    uint4 w;
    w.x = pack_bf16x2(v[0] * scale, v[1] * scale);
    w.y = pack_bf16x2(v[2] * scale, v[3] * scale);
    w.z = pack_bf16x2(v[4] * scale, v[5] * scale);
    w.w = pack_bf16x2(v[6] * scale, v[7] * scale);
    *p = w;
  }
}

// Chunk kc's scores (KC keys, element 4 j + e is key kc * KC + 8 j + t2 +
// (e & 1)) to e = exp(clip(s, -60, 80) - 20) in place (keys past N give 0;
// with SKIP, keys at or past np are skipped: the caller's P V never reads
// them), their sums into l, and P V's A fragments (zeros for a warp whose
// rows all lie past N).  K15's l sums the bf16 p that P V reads, K1's the
// fp32 e.
template <int KC, bool K15, bool SKIP>
__device__ __forceinline__ void wide_exp(float (&s)[KC / 2],
                                         unsigned (&pf)[KC / 16][4], int kc,
                                         int N, int np, int t2, bool live,
                                         float& l_lo, float& l_hi) {
  if (!live) {
#pragma unroll
    for (int st = 0; st < KC / 16; ++st)
      pf[st][0] = pf[st][1] = pf[st][2] = pf[st][3] = 0u;
    return;
  }
  const bool last = kc * KC + KC > N;
#pragma unroll
  for (int j = 0; j < KC / 8; ++j) {
    if (SKIP && last && kc * KC + j * 8 >= np) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = expf(fminf(fmaxf(s[4 * j + e], -60.f), 80.f) - 20.f);
      if (last && kc * KC + j * 8 + t2 + (e & 1) >= N) p = 0.f;
      if constexpr (K15) p = __bfloat162float(__float2bfloat16_rn(p));
      s[4 * j + e] = p;
    }
    l_lo += s[4 * j] + s[4 * j + 1];
    l_hi += s[4 * j + 2] + s[4 * j + 3];
  }
#pragma unroll
  for (int st = 0; st < KC / 16; ++st) {
    pf[st][0] = pack_bf16x2(s[8 * st], s[8 * st + 1]);
    pf[st][1] = pack_bf16x2(s[8 * st + 2], s[8 * st + 3]);
    pf[st][2] = pack_bf16x2(s[8 * st + 4], s[8 * st + 5]);
    pf[st][3] = pack_bf16x2(s[8 * st + 6], s[8 * st + 7]);
  }
}

// A warpgroup's 64-row tile of o (rows q0 ..) divided by l (K1: o * (1 /
// l); K15: o / l, the IEEE quotient from the rounded reciprocal), rounded to
// bf16 and stored.  At hd 192 it is staged in the warpgroup's q' tile (its
// Q K^T are complete), row-major with each row's 16-byte chunks XOR-
// swizzled by the row (conflict-free 4-byte stores), then stored a 16-byte
// chunk a thread, each row's chunks by consecutive threads: the fragments'
// own stores write 16 bytes a row a warp, and took longer than the
// products.  At hd 256 the staging's addresses beside o's 128 registers
// spill, and the fragments store o themselves.
template <int HD, bool K15>
__device__ __forceinline__ void wide_store(const float (&o)[HD / 2],
                                           float l_lo, float l_hi,
                                           unsigned char* Qw, bf16* ob,
                                           long long ld, int q0, int N,
                                           int wt, int wg, bool live) {
  constexpr bool STAGE_O = HD <= 192;
  const int warp = wt >> 5, lane = wt & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  if (live) {
    // each row's l is spread over the four lanes of its quad
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, m);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, m);
    }
    const float inv_lo = __frcp_rn(l_lo), inv_hi = __frcp_rn(l_hi);
    auto out = [&](float x, float l, float r) {
      return K15 ? div_rn_by(x, l, r) : x * r;
    };
    const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
    const int n_lo = q0 + r_lo, n_hi = q0 + r_hi;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if constexpr (STAGE_O) {
        *reinterpret_cast<unsigned*>(
            Qw + r_lo * HD * 2 + ((j ^ (r_lo & 7)) << 4) + t2 * 2) =
            pack_bf16x2(out(o[4 * j], l_lo, inv_lo),
                        out(o[4 * j + 1], l_lo, inv_lo));
        *reinterpret_cast<unsigned*>(
            Qw + r_hi * HD * 2 + ((j ^ (r_hi & 7)) << 4) + t2 * 2) =
            pack_bf16x2(out(o[4 * j + 2], l_hi, inv_hi),
                        out(o[4 * j + 3], l_hi, inv_hi));
      } else {
        const int col = j * 8 + t2;
        if (n_lo < N)
          store2(ob + n_lo * ld + col, out(o[4 * j], l_lo, inv_lo),
                 out(o[4 * j + 1], l_lo, inv_lo));
        if (n_hi < N)
          store2(ob + n_hi * ld + col, out(o[4 * j + 2], l_hi, inv_hi),
                 out(o[4 * j + 3], l_hi, inv_hi));
      }
    }
  }
  if constexpr (STAGE_O) {
    wg_sync(wg);
    for (int i = wt; i < 64 * (HD / 8); i += 128) {
      const int r = i / (HD / 8), c = i % (HD / 8), n = q0 + r;
      if (n < N)
        *reinterpret_cast<uint4*>(ob + n * ld + c * 8) =
            *reinterpret_cast<const uint4*>(Qw + r * HD * 2 +
                                            ((c ^ (r & 7)) << 4));
    }
  }
}

template <int HD, bool K15>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
attn_core_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const CoreArgs a) {
  using L = WideLayout<HD>;
  constexpr bool PIPE = HD <= 192;     // two score buffers
  constexpr int KC = PIPE ? 64 : 32;   // keys a chunk
  constexpr int DK = HD / 16;          // k16 steps of Q K^T
  constexpr int NS = KC / 2;           // score accumulators a thread
  constexpr int PS = KC / 16;          // k16 steps of P V a chunk
  extern __shared__ unsigned char smem_raw[];
  const int N = a.N, np = L::rows(N);
  const int nkc = (N + KC - 1) / KC, nq = (N + 63) / 64;
  unsigned char* Kt = align1024(smem_raw);
  unsigned char* Vt = Kt + L::tile(N);
  uint64_t* bar = reinterpret_cast<uint64_t*>(Kt + L::bar_offset(N));

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  bf16* ob = a.o + b * a.so[0] + h * a.so[1];
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, t2 = (tid & 3) * 2;
  unsigned char* Qw = Kt + L::qw_offset(N) + wg * L::QW;
  uint64_t* qbar = &bar[2 + wg];

  // query tile qt's raw q rows into warpgroup (qt & 1)'s tile by TMA, in
  // the 128-byte swizzle Q K^T reads (zeros past N)
  auto issue_q = [&](int qt) {
    unsigned char* dst = Kt + L::qw_offset(N) + (qt & 1) * L::QW;
    uint64_t* qb = &bar[2 + (qt & 1)];
    mbar_expect_tx(qb, L::QW);
#pragma unroll
    for (int c = 0; c < HD / 64; ++c)
      tma_load_4d(dst + c * 64 * 128, &map_q, qb, 64 * c, qt * 64, h, b);
  };
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    // both warpgroups' first q tiles, then K, then V
    for (int qt = 0; qt < 2 && qt < nq; ++qt) issue_q(qt);
    for (int i = 0; i < 2; ++i) {
      mbar_expect_tx(&bar[i], (HD / 64) * np * 128);
#pragma unroll
      for (int c = 0; c < HD / 64; ++c)
        tma_load_4d((i ? Vt : Kt) + c * np * 128, i ? &map_v : &map_k,
                    &bar[i], 64 * c, 0, h, b);
    }
  }
  // K15 takes the scale rounded to bf16 first (as the staged kernel)
  const float scale =
      K15 ? __bfloat162float(__float2bfloat16_rn(a.scale)) : a.scale;

  for (int qt = wg, it = 0; qt < nq; qt += 2, ++it) {
    const bool live = qt * 64 + warp * 16 < N;     // the same for the warp
    const bool first = qt == wg;
    mbar_wait(qbar, it & 1);
    wide_scale_q<HD>(Qw, wt, scale);
    fence_proxy_async();           // q' visible to the tensor cores
    wg_sync(wg);
    if (first) mbar_wait(&bar[0], 0);              // K
    float o[HD / 2];
    float l_lo = 0.f, l_hi = 0.f;

    // Q K^T of key chunk kc into s
    auto qk = [&](float (&s)[NS], int kc) {
#pragma unroll
      for (int d = 0; d < DK; ++d)
        wgmma_ss<KC>(s, desc_sw128(Qw + (d / 4) * 64 * 128 + (d % 4) * 32),
                     desc_sw128(Kt + (d / 4) * np * 128 + kc * KC * 128 +
                                (d % 4) * 32),
                     d > 0);
    };
    // chunk kc's exps, l, and P V issued
    auto exp_pv = [&](float (&s)[NS], int kc) {
      unsigned pf[PS][4];
      wide_exp<KC, K15, true>(s, pf, kc, N, np, t2, live, l_lo, l_hi);
      if (first && kc == 0) mbar_wait(&bar[1], 0);  // V
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

    if constexpr (PIPE) {
      // chunk kc + 1's Q K^T issued before chunk kc's exps
      float sa[NS], sb[NS];
      auto chunk = [&](float (&s)[NS], float (&nxt)[NS], int kc) {
        if (kc + 1 < nkc) {
          wgmma_fence();
          qk(nxt, kc + 1);
          wgmma_commit();
          wgmma_wait<1>();         // this chunk's scores (and P V before)
        } else {
          wgmma_wait<0>();
        }
        exp_pv(s, kc);
      };
      wgmma_fence();
      qk(sa, 0);
      wgmma_commit();
      for (int kc = 0; kc < nkc; kc += 2) {
        chunk(sa, sb, kc);
        if (kc + 1 < nkc) chunk(sb, sa, kc + 1);
      }
    } else {
      float s[NS];
      for (int kc = 0; kc < nkc; ++kc) {
        wgmma_fence();
        qk(s, kc);
        wgmma_commit();
        wgmma_wait<0>();           // these scores, and the last P V
        exp_pv(s, kc);
      }
    }
    wgmma_wait<0>();
    wide_store<HD, K15>(o, l_lo, l_hi, Qw, ob, a.so[2], qt * 64, N, wt, wg,
                        live);
    // the tile is free once every thread has read its rows: this
    // warpgroup's next q tile
    wg_sync(wg);
    if (wt == 0 && qt + 2 < nq) {
      fence_proxy_async();
      issue_q(qt + 2);
    }
  }
}

template <int HD, bool K15>
static cudaError_t launch_core_wide(const CoreArgs& a, int B,
                                    cudaStream_t s) {
  using L = WideLayout<HD>;
  // K and V in one box a column block, q in 64-row tiles
  CUtensorMap maps[2], map_q;
  cudaError_t err = core_maps(a, B, HD, L::rows(a.N), maps);
  if (err != cudaSuccess) return err;
  err = head_map(&map_q, a.q, a.sq, a, B, HD, 64);
  if (err != cudaSuccess) return err;
  const int smem = L::smem_bytes(a.N);
  err = cudaFuncSetAttribute(attn_core_wide_kernel<HD, K15>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  attn_core_wide_kernel<HD, K15><<<B * a.H, WIDE_THREADS, smem, s>>>(
      map_q, maps[0], maps[1], a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head dims 192 and 256 past the N whose K and V fit the wide kernel (224
// at hd 192, 160 at hd 256): the wide kernel's two warpgroups, each its own
// 64-row query tile (a block the pair 2 x, 2 x + 1 of one (sample, head);
// one tile, the second warpgroup idle, where those blocks fit one wave),
// walking the head's keys in 64-key tiles that TMA brings into a ring of
// two stages (96 or 128 KB) shared by both: thread 0 refills a stage once
// every warp of the block is past its P V.  The q tiles come by TMA with
// the first key tiles and are scaled in place, as in the wide kernel; the
// per-chunk math, order and chunk widths are the wide kernel's, so both
// give the same bits (a ragged last tile's keys past N add exact zeros).
// Both warpgroups wait for each stage, so they run in step: the exps of one
// run beside the other's products, not a tile apart.
//
// With BIAS it is also K9 at these head dims (dynamic_tuning_tpu/ops/
// mha_serving.py:321 mha_windowed_fused, entered through dyt_mha_windowed):
// each stage also holds the two warpgroups' 64 x 64 blocks of the bf16
// [H, N, N] bias, which TMA brings with K and V (the 3-D map and 128-byte
// swizzle of windowed_attention.cu), added to the fp32 scores before the
// exp.  Two stages take 160 KB at hd 256, 128 KB at hd 192.
template <int HD, bool BIAS = false>
struct WideRingLayout {
  static constexpr int KT = CORE_STREAM_KEYS;               // keys a tile
  static constexpr int KV = KT * HD * 2;                    // a K or V tile
  static constexpr int BT = 64 * KT * 2;                    // a bias block
  static constexpr int STAGE = 2 * KV + (BIAS ? 2 * BT : 0);
  static constexpr int STAGES = 2;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int QW = 64 * HD * 2;                    // a q' tile
  static constexpr int SMEM = 1024 + RING + 2 * QW + (2 * STAGES + 2) * 8;
};

template <int HD, bool K15, bool BIAS>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
attn_core_wide_ring_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_bias,
                           const CoreArgs a, int tpb) {
  using L = WideRingLayout<HD, BIAS>;
  constexpr int KT = L::KT;
  constexpr int KC = HD <= 192 ? 64 : 32;   // keys a chunk (the wide kernel's)
  constexpr int CPT = KT / KC;              // chunks a tile
  constexpr int DK = HD / 16;               // k16 steps of Q K^T
  constexpr int NS = KC / 2;                // score accumulators a thread
  constexpr int PS = KC / 16;               // k16 steps of P V a chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::RING + 2 * L::QW);
  uint64_t* empty = full + L::STAGES;
  uint64_t* qbar = empty + L::STAGES;

  const int N = a.N, nt = (N + KT - 1) / KT;
  const int h = blockIdx.y, b = blockIdx.z;
  bf16* ob = a.o + b * a.so[0] + h * a.so[1];
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, t2 = (lane & 3) * 2;
  const int g = lane >> 2;
  const int q0t = tpb * blockIdx.x, qt = q0t + wg;
  // the query tiles that have rows (K9 loads their bias blocks)
  const int nqb = tpb == 2 && (q0t + 1) * 64 < N ? 2 : 1;
  const bool active = wg < tpb && qt * 64 < N;     // the same for the group
  const bool live = active && qt * 64 + warp * 16 < N;
  unsigned char* Qw = ring + L::RING + wg * L::QW;

  // key tile i into stage i % STAGES: K, then V, in 64-column boxes (and
  // the bias blocks [query tile, key tile] of the live query tiles)
  auto issue = [&](int i) {
    const int st = i % L::STAGES;
    unsigned char* dst = ring + st * L::STAGE;
    mbar_expect_tx(&full[st], 2 * L::KV + (BIAS ? nqb * L::BT : 0));
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {
      tma_load_4d(dst + c * KT * 128, &map_k, &full[st], 64 * c, i * KT, h,
                  b);
      tma_load_4d(dst + L::KV + c * KT * 128, &map_v, &full[st], 64 * c,
                  i * KT, h, b);
    }
    if constexpr (BIAS)
      for (int w = 0; w < nqb; ++w)
        tma_load_3d(dst + 2 * L::KV + w * L::BT, &map_bias, &full[st],
                    i * KT, (q0t + w) * 64, h);
  };
  if (tid == 0) {
    for (int st = 0; st < L::STAGES; ++st) {
      mbar_init(&full[st], 1);                     // thread 0's arrive
      mbar_init(&empty[st], WIDE_THREADS / 32);    // lane 0 of each warp
    }
    mbar_init(&qbar[0], 1);
    mbar_init(&qbar[1], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    // the two q tiles (zeros past N), then the first key tiles
    for (int w = 0; w < tpb && (q0t + w) * 64 < N; ++w) {
      mbar_expect_tx(&qbar[w], L::QW);
#pragma unroll
      for (int c = 0; c < HD / 64; ++c)
        tma_load_4d(ring + L::RING + w * L::QW + c * 64 * 128, &map_q,
                    &qbar[w], 64 * c, (q0t + w) * 64, h, b);
    }
    for (int i = 0; i < nt && i < L::STAGES; ++i) issue(i);
  }
  // K15 takes the scale rounded to bf16 first (as the staged kernel)
  const float scale =
      K15 ? __bfloat162float(__float2bfloat16_rn(a.scale)) : a.scale;
  if (active) {
    mbar_wait(&qbar[wg], 0);
    wide_scale_q<HD>(Qw, wt, scale);
    fence_proxy_async();           // q' visible to the tensor cores
    wg_sync(wg);
  }
  float o[HD / 2];
  float l_lo = 0.f, l_hi = 0.f;

  // tile i - 1's stage is free (every P V before this point is complete):
  // each warp says so; thread 0 refills it with tile i - 1 + STAGES
  auto release = [&](int i) {
    const int prev = (i - 1) % L::STAGES;
    if (lane == 0) mbar_arrive(&empty[prev]);
    if (tid == 0 && i - 1 + L::STAGES < nt) {
      mbar_wait(&empty[prev], ((i - 1) / L::STAGES) & 1);
      issue(i - 1 + L::STAGES);
    }
  };
  for (int i = 0; i < nt; ++i) {
    const int st = i % L::STAGES;
    mbar_wait(&full[st], (i / L::STAGES) & 1);
    const unsigned char* Kt = ring + st * L::STAGE;
    const unsigned char* Vt = Kt + L::KV;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int kc = i * CPT + cc;                 // keys kc * KC ..
      float s[NS];
      if (active) {
        wgmma_fence();
#pragma unroll
        for (int d = 0; d < DK; ++d)
          wgmma_ss<KC>(s, desc_sw128(Qw + (d / 4) * 64 * 128 + (d % 4) * 32),
                       desc_sw128(Kt + (d / 4) * KT * 128 + cc * KC * 128 +
                                  (d % 4) * 32),
                       d > 0);
        wgmma_commit();
      }
      wgmma_wait<0>();             // these scores, and the last P V
      if (cc == 0 && i > 0) release(i);
      if (!active) continue;
      if constexpr (BIAS) {
        // s + bias: element 4 j + e of s is key cc * KC + 8 j + t2 + (e &
        // 1) of row g + 8 (e >> 1) of the warp's 16; its bias sits in the
        // block's swizzled row at 16-byte chunk (cc * KC / 8 + j) ^ g
        if (live) {
          const unsigned char* Bt = Kt + 2 * L::KV + wg * L::BT;
#pragma unroll
          for (int j = 0; j < KC / 8; ++j) {
            const bf16* brow = reinterpret_cast<const bf16*>(
                Bt + (warp * 16 + g) * 128 +
                (((cc * (KC / 8) + j) ^ g) << 4)) + t2;
            const float2 b_lo = load2(brow), b_hi = load2(brow + 8 * 64);
            s[4 * j] += b_lo.x;
            s[4 * j + 1] += b_lo.y;
            s[4 * j + 2] += b_hi.x;
            s[4 * j + 3] += b_hi.y;
          }
        }
      }
      // every key of the tile (TMA zero-fills past N; p is masked there)
      unsigned pf[PS][4];
      wide_exp<KC, K15, false>(s, pf, kc, N, 0, t2, live, l_lo, l_hi);
      wgmma_fence();
#pragma unroll
      for (int st2 = 0; st2 < PS; ++st2)
        wgmma_rs<HD, true>(o, pf[st2],
                           desc_sw128_mn(Vt + (cc * KC + st2 * 16) * 128,
                                         KT * 128),
                           kc > 0 || st2 > 0);
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  if (active)
    wide_store<HD, K15>(o, l_lo, l_hi, Qw, ob, a.so[2], qt * 64, N, wt, wg,
                        live);
}

// ``bias`` null (K1, K15) or K9's bf16 [H, N, N] bias with its padded
// strides (elements; multiples of 8, the row stride at least N).
template <int HD, bool K15, bool BIAS = false>
static cudaError_t launch_core_wide_ring(const CoreArgs& a, int B,
                                         cudaStream_t s,
                                         const bf16* bias = nullptr,
                                         long long head_stride = 0,
                                         long long row_stride = 0) {
  using L = WideRingLayout<HD, BIAS>;
  CUtensorMap maps[2], map_q, map_bias{};
  cudaError_t err = core_maps(a, B, HD, L::KT, maps);
  if (err != cudaSuccess) return err;
  err = head_map(&map_q, a.q, a.sq, a, B, HD, 64);
  if (err != cudaSuccess) return err;
  if constexpr (BIAS) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(a.N),
                                static_cast<cuuint64_t>(a.N),
                                static_cast<cuuint64_t>(a.H)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride) * 2,
                                   static_cast<cuuint64_t>(head_stride) * 2};
    const cuuint32_t box[3] = {64, 64, 1};
    err = tensor_map(&map_bias, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, bias, 3,
                     dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(attn_core_wide_ring_kernel<HD, K15, BIAS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::SMEM);
  if (err != cudaSuccess) return err;
  // one query tile a block when those blocks fit the SMs in one wave (one
  // block an SM), else the pair: K9 at B=1, N=1025 in 4 heads runs faster
  // as 68 single tiles than as 36 pairs, and at B=2 as 72 pairs than as two
  // waves of single tiles (PERF.md §6, K9)
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int nq = (a.N + 63) / 64;
  const int tpb = (long long)nq * a.H * B <= sms ? 1 : 2;
  const dim3 grid((nq + tpb - 1) / tpb, a.H, B);
  attn_core_wide_ring_kernel<HD, K15, BIAS>
      <<<grid, WIDE_THREADS, L::SMEM, s>>>(map_q, maps[0], maps[1], map_bias,
                                           a, tpb);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head dims past 256 (320, 384, ... up to XW_MAX_HD), hd a run-time count of
// 64-column blocks, so that no list of template instances stops at its
// last entry.  o for a whole row no longer fits a thread's registers (192
// fp32 at hd 384 in wgmma's layout), so o's columns are split: a block owns
// one 64-row query tile of one (sample, head) and a group of 2 WCB of o's
// 64-column blocks, WCB for each of its two warpgroups (m64n64 to m64n256
// P V products into 32 WCB registers a thread; WCB is the one template
// parameter besides the mode: a P V width picked at run time made ptxas
// serialize the products).  Both warpgroups compute the same scores S = Q
// K^T on the tensor cores (wgmma_ss, q' and k from shared memory, over all
// of hd): the serving softmax has no row max, so e and l are the same bits
// in each, and each sums o's columns over the same key chunks in the same
// order (K1's l over the fp32 e, K15's over the bf16 p).  S costs the
// tensor cores twice what it would once, against the SIMT slices kernel's
// hd / 64 recomputations on the CUDA cores.
//   * q comes once by TMA (64-column boxes, the 128-byte swizzle) and is
//     scaled in place;
//   * the keys come in tiles of XW_KT = 32 that TMA brings into a ring of
//     stages: all of K's column blocks, the V column blocks of the block's
//     group (zeros past hd: a group's last blocks may lie past it, and are
//     computed and not stored) and (K9) the query tile's unswizzled 64 x
//     32 bias block; thread 0 refills a stage once every warp is past its
//     P V (the wide ring's protocol);
//   * each tile is one 32-key chunk: S (16 registers), the bias, the
//     clamped expf and l (wide_exp), then P V of the warpgroup's columns;
//     the two warpgroups' products interleave on the tensor cores (a
//     second score buffer with tile i + 1's S issued before tile i's exps
//     made ptxas serialize the products, and ran slower: PERF.md §6);
//   * o is stored from the fragments.
// The column groups, WCB and the stages are picked at launch (xw_plan):
// the fewest groups (or, where the blocks of one group would leave SMs
// idle, as many more as fill them: K9 at B=1, N=1025 in 2 heads has 34
// query tiles), then the fewest columns past hd, with two stages or more
// fitting a block (as many as fit, at most four).  Past XW_MAX_HD the q
// tile and two stages of K no longer fit beside V's column blocks; those
// head dims take the SIMT slices kernel (ops/mha_serving.py::core_of
// routes them).
constexpr int XW_KT = 32;               // keys a tile, the chunk of S
constexpr int XW_MAX_CB = 4;            // o's 64-column blocks a warpgroup
constexpr int XW_MAX_HD = 768;
constexpr int XW_BOX = XW_KT * 128;     // a 64-column box of 32 keys
constexpr int XW_QBOX = 64 * 128;       // a 64-column box of the q tile

struct XwPlan {
  int ncb;                  // hd / 64
  int wcb;                  // o's column blocks a warpgroup
  int groups;               // column groups of o (blocks a query tile)
  int stages;
  int stage_bytes;
  int smem;
};

// The plan for head dim ``hd`` (``bias``: K9's blocks in each stage) and
// ``tiles`` query tiles on ``sms`` SMs, false where none fits a block.
static bool xw_plan(int hd, bool bias, long long tiles, int sms,
                    XwPlan* p) {
  if (hd <= 256 || hd % 64 || hd > XW_MAX_HD) return false;
  const int ncb = hd / 64;
  const long long fill = tiles < sms ? sms / tiles : 1;
  const int want = static_cast<int>(fill < (ncb + 1) / 2 ? fill
                                                         : (ncb + 1) / 2);
  bool found = false;
  for (int wcb = XW_MAX_CB; wcb >= 1; --wcb) {
    const int G = (ncb + 2 * wcb - 1) / (2 * wcb);
    if (G < want) continue;
    const int waste = 2 * wcb * G - ncb;
    if (found && (G > p->groups ||
                  (G == p->groups && waste >= 2 * p->wcb * G - ncb)))
      continue;
    const int stage = (ncb + 2 * wcb) * XW_BOX + (bias ? 64 * XW_KT * 2 : 0);
    for (int st = 4; st >= 2; --st) {
      const int smem = 1024 + ncb * XW_QBOX + st * stage + (2 * st + 1) * 8;
      if (smem <= 232448) {
        *p = XwPlan{ncb, wcb, G, st, stage, smem};
        found = true;
        break;
      }
    }
  }
  return found;
}

template <int WCB, bool K15, bool BIAS>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
attn_core_xwide_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_bias,
                       const CoreArgs a, const XwPlan p) {
  constexpr int KT = XW_KT;
  constexpr int NS = KT / 2;                // score accumulators a thread
  constexpr int PS = KT / 16;               // k16 steps of P V a tile
  constexpr int W = 64 * WCB;               // a warpgroup's o columns
  constexpr int CBB = 2 * WCB;              // the block's column blocks
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  const int ncb = p.ncb, nst = p.stages, G = p.groups;
  unsigned char* ring = Qs + ncb * XW_QBOX;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + nst * p.stage_bytes);
  uint64_t* empty = full + nst;
  uint64_t* qbar = empty + nst;

  const int N = a.N, nt = (N + KT - 1) / KT;
  const int qt = blockIdx.x / G, grp = blockIdx.x % G;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, t2 = (lane & 3) * 2;
  const int g = lane >> 2;
  const int cb0 = grp * CBB;                // the group's first column block
  const int wc0 = wg * WCB;                 // this warpgroup's, in the group
  const bool live = qt * 64 + warp * 16 < N;       // the same for the warp

  // key tile i into stage i % nst: K's column blocks, the group's of V,
  // (K9) the bias block [query tile, key tile]
  auto issue = [&](int i) {
    const int st = i % nst;
    unsigned char* dst = ring + st * p.stage_bytes;
    mbar_expect_tx(&full[st], (ncb + CBB) * XW_BOX +
                                  (BIAS ? 64 * KT * 2 : 0));
    for (int c = 0; c < ncb; ++c)
      tma_load_4d(dst + c * XW_BOX, &map_k, &full[st], 64 * c, i * KT, h, b);
#pragma unroll
    for (int c = 0; c < CBB; ++c)
      tma_load_4d(dst + (ncb + c) * XW_BOX, &map_v, &full[st],
                  64 * (cb0 + c), i * KT, h, b);
    if constexpr (BIAS)
      tma_load_3d(dst + (ncb + CBB) * XW_BOX, &map_bias, &full[st], i * KT,
                  qt * 64, h);
  };
  if (tid == 0) {
    for (int st = 0; st < nst; ++st) {
      mbar_init(&full[st], 1);                     // thread 0's arrive
      mbar_init(&empty[st], WIDE_THREADS / 32);    // lane 0 of each warp
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    // the q tile (zeros past N), then the first key tiles
    mbar_expect_tx(qbar, ncb * XW_QBOX);
    for (int c = 0; c < ncb; ++c)
      tma_load_4d(Qs + c * XW_QBOX, &map_q, qbar, 64 * c, qt * 64, h, b);
    for (int i = 0; i < nt && i < nst; ++i) issue(i);
  }
  // K15 takes the scale rounded to bf16 first (as the staged kernel); q' =
  // bf16(q * scale) in place, each 16-byte chunk by one thread of the block
  const float scale =
      K15 ? __bfloat162float(__float2bfloat16_rn(a.scale)) : a.scale;
  mbar_wait(qbar, 0);
  for (int i = tid; i < ncb * 64 * 8; i += WIDE_THREADS) {
    uint4* q = reinterpret_cast<uint4*>(Qs + i * 16);
    float v[8];
    load8(reinterpret_cast<const bf16*>(q), v);
    uint4 w;
    w.x = pack_bf16x2(v[0] * scale, v[1] * scale);
    w.y = pack_bf16x2(v[2] * scale, v[3] * scale);
    w.z = pack_bf16x2(v[4] * scale, v[5] * scale);
    w.w = pack_bf16x2(v[6] * scale, v[7] * scale);
    *q = w;
  }
  fence_proxy_async();             // q' visible to the tensor cores
  __syncthreads();

  float o[W / 2];
  float l_lo = 0.f, l_hi = 0.f;
  float s[NS];
  for (int i = 0; i < nt; ++i) {
    const int st = i % nst;
    mbar_wait(&full[st], (i / nst) & 1);
    const unsigned char* Kt = ring + st * p.stage_bytes;
    const unsigned char* Vt = Kt + ncb * XW_BOX;
    // S of tile i over all of hd
    wgmma_fence();
    for (int c = 0; c < ncb; ++c) {
#pragma unroll
      for (int d = 0; d < 4; ++d)
        wgmma_ss<KT>(s, desc_sw128(Qs + c * XW_QBOX + d * 32),
                     desc_sw128(Kt + c * XW_BOX + d * 32), c > 0 || d > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();               // these scores, and the last P V
    fence_regs(s);
    if (i > 0) {
      // tile i - 1's stage is free: each warp says so; thread 0 refills it
      // with tile i - 1 + nst
      const int prev = (i - 1) % nst;
      if (lane == 0) mbar_arrive(&empty[prev]);
      if (tid == 0 && i - 1 + nst < nt) {
        mbar_wait(&empty[prev], ((i - 1) / nst) & 1);
        issue(i - 1 + nst);
      }
    }
    if constexpr (BIAS) {
      // s + bias: element 4 j + e of s is key 8 j + t2 + (e & 1) of row g +
      // 8 (e >> 1) of the warp's 16, in the block's [64][32] rows
      if (live) {
        const bf16* brow = reinterpret_cast<const bf16*>(Vt + CBB * XW_BOX) +
                           (warp * 16 + g) * KT + t2;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          const float2 b_lo = load2(brow + j * 8);
          const float2 b_hi = load2(brow + 8 * KT + j * 8);
          s[4 * j] += b_lo.x;
          s[4 * j + 1] += b_lo.y;
          s[4 * j + 2] += b_hi.x;
          s[4 * j + 3] += b_hi.y;
        }
      }
    }
    // every key of the tile (TMA zero-fills past N; p is masked there)
    unsigned pf[PS][4];
    wide_exp<KT, K15, false>(s, pf, i, N, 0, t2, live, l_lo, l_hi);
    wgmma_fence();
#pragma unroll
    for (int st2 = 0; st2 < PS; ++st2)
      wgmma_rs<W, true>(o, pf[st2],
                        desc_sw128_mn(Vt + wc0 * XW_BOX + st2 * 16 * 128,
                                      XW_BOX),
                        i > 0 || st2 > 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  if (!live) return;

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
  const int n_lo = qt * 64 + warp * 16 + g, n_hi = n_lo + 8;
  const int cbw = cb0 + wc0;                // this warpgroup's first block
  bf16* ob = a.o + b * a.so[0] + h * a.so[1] + cbw * 64;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    if (cbw + j / 8 >= ncb) break;          // columns past hd
    const int col = j * 8 + t2;
    if (n_lo < N)
      store2(ob + n_lo * a.so[2] + col, out(o[4 * j], l_lo, inv_lo),
             out(o[4 * j + 1], l_lo, inv_lo));
    if (n_hi < N)
      store2(ob + n_hi * a.so[2] + col, out(o[4 * j + 2], l_hi, inv_hi),
             out(o[4 * j + 3], l_hi, inv_hi));
  }
}

template <int WCB, bool K15, bool BIAS>
static cudaError_t launch_xwide_plan(const CUtensorMap (&maps)[4],
                                     const CoreArgs& a, int B,
                                     const XwPlan& p, cudaStream_t s) {
  auto kernel = attn_core_xwide_kernel<WCB, K15, BIAS>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + 63) / 64 * p.groups, a.H, B);
  kernel<<<grid, WIDE_THREADS, p.smem, s>>>(maps[0], maps[1], maps[2],
                                            maps[3], a, p);
  return cudaGetLastError();
}

// The core past head dim 256 (either mode; with BIAS K9's bias [H, N, N],
// its padded strides in elements).
template <bool K15, bool BIAS = false>
static cudaError_t launch_core_xwide(const CoreArgs& a, int B, int hd,
                                     cudaStream_t s,
                                     const bf16* bias = nullptr,
                                     long long head_stride = 0,
                                     long long row_stride = 0) {
  if (a.N <= 0 || B <= 0 || a.H <= 0 || B > 65535 || a.H > 65535)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  XwPlan p;
  if (!xw_plan(hd, BIAS, (long long)(a.N + 63) / 64 * a.H * B, sms, &p))
    return cudaErrorInvalidValue;
  // q, K, V and (K9) the bias
  CUtensorMap maps[4] = {};
  err = head_map(&maps[0], a.q, a.sq, a, B, hd, 64);
  if (err != cudaSuccess) return err;
  err = head_map(&maps[1], a.k, a.sk, a, B, hd, XW_KT);
  if (err != cudaSuccess) return err;
  err = head_map(&maps[2], a.v, a.sv, a, B, hd, XW_KT);
  if (err != cudaSuccess) return err;
  if constexpr (BIAS) {
    // [64 rows][32 keys] boxes, unswizzled (read by the threads, not wgmma)
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(a.N),
                                static_cast<cuuint64_t>(a.N),
                                static_cast<cuuint64_t>(a.H)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride) * 2,
                                   static_cast<cuuint64_t>(head_stride) * 2};
    const cuuint32_t box[3] = {XW_KT, 64, 1};
    err = tensor_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, bias, 3,
                     dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
  }
  switch (p.wcb) {
    case 1: return launch_xwide_plan<1, K15, BIAS>(maps, a, B, p, s);
    case 2: return launch_xwide_plan<2, K15, BIAS>(maps, a, B, p, s);
    case 3: return launch_xwide_plan<3, K15, BIAS>(maps, a, B, p, s);
    default: return launch_xwide_plan<4, K15, BIAS>(maps, a, B, p, s);
  }
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
// 256 keys, else 64-key chunks; the ring once K and V do not fit.  Head
// dims 192 and 256: the wide kernel while K and V fit, else its ring.
template <int HD, bool K15>
static cudaError_t launch_attn_core(const CoreArgs& a, int B, cudaStream_t s) {
  if (a.N <= 0 || B <= 0 || a.H <= 0) return cudaErrorInvalidValue;
  if constexpr (HD > 128) {
    if (WideLayout<HD>::smem_bytes(a.N) <= CORE_SMEM_LIMIT)
      return launch_core_wide<HD, K15>(a, B, s);
    return launch_core_wide_ring<HD, K15>(a, B, s);
  } else {
    const int nc = (a.N + 15) / 16;
    if (nc <= 13) return launch_core_kc<HD, 208, K15>(a, B, s);
    if (nc <= 16) return launch_core_kc<HD, 256, K15>(a, B, s);
    if (CoreLayout<HD, CORE_STREAM_KEYS>::smem_bytes(a.N) <= CORE_SMEM_LIMIT)
      return launch_core_kc<HD, CORE_STREAM_KEYS, K15>(a, B, s);
    return launch_core_ring<HD, K15>(a, B, s);
  }
}

template <int HD>
static cudaError_t launch_core_hd(const CoreArgs& a, int B, bool k15,
                                  cudaStream_t s) {
  return k15 ? launch_attn_core<HD, true>(a, B, s)
             : launch_attn_core<HD, false>(a, B, s);
}

// The wgmma core at head dims 64, 128, 192 and 256, and past 256 up to
// XW_MAX_HD; either mode.
static cudaError_t attn_core_strided(const CoreArgs& a, int B, int hd,
                                     bool k15, cudaStream_t s) {
  switch (hd) {
    case 64: return launch_core_hd<64>(a, B, k15, s);
    case 128: return launch_core_hd<128>(a, B, k15, s);
    case 192: return launch_core_hd<192>(a, B, k15, s);
    case 256: return launch_core_hd<256>(a, B, k15, s);
    default:
      return k15 ? launch_core_xwide<true>(a, B, hd, s)
                 : launch_core_xwide<false>(a, B, hd, s);
  }
}

// The K1 mode on the raw qkv buffer [B, N, 3C] -> out [B, N, C].
static cudaError_t attn_core(const bf16* qkv, bf16* out, int B, int N, int C,
                             int H, float scale, cudaStream_t s) {
  if (H <= 0 || C % H) return cudaErrorInvalidValue;
  const long long hd = C / H, C3 = 3LL * C, rows = (long long)N * C3;
  const CoreArgs a{qkv, qkv + C, qkv + 2 * C, out,
                   {rows, hd, C3}, {rows, hd, C3}, {rows, hd, C3},
                   {(long long)N * C, hd, C}, N, H, scale};
  return attn_core_strided(a, B, (int)hd, false, s);
}

// The chain; ``simt_core`` runs its core on simt_core.cu's kernel (head
// dims past XW_MAX_HD, where the caller routes it) in place of the wgmma
// core.
template <typename TX>
static cudaError_t sublayer(const TX* x, const float* gamma, const float* beta,
                            const bf16* wqkv, const float* bqkv,
                            const bf16* wproj, const float* bproj, TX* out,
                            float* xm32, bf16* ln_buf, bf16* qkv_buf,
                            bf16* attn_buf, int B, int N, int C, int H,
                            float scale, int simt_core, cudaStream_t s) {
  const int M = B * N;
  cudaError_t err = launch_layernorm_bf16<TX>(x, gamma, beta, ln_buf, M, C, s);
  if (err != cudaSuccess) return err;

  err = launch_gemm_nt<EPI_BIAS_BF16, TX>(ln_buf, wqkv, bqkv, M, 3 * C, C,
                                          qkv_buf, nullptr, nullptr,
                                          nullptr, s);
  if (err != cudaSuccess) return err;

  err = simt_core ? static_cast<cudaError_t>(dyt_simt_core_qkv(
                        qkv_buf, attn_buf, B, N, C, H, scale, 0, s))
                  : attn_core(qkv_buf, attn_buf, B, N, C, H, scale, s);
  if (err != cudaSuccess) return err;

  return launch_gemm_nt<EPI_RESIDUAL, TX>(attn_buf, wproj, bproj, M, C, C,
                                          nullptr, x, out, xm32, s);
}

}  // namespace dyt

extern "C" {

// The bf16 attention core alone: qkv [B, N, 3C] -> out [B, N, C], both bf16
// (the int8 sublayer chain of quant.cu runs it between its int8 GEMMs),
// head dims 64, 128, 192, 256 and the multiples of 64 past 256 up to 768.
int dyt_attn_core(const void* qkv, void* out, int B, int N, int C, int H,
                  float scale, void* stream) {
  return dyt::attn_core(static_cast<const dyt::bf16*>(qkv),
                        static_cast<dyt::bf16*>(out), B, N, C, H, scale,
                        static_cast<cudaStream_t>(stream));
}

// The attention core on strided bf16 q, k, v [B, H, N, hd] -> out (K1 with
// k15 = 0, K15 with k15 = 1).  ``strides`` holds 12 element strides: batch,
// head and row of q, k, v and out, in that order; hd has unit stride, and
// every stride is a multiple of 8 elements (rows, heads and samples on 16
// bytes: the tensor maps need it).  hd 64, 128, 192, 256, or a multiple of
// 64 past 256 up to 768; any N.
// Returns a cudaError_t value.
int dyt_mha_core(const void* q, const void* k, const void* v, void* out,
                 const long long* strides, int B, int N, int H, int hd,
                 float scale, int k15, void* stream) {
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
  return dyt::attn_core_strided(a, B, hd, k15 != 0,
                                static_cast<cudaStream_t>(stream));
}

// x, out: [B, N, C] in the residual dtype (x_f32 selects fp32 over bf16);
// gamma/beta/bqkv/bproj fp32; wqkv [3C, C], wproj [C, C] bf16; xm32 an
// optional fp32 [B, N, C] copy of out; ln_buf [B*N, C], qkv_buf [B*N, 3C],
// attn_buf [B*N, C] bf16 scratch; simt_core the SIMT core's route (head
// dims past 768).  Returns a cudaError_t value.
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
                                simt_core, s);
  return dyt::sublayer<bf16>(static_cast<const bf16*>(x), gamma, beta, wq,
                             bqkv, wp, bproj, static_cast<bf16*>(out), xm32,
                             lb, qb, ab, B, N, C, H, scale, simt_core, s);
}

// K9 at head dims 192 and 256 and past them up to 768 (dyt_mha_windowed's
// arguments: qkv [B, N, 3C] bf16 contiguous on 16 bytes, bias [H, N, N] bf16
// on 16 bytes with unit column stride and padded row and head strides, out
// [B, N, C] bf16): the wide core's ring with the bias blocks, past 256 the
// core past 256 with its bias blocks.  Returns a cudaError_t value.
int dyt_mha_windowed_wide(const void* qkv, const void* bias, void* out, int B,
                          int N, int C, int H, long long head_stride,
                          int row_stride, float scale, void* stream) {
  using dyt::bf16;
  if (B <= 0 || N <= 0 || H <= 0 || C % H || row_stride % 8 ||
      head_stride % 8 || row_stride < N ||
      (reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(bias)) %
          16)
    return cudaErrorInvalidValue;
  const long long hd = C / H, C3 = 3LL * C, rows = (long long)N * C3;
  auto* q = static_cast<const bf16*>(qkv);
  const dyt::CoreArgs a{q, q + C, q + 2 * C, static_cast<bf16*>(out),
                        {rows, hd, C3}, {rows, hd, C3}, {rows, hd, C3},
                        {(long long)N * C, hd, C}, N, H, scale};
  auto* bp = static_cast<const bf16*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 192)
    return dyt::launch_core_wide_ring<192, false, true>(a, B, s, bp,
                                                        head_stride,
                                                        row_stride);
  if (hd == 256)
    return dyt::launch_core_wide_ring<256, false, true>(a, B, s, bp,
                                                        head_stride,
                                                        row_stride);
  return dyt::launch_core_xwide<false, true>(a, B, (int)hd, s, bp,
                                             head_stride, row_stride);
}

const char* dyt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
