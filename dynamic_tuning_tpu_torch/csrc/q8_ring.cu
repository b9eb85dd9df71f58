// K10's attention core with int8 scores on a wgmma key ring: the function
// of dynamic_tuning_tpu/ops/quant.py::attn_core_pairs_q8 (:309) where the
// staged core of quant.cu (attn_core_q8_kernel: a head pair's codes and V
// in one cluster's shared memory) cannot go: bf16 qkv past head dim 256 (up
// to 768) and, at head dims 64 to 256, past the N whose codes and V fit a
// block.  Reached as K10 alone and inside K5, K6 and K8 with ``attn_q8``
// (quant.cu's int8 chain); ops/mha_serving.py::core_of routes it ("q8_ring").
// Per sample b and head h of the pair p = h / 2, as the staged core:
//   kc = k_p - mean_n(k_p)   per lane of the pair's 2 hd lanes (float64 sum)
//   kq, ks = row quant of kc over the 2 hd lanes (one scale a pair row)
//   qq, qs = row quant of fp32 q * scale over the head's hd lanes
//   s = (float(qq . kq_h) * qs) * ks;  e = expf(clip(s, -60, 80) - 20)
//   l = sum(e) in fp32;  o = (bf16(e) @ v in fp32) * (1 / l) -> bf16
//
// What bounds it on an H100.  At B = 32, N = 197, C = 768 in 2 heads of 384
// it reads q, k and v (29 MB of bf16) and writes o (9.7 MB): 0.0116 ms at
// 3.35 TB/s; the products (0.95 G int8 and 0.95 GFLOP bf16) take 0.0015 ms at
// the tensor peaks, so bytes bound it.  Its SIMT predecessor (dp4a scores
// and FFMA P V on simt_core.cuh's 64-column slices, each slice recomputing
// the scores) took 0.49 ms.
//
// What the design does about it.  The codes come first, from q8_codes.cuh's
// two kernels (the k lane means; the q and k codes and scales, bit for bit
// the staged core's and the SIMT form's: the k scales laid out as rows of
// a head pair's keys), then one kernel, attention_sublayer.cu's
// attn_core_xwide_kernel with int8 scores:
//   * a block owns 64-row query tiles and walks the keys in tiles of 32 that
//     thread 0 brings by TMA into a ring of 2 to 4 stages: the key tile's k
//     codes of the head's hd lanes (128-code boxes, the 128-byte swizzle
//     8-bit wgmma reads K-major), its V column blocks and its 32 k scales;
//     so N has no ceiling;
//   * S = qq . kq on wgmma m64n32k32 s8 x s8 -> s32, both operands from
//     shared memory (the q codes come once by TMA): only the q head's hd
//     lanes carry codes, so the dot equals JAX's over the pair's 2 hd lanes,
//     and the int32 sums are exact;
//   * the scores are dequantized in fp32 in JAX's order, exponentiated,
//     masked past N and summed into l, rounded to bf16 as P V's A fragments;
//     P V runs on bf16 wgmma against V read N-major, each tile's product
//     into a zeroed partial that a round-to-nearest add puts into o (the
//     MoE tail's device: chained inside the tensor cores the sums sat
//     farther from the plain version's, and the int8_attn forward's gates
//     with them);
//   * past head dim 256 (o no longer fits a thread's registers beside the
//     scores) both warpgroups compute the same S for one query tile and each
//     sums P V over its half of o's column blocks (WCB of them; a group of 2
//     WCB a block, more groups where the query tiles leave SMs idle); up to
//     256 each warpgroup owns a query tile of its own and all of o's
//     columns, so no score is computed twice;
//   * o * (1 / l) is rounded once and stored from the fragments.
// The codes, scales and int32 scores are the staged core's bits; only the
// fp32 sums of l and of P V (32-key tiles) can round otherwise.
#include "gemm.cuh"
#include "q8_codes.cuh"

namespace dyt {

constexpr int QR_THREADS = 256;          // two consumer warpgroups
constexpr int QR_KT = 32;                // keys a tile, the chunk of S
constexpr int QR_MAX_HD = 768;
constexpr int QR_MAX_CB = 4;             // o's 64-column blocks a warpgroup
constexpr int QR_BOX = QR_KT * 128;      // 128 codes, or 64 of V, of a tile
constexpr int QR_QBOX = 64 * 128;        // 128 codes of the 64-row q tile
constexpr int QR_SMEM_LIMIT = 232448;    // a block's shared memory on sm_90

struct QrPlan {
  int nkb;          // 128-code boxes of a head's codes: ceil(hd / 128)
  int ncb;          // o's 64-column blocks: hd / 64
  int groups;       // column groups of o a query tile (blocks a tile)
  int qtiles;       // query tiles a block: a warpgroup's own (2) or one
  int nvb;          // V column blocks a stage
  int stages;
  int stage_bytes;
  int smem;
};

// Shared memory of a plan: the q code boxes [qtiles][nkb], the ring
// (stages x (nkb k boxes + nvb V boxes)), each stage's 32 k scales, then a
// full and an empty barrier a stage and the q barrier; from a 1024-byte
// boundary.
static int qr_smem(int qbytes, int stages, int stage_bytes) {
  return 1024 + qbytes + stages * (stage_bytes + QR_KT * 4) +
         (2 * stages + 1) * 8;
}

// The plan for head dim ``hd`` and ``tiles`` query tiles on ``sms`` SMs
// (false where none fits): up to 256 a query tile a warpgroup with all of
// o's columns; past it xw_plan's choice (attention_sublayer.cu): the fewest
// column groups (or as many more as fill the SMs), then the fewest columns
// past hd; as many stages (at most four) as fit.
static bool qr_plan(int hd, long long tiles, int sms, QrPlan* p) {
  if (hd <= 0 || hd % 64 || hd > QR_MAX_HD) return false;
  const int ncb = hd / 64, nkb = (hd + 127) / 128;
  auto fit = [&](int groups, int qtiles, int nvb) {
    const int stage = (nkb + nvb) * QR_BOX;
    for (int st = 4; st >= 2; --st) {
      const int smem = qr_smem(qtiles * nkb * QR_QBOX, st, stage);
      if (smem <= QR_SMEM_LIMIT) {
        *p = QrPlan{nkb, ncb, groups, qtiles, nvb, st, stage, smem};
        return true;
      }
    }
    return false;
  };
  if (hd <= 256) return fit(1, 2, ncb);
  const long long fill = tiles < sms ? sms / tiles : 1;
  const int want = static_cast<int>(fill < (ncb + 1) / 2 ? fill
                                                         : (ncb + 1) / 2);
  bool found = false;
  int best_wcb = 0;
  QrPlan best{};
  for (int wcb = QR_MAX_CB; wcb >= 1; --wcb) {
    const int G = (ncb + 2 * wcb - 1) / (2 * wcb);
    if (G < want) continue;
    if (found && (G > best.groups ||
                  (G == best.groups &&
                   2 * wcb * G - ncb >= 2 * best_wcb * G - ncb)))
      continue;
    if (fit(G, 1, 2 * wcb)) {
      best = *p;
      best_wcb = wcb;
      found = true;
    }
  }
  *p = best;
  return found;
}

// o's column blocks a warpgroup of plan ``p``
static int qr_wcb(const QrPlan& p) {
  return p.qtiles == 2 ? p.ncb : p.nvb / 2;
}

// two blocks an SM at head dim 64 (107-111 registers a thread), one past it
// (169-239: o and a P V partial)
template <int WCB, bool ROWS2>
__global__ void __launch_bounds__(QR_THREADS, ROWS2 && WCB == 1 ? 2 : 1)
attn_core_q8_ring_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_ks,
                         const float* __restrict__ qs, bf16* __restrict__ out,
                         int N, int H, int hd, const QrPlan p) {
  constexpr int KT = QR_KT;
  constexpr int NS = KT / 2;                // score accumulators a thread
  constexpr int PS = KT / 16;               // k16 steps of P V a tile
  constexpr int W = 64 * WCB;               // a warpgroup's o columns
  // the V column blocks of a P V partial: all of a warpgroup's up to three
  // (one partial, added after the next tile's scores), else two at a time
  // (o and one partial beside the scores stay under 255 registers)
  constexpr int CH = WCB <= 3 ? WCB : 2;
  constexpr int NCH = WCB / CH;             // partials a tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  const int nkb = p.nkb, nst = p.stages, G = p.groups, nvb = p.nvb;
  const int qbytes = p.qtiles * nkb * QR_QBOX;
  unsigned char* ring = Qs + qbytes;
  float* kss = reinterpret_cast<float*>(ring + nst * p.stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(kss + nst * KT);
  uint64_t* empty = full + nst;
  uint64_t* qbar = empty + nst;

  const int C = H * hd, nt = (N + KT - 1) / KT, dk = hd / 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31, t2 = (lane & 3) * 2;
  const int g = lane >> 2;
  // this warpgroup's query tile, the block's first V column block and the
  // warpgroup's first o column block (of the head's)
  const int qt = ROWS2 ? blockIdx.x * 2 + wg : blockIdx.x / G;
  const int vcb = ROWS2 ? 0 : (blockIdx.x % G) * nvb;
  const int cb0 = vcb + (ROWS2 ? 0 : wg * WCB);
  const unsigned char* Qw = Qs + (ROWS2 ? wg * nkb * QR_QBOX : 0);
  const bool live = qt * 64 + warp * 16 < N;       // the same for the warp

  // key tile i into stage i % nst: the head's k code boxes, the block's V
  // column blocks (zeros past hd and past N), the pair's 32 k scales
  auto issue = [&](int i) {
    const int st = i % nst;
    unsigned char* dst = ring + st * p.stage_bytes;
    mbar_expect_tx(&full[st], (nkb + nvb) * QR_BOX + KT * 4);
    for (int c = 0; c < nkb; ++c)
      tma_load_3d(dst + c * QR_BOX, &map_k, &full[st], h * hd + 128 * c,
                  i * KT, b);
    for (int c = 0; c < nvb; ++c)
      tma_load_4d(dst + (nkb + c) * QR_BOX, &map_v, &full[st],
                  64 * (vcb + c), i * KT, h, b);
    tma_load_2d(kss + st * KT, &map_ks, &full[st], i * KT,
                b * (H / 2) + h / 2);
  };
  if (tid == 0) {
    for (int st = 0; st < nst; ++st) {
      mbar_init(&full[st], 1);                      // thread 0's arrive
      mbar_init(&empty[st], QR_THREADS / 32);       // lane 0 of each warp
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    // the q code tiles (zeros past N), then the first key tiles
    mbar_expect_tx(qbar, qbytes);
    for (int r = 0; r < p.qtiles; ++r)
      for (int c = 0; c < nkb; ++c)
        tma_load_3d(Qs + (r * nkb + c) * QR_QBOX, &map_q, qbar,
                    h * hd + 128 * c,
                    (ROWS2 ? blockIdx.x * 2 + r : qt) * 64, b);
    for (int i = 0; i < nt && i < nst; ++i) issue(i);
  }
  const int n_lo = qt * 64 + warp * 16 + g, n_hi = n_lo + 8;
  const float qs_lo = n_lo < N ? qs[((size_t)b * N + n_lo) * H + h] : 0.f;
  const float qs_hi = n_hi < N ? qs[((size_t)b * N + n_hi) * H + h] : 0.f;
  mbar_wait(qbar, 0);

  // o sums each tile's P V partial (a wgmma chain over the tile's 32 keys
  // from zero) with a round-to-nearest add: the tensor cores' own chained
  // sums land farther from the plain version's fp32 sums (PERF.md)
  float o[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
  float pv[32 * CH];
  float l_lo = 0.f, l_hi = 0.f;
  int s[NS];
  // P V of the tile in pf into the partial of column blocks ch * CH ..
  // from V tile Vt: issued and committed, not awaited
  auto pv_issue = [&](const unsigned (&pf)[PS][4], const unsigned char* Vt,
                      int ch) {
    wgmma_fence();
#pragma unroll
    for (int st2 = 0; st2 < PS; ++st2)
      wgmma_rs<64 * CH, true>(
          pv, pf[st2],
          desc_sw128_mn(Vt + (cb0 - vcb + ch * CH) * QR_BOX + st2 * 16 * 128,
                        QR_BOX),
          st2 > 0);
    wgmma_commit();
  };
  // the awaited partial of column blocks ch * CH .. added to o
  auto pv_add = [&](int ch) {
    fence_regs(pv);
#pragma unroll
    for (int i = 0; i < 32 * CH; ++i)
      o[ch * 32 * CH + i] = __fadd_rn(o[ch * 32 * CH + i], pv[i]);
  };
  for (int i = 0; i < nt; ++i) {
    const int st = i % nst;
    mbar_wait(&full[st], (i / nst) & 1);
    const unsigned char* Kt = ring + st * p.stage_bytes;
    const unsigned char* Vt = Kt + nkb * QR_BOX;
    // S of tile i over the head's hd lanes, int32
    wgmma_fence();
    for (int d = 0; d < dk; ++d)
      wgmma_ss_s8<KT>(s, desc_sw128(Qw + (d >> 2) * QR_QBOX + (d & 3) * 32),
                      desc_sw128(Kt + (d >> 2) * QR_BOX + (d & 3) * 32),
                      d > 0);
    wgmma_commit();
    wgmma_wait<0>();               // these scores, and the last P V
    fence_regs(s);
    if (i > 0) pv_add(NCH - 1);                  // tile i - 1's last partial
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
    // e = expf(clip((float(s) * qs) * ks, -60, 80) - 20), zero past N;
    // element 4 j + e of s is key i * KT + 8 j + t2 + (e & 1) of row g + 8
    // (e >> 1) of the warp's 16
    unsigned pf[PS][4];
    if (live) {
      const bool last = i * KT + KT > N;
      const float* ksr = kss + st * KT;
      float e[NS];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        const int k0 = j * 8 + t2;
        const float2 kscl = *reinterpret_cast<const float2*>(ksr + k0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float sv = mul(mul(__int2float_rn(s[4 * j + c]),
                                   c < 2 ? qs_lo : qs_hi),
                               (c & 1) ? kscl.y : kscl.x);
          float ev = expf(fminf(fmaxf(sv, -60.f), 80.f) - 20.f);
          if (last && i * KT + k0 + (c & 1) >= N) ev = 0.f;
          e[4 * j + c] = ev;
        }
        l_lo += e[4 * j] + e[4 * j + 1];
        l_hi += e[4 * j + 2] + e[4 * j + 3];
      }
      // the A fragments of P V, one per 16 keys (two n8 score tiles)
#pragma unroll
      for (int st2 = 0; st2 < PS; ++st2)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          pf[st2][c] = pack_bf16x2(e[8 * st2 + 2 * c], e[8 * st2 + 2 * c + 1]);
    } else {
#pragma unroll
      for (int st2 = 0; st2 < PS; ++st2)
        pf[st2][0] = pf[st2][1] = pf[st2][2] = pf[st2][3] = 0u;
    }
    // the partials but the last one awaited here; the last under the next
    // tile's scores
#pragma unroll
    for (int ch = 0; ch + 1 < NCH; ++ch) {
      pv_issue(pf, Vt, ch);
      wgmma_wait<0>();
      pv_add(ch);
    }
    pv_issue(pf, Vt, NCH - 1);
  }
  wgmma_wait<0>();
  pv_add(NCH - 1);
  if (!live) return;

  // each row's l is spread over the four lanes of its quad
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, m);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, m);
  }
  const float inv_lo = __frcp_rn(l_lo), inv_hi = __frcp_rn(l_hi);
  bf16* ob = out + (size_t)b * N * C + h * hd + cb0 * 64;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    if (cb0 + j / 8 >= p.ncb) break;        // columns past hd
    const int col = j * 8 + t2;
    if (n_lo < N)
      store2(ob + (size_t)n_lo * C + col, o[4 * j] * inv_lo,
             o[4 * j + 1] * inv_lo);
    if (n_hi < N)
      store2(ob + (size_t)n_hi * C + col, o[4 * j + 2] * inv_hi,
             o[4 * j + 3] * inv_hi);
  }
}

template <int WCB, bool ROWS2>
static cudaError_t launch_q8_ring(const CUtensorMap (&maps)[4],
                                  const float* qs, bf16* out, int B, int N,
                                  int H, int hd, const QrPlan& p,
                                  cudaStream_t s) {
  auto kernel = attn_core_q8_ring_kernel<WCB, ROWS2>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  const int nq = (N + 63) / 64;
  const dim3 grid(ROWS2 ? (nq + 1) / 2 : nq * p.groups, H, B);
  kernel<<<grid, QR_THREADS, p.smem, s>>>(maps[0], maps[1], maps[2], maps[3],
                                          qs, out, N, H, hd, p);
  return cudaGetLastError();
}

// K10 on the ring: bf16 qkv [B, N, 3C] -> out [B, N, C] (H even, head dim
// a multiple of 64 up to QR_MAX_HD); scratch of ScQ8Scratch's bytes.
static cudaError_t attn_core_q8_ring(const bf16* qkv, bf16* out,
                                     void* scratch, int B, int N, int C,
                                     int H, float scale, cudaStream_t s) {
  if (B <= 0 || N <= 0 || H <= 0 || H % 2 || C % H || B > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  const int hd = C / H;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  QrPlan p;
  if (!qr_plan(hd, (long long)(N + 63) / 64 * H * B, sms, &p))
    return cudaErrorInvalidValue;
  const ScQ8Scratch L(B, N, C, H);
  const long long hp = H / 2;
  err = q8_codes(qkv, scratch, B, N, C, H, scale, s);
  if (err != cudaSuccess) return err;
  auto* base = static_cast<unsigned char*>(scratch);
  // the q and k codes [B][N][C] int8 in 128-code boxes of 64 or 32 rows, V
  // (as head_map: [B][H][N][hd] bf16 in 64-column boxes of 32 rows), the
  // k scales [B * H/2][Np] fp32 in rows of 32, unswizzled; zeros past each
  // edge
  CUtensorMap maps[4] = {};
  const cuuint64_t cdims[3] = {static_cast<cuuint64_t>(C),
                               static_cast<cuuint64_t>(N),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t cstrides[2] = {static_cast<cuuint64_t>(C),
                                  static_cast<cuuint64_t>(N) * C};
  const cuuint32_t qbox[3] = {128, 64, 1};
  const cuuint32_t kbox[3] = {128, QR_KT, 1};
  err = tensor_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, base + L.qc, 3,
                   cdims, cstrides, qbox);
  if (err != cudaSuccess) return err;
  err = tensor_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, base + L.kc, 3,
                   cdims, cstrides, kbox);
  if (err != cudaSuccess) return err;
  const long long C3 = 3LL * C;
  const cuuint64_t vdims[4] = {static_cast<cuuint64_t>(hd),
                               static_cast<cuuint64_t>(N),
                               static_cast<cuuint64_t>(H),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t vstrides[3] = {static_cast<cuuint64_t>(C3) * 2,
                                  static_cast<cuuint64_t>(hd) * 2,
                                  static_cast<cuuint64_t>(N * C3) * 2};
  const cuuint32_t vbox[4] = {64, QR_KT, 1, 1};
  err = tensor_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, qkv + 2 * C,
                   4, vdims, vstrides, vbox);
  if (err != cudaSuccess) return err;
  const cuuint64_t kdims[2] = {static_cast<cuuint64_t>(N),
                               static_cast<cuuint64_t>(B * hp)};
  const cuuint64_t kstrides[1] = {static_cast<cuuint64_t>(L.np) * 4};
  const cuuint32_t ksbox[2] = {QR_KT, 1};
  err = tensor_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base + L.ks, 2,
                   kdims, kstrides, ksbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  const auto* qs = reinterpret_cast<const float*>(base + L.qs);
  const int wcb = qr_wcb(p);
  if (p.qtiles == 2) {
    switch (wcb) {
      case 1: return launch_q8_ring<1, true>(maps, qs, out, B, N, H, hd, p, s);
      case 2: return launch_q8_ring<2, true>(maps, qs, out, B, N, H, hd, p, s);
      case 3: return launch_q8_ring<3, true>(maps, qs, out, B, N, H, hd, p, s);
      default:
        return launch_q8_ring<4, true>(maps, qs, out, B, N, H, hd, p, s);
    }
  }
  switch (wcb) {
    case 1: return launch_q8_ring<1, false>(maps, qs, out, B, N, H, hd, p, s);
    case 2: return launch_q8_ring<2, false>(maps, qs, out, B, N, H, hd, p, s);
    case 3: return launch_q8_ring<3, false>(maps, qs, out, B, N, H, hd, p, s);
    default:
      return launch_q8_ring<4, false>(maps, qs, out, B, N, H, hd, p, s);
  }
}

}  // namespace dyt

extern "C" {

// K10 on the wgmma key ring: qkv [B, N, 3C] bf16 -> out [B, N, C] bf16 (H
// even, C / H a multiple of 64 up to 768); scratch of
// dyt_simt_core_q8_scratch_bytes(B, N, C, H) bytes on 16 bytes, for the
// codes.  Returns a cudaError_t value.
int dyt_attn_core_q8_ring(const void* qkv, void* out, void* scratch, int B,
                          int N, int C, int H, float scale, void* stream) {
  return dyt::attn_core_q8_ring(static_cast<const dyt::bf16*>(qkv),
                                static_cast<dyt::bf16*>(out), scratch, B, N,
                                C, H, scale,
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
