// The fp32 serving attention core, register-tiled on the CUDA cores (FFMA).
//
// Replaces, on fp32 q, k and v, the TPU kernels' serving core: K1
// (dynamic_tuning_tpu/ops/mha_serving.py:110 _mha_fused_kernel), the core
// attn_core_pairs (:409) inside K2, K3 and K7 (attention_sublayer_serving,
// dyt_prologue_serving, dyt_prologue_serving_moe, all generic in their
// dtype), K9 (:283 _mha_windowed_kernel) with its bf16 [H, N, N] bias
// upcast at the score add.  Per query row of each head:
//   q' = q * scale (fp32);  s = q' . k (fp32) [+ fp32(bias)]
//   e = exp(clip(s, -60, 80) - 20) (expf, no row max);  l = sum(e)
//   o = (e @ v in fp32) * (1 / l)
// The serving softmax has no row max, so each key tile's e is final when it
// is computed: the walk over keys carries only l and o, never rescales.
// Where an int8 quantization follows (the fp32 cores inside K6 and K8) the
// exact route of simt_core.cuh (float64 sums) runs instead.  Head dims past
// 256, up to 768, take f32_core_xwide_kernel (its note below); past 768 the
// SIMT core of simt_core.cuh, where the caller routes it.
//
// Not TF32 or 3xTF32 on wgmma: the port's fp32 is full fp32, as JAX's, and
// wgmma takes tf32 operands only K-major (V would need a transposed copy).
//
// What bounds it on an H100.  At ViT-B/16 in fp32 (B = 32, N = 197, 12
// heads of 64) the two products are 3.8 GFLOP: 0.057 ms at the 67 TFLOP/s
// FFMA peak against 0.024 ms of bytes, so the FMAs bound it; the CUDA cores
// reach their rate only when every thread issues FMAs from registers with
// few shared-memory loads between them, and the 64-row tiles of N = 197
// waste a quarter of their rows and keys unless the ragged edges are
// skipped.
//
// What the design does about it (the register blocking of gemm_f32.cuh
// carried to attention).  A block of 256 threads owns 64 query rows of one
// (sample, head); thread (ty, tx) = (tid / 16, tid % 16) owns rows 4 ty ..
// 4 ty + 3, so warp w owns rows 8 w .. 8 w + 7:
//   * q' is scaled once into shared memory; K and V come in tiles of KT keys
//     (64 at hd 64, 32 past it) by cp.async into two stages, tile t + 1 in
//     flight while tile t computes;
//   * S = q' K^T: each thread a 4 x (KT / 16) micro-tile (its rows, keys tx
//     + 16 j) from float4 reads along hd: each q' read (a broadcast to the
//     half warp) and each k read feed four FMAs of each product row, 64
//     FMAs per 8 loads at KT = 64;
//   * the clamped expf and l in registers, e written k-major to a P tile
//     (one float4 a key: the thread's four rows);
//   * o += P V: each thread its 4 rows x HD / 16 columns (4 tx + 64 c ..
//     + 3), one float4 of P and HD / 64 of V a key, 16 HD / 64 FMAs;
//   * a warp whose rows all lie past N skips both products, and the last
//     key tile scores only the 16-key groups that hold keys, so N = 197
//     computes 200 rows and 208 keys rather than 256 and 256;
//   * l is summed over the half warp at the end and o * (1 / l) stored.
#include "common.cuh"

namespace dyt {

constexpr int FC_QT = 64;                  // query rows a block
constexpr int FC_THREADS = 4 * FC_QT;      // four rows a thread

// Shared memory (fp32 words): q' [QT][QW], K [2][KT][QW], V [2][KT][HD],
// P [KT][PW] (k-major), then K9's bias tile [QT][KT] in bf16.  QW = HD + 4:
// the half warp's k reads (keys tx + 16 j, one row each) fall on distinct
// banks; PW = QT + 4 likewise for the P stores.  Two blocks an SM at hd 64
// (110.6 KB, 128 registers a thread); past it one, so that the registers
// do not spill.
template <int HD>
struct FcLayout {
  static constexpr int KT = HD <= 64 ? 64 : 32;
  static constexpr int NJ = KT / 16;       // keys a thread scores a tile
  static constexpr int NC = HD / 64;       // float4 column groups of o
  static constexpr int QW = HD + 4;
  static constexpr int PW = FC_QT + 4;
  static constexpr int K_OFF = FC_QT * QW;
  static constexpr int V_OFF = K_OFF + 2 * KT * QW;
  static constexpr int P_OFF = V_OFF + 2 * KT * HD;
  static constexpr int B_OFF = P_OFF + KT * PW;
  static constexpr int BYTES = B_OFF * 4 + FC_QT * KT * 2;
  static constexpr int BLOCKS = HD == 64 ? 2 : 1;    // an SM
};

// Element strides (batch, head, row) of q, k, v and out, unit stride along
// hd; bias null or bf16 [H, N, N] with strides (bh, br, 1), bh and br
// multiples of 8, on 16 bytes, each row readable to N rounded up to 8
// (K9's layout, ops/mha_serving.py::_windowed_bias).
struct FcArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long sq[3], sk[3], sv[3], so[3];
  const bf16* bias;
  long long bh, br;
  int N, H;
  float scale;
};

// acc[i][j] = q'(row 4 ty + i) . k(key tx + 16 j) over hd, for the first
// NJA of the thread's NJ keys (the rest of a ragged last tile holds none)
template <int HD, int NJA>
__device__ __forceinline__ void fc_scores(const float* __restrict__ Qs,
                                          const float* __restrict__ Ks,
                                          int ty, int tx,
                                          float (&acc)[4][FcLayout<HD>::NJ]) {
  using L = FcLayout<HD>;
#pragma unroll 8
  for (int d = 0; d < HD; d += 4) {
    float4 qv[4], kv[NJA];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qv[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * L::QW + d);
#pragma unroll
    for (int j = 0; j < NJA; ++j)
      kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * L::QW +
                                               d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJA; ++j) {
        acc[i][j] = fmaf(qv[i].x, kv[j].x, acc[i][j]);
        acc[i][j] = fmaf(qv[i].y, kv[j].y, acc[i][j]);
        acc[i][j] = fmaf(qv[i].z, kv[j].z, acc[i][j]);
        acc[i][j] = fmaf(qv[i].w, kv[j].w, acc[i][j]);
      }
  }
}

template <int HD>
__global__ void __launch_bounds__(FC_THREADS, FcLayout<HD>::BLOCKS)
f32_core_kernel(const FcArgs a) {
  using L = FcLayout<HD>;
  constexpr int KT = L::KT, NJ = L::NJ, NC = L::NC;
  extern __shared__ __align__(16) float fc_smem[];
  float* Qs = fc_smem;
  float* Ks = fc_smem + L::K_OFF;
  float* Vs = fc_smem + L::V_OFF;
  float* Ps = fc_smem + L::P_OFF;
  bf16* Bs = reinterpret_cast<bf16*>(fc_smem + L::B_OFF);

  const int N = a.N, q0 = blockIdx.x * FC_QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const bool live = q0 + 8 * (tid >> 5) < N;       // the same for the warp
  const float* kb = a.k + b * a.sk[0] + h * a.sk[1];
  const float* vb = a.v + b * a.sv[0] + h * a.sv[1];
  const int nt = (N + KT - 1) / KT;
  const bf16* bb = a.bias != nullptr ? a.bias + h * a.bh : nullptr;

  // key tile t's bias block [QT][KT] (zeros past N: 16-byte chunks that
  // start at a key < N are read whole, inside the row's padding)
  auto issue_bias = [&](int t) {
    for (int i = tid; i < FC_QT * (KT / 8); i += FC_THREADS) {
      const int r = i / (KT / 8), c = (i % (KT / 8)) * 8;
      const int n = q0 + r, key = t * KT + c;
      const bool ok = n < N && key < N;
      cp_async16(Bs + r * KT + c, ok ? bb + n * a.br + key : bb,
                 ok ? 16 : 0);
    }
  };
  // key tile t's K and V into stage t & 1 (zeros past N), with tile 0's
  // bias
  auto issue = [&](int t) {
    float* kd = Ks + (t & 1) * KT * L::QW;
    float* vd = Vs + (t & 1) * KT * HD;
    for (int i = tid; i < KT * (HD / 4); i += FC_THREADS) {
      const int r = i / (HD / 4), c = (i % (HD / 4)) * 4, n = t * KT + r;
      const bool ok = n < N;
      cp_async16(kd + r * L::QW + c, ok ? kb + n * a.sk[2] + c : kb,
                 ok ? 16 : 0);
      cp_async16(vd + r * HD + c, ok ? vb + n * a.sv[2] + c : vb,
                 ok ? 16 : 0);
    }
    if (t == 0 && bb != nullptr) issue_bias(0);
    cp_async_commit();
  };
  issue(0);

  // q' = q * scale into shared memory, zeros past N
  {
    const float* qb = a.q + b * a.sq[0] + h * a.sq[1];
    for (int i = tid; i < FC_QT * (HD / 4); i += FC_THREADS) {
      const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < N) {
        v = *reinterpret_cast<const float4*>(qb + (q0 + r) * a.sq[2] + c);
        v = make_float4(__fmul_rn(v.x, a.scale), __fmul_rn(v.y, a.scale),
                        __fmul_rn(v.z, a.scale), __fmul_rn(v.w, a.scale));
      }
      *reinterpret_cast<float4*>(Qs + r * L::QW + c) = v;
    }
  }

  float o[4][NC][4];
  float l[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][c][e] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int k0 = t * KT, kn = N - k0 < KT ? N - k0 : KT;
    cp_async_wait<0>();            // this thread's copies of tile t
    // tile t, its bias block (and q') visible to all; every thread is past
    // tile t - 1's P V, so stage (t + 1) & 1 and the P tile are free
    __syncthreads();
    if (t + 1 < nt) issue(t + 1);
    const float* Kst = Ks + (t & 1) * KT * L::QW;
    const float* Vst = Vs + (t & 1) * KT * HD;
    if (live) {
      // --- scores of the 16-key groups that hold keys ---------------------
      const int nja = (kn + 15) / 16;
      float s[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
      if (nja == NJ) {
        fc_scores<HD, NJ>(Qs, Kst, ty, tx, s);
      } else if constexpr (NJ == 4) {
        if (nja == 1) fc_scores<HD, 1>(Qs, Kst, ty, tx, s);
        else if (nja == 2) fc_scores<HD, 2>(Qs, Kst, ty, tx, s);
        else fc_scores<HD, 3>(Qs, Kst, ty, tx, s);
      } else {
        fc_scores<HD, 1>(Qs, Kst, ty, tx, s);
      }
      // --- e = exp(clip(s [+ bias], -60, 80) - 20), l, P = e k-major --------
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j >= nja) continue;
        const int key = k0 + tx + 16 * j;
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          e[i] = 0.f;
          if (key < N) {
            float v = s[i][j];
            if (bb != nullptr)
              v = __fadd_rn(v, __bfloat162float(
                                   Bs[(4 * ty + i) * KT + tx + 16 * j]));
            e[i] = expf(__fsub_rn(fminf(fmaxf(v, -60.f), 80.f), 20.f));
          }
          l[i] += e[i];
        }
        *reinterpret_cast<float4*>(Ps + (tx + 16 * j) * L::PW + 4 * ty) =
            make_float4(e[0], e[1], e[2], e[3]);
      }
    }
    __syncthreads();               // the P tile is whole, the bias block read
    if (bb != nullptr && t + 1 < nt) {
      issue_bias(t + 1);           // under this tile's P V
      cp_async_commit();
    }
    if (live) {
      // --- o += P V over the tile's kn keys --------------------------------
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const float4 p = *reinterpret_cast<const float4*>(Ps + kk * L::PW +
                                                          4 * ty);
        const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 v = *reinterpret_cast<const float4*>(
              Vst + kk * HD + 64 * c + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            o[i][c][0] = fmaf(pr[i], v.x, o[i][c][0]);
            o[i][c][1] = fmaf(pr[i], v.y, o[i][c][1]);
            o[i][c][2] = fmaf(pr[i], v.z, o[i][c][2]);
            o[i][c][3] = fmaf(pr[i], v.w, o[i][c][3]);
          }
        }
      }
    }
  }
  if (!live) return;

  // --- l over the half warp, o * (1 / l) ---------------------------------
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 1; m < 16; m <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], m);
  float* ob = a.o + b * a.so[0] + h * a.so[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + 4 * ty + i;
    if (n >= N) continue;
    const float inv = __frcp_rn(l[i]);
    auto out = [&](float x) { return __fmul_rn(x, inv); };
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(ob + n * a.so[2] + 64 * c + 4 * tx) =
          make_float4(out(o[i][c][0]), out(o[i][c][1]), out(o[i][c][2]),
                      out(o[i][c][3]));
  }
}

template <int HD>
static cudaError_t launch_fc(const FcArgs& a, int B, cudaStream_t s) {
  using L = FcLayout<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      f32_core_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + FC_QT - 1) / FC_QT, a.H, B);
  f32_core_kernel<HD><<<grid, FC_THREADS, L::BYTES, s>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head dims past 256 (320, 384, ... up to FX_MAX_HD), hd a run-time count of
// 64-column blocks.  The layout above would hold q', two stages of K and of
// V as fp32 rows (~296 KB at hd 384) and o for 4 rows x hd / 16 columns a
// thread, so here:
//   * q' stays in shared memory (scaled once, rows of hd + 4 words), and K
//     and V come through a ring of 64-column slices of a KT-key tile ([KT]
//     [68] words, by cp.async, two to four deep): for each key tile, K's
//     ncb slices, then the V slices of the block's column group;
//   * S = q' K^T sums each thread's 4 x (KT / 16) micro-tile over the K
//     slices (f32_core_kernel's reads, a slice at a time: the micro-tile
//     does not depend on hd); after the last, the clamped expf, l and the
//     P tile;
//   * o's columns are split over blocks: a block owns at most FX_MAX_CB
//     column blocks (4 rows x 4 columns x FX_MAX_CB a thread, 96
//     registers), so up to hd 384 one group computes S once; past that S
//     is computed once a group, and so it is where the blocks of one group
//     would leave SMs idle and more groups fill them (K9 at B=1, N=1025 in
//     2 heads has 34 query tiles);
//   * P V then runs a V slice at a time into the slice's 16 accumulators.
// KT is 64 (64 FMAs per 8 loads in S, as the kernel above at hd 64) where
// its layout fits a block, else 32 (hd 640 and past).  The sums are those
// of the kernel above in its order over keys (S over hd in the same
// ascending order, four products an FMA chain), full fp32 FMAs and expf.
constexpr int FX_SW = 68;               // words a slice row (64 + 4)
constexpr int FX_MAX_CB = 6;            // o's 64-column blocks a block
constexpr int FX_MAX_HD = 768;

struct FxPlan {
  int ncb, kt, groups, ring, qw, smem;
};

// The plan for head dim ``hd`` and ``tiles`` query tiles on ``sms`` SMs,
// false where none fits a block.
static bool fx_plan(int hd, long long tiles, int sms, FxPlan* p) {
  if (hd <= 256 || hd % 64 || hd > FX_MAX_HD) return false;
  const int ncb = hd / 64;
  const long long fill = tiles < sms ? sms / tiles : 1;
  int groups = (ncb + FX_MAX_CB - 1) / FX_MAX_CB;
  if (groups < fill) groups = fill < ncb ? static_cast<int>(fill) : ncb;
  const int qw = hd + 4;
  for (int kt = 64; kt >= 32; kt /= 2) {
    for (int ring = 4; ring >= 2; --ring) {
      // q', the ring, the P tile [KT][PW], two bias blocks [64][KT] bf16
      const int smem = (FC_QT * qw + (ring + 1) * kt * FX_SW) * 4 +
                       2 * FC_QT * kt * 2;
      if (smem <= 232448) {
        *p = FxPlan{ncb, kt, groups, ring, qw, smem};
        return true;
      }
    }
  }
  return false;
}

template <int NJ, int NJA>
__device__ __forceinline__ void fx_scores(const float* __restrict__ Qs,
                                          int qw,
                                          const float* __restrict__ Ks,
                                          int ty, int tx,
                                          float (&acc)[4][NJ]) {
#pragma unroll 8
  for (int d = 0; d < 64; d += 4) {
    float4 qv[4], kv[NJA];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qv[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * qw + d);
#pragma unroll
    for (int j = 0; j < NJA; ++j)
      kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * FX_SW +
                                               d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJA; ++j) {
        acc[i][j] = fmaf(qv[i].x, kv[j].x, acc[i][j]);
        acc[i][j] = fmaf(qv[i].y, kv[j].y, acc[i][j]);
        acc[i][j] = fmaf(qv[i].z, kv[j].z, acc[i][j]);
        acc[i][j] = fmaf(qv[i].w, kv[j].w, acc[i][j]);
      }
  }
}

template <int KT>
__global__ void __launch_bounds__(FC_THREADS, 1)
f32_core_xwide_kernel(const FcArgs a, const FxPlan p) {
  constexpr int NJ = KT / 16, PW = FC_QT + 4;
  extern __shared__ __align__(16) float fx_smem[];
  const int ncb = p.ncb, qw = p.qw, R = p.ring, G = p.groups;
  float* Qs = fx_smem;
  float* ring = Qs + FC_QT * qw;
  float* Ps = ring + R * KT * FX_SW;
  bf16* Bs = reinterpret_cast<bf16*>(Ps + KT * PW);

  const int N = a.N, h = blockIdx.y, b = blockIdx.z;
  const int qt = blockIdx.x / G, grp = blockIdx.x % G, q0 = qt * FC_QT;
  const int cb0 = grp * ncb / G, ncbb = (grp + 1) * ncb / G - cb0;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const bool live = q0 + 8 * (tid >> 5) < N;       // the same for the warp
  const float* kb = a.k + b * a.sk[0] + h * a.sk[1];
  const float* vb = a.v + b * a.sv[0] + h * a.sv[1];
  const int nt = (N + KT - 1) / KT, U = ncb + ncbb, units = nt * U;
  const bf16* bb = a.bias != nullptr ? a.bias + h * a.bh : nullptr;

  // unit gi (key tile gi / U; its slice u = gi % U: K's column block u, or
  // V's cb0 + u - ncb) into ring slot gi % R, zeros past N, with a tile's
  // bias block beside its first slice; one commit group a unit (empty past
  // the last)
  auto issue = [&](int gi) {
    if (gi < units) {
      const int t = gi / U, u = gi % U;
      const bool isk = u < ncb;
      const float* src = isk ? kb + 64 * u : vb + 64 * (cb0 + u - ncb);
      const long long ld = isk ? a.sk[2] : a.sv[2];
      float* dst = ring + (gi % R) * KT * FX_SW;
      for (int i = tid; i < KT * 16; i += FC_THREADS) {
        const int r = i >> 4, c = (i & 15) * 4, n = t * KT + r;
        const bool ok = n < N;
        cp_async16(dst + r * FX_SW + c, ok ? src + n * ld + c : src,
                   ok ? 16 : 0);
      }
      if (u == 0 && bb != nullptr) {
        bf16* bd = Bs + (t & 1) * FC_QT * KT;
        for (int i = tid; i < FC_QT * (KT / 8); i += FC_THREADS) {
          const int r = i / (KT / 8), c = (i % (KT / 8)) * 8;
          const int n = q0 + r, key = t * KT + c;
          const bool ok = n < N && key < N;
          cp_async16(bd + r * KT + c, ok ? bb + n * a.br + key : bb,
                     ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };
  for (int gi = 0; gi < R - 1; ++gi) issue(gi);

  // q' = q * scale into shared memory, zeros past N
  {
    const float* qb = a.q + b * a.sq[0] + h * a.sq[1];
    for (int i = tid; i < FC_QT * (ncb * 16); i += FC_THREADS) {
      const int r = i / (ncb * 16), c = (i % (ncb * 16)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < N) {
        v = *reinterpret_cast<const float4*>(qb + (q0 + r) * a.sq[2] + c);
        v = make_float4(__fmul_rn(v.x, a.scale), __fmul_rn(v.y, a.scale),
                        __fmul_rn(v.z, a.scale), __fmul_rn(v.w, a.scale));
      }
      *reinterpret_cast<float4*>(Qs + r * qw + c) = v;
    }
  }

  float o[4][FX_MAX_CB][4];
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  float s[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < FX_MAX_CB; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][c][e] = 0.f;
  }

  for (int gi = 0; gi < units; ++gi) {
    const int t = gi / U, u = gi % U;
    const int k0 = t * KT, kn = N - k0 < KT ? N - k0 : KT;
    // unit gi's copies (this thread's), then everyone's; every thread is
    // past unit gi - 1, so its slot takes unit gi + R - 1
    switch (R) {
      case 2: cp_async_wait<0>(); break;
      case 3: cp_async_wait<1>(); break;
      default: cp_async_wait<2>(); break;
    }
    __syncthreads();
    issue(gi + R - 1);
    if (!live) continue;
    const float* sl = ring + (gi % R) * KT * FX_SW;
    if (u < ncb) {
      // --- scores of the 16-key groups that hold keys, slice u ------------
      const int nja = (kn + 15) / 16;
      if (nja == NJ) {
        fx_scores<NJ, NJ>(Qs + 64 * u, qw, sl, ty, tx, s);
      } else if constexpr (NJ == 4) {
        if (nja == 1) fx_scores<NJ, 1>(Qs + 64 * u, qw, sl, ty, tx, s);
        else if (nja == 2) fx_scores<NJ, 2>(Qs + 64 * u, qw, sl, ty, tx, s);
        else fx_scores<NJ, 3>(Qs + 64 * u, qw, sl, ty, tx, s);
      } else {
        fx_scores<NJ, 1>(Qs + 64 * u, qw, sl, ty, tx, s);
      }
      if (u < ncb - 1) continue;
      // --- e = exp(clip(s [+ bias], -60, 80) - 20), l, P = e k-major ------
      const bf16* bt = Bs + (t & 1) * FC_QT * KT;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int key = k0 + tx + 16 * j;
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          e[i] = 0.f;
          if (key < N) {
            float v = s[i][j];
            if (bb != nullptr)
              v = __fadd_rn(v, __bfloat162float(
                                   bt[(4 * ty + i) * KT + tx + 16 * j]));
            e[i] = expf(__fsub_rn(fminf(fmaxf(v, -60.f), 80.f), 20.f));
          }
          l[i] += e[i];
          s[i][j] = 0.f;
        }
        *reinterpret_cast<float4*>(Ps + (tx + 16 * j) * PW + 4 * ty) =
            make_float4(e[0], e[1], e[2], e[3]);
      }
    } else {
      // --- o += P V over the tile's kn keys, V slice c --------------------
      const int c = u - ncb;
#pragma unroll
      for (int cc = 0; cc < FX_MAX_CB; ++cc) {
        if (cc != c) continue;
#pragma unroll 4
        for (int kk = 0; kk < kn; ++kk) {
          const float4 pv =
              *reinterpret_cast<const float4*>(Ps + kk * PW + 4 * ty);
          const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
          const float4 v =
              *reinterpret_cast<const float4*>(sl + kk * FX_SW + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            o[i][cc][0] = fmaf(pr[i], v.x, o[i][cc][0]);
            o[i][cc][1] = fmaf(pr[i], v.y, o[i][cc][1]);
            o[i][cc][2] = fmaf(pr[i], v.z, o[i][cc][2]);
            o[i][cc][3] = fmaf(pr[i], v.w, o[i][cc][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!live) return;

  // --- l over the half warp, o * (1 / l) ---------------------------------
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 1; m < 16; m <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], m);
  float* ob = a.o + b * a.so[0] + h * a.so[1] + cb0 * 64;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + 4 * ty + i;
    if (n >= N) continue;
    const float inv = __frcp_rn(l[i]);
    auto out = [&](float x) { return __fmul_rn(x, inv); };
#pragma unroll
    for (int c = 0; c < FX_MAX_CB; ++c)
      if (c < ncbb)
        *reinterpret_cast<float4*>(ob + n * a.so[2] + 64 * c + 4 * tx) =
            make_float4(out(o[i][c][0]), out(o[i][c][1]), out(o[i][c][2]),
                        out(o[i][c][3]));
  }
}

template <int KT>
static cudaError_t launch_fx_kt(const FcArgs& a, int B, const FxPlan& p,
                                cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      f32_core_xwide_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + FC_QT - 1) / FC_QT * p.groups, a.H, B);
  f32_core_xwide_kernel<KT><<<grid, FC_THREADS, p.smem, s>>>(a, p);
  return cudaGetLastError();
}

static cudaError_t launch_fx(const FcArgs& a, int B, int hd, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  FxPlan p;
  if (!fx_plan(hd, (long long)(a.N + FC_QT - 1) / FC_QT * a.H * B, sms, &p))
    return cudaErrorInvalidValue;
  return p.kt == 64 ? launch_fx_kt<64>(a, B, p, s)
                    : launch_fx_kt<32>(a, B, p, s);
}

static cudaError_t f32_core(const FcArgs& a, int B, int hd, cudaStream_t s) {
  if (a.N <= 0 || B <= 0 || a.H <= 0 || B > 65535 || a.H > 65535)
    return cudaErrorInvalidValue;
  switch (hd) {
    case 64: return launch_fc<64>(a, B, s);
    case 128: return launch_fc<128>(a, B, s);
    case 192: return launch_fc<192>(a, B, s);
    case 256: return launch_fc<256>(a, B, s);
    default: return launch_fx(a, B, hd, s);
  }
}

}  // namespace dyt

extern "C" {

// The fp32 core on strided q, k, v [B, H, N, hd] -> out (K1's rounding);
// ``strides`` as dyt_mha_core's (batch, head, row of q, k, v
// and out; unit stride along hd; every stride a multiple of 8 elements and
// the operands on 16 bytes); head dim 64, 128, 192, 256 or a multiple of 64
// past 256 up to 768; bias null or bf16 [H, N, N] with head stride
// ``bias_head`` and row stride ``bias_row`` (unit column stride).  Returns a
// cudaError_t value.
int dyt_f32_core(const float* q, const float* k, const float* v, float* out,
                 const long long* strides, int B, int N, int H, int hd,
                 float scale, const void* bias, long long bias_head,
                 long long bias_row, void* stream) {
  dyt::FcArgs a{q, k, v, out, {}, {}, {}, {},
                static_cast<const dyt::bf16*>(bias), bias_head, bias_row, N,
                H, scale};
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  return dyt::f32_core(a, B, hd, static_cast<cudaStream_t>(stream));
}

// The fp32 core (K1's rounding) on the raw qkv [B, N, 3C] -> out [B, N, C],
// both fp32 and contiguous: the core of the fp32 sublayer chain
// (simt_chain.cu), head dims as dyt_f32_core's.  Returns a cudaError_t
// value.
int dyt_f32_core_qkv(const float* qkv, float* out, int B, int N, int C,
                     int H, float scale, void* stream) {
  if (H <= 0 || C % H) return cudaErrorInvalidValue;
  const long long hd = C / H, C3 = 3LL * C, rows = (long long)N * C3;
  const dyt::FcArgs a{qkv, qkv + C, qkv + 2 * C, out,
                      {rows, hd, C3}, {rows, hd, C3}, {rows, hd, C3},
                      {(long long)N * C, hd, C}, nullptr, 0, 0, N, H, scale};
  return dyt::f32_core(a, B, (int)hd, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
