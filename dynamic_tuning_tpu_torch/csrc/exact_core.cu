// The exact fp32 attention core on the FP64 tensor cores (DMMA): the core
// of the int8 chains K6 and K8 with fp32 adapters (quant.cu's sublayer with
// an fp32 qkv scratch), whose output is requantized for proj, so its sums
// are float64 as the plain version's are and it lands on the plain
// version's bits.  It replaces, inside those chains, the TPU kernels'
// serving core dynamic_tuning_tpu/ops/mha_serving.py::attn_core_pairs (as
// quant.py::dyt_prologue_serving_q8 and dyt_prologue_serving_q8_moe run it
// on fp32 adapters).  Per query row of each head, on raw fp32 qkv:
//   q' = fp32(q * scale);  s = fp32(q' . k summed in float64)
//   e = expf(clip(s, -60, 80) - 20);  l = fp32(sum of e in float64)
//   o = fp32(e @ v summed in float64) * (1 / l)
// Head dims 64 to 256 take this kernel; past 256 the chain runs the SIMT
// slices kernel's exact form instead (simt_core.cu, dyt_simt_core_exact;
// ops/mha_serving.py::core_of's "simt_exact").
//
// What bounds it on an H100.  At B = 32, N = 197, 12 heads of 64 the two
// products are 1.9 G multiply-adds in float64: 0.057 ms at the 67 TFLOP/s
// of the FP64 tensor cores, against 0.011 ms of bytes.  A conversion of an
// fp32 value to float64 issues 16 a clock an SM, an eighth of the FP32
// rate, so each operand is converted a few times a block at most, never
// once per multiply-add.
//
// What the design does about it.  A block owns QT query rows (16 a row
// group) of one (sample, head) and walks the keys in chunks of KC:
//   * a warp owns 16 query rows and 64 columns of o (CW = hd / 64 warps a
//     row group), its slice of q' in fp32 (registers, or at hd 64 shared
//     memory), converted as its A fragments are formed;
//   * each chunk of K and V comes in by cp.async through two fp32 stages
//     (chunk c + 1 in flight while chunk c is computed); the block converts
//     it once into float64 K and V rows padded so that the fragment loads
//     of a half warp fall on distinct banks;
//   * S = q' K^T on m16n8k8 DMMA: each warp over its 64 columns of hd, the
//     row group's partial sums added in a fixed order through shared memory
//     (CW > 1), so every warp of the group holds the same s;
//   * e goes from the S accumulators straight into the A fragments of P V:
//     the accumulator's columns (2t, 2t + 1) are taken as the keys of A's
//     columns (t, t + 4), and V's fragment rows follow the same order, so no
//     value moves between lanes;
//   * l is summed in float64 over the quad's keys, then across the quad.
// Key chunks of 16; query tiles of 64 rows at hd 64 (4 blocks of 4 warps
// an SM) and 32 rows past it (hd 128: 3 blocks of 4 warps; 192: 2 of 6;
// 256: 1 of 8), so at least 8 warps of products are in flight on each SM.
//
// Its int8-score mode (Q8, route "q8_exact") is K10 on fp32 qkv: the
// function of dynamic_tuning_tpu/ops/quant.py::attn_core_pairs_q8 in the
// weights' dtype (fp32 K10, and K6 / K8 with fp32 adapters and int8
// scores), replacing simt_core_q8.cu's SIMT form at head dims 64 to 256:
//   q codes: fp32(q * scale) quantized per head row; k codes: k centred by
//   its lane mean over the N tokens (float64 sum, one rounding), quantized
//   per row of its head pair (IEEE 127 / amax, half to even), both from
//   q8_codes.cuh's two kernels into device memory;
//   s = fp32(q codes . k codes) * qs * ks;  e, l and o as above.
// What bounds it: the float64 P V (0.95 G multiply-adds at B = 32, N =
// 197, 12 heads of 64: 0.028 ms at the FP64 tensor peak; the int8 Q K^T is
// ~0.001 ms of IMMA work).  What the design does: the exact kernel's walk
// with S on mma.sync m16n8k32 s8 (IMMA) over the codes: a chunk's k codes
// (a quarter of its fp32 bytes) and k scales come in by cp.async beside V,
// no K is converted to float64, and the int32 accumulators of m16n8k32 sit
// where m16n8k8's float64 ones do (rows g, g + 8, columns 2t, 2t + 1), so
// e feeds P V's A fragments the same way.  Each warp of a row group
// computes the whole head's int32 s itself (hd / 32 IMMA steps a key
// tile, from q code fragments held in registers): no partial sums cross
// warps, and a chunk takes two barriers, not three.  At hd 64 the mode
// walks keys in chunks of 32 with query tiles of 128 rows (2 blocks of 8
// warps an SM), at hd 256 in chunks of 32: half the barriers a key, and
// at hd 64 each converted V chunk serves twice the rows.
#include "dmma.cuh"
#include "q8_codes.cuh"

namespace dyt {

template <int HD, bool Q8>
struct XcPlan {
  static constexpr int CW = HD / 64;              // warps a row group
  static constexpr int RG = HD == 64 ? (Q8 ? 8 : 4) : 2;   // row groups
  static constexpr int QT = 16 * RG;              // query rows a block
  static constexpr int THREADS = 32 * RG * CW;
  static constexpr int MIN_BLOCKS =
      HD == 64 ? (Q8 ? 2 : 4) : HD == 128 ? 3 : HD == 192 ? 2 : 1;
  static constexpr int KC =                                 // keys a chunk
      Q8 && (HD == 64 || HD == 256) ? 32 : 16;
  static constexpr int NT = KC / 8;               // S n-tiles a chunk
  static constexpr int LDK = HD + 4;              // doubles a K row
  static constexpr int LDV = HD + 2;              // doubles a V row
  static constexpr int LDQ = HD + 16;             // bytes a row of k codes
  // q' fragments in shared memory (QS: at hd 64, where four blocks an SM
  // leave 128 registers a thread) rather than in registers
  static constexpr bool QS = HD == 64 && !Q8;
  // shared memory (bytes): two stages of K [KC][HD] (fp32, or with Q8 the
  // int8 codes) and fp32 V [KC][HD] (with Q8 then the chunk's k scales
  // [KC]); the float64 K [KC][LDK] (with Q8 the code rows [KC][LDQ] and
  // the k scales [KC]) and V [KC][LDV], with CW > 1 the row groups'
  // partial scores [RG][CW][NT][32 lanes][4], with QS each warp's q'
  // fragments [8 k-steps][32 lanes] as float4
  static constexpr int KBYTES = KC * HD * (Q8 ? 1 : 4);
  static constexpr int KS_OFF = KBYTES + KC * HD * 4;   // in a stage
  static constexpr int STAGE = KS_OFF + (Q8 ? KC * 4 : 0);
  static constexpr int KD_OFF = 2 * STAGE;
  static constexpr int VD_OFF =
      KD_OFF + (Q8 ? KC * LDQ + KC * 4 : KC * LDK * 8);
  static constexpr int SP_OFF = VD_OFF + KC * LDV * 8;
  static constexpr int QS_OFF =
      SP_OFF + (CW > 1 && !Q8 ? RG * CW * NT * 32 * 4 * 8 : 0);
  static constexpr int BYTES = QS_OFF + (QS ? RG * CW * 8 * 32 * 16 : 0);
};

// The int8-score mode's inputs: q8_codes.cuh's codes and scales
struct XcQ8 {
  const int8_t* qc;          // q codes [B*N, C]
  const int8_t* kc;          // k codes [B*N, C]
  const float* qs;           // q scales [B*N, H]
  const float* ks;           // k scales [B, H/2, np]
  int np;
};

// c += a * b on the int8 tensor cores (IMMA): A 16 x 32 (row), B 32 x 8
// (col), s32 sums.  A: a0 (g, 4t..4t+3), a1 (g + 8, 4t..), a2 (g, 16 + 4t
// ..), a3 (g + 8, 16 + 4t ..); B: b0 (4t..4t+3, g), b1 (16 + 4t .., g);
// C as m16n8k8's (dmma.cuh).  Four codes a register, the lowest column in
// the lowest byte.
__device__ __forceinline__ void imma_16x8x32(int (&c)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int HD, bool Q8>
__global__ void __launch_bounds__(XcPlan<HD, Q8>::THREADS,
                                  XcPlan<HD, Q8>::MIN_BLOCKS)
exact_core_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                  int N, int H, float scale, const XcQ8 q8) {
  using P = XcPlan<HD, Q8>;
  constexpr int KC = P::KC, NT = P::NT, CW = P::CW;
  constexpr int PIECES = KC * (HD / 4);     // 16-byte pieces of fp32 rows
  extern __shared__ __align__(16) unsigned char xc_smem[];
  unsigned char* stage = xc_smem;
  double* Kd = reinterpret_cast<double*>(xc_smem + P::KD_OFF);
  unsigned char* Kq = xc_smem + P::KD_OFF;                  // Q8: codes
  float* Ksc = reinterpret_cast<float*>(Kq + KC * P::LDQ);  // Q8: scales
  double* Vd = reinterpret_cast<double*>(xc_smem + P::VD_OFF);
  double* Sp = reinterpret_cast<double*>(xc_smem + P::SP_OFF);

  const int q0 = blockIdx.x * P::QT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * HD;
  const long long C3 = 3LL * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / CW, cw = warp % CW;
  const int r0 = q0 + 16 * rg;                // this warp's first row
  const bool active = r0 < N;
  const float* base = qkv + (long long)b * N * C3 + h * HD;
  const int nch = (N + KC - 1) / KC;

  // chunk ch of K (fp32, or the codes and k scales) and V into stage st
  // (zeros past N)
  auto load = [&](int ch, int st) {
    unsigned char* sb = stage + st * P::STAGE;
    for (int i = tid; i < (Q8 ? 1 : 2) * PIECES; i += P::THREADS) {
      const int isv = Q8 || i >= PIECES;
      const int j = i >= PIECES ? i - PIECES : i;
      const int r = j / (HD / 4), c = (j % (HD / 4)) * 4;
      const int n = ch * KC + r;
      const float* src = base + (long long)n * C3 + (isv ? 2 : 1) * C + c;
      cp_async16(sb + (isv ? P::KBYTES : 0) + (r * HD + c) * 4,
                 n < N ? src : qkv, n < N ? 16 : 0);
    }
    if constexpr (Q8) {
      for (int i = tid; i < KC * (HD / 16) + KC; i += P::THREADS) {
        if (i < KC * (HD / 16)) {
          const int r = i / (HD / 16), c = (i % (HD / 16)) * 16;
          const int n = ch * KC + r;
          cp_async16(sb + r * HD + c,
                     n < N ? q8.kc + ((long long)b * N + n) * C + h * HD + c
                           : q8.kc,
                     n < N ? 16 : 0);
        } else {
          const int n = ch * KC + i - KC * (HD / 16);
          cp_async4(sb + P::KS_OFF + 4 * (i - KC * (HD / 16)),
                    n < N ? q8.ks + ((long long)b * (H / 2) + h / 2) * q8.np +
                                n
                          : q8.ks,
                    n < N ? 4 : 0);
        }
      }
    }
  };
  load(0, 0);
  cp_async_commit();
  if (nch > 1) load(1, 1);
  cp_async_commit();

  // q' = fp32(q * scale) of rows r0 + g (+ 8) at this warp's 64 columns:
  // qa[ks] = A fragment of k-step ks (columns 64 cw + 8 ks + t (+ 4));
  // with Q8 the q codes' fragments qa8[ks] over the whole head (columns
  // 32 ks + 4t (+ 16)) and the rows' q scales
  float qa[Q8 ? 1 : 8][4];
  unsigned qa8[Q8 ? HD / 32 : 1][4];
  float qsr[2];
  float4* qs4 = reinterpret_cast<float4*>(xc_smem + P::QS_OFF) +
                warp * 8 * 32 + lane;
  if constexpr (Q8) {
#pragma unroll
    for (int ks = 0; ks < HD / 32; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = r0 + g + 8 * (i & 1);
        const int d = 32 * ks + 4 * t + 16 * (i >> 1);
        qa8[ks][i] = n < N ? *reinterpret_cast<const unsigned*>(
                                 q8.qc + ((long long)b * N + n) * C +
                                 h * HD + d)
                           : 0u;
      }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int n = r0 + g + 8 * x;
      qsr[x] = n < N ? q8.qs[((long long)b * N + n) * H + h] : 0.f;
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = r0 + g + 8 * (i & 1);
        const int d = 64 * cw + 8 * ks + t + 4 * (i >> 1);
        qa[ks][i] = n < N ? __fmul_rn(base[(long long)n * C3 + d], scale)
                          : 0.f;
      }
  }

  if constexpr (P::QS) {
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      qs4[ks * 32] = make_float4(qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3]);
  }
  double o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.0;
  double l[2] = {0.0, 0.0};

  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<1>();                 // chunk ch landed (this thread's)
    __syncthreads();                    // ... and every thread's; the last
                                        // chunk's float64 rows are free
    {
      const unsigned char* sb = stage + (ch & 1) * P::STAGE;
      for (int i = tid; i < (Q8 ? 1 : 2) * PIECES; i += P::THREADS) {
        const int isv = Q8 || i >= PIECES;
        const int j = i >= PIECES ? i - PIECES : i;
        const int r = j / (HD / 4), c = (j % (HD / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(
            sb + (isv ? P::KBYTES : 0) + (r * HD + c) * 4);
        double* dst = isv ? Vd + r * P::LDV + c : Kd + r * P::LDK + c;
        reinterpret_cast<double2*>(dst)[0] = make_double2(v.x, v.y);
        reinterpret_cast<double2*>(dst)[1] = make_double2(v.z, v.w);
      }
      if constexpr (Q8) {
        // the codes into rows padded by 16 bytes (the B fragments' loads
        // of a warp on distinct banks), and the k scales
        for (int i = tid; i < KC * (HD / 16) + KC; i += P::THREADS) {
          if (i < KC * (HD / 16)) {
            const int r = i / (HD / 16), c = (i % (HD / 16)) * 16;
            *reinterpret_cast<int4*>(Kq + r * P::LDQ + c) =
                *reinterpret_cast<const int4*>(sb + r * HD + c);
          } else {
            Ksc[i - KC * (HD / 16)] = reinterpret_cast<const float*>(
                sb + P::KS_OFF)[i - KC * (HD / 16)];
          }
        }
      }
    }
    __syncthreads();                    // float64 K, V ready; stage free
    if (ch + 2 < nch) load(ch + 2, ch & 1);
    cp_async_commit();

    const int k0 = ch * KC;
    const int kn = N - k0 < KC ? N - k0 : KC;
    const int ntv = (kn + 7) / 8;       // n-tiles holding a key < N

    // --- s = q' . k over this warp's 64 columns of hd ----------------------
    // (Q8: the exact int32 sum of the codes over the whole head, held in
    // float64: each warp of a row group computes the same s, with no
    // exchange; the IMMA work is a small fraction of the DMMA P V's)
    double s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.0;
    if (active) {
      if constexpr (Q8) {
        int acc[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = 0;
#pragma unroll
        for (int ks = 0; ks < HD / 32; ++ks) {
          const unsigned char* kr = Kq + g * P::LDQ + 32 * ks + 4 * t;
#pragma unroll
          for (int j = 0; j < NT; ++j)
            if (j < ntv)
              imma_16x8x32(
                  acc[j], qa8[ks],
                  *reinterpret_cast<const unsigned*>(kr + 8 * j * P::LDQ),
                  *reinterpret_cast<const unsigned*>(kr + 8 * j * P::LDQ +
                                                     16));
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] = acc[j][i];
      } else {
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          float4 q4;
          if constexpr (P::QS)
            q4 = qs4[ks * 32];         // this thread's own: no barrier
          else
            q4 = make_float4(qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3]);
          const double a[4] = {q4.x, q4.y, q4.z, q4.w};
          const double* kr = Kd + g * P::LDK + 64 * cw + 8 * ks + t;
#pragma unroll
          for (int j = 0; j < NT; ++j)
            if (j < ntv)
              dmma_16x8x8(s[j], a, kr[8 * j * P::LDK],
                          kr[8 * j * P::LDK + 4]);
        }
      }
    }
    if constexpr (CW > 1 && !Q8) {
      // the row group's partial sums, added in the order of cw
      double* mine = Sp + ((rg * CW + cw) * NT * 32 + lane) * 4;
      if (active) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          reinterpret_cast<double2*>(mine + j * 128)[0] =
              make_double2(s[j][0], s[j][1]);
          reinterpret_cast<double2*>(mine + j * 128)[1] =
              make_double2(s[j][2], s[j][3]);
        }
      }
      __syncthreads();
      if (active) {
        const double* grp = Sp + (rg * CW * NT * 32 + lane) * 4;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const double2 p0 = reinterpret_cast<const double2*>(
              grp + j * 128)[0];
          const double2 p1 = reinterpret_cast<const double2*>(
              grp + j * 128)[1];
          s[j][0] = p0.x;
          s[j][1] = p0.y;
          s[j][2] = p1.x;
          s[j][3] = p1.y;
#pragma unroll
          for (int c = 1; c < CW; ++c) {
            const double2 u0 = reinterpret_cast<const double2*>(
                grp + (c * NT + j) * 128)[0];
            const double2 u1 = reinterpret_cast<const double2*>(
                grp + (c * NT + j) * 128)[1];
            s[j][0] += u0.x;
            s[j][1] += u0.y;
            s[j][2] += u1.x;
            s[j][3] += u1.y;
          }
        }
      }
    }
    if (!active) continue;

    // --- e, l, o += e @ v over this warp's 64 columns ----------------------
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= ntv) continue;
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 8 * j + 2 * t + (i & 1);
        float v = __double2float_rn(s[j][i]);
        if constexpr (Q8)   // (fp32(int32 sum) * qs) * ks, the plain order
          v = __fmul_rn(__fmul_rn(v, qsr[i >> 1]),
                        Ksc[8 * j + 2 * t + (i & 1)]);
        e[i] = key < N
                   ? expf(__fsub_rn(fminf(fmaxf(v, -60.f), 80.f), 20.f))
                   : 0.f;
        l[i >> 1] += static_cast<double>(e[i]);
      }
      // A's columns t, t + 4 are the keys 2t, 2t + 1 of this n-tile
      const double a[4] = {e[0], e[2], e[1], e[3]};
      const double* vr = Vd + (8 * j + 2 * t) * P::LDV + 64 * cw + g;
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
        dmma_16x8x8(o[nn], a, vr[8 * nn], vr[P::LDV + 8 * nn]);
    }
  }
  cp_async_wait<0>();
  if (!active) return;

  // --- l over the quad, o * (1 / l) ---------------------------------------
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int n = r0 + g + 8 * x;
    if (n >= N) continue;
    const float inv = __frcp_rn(__double2float_rn(l[x]));
    float* orow = out + ((long long)b * N + n) * C + h * HD + 64 * cw + 2 * t;
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
      *reinterpret_cast<float2*>(orow + 8 * nn) = make_float2(
          __fmul_rn(__double2float_rn(o[nn][2 * x]), inv),
          __fmul_rn(__double2float_rn(o[nn][2 * x + 1]), inv));
  }
}

template <int HD, bool Q8>
static cudaError_t launch_exact_core(const float* qkv, float* out, int B,
                                     int N, int H, float scale,
                                     const XcQ8& q8, cudaStream_t s) {
  using P = XcPlan<HD, Q8>;
  auto kernel = exact_core_kernel<HD, Q8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + P::QT - 1) / P::QT, H, B);
  kernel<<<grid, P::THREADS, P::BYTES, s>>>(qkv, out, N, H, scale, q8);
  return cudaGetLastError();
}

template <bool Q8>
static cudaError_t exact_core(const float* qkv, float* out, int B, int N,
                              int C, int H, float scale, const XcQ8& q8,
                              cudaStream_t s) {
  switch (C / H) {
    case 64: return launch_exact_core<64, Q8>(qkv, out, B, N, H, scale, q8, s);
    case 128:
      return launch_exact_core<128, Q8>(qkv, out, B, N, H, scale, q8, s);
    case 192:
      return launch_exact_core<192, Q8>(qkv, out, B, N, H, scale, q8, s);
    case 256:
      return launch_exact_core<256, Q8>(qkv, out, B, N, H, scale, q8, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dyt

extern "C" {

// The exact fp32 core on raw qkv [B, N, 3C] -> out [B, N, C], both fp32 and
// contiguous, its sums in float64 on DMMA, at head dims 64 to 256 (others
// are refused).  Returns a cudaError_t value.
int dyt_exact_core(const float* qkv, float* out, int B, int N, int C, int H,
                   float scale, void* stream) {
  if (H <= 0 || C % H || N <= 0 || B <= 0 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  return dyt::exact_core<false>(qkv, out, B, N, C, H, scale, dyt::XcQ8{},
                                static_cast<cudaStream_t>(stream));
}

// K10 on fp32 qkv [B, N, 3C] -> out [B, N, C] (its int8-score mode): the
// codes into ``scratch`` (dyt_simt_core_q8_scratch_bytes, on 16 bytes; two
// launches of q8_codes.cuh), then the kernel; H even, head dims 64 to 256.
// Returns a cudaError_t value.
int dyt_exact_core_q8(const float* qkv, float* out, void* scratch, int B,
                      int N, int C, int H, float scale, void* stream) {
  if (H <= 0 || H % 2 || C % H || N <= 0 || B <= 0 || B > 65535 ||
      H > 65535 || (C / H) % 64 || C / H > 256)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dyt::q8_codes(qkv, scratch, B, N, C, H, scale, s);
  if (err != cudaSuccess) return err;
  const dyt::ScQ8Scratch L(B, N, C, H);
  auto* base = static_cast<unsigned char*>(scratch);
  const dyt::XcQ8 q8{reinterpret_cast<const int8_t*>(base + L.qc),
                     reinterpret_cast<const int8_t*>(base + L.kc),
                     reinterpret_cast<const float*>(base + L.qs),
                     reinterpret_cast<const float*>(base + L.ks), L.np};
  return dyt::exact_core<true>(qkv, out, B, N, C, H, scale, q8, s);
}

}  // extern "C"
