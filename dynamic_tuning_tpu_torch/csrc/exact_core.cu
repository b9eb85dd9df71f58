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
#include "dmma.cuh"

namespace dyt {

template <int HD>
struct XcPlan {
  static constexpr int CW = HD / 64;              // warps a row group
  static constexpr int RG = HD == 64 ? 4 : 2;     // row groups a block
  static constexpr int QT = 16 * RG;              // query rows a block
  static constexpr int THREADS = 32 * RG * CW;
  static constexpr int MIN_BLOCKS =
      HD == 64 ? 4 : HD == 128 ? 3 : HD == 192 ? 2 : 1;
  static constexpr int KC = 16;                   // keys a chunk
  static constexpr int NT = KC / 8;               // S n-tiles a chunk
  static constexpr int LDK = HD + 4;              // doubles a K row
  static constexpr int LDV = HD + 2;              // doubles a V row
  // q' fragments in shared memory (QS: at hd 64, where four blocks an SM
  // leave 128 registers a thread) rather than in registers
  static constexpr bool QS = HD == 64;
  // shared memory (bytes): two fp32 stages of K and V [KC][HD], the
  // float64 K [KC][LDK] and V [KC][LDV], with CW > 1 the row groups'
  // partial scores [RG][CW][NT][32 lanes][4], with QS each warp's q'
  // fragments [8 k-steps][32 lanes] as float4
  static constexpr int STAGE = 2 * KC * HD * 4;
  static constexpr int KD_OFF = 2 * STAGE;
  static constexpr int VD_OFF = KD_OFF + KC * LDK * 8;
  static constexpr int SP_OFF = VD_OFF + KC * LDV * 8;
  static constexpr int QS_OFF =
      SP_OFF + (CW > 1 ? RG * CW * NT * 32 * 4 * 8 : 0);
  static constexpr int BYTES = QS_OFF + (QS ? RG * CW * 8 * 32 * 16 : 0);
};

template <int HD>
__global__ void __launch_bounds__(XcPlan<HD>::THREADS,
                                  XcPlan<HD>::MIN_BLOCKS)
exact_core_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                  int N, int H, float scale) {
  using P = XcPlan<HD>;
  constexpr int KC = P::KC, NT = P::NT, CW = P::CW;
  extern __shared__ __align__(16) unsigned char xc_smem[];
  float* stage = reinterpret_cast<float*>(xc_smem);
  double* Kd = reinterpret_cast<double*>(xc_smem + P::KD_OFF);
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

  // chunk ch of K and V into fp32 stage st (zeros past N)
  auto load = [&](int ch, int st) {
    float* ks = stage + st * (2 * KC * HD);
    for (int i = tid; i < 2 * KC * (HD / 4); i += P::THREADS) {
      const int isv = i >= KC * (HD / 4);
      const int j = isv ? i - KC * (HD / 4) : i;
      const int r = j / (HD / 4), c = (j % (HD / 4)) * 4;
      const int n = ch * KC + r;
      const float* src = base + (long long)n * C3 + (isv ? 2 : 1) * C + c;
      cp_async16(ks + isv * KC * HD + r * HD + c, n < N ? src : qkv,
                 n < N ? 16 : 0);
    }
  };
  load(0, 0);
  cp_async_commit();
  if (nch > 1) load(1, 1);
  cp_async_commit();

  // q' = fp32(q * scale) of rows r0 + g (+ 8) at this warp's 64 columns:
  // qa[ks] = A fragment of k-step ks (columns 64 cw + 8 ks + t (+ 4))
  float qa[8][4];
  float4* qs4 = reinterpret_cast<float4*>(xc_smem + P::QS_OFF) +
                warp * 8 * 32 + lane;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = r0 + g + 8 * (i & 1);
      const int d = 64 * cw + 8 * ks + t + 4 * (i >> 1);
      qa[ks][i] = n < N ? __fmul_rn(base[(long long)n * C3 + d], scale)
                        : 0.f;
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
      const float* ks = stage + (ch & 1) * (2 * KC * HD);
      for (int i = tid; i < 2 * KC * (HD / 4); i += P::THREADS) {
        const int isv = i >= KC * (HD / 4);
        const int j = isv ? i - KC * (HD / 4) : i;
        const int r = j / (HD / 4), c = (j % (HD / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(
            ks + isv * KC * HD + r * HD + c);
        double* dst = isv ? Vd + r * P::LDV + c : Kd + r * P::LDK + c;
        reinterpret_cast<double2*>(dst)[0] = make_double2(v.x, v.y);
        reinterpret_cast<double2*>(dst)[1] = make_double2(v.z, v.w);
      }
    }
    __syncthreads();                    // float64 K, V ready; stage free
    if (ch + 2 < nch) load(ch + 2, ch & 1);
    cp_async_commit();

    const int k0 = ch * KC;
    const int kn = N - k0 < KC ? N - k0 : KC;
    const int ntv = (kn + 7) / 8;       // n-tiles holding a key < N

    // --- s = q' . k over this warp's 64 columns of hd ----------------------
    double s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.0;
    if (active) {
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
    if constexpr (CW > 1) {
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
        const float v = __double2float_rn(s[j][i]);
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

template <int HD>
static cudaError_t launch_exact_core(const float* qkv, float* out, int B,
                                     int N, int H, float scale,
                                     cudaStream_t s) {
  using P = XcPlan<HD>;
  auto kernel = exact_core_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + P::QT - 1) / P::QT, H, B);
  kernel<<<grid, P::THREADS, P::BYTES, s>>>(qkv, out, N, H, scale);
  return cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 64: return dyt::launch_exact_core<64>(qkv, out, B, N, H, scale, s);
    case 128: return dyt::launch_exact_core<128>(qkv, out, B, N, H, scale, s);
    case 192: return dyt::launch_exact_core<192>(qkv, out, B, N, H, scale, s);
    case 256: return dyt::launch_exact_core<256>(qkv, out, B, N, H, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
