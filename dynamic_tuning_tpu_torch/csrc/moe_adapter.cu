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
// What bounds it on an H100.  At ViT-B serving shapes (M = 128*197 rows,
// C = 768, E = 4, b = 64) the two expert products are 4*M*C*W = 19.8 GFLOP of
// bf16 tensor work (~20 us at peak) while the kernel reads the fp32 x_mid
// (77 MB) and writes adapt (39 MB in bf16): ~35 us at 3.35 TB/s, bound by
// device-memory bytes.  Each block also pulls both expert stacks (2 * W * C
// bf16, 786 KB at W = 256) from L2 through shared memory.
//
// What the design does about it.  x_mid is read from device memory once: a
// block owns 64 rows and streams them in 64-column chunks, the next chunk's
// rows loading into registers while this one's products run.  Each chunk
// is rounded to bf16 for the down GEMM (mma.sync, fp32 accumulators)
// against the matching 64 columns of all W expert rows, staged with
// cp.async; the same fp32 chunk feeds the E + 1 router dots, summed in
// float64 over all 256 threads and rounded once (the plain version does the
// same, so the gates and logits do not depend on a summation order).  A
// warp keeps the down accumulators of its 16 rows and half of W in
// registers (64 at W = 256) -- not the A and H fragments too, as a straight
// copy of the dense adapter kernel (dyt_prologue.cu) would at ~190
// registers.  Then + bd, ReLU and the gate in fp32, one rounding into a
// bf16 H tile [64, W] in shared memory, and the up GEMM streams its A
// fragments from H over K = W.  Every tensor-core step's product is added
// with a round-to-nearest add (mma_bf16_16816_rn).  99 KB of shared memory
// at W = 256: two blocks an SM, one's loads under the other's products.
// + bd, x gate and (up + gates.Bu) * scale use __fadd_rn / __fmul_rn so
// nvcc contracts no rounding point away.
//
// Where the time goes: utils/moe_tail_ablation.py times this kernel with
// one phase taken out at a time (PERF.md).  No single phase holds it up;
// deeper pipelining (the next chunk's weights in flight during the
// products) and more rows per block (half the L2 weight traffic) are the
// next steps.
#include "common.cuh"

namespace dyt {

constexpr int MOE_ROWS = 64;          // rows per block
constexpr int MOE_THREADS = 256;      // 8 warps: 4 row groups x 2 column halves
constexpr int MOE_CHUNK = 64;         // x_mid columns / C columns per step
constexpr int MOE_LDA = MOE_CHUNK + 8;   // bf16 x chunk and Wd chunk stride
constexpr int MOE_LDF = MOE_CHUNK + 1;   // fp32 x chunk stride (router)
constexpr int MOE_MAX_W = 512;
static_assert(MOE_THREADS == 4 * MOE_ROWS, "a lane quad per row (router)");

__host__ __device__ inline size_t align128(size_t v) {
  return (v + 127) & ~(size_t)127;
}

// Shared-memory layout for E experts, W = E*b columns.
struct MoeLayout {
  int ldh;                             // H tile and Wu chunk row stride
  size_t f_off, a_off, w_off, h_off, r_off, g_off, q_off, bytes;
  __host__ __device__ MoeLayout(int E, int W) {
    ldh = W + 8;
    const size_t wd = (size_t)W * MOE_LDA * 2;          // Wd[0:W][64 cols]
    const size_t wu = (size_t)MOE_CHUNK * ldh * 2;      // Wu[64 rows][0:W]
    f_off = 0;                                          // fp32 x chunk
    a_off = f_off + align128((size_t)MOE_ROWS * MOE_LDF * 4);
    w_off = a_off + align128((size_t)MOE_ROWS * MOE_LDA * 2);
    h_off = w_off + align128(wd > wu ? wd : wu);
    r_off = h_off + align128((size_t)MOE_ROWS * ldh * 2);
    g_off = r_off + align128((size_t)(E + 1) * MOE_ROWS * 8);  // f64 dots
    q_off = g_off + align128((size_t)E * MOE_ROWS * 4);        // gates
    bytes = q_off + (size_t)(E + 1) * MOE_CHUNK * 4;   // router weights,
                                                        // then up biases
  }
};

// NP: the most 16-column pairs of W one warp owns in the down GEMM
// (ceil(W / 32)); the accumulators take 8 * NP registers.
template <int NP, typename TO>
__global__ void __launch_bounds__(MOE_THREADS, NP <= 8 ? 2 : 1)
moe_adapter_router_kernel(const float* __restrict__ xm, int M, int C,
                          const float* __restrict__ wr,
                          const bf16* __restrict__ wd,
                          const float* __restrict__ bd,
                          const bf16* __restrict__ wu,
                          const float* __restrict__ bu,
                          const float* __restrict__ ascale,
                          const float* __restrict__ wsel,
                          const float* __restrict__ bsel,
                          TO* __restrict__ adapt, float* __restrict__ logits,
                          int E, int b, float inv_tau) {
  const int W = E * b, P = W / 16;
  const MoeLayout L(E, W);
  extern __shared__ __align__(128) unsigned char moe_smem[];
  float* Xf = reinterpret_cast<float*>(moe_smem + L.f_off);
  bf16* As = reinterpret_cast<bf16*>(moe_smem + L.a_off);
  bf16* Ws = reinterpret_cast<bf16*>(moe_smem + L.w_off);   // Wd, then Wu
  bf16* Hs = reinterpret_cast<bf16*>(moe_smem + L.h_off);
  double* Rd = reinterpret_cast<double*>(moe_smem + L.r_off);  // [E+1][64]
  float* G = reinterpret_cast<float*>(moe_smem + L.g_off);     // [E][64]
  float* Rw = reinterpret_cast<float*>(moe_smem + L.q_off);    // [E+1][64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * MOE_ROWS;
  const int NR = E + (wsel != nullptr);      // dots per row

  for (int i = tid; i < NR * MOE_ROWS; i += MOE_THREADS) Rd[i] = 0.0;

  // mma.sync fragment addressing (as gemm_nt_kernel): A rows lane%16, k half
  // lane/16; B rows lane%8 (+8 for lanes 16..31), k half (lane/8)%2;
  // accumulator pairs at row g (+8), columns t2, t2+1 of each n8 tile
  const int a_row = lane & 15, a_k = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) * 8;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int wm0 = (warp & 3) * 16, half = warp >> 2;
  // the down GEMM's 16-column pairs of W: the first ceil(P/2) to half 0
  const int p0 = half ? (P + 1) / 2 : 0, np = half ? P / 2 : (P + 1) / 2;

  float acc[NP][2][4];
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][t][e] = 0.f;

  // --- down GEMM + router dots, one pass over the fp32 x_mid rows ----------
  // x pass p reads row p*16 + tid/16, columns (tid%16)*4..+3 of the chunk:
  // each half-warp one contiguous 256-byte row segment
  const int lrow = tid >> 4, lcol = (tid & 15) * 4;
  float4 xv4[MOE_ROWS / 16];          // this thread's part of the next chunk
  auto load_x = [&](int k0) {
#pragma unroll
    for (int p = 0; p < MOE_ROWS / 16; ++p) {
      const int gm = m0 + p * 16 + lrow;
      xv4[p] = gm < M ? *reinterpret_cast<const float4*>(
                            xm + (size_t)gm * C + k0 + lcol)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load_x(0);
  for (int k0 = 0; k0 < C; k0 += MOE_CHUNK) {
    for (int i = tid; i < W * (MOE_CHUNK / 8); i += MOE_THREADS) {
      const int n = i / (MOE_CHUNK / 8), c = (i % (MOE_CHUNK / 8)) * 8;
      cp_async16(Ws + n * MOE_LDA + c, wd + (size_t)n * C + k0 + c, 16);
    }
    cp_async_commit();
#pragma unroll
    for (int p = 0; p < MOE_ROWS / 16; ++p) {
      const int r = p * 16 + lrow;
      const float4 v = xv4[p];
      float* f = Xf + r * MOE_LDF + lcol;
      f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
      __align__(8) bf16 h[4] = {from_f32<bf16>(v.x), from_f32<bf16>(v.y),
                                from_f32<bf16>(v.z), from_f32<bf16>(v.w)};
      *reinterpret_cast<uint2*>(As + r * MOE_LDA + lcol) =
          *reinterpret_cast<const uint2*>(h);
    }
    for (int i = tid; i < NR * MOE_CHUNK; i += MOE_THREADS) {
      const int e = i / MOE_CHUNK, c = i % MOE_CHUNK;
      Rw[i] = e < E ? wr[(size_t)e * C + k0 + c] : wsel[k0 + c];
    }
    cp_async_wait<0>();
    __syncthreads();
    // the next chunk's rows load while this one's products run
    if (k0 + MOE_CHUNK < C) load_x(k0 + MOE_CHUNK);
    // router dots in float64 (fp32 products are exact there): the four
    // lanes of a quad take 16 columns each of one row, then add up
    {
      const int r = tid >> 2, c0 = (tid & 3) * 16;
      float xv[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) xv[c] = Xf[r * MOE_LDF + c0 + c];
      for (int e = 0; e < NR; ++e) {
        const float* w = Rw + e * MOE_CHUNK + c0;
        double s = 0.0;
#pragma unroll
        for (int c = 0; c < 16; ++c) s = fma((double)xv[c], (double)w[c], s);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if ((tid & 3) == 0) Rd[e * MOE_ROWS + r] += s;
      }
    }
#pragma unroll
    for (int kk = 0; kk < MOE_CHUNK; kk += 16) {
      unsigned af[4];
      ldmatrix_x4(af, As + (wm0 + a_row) * MOE_LDA + kk + a_k);
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        if (q >= np) break;
        unsigned r4[4];
        ldmatrix_x4(r4, Ws + ((p0 + q) * 16 + b_row) * MOE_LDA + kk + b_k);
        mma_bf16_16816_rn(acc[q][0], af, r4[0], r4[1]);
        mma_bf16_16816_rn(acc[q][1], af, r4[2], r4[3]);
      }
    }
    __syncthreads();
  }

  // --- expert softmax per row (max-subtracted, IEEE exp and division) ------
  if (tid < MOE_ROWS) {
    const int r = tid;
    float mx = -INFINITY;
    for (int e = 0; e < E; ++e) {
      const float v = __fmul_rn((float)Rd[e * MOE_ROWS + r], inv_tau);
      G[e * MOE_ROWS + r] = v;
      mx = fmaxf(mx, v);
    }
    float sum = 0.f;
    for (int e = 0; e < E; ++e) {
      const float ex = expf(__fadd_rn(G[e * MOE_ROWS + r], -mx));
      G[e * MOE_ROWS + r] = ex;
      sum = __fadd_rn(sum, ex);
    }
    for (int e = 0; e < E; ++e)
      G[e * MOE_ROWS + r] = __fdiv_rn(G[e * MOE_ROWS + r], sum);
    if (wsel != nullptr && m0 + r < M)
      logits[m0 + r] = __fadd_rn((float)Rd[E * MOE_ROWS + r], bsel[0]);
  }
  __syncthreads();

  // --- bottleneck: bf16(relu(down + bd) * gate) -> H ----------------------
  const int ldh = L.ldh;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    if (q >= np) break;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int c = (p0 + q) * 16 + t * 8 + t2;
      const float b0 = bd[c], b1 = bd[c + 1];
      const int e0 = c / b, e1 = (c + 1) / b;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm0 + g + hh * 8;
        const float h0 = fmaxf(__fadd_rn(acc[q][t][2 * hh], b0), 0.f);
        const float h1 = fmaxf(__fadd_rn(acc[q][t][2 * hh + 1], b1), 0.f);
        store2(Hs + r * ldh + c, __fmul_rn(h0, G[e0 * MOE_ROWS + r]),
               __fmul_rn(h1, G[e1 * MOE_ROWS + r]));
      }
    }
  }
  __syncthreads();

  // --- up GEMM per 64 output columns: (H . Wu^T + gates . Bu) * scale ------
  const float s = ascale[0];
  const int wn0 = half * 32;
  float* Bs = Rw;                     // Bu[0:E][n0:n0+64]
  for (int n0 = 0; n0 < C; n0 += MOE_CHUNK) {
    for (int i = tid; i < MOE_CHUNK * (W / 8); i += MOE_THREADS) {
      const int n = i / (W / 8), c = (i % (W / 8)) * 8;
      cp_async16(Ws + n * ldh + c, wu + (size_t)(n0 + n) * W + c, 16);
    }
    for (int i = tid; i < E * (MOE_CHUNK / 4); i += MOE_THREADS) {
      const int e = i / (MOE_CHUNK / 4), c = (i % (MOE_CHUNK / 4)) * 4;
      cp_async16(Bs + e * MOE_CHUNK + c, bu + (size_t)e * C + n0 + c, 16);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float u[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) u[j][e] = 0.f;
    for (int kk = 0; kk < W; kk += 16) {
      unsigned af[4];
      ldmatrix_x4(af, Hs + (wm0 + a_row) * ldh + kk + a_k);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        unsigned r4[4];
        ldmatrix_x4(r4, Ws + (wn0 + j * 8 + b_row) * ldh + kk + b_k);
        mma_bf16_16816_rn(u[j], af, r4[0], r4[1]);
        mma_bf16_16816_rn(u[j + 1], af, r4[2], r4[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + wn0 + j * 8 + t2;
      // gates . Bu: E products summed in float64, rounded once
      double ub[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
      for (int e = 0; e < E; ++e) {
        const float2 bb = load2(Bs + e * MOE_CHUNK + c - n0);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const double ge = G[e * MOE_ROWS + wm0 + g + hh * 8];
          ub[hh][0] = fma(ge, (double)bb.x, ub[hh][0]);
          ub[hh][1] = fma(ge, (double)bb.y, ub[hh][1]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int gm = m0 + wm0 + g + hh * 8;
        if (gm >= M) continue;
        store2(adapt + (size_t)gm * C + c,
               __fmul_rn(__fadd_rn(u[j][2 * hh], (float)ub[hh][0]), s),
               __fmul_rn(__fadd_rn(u[j][2 * hh + 1], (float)ub[hh][1]), s));
      }
    }
    __syncthreads();        // before the next Wu chunk overwrites Ws
  }
}

template <int NP, typename TO>
static cudaError_t launch_moe(const float* xm, int M, int C, const float* wr,
                              const bf16* wd, const float* bd, const bf16* wu,
                              const float* bu, const float* ascale,
                              const float* wsel, const float* bsel, TO* adapt,
                              float* logits, int E, int b, float inv_tau,
                              cudaStream_t st) {
  const int bytes = (int)MoeLayout(E, E * b).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      moe_adapter_router_kernel<NP, TO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  moe_adapter_router_kernel<NP, TO>
      <<<(M + MOE_ROWS - 1) / MOE_ROWS, MOE_THREADS, bytes, st>>>(
          xm, M, C, wr, wd, bd, wu, bu, ascale, wsel, bsel, adapt, logits, E,
          b, inv_tau);
  return cudaGetLastError();
}

template <typename TO>
static cudaError_t moe(const float* xm, int M, int C, const float* wr,
                       const bf16* wd, const float* bd, const bf16* wu,
                       const float* bu, const float* ascale, const float* wsel,
                       const float* bsel, TO* adapt, float* logits, int E,
                       int b, float inv_tau, cudaStream_t st) {
  const int W = E * b;
  if (W <= 64)
    return launch_moe<2, TO>(xm, M, C, wr, wd, bd, wu, bu, ascale, wsel, bsel,
                             adapt, logits, E, b, inv_tau, st);
  if (W <= 128)
    return launch_moe<4, TO>(xm, M, C, wr, wd, bd, wu, bu, ascale, wsel, bsel,
                             adapt, logits, E, b, inv_tau, st);
  if (W <= 256)
    return launch_moe<8, TO>(xm, M, C, wr, wd, bd, wu, bu, ascale, wsel, bsel,
                             adapt, logits, E, b, inv_tau, st);
  return launch_moe<16, TO>(xm, M, C, wr, wd, bd, wu, bu, ascale, wsel, bsel,
                            adapt, logits, E, b, inv_tau, st);
}

}  // namespace dyt

extern "C" {

// Expert counts and widths the MoE kernel takes: E >= 2, W = E*b a multiple
// of 16 and at most 512.
int dyt_moe_width_supported(int E, int b) {
  const int W = E * b;
  return E >= 2 && b >= 1 && W % 16 == 0 && W <= dyt::MOE_MAX_W;
}

// Dynamic shared memory of one block (the wrapper checks it against the
// card's 227 KB).
int dyt_moe_smem_bytes(int E, int b) {
  return (int)dyt::MoeLayout(E, E * b).bytes;
}

// xm: fp32 [M, C] x_mid (C % 64 == 0); wr [E, C] fp32; wd [E*b, C] and
// wu [C, E*b] bf16; bd [E*b], bu [E, C], ascale [1] fp32; wsel [C] and
// bsel [1] fp32, or wsel == NULL to skip the router head; adapt [M, C] in the
// residual dtype (adapt_f32 selects fp32 over bf16); logits fp32 [M];
// inv_tau the fp32 value of 1/tau.  Returns a cudaError_t value.
int dyt_moe_adapter_router(const float* xm, int M, int C, const float* wr,
                           const void* wd, const float* bd, const void* wu,
                           const float* bu, const float* ascale,
                           const float* wsel, const float* bsel, void* adapt,
                           int adapt_f32, float* logits, int E, int b,
                           float inv_tau, void* stream) {
  using dyt::bf16;
  if (!dyt_moe_width_supported(E, b) || C % 64) return cudaErrorInvalidValue;
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
