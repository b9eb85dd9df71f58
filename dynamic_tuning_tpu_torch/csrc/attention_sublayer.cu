// Pre-norm attention sublayer of the serving path:
//     out = x + proj(attn_core(qkv(LN(x))))
//
// Replaces the TPU kernel dynamic_tuning_tpu/ops/mha_serving.py::
// attention_sublayer_serving (_attn_sublayer_kernel, with its shared core
// attn_core_pairs) and forms the first four steps of dyt_prologue_serving
// (see dyt_prologue.cu).
//
// What bounds it on an H100.  At ViT-B/16 serving shapes (B=128, N=197,
// C=768, 12 heads of 64) the sublayer does ~0.12 TFLOP of qkv/proj GEMM and
// ~0.015 TFLOP of attention products per block (0.12 ms at the 989 TFLOP/s
// bf16 peak), plus one expf per score (60 M per block).  The TPU kernel
// kept every intermediate in VMEM; the chain below moves the bf16 LN rows,
// qkv buffer and core output through device memory, ~0.5 GB per block
// (0.15 ms at 3.35 TB/s).  So this first, simple version sits near the
// balance point: bytes and the mma.sync GEMM's efficiency (~220 TFLOP/s,
// no wgmma yet) bound it together.
//
// What the design does about it.  Four kernels on the caller's stream:
//   1. layernorm_bf16_kernel -- one warp per row, fp32 two-pass LN (mean,
//      then mean of centred squares, eps 1e-6), rounded once to bf16;
//   2. gemm_nt_kernel<EPI_BIAS_BF16> -- LN rows x Wqkv^T on tensor cores,
//      fp32 accumulation, + bqkv in fp32, one rounding to bf16;
//   3. attn_core_kernel -- one block per (sample, head): K and V of the head
//      stay in shared memory while eight warps stream 16-row query tiles
//      over 16-key chunks on mma.sync.  The serving softmax has no row max
//      (e = exp(clip(s, -60, 80) - 20)), so each key chunk is final when it
//      is computed: scores and probabilities never leave registers, with no
//      rescaling and no [N, N] score tile anywhere;
//   4. gemm_nt_kernel<EPI_RESIDUAL> -- core x Wproj^T + x + bproj in fp32,
//      written in the residual dtype (and as an fp32 copy for the DyT
//      prologue's adapter/router, which read x_mid in fp32).
// Fusing the chain (wgmma, TMA, the core inside the qkv GEMM's epilogue) is
// later work; each step follows the TPU kernel's rounding points exactly.
#include "common.cuh"

namespace dyt {

template <typename TX>
__global__ void __launch_bounds__(256)
layernorm_bf16_kernel(const TX* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ b, bf16* __restrict__ out,
                      int M, int C) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const TX* xr = x + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f32(xr[c]) - mu;
    v += d * d;
  }
  const float rs = rsqrtf(warp_sum(v) / C + 1e-6f);
  bf16* orow = out + (size_t)row * C;
  for (int c = lane; c < C; c += 32)
    orow[c] = from_f32<bf16>((to_f32(xr[c]) - mu) * rs * g[c] + b[c]);
}

// ---------------------------------------------------------------------------
// attention core on the raw [B, N, 3C] qkv buffer ([q|k|v] x head x hd
// columns), writing [B, N, C].  Per query row:
//   q' = bf16(q * scale);  s = q' . k (fp32);  e = exp(clip(s,-60,80) - 20)
//   l = sum(e) in fp32;    o = (bf16(e) @ v in fp32) * (1 / l) -> bf16

constexpr int ATT_WARPS = 8;

template <int HD>
struct AttnLayout {
  static constexpr int LDK = HD + 8;   // K/V smem row stride (bank skew)
  static int smem_bytes(int N) {
    const int np = (N + 15) / 16 * 16;
    return 2 * np * LDK * 2;
  }
};

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// One block per (sample, head).  Each warp owns 16 query rows at a time and
// walks the keys in chunks of 16: S = Q K^T lands in mma accumulators, the
// clamped exp turns it in registers into the bf16 A operand of P V, and l
// accumulates from the fp32 e.  Thread (g = lane/4, t = lane%4) holds rows g
// and g + 8 of every tile.
template <int HD>
__global__ void __launch_bounds__(ATT_WARPS * 32)
attn_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N,
                 int H, float scale) {
  constexpr int LDK = AttnLayout<HD>::LDK;
  constexpr int CPR = HD / 8;    // 16-byte chunks per head row
  constexpr int DK = HD / 16;    // k16 steps of Q K^T
  constexpr int OT = HD / 8;     // n8 tiles of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int np = (N + 15) / 16 * 16;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + np * LDK;

  const int C = H * HD, C3 = 3 * C;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const bf16* base = qkv + (size_t)b * N * C3;

  for (int i = threadIdx.x; i < np * CPR; i += blockDim.x) {
    const int r = i / CPR, c = (i % CPR) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (r < N) {
      const bf16* row = base + (size_t)r * C3 + h * HD + c;
      kv = *reinterpret_cast<const uint4*>(row + C);
      vv = *reinterpret_cast<const uint4*>(row + 2 * C);
    }
    *reinterpret_cast<uint4*>(Ks + r * LDK + c) = kv;
    *reinterpret_cast<uint4*>(Vs + r * LDK + c) = vv;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  // ldmatrix row addresses: K as the col-major B of Q K^T (keys lane%8,
  // +8 for lanes 16..31; d half (lane/8)%2), V transposed for P V (keys
  // lane%16, d half lane/16)
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = lane & 15, v_col = (lane >> 4) * 8;
  const int nchunks = np / 16;

  for (int qc = warp; qc < nchunks; qc += ATT_WARPS) {
    const int n_lo = qc * 16 + g, n_hi = n_lo + 8;
    // q rows scaled in fp32 and rounded to bf16 before Q K^T, loaded
    // straight into the A-operand layout
    unsigned qf[DK][4];
#pragma unroll
    for (int d = 0; d < DK; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = (e & 1) ? n_hi : n_lo;
        const int col = d * 16 + t2 + (e >> 1) * 8;
        float2 q = make_float2(0.f, 0.f);
        if (n < N) q = load2(base + (size_t)n * C3 + h * HD + col);
        qf[d][e] = pack_bf16x2(q.x * scale, q.y * scale);
      }
    }
    float o[OT][4];
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    float l_lo = 0.f, l_hi = 0.f;

    for (int kc = 0; kc < nchunks; ++kc) {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        unsigned r[4];
        ldmatrix_x4(r, Ks + (kc * 16 + k_row) * LDK + d * 16 + k_col);
        mma_bf16_16816(s[0], qf[d], r[0], r[1]);
        mma_bf16_16816(s[1], qf[d], r[2], r[3]);
      }
      // e = exp(clip(s, -60, 80) - 20); padded keys contribute nothing
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kc * 16 + j * 8 + t2 + (e & 1);
          s[j][e] = col < N
              ? expf(fminf(fmaxf(s[j][e], -60.f), 80.f) - 20.f) : 0.f;
        }
        l_lo += s[j][0] + s[j][1];     // l sums the fp32 e, not bf16(e)
        l_hi += s[j][2] + s[j][3];
      }
      const unsigned pf[4] = {pack_bf16x2(s[0][0], s[0][1]),
                              pack_bf16x2(s[0][2], s[0][3]),
                              pack_bf16x2(s[1][0], s[1][1]),
                              pack_bf16x2(s[1][2], s[1][3])};
#pragma unroll
      for (int j = 0; j < OT; j += 2) {
        unsigned r[4];
        ldmatrix_x4_trans(r, Vs + (kc * 16 + v_row) * LDK + j * 8 + v_col);
        mma_bf16_16816(o[j], pf, r[0], r[1]);
        mma_bf16_16816(o[j + 1], pf, r[2], r[3]);
      }
    }

    // each row's l is spread over the four lanes of its quad
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, m);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, m);
    }
    const float inv_lo = 1.0f / l_lo, inv_hi = 1.0f / l_hi;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int col = h * HD + j * 8 + t2;
      if (n_lo < N)
        store2(out + ((size_t)b * N + n_lo) * C + col, o[j][0] * inv_lo,
               o[j][1] * inv_lo);
      if (n_hi < N)
        store2(out + ((size_t)b * N + n_hi) * C + col, o[j][2] * inv_hi,
               o[j][3] * inv_hi);
    }
  }
}

template <int HD>
static cudaError_t launch_attn_core(const bf16* qkv, bf16* out, int B, int N,
                                    int H, float scale, cudaStream_t s) {
  const int smem = AttnLayout<HD>::smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      attn_core_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attn_core_kernel<HD><<<B * H, ATT_WARPS * 32, smem, s>>>(qkv, out, N, H,
                                                           scale);
  return cudaGetLastError();
}

template <typename TX>
static cudaError_t sublayer(const TX* x, const float* gamma, const float* beta,
                            const bf16* wqkv, const float* bqkv,
                            const bf16* wproj, const float* bproj, TX* out,
                            float* xm32, bf16* ln_buf, bf16* qkv_buf,
                            bf16* attn_buf, int B, int N, int C, int H,
                            float scale, cudaStream_t s) {
  const int M = B * N, hd = C / H;
  layernorm_bf16_kernel<TX><<<(M + 7) / 8, 256, 0, s>>>(x, gamma, beta,
                                                        ln_buf, M, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = launch_gemm_nt<EPI_BIAS_BF16, TX>(ln_buf, wqkv, bqkv, M, 3 * C, C,
                                          qkv_buf, nullptr, nullptr,
                                          nullptr, s);
  if (err != cudaSuccess) return err;

  if (hd == 64)
    err = launch_attn_core<64>(qkv_buf, attn_buf, B, N, H, scale, s);
  else if (hd == 128)
    err = launch_attn_core<128>(qkv_buf, attn_buf, B, N, H, scale, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;

  return launch_gemm_nt<EPI_RESIDUAL, TX>(attn_buf, wproj, bproj, M, C, C,
                                          nullptr, x, out, xm32, s);
}

}  // namespace dyt

extern "C" {

// Shared-memory bytes the attention core needs at (N, hd); 0 when hd is not
// supported.  The wrapper checks it against the card's per-block limit.
int dyt_attn_core_smem_bytes(int N, int hd) {
  if (hd == 64) return dyt::AttnLayout<64>::smem_bytes(N);
  if (hd == 128) return dyt::AttnLayout<128>::smem_bytes(N);
  return 0;
}

// x, out: [B, N, C] in the residual dtype (x_f32 selects fp32 over bf16);
// gamma/beta/bqkv/bproj fp32; wqkv [3C, C], wproj [C, C] bf16; xm32 an
// optional fp32 [B, N, C] copy of out; ln_buf [B*N, C], qkv_buf [B*N, 3C],
// attn_buf [B*N, C] bf16 scratch.  Returns a cudaError_t value.
int dyt_attention_sublayer(const void* x, int x_f32, const float* gamma,
                           const float* beta, const void* wqkv,
                           const float* bqkv, const void* wproj,
                           const float* bproj, void* out, float* xm32,
                           void* ln_buf, void* qkv_buf, void* attn_buf, int B,
                           int N, int C, int H, float scale, void* stream) {
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
                                xm32, lb, qb, ab, B, N, C, H, scale, s);
  return dyt::sublayer<bf16>(static_cast<const bf16*>(x), gamma, beta, wq,
                             bqkv, wp, bproj, static_cast<bf16*>(out), xm32,
                             lb, qb, ab, B, N, C, H, scale, s);
}

const char* dyt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
