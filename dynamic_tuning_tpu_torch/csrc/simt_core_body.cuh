// The SIMT core's kernel body (simt_core.cuh), included in both of its
// kernels: simt_core_kernel (fp32 sums) and simt_core_kernel_f64 (float64
// sums), which differ only in their launch bounds.  In scope: T, HD, Q8,
// Acc and the kernel argument a.  Not a header of its own.
  using L = ScLayout<HD, Q8>;
  constexpr int KT = L::KT;
  constexpr int NJ = KT / 16;            // keys a thread scores per tile
  constexpr int NC = HD / 64;            // float4 output groups a row
  extern __shared__ __align__(16) float sc_smem[];
  float* Qs = sc_smem + L::Q_OFF;
  float* Ks = sc_smem + L::K_OFF;
  float* Vs = sc_smem + L::V_OFF;
  float* Ss = sc_smem + L::S_OFF;
  float* qsc = sc_smem + L::QS_OFF;
  float* ksc = sc_smem + L::KS_OFF;

  const int N = a.N, q0 = blockIdx.x * SC_QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // --- the query tile: q' = T(q * scale) as fp32, or the codes ------------
  if constexpr (Q8) {
    const int8_t* qb = static_cast<const int8_t*>(a.q) + b * a.sq[0] +
                       h * a.sq[1];
    int* Qi = reinterpret_cast<int*>(Qs);
    for (int i = tid; i < SC_QT * (HD / 16); i += SC_THREADS) {
      const int r = i / (HD / 16), c = (i % (HD / 16)) * 16;
      const int n = q0 + r;
      int4 v = make_int4(0, 0, 0, 0);
      if (n < N) v = *reinterpret_cast<const int4*>(qb + n * a.sq[2] + c);
      *reinterpret_cast<int4*>(Qi + r * L::QW + c / 4) = v;
    }
    for (int r = tid; r < SC_QT; r += SC_THREADS) {
      const int n = q0 + r;
      qsc[r] = n < N ? a.qs[((long long)b * N + n) * a.H + h] : 0.f;
    }
  } else {
    const T* qb = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
    const float scale = a.scale;
    for (int i = tid; i < SC_QT * (HD / 8); i += SC_THREADS) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      const int n = q0 + r;
      float v[8];
      if (n < N) {
        load8(qb + n * a.sq[2] + c, v);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = to_f32(from_f32<T>(__fmul_rn(v[e], scale)));
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
      store8(Qs + r * L::QW + c, v);
    }
  }

  Acc o[4][NC][4];
  Acc l[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][c][e] = 0;

  const T* vb = a.v + b * a.sv[0] + h * a.sv[1];
  const bf16* bb = a.bias != nullptr ? a.bias + h * a.bh : nullptr;
  const int nt = (N + KT - 1) / KT;
  for (int t = 0; t < nt; ++t) {
    const int k0 = t * KT;
    __syncthreads();                     // the last tile's K, V, S are read
    // --- the key tile's K (or codes and scales) and V --------------------
    if constexpr (Q8) {
      const int8_t* kb = static_cast<const int8_t*>(a.k) + b * a.sk[0] +
                         h * a.sk[1];
      int* Ki = reinterpret_cast<int*>(Ks);
      for (int i = tid; i < KT * (HD / 16); i += SC_THREADS) {
        const int r = i / (HD / 16), c = (i % (HD / 16)) * 16;
        const int n = k0 + r;
        int4 v = make_int4(0, 0, 0, 0);
        if (n < N) v = *reinterpret_cast<const int4*>(kb + n * a.sk[2] + c);
        *reinterpret_cast<int4*>(Ki + r * L::QW + c / 4) = v;
      }
      const float* ksb = a.ks + ((long long)b * (a.H / 2) + h / 2) * a.ks_n;
      for (int r = tid; r < KT; r += SC_THREADS) {
        const int n = k0 + r;
        ksc[r] = n < N ? ksb[n] : 0.f;
      }
    } else {
      const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
      for (int i = tid; i < KT * (HD / 8); i += SC_THREADS) {
        const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
        const int n = k0 + r;
        float v[8];
        if (n < N) {
          load8(kb + n * a.sk[2] + c, v);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = 0.f;
        }
        store8(Ks + r * L::QW + c, v);
      }
    }
    for (int i = tid; i < KT * (HD / 8); i += SC_THREADS) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      const int n = k0 + r;
      float v[8];
      if (n < N) {
        load8(vb + n * a.sv[2] + c, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;   // 0 * 0 past N, no NaN
      }
      store8(Vs + r * L::VW + c, v);
    }
    __syncthreads();

    // --- scores, e, l: rows ty + 16 i, keys tx + 16 j ----------------------
    float s[4][NJ];
    if constexpr (Q8) {
      int acc[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0;
      const int* Qi = reinterpret_cast<const int*>(Qs);
      const int* Ki = reinterpret_cast<const int*>(Ks);
#pragma unroll 4
      for (int d = 0; d < HD / 4; d += 4) {
        int4 qv[4], kv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const int4*>(Qi + (ty + 16 * i) * L::QW +
                                                 d);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          kv[j] = *reinterpret_cast<const int4*>(Ki + (tx + 16 * j) * L::QW +
                                                 d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            acc[i][j] = __dp4a(qv[i].x, kv[j].x, acc[i][j]);
            acc[i][j] = __dp4a(qv[i].y, kv[j].y, acc[i][j]);
            acc[i][j] = __dp4a(qv[i].z, kv[j].z, acc[i][j]);
            acc[i][j] = __dp4a(qv[i].w, kv[j].w, acc[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          s[i][j] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]),
                                        qsc[ty + 16 * i]),
                              ksc[tx + 16 * j]);
    } else {
      Acc sa[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) sa[i][j] = 0;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        float4 qv[4], kv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) *
                                                   L::QW + d);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) *
                                                   L::QW + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            sa[i][j] = sc_fma(qv[i].x, kv[j].x, sa[i][j]);
            sa[i][j] = sc_fma(qv[i].y, kv[j].y, sa[i][j]);
            sa[i][j] = sc_fma(qv[i].z, kv[j].z, sa[i][j]);
            sa[i][j] = sc_fma(qv[i].w, kv[j].w, sa[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = sc_f32(sa[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, n = q0 + r;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int key = tx + 16 * j;
        float e = 0.f;
        if (k0 + key < N && n < N) {
          float v = s[i][j];
          if (bb != nullptr)
            v = __fadd_rn(v, __bfloat162float(bb[n * a.br + k0 + key]));
          e = expf(__fsub_rn(fminf(fmaxf(v, -60.f), 80.f), 20.f));
        }
        const float p = to_f32(from_f32<T>(e));
        l[i] += e;
        Ss[r * L::SW + key] = p;
      }
    }
    __syncthreads();

    // --- o += T(e) @ v: rows ty + 16 i, columns 4 tx + 64 c .. + 3 ---------
    const int kn = N - k0 < KT ? N - k0 : KT;
    for (int key = 0; key < kn; ++key) {
      float4 vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        vv[c] = *reinterpret_cast<const float4*>(Vs + key * L::VW + 64 * c +
                                                 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ss[(ty + 16 * i) * L::SW + key];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          o[i][c][0] = sc_fma(p, vv[c].x, o[i][c][0]);
          o[i][c][1] = sc_fma(p, vv[c].y, o[i][c][1]);
          o[i][c][2] = sc_fma(p, vv[c].z, o[i][c][2]);
          o[i][c][3] = sc_fma(p, vv[c].w, o[i][c][3]);
        }
      }
    }
  }

  // --- l over the half warp, o * (1 / l) ---------------------------------
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 1; m < 16; m <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], m);
  T* ob = a.o + b * a.so[0] + h * a.so[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty + 16 * i;
    if (n >= N) continue;
    const float inv = __frcp_rn(sc_f32(l[i]));
    auto out = [&](Acc x) { return __fmul_rn(sc_f32(x), inv); };
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      T* p = ob + n * a.so[2] + 64 * c + 4 * tx;
      store2(p, out(o[i][c][0]), out(o[i][c][1]));
      store2(p + 2, out(o[i][c][2]), out(o[i][c][3]));
    }
  }
