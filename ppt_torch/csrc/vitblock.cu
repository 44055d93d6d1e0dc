// One pre-norm PointBERT ViT block, and the block fused with the trunk's
// readout, as a short sequence of hand-written launches:
//   add_ln    x0 = x + pos ; xn = LN1(x0)            (f32 stats, eps 1e-6)
//   gemm      qkv = xn @ wqkv
//   attention whole-row softmax per (batch, head, query tile)
//   gemm      x1 = x0 + dp1 * (attn @ wproj + bproj)
//   add_ln    xn = LN2(x1)
//   gemm      h1 = gelu_tanh(xn @ wfc1 + bfc1)
//   gemm      out = x1 + dp2 * (h1 @ wfc2 + bfc2)
//   readout   [LN_f(out[:, 0]), max_{l>=1} LN_f(out[:, l])]   (readout only)
//
// Replaces ppt_tpu/kernels/vitblock.py:fused_vit_block (_block_kernel)
// and :fused_vit_block_readout (_block_readout_kernel).
//
// Bound: operations, ~71 GFLOP per block at B=32, L=513, C=384 against
// ~0.1 GB of activations. Design: in bf16 (the serving dtype) the GEMMs
// and both attention products run on the tensor cores (mma.sync, f32
// accumulators); in f32 they run as FMA on the CUDA cores, since TF32
// would round the operands. The GEMM epilogues carry the bias, GELU and
// droppath-scaled residual, so each sublayer writes its result once.
// Attention never takes an online-softmax rescale, which keeps the TPU
// kernel's rounding: row max over all keys, exp(s - m) rounded to the
// compute dtype before P@V, the f32 accumulator divided by the f32
// denominator afterwards (vitblock.py:93-106). Fusing the whole block
// into one persistent kernel, and wgmma/TMA tiles, are later work.
//
// Rounding follows _block_body (vitblock.py:81-125): qkv, attn, y, y2,
// h1 and each residual sum are rounded to the compute dtype T at the same
// points.
#include "common.cuh"

PPT_ERROR_STRING_FN

constexpr float LN_EPS = 1e-6f;

// ---------------------------------------------------------------------------
// x0 = x + pos (optional) ; xn = LN(x0) — one warp per row, C <= 1024
// ---------------------------------------------------------------------------
template <typename T>
__global__ void add_ln_kernel(const T* __restrict__ x, const T* __restrict__ pos, int rows,
                              int C, const float* __restrict__ s, const float* __restrict__ b,
                              T* __restrict__ x0_out, T* __restrict__ xn_out) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t o = (size_t)row * C;
  add_ln_row<T>(x + o, pos ? pos + o : nullptr, C, s, b, LN_EPS, x0_out ? x0_out + o : nullptr,
                xn_out + o);
}

// ---------------------------------------------------------------------------
// GEMM out[M,N] = A[M,K] @ W[K,N] with an epilogue
// ---------------------------------------------------------------------------
enum { EPI_ROUND = 0, EPI_BIAS_RES = 1, EPI_BIAS_GELU = 2 };

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  const float inner = __fmul_rn(c, __fadd_rn(x, __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

// EPI_ROUND:     out = T(acc)
// EPI_BIAS_RES:  y = T(T(acc) + T(bias)); out = T(res + T(y * T(dp[row / L, dp_col])))
// EPI_BIAS_GELU: out = T(gelu_tanh(acc + bias))      (bias added in f32)
template <typename T, int EPI>
__device__ __forceinline__ void epilogue(float acc, int r, int c, int N,
                                         const float* __restrict__ bias,
                                         const T* __restrict__ res,
                                         const float* __restrict__ dp, int dp_col, int L,
                                         T* __restrict__ out) {
  const size_t o = (size_t)r * N + c;
  float v;
  if (EPI == EPI_ROUND) {
    v = acc;
  } else if (EPI == EPI_BIAS_RES) {
    const float y = rnd<T>(__fadd_rn(rnd<T>(acc), rnd<T>(bias[c])));
    const float scaled = rnd<T>(__fmul_rn(y, rnd<T>(dp[(r / L) * 2 + dp_col])));
    v = __fadd_rn(to_f(res[o]), scaled);
  } else {
    v = gelu_tanh(__fadd_rn(acc, bias[c]));
  }
  out[o] = from_f<T>(v);
}

// the epilogue as the functor the shared GEMM main loops call per element
template <typename T, int EPI>
struct Epilogue {
  int N;
  const float* bias;
  const T* res;
  const float* dp;
  int dp_col, L;
  T* out;
  __device__ __forceinline__ void operator()(float acc, int r, int c) const {
    epilogue<T, EPI>(acc, r, c, N, bias, res, dp, dp_col, L, out);
  }
};

// f32 on the CUDA cores, bf16 on the tensor cores (common.cuh)
template <int EPI>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W, int M, int N, int K,
                const float* __restrict__ bias, const float* __restrict__ res,
                const float* __restrict__ dp, int dp_col, int L, float* __restrict__ out) {
  gemm_f32_body<false>(A, W, M, N, K, Epilogue<float, EPI>{N, bias, res, dp, dp_col, L, out});
}

template <int EPI>
__global__ void __launch_bounds__(256)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, int M, int N, int K,
                 const float* __restrict__ bias, const bf16* __restrict__ res,
                 const float* __restrict__ dp, int dp_col, int L, bf16* __restrict__ out) {
  gemm_bf16_body<128, false>(A, W, M, N, K,
                             Epilogue<bf16, EPI>{N, bias, res, dp, dp_col, L, out});
}

// ---------------------------------------------------------------------------
// Whole-row attention. qkv [B, L, 3C] (q | k | v, heads side by side);
// out [B, L, C].
//
// f32: grid (ceil(L / TQ), heads, B), 256 threads, D <= 128; a 32-query
// tile's whole score rows sit in shared memory.
// ---------------------------------------------------------------------------
constexpr int TQ = 32, TK = 64;

__global__ void __launch_bounds__(256)
attention_f32_kernel(const float* __restrict__ qkv, int L, int C, int D, float scale,
                     float* __restrict__ out) {
  extern __shared__ float sm[];
  float* Qs = sm;                  // [TQ][D]
  float* KV = Qs + TQ * D;         // [TK][D + 1]
  float* S = KV + TK * (D + 1);    // [TQ][L]
  float* den = S + (size_t)TQ * L; // [TQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int nq = min(TQ, L - q0);
  const size_t ld = 3 * (size_t)C;
  const float* base = qkv + (size_t)b * L * ld;

  for (int e = tid; e < TQ * D; e += 256) {
    const int q = e / D, d = e % D;
    Qs[e] = q < nq ? (base[(size_t)(q0 + q) * ld + h * D + d]) : 0.f;
  }

  // pass 1: scores
  for (int k0 = 0; k0 < L; k0 += TK) {
    const int nk = min(TK, L - k0);
    __syncthreads();
    for (int e = tid; e < TK * D; e += 256) {
      const int j = e / D, d = e % D;
      KV[j * (D + 1) + d] = j < nk ? base[(size_t)(k0 + j) * ld + C + h * D + d] : 0.f;
    }
    __syncthreads();
    const int j = tid & (TK - 1);
    if (j < nk) {
      for (int q = tid >> 6; q < nq; q += 4) {
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(Qs[q * D + d], KV[j * (D + 1) + d], s);
        S[(size_t)q * L + k0 + j] = __fmul_rn(s, scale);
      }
    }
  }
  __syncthreads();

  // softmax numerators and f32 denominators, one warp per row
  for (int q = warp; q < nq; q += 8) {
    float* row = S + (size_t)q * L;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
    for (int off = 16; off; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float p = expf(__fsub_rn(row[j], m));
      row[j] = p;
      sum += p;
    }
    for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) den[q] = sum;
  }

  // pass 2: P @ V
  constexpr int MAXE = TQ * 128 / 256;
  float acc[MAXE];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) acc[e] = 0.f;
  const int nE = (TQ * D) / 256;  // D multiple of 8
  for (int k0 = 0; k0 < L; k0 += TK) {
    const int nk = min(TK, L - k0);
    __syncthreads();
    for (int e = tid; e < TK * D; e += 256) {
      const int j = e / D, d = e % D;
      KV[j * (D + 1) + d] =
          j < nk ? base[(size_t)(k0 + j) * ld + 2 * C + h * D + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      if (e < nE) {
        const int idx = tid + 256 * e, q = idx / D, d = idx % D;
        if (q < nq) {
          const float* prow = S + (size_t)q * L + k0;
          float a = acc[e];
          for (int j = 0; j < nk; ++j) a = fmaf(prow[j], KV[j * (D + 1) + d], a);
          acc[e] = a;
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    if (e < nE) {
      const int idx = tid + 256 * e, q = idx / D, d = idx % D;
      if (q < nq)
        out[((size_t)b * L + q0 + q) * C + h * D + d] = __fdiv_rn(acc[e], den[q]);
    }
  }
}

// bf16: grid (ceil(L / 64), heads, B), 4 warps of 16 queries each, mma.sync
// for both products, no score matrix in memory. Pass 1 sweeps the key
// tiles for the row max; pass 2 recomputes the scores, forms
// p = exp(s - m) in f32 (summed in f32 for the denominator), rounds p to
// bf16 straight from the accumulator registers into the A fragments of
// P @ V, and divides the f32 result by the denominator at the end: the
// TPU kernel's rounding, with no online rescale.
template <int D>
__global__ void __launch_bounds__(128)
attention_bf16_kernel(const bf16* __restrict__ qkv, int L, int C, float scale,
                      bf16* __restrict__ out) {
  constexpr int LD = D + 8, KS = D / 16;
  __shared__ __align__(16) bf16 Ks[TK * LD];
  __shared__ __align__(16) bf16 Vs[TK * LD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int kq = (lane & 3) * 2;
  const size_t ld = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)b * L * ld;

  uint32_t qf[KS][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bf16* q0p = base + (size_t)r0 * ld + h * D + ks * 16 + kq;
    const bf16* q1p = base + (size_t)r1 * ld + h * D + ks * 16 + kq;
    qf[ks][0] = r0 < L ? *reinterpret_cast<const uint32_t*>(q0p) : 0u;
    qf[ks][1] = r1 < L ? *reinterpret_cast<const uint32_t*>(q1p) : 0u;
    qf[ks][2] = r0 < L ? *reinterpret_cast<const uint32_t*>(q0p + 8) : 0u;
    qf[ks][3] = r1 < L ? *reinterpret_cast<const uint32_t*>(q1p + 8) : 0u;
  }

  auto load_tile = [&](bf16* dst, int k0, int off) {  // 64 keys x D, zero past L
    for (int e = tid; e < TK * (D / 8); e += 128) {
      const int j = e / (D / 8), c = (e % (D / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + j < L)
        v = *reinterpret_cast<const uint4*>(base + (size_t)(k0 + j) * ld + off + h * D + c);
      *reinterpret_cast<uint4*>(dst + j * LD + c) = v;
    }
  };
  // s[nt] = scaled scores of keys k0 + 8nt.. (C fragments); -inf past L
  auto scores = [&](float (&s)[8][4], int k0) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Ks + (p * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * p], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * p + 1], qf[ks], kb[2], kb[3]);
      }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = k0 + nt * 8 + kq + (e & 1) < L ? __fmul_rn(s[nt][e], scale) : -INFINITY;
  };

  // pass 1: row max over all keys
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int k0 = 0; k0 < L; k0 += TK) {
    __syncthreads();
    load_tile(Ks, k0, C);
    __syncthreads();
    float s[8][4];
    scores(s, k0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {  // the 4 lanes of a row
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }

  // pass 2: P @ V and the f32 denominators
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float d0 = 0.f, d1 = 0.f;
  for (int k0 = 0; k0 < L; k0 += TK) {
    __syncthreads();
    load_tile(Ks, k0, C);
    load_tile(Vs, k0, 2 * C);
    __syncthreads();
    float s[8][4];
    scores(s, k0);
    uint32_t pf[4][4];  // P as A fragments, 16 keys each
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = expf(__fsub_rn(s[nt][0], m0)), p1 = expf(__fsub_rn(s[nt][1], m0));
      const float p2 = expf(__fsub_rn(s[nt][2], m1)), p3 = expf(__fsub_rn(s[nt][3], m1));
      d0 += p0 + p1;
      d1 += p2 + p3;
      pf[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vs + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                  p * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * p], pf[ks], vb[0], vb[1]);
        mma_bf16(o[2 * p + 1], pf[ks], vb[2], vb[3]);
      }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, off);
    d1 += __shfl_xor_sync(0xffffffffu, d1, off);
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1;
      if (r < L)
        out[((size_t)b * L + r) * C + h * D + dt * 8 + kq + (e & 1)] =
            __float2bfloat16_rn(__fdiv_rn(o[dt][e], e < 2 ? d0 : d1));
    }
}

// ---------------------------------------------------------------------------
// Readout: out[b] = [LN_f(x[b, 0]), max_{l >= 1} LN_f(x[b, l]), 0 x 6] f32
// ---------------------------------------------------------------------------
template <typename T>
__global__ void readout_kernel(const T* __restrict__ x, int L, int C,
                               const float* __restrict__ s, const float* __restrict__ b,
                               float* __restrict__ out) {
  extern __shared__ float sm[];
  float* mu = sm;       // [L]
  float* rs = sm + L;   // [L]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const T* xb = x + (size_t)blockIdx.x * L * C;
  for (int r = warp; r < L; r += nw) {
    float sum = 0.f, sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float t = to_f(xb[(size_t)r * C + c]);
      sum += t;
      sq = fmaf(t, t, sq);
    }
    for (int off = 16; off; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    if (lane == 0) {
      const float m = sum / C;
      mu[r] = m;
      rs[r] = rsqrtf(__fsub_rn(sq / C, __fmul_rn(m, m)) + LN_EPS);
    }
  }
  __syncthreads();
  float* ob = out + (size_t)blockIdx.x * 8 * C;
  for (int c = tid; c < C; c += blockDim.x) {
    const float sc = s[c], bc = b[c];
    float mx = -INFINITY, cls = 0.f;
    for (int r = 0; r < L; ++r) {
      const float t = to_f(xb[(size_t)r * C + c]);
      const float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(t, mu[r]), rs[r]), sc), bc);
      if (r == 0) cls = y;
      else mx = fmaxf(mx, y);
    }
    ob[c] = cls;
    ob[C + c] = mx;
    for (int k = 2; k < 8; ++k) ob[k * C + c] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <int EPI>
static int gemm(const float* A, const float* W, int M, int N, int K, const float* bias,
                const float* res, const float* dp, int dp_col, int L, float* out,
                cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_f32_kernel<EPI><<<grid, 256, 0, st>>>(A, W, M, N, K, bias, res, dp, dp_col, L, out);
  PPT_CHECK_LAUNCH();
  return 0;
}

template <int EPI>
static int gemm(const bf16* A, const bf16* W, int M, int N, int K, const float* bias,
                const bf16* res, const float* dp, int dp_col, int L, bf16* out,
                cudaStream_t st) {
  if (K % TBK || N % 8) return (int)cudaErrorInvalidValue;
  dim3 grid((N + TBN - 1) / TBN, (M + 127) / 128);
  gemm_bf16_kernel<EPI><<<grid, 256, 0, st>>>(A, W, M, N, K, bias, res, dp, dp_col, L, out);
  PPT_CHECK_LAUNCH();
  return 0;
}

// the scale as JAX forms it: 1/sqrt(d) in double, then rounded to f32
static float attn_scale(int D) { return (float)(1.0 / sqrt((double)D)); }

static int attention(const float* qkv, int B, int L, int C, int heads, float* out,
                     cudaStream_t st) {
  const int D = C / heads;
  const size_t smem = sizeof(float) * ((size_t)TQ * D + TK * (D + 1) + (size_t)TQ * L + TQ);
  cudaFuncSetAttribute(attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((L + TQ - 1) / TQ, heads, B);
  attention_f32_kernel<<<grid, 256, smem, st>>>(qkv, L, C, D, attn_scale(D), out);
  PPT_CHECK_LAUNCH();
  return 0;
}

static int attention(const bf16* qkv, int B, int L, int C, int heads, bf16* out,
                     cudaStream_t st) {
  const int D = C / heads;
  const float scale = attn_scale(D);
  dim3 grid((L + 63) / 64, heads, B);
  if (D == 32)
    attention_bf16_kernel<32><<<grid, 128, 0, st>>>(qkv, L, C, scale, out);
  else if (D == 64)
    attention_bf16_kernel<64><<<grid, 128, 0, st>>>(qkv, L, C, scale, out);
  else if (D == 128)
    attention_bf16_kernel<128><<<grid, 128, 0, st>>>(qkv, L, C, scale, out);
  else
    return (int)cudaErrorInvalidValue;
  PPT_CHECK_LAUNCH();
  return 0;
}

template <typename T>
static int add_ln(const T* x, const T* pos, int rows, int C, const float* s, const float* b,
                  T* x0, T* xn, cudaStream_t st) {
  add_ln_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(x, pos, rows, C, s, b, x0, xn);
  PPT_CHECK_LAUNCH();
  return 0;
}

#define PPT_TRY(call)           \
  do {                          \
    int rc__ = (call);          \
    if (rc__) return rc__;      \
  } while (0)

template <typename T>
static int block(const T* x, const T* pos, const float* dp, int B, int L, int C, int heads,
                 int hid, const float* ln1s, const float* ln1b, const T* wqkv, const T* wproj,
                 const float* bproj, const float* ln2s, const float* ln2b, const T* wfc1,
                 const float* bfc1, const T* wfc2, const float* bfc2, const float* lnfs,
                 const float* lnfb, T* x0, T* xn, T* qkv, T* attn, T* x1, T* h1, T* out,
                 float* ro, cudaStream_t st) {
  const int rows = B * L;
  PPT_TRY(add_ln<T>(x, pos, rows, C, ln1s, ln1b, x0, xn, st));
  PPT_TRY(gemm<EPI_ROUND>(xn, wqkv, rows, 3 * C, C, nullptr, nullptr, nullptr, 0, L, qkv, st));
  PPT_TRY(attention(qkv, B, L, C, heads, attn, st));
  PPT_TRY(gemm<EPI_BIAS_RES>(attn, wproj, rows, C, C, bproj, x0, dp, 0, L, x1, st));
  PPT_TRY(add_ln<T>(x1, nullptr, rows, C, ln2s, ln2b, nullptr, xn, st));
  PPT_TRY(gemm<EPI_BIAS_GELU>(xn, wfc1, rows, hid, C, bfc1, nullptr, nullptr, 0, L, h1, st));
  PPT_TRY(gemm<EPI_BIAS_RES>(h1, wfc2, rows, C, hid, bfc2, x1, dp, 1, L, out, st));
  if (ro) {
    const size_t smem = sizeof(float) * 2 * (size_t)L;
    cudaFuncSetAttribute(readout_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    readout_kernel<T><<<B, 256, smem, st>>>(out, L, C, lnfs, lnfb, ro);
    PPT_CHECK_LAUNCH();
  }
  return 0;
}

// `ro` == nullptr: plain block (result in `out`); otherwise the readout
// rows [B, 8, C] f32 are written to `ro` (and `out` is scratch).
PPT_EXPORT int ppt_vit_block(int dtype, const void* x, const void* pos, const void* dp, int B,
                             int L, int C, int heads, int hid, const void* ln1s,
                             const void* ln1b, const void* wqkv, const void* wproj,
                             const void* bproj, const void* ln2s, const void* ln2b,
                             const void* wfc1, const void* bfc1, const void* wfc2,
                             const void* bfc2, const void* lnfs, const void* lnfb, void* x0,
                             void* xn, void* qkv, void* attn, void* x1, void* h1, void* out,
                             void* ro, void* stream) {
#define PPT_BLOCK_ARGS(T)                                                                    \
  (const T*)x, (const T*)pos, (const float*)dp, B, L, C, heads, hid, (const float*)ln1s,   \
      (const float*)ln1b, (const T*)wqkv, (const T*)wproj, (const float*)bproj,             \
      (const float*)ln2s, (const float*)ln2b, (const T*)wfc1, (const float*)bfc1,           \
      (const T*)wfc2, (const float*)bfc2, (const float*)lnfs, (const float*)lnfb, (T*)x0,   \
      (T*)xn, (T*)qkv, (T*)attn, (T*)x1, (T*)h1, (T*)out, (float*)ro, (cudaStream_t)stream
  if (dtype == PPT_BF16) return block<bf16>(PPT_BLOCK_ARGS(bf16));
  return block<float>(PPT_BLOCK_ARGS(float));
#undef PPT_BLOCK_ARGS
}
