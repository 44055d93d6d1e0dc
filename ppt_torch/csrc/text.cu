// The CLIP text path on hand-written kernels: one text block, the whole
// tower (12 blocks + EOT pooling + ln_final + text_projection, with or
// without every block's output) and the tower's input-cotangent backward.
//
// Replaces ppt_tpu/kernels/textblock.py:fused_text_block (_text_kernel),
// ppt_tpu/kernels/texttower.py:fused_text_tower (_tower_kernel, both
// variants) and :_tower_bwd_pallas (_tower_bwd_kernel).
//
// Bound: operations. One encode of [40, 48, 512] is ~145 GFLOP of GEMM
// against 75 MB of bf16 weights that no SM can hold, so each C entry
// point walks the layers itself and launches GEMM, LayerNorm and
// attention kernels on one stream: 7 per layer forward, 13 per layer
// backward, none from Python. In bf16 the GEMMs run on the tensor cores
// (mma.sync, f32 accumulators); in f32 they run as FMA on the CUDA
// cores, since TF32 would round the operands. The backward's products
// against a transposed weight read the weight as it lies ([N, K] is the
// mma's native B layout), so no weight is ever transposed in memory.
// Attention is one block per (class, head): a class is at most 77 rows,
// so q, k, v and the whole score matrix sit in shared memory and the
// causal loops stop at the diagonal (nothing past a row is ever read).
// Its products are under a hundredth of the operations and run as f32 FMA
// on the compute dtype's values, which is what a tensor core computes up
// to summation order; they are bound by shared-memory loads (two per
// FMA), so they take a far larger share of the time than of the work.
// No float atomics anywhere: two runs give the same bits.
//
// Left behind as the TPU's own: the 8-class chunk with its block-diagonal
// mask (under -inf it is per-class causal attention), the padding of L
// and C, the one-hot product for pooling (the kernels still take the
// one-hot rows and form the same f32 sum), weights resident on chip.
//
// Rounding. T is the compute dtype; every product accumulates in f32.
//   tower (texttower.py:99-138): T(acc) + T(bias) in T; softmax
//     normalised in f32, then cast; c_fc adds its f32 bias before
//     QuickGELU in f32.
//   block (textblock.py:93-149): T(acc + bias) with the bias added in
//     f32; exp(s - m) cast to T before P@V, the f32 accumulator divided
//     by the f32 denominator afterwards.
//   backward (texttower.py:213-326): the recompute rounds as the tower's
//     forward; every cotangent entering a product is cast to T;
//     elementwise chains are f32; d_s uses the f32 P, dV uses T(P); dq
//     and dk are scaled after their products.
// LayerNorm: f32, fast variance E[x^2] - E[x]^2, eps 1e-5.
#include "common.cuh"

PPT_ERROR_STRING_FN

namespace text {  // keeps these kernels' names apart from csrc/vitblock.cu's in a trace

constexpr float LN_EPS = 1e-5f;
enum { ROUND_TOWER = 0, ROUND_BLOCK = 1 };

__device__ __forceinline__ float sigmoidf(float z) { return 1.0f / (1.0f + expf(-z)); }

// ---------------------------------------------------------------------------
// LayerNorm forward (the shared row routine at this tower's eps), and its
// input cotangent. One warp per row, C <= 1024.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void ln_kernel(const T* __restrict__ x, int rows, int C, const float* __restrict__ s,
                          const float* __restrict__ b, T* __restrict__ out) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t o = (size_t)row * C;
  add_ln_row<T>(x + o, nullptr, C, s, b, LN_EPS, nullptr, out + o);
}

// d = dprev + r * (t - mean(t) - xhat * mean(t * xhat)), t = dy * gamma,
// with xhat and r recomputed from the LayerNorm's input x
// (texttower.py:157-163). Writes d as f32 and rounded to T.
template <typename T>
__global__ void ln_vjp_kernel(const T* __restrict__ x, const float* __restrict__ dy,
                              const float* __restrict__ gamma, const float* __restrict__ dprev,
                              int rows, int C, float* __restrict__ d32, T* __restrict__ dT) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = (size_t)row * C;
  float v[32], t[32];
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = lane + 32 * i;
    const float xv = c < C ? to_f(x[base + c]) : 0.f;
    v[i] = xv;
    sum += xv;
    sq = fmaf(xv, xv, sq);
  }
  for (int off = 16; off; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const float mu = sum / C;
  const float rs = rsqrtf(__fsub_rn(sq / C, __fmul_rn(mu, mu)) + LN_EPS);
  float st = 0.f, stx = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = lane + 32 * i;
    float tv = 0.f, xh = 0.f;
    if (c < C) {
      xh = (v[i] - mu) * rs;
      tv = dy[base + c] * gamma[c];
    }
    v[i] = xh;
    t[i] = tv;
    st += tv;
    stx = fmaf(tv, xh, stx);
  }
  for (int off = 16; off; off >>= 1) {
    st += __shfl_xor_sync(0xffffffffu, st, off);
    stx += __shfl_xor_sync(0xffffffffu, stx, off);
  }
  const float mt = st / C, mtx = stx / C;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = lane + 32 * i;
    if (c < C) {
      const float d = dprev[base + c] + rs * (t[i] - mt - v[i] * mtx);
      d32[base + c] = d;
      dT[base + c] = from_f<T>(d);
    }
  }
}

// ---------------------------------------------------------------------------
// GEMM out[M,N] = A[M,K] @ W with an epilogue. TB = false: W is [K, N];
// TB = true: W is [N, K] and the product is A @ W^T.
// ---------------------------------------------------------------------------
enum {
  EPI_BIAS = 0,        // T: bias_add(acc, bias)
  EPI_BIAS_RES = 1,    // T: res + bias_add(acc, bias)
  EPI_BIAS_QGELU = 2,  // T: quick_gelu(acc + bias), bias added in f32
  EPI_BIAS_F32 = 3,    // f32: acc + bias              (GELU pre-activation)
  EPI_F32 = 4,         // f32: acc
  EPI_ROUND = 5,       // T: acc
  EPI_GELU_GRAD = 6    // T: acc * quick_gelu'(aux)
};

struct EpiArgs {
  const float* bias;
  const void* res;
  const float* aux;
  int mode;
};

template <typename T>
__device__ __forceinline__ float bias_add(float acc, float b, int mode) {
  if (mode == ROUND_TOWER) return rnd<T>(__fadd_rn(rnd<T>(acc), rnd<T>(b)));
  return rnd<T>(__fadd_rn(acc, b));
}

template <typename T, int EPI>
__device__ __forceinline__ void epilogue(float acc, int r, int c, int N, const EpiArgs& ea,
                                         void* __restrict__ out) {
  const size_t o = (size_t)r * N + c;
  if constexpr (EPI == EPI_F32) {
    ((float*)out)[o] = acc;
  } else if constexpr (EPI == EPI_BIAS_F32) {
    ((float*)out)[o] = __fadd_rn(acc, ea.bias[c]);
  } else {
    float v;
    if constexpr (EPI == EPI_ROUND) {
      v = acc;
    } else if constexpr (EPI == EPI_BIAS) {
      v = bias_add<T>(acc, ea.bias[c], ea.mode);
    } else if constexpr (EPI == EPI_BIAS_RES) {
      v = __fadd_rn(to_f(((const T*)ea.res)[o]), bias_add<T>(acc, ea.bias[c], ea.mode));
    } else if constexpr (EPI == EPI_BIAS_QGELU) {
      const float z = __fadd_rn(acc, ea.bias[c]);
      v = z * sigmoidf(1.702f * z);
    } else {  // EPI_GELU_GRAD (texttower.py:265-272)
      const float z = ea.aux[o];
      const float sg = sigmoidf(1.702f * z);
      v = acc * (sg + 1.702f * z * sg * (1.0f - sg));
    }
    ((T*)out)[o] = from_f<T>(v);
  }
}

// the epilogue as the functor the shared GEMM main loops call per element
template <typename T, int EPI>
struct Epilogue {
  int N;
  EpiArgs ea;
  void* out;
  __device__ __forceinline__ void operator()(float acc, int r, int c) const {
    epilogue<T, EPI>(acc, r, c, N, ea, out);
  }
};

// f32 on the CUDA cores, bf16 on the tensor cores (common.cuh)
template <bool TB, int EPI>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W, int M, int N, int K,
                EpiArgs ea, void* __restrict__ out) {
  gemm_f32_body<TB>(A, W, M, N, K, Epilogue<float, EPI>{N, ea, out});
}

template <int TBM, bool TB, int EPI>
__global__ void __launch_bounds__(256)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, int M, int N, int K,
                 EpiArgs ea, void* __restrict__ out) {
  gemm_bf16_body<TBM, TB>(A, W, M, N, K, Epilogue<bf16, EPI>{N, ea, out});
}

// ---------------------------------------------------------------------------
// Causal attention, one block per (head, class). qkv [B, L, 3C] (q | k | v,
// heads side by side). Shared memory holds q, k, v as f32 [L][D + 1] and
// the [L][L] scores; every loop over keys stops at the query's own row.
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void load_head(float* dst, const T* __restrict__ src, size_t ld, int L,
                                          int D) {
  for (int e = threadIdx.x; e < L * D; e += blockDim.x) {
    const int i = e / D, d = e % D;
    dst[i * (D + 1) + d] = to_f(src[(size_t)i * ld + d]);
  }
}

// S[i][j] = scale * q_i . k_j for j <= i
__device__ __forceinline__ void causal_scores(float* S, const float* q, const float* k, int L,
                                              int D, float scale) {
  for (int e = threadIdx.x; e < L * L; e += blockDim.x) {
    const int i = e / L, j = e % L;
    if (j > i) continue;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(q[i * (D + 1) + d], k[j * (D + 1) + d], s);
    S[e] = __fmul_rn(s, scale);
  }
}

// Row softmax over j <= i, one warp per row. normalise: S <- exp(s - m) /
// sum in f32; otherwise S <- exp(s - m) and den[i] <- sum.
__device__ __forceinline__ void causal_softmax(float* S, float* den, int L, bool normalise) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int i = warp; i < L; i += nw) {
    float* row = S + (size_t)i * L;
    float m = -INFINITY;
    for (int j = lane; j <= i; j += 32) m = fmaxf(m, row[j]);
    for (int off = 16; off; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int j = lane; j <= i; j += 32) {
      const float p = expf(__fsub_rn(row[j], m));
      row[j] = p;
      sum += p;
    }
    for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (normalise) {
      for (int j = lane; j <= i; j += 32) row[j] = __fdiv_rn(row[j], sum);
    } else if (lane == 0) {
      den[i] = sum;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
attn_fwd_kernel(const T* __restrict__ qkv, int L, int C, int D, float scale, int mode,
                T* __restrict__ out) {
  extern __shared__ float sm[];
  const int LD = D + 1;
  float* q = sm;
  float* k = q + L * LD;
  float* v = k + L * LD;
  float* S = v + L * LD;   // [L][L]
  float* den = S + L * L;  // [L]
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t ld = 3 * (size_t)C;
  const T* base = qkv + (size_t)b * L * ld + h * D;
  load_head(q, base, ld, L, D);
  load_head(k, base + C, ld, L, D);
  load_head(v, base + 2 * C, ld, L, D);
  __syncthreads();
  causal_scores(S, q, k, L, D, scale);
  __syncthreads();
  causal_softmax(S, den, L, mode == ROUND_TOWER);
  __syncthreads();
  for (int e = threadIdx.x; e < L * D; e += blockDim.x) {
    const int i = e / D, d = e % D;
    float a = 0.f;
    for (int j = 0; j <= i; ++j) a = fmaf(rnd<T>(S[i * L + j]), v[j * LD + d], a);
    if (mode == ROUND_BLOCK) a = __fdiv_rn(a, den[i]);
    out[((size_t)b * L + i) * C + h * D + d] = from_f<T>(a);
  }
}

// dqkv [B, L, 3C] from qkv and dO = T(d_attn) [B, L, C] (texttower.py:287-319)
template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dO, int L, int C, int D,
                float scale, T* __restrict__ dqkv) {
  extern __shared__ float sm[];
  const int LD = D + 1;
  float* q = sm;
  float* k = q + L * LD;
  float* v = k + L * LD;
  float* go = v + L * LD;
  float* P = go + L * LD;  // [L][L] f32 probabilities
  float* dS = P + L * L;   // [L][L] dP, then T(dS)
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const size_t ld = 3 * (size_t)C;
  const T* base = qkv + (size_t)b * L * ld + h * D;
  load_head(q, base, ld, L, D);
  load_head(k, base + C, ld, L, D);
  load_head(v, base + 2 * C, ld, L, D);
  load_head(go, dO + (size_t)b * L * C + h * D, (size_t)C, L, D);
  __syncthreads();
  causal_scores(P, q, k, L, D, scale);
  __syncthreads();
  causal_softmax(P, nullptr, L, true);
  for (int e = threadIdx.x; e < L * L; e += blockDim.x) {  // dP = dO @ V^T
    const int i = e / L, j = e % L;
    if (j > i) continue;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(go[i * LD + d], v[j * LD + d], s);
    dS[e] = s;
  }
  __syncthreads();
  for (int i = warp; i < L; i += nw) {  // dS = T(P * (dP - rowsum(dP * P)))
    float rd = 0.f;
    for (int j = lane; j <= i; j += 32) rd = fmaf(dS[i * L + j], P[i * L + j], rd);
    for (int off = 16; off; off >>= 1) rd += __shfl_xor_sync(0xffffffffu, rd, off);
    for (int j = lane; j <= i; j += 32)
      dS[i * L + j] = rnd<T>(P[i * L + j] * (dS[i * L + j] - rd));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < L * D; e += blockDim.x) {
    const int i = e / D, d = e % D;
    float dq = 0.f, dk = 0.f, dv = 0.f;
    for (int j = 0; j <= i; ++j) dq = fmaf(dS[i * L + j], k[j * LD + d], dq);
    for (int r = i; r < L; ++r) {  // row i read as a key: queries r >= i see it
      dk = fmaf(dS[r * L + i], q[r * LD + d], dk);
      dv = fmaf(rnd<T>(P[r * L + i]), go[r * LD + d], dv);
    }
    T* o = dqkv + ((size_t)b * L + i) * ld + h * D + d;
    o[0] = from_f<T>(__fmul_rn(dq, scale));
    o[C] = from_f<T>(__fmul_rn(dk, scale));
    o[2 * C] = from_f<T>(dv);
  }
}

// ---------------------------------------------------------------------------
// Tower epilogue: EOT pooling (the one-hot rows' f32 sum), ln_final,
// text_projection; and its backward. One block of 256 threads per class.
// ---------------------------------------------------------------------------
// sums of a and b over the block, returned to every thread; red holds 64 floats
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int off = 16; off; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  __syncthreads();
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
  for (int w = 0; w < nw; ++w) {
    a += red[w];
    b += red[32 + w];
  }
}

// pooled[k] = sum_l eot[l] * x[l, k] into shared memory, with its mean and rstd
template <typename T>
__device__ __forceinline__ void pool_stats(const T* __restrict__ x, const float* __restrict__ eot,
                                           int L, int D, float* pooled, float* red, float& mu,
                                           float& rs) {
  float sum = 0.f, sq = 0.f;
  for (int k = threadIdx.x; k < D; k += blockDim.x) {
    float p = 0.f;
    for (int l = 0; l < L; ++l) p = fmaf(eot[l], to_f(x[(size_t)l * D + k]), p);
    pooled[k] = p;
    sum += p;
    sq = fmaf(p, p, sq);
  }
  block_sum2(sum, sq, red);
  mu = sum / D;
  rs = rsqrtf(__fsub_rn(sq / D, __fmul_rn(mu, mu)) + LN_EPS);
}

template <typename T>
__global__ void __launch_bounds__(256)
pool_ln_proj_kernel(const T* __restrict__ x, const float* __restrict__ eot, int L, int D, int E,
                    const float* __restrict__ lnfs, const float* __restrict__ lnfb,
                    const float* __restrict__ tproj, float* __restrict__ out) {
  extern __shared__ float sm[];
  float* pooled = sm;    // [D]
  float* red = sm + D;   // [64]
  const int c = blockIdx.x;
  float mu, rs;
  pool_stats(x + (size_t)c * L * D, eot + (size_t)c * L, L, D, pooled, red, mu, rs);
  for (int k = threadIdx.x; k < D; k += blockDim.x)
    pooled[k] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(pooled[k], mu), rs), lnfs[k]), lnfb[k]);
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float a = 0.f;
    for (int k = 0; k < D; ++k) a = fmaf(pooled[k], tproj[(size_t)k * E + e], a);
    out[(size_t)c * E + e] = a;
  }
}

// d2[c, l, :] = eot[c, l] * ln_vjp(g[c] @ tproj^T) (texttower.py:193-210)
template <typename T>
__global__ void __launch_bounds__(256)
epilogue_bwd_kernel(const float* __restrict__ g, const T* __restrict__ xfin,
                    const float* __restrict__ eot, int L, int D, int E,
                    const float* __restrict__ lnfs, const float* __restrict__ tproj,
                    float* __restrict__ d32, T* __restrict__ dT) {
  extern __shared__ float sm[];
  float* pooled = sm;       // [D]
  float* dxn = sm + D;      // [D]
  float* gs = dxn + D;      // [E]
  float* red = gs + E;      // [64]
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int e = threadIdx.x; e < E; e += blockDim.x) gs[e] = g[(size_t)c * E + e];
  __syncthreads();
  for (int k = warp; k < D; k += nw) {  // d_xn = g @ tproj^T, one warp per k
    float a = 0.f;
    for (int e = lane; e < E; e += 32) a = fmaf(gs[e], tproj[(size_t)k * E + e], a);
    for (int off = 16; off; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0) dxn[k] = a;
  }
  float mu, rs;
  pool_stats(xfin + (size_t)c * L * D, eot + (size_t)c * L, L, D, pooled, red, mu, rs);
  float st = 0.f, stx = 0.f;
  for (int k = threadIdx.x; k < D; k += blockDim.x) {
    const float xh = (pooled[k] - mu) * rs;
    const float t = dxn[k] * lnfs[k];
    pooled[k] = xh;
    dxn[k] = t;
    st += t;
    stx = fmaf(t, xh, stx);
  }
  block_sum2(st, stx, red);
  const float mt = st / D, mtx = stx / D;
  for (int k = threadIdx.x; k < D; k += blockDim.x) {
    const float dp = rs * (dxn[k] - mt - pooled[k] * mtx);
    for (int l = 0; l < L; ++l) {
      const size_t o = ((size_t)c * L + l) * D + k;
      const float d = eot[(size_t)c * L + l] * dp;
      d32[o] = d;
      dT[o] = from_f<T>(d);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
#define PPT_TRY(call)           \
  do {                          \
    int rc__ = (call);          \
    if (rc__) return rc__;      \
  } while (0)

template <bool TB, int EPI>
static int gemm(const float* A, const float* W, int M, int N, int K, EpiArgs ea, void* out,
                cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_f32_kernel<TB, EPI><<<grid, 256, 0, st>>>(A, W, M, N, K, ea, out);
  PPT_CHECK_LAUNCH();
  return 0;
}

template <bool TB, int EPI>
static int gemm(const bf16* A, const bf16* W, int M, int N, int K, EpiArgs ea, void* out,
                cudaStream_t st) {
  if (K % TBK || N % 8) return (int)cudaErrorInvalidValue;
  const int nb = (N + TBN - 1) / TBN;
  if (((M + 127) / 128) * nb >= 120) {  // enough 128-row tiles to fill the card
    dim3 grid(nb, (M + 127) / 128);
    gemm_bf16_kernel<128, TB, EPI><<<grid, 256, 0, st>>>(A, W, M, N, K, ea, out);
  } else {
    dim3 grid(nb, (M + 63) / 64);
    gemm_bf16_kernel<64, TB, EPI><<<grid, 256, 0, st>>>(A, W, M, N, K, ea, out);
  }
  PPT_CHECK_LAUNCH();
  return 0;
}

// the scale as JAX forms it: 1/sqrt(d) in double, then rounded to f32
static float attn_scale(int D) { return (float)(1.0 / sqrt((double)D)); }

template <typename T>
static int ln(const T* x, int rows, int C, const float* s, const float* b, T* out,
              cudaStream_t st) {
  ln_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(x, rows, C, s, b, out);
  PPT_CHECK_LAUNCH();
  return 0;
}

template <typename T>
static int ln_vjp(const T* x, const float* dy, const float* gamma, const float* dprev, int rows,
                  int C, float* d32, T* dT, cudaStream_t st) {
  ln_vjp_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(x, dy, gamma, dprev, rows, C, d32, dT);
  PPT_CHECK_LAUNCH();
  return 0;
}

template <typename T>
static int attn_fwd(const T* qkv, int B, int L, int C, int heads, int mode, T* out,
                    cudaStream_t st) {
  const int D = C / heads;
  const size_t smem = sizeof(float) * (3 * (size_t)L * (D + 1) + (size_t)L * L + L);
  PPT_TRY((int)cudaFuncSetAttribute(attn_fwd_kernel<T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  attn_fwd_kernel<T><<<dim3(heads, B), 256, smem, st>>>(qkv, L, C, D, attn_scale(D), mode, out);
  PPT_CHECK_LAUNCH();
  return 0;
}

template <typename T>
static int attn_bwd(const T* qkv, const T* dO, int B, int L, int C, int heads, T* dqkv,
                    cudaStream_t st) {
  const int D = C / heads;
  const size_t smem = sizeof(float) * (4 * (size_t)L * (D + 1) + 2 * (size_t)L * L);
  PPT_TRY((int)cudaFuncSetAttribute(attn_bwd_kernel<T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  attn_bwd_kernel<T><<<dim3(heads, B), 256, smem, st>>>(qkv, dO, L, C, D, attn_scale(D), dqkv);
  PPT_CHECK_LAUNCH();
  return 0;
}

// One layer's weights, in the order every entry point takes them.
template <typename T>
struct LayerW {
  const float *ln1s, *ln1b;
  const T* win;
  const float* bin;
  const T* wout;
  const float* bout;
  const float *ln2s, *ln2b;
  const T* wfc;
  const float* bfc;
  const T* wproj;
  const float* bproj;
};

// layer i of weights stacked on a leading depth axis; w points at 12 bases
template <typename T>
static LayerW<T> layer_at(void* const* w, int i, int D, int hid) {
  const size_t d = D, h = hid, n = i;
  LayerW<T> lw;
  lw.ln1s = (const float*)w[0] + n * d;
  lw.ln1b = (const float*)w[1] + n * d;
  lw.win = (const T*)w[2] + n * d * 3 * d;
  lw.bin = (const float*)w[3] + n * 3 * d;
  lw.wout = (const T*)w[4] + n * d * d;
  lw.bout = (const float*)w[5] + n * d;
  lw.ln2s = (const float*)w[6] + n * d;
  lw.ln2b = (const float*)w[7] + n * d;
  lw.wfc = (const T*)w[8] + n * d * h;
  lw.bfc = (const float*)w[9] + n * h;
  lw.wproj = (const T*)w[10] + n * h * d;
  lw.bproj = (const float*)w[11] + n * d;
  return lw;
}

// scratch of the forward: y [R, D], qkv [R, 3D], attn [R, D], x1 [R, D], h1 [R, hid]
template <typename T>
struct FwdScratch {
  T *y, *qkv, *attn, *x1, *h1;
};

// x_in -> x1 (after the attention sublayer), with qkv left in s.qkv
template <typename T>
static int attn_sublayer(const T* x_in, const LayerW<T>& w, int B, int L, int D, int heads,
                         int mode, const FwdScratch<T>& s, cudaStream_t st) {
  const int R = B * L;
  PPT_TRY(ln<T>(x_in, R, D, w.ln1s, w.ln1b, s.y, st));
  PPT_TRY((gemm<false, EPI_BIAS>(s.y, w.win, R, 3 * D, D, EpiArgs{w.bin, nullptr, nullptr, mode},
                                 s.qkv, st)));
  PPT_TRY(attn_fwd<T>(s.qkv, B, L, D, heads, mode, s.attn, st));
  PPT_TRY((gemm<false, EPI_BIAS_RES>(s.attn, w.wout, R, D, D,
                                     EpiArgs{w.bout, x_in, nullptr, mode}, s.x1, st)));
  return 0;
}

template <typename T>
static int layer_fwd(const T* x_in, T* x_out, const LayerW<T>& w, int B, int L, int D, int heads,
                     int hid, int mode, const FwdScratch<T>& s, cudaStream_t st) {
  const int R = B * L;
  PPT_TRY(attn_sublayer<T>(x_in, w, B, L, D, heads, mode, s, st));
  PPT_TRY(ln<T>(s.x1, R, D, w.ln2s, w.ln2b, s.y, st));
  PPT_TRY((gemm<false, EPI_BIAS_QGELU>(s.y, w.wfc, R, hid, D,
                                       EpiArgs{w.bfc, nullptr, nullptr, mode}, s.h1, st)));
  PPT_TRY((gemm<false, EPI_BIAS_RES>(s.h1, w.wproj, R, D, hid,
                                     EpiArgs{w.bproj, s.x1, nullptr, mode}, x_out, st)));
  return 0;
}

// dims: B, L, D, heads, hid
// ptrs: x, 12 weights (LayerW order), y, qkv, attn, x1, h1, out
template <typename T>
static int text_block(const int* dims, void* const* p, cudaStream_t st) {
  const int B = dims[0], L = dims[1], D = dims[2], heads = dims[3], hid = dims[4];
  const LayerW<T> w = layer_at<T>(p + 1, 0, D, hid);
  const FwdScratch<T> s{(T*)p[13], (T*)p[14], (T*)p[15], (T*)p[16], (T*)p[17]};
  return layer_fwd<T>((const T*)p[0], (T*)p[18], w, B, L, D, heads, hid, ROUND_BLOCK, s, st);
}

// dims: C, L, D, heads, hid, depth, E
// ptrs: x0, eot, 12 stacked weights, lnfs, lnfb, tproj, y, qkv, attn, x1, h1,
//       xa, xb (ping-pong, unused with xs), xs [depth, C*L, D] or null, out [C, E]
template <typename T>
static int text_tower(const int* dims, void* const* p, cudaStream_t st) {
  const int B = dims[0], L = dims[1], D = dims[2], heads = dims[3], hid = dims[4];
  const int depth = dims[5], E = dims[6];
  const size_t RD = (size_t)B * L * D;
  const FwdScratch<T> s{(T*)p[17], (T*)p[18], (T*)p[19], (T*)p[20], (T*)p[21]};
  T* pp[2] = {(T*)p[22], (T*)p[23]};
  T* xs = (T*)p[24];
  const T* x = (const T*)p[0];
  for (int i = 0; i < depth; ++i) {
    T* x_out = xs ? xs + (size_t)i * RD : pp[i & 1];
    PPT_TRY(layer_fwd<T>(x, x_out, layer_at<T>(p + 2, i, D, hid), B, L, D, heads, hid,
                         ROUND_TOWER, s, st));
    x = x_out;
  }
  const size_t smem = sizeof(float) * ((size_t)D + 64);
  pool_ln_proj_kernel<T><<<B, 256, smem, st>>>(x, (const float*)p[1], L, D, E,
                                               (const float*)p[14], (const float*)p[15],
                                               (const float*)p[16], (float*)p[25]);
  PPT_CHECK_LAUNCH();
  return 0;
}

// dims: C, L, D, heads, hid, depth, E
// ptrs: g [C, E] f32, x0, xs, eot, 12 stacked weights, lnfs, lnfb, tproj,
//       y, qkv, attn, x1 (T), h1f [R, hid] f32, dh [R, hid] T, dT [R, D] T,
//       d2, dx1, dy [R, D] f32, dO [R, D] T, dqkv [R, 3D] T, dx0 [C, L, D] T
template <typename T>
static int text_tower_bwd(const int* dims, void* const* p, cudaStream_t st) {
  const int B = dims[0], L = dims[1], D = dims[2], heads = dims[3], hid = dims[4];
  const int depth = dims[5], E = dims[6];
  const int R = B * L;
  const size_t RD = (size_t)R * D;
  const float* g = (const float*)p[0];
  const T* x0 = (const T*)p[1];
  const T* xs = (const T*)p[2];
  const float* eot = (const float*)p[3];
  void* const* w = p + 4;
  const FwdScratch<T> s{(T*)p[19], (T*)p[20], (T*)p[21], (T*)p[22], nullptr};
  float* h1f = (float*)p[23];
  T* dh = (T*)p[24];
  T* dT = (T*)p[25];
  float* d2 = (float*)p[26];
  float* dx1 = (float*)p[27];
  float* dy = (float*)p[28];
  T* dO = (T*)p[29];
  T* dqkv = (T*)p[30];
  T* dx0 = (T*)p[31];

  const size_t smem = sizeof(float) * (2 * (size_t)D + E + 64);
  PPT_TRY((int)cudaFuncSetAttribute(epilogue_bwd_kernel<T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  epilogue_bwd_kernel<T><<<B, 256, smem, st>>>(g, xs + (size_t)(depth - 1) * RD, eot, L, D, E,
                                               (const float*)w[12], (const float*)w[14], d2, dT);
  PPT_CHECK_LAUNCH();

  for (int i = depth - 1; i >= 0; --i) {
    const LayerW<T> lw = layer_at<T>(w, i, D, hid);
    const T* x_in = i == 0 ? x0 : xs + (size_t)(i - 1) * RD;
    // recompute the forward's internals from the saved block input
    PPT_TRY(attn_sublayer<T>(x_in, lw, B, L, D, heads, ROUND_TOWER, s, st));
    PPT_TRY(ln<T>(s.x1, R, D, lw.ln2s, lw.ln2b, s.y, st));
    PPT_TRY((gemm<false, EPI_BIAS_F32>(s.y, lw.wfc, R, hid, D,
                                       EpiArgs{lw.bfc, nullptr, nullptr, 0}, h1f, st)));
    // MLP backward
    PPT_TRY((gemm<true, EPI_GELU_GRAD>(dT, lw.wproj, R, hid, D,
                                       EpiArgs{nullptr, nullptr, h1f, 0}, dh, st)));
    PPT_TRY((gemm<true, EPI_F32>(dh, lw.wfc, R, D, hid, EpiArgs{nullptr, nullptr, nullptr, 0},
                                 dy, st)));
    PPT_TRY(ln_vjp<T>(s.x1, dy, lw.ln2s, d2, R, D, dx1, dT, st));
    // attention backward
    PPT_TRY((gemm<true, EPI_ROUND>(dT, lw.wout, R, D, D, EpiArgs{nullptr, nullptr, nullptr, 0},
                                   dO, st)));
    PPT_TRY(attn_bwd<T>(s.qkv, dO, B, L, D, heads, dqkv, st));
    PPT_TRY((gemm<true, EPI_F32>(dqkv, lw.win, R, D, 3 * D,
                                 EpiArgs{nullptr, nullptr, nullptr, 0}, dy, st)));
    PPT_TRY(ln_vjp<T>(x_in, dy, lw.ln1s, dx1, R, D, d2, i == 0 ? dx0 : dT, st));
  }
  return 0;
}

}  // namespace text

PPT_EXPORT int ppt_text_block(int dtype, const int* dims, void* const* ptrs, void* stream) {
  if (dtype == PPT_BF16) return text::text_block<bf16>(dims, ptrs, (cudaStream_t)stream);
  return text::text_block<float>(dims, ptrs, (cudaStream_t)stream);
}

PPT_EXPORT int ppt_text_tower(int dtype, const int* dims, void* const* ptrs, void* stream) {
  if (dtype == PPT_BF16) return text::text_tower<bf16>(dims, ptrs, (cudaStream_t)stream);
  return text::text_tower<float>(dims, ptrs, (cudaStream_t)stream);
}

PPT_EXPORT int ppt_text_tower_bwd(int dtype, const int* dims, void* const* ptrs, void* stream) {
  if (dtype == PPT_BF16) return text::text_tower_bwd<bf16>(dims, ptrs, (cudaStream_t)stream);
  return text::text_tower_bwd<float>(dims, ptrs, (cudaStream_t)stream);
}
