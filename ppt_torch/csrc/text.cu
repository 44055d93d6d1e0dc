// The CLIP text path on hand-written kernels: one text block, the whole
// tower (12 blocks + EOT pooling + ln_final + text_projection, with or
// without every block's output) and the tower's input-cotangent backward.
//
// Replaces ppt_tpu/kernels/textblock.py:fused_text_block (_text_kernel),
// ppt_tpu/kernels/texttower.py:fused_text_tower (_tower_kernel, both
// variants) and :_tower_bwd_pallas (_tower_bwd_kernel).
//
// Bound: operations. One encode of [40, 48, 512] is ~145 GFLOP of GEMM
// (0.147 ms at the bf16 peak) against 75 MB of bf16 weights that no SM can
// hold, so each C entry point walks the layers itself and launches GEMM,
// LayerNorm and attention kernels on one stream: 7 per layer forward, 13
// per layer backward (12 in bf16, where c_fc's recompute runs inside the
// GELU-gradient product), none from Python; in bf16 each launched with
// programmatic dependent launch so that its launch and prologue overlap
// the kernel before it (chained()). In bf16 the GEMMs run gemm.cuh's
// warp-specialised wgmma body on TMA-loaded tiles (persistent CTAs, f32
// accumulators), with this file's epilogues as its functor; the
// backward's products against a transposed weight read the weight as it
// lies ([N, K], a K-major wgmma operand), so no weight is ever transposed
// in memory, and its f32 results (the LayerNorms' cotangents) leave from
// the registers. The 1920 rows of the slice make 60 tiles of 128 x 128 of
// every N = 512 product on 132 SMs, so gemm.cuh's rule takes 128 x 64
// tiles there. In f32 the GEMMs run as FMA on the CUDA cores, since TF32
// would round the operands.
// Attention is one block per (class, head): a class is at most 77 rows.
// In bf16 it runs on the tensor cores (mma.sync m16n8k16): q, k, v (and
// dO, T(P), T(dS) in the backward) come into shared memory as bf16 by
// cp.async, one warp per 16 query rows holds its scores in registers, the
// softmax runs on the accumulator fragments, and each warp's products stop
// at its diagonal tile (nothing past a row is read). wgmma's 64-row tiles
// would pad L = 48 to 64; these products are about 1% of the work. In f32
// the scores sit in shared memory and the products run as FMA.
// The LayerNorm backward moves each row in 16-byte accesses (one warp a
// row), and the tower's f32 projection [D, E] is read by many blocks a
// class.
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
#include <type_traits>

#include "gemm.cuh"

PPT_ERROR_STRING_FN

namespace text {  // keeps these kernels' names apart from csrc/vitblock.cu's in a trace

constexpr float LN_EPS = 1e-5f;
enum { ROUND_TOWER = 0, ROUND_BLOCK = 1 };

__device__ __forceinline__ float sigmoidf(float z) { return 1.0f / (1.0f + expf(-z)); }

// Every kernel here runs in a chain of launches on one stream; in bf16 each
// is launched with programmatic dependent launch (launch_kernel, hopper.cuh):
// it waits for the kernel before it, then lets the next one launch, whose
// CTAs wait in turn, so each launch's latency and prologue overlap the
// previous kernel's tail. The f32 chain launches plainly: its many-CTA FMA
// GEMMs ran slower chained so on the H100 (chip_smoke.py's f32 times).
__device__ __forceinline__ void chained() {
  pdl_wait();
  pdl_launch_dependents();
}
template <typename T> constexpr bool PDL = std::is_same<T, bf16>::value;

// ---------------------------------------------------------------------------
// LayerNorm forward and its input cotangent: one warp per row, C <= 1024.
// f32 statistics, fast variance E[x^2] - E[x]^2.
// ---------------------------------------------------------------------------
// Eight consecutive elements p[c .. c + 7] as f32, in one or two 16-byte
// loads, and their stores
__device__ __forceinline__ void load8(const float* __restrict__ p, int c, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p + c);
  const float4 b = *reinterpret_cast<const float4*>(p + c + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* __restrict__ p, int c, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p + c);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __low2float(h[j]);
    v[2 * j + 1] = __high2float(h[j]);
  }
}
__device__ __forceinline__ void store8(float* __restrict__ p, int c, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p + c) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + c + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* __restrict__ p, int c, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p + c) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// out = T(LN(x)) at this tower's eps: the shared row routine (common.cuh)
template <typename T>
__global__ void ln_kernel(const T* __restrict__ x, int rows, int C, const float* __restrict__ s,
                          const float* __restrict__ b, T* __restrict__ out) {
  chained();
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t o = (size_t)row * C;
  add_ln_row<T>(x + o, nullptr, C, s, b, LN_EPS, nullptr, out + o);
}

// d = dprev + r * (t - mean(t) - xhat * mean(t * xhat)), t = dy * gamma,
// with xhat and r recomputed from the LayerNorm's input x
// (texttower.py:157-163). Writes d as f32 and rounded to T. C is a multiple
// of 8: lane l takes the 8-element chunks l, l + 32, ..., so that every
// access is 16 bytes wide.
template <typename T>
__global__ void ln_vjp_kernel(const T* __restrict__ x, const float* __restrict__ dy,
                              const float* __restrict__ gamma, const float* __restrict__ dprev,
                              int rows, int C, float* __restrict__ d32, T* __restrict__ dT) {
  chained();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = (size_t)row * C;
  float v[4][8], t[4][8];
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 8 * (lane + 32 * i);
    if (c < C) load8(x + base, c, v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c >= C) v[i][j] = 0.f;
      sum += v[i][j];
      sq = fmaf(v[i][j], v[i][j], sq);
    }
  }
  for (int off = 16; off; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const float mu = sum / C;
  const float rs = rsqrtf(__fsub_rn(sq / C, __fmul_rn(mu, mu)) + LN_EPS);
  float st = 0.f, stx = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 8 * (lane + 32 * i);
    float g[8], dyv[8];
    if (c < C) {
      load8(dy + base, c, dyv);
      load8(gamma, c, g);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float tv = 0.f, xh = 0.f;
      if (c < C) {
        xh = (v[i][j] - mu) * rs;
        tv = dyv[j] * g[j];
      }
      v[i][j] = xh;
      t[i][j] = tv;
      st += tv;
      stx = fmaf(tv, xh, stx);
    }
  }
  for (int off = 16; off; off >>= 1) {
    st += __shfl_xor_sync(0xffffffffu, st, off);
    stx += __shfl_xor_sync(0xffffffffu, stx, off);
  }
  const float mt = st / C, mtx = stx / C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 8 * (lane + 32 * i);
    if (c >= C) continue;
    float d[8];
    load8(dprev + base, c, d);
#pragma unroll
    for (int j = 0; j < 8; ++j) d[j] = d[j] + rs * (t[i][j] - mt - v[i][j] * mtx);
    store8(d32 + base, c, d);
    store8(dT + base, c, d);
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

// The epilogue as the functor both GEMM main loops take: what depends on
// the column alone (the bias, as the rounding mode adds it) taken once by
// col(c), the value before its final rounding to the output's type by
// value(acc, rv, cv, ev), with ev the residual (RES) or the GELU
// pre-activation (EPI_GELU_GRAD). The f32 main loop (common.cuh) calls it
// per element and it stores, reading the pre-activation from ea.aux (an
// EPI_BIAS_F32 product's output). The wgmma one (gemm.cuh) stores a bf16
// result itself by TMA, reads the residual by TMA, stores an f32 result
// by store2, and for EPI_GELU_GRAD (DUAL) computes the pre-activation in
// the same CTA as a second product, pre(acc2, col2(c)) = acc2 + bias in
// f32, as EPI_BIAS_F32 forms it.
//   bias_add: ROUND_TOWER T(T(acc) + T(bias)) in T; ROUND_BLOCK T(acc + bias)
template <typename T, int EPI>
struct Epilogue {
  static constexpr bool RES = EPI == EPI_BIAS_RES;
  static constexpr bool OUT32 = EPI == EPI_F32 || EPI == EPI_BIAS_F32;
  static constexpr bool DUAL = EPI == EPI_GELU_GRAD;
  int N;
  EpiArgs ea;
  void* out;
  __device__ __forceinline__ float row(int) const { return 0.f; }
  __device__ __forceinline__ float col(int c) const {
    if (EPI == EPI_BIAS || RES) return ea.mode == ROUND_TOWER ? rnd<T>(ea.bias[c]) : ea.bias[c];
    return EPI == EPI_BIAS_QGELU || EPI == EPI_BIAS_F32 ? ea.bias[c] : 0.f;
  }
  __device__ __forceinline__ float col2(int c) const { return ea.bias[c]; }
  __device__ __forceinline__ float pre(float acc2, float cv2) const { return __fadd_rn(acc2, cv2); }
  __device__ __forceinline__ float value(float acc, float, float cv, float ev) const {
    if (EPI == EPI_F32 || EPI == EPI_ROUND) return acc;
    if (EPI == EPI_BIAS_F32) return __fadd_rn(acc, cv);
    if (EPI == EPI_BIAS_QGELU) {
      const float z = __fadd_rn(acc, cv);
      return z * sigmoidf(1.702f * z);
    }
    if (EPI == EPI_GELU_GRAD) {  // texttower.py:265-272
      const float sg = sigmoidf(1.702f * ev);
      return acc * (sg + 1.702f * ev * sg * (1.0f - sg));
    }
    const float y = rnd<T>(__fadd_rn(ea.mode == ROUND_TOWER ? rnd<T>(acc) : acc, cv));
    return RES ? __fadd_rn(ev, y) : y;
  }
  __device__ __forceinline__ void store2(int r, int c, float v0, float v1) const {
    *reinterpret_cast<float2*>((float*)out + (size_t)r * N + c) = make_float2(v0, v1);
  }
  __device__ __forceinline__ void operator()(float acc, int r, int c) const {
    const size_t o = (size_t)r * N + c;
    const float ev = RES ? to_f(((const T*)ea.res)[o]) : DUAL ? ea.aux[o] : 0.f;
    const float v = value(acc, 0.f, col(c), ev);
    if (OUT32) ((float*)out)[o] = v;
    else ((T*)out)[o] = from_f<T>(v);
  }
};

// f32 on the CUDA cores (common.cuh)
template <bool TB, int EPI>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W, int M, int N, int K,
                EpiArgs ea, void* __restrict__ out) {
  chained();
  gemm_f32_body<TB>(A, W, M, N, K, Epilogue<float, EPI>{N, ea, out});
}

// bf16 on Hopper (gemm.cuh): persistent CTAs walking 128 x BN tiles, W
// read as it lies ([N, K] K-major for TB)
template <int BN, bool TB, int EPI>
__global__ void __launch_bounds__(384, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap tr,
                  int M, int N, int K, EpiArgs ea, void* out) {
  chained();
  gemm_wgmma_body<BN, TB>(&ta, &tw, &tc, &tr, M, N, K, Epilogue<bf16, EPI>{N, ea, out});
}

// dh = T((dT @ wproj^T) * quick_gelu'(y2 @ wfc + bfc)) in one pass: the GELU
// pre-activation is the second product of the same CTA (gemm.cuh's DUAL),
// so it never leaves the registers
template <int BN>
__global__ void __launch_bounds__(384, 1)
gemm_gelu_grad_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tw,
                      const __grid_constant__ CUtensorMap tc,
                      const __grid_constant__ CUtensorMap ta2,
                      const __grid_constant__ CUtensorMap tw2, int M, int N, int K, EpiArgs ea) {
  chained();
  gemm_wgmma_body<BN, true>(&ta, &tw, &tc, &tc, M, N, K,
                            Epilogue<bf16, EPI_GELU_GRAD>{N, ea, nullptr}, &ta2, &tw2);
}

// ---------------------------------------------------------------------------
// Causal attention, one block per (head, class). qkv [B, L, 3C] (q | k | v,
// heads side by side); every product stops at the query's own row.
// ---------------------------------------------------------------------------
// f32: the CUDA cores. Shared memory holds q, k, v as f32 [L][D + 1] and
// the [L][L] scores.
__device__ __forceinline__ void load_head(float* dst, const float* __restrict__ src, size_t ld,
                                          int L, int D) {
  for (int e = threadIdx.x; e < L * D; e += blockDim.x) {
    const int i = e / D, d = e % D;
    dst[i * (D + 1) + d] = src[(size_t)i * ld + d];
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
// sum; otherwise S <- exp(s - m) and den[i] <- sum.
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

__global__ void __launch_bounds__(256)
attn_fwd_f32_kernel(const float* __restrict__ qkv, int L, int C, int D, float scale, int mode,
                    float* __restrict__ out) {
  chained();
  extern __shared__ float sm[];
  const int LD = D + 1;
  float* q = sm;
  float* k = q + L * LD;
  float* v = k + L * LD;
  float* S = v + L * LD;   // [L][L]
  float* den = S + L * L;  // [L]
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t ld = 3 * (size_t)C;
  const float* base = qkv + (size_t)b * L * ld + h * D;
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
    for (int j = 0; j <= i; ++j) a = fmaf(S[i * L + j], v[j * LD + d], a);
    if (mode == ROUND_BLOCK) a = __fdiv_rn(a, den[i]);
    out[((size_t)b * L + i) * C + h * D + d] = a;
  }
}

// dqkv [B, L, 3C] from qkv and dO = d_attn [B, L, C] (texttower.py:287-319)
__global__ void __launch_bounds__(256)
attn_bwd_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dO, int L, int C,
                    int D, float scale, float* __restrict__ dqkv) {
  chained();
  extern __shared__ float sm[];
  const int LD = D + 1;
  float* q = sm;
  float* k = q + L * LD;
  float* v = k + L * LD;
  float* go = v + L * LD;
  float* P = go + L * LD;  // [L][L] probabilities
  float* dS = P + L * L;   // [L][L] dP, then dS
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const size_t ld = 3 * (size_t)C;
  const float* base = qkv + (size_t)b * L * ld + h * D;
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
  for (int i = warp; i < L; i += nw) {  // dS = P * (dP - rowsum(dP * P))
    float rd = 0.f;
    for (int j = lane; j <= i; j += 32) rd = fmaf(dS[i * L + j], P[i * L + j], rd);
    for (int off = 16; off; off >>= 1) rd += __shfl_xor_sync(0xffffffffu, rd, off);
    for (int j = lane; j <= i; j += 32) dS[i * L + j] = P[i * L + j] * (dS[i * L + j] - rd);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < L * D; e += blockDim.x) {
    const int i = e / D, d = e % D;
    float dq = 0.f, dk = 0.f, dv = 0.f;
    for (int j = 0; j <= i; ++j) dq = fmaf(dS[i * L + j], k[j * LD + d], dq);
    for (int r = i; r < L; ++r) {  // row i read as a key: queries r >= i see it
      dk = fmaf(dS[r * L + i], q[r * LD + d], dk);
      dv = fmaf(P[r * L + i], go[r * LD + d], dv);
    }
    float* o = dqkv + ((size_t)b * L + i) * ld + h * D + d;
    o[0] = __fmul_rn(dq, scale);
    o[C] = __fmul_rn(dk, scale);
    o[2 * C] = dv;
  }
}

// bf16: the tensor cores (mma.sync m16n8k16, f32 accumulators; fragment
// layouts in common.cuh). The class's rows are padded to Lp = 16 ceil(L /
// 16) <= ATT_MAX_L, one warp per 16 of them. q, k, v (and dO) sit in
// shared memory as bf16 [Lp][D + 8] (16-byte padded rows: ldmatrix's
// eight row addresses fall in distinct banks), rows past L zero. Warp w
// owns query rows 16 w .. 16 w + 15 and computes their scores against key
// tiles 0 .. w only, into registers; the diagonal tile's entries past a
// row are set to -inf, so nothing past the diagonal is read or counts.
// The softmax runs on the accumulator fragments in f32 (each row's max and
// sum over the four lanes that hold it), and the rounded probabilities
// feed P V straight from the registers as the A fragments.
constexpr int ATT_MAX_L = 128;  // 8 key tiles of 16: 64 f32 scores a thread
constexpr int ATT_MAX_T = ATT_MAX_L / 16;

__device__ __forceinline__ int att_lp(int L) { return (L + 15) & ~15; }

// rows 0 .. L - 1 of a head [L][D] (row stride lds elements) into [Lp][D + 8],
// the rows past L zero: 16-byte cp.async copies, all in flight together
// (the caller commits and waits)
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, size_t lds,
                                          int L, int Lp) {
  constexpr int U = D / 8;  // 16-byte units a row
  for (int e = threadIdx.x; e < Lp * U; e += blockDim.x) {
    const int i = e / U, c = (e % U) * 8;
    cp_async16(dst + i * (D + 8) + c, i < L ? src + (size_t)i * lds + c : src, i < L);
  }
}

// f32 s[2 t + n][e] (+)= A (16 rows at `a`, row stride lda) times B^T for the
// key tiles t <= last, B rows at `b` (row stride ldb), depth D: the
// m16n8k16 C fragments of a [16 x 16 ATT_MAX_T] product
template <int D>
__device__ __forceinline__ void rows_times_rows_t(float (&s)[2 * ATT_MAX_T][4], const bf16* a,
                                                  int lda, const bf16* b, int ldb, int last) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < 2 * ATT_MAX_T; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (lane & 15) * lda + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int t = 0; t < ATT_MAX_T; ++t) {
      if (t > last) break;
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (t * 16 + (lane >> 4) * 8 + (lane & 7)) * ldb + ks * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * t], af, bf[0], bf[1]);
      mma_bf16(s[2 * t + 1], af, bf[2], bf[3]);
    }
  }
}

// o[n][e] += A (16 x 16 k-tile t from the fragments a[t]) times B [k][D] at
// `b` (row stride ldb, rows of k), for the k tiles t0 <= t <= last; A
// fragments from f(t), a callable that returns the tile's 4 registers
template <int D, typename AFrag>
__device__ __forceinline__ void frags_times_rows(float (&o)[D / 8][4], AFrag f, const bf16* b,
                                                 int ldb, int t0, int last) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < ATT_MAX_T; ++t) {
    if (t < t0) continue;
    if (t > last) break;
    uint32_t af[4];
    f(t, af);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + (t * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ldb + dn * 16 +
                                (lane >> 4) * 8);
      mma_bf16(o[2 * dn], af, bf[0], bf[1]);
      mma_bf16(o[2 * dn + 1], af, bf[2], bf[3]);
    }
  }
}

// Scale the scores of query rows i0 + g and i0 + g + 8 (g = lane / 4), set
// the entries past each row to -inf, and return each row's max in m[2].
__device__ __forceinline__ void scale_mask_max(float (&s)[2 * ATT_MAX_T][4], int i0, int last,
                                               float scale, float (&m)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c0 = 2 * (lane & 3);
  m[0] = m[1] = -INFINITY;
#pragma unroll
  for (int t = 0; t < 2 * ATT_MAX_T; ++t) {
    if (t > 2 * last + 1) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e >> 1), j = 8 * t + c0 + (e & 1);
      const float v = j > i ? -INFINITY : __fmul_rn(s[t][e], scale);
      s[t][e] = v;
      m[e >> 1] = fmaxf(m[e >> 1], v);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    for (int off = 1; off < 4; off <<= 1)
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], off));
}

// s <- exp(s - m) and each row's sum in den[2]
__device__ __forceinline__ void exp_rows(float (&s)[2 * ATT_MAX_T][4], int last,
                                         const float (&m)[2], float (&den)[2]) {
  den[0] = den[1] = 0.f;
#pragma unroll
  for (int t = 0; t < 2 * ATT_MAX_T; ++t) {
    if (t > 2 * last + 1) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(__fsub_rn(s[t][e], m[e >> 1]));
      s[t][e] = p;
      den[e >> 1] += p;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    for (int off = 1; off < 4; off <<= 1) den[h] += __shfl_xor_sync(0xffffffffu, den[h], off);
}

// the A fragment of key tile t from the f32 fragments of rows [16][16 t .. 16 t + 15]
__device__ __forceinline__ void pack_frag(const float (&s)[2 * ATT_MAX_T][4], int t,
                                          uint32_t (&a)[4]) {
  a[0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
  a[1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
  a[2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
  a[3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
}

// rows i0 + g, i0 + g + 8 of o (times sc[row]) into out (row stride ld), rows >= L skipped
template <int D>
__device__ __forceinline__ void store_rows(const float (&o)[D / 8][4], bf16* out, size_t ld,
                                           int i0, int L, const float (&sc)[2], bool div) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c0 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + g + 8 * h;
    if (i >= L) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float v0 = o[n][2 * h], v1 = o[n][2 * h + 1];
      if (div) {
        v0 = __fdiv_rn(v0, sc[h]);
        v1 = __fdiv_rn(v1, sc[h]);
      } else {
        v0 = __fmul_rn(v0, sc[h]);
        v1 = __fmul_rn(v1, sc[h]);
      }
      *reinterpret_cast<uint32_t*>(out + (size_t)i * ld + 8 * n + c0) = pack_bf16(v0, v1);
    }
  }
}

// tower: P normalised in f32, then cast to bf16 before P V; block: exp(s -
// m) cast to bf16, the f32 accumulator divided by the f32 denominator after
template <int D>
__global__ void __launch_bounds__(32 * ATT_MAX_T)
attn_fwd_bf16_kernel(const bf16* __restrict__ qkv, int L, int C, float scale, int mode,
                     bf16* __restrict__ out) {
  chained();
  extern __shared__ __align__(16) unsigned char att_smem[];
  constexpr int LD = D + 8;
  const int Lp = att_lp(L);
  bf16* q = reinterpret_cast<bf16*>(att_smem);
  bf16* k = q + Lp * LD;
  bf16* v = k + Lp * LD;
  const int h = blockIdx.x, b = blockIdx.y, w = threadIdx.x >> 5;
  const size_t ld = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)b * L * ld + h * D;
  load_rows<D>(q, base, ld, L, Lp);
  load_rows<D>(k, base + C, ld, L, Lp);
  load_rows<D>(v, base + 2 * C, ld, L, Lp);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float s[2 * ATT_MAX_T][4], m[2], den[2];
  rows_times_rows_t<D>(s, q + 16 * w * LD, LD, k, LD, w);
  scale_mask_max(s, 16 * w, w, scale, m);
  exp_rows(s, w, m, den);
  const bool tower = mode == ROUND_TOWER;
  if (tower) {
#pragma unroll
    for (int t = 0; t < 2 * ATT_MAX_T; ++t) {
      if (t > 2 * w + 1) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = __fdiv_rn(s[t][e], den[e >> 1]);
    }
  }
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  frags_times_rows<D>(o, [&](int t, uint32_t(&a)[4]) { pack_frag(s, t, a); }, v, LD, 0, w);
  const float sc[2] = {tower ? 1.f : den[0], tower ? 1.f : den[1]};
  store_rows<D>(o, out + (size_t)b * L * C + h * D, (size_t)C, 16 * w, L, sc, !tower);
}

// dqkv [B, L, 3C] from qkv and dO = T(d_attn) [B, L, C] (texttower.py:287-319).
// Warp w first forms its query rows' f32 P and dP = dO V^T in registers,
// then dS = T(P * (dP - rowsum(dP * P))) and T(P) into shared memory (rows
// past L zero); after a barrier it forms dq for query tile w (dS K), and
// dk (dS^T Q) and dv (T(P)^T dO) for key tile w from query tiles w ..,
// the transposed operands through ldmatrix.trans. dq and dk are scaled
// after their products.
template <int D>
__global__ void __launch_bounds__(32 * ATT_MAX_T)
attn_bwd_bf16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dO, int L, int C,
                     float scale, bf16* __restrict__ dqkv) {
  chained();
  extern __shared__ __align__(16) unsigned char att_smem[];
  constexpr int LD = D + 8;
  const int Lp = att_lp(L), LP = Lp + 8, nt = Lp / 16;
  bf16* q = reinterpret_cast<bf16*>(att_smem);
  bf16* k = q + Lp * LD;
  bf16* v = k + Lp * LD;
  bf16* go = v + Lp * LD;
  bf16* P = go + Lp * LD;  // [Lp][Lp + 8] T(P)
  bf16* dS = P + Lp * LP;  // [Lp][Lp + 8] T(dS)
  const int h = blockIdx.x, b = blockIdx.y, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c0 = 2 * (lane & 3);
  const size_t ld = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)b * L * ld + h * D;
  load_rows<D>(q, base, ld, L, Lp);
  load_rows<D>(k, base + C, ld, L, Lp);
  load_rows<D>(v, base + 2 * C, ld, L, Lp);
  load_rows<D>(go, dO + (size_t)b * L * C + h * D, (size_t)C, L, Lp);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  {
    float s[2 * ATT_MAX_T][4], dp[2 * ATT_MAX_T][4], m[2], den[2], rd[2] = {0.f, 0.f};
    rows_times_rows_t<D>(s, q + 16 * w * LD, LD, k, LD, w);
    scale_mask_max(s, 16 * w, w, scale, m);
    exp_rows(s, w, m, den);
    rows_times_rows_t<D>(dp, go + 16 * w * LD, LD, v, LD, w);
#pragma unroll
    for (int t = 0; t < 2 * ATT_MAX_T; ++t) {
      if (t > 2 * w + 1) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[t][e] = __fdiv_rn(s[t][e], den[e >> 1]);
        rd[e >> 1] = fmaf(dp[t][e], s[t][e], rd[e >> 1]);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      for (int off = 1; off < 4; off <<= 1) rd[hh] += __shfl_xor_sync(0xffffffffu, rd[hh], off);
#pragma unroll
    for (int t = 0; t < 2 * ATT_MAX_T; ++t) {
      if (t > 2 * w + 1) break;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 16 * w + g + 8 * hh, j = 8 * t + c0;
        const bool row = i < L;  // rows past L: zero
        const float p0 = row ? s[t][2 * hh] : 0.f, p1 = row ? s[t][2 * hh + 1] : 0.f;
        *reinterpret_cast<uint32_t*>(P + i * LP + j) = pack_bf16(p0, p1);
        *reinterpret_cast<uint32_t*>(dS + i * LP + j) =
            pack_bf16(p0 * (dp[t][2 * hh] - rd[hh]), p1 * (dp[t][2 * hh + 1] - rd[hh]));
      }
    }
  }
  __syncthreads();
  float o[D / 8][4];
  const float sc[2] = {scale, scale}, one[2] = {1.f, 1.f};
  bf16* out = dqkv + (size_t)b * L * ld + h * D;
  auto zero = [&]() {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  };
  // rows [16 w][16 t] of a [Lp][LP] matrix, as an A fragment
  auto rows_of = [&](const bf16* X) {
    return [=](int t, uint32_t(&a)[4]) {
      ldmatrix_x4(a, X + (16 * w + (lane & 15)) * LP + 16 * t + (lane >> 4) * 8);
    };
  };
  // columns [16 t][16 w] of a [Lp][LP] matrix, transposed, as an A fragment
  auto cols_of = [&](const bf16* X) {
    return [=](int t, uint32_t(&a)[4]) {
      ldmatrix_x4_trans(a, X + (16 * t + ((lane >> 4) & 1) * 8 + (lane & 7)) * LP + 16 * w +
                               ((lane >> 3) & 1) * 8);
    };
  };
  zero();
  frags_times_rows<D>(o, rows_of(dS), k, LD, 0, w);  // dq = dS K
  store_rows<D>(o, out, ld, 16 * w, L, sc, false);
  zero();
  frags_times_rows<D>(o, cols_of(dS), q, LD, w, nt - 1);  // dk = dS^T Q
  store_rows<D>(o, out + C, ld, 16 * w, L, sc, false);
  zero();
  frags_times_rows<D>(o, cols_of(P), go, LD, w, nt - 1);  // dv = T(P)^T dO
  store_rows<D>(o, out + 2 * C, ld, 16 * w, L, one, false);
}

// ---------------------------------------------------------------------------
// Tower epilogue: EOT pooling (the one-hot rows' f32 sum), ln_final,
// text_projection; and its backward. The projection's f32 [D, E] weight is
// read by many blocks a class (one block a class left the loads' latency
// in series: 0.11 ms of the forward on the H100).
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
#pragma unroll 8
    for (int l = 0; l < L; ++l) p = fmaf(eot[l], to_f(x[(size_t)l * D + k]), p);
    pooled[k] = p;
    sum += p;
    sq = fmaf(p, p, sq);
  }
  block_sum2(sum, sq, red);
  mu = sum / D;
  rs = rsqrtf(__fsub_rn(sq / D, __fmul_rn(mu, mu)) + LN_EPS);
}

// out[c, e] = (ln_final(pooled[c]) @ tproj)[e]. Grid (C, ceil(E / 64)), 1024
// threads: each block pools its class and normalises it (the pooling is
// cheap next to the projection), then 16 groups of 64 threads each sum a
// sixteenth of D for the block's 64 columns (loads coalesced along E), the
// 16 partial sums added in a fixed order.
constexpr int PROJ_COLS = 64, PROJ_GROUPS = 16;

template <typename T>
__global__ void __launch_bounds__(PROJ_COLS * PROJ_GROUPS)
pool_ln_proj_kernel(const T* __restrict__ x, const float* __restrict__ eot, int L, int D, int E,
                    const float* __restrict__ lnfs, const float* __restrict__ lnfb,
                    const float* __restrict__ tproj, float* __restrict__ out) {
  chained();
  extern __shared__ float sm[];
  float* xn = sm;          // [D]
  float* red = sm + D;     // [64]
  float* part = red + 64;  // [PROJ_GROUPS][PROJ_COLS]
  const int c = blockIdx.x, col = threadIdx.x % PROJ_COLS, grp = threadIdx.x / PROJ_COLS;
  const int e = blockIdx.y * PROJ_COLS + col;
  float mu, rs;
  pool_stats(x + (size_t)c * L * D, eot + (size_t)c * L, L, D, xn, red, mu, rs);
  for (int k = threadIdx.x; k < D; k += blockDim.x)
    xn[k] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xn[k], mu), rs), lnfs[k]), lnfb[k]);
  __syncthreads();
  float a = 0.f;
  if (e < E) {
#pragma unroll 8
    for (int k = grp; k < D; k += PROJ_GROUPS) a = fmaf(xn[k], tproj[(size_t)k * E + e], a);
  }
  part[grp * PROJ_COLS + col] = a;
  __syncthreads();
  if (grp == 0 && e < E) {
    float o = 0.f;
    for (int q = 0; q < PROJ_GROUPS; ++q) o += part[q * PROJ_COLS + col];
    out[(size_t)c * E + e] = o;
  }
}

// dxn[c, k] = (g[c] @ tproj^T)[k]. Grid (C, ceil(D / 32)), 256 threads: warp w
// of a block takes rows k = 32 blockIdx.y + w + 8 j (j < 4) of tproj, its
// lanes along E (coalesced), four rows' loads in flight at once.
__global__ void __launch_bounds__(256)
proj_bwd_kernel(const float* __restrict__ g, const float* __restrict__ tproj, int D, int E,
                float* __restrict__ dxn) {
  chained();
  const int c = blockIdx.x, lane = threadIdx.x & 31, k0 = blockIdx.y * 32 + (threadIdx.x >> 5);
  const float* gc = g + (size_t)c * E;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int e = lane; e < E; e += 32) {
    const float ge = gc[e];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + 8 * j < D) a[j] = fmaf(ge, tproj[(size_t)(k0 + 8 * j) * E + e], a[j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    for (int off = 16; off; off >>= 1) a[j] += __shfl_xor_sync(0xffffffffu, a[j], off);
    if (lane == 0 && k0 + 8 * j < D) dxn[(size_t)c * D + k0 + 8 * j] = a[j];
  }
}

// d2[c, l, :] = eot[c, l] * ln_vjp(dxn[c]) (texttower.py:193-210), dxn from
// proj_bwd_kernel
template <typename T>
__global__ void __launch_bounds__(256)
epilogue_bwd_kernel(const float* __restrict__ dxn_in, const T* __restrict__ xfin,
                    const float* __restrict__ eot, int L, int D, const float* __restrict__ lnfs,
                    float* __restrict__ d32, T* __restrict__ dT) {
  chained();
  extern __shared__ float sm[];
  float* pooled = sm;       // [D]
  float* dxn = sm + D;      // [D]
  float* red = dxn + D;     // [64]
  const int c = blockIdx.x;
  float mu, rs;
  pool_stats(xfin + (size_t)c * L * D, eot + (size_t)c * L, L, D, pooled, red, mu, rs);
  float st = 0.f, stx = 0.f;
  for (int k = threadIdx.x; k < D; k += blockDim.x) {
    const float xh = (pooled[k] - mu) * rs;
    const float t = dxn_in[(size_t)c * D + k] * lnfs[k];
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
  return launch_kernel(false, gemm_f32_kernel<TB, EPI>, grid, 256, 0, st, A, W, M, N, K, ea, out);
}

// bf16 on gemm.cuh's wgmma body. Maps: A [M, K]; W [K, N] (64-row boxes) or,
// for TB, [N, K] (BN-row boxes); a bf16 output [M, N]; the residual [M, N]
// (EPI_BIAS_RES). An f32 output leaves from the registers, so its maps are
// placeholders. K and N are multiples of 8 and every base 16-byte aligned
// (kernels/textblock.py refuses the rest by name).
template <int BN, bool TB, int EPI>
static int gemm_wgmma(const bf16* A, const bf16* W, int M, int N, int K, EpiArgs ea, void* out,
                      cudaStream_t st) {
  using Epi = Epilogue<bf16, EPI>;
  auto kernel = gemm_wgmma_kernel<BN, TB, EPI>;
  static const int pool = check_reg_pool(kernel, RegSplit<3, 1>::NEED);
  if (pool) return pool;
  constexpr int smem = GemmTile<BN>::SMEM;
  static const int attr = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr) return attr;
  CUtensorMap maps[4];
  PPT_TRY(mat_map(&maps[0], A, M, K, GM_BM));
  PPT_TRY(TB ? mat_map(&maps[1], W, N, K, BN) : mat_map(&maps[1], W, K, N, GM_BK));
  if (Epi::OUT32) maps[2] = maps[0];
  else PPT_TRY(mat_map(&maps[2], (const bf16*)out, M, N, GM_BM));
  if (Epi::RES) PPT_TRY(mat_map(&maps[3], (const bf16*)ea.res, M, N, GM_BM));
  else maps[3] = maps[2];
  const int tiles = ((M + GM_BM - 1) / GM_BM) * ((N + BN - 1) / BN), sms = sm_count();
  return launch_kernel(true, kernel, tiles < sms ? tiles : sms, 384, smem, st, maps[0], maps[1],
                       maps[2], maps[3], M, N, K, ea, out);
}

template <bool TB, int EPI>
static int gemm(const bf16* A, const bf16* W, int M, int N, int K, EpiArgs ea, void* out,
                cudaStream_t st) {
  if (K % 8 || N % 8) return (int)cudaErrorInvalidValue;  // TMA rows: multiples of 16 bytes
  return gemm_tile_n(M, N, sm_count()) == 64
             ? gemm_wgmma<64, TB, EPI>(A, W, M, N, K, ea, out, st)
             : gemm_wgmma<128, TB, EPI>(A, W, M, N, K, ea, out, st);
}

// dh = T((dT @ wproj^T) * quick_gelu'(y2 @ wfc + bfc)) [M, N] (K deep). f32:
// the pre-activation as an f32 product into h1f, then the product it
// scales; bf16: both products in one CTA, h1f unused.
static int gelu_grad(const float* dT, const float* wproj, const float* y2, const float* wfc,
                     const float* bfc, int M, int N, int K, float* h1f, float* dh,
                     cudaStream_t st) {
  PPT_TRY((gemm<false, EPI_BIAS_F32>(y2, wfc, M, N, K, EpiArgs{bfc, nullptr, nullptr, 0}, h1f,
                                     st)));
  return gemm<true, EPI_GELU_GRAD>(dT, wproj, M, N, K, EpiArgs{nullptr, nullptr, h1f, 0}, dh, st);
}

template <int BN>
static int gelu_grad_wgmma(const bf16* dT, const bf16* wproj, const bf16* y2, const bf16* wfc,
                           const float* bfc, int M, int N, int K, bf16* dh, cudaStream_t st) {
  auto kernel = gemm_gelu_grad_kernel<BN>;
  static const int pool = check_reg_pool(kernel, RegSplit<3, 1>::NEED);
  if (pool) return pool;
  constexpr int smem = GemmTile<BN>::SMEM;
  static const int attr = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr) return attr;
  CUtensorMap maps[5];
  PPT_TRY(mat_map(&maps[0], dT, M, K, GM_BM));
  PPT_TRY(mat_map(&maps[1], wproj, N, K, BN));
  PPT_TRY(mat_map(&maps[2], dh, M, N, GM_BM));
  PPT_TRY(mat_map(&maps[3], y2, M, K, GM_BM));
  PPT_TRY(mat_map(&maps[4], wfc, K, N, GM_BK));
  const int tiles = ((M + GM_BM - 1) / GM_BM) * ((N + BN - 1) / BN), sms = sm_count();
  return launch_kernel(true, kernel, tiles < sms ? tiles : sms, 384, smem, st, maps[0], maps[1],
                       maps[2], maps[3], maps[4], M, N, K, EpiArgs{bfc, nullptr, nullptr, 0});
}

static int gelu_grad(const bf16* dT, const bf16* wproj, const bf16* y2, const bf16* wfc,
                     const float* bfc, int M, int N, int K, float*, bf16* dh, cudaStream_t st) {
  if (K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  return gemm_tile_n(M, N, sm_count()) == 64
             ? gelu_grad_wgmma<64>(dT, wproj, y2, wfc, bfc, M, N, K, dh, st)
             : gelu_grad_wgmma<128>(dT, wproj, y2, wfc, bfc, M, N, K, dh, st);
}

// the scale as JAX forms it: 1/sqrt(d) in double, then rounded to f32
static float attn_scale(int D) { return (float)(1.0 / sqrt((double)D)); }

template <typename T>
static int ln(const T* x, int rows, int C, const float* s, const float* b, T* out,
              cudaStream_t st) {
  return launch_kernel(PDL<T>, ln_kernel<T>, (rows + 7) / 8, 256, 0, st, x, rows, C, s, b, out);
}

template <typename T>
static int ln_vjp(const T* x, const float* dy, const float* gamma, const float* dprev, int rows,
                  int C, float* d32, T* dT, cudaStream_t st) {
  return launch_kernel(PDL<T>, ln_vjp_kernel<T>, (rows + 7) / 8, 256, 0, st, x, dy, gamma, dprev,
                       rows, C, d32, dT);
}

static int attn_fwd(const float* qkv, int B, int L, int C, int heads, int mode, float* out,
                    cudaStream_t st) {
  const int D = C / heads;
  const size_t smem = sizeof(float) * (3 * (size_t)L * (D + 1) + (size_t)L * L + L);
  PPT_TRY((int)cudaFuncSetAttribute(attn_fwd_f32_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  return launch_kernel(false, attn_fwd_f32_kernel, dim3(heads, B), 256, smem, st, qkv, L, C, D,
                       attn_scale(D), mode, out);
}

static int attn_bwd(const float* qkv, const float* dO, int B, int L, int C, int heads,
                    float* dqkv, cudaStream_t st) {
  const int D = C / heads;
  const size_t smem = sizeof(float) * (4 * (size_t)L * (D + 1) + 2 * (size_t)L * L);
  PPT_TRY((int)cudaFuncSetAttribute(attn_bwd_f32_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  return launch_kernel(false, attn_bwd_f32_kernel, dim3(heads, B), 256, smem, st, qkv, dO, L, C,
                       D, attn_scale(D), dqkv);
}

// bf16 attention's shared memory: q, k, v (and dO) as [Lp][D + 8], and for
// the backward T(P) and T(dS) as [Lp][Lp + 8] (kernels/textblock.py
// mirrors it)
static size_t attn_bf16_smem(int L, int D, bool backward) {
  const size_t Lp = (L + 15) & ~15;
  return 2 * ((backward ? 4 : 3) * Lp * (D + 8) + (backward ? 2 * Lp * (Lp + 8) : 0));
}

template <int D>
static int attn_fwd_d(const bf16* qkv, int B, int L, int C, int heads, int mode, bf16* out,
                      cudaStream_t st) {
  const size_t smem = attn_bf16_smem(L, D, false);
  PPT_TRY((int)cudaFuncSetAttribute(attn_fwd_bf16_kernel<D>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  return launch_kernel(true, attn_fwd_bf16_kernel<D>, dim3(heads, B), 2 * ((L + 15) & ~15), smem,
                       st, qkv, L, C, attn_scale(D), mode, out);
}

template <int D>
static int attn_bwd_d(const bf16* qkv, const bf16* dO, int B, int L, int C, int heads, bf16* dqkv,
                      cudaStream_t st) {
  const size_t smem = attn_bf16_smem(L, D, true);
  PPT_TRY((int)cudaFuncSetAttribute(attn_bwd_bf16_kernel<D>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  return launch_kernel(true, attn_bwd_bf16_kernel<D>, dim3(heads, B), 2 * ((L + 15) & ~15), smem,
                       st, qkv, dO, L, C, attn_scale(D), dqkv);
}

// head dims 16, 32, ..., 128 (one instance each)
#define PPT_HEAD_DIM_SWITCH(D, CALL) \
  switch (D) {                       \
    case 16: return CALL(16);        \
    case 32: return CALL(32);        \
    case 48: return CALL(48);        \
    case 64: return CALL(64);        \
    case 80: return CALL(80);        \
    case 96: return CALL(96);        \
    case 112: return CALL(112);      \
    case 128: return CALL(128);      \
  }                                  \
  return (int)cudaErrorInvalidValue

static int attn_fwd(const bf16* qkv, int B, int L, int C, int heads, int mode, bf16* out,
                    cudaStream_t st) {
  if (L > ATT_MAX_L) return (int)cudaErrorInvalidValue;
#define PPT_CALL(d) attn_fwd_d<d>(qkv, B, L, C, heads, mode, out, st)
  PPT_HEAD_DIM_SWITCH(C / heads, PPT_CALL);
#undef PPT_CALL
}

static int attn_bwd(const bf16* qkv, const bf16* dO, int B, int L, int C, int heads, bf16* dqkv,
                    cudaStream_t st) {
  if (L > ATT_MAX_L) return (int)cudaErrorInvalidValue;
#define PPT_CALL(d) attn_bwd_d<d>(qkv, dO, B, L, C, heads, dqkv, st)
  PPT_HEAD_DIM_SWITCH(C / heads, PPT_CALL);
#undef PPT_CALL
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
  PPT_TRY(attn_fwd(s.qkv, B, L, D, heads, mode, s.attn, st));
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
  const size_t smem = sizeof(float) * ((size_t)D + 64 + PROJ_COLS * PROJ_GROUPS);
  return launch_kernel(PDL<T>, pool_ln_proj_kernel<T>, dim3(B, (E + PROJ_COLS - 1) / PROJ_COLS),
                       PROJ_COLS * PROJ_GROUPS, smem, st, x, (const float*)p[1], L, D, E,
                       (const float*)p[14], (const float*)p[15], (const float*)p[16],
                       (float*)p[25]);
}

// dims: C, L, D, heads, hid, depth, E
// ptrs: g [C, E] f32, x0, xs, eot, 12 stacked weights, lnfs, lnfb, tproj,
//       y, qkv, attn, x1 (T), h1f [R, hid] f32 (f32 only, else null),
//       dh [R, hid] T, dT [R, D] T, d2, dx1, dy [R, D] f32, dO [R, D] T,
//       dqkv [R, 3D] T, dx0 [C, L, D] T
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

  // d_xn = g @ tproj^T into dy's memory as f32 [C, D] (dy is free until the
  // first layer's MLP backward), then ln_final's and the pooling's backward
  PPT_TRY(launch_kernel(PDL<T>, proj_bwd_kernel, dim3(B, (D + 31) / 32), 256, 0, st, g,
                        (const float*)w[14], D, E, dy));
  PPT_TRY(launch_kernel(PDL<T>, epilogue_bwd_kernel<T>, B, 256,
                        sizeof(float) * (2 * (size_t)D + 64), st, dy,
                        xs + (size_t)(depth - 1) * RD, eot, L, D, (const float*)w[12], d2, dT));

  for (int i = depth - 1; i >= 0; --i) {
    const LayerW<T> lw = layer_at<T>(w, i, D, hid);
    const T* x_in = i == 0 ? x0 : xs + (size_t)(i - 1) * RD;
    // recompute the forward's internals from the saved block input
    PPT_TRY(attn_sublayer<T>(x_in, lw, B, L, D, heads, ROUND_TOWER, s, st));
    PPT_TRY(ln<T>(s.x1, R, D, lw.ln2s, lw.ln2b, s.y, st));
    // MLP backward (c_fc's pre-activation recomputed inside, from s.y)
    PPT_TRY(gelu_grad(dT, lw.wproj, s.y, lw.wfc, lw.bfc, R, hid, D, h1f, dh, st));
    PPT_TRY((gemm<true, EPI_F32>(dh, lw.wfc, R, D, hid, EpiArgs{nullptr, nullptr, nullptr, 0},
                                 dy, st)));
    PPT_TRY(ln_vjp<T>(s.x1, dy, lw.ln2s, d2, R, D, dx1, dT, st));
    // attention backward
    PPT_TRY((gemm<true, EPI_ROUND>(dT, lw.wout, R, D, D, EpiArgs{nullptr, nullptr, nullptr, 0},
                                   dO, st)));
    PPT_TRY(attn_bwd(s.qkv, dO, B, L, D, heads, dqkv, st));
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
