// One pre-norm PointBERT ViT block, the block fused with the trunk's
// readout, and the whole trunk (every block, then the readout), as short
// sequences of hand-written launches:
//   add_ln    x0 = x + pos ; xn = LN1(x0)            (f32 stats, eps 1e-6)
//   gemm      qkv = xn @ wqkv
//   attention whole-row softmax per (batch, head, query tile) (attention.cuh)
//   gemm      x1 = x0 + dp1 * (attn @ wproj + bproj)
//   add_ln    xn = LN2(x1)
//   gemm      h1 = gelu_tanh(xn @ wfc1 + bfc1)
//   gemm      out = x1 + dp2 * (h1 @ wfc2 + bfc2)
//   readout   [LN_f(out[:, 0]), max_{l>=1} LN_f(out[:, l])]   (readout only)
//
// Replaces ppt_tpu/kernels/vitblock.py:fused_vit_block (_block_kernel),
// :fused_vit_block_readout (_block_readout_kernel) and :fused_vit_tower
// (_vit_tower_kernel). The TPU tower keeps x in VMEM across all blocks and
// the ~43 MB of stacked bf16 weights resident; an SM has 228 KB of shared
// memory, so here the tower is the block's launches walked over the depth
// by one C entry point, activations ping-ponging through one workspace:
// its output equals the block chain's bit for bit. A persistent one-launch
// tower is later work.
//
// Bound: operations, ~71 GFLOP per block at B=32, L=513, C=384 against
// ~0.1 GB of activations. Design: in bf16 (the serving dtype) the four
// GEMMs run gemm.cuh's warp-specialised wgmma kernel on TMA-loaded tiles
// (persistent CTAs, W read as it lies as an MN-major operand) and the
// attention attention.cuh's wgmma kernel, f32 accumulators; in f32 both
// run as FMA on the CUDA cores, since TF32 would round the operands. The
// GEMM epilogues carry the bias, GELU and droppath-scaled residual, so
// each sublayer writes its result once. Attention never takes an
// online-softmax rescale, which keeps the TPU kernel's rounding: row max
// over all keys, exp(s - m) rounded to the compute dtype before P@V, the
// f32 accumulator divided by the f32 denominator afterwards
// (vitblock.py:93-106). Fusing the whole block into one persistent kernel
// is later work.
//
// Rounding follows _block_body (vitblock.py:81-125): qkv, attn, y, y2,
// h1 and each residual sum are rounded to the compute dtype T at the same
// points.
#include "attention.cuh"
#include "gemm.cuh"

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

// The probe's form of the same launch: grid (ceil(L / 8), B / R), each warp
// one token row in each of the block's R clouds; without LN only
// x0 = x + pos is written (mode mm_only).
template <typename T, bool LN, int R>
__global__ void add_ln_rows_kernel(const T* __restrict__ x, const T* __restrict__ pos, int L,
                                   int C, const float* __restrict__ s,
                                   const float* __restrict__ b, T* __restrict__ x0_out,
                                   T* __restrict__ xn_out) {
  const int l = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (l >= L) return;
  for (int i = 0; i < R; ++i) {
    const size_t o = ((size_t)(blockIdx.y * R + i) * L + l) * C;
    if constexpr (LN) {
      add_ln_row<T>(x + o, pos ? pos + o : nullptr, C, s, b, LN_EPS,
                    x0_out ? x0_out + o : nullptr, xn_out + o);
    } else {
      for (int c = threadIdx.x & 31; c < C; c += 32)
        x0_out[o + c] = from_f<T>(rnd<T>(__fadd_rn(to_f(x[o + c]), to_f(pos[o + c]))));
    }
  }
}

// ---------------------------------------------------------------------------
// GEMM out[M,N] = A[M,K] @ W[K,N] with an epilogue
// ---------------------------------------------------------------------------
enum { EPI_ROUND = 0, EPI_BIAS_RES = 1, EPI_BIAS_GELU = 2, EPI_BIAS = 3 };

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  const float inner = __fmul_rn(c, __fadd_rn(x, __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

// EPI_ROUND:     out = T(acc)
// EPI_BIAS_RES:  y = T(T(acc) + T(bias)); out = T(res + T(y * T(dp[row / L, dp_col])))
// EPI_BIAS_GELU: out = T(gelu_tanh(acc + bias))      (bias added in f32)
// EPI_BIAS:      out = T(acc + bias)                 (the probe's GELU-less fc1)
// As the functor the GEMM main loops call, with what depends on the row
// alone (the DropPath scale) or the column alone (the bias) taken once:
// one element at a time (the f32 body, which stores it), or the value
// alone (the wgmma body, which stores through shared memory and reads the
// residual there, RES).
template <typename T, int EPI>
struct Epilogue {
  static constexpr bool RES = EPI == EPI_BIAS_RES;
  static constexpr bool OUT32 = false, DUAL = false;  // bf16 results of one product
  int N;
  const float* bias;
  const T* res;
  const float* dp;
  int dp_col, L;
  T* out;
  // row r's factor: EPI_BIAS_RES the DropPath scale of its sample, in T
  __device__ __forceinline__ float row(int r) const {
    return RES ? rnd<T>(dp[(r / L) * 2 + dp_col]) : 0.f;
  }
  // column c's bias as the epilogue adds it (EPI_BIAS_RES: in T)
  __device__ __forceinline__ float col(int c) const {
    return EPI == EPI_ROUND ? 0.f : RES ? rnd<T>(bias[c]) : bias[c];
  }
  // the value before the final rounding to T; rv, cv from row() and col(),
  // res_v the residual element (EPI_BIAS_RES)
  __device__ __forceinline__ float value(float acc, float rv, float cv, float res_v) const {
    if (EPI == EPI_ROUND) return acc;
    if (RES) {
      const float y = rnd<T>(__fadd_rn(rnd<T>(acc), cv));
      return __fadd_rn(res_v, rnd<T>(__fmul_rn(y, rv)));
    }
    if (EPI == EPI_BIAS_GELU) return gelu_tanh(__fadd_rn(acc, cv));
    return __fadd_rn(acc, cv);
  }
  __device__ __forceinline__ void operator()(float acc, int r, int c) const {
    const size_t o = (size_t)r * N + c;
    out[o] = from_f<T>(value(acc, row(r), col(c), RES ? to_f(res[o]) : 0.f));
  }
};

// f32 on the CUDA cores (common.cuh)
template <int EPI>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W, int M, int N, int K,
                const float* __restrict__ bias, const float* __restrict__ res,
                const float* __restrict__ dp, int dp_col, int L, float* __restrict__ out) {
  gemm_f32_body<false>(A, W, M, N, K, Epilogue<float, EPI>{N, bias, res, dp, dp_col, L, out});
}

// bf16 on Hopper (gemm.cuh): persistent CTAs walking 128 x 128 tiles
template <int EPI>
__global__ void __launch_bounds__(384, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap tr,
                  int M, int N, int K, const float* __restrict__ bias,
                  const float* __restrict__ dp, int dp_col, int L) {
  gemm_wgmma_body<GM_BN, false>(&ta, &tw, &tc, &tr, M, N, K,
                                Epilogue<bf16, EPI>{N, bias, nullptr, dp, dp_col, L, nullptr});
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

// maps: A [M, K], W [K, N], out [M, N] and (EPI_BIAS_RES) the residual
template <int EPI>
static int gemm(const bf16* A, const bf16* W, int M, int N, int K, const float* bias,
                const bf16* res, const float* dp, int dp_col, int L, bf16* out,
                cudaStream_t st) {
  if (K % 8 || N % 8) return (int)cudaErrorInvalidValue;  // TMA rows: multiples of 16 bytes
  auto kernel = gemm_wgmma_kernel<EPI>;
  static const int pool = check_reg_pool(kernel, RegSplit<3, 1>::NEED);
  if (pool) return pool;
  CUtensorMap maps[4];
  int rc = mat_map(&maps[0], A, M, K, GM_BM);
  if (!rc) rc = mat_map(&maps[1], W, K, N, GM_BK);
  if (!rc) rc = mat_map(&maps[2], out, M, N, GM_BM);
  if (!rc) rc = mat_map(&maps[3], EPI == EPI_BIAS_RES ? res : out, M, N, GM_BM);
  if (rc) return rc;
  const int tiles = ((M + GM_BM - 1) / GM_BM) * ((N + GM_BN - 1) / GM_BN), sms = sm_count();
  constexpr int smem = GemmTile<GM_BN>::SMEM;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<tiles < sms ? tiles : sms, 384, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], M, N, K, bias, dp, dp_col, L);
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
  const int D = C / heads;
  PPT_TRY(whole_row_attention(qkv, qkv + C, qkv + 2 * C, B, L, heads, D, (long long)L * 3 * C,
                              3 * C, D, attn, st));
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

// ---------------------------------------------------------------------------
// The ViT-block ablation probe (ppt_torch/tools/vitblock_probe.py): the
// block's launch sequence above with one component taken out or replaced,
// so that each mode prices that component inside the production code.
// Replaces ppt_tpu/tools/vitblock_probe.py:_variant_pallas (its kernel
// _variant_kernel). Modes, as the TPU probe names them:
//   full        the production sequence, block() itself (rows 1)
//   mm_only     no LN1/LN2 (x0 and x1 feed the GEMMs), raw-score attention
//               (ATT_RAW), no GELU
//   no_softmax  ATT_RAW attention; LayerNorms and GELU kept
//   no_gelu     GELU is the identity in the fc1 epilogue
//   pv_ones     ATT_PV_ONES: the denominator from a ones column of V
//   qk_packed2  ATT_PACKED2: two heads per block-diagonal product
// rows = 2: each block of the attention and LayerNorm launches takes two
// clouds' tiles in turn (the TPU probe's two clouds per grid instance).
// Every mode runs the production GEMMs (gemm.cuh). In bf16, full,
// no_gelu, mm_only, no_softmax and rows = 2 run the production attention
// kernel (wgmma and TMA); pv_ones and qk_packed2 run the probe's own
// mma.sync attention kernel (attention.cuh), so their deltas against full
// also price the change of kernel.
// ---------------------------------------------------------------------------
enum { VAR_FULL = 0, VAR_MM_ONLY = 1, VAR_NO_SOFTMAX = 2, VAR_NO_GELU = 3, VAR_PV_ONES = 4,
       VAR_QK_PACKED2 = 5 };

template <typename T, bool LN, int R>
static int add_ln_rows(const T* x, const T* pos, int B, int L, int C, const float* s,
                       const float* b, T* x0, T* xn, cudaStream_t st) {
  if (R == 1 && LN) return add_ln<T>(x, pos, B * L, C, s, b, x0, xn, st);
  add_ln_rows_kernel<T, LN, R><<<dim3((L + 7) / 8, B / R), 256, 0, st>>>(x, pos, L, C, s, b,
                                                                          x0, xn);
  PPT_CHECK_LAUNCH();
  return 0;
}

template <typename T, int MODE, int R>
static int variant(const T* x, const T* pos, const float* dp, int B, int L, int C, int heads,
                   int hid, const float* ln1s, const float* ln1b, const T* wqkv,
                   const T* wproj, const float* bproj, const float* ln2s, const float* ln2b,
                   const T* wfc1, const float* bfc1, const T* wfc2, const float* bfc2, T* x0,
                   T* xn, T* qkv, T* attn, T* x1, T* h1, T* out, cudaStream_t st) {
  constexpr bool LN = MODE != VAR_MM_ONLY;
  constexpr bool GELU = MODE != VAR_MM_ONLY && MODE != VAR_NO_GELU;
  constexpr int ATT = MODE == VAR_MM_ONLY || MODE == VAR_NO_SOFTMAX ? ATT_RAW
                      : MODE == VAR_PV_ONES                         ? ATT_PV_ONES
                      : MODE == VAR_QK_PACKED2                      ? ATT_PACKED2
                                                                    : ATT_SOFTMAX;
  if (B % R) return (int)cudaErrorInvalidValue;
  const int rows = B * L, D = C / heads;
  PPT_TRY((add_ln_rows<T, LN, R>(x, pos, B, L, C, ln1s, ln1b, x0, xn, st)));
  PPT_TRY(gemm<EPI_ROUND>(LN ? xn : x0, wqkv, rows, 3 * C, C, nullptr, nullptr, nullptr, 0, L,
                          qkv, st));
  PPT_TRY((attention_variant<ATT, R>(qkv, qkv + C, qkv + 2 * C, B, L, heads, D,
                                     (long long)L * 3 * C, 3 * C, D, attn, st)));
  PPT_TRY(gemm<EPI_BIAS_RES>(attn, wproj, rows, C, C, bproj, x0, dp, 0, L, x1, st));
  if (LN) PPT_TRY((add_ln_rows<T, true, R>(x1, nullptr, B, L, C, ln2s, ln2b, nullptr, xn, st)));
  PPT_TRY(gemm<GELU ? EPI_BIAS_GELU : EPI_BIAS>(LN ? xn : x1, wfc1, rows, hid, C, bfc1, nullptr,
                                                nullptr, 0, L, h1, st));
  PPT_TRY(gemm<EPI_BIAS_RES>(h1, wfc2, rows, C, hid, bfc2, x1, dp, 1, L, out, st));
  return 0;
}

template <typename T, int R>
static int variant_mode(int mode, const T* x, const T* pos, const float* dp, int B, int L, int C,
                        int heads, int hid, const float* ln1s, const float* ln1b, const T* wqkv,
                        const T* wproj, const float* bproj, const float* ln2s,
                        const float* ln2b, const T* wfc1, const float* bfc1, const T* wfc2,
                        const float* bfc2, T* x0, T* xn, T* qkv, T* attn, T* x1, T* h1, T* out,
                        cudaStream_t st) {
#define PPT_VARIANT(M)                                                                       \
  variant<T, M, R>(x, pos, dp, B, L, C, heads, hid, ln1s, ln1b, wqkv, wproj, bproj, ln2s,   \
                   ln2b, wfc1, bfc1, wfc2, bfc2, x0, xn, qkv, attn, x1, h1, out, st)
  switch (mode) {
    case VAR_FULL:
      if (R == 1)
        return block<T>(x, pos, dp, B, L, C, heads, hid, ln1s, ln1b, wqkv, wproj, bproj, ln2s,
                        ln2b, wfc1, bfc1, wfc2, bfc2, nullptr, nullptr, x0, xn, qkv, attn, x1,
                        h1, out, nullptr, st);
      return PPT_VARIANT(VAR_FULL);
    case VAR_MM_ONLY: return PPT_VARIANT(VAR_MM_ONLY);
    case VAR_NO_SOFTMAX: return PPT_VARIANT(VAR_NO_SOFTMAX);
    case VAR_NO_GELU: return PPT_VARIANT(VAR_NO_GELU);
    case VAR_PV_ONES: return PPT_VARIANT(VAR_PV_ONES);
    case VAR_QK_PACKED2: return PPT_VARIANT(VAR_QK_PACKED2);
  }
#undef PPT_VARIANT
  return (int)cudaErrorInvalidValue;
}

PPT_EXPORT int ppt_vit_variant(int dtype, int mode, int rows, const void* x, const void* pos,
                               const void* dp, int B, int L, int C, int heads, int hid,
                               const void* ln1s, const void* ln1b, const void* wqkv,
                               const void* wproj, const void* bproj, const void* ln2s,
                               const void* ln2b, const void* wfc1, const void* bfc1,
                               const void* wfc2, const void* bfc2, void* x0, void* xn, void* qkv,
                               void* attn, void* x1, void* h1, void* out, void* stream) {
#define PPT_VARIANT_ARGS(T)                                                                  \
  mode, (const T*)x, (const T*)pos, (const float*)dp, B, L, C, heads, hid,                  \
      (const float*)ln1s, (const float*)ln1b, (const T*)wqkv, (const T*)wproj,              \
      (const float*)bproj, (const float*)ln2s, (const float*)ln2b, (const T*)wfc1,          \
      (const float*)bfc1, (const T*)wfc2, (const float*)bfc2, (T*)x0, (T*)xn, (T*)qkv,      \
      (T*)attn, (T*)x1, (T*)h1, (T*)out, (cudaStream_t)stream
  if (rows != 1 && rows != 2) return (int)cudaErrorInvalidValue;
  if (dtype == PPT_BF16)
    return rows == 1 ? variant_mode<bf16, 1>(PPT_VARIANT_ARGS(bf16))
                     : variant_mode<bf16, 2>(PPT_VARIANT_ARGS(bf16));
  return rows == 1 ? variant_mode<float, 1>(PPT_VARIANT_ARGS(float))
                   : variant_mode<float, 2>(PPT_VARIANT_ARGS(float));
#undef PPT_VARIANT_ARGS
}

// The whole trunk: `depth` blocks, then the readout into `ro` [B, 8, C] f32.
// Stacked weights lead with the depth axis; dp is [depth, B, 2] f32. The
// workspace holds rows x (6C + 3C + hid) elements of T: the block's six
// intermediates plus two activation buffers the blocks ping-pong through.
template <typename T>
static int tower(const T* x, const T* pos, const float* dp, int B, int L, int C, int heads,
                 int hid, int depth, const float* ln1s, const float* ln1b, const T* wqkv,
                 const T* wproj, const float* bproj, const float* ln2s, const float* ln2b,
                 const T* wfc1, const float* bfc1, const T* wfc2, const float* bfc2,
                 const float* lnfs, const float* lnfb, T* ws, float* ro, cudaStream_t st) {
  const size_t rows = (size_t)B * L;
  T* x0 = ws;
  T* xn = x0 + rows * C;
  T* qkv = xn + rows * C;
  T* attn = qkv + rows * 3 * C;
  T* x1 = attn + rows * C;
  T* h1 = x1 + rows * C;
  T* act[2] = {h1 + rows * hid, h1 + rows * hid + rows * C};
  const T* cur = x;
  for (int i = 0; i < depth; ++i) {
    const size_t c = (size_t)i * C;
    T* out = act[i & 1];
    PPT_TRY(block<T>(cur, pos, dp + (size_t)i * B * 2, B, L, C, heads, hid, ln1s + c, ln1b + c,
                     wqkv + c * 3 * C, wproj + c * C, bproj + c, ln2s + c, ln2b + c,
                     wfc1 + c * hid, bfc1 + (size_t)i * hid, wfc2 + (size_t)i * hid * C,
                     bfc2 + c, lnfs, lnfb, x0, xn, qkv, attn, x1, h1, out,
                     i == depth - 1 ? ro : nullptr, st));
    cur = out;
  }
  return 0;
}

PPT_EXPORT int ppt_vit_tower(int dtype, const void* x, const void* pos, const void* dp, int B,
                             int L, int C, int heads, int hid, int depth, const void* ln1s,
                             const void* ln1b, const void* wqkv, const void* wproj,
                             const void* bproj, const void* ln2s, const void* ln2b,
                             const void* wfc1, const void* bfc1, const void* wfc2,
                             const void* bfc2, const void* lnfs, const void* lnfb, void* ws,
                             void* ro, void* stream) {
#define PPT_TOWER_ARGS(T)                                                                    \
  (const T*)x, (const T*)pos, (const float*)dp, B, L, C, heads, hid, depth,                 \
      (const float*)ln1s, (const float*)ln1b, (const T*)wqkv, (const T*)wproj,              \
      (const float*)bproj, (const float*)ln2s, (const float*)ln2b, (const T*)wfc1,          \
      (const float*)bfc1, (const T*)wfc2, (const float*)bfc2, (const float*)lnfs,           \
      (const float*)lnfb, (T*)ws, (float*)ro, (cudaStream_t)stream
  if (depth < 1) return (int)cudaErrorInvalidValue;
  if (dtype == PPT_BF16) return tower<bf16>(PPT_TOWER_ARGS(bf16));
  return tower<float>(PPT_TOWER_ARGS(float));
#undef PPT_TOWER_ARGS
}
