// MiniPointNet group encoder with both BatchNorms folded into the
// weights (eval mode):
//   x1 = relu(x @ fw1 + fb1)                      [M, C1]
//   x2 = x1 @ w2 + b2 ; g = max_M x2              [M, C2], [C2]
//   h  = relu(x2 @ fwl + g @ fwg + fbs)           [M, H]
//   y  = h @ w3 + b3 ; out = max_M y              [CO]
// per group of M <= 32 points; only out [B*G, CO] is written.
//
// Replaces ppt_tpu/kernels/mini.py:mini_forward (_forward_kernel).
//
// Bound: operations. ~3.1e11 FLOP per batch at B=32, G=512, M=32
// against ~10 MB of input and output. Design: in bf16 (the serving
// dtype) the four products run on the tensor cores, 4 groups per block
// (mini_forward_bf16_kernel below). In f32 (plain FMA on the CUDA cores,
// since TF32 would round the operands): one block per group, the stage
// activations (x1, x2, a 256-column chunk of h) in shared memory, each
// thread owning one output column for all M rows (32 independent f32
// accumulators, weights read once per k from L2, activations as
// broadcast float4 loads). In both, h never leaves the SM: each chunk is
// folded into the y accumulators right away.
//
// Rounding: as _forward_kernel (mini.py:97-107, :158-175), every dot
// product accumulates in f32; in bf16 it is rounded to bf16, then the
// bias (in bf16) is added and rounded again. The f32 kernel rounds nowhere.
#include "common.cuh"

PPT_ERROR_STRING_FN

constexpr int MAXM = 32;
constexpr int THREADS = 256;

// acc[r] = sum_k A[r*lda + k] * W[k*ldw + col] over r < MAXM (K % 4 == 0)
__device__ __forceinline__ void col_dot(const float* __restrict__ A, int lda, int K,
                                        const float* __restrict__ W, int ldw, int col,
                                        float (&acc)[MAXM]) {
#pragma unroll
  for (int r = 0; r < MAXM; ++r) acc[r] = 0.f;
  for (int k = 0; k < K; k += 4) {
    const float w0 = W[(size_t)(k + 0) * ldw + col];
    const float w1 = W[(size_t)(k + 1) * ldw + col];
    const float w2 = W[(size_t)(k + 2) * ldw + col];
    const float w3 = W[(size_t)(k + 3) * ldw + col];
#pragma unroll
    for (int r = 0; r < MAXM; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(A + r * lda + k);
      float s = acc[r];
      s = fmaf(a.x, w0, s);
      s = fmaf(a.y, w1, s);
      s = fmaf(a.z, w2, s);
      s = fmaf(a.w, w3, s);
      acc[r] = s;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
mini_forward_kernel(const float* __restrict__ x, int M, int C1, int C2, int H, int CO,
                    const float* __restrict__ fw1, const float* __restrict__ fb1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ fwg, const float* __restrict__ fwl,
                    const float* __restrict__ fbs, const float* __restrict__ w3,
                    const float* __restrict__ b3, float* __restrict__ out) {
  extern __shared__ float sm[];
  float* x1 = sm;                 // [MAXM][C1]
  float* x2 = x1 + MAXM * C1;     // [MAXM][C2]
  float* hc = x2 + MAXM * C2;     // [MAXM][THREADS]
  float* g = hc + MAXM * THREADS; // [C2]
  float* gh = g + C2;             // [H]
  float* xin = gh + H;            // [MAXM][3]

  const int tid = threadIdx.x;
  const size_t grp = blockIdx.x;
  const float* xg = x + grp * M * 3;
  for (int e = tid; e < MAXM * 3; e += THREADS)
    xin[e] = e < M * 3 ? xg[e] : 0.f;
  __syncthreads();

  // stage 1: K = 3
  for (int c = tid; c < C1; c += THREADS) {
    const float wa = fw1[c], wb = fw1[C1 + c], wc = fw1[2 * C1 + c];
    const float bias = fb1[c];
    for (int r = 0; r < MAXM; ++r) {
      float s = xin[3 * r] * wa;
      s = fmaf(xin[3 * r + 1], wb, s);
      s = fmaf(xin[3 * r + 2], wc, s);
      x1[r * C1 + c] = fmaxf(s + bias, 0.f);
    }
  }
  __syncthreads();

  float acc[MAXM];
  // stage 2 and the first max over the group's points
  for (int c = tid; c < C2; c += THREADS) {
    col_dot(x1, C1, C1, w2, C2, c, acc);
    const float bias = b2[c];
    float m = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAXM; ++r) {
      const float v = acc[r] + bias;
      x2[r * C2 + c] = v;
      if (r < M) m = fmaxf(m, v);
    }
    g[c] = m;
  }
  __syncthreads();

  // global half of the split dense: gh = g @ fwg (one row)
  for (int c = tid; c < H; c += THREADS) {
    float s = 0.f;
    for (int k = 0; k < C2; ++k) s = fmaf(g[k], fwg[(size_t)k * H + c], s);
    gh[c] = s;
  }
  __syncthreads();

  float yacc[MAXM];
#pragma unroll
  for (int r = 0; r < MAXM; ++r) yacc[r] = 0.f;
  for (int h0 = 0; h0 < H; h0 += THREADS) {
    const int c = h0 + tid;
    if (c < H) {
      col_dot(x2, C2, C2, fwl, H, c, acc);
      const float ghc = gh[c], bias = fbs[c];
#pragma unroll
      for (int r = 0; r < MAXM; ++r)
        hc[r * THREADS + tid] = fmaxf(acc[r] + ghc + bias, 0.f);
    } else {
#pragma unroll
      for (int r = 0; r < MAXM; ++r) hc[r * THREADS + tid] = 0.f;
    }
    __syncthreads();
    if (tid < CO) {
      const int kn = min(THREADS, H - h0);  // a multiple of 4
      for (int k = 0; k < kn; k += 4) {
        const float wa = w3[(size_t)(h0 + k) * CO + tid];
        const float wb = w3[(size_t)(h0 + k + 1) * CO + tid];
        const float wc = w3[(size_t)(h0 + k + 2) * CO + tid];
        const float wd = w3[(size_t)(h0 + k + 3) * CO + tid];
#pragma unroll
        for (int r = 0; r < MAXM; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(hc + r * THREADS + k);
          float s = yacc[r];
          s = fmaf(a.x, wa, s);
          s = fmaf(a.y, wb, s);
          s = fmaf(a.z, wc, s);
          s = fmaf(a.w, wd, s);
          yacc[r] = s;
        }
      }
    }
    __syncthreads();
  }

  if (tid < CO) {
    const float bias = b3[tid];
    float m = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAXM; ++r)
      if (r < M) m = fmaxf(m, yacc[r] + bias);
    out[grp * CO + tid] = m;
  }
}

// ---------------------------------------------------------------------------
// bf16: the same chain on the tensor cores (mma.sync, f32 accumulators) for
// PointBERT's widths. One block of 8 warps takes 4 groups x 32 rows (a
// group of M < 32 points is padded and its padding rows are left out of
// the maxes). x1, x2 and a 64-column chunk of h stay in shared memory as
// bf16; the weights stream through a double-buffered shared tile (32 k-rows
// at a time, cp.async); y's 128 x 256 accumulators stay in registers across
// the h chunks, so h never exists whole and only out is written.
// ---------------------------------------------------------------------------
namespace tc {
constexpr int GPB = 4, R = GPB * MAXM;                   // groups, rows per block
constexpr int C1 = 128, C2 = 256, H = 512, CO = 256, HC = 64;  // widths, h chunk
constexpr int X1_LD = C1 + 8, X2_LD = C2 + 8, HC_LD = HC + 8, WS_LD = 256 + 8;
constexpr int KT = 32;  // k-rows per staged weight tile
constexpr size_t SMEM = sizeof(bf16) * ((size_t)R * X2_LD + (size_t)R * X1_LD +
                                        2 * KT * WS_LD + 16 * X2_LD) +
                        sizeof(float) * (GPB * H + R * 3);

// acc[mt][nt] += A[a_row0 + 16 mt .., 0:K) @ W[0:K, n_base + w_col0 + 8 nt ..]
// A is bf16 in shared memory (row stride lda); W is bf16 in global memory
// (row stride ldw), staged NW columns from n_base at a time through ws.
// Every thread of the block calls it (it holds the block's barriers).
template <int MT, int NT>
__device__ __forceinline__ void block_mma(float (&acc)[MT][NT][4], const bf16* As, int lda,
                                          int a_row0, const bf16* __restrict__ W, int ldw,
                                          int n_base, int NW, int K, int w_col0, bf16* ws) {
  const int tid = threadIdx.x, lane = tid & 31;
  auto stage = [&](int buf, int k0) {
    const int chunks = NW / 8;
    for (int e = tid; e < KT * chunks; e += THREADS) {
      const int kr = e / chunks, nc = (e % chunks) * 8;
      cp_async16(ws + (buf * KT + kr) * WS_LD + nc, W + (size_t)(k0 + kr) * ldw + n_base + nc,
                 true);
    }
    cp_async_commit();
  };
  __syncthreads();  // earlier readers of ws (and of the caller's outputs) are done
  stage(0, 0);
  const int nk = K / KT;
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      stage((kt + 1) & 1, (kt + 1) * KT);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* wsb = ws + (kt & 1) * KT * WS_LD;
#pragma unroll
    for (int ks = 0; ks < KT; ks += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], As + (a_row0 + mt * 16 + (lane & 15)) * lda + kt * KT + ks +
                               (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, wsb + (ks + ((lane >> 3) & 1) * 8 + (lane & 7)) * WS_LD + w_col0 +
                                 p * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * p], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * p + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

__device__ __forceinline__ float bf(const bf16* p, int i) { return __bfloat162float(p[i]); }

__global__ void __launch_bounds__(THREADS, 1)
mini_forward_bf16_kernel(const float* __restrict__ x, int n_groups, int M,
                         const bf16* __restrict__ fw1, const bf16* __restrict__ fb1,
                         const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                         const bf16* __restrict__ fwg, const bf16* __restrict__ fwl,
                         const bf16* __restrict__ fbs, const bf16* __restrict__ w3,
                         const bf16* __restrict__ b3, bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* x2s = reinterpret_cast<bf16*>(smraw);  // [R][X2_LD]
  bf16* x1s = x2s + R * X2_LD;                 // [R][X1_LD]; later the h chunk [R][HC_LD]
  bf16* hcs = x1s;
  bf16* ws = x1s + R * X1_LD;                  // [2][KT][WS_LD]
  bf16* gA = ws + 2 * KT * WS_LD;              // [16][X2_LD]: rows 0..3 the group maxes
  float* gh = reinterpret_cast<float*>(gA + 16 * X2_LD);  // [GPB][H]
  float* xin = gh + GPB * H;                               // [R][3]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // warp wm's 32 rows are group wm
  const int g0 = blockIdx.x * GPB;

  for (int e = tid; e < R * 3; e += THREADS) {
    const int row = e / 3, grp = g0 + row / MAXM, r = row % MAXM;
    xin[e] = (grp < n_groups && r < M) ? rnd<bf16>(x[((size_t)grp * M + r) * 3 + e % 3]) : 0.f;
  }
  for (int e = tid; e < 16 * X2_LD; e += THREADS) gA[e] = __float2bfloat16_rn(0.f);
  __syncthreads();

  // x1 = relu(T(T(x @ fw1) + fb1))
  for (int e = tid; e < R * C1; e += THREADS) {
    const int row = e / C1, c = e % C1;
    float s = __fmul_rn(xin[3 * row], bf(fw1, c));
    s = fmaf(xin[3 * row + 1], bf(fw1, C1 + c), s);
    s = fmaf(xin[3 * row + 2], bf(fw1, 2 * C1 + c), s);
    x1s[row * X1_LD + c] = __float2bfloat16_rn(fmaxf(rnd<bf16>(rnd<bf16>(s) + bf(fb1, c)), 0.f));
  }

  // x2 = T(T(x1 @ w2) + b2), two 128-column halves
  for (int nb = 0; nb < C2; nb += 128) {
    float acc[2][8][4];
    zero(acc);
    block_mma(acc, x1s, X1_LD, wm * 32, w2, C2, nb, 128, C1, wn * 64, ws);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = wm * 32 + mt * 16 + (lane >> 2) + (e >> 1) * 8;
          const int c = nb + wn * 64 + nt * 8 + (lane & 3) * 2 + (e & 1);
          x2s[row * X2_LD + c] = __float2bfloat16_rn(rnd<bf16>(acc[mt][nt][e]) + bf(b2, c));
        }
  }
  __syncthreads();

  // g = max over each group's valid rows -> rows 0..3 of gA
  for (int e = tid; e < GPB * C2; e += THREADS) {
    const int grp = e / C2, c = e % C2;
    float m = -INFINITY;
    for (int r = 0; r < M; ++r) m = fmaxf(m, __bfloat162float(x2s[(grp * MAXM + r) * X2_LD + c]));
    gA[grp * X2_LD + c] = __float2bfloat16_rn(m);
  }

  // gh = T(g @ fwg): a 16-row tile whose rows 4..15 are zero
  for (int nb = 0; nb < H; nb += 256) {
    float acc[1][4][4];
    zero(acc);
    block_mma(acc, gA, X2_LD, 0, fwg, H, nb, 256, C2, warp * 32, ws);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int grp = (lane >> 2) + (e >> 1) * 8;
        if (grp < GPB)
          gh[grp * H + nb + warp * 32 + nt * 8 + (lane & 3) * 2 + (e & 1)] =
              rnd<bf16>(acc[0][nt][e]);
      }
  }

  // h chunk by chunk; y = h @ w3 accumulates in registers
  float y[2][16][4];
  zero(y);
  for (int hb = 0; hb < H; hb += HC) {
    float acc[2][4][4];
    zero(acc);
    block_mma(acc, x2s, X2_LD, wm * 32, fwl, H, hb, HC, C2, wn * 32, ws);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = wm * 32 + mt * 16 + (lane >> 2) + (e >> 1) * 8;
          const int cl = wn * 32 + nt * 8 + (lane & 3) * 2 + (e & 1), c = hb + cl;
          const float v = rnd<bf16>(rnd<bf16>(rnd<bf16>(acc[mt][nt][e]) + gh[wm * H + c]) +
                                    bf(fbs, c));
          hcs[row * HC_LD + cl] = __float2bfloat16_rn(fmaxf(v, 0.f));
        }
    block_mma(y, hcs, HC_LD, wm * 32, w3 + (size_t)hb * CO, CO, 0, CO, HC, wn * 128, ws);
  }

  // out = max over the group's valid rows of T(T(y) + b3)
  const int grp = g0 + wm;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = wn * 128 + nt * 8 + (lane & 3) * 2 + j;
      const float bias = bf(b3, c);
      float m = -INFINITY;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = mt * 16 + (lane >> 2) + hi * 8;
          if (r < M) m = fmaxf(m, rnd<bf16>(rnd<bf16>(y[mt][nt][hi * 2 + j]) + bias));
        }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane < 4 && grp < n_groups) out[(size_t)grp * CO + c] = __float2bfloat16_rn(m);
    }
}
}  // namespace tc

static int launch_f32(const void* x, int n_groups, int M, int C1, int C2, int H, int CO,
                      const void* fw1, const void* fb1, const void* w2, const void* b2,
                      const void* fwg, const void* fwl, const void* fbs, const void* w3,
                      const void* b3, void* out, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)MAXM * (C1 + C2 + THREADS + 3) + C2 + H);
  cudaFuncSetAttribute(mini_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  mini_forward_kernel<<<n_groups, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, M, C1, C2, H, CO, (const float*)fw1, (const float*)fb1,
      (const float*)w2, (const float*)b2, (const float*)fwg, (const float*)fwl,
      (const float*)fbs, (const float*)w3, (const float*)b3, (float*)out);
  PPT_CHECK_LAUNCH();
  return 0;
}

PPT_EXPORT int ppt_mini_forward(int dtype, const void* x, int n_groups, int M, int C1, int C2,
                                int H, int CO, const void* fw1, const void* fb1,
                                const void* w2, const void* b2, const void* fwg,
                                const void* fwl, const void* fbs, const void* w3,
                                const void* b3, void* out, void* stream) {
  if (dtype == PPT_BF16) {
    if (C1 != tc::C1 || C2 != tc::C2 || H != tc::H || CO != tc::CO)
      return (int)cudaErrorInvalidValue;
    cudaFuncSetAttribute(tc::mini_forward_bf16_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tc::SMEM);
    tc::mini_forward_bf16_kernel<<<(n_groups + tc::GPB - 1) / tc::GPB, THREADS, tc::SMEM,
                                   (cudaStream_t)stream>>>(
        (const float*)x, n_groups, M, (const bf16*)fw1, (const bf16*)fb1, (const bf16*)w2,
        (const bf16*)b2, (const bf16*)fwg, (const bf16*)fwl, (const bf16*)fbs,
        (const bf16*)w3, (const bf16*)b3, (bf16*)out);
    PPT_CHECK_LAUNCH();
    return 0;
  }
  return launch_f32(x, n_groups, M, C1, C2, H, CO, fw1, fb1, w2, b2, fwg, fwl, fbs, w3, b3,
                    out, stream);
}
