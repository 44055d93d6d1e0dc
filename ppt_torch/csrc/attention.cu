// Standalone multi-head attention for the unfused ViT block, [B, L, H, D]
// in and out (layout and strides as in attention.cuh):
//   ppt_mha        whole-row attention (attention.cuh), the block's own
//                  kernels. Replaces ppt_tpu/kernels/attention.py:fused_mha
//                  (_mha_kernel via _mha_pallas), used below L = 1024.
//   ppt_flash_mha  single-pass flash attention with an online softmax.
//                  Replaces the forward of :flash_mha, the stock TPU flash
//                  kernel that every route takes from L = 1024 on.
//
// Bound. fused_mha at the PPT-Base shape [32, 513, 6, 64] bf16: 12.9
// GFLOP against 50 MB moved, bytes (0.015 ms); flash_mha at the long
// trunk's [32, 1025, 6, 64]: 51.6 GFLOP against 101 MB, operations
// (0.052 ms). Neither score matrix ever reaches device memory.
//
// Flash design (bf16): one CTA of 4 warps per (batch, head, 64-query
// tile), each warp 16 query rows held as mma.sync A fragments; K and V
// tiles of 64 keys staged in shared memory by cp.async, double-buffered,
// keys >= L zero-filled. Per tile: S = Q K^T on mma.sync into f32, scaled,
// keys >= L masked to -inf; the running row
// max and sum in f32, the accumulator rescaled by exp(m_old - m_new); P =
// exp(s - m) rounded to bf16 from the accumulator registers straight into
// the A fragments of P V; one division by the f32 sum at the end. Query
// rows >= L are computed on zeros and never written. The TPU version pads
// L to 512 and masks with segment ids; only the valid rows' semantics
// carry over: no padding tensor, no segment-id array. Deterministic: every
// sum runs in a fixed order, no atomics. f32 runs the same online softmax
// as FMA on the CUDA cores (32 queries per CTA, scores through shared
// memory). wgmma and TMA are later work.
#include "attention.cuh"

PPT_ERROR_STRING_FN

constexpr int FL_TK = 64;  // keys per tile

template <int D>
__global__ void __launch_bounds__(128)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, long long sb, long long sl, long long sh, int L,
                  float scale, bf16* __restrict__ out) {
  constexpr int LD = D + 8, KS = D / 16, TILE = FL_TK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [2][64][LD]
  bf16* Vs = Ks + 2 * TILE;                       // [2][64][LD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int q0 = blockIdx.x * 64;
  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int kq = (lane & 3) * 2;
  const size_t off = (size_t)b * sb + (size_t)h * sh;
  const bf16 *qb = q + off, *kb = k + off, *vb = v + off;

  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bf16* q0p = qb + (size_t)r0 * sl + ks * 16 + kq;
    const bf16* q1p = qb + (size_t)r1 * sl + ks * 16 + kq;
    qf[ks][0] = r0 < L ? *reinterpret_cast<const uint32_t*>(q0p) : 0u;
    qf[ks][1] = r1 < L ? *reinterpret_cast<const uint32_t*>(q1p) : 0u;
    qf[ks][2] = r0 < L ? *reinterpret_cast<const uint32_t*>(q0p + 8) : 0u;
    qf[ks][3] = r1 < L ? *reinterpret_cast<const uint32_t*>(q1p + 8) : 0u;
  }

  auto load_tile = [&](int stage, int k0) {  // 64 keys of K and V, zero-filled past L
    for (int e = tid; e < FL_TK * (D / 8); e += 128) {
      const int j = e / (D / 8), c = (e % (D / 8)) * 8;
      const bool ok = k0 + j < L;
      const size_t o = (size_t)(ok ? k0 + j : 0) * sl + c;
      cp_async16(Ks + stage * TILE + j * LD + c, kb + o, ok);
      cp_async16(Vs + stage * TILE + j * LD + c, vb + o, ok);
    }
    cp_async_commit();
  };

  const int n_tiles = (L + FL_TK - 1) / FL_TK;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  load_tile(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile((t + 1) & 1, (t + 1) * FL_TK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks_ = Ks + (t & 1) * TILE;
    const bf16* vs_ = Vs + (t & 1) * TILE;
    const int k0 = t * FL_TK;

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t kf[4];
        ldmatrix_x4(kf, ks_ + (p * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * p], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * p + 1], qf[ks], kf[2], kf[3]);
      }
    float mt0 = m0, mt1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k0 + nt * 8 + kq + (e & 1) < L;
        s[nt][e] = ok ? __fmul_rn(s[nt][e], scale) : -INFINITY;
        if (e < 2) mt0 = fmaxf(mt0, s[nt][e]);
        else mt1 = fmaxf(mt1, s[nt][e]);
      }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {  // the 4 lanes of a row
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, x));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, x));
    }
    // key 0 is in the first tile, so the max is finite from there on and
    // the first correction exp(-inf) is 0
    const float b0 = mt0, b1 = mt1;
    const float c0 = expf(__fsub_rn(m0, b0)), c1 = expf(__fsub_rn(m1, b1));
    m0 = mt0;
    m1 = mt1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= c0;
      o[dt][1] *= c0;
      o[dt][2] *= c1;
      o[dt][3] *= c1;
    }
    uint32_t pf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = expf(__fsub_rn(s[nt][0], b0)), p1 = expf(__fsub_rn(s[nt][1], b0));
      const float p2 = expf(__fsub_rn(s[nt][2], b1)), p3 = expf(__fsub_rn(s[nt][3], b1));
      l0 += p0 + p1;
      l1 += p2 + p3;
      pf[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs_ + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                  p * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * p], pf[ks], vf[0], vf[1]);
        mma_bf16(o[2 * p + 1], pf[ks], vf[2], vf[3]);
      }
    __syncthreads();  // the next load reuses this stage's buffers
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1;
      if (r < L)
        out[((size_t)b * L + r) * H * D + h * D + dt * 8 + kq + (e & 1)] =
            __float2bfloat16_rn(__fdiv_rn(o[dt][e], e < 2 ? l0 : l1));
    }
}

// f32: grid (ceil(L / 32), H, B), 256 threads, D <= 128 and a multiple of 8.
constexpr int FL_TQ = 32;

__global__ void __launch_bounds__(256)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, long long sb, long long sl, long long sh, int L,
                 int D, float scale, float* __restrict__ out) {
  extern __shared__ float sm[];
  float* Qs = sm;                    // [TQ][D]
  float* KV = Qs + FL_TQ * D;        // [TK][D + 1]
  float* S = KV + FL_TK * (D + 1);   // [TQ][TK]
  float* corr = S + FL_TQ * FL_TK;   // [TQ] this tile's rescale
  float* den = corr + FL_TQ;         // [TQ] running sum
  float* mrow = den + FL_TQ;         // [TQ] running max

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * FL_TQ, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int nq = min(FL_TQ, L - q0);
  const size_t off = (size_t)b * sb + (size_t)h * sh;
  const float *qb = q + off, *kb = k + off, *vb = v + off;

  for (int e = tid; e < FL_TQ * D; e += 256) {
    const int r = e / D, d = e % D;
    Qs[e] = r < nq ? qb[(size_t)(q0 + r) * sl + d] : 0.f;
  }
  if (tid < FL_TQ) {
    den[tid] = 0.f;
    mrow[tid] = -INFINITY;
  }
  constexpr int MAXE = FL_TQ * 128 / 256;
  float acc[MAXE];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) acc[e] = 0.f;
  const int nE = (FL_TQ * D) / 256;

  for (int k0 = 0; k0 < L; k0 += FL_TK) {
    const int nk = min(FL_TK, L - k0);
    __syncthreads();
    for (int e = tid; e < FL_TK * D; e += 256) {
      const int j = e / D, d = e % D;
      KV[j * (D + 1) + d] = j < nk ? kb[(size_t)(k0 + j) * sl + d] : 0.f;
    }
    __syncthreads();
    {  // scores, masked to -inf
      const int j = tid & (FL_TK - 1);
      for (int r = tid >> 6; r < nq; r += 4) {
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(Qs[r * D + d], KV[j * (D + 1) + d], s);
        S[r * FL_TK + j] = j < nk ? __fmul_rn(s, scale) : -INFINITY;
      }
    }
    __syncthreads();
    // online softmax, one warp per row: new max, rescale, numerators, sum
    for (int r = warp; r < nq; r += 8) {
      float* row = S + r * FL_TK;
      const float s0 = row[lane], s1 = row[lane + 32];
      const float m_old = mrow[r];
      float mt = fmaxf(m_old, fmaxf(s0, s1));
      for (int x = 16; x; x >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, x));
      const float base = mt;  // finite: key 0 is in the first tile
      const float p0 = expf(__fsub_rn(s0, base)), p1 = expf(__fsub_rn(s1, base));
      row[lane] = p0;
      row[lane + 32] = p1;
      float sum = p0 + p1;
      for (int x = 16; x; x >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, x);
      __syncwarp();
      if (lane == 0) {
        const float c = expf(__fsub_rn(m_old, base));
        corr[r] = c;
        den[r] = den[r] * c + sum;
        mrow[r] = mt;
      }
    }
    __syncthreads();
    for (int e = tid; e < FL_TK * D; e += 256) {
      const int j = e / D, d = e % D;
      KV[j * (D + 1) + d] = j < nk ? vb[(size_t)(k0 + j) * sl + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      if (e < nE) {
        const int idx = tid + 256 * e, r = idx / D, d = idx % D;
        if (r < nq) {
          const float* prow = S + r * FL_TK;
          float a = acc[e] * corr[r];
          for (int j = 0; j < nk; ++j) a = fmaf(prow[j], KV[j * (D + 1) + d], a);
          acc[e] = a;
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    if (e < nE) {
      const int idx = tid + 256 * e, r = idx / D, d = idx % D;
      if (r < nq)
        out[((size_t)b * L + q0 + r) * H * D + h * D + d] = __fdiv_rn(acc[e], den[r]);
    }
  }
}

template <int D>
static int flash_bf16(const bf16* q, const bf16* k, const bf16* v, int B, int L, int H,
                      long long sb, long long sl, long long sh, bf16* out, cudaStream_t st) {
  const size_t smem = 4 * (size_t)FL_TK * (D + 8) * sizeof(bf16);
  cudaFuncSetAttribute(flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((L + 63) / 64, H, B);
  flash_bf16_kernel<D><<<grid, 128, smem, st>>>(q, k, v, sb, sl, sh, L, attn_scale(D), out);
  PPT_CHECK_LAUNCH();
  return 0;
}

PPT_EXPORT int ppt_mha(int dtype, const void* q, const void* k, const void* v, int B, int L,
                       int H, int D, long long sb, long long sl, long long sh, void* out,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == PPT_BF16)
    return whole_row_attention((const bf16*)q, (const bf16*)k, (const bf16*)v, B, L, H, D, sb,
                               sl, sh, (bf16*)out, st);
  return whole_row_attention((const float*)q, (const float*)k, (const float*)v, B, L, H, D, sb,
                             sl, sh, (float*)out, st);
}

PPT_EXPORT int ppt_flash_mha(int dtype, const void* q, const void* k, const void* v, int B,
                             int L, int H, int D, long long sb, long long sl, long long sh,
                             void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == PPT_BF16) {
    const bf16 *qq = (const bf16*)q, *kk = (const bf16*)k, *vv = (const bf16*)v;
    if (D == 32) return flash_bf16<32>(qq, kk, vv, B, L, H, sb, sl, sh, (bf16*)out, st);
    if (D == 64) return flash_bf16<64>(qq, kk, vv, B, L, H, sb, sl, sh, (bf16*)out, st);
    if (D == 128) return flash_bf16<128>(qq, kk, vv, B, L, H, sb, sl, sh, (bf16*)out, st);
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * ((size_t)FL_TQ * D + FL_TK * (D + 1) + FL_TQ * FL_TK +
                                       3 * FL_TQ);
  cudaFuncSetAttribute(flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((L + FL_TQ - 1) / FL_TQ, H, B);
  flash_f32_kernel<<<grid, 256, smem, st>>>((const float*)q, (const float*)k, (const float*)v, sb,
                                            sl, sh, L, D, attn_scale(D), (float*)out);
  PPT_CHECK_LAUNCH();
  return 0;
}
