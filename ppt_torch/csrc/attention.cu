// Standalone multi-head attention for the unfused ViT block, [B, L, H, D]
// in and out (layout and strides as in attention.cuh):
//   ppt_mha        whole-row attention (attention.cuh), the block's own
//                  kernels. Replaces ppt_tpu/kernels/attention.py:fused_mha
//                  (_mha_kernel via _mha_pallas), used below L = 1024.
//   ppt_flash_mha  single-pass flash attention with an online softmax.
//                  Replaces the forward of :flash_mha, the stock TPU flash
//                  kernel that every route takes from L = 1024 on; in
//                  training it also writes the row log-sum-exp.
//   ppt_flash_mha_bwd  its backward (di, dK/dV, dQ; design at the end of
//                  this file). Replaces the stock TPU flash backward,
//                  jax/experimental/pallas/ops/tpu/flash_attention.py:941
//                  _flash_attention_bwd_dkv and :1287 _flash_attention_bwd_dq.
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
// the A fragments of P V; one division by the f32 sum at the end (and, for
// training, lse = m + log(l) written per row). Query
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
                  float scale, bf16* __restrict__ out, float* __restrict__ lse) {
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
  if (lse && (lane & 3) == 0) {  // the training forward: m + log(l) per row
    float* lrow = lse + ((size_t)b * H + h) * L;
    if (r0 < L) lrow[r0] = __fadd_rn(m0, logf(l0));
    if (r1 < L) lrow[r1] = __fadd_rn(m1, logf(l1));
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
                 int D, float scale, float* __restrict__ out, float* __restrict__ lse) {
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
  if (lse && tid < nq)
    lse[((size_t)b * H + h) * L + q0 + tid] = __fadd_rn(mrow[tid], logf(den[tid]));
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
                      long long sb, long long sl, long long sh, bf16* out, float* lse,
                      cudaStream_t st) {
  const size_t smem = 4 * (size_t)FL_TK * (D + 8) * sizeof(bf16);
  cudaFuncSetAttribute(flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((L + 63) / 64, H, B);
  flash_bf16_kernel<D><<<grid, 128, smem, st>>>(q, k, v, sb, sl, sh, L, attn_scale(D), out,
                                                 lse);
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

// lse: null when serving; in training the [B, H, L] f32 row log-sum-exp
// m + log(l) that the backward reads.
PPT_EXPORT int ppt_flash_mha(int dtype, const void* q, const void* k, const void* v, int B,
                             int L, int H, int D, long long sb, long long sl, long long sh,
                             void* out, void* lse, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* ls = (float*)lse;
  if (dtype == PPT_BF16) {
    const bf16 *qq = (const bf16*)q, *kk = (const bf16*)k, *vv = (const bf16*)v;
    if (D == 32) return flash_bf16<32>(qq, kk, vv, B, L, H, sb, sl, sh, (bf16*)out, ls, st);
    if (D == 64) return flash_bf16<64>(qq, kk, vv, B, L, H, sb, sl, sh, (bf16*)out, ls, st);
    if (D == 128) return flash_bf16<128>(qq, kk, vv, B, L, H, sb, sl, sh, (bf16*)out, ls, st);
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * ((size_t)FL_TQ * D + FL_TK * (D + 1) + FL_TQ * FL_TK +
                                       3 * FL_TQ);
  cudaFuncSetAttribute(flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((L + FL_TQ - 1) / FL_TQ, H, B);
  flash_f32_kernel<<<grid, 256, smem, st>>>((const float*)q, (const float*)k, (const float*)v, sb,
                                            sl, sh, L, D, attn_scale(D), (float*)out, ls);
  PPT_CHECK_LAUNCH();
  return 0;
}

// ---------------------------------------------------------------------------
// flash_mha's backward: ppt_flash_mha_bwd, three launches.
//   di   one warp per (b, l, h) row: di = sum_d o * do in f32, from the
//        forward's output rounded to the compute dtype (as the stock
//        _flash_attention_bwd forms it, flash_attention.py:274-276).
//   dkv  one CTA of 4 warps per (b, h, 64-key tile); each warp owns 16 keys
//        and walks every 32-query tile, recomputing S^T = K Q^T and
//        P^T = exp(S^T * scale - lse) from the forward's row log-sum-exp.
//        dV += P^T(bf16) dO, dP^T = V dO^T, dS^T = (dP^T - di) P^T scale,
//        dK += dS^T(bf16) Q, both accumulated in f32 registers: no atomics.
//   dq   one CTA of 4 warps per (b, h, 64-query tile), 16 queries a warp,
//        walking every 64-key tile: S, P, dP = dO V^T, dS as above,
//        dQ += dS(bf16) K in f32 registers.
// The arithmetic of _flash_attention_dkv_kernel / _flash_attention_dq_kernel
// (flash_attention.py:894-919, :1227-1261), not their blocking. Casts: P to
// the compute dtype only for the dV product, dS only for the dK and dQ
// products. Masking without padding: a query column >= L gives P = dS = 0
// in the dK/dV kernel, a key >= L gives P = dS = 0 in the dQ kernel (both
// by select, so the zero-filled tail rows reach no sum and no 0 * inf),
// and rows >= L are never written. Every sum runs in a fixed order:
// repeated runs give identical bits.
//
// Bound at the long trunk's [32, 1025, 6, 64] bf16: 5 products of
// 2 B H L^2 D (S twice, dP twice, and dV, dK, dQ: the two recomputed
// products are not counted) = 129 GFLOP at the bf16 peak, against ~0.2 GB
// moved: operations. bf16 runs every product on mma.sync m16n8k16 with
// cp.async double-buffered tiles; f32 runs FMA on the CUDA cores with
// scores and gradients staged in shared memory. wgmma and TMA are later
// work.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_di_kernel(const T* __restrict__ o, const T* __restrict__ dout, int rows, int L, int H,
                    int D, float* __restrict__ di) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);  // (b * L + l) * H + h
  if (row >= rows) return;
  const T *orow = o + (size_t)row * D, *drow = dout + (size_t)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = __fadd_rn(s, __fmul_rn(to_f(orow[d]), to_f(drow[d])));
  for (int x = 16; x; x >>= 1) s += __shfl_xor_sync(0xffffffffu, s, x);
  if (lane == 0) {
    const int h = row % H, l = (row / H) % L, b = row / (H * L);
    di[((size_t)b * H + h) * L + l] = s;
  }
}

constexpr int BW_TK = 64, BW_TQ = 32;  // bf16 dK/dV: keys per CTA, queries per step

// smem bytes of the bf16 dK/dV kernel: K and V tiles, two Q/dO stages, lse/di
template <int D> constexpr size_t dkv_bf16_smem() {
  return (size_t)(2 * BW_TK + 4 * BW_TQ) * (D + 8) * sizeof(bf16) + 4 * BW_TQ * sizeof(float);
}
static_assert(dkv_bf16_smem<128>() <= 232448, "dK/dV tiles exceed the SM's shared memory");

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, long long sb, long long sl, long long sh,
                          const bf16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ di, int L, float scale,
                          bf16* __restrict__ dk, bf16* __restrict__ dv) {
  constexpr int LD = D + 8, KS = D / 16, QT = BW_TQ * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* Vs = Ks + BW_TK * LD;                     // [64][LD]
  bf16* Qs = Vs + BW_TK * LD;                     // [2][32][LD]
  bf16* dOs = Qs + 2 * QT;                        // [2][32][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * QT);  // [2][32]
  float* di_s = lse_s + 2 * BW_TQ;                        // [2][32]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int k0 = blockIdx.x * BW_TK;
  const int kq = (lane & 3) * 2;
  const size_t off = (size_t)b * sb + (size_t)h * sh;
  const bf16 *qb = q + off, *kb = k + off, *vb = v + off;
  const bf16* dob = dout + ((size_t)b * L * H + h) * D;  // contiguous [B, L, H, D]
  const float *lseb = lse + ((size_t)b * H + h) * L, *dib = di + ((size_t)b * H + h) * L;

  for (int e = tid; e < BW_TK * (D / 8); e += 128) {  // this CTA's keys, zero past L
    const int j = e / (D / 8), c = (e % (D / 8)) * 8;
    const bool ok = k0 + j < L;
    const size_t o = (size_t)(ok ? k0 + j : 0) * sl + c;
    cp_async16(Ks + j * LD + c, kb + o, ok);
    cp_async16(Vs + j * LD + c, vb + o, ok);
  }
  cp_async_commit();
  auto load_tile = [&](int stage, int q0) {  // 32 queries of Q and dO, lse and di
    for (int e = tid; e < BW_TQ * (D / 8); e += 128) {
      const int j = e / (D / 8), c = (e % (D / 8)) * 8;
      const bool ok = q0 + j < L;
      const int r = ok ? q0 + j : 0;
      cp_async16(Qs + stage * QT + j * LD + c, qb + (size_t)r * sl + c, ok);
      cp_async16(dOs + stage * QT + j * LD + c, dob + (size_t)r * H * D + c, ok);
    }
    if (tid < BW_TQ) {
      const bool ok = q0 + tid < L;
      lse_s[stage * BW_TQ + tid] = ok ? lseb[q0 + tid] : 0.f;
      di_s[stage * BW_TQ + tid] = ok ? dib[q0 + tid] : 0.f;
    }
    cp_async_commit();
  };

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

  // S^T or dP^T of this warp's 16 keys x 32 queries: A = the key rows of
  // `rows` (K or V), B = the query rows of `cols` (Q or dO), both [n][D]
  auto product_t = [&](float (&acc)[4][4], const bf16* rows, const bf16* cols) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, rows + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t bf[4];
        ldmatrix_x4(bf, cols + (p * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * p], a, bf[0], bf[1]);
        mma_bf16(acc[2 * p + 1], a, bf[2], bf[3]);
      }
    }
  };
  // acc[16 keys x D] += X^T (C fragments, rounded to bf16 as A fragments) @ Y [32 x D]
  auto accumulate = [&](float (&acc)[D / 8][4], const float (&x)[4][4], const bf16* y) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t a[4] = {pack_bf16(x[2 * ks][0], x[2 * ks][1]), pack_bf16(x[2 * ks][2], x[2 * ks][3]),
                       pack_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1]),
                       pack_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3])};
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, y + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + p * 16 +
                                  (lane >> 4) * 8);
        mma_bf16(acc[2 * p], a, bf[0], bf[1]);
        mma_bf16(acc[2 * p + 1], a, bf[2], bf[3]);
      }
    }
  };

  const int n_tiles = (L + BW_TQ - 1) / BW_TQ;
  load_tile(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile((t + 1) & 1, (t + 1) * BW_TQ);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = t & 1, q0 = t * BW_TQ;
    const bf16 *qs = Qs + st * QT, *dos = dOs + st * QT;
    const float *ls = lse_s + st * BW_TQ, *ds_ = di_s + st * BW_TQ;
    float p[4][4], g[4][4];
    product_t(p, Ks, qs);   // S^T
    product_t(g, Vs, dos);  // dP^T
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + kq + (e & 1);  // this element's query in the tile
        const bool ok = q0 + c < L;
        const float pe = ok ? expf(__fsub_rn(__fmul_rn(p[nt][e], scale), ls[c])) : 0.f;
        g[nt][e] = ok ? __fmul_rn(__fmul_rn(__fsub_rn(g[nt][e], ds_[c]), pe), scale) : 0.f;
        p[nt][e] = pe;
      }
    accumulate(dva, p, dos);  // dV += P^T dO
    accumulate(dka, g, qs);   // dK += dS^T Q
    __syncthreads();  // the next load reuses this stage's buffers
  }
  const int r0 = k0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (e >> 1) * 8;
      if (r < L) {
        const size_t o = ((size_t)b * L + r) * H * D + h * D + dt * 8 + kq + (e & 1);
        dk[o] = __float2bfloat16_rn(dka[dt][e]);
        dv[o] = __float2bfloat16_rn(dva[dt][e]);
      }
    }
}

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, long long sb, long long sl, long long sh,
                         const bf16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ di, int L, float scale,
                         bf16* __restrict__ dq) {
  constexpr int LD = D + 8, KS = D / 16, TILE = FL_TK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [2][64][LD]
  bf16* Vs = Ks + 2 * TILE;                       // [2][64][LD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int r0 = blockIdx.x * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int kq = (lane & 3) * 2;
  const size_t off = (size_t)b * sb + (size_t)h * sh;
  const bf16 *qb = q + off, *kb = k + off, *vb = v + off;
  const bf16* dob = dout + ((size_t)b * L * H + h) * D;
  const float *lseb = lse + ((size_t)b * H + h) * L, *dib = di + ((size_t)b * H + h) * L;

  uint32_t qf[KS][4], gf[KS][4];  // this warp's 16 rows of Q and dO as A fragments
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bf16* q0p = qb + (size_t)r0 * sl + ks * 16 + kq;
    const bf16* q1p = qb + (size_t)r1 * sl + ks * 16 + kq;
    const bf16* g0p = dob + (size_t)r0 * H * D + ks * 16 + kq;
    const bf16* g1p = dob + (size_t)r1 * H * D + ks * 16 + kq;
    qf[ks][0] = r0 < L ? *reinterpret_cast<const uint32_t*>(q0p) : 0u;
    qf[ks][1] = r1 < L ? *reinterpret_cast<const uint32_t*>(q1p) : 0u;
    qf[ks][2] = r0 < L ? *reinterpret_cast<const uint32_t*>(q0p + 8) : 0u;
    qf[ks][3] = r1 < L ? *reinterpret_cast<const uint32_t*>(q1p + 8) : 0u;
    gf[ks][0] = r0 < L ? *reinterpret_cast<const uint32_t*>(g0p) : 0u;
    gf[ks][1] = r1 < L ? *reinterpret_cast<const uint32_t*>(g1p) : 0u;
    gf[ks][2] = r0 < L ? *reinterpret_cast<const uint32_t*>(g0p + 8) : 0u;
    gf[ks][3] = r1 < L ? *reinterpret_cast<const uint32_t*>(g1p + 8) : 0u;
  }
  const float lse0 = r0 < L ? lseb[r0] : 0.f, lse1 = r1 < L ? lseb[r1] : 0.f;
  const float di0 = r0 < L ? dib[r0] : 0.f, di1 = r1 < L ? dib[r1] : 0.f;

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
  // acc[16 x 64 keys] = A (this warp's rows) @ rows(tile)^T
  auto product = [&](float (&acc)[8][4], const uint32_t (&a)[KS][4], const bf16* tile) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t bf[4];
        ldmatrix_x4(bf, tile + (p * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * p], a[ks], bf[0], bf[1]);
        mma_bf16(acc[2 * p + 1], a[ks], bf[2], bf[3]);
      }
  };

  float dqa[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[dt][e] = 0.f;

  const int n_tiles = (L + FL_TK - 1) / FL_TK;
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
    float s[8][4], g[8][4];
    product(s, qf, ks_);  // S
    product(g, gf, vs_);  // dP
    uint32_t sf[4][4];    // dS rounded to bf16 as A fragments, 16 keys each
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k0 + nt * 8 + kq + (e & 1) < L;
        const float pe = ok ? expf(__fsub_rn(__fmul_rn(s[nt][e], scale), e < 2 ? lse0 : lse1))
                            : 0.f;
        d[e] = ok ? __fmul_rn(__fmul_rn(__fsub_rn(g[nt][e], e < 2 ? di0 : di1), pe), scale)
                  : 0.f;
      }
      sf[nt >> 1][(nt & 1) * 2] = pack_bf16(d[0], d[1]);
      sf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)  // dQ += dS K
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, ks_ + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                  p * 16 + (lane >> 4) * 8);
        mma_bf16(dqa[2 * p], sf[ks], bf[0], bf[1]);
        mma_bf16(dqa[2 * p + 1], sf[ks], bf[2], bf[3]);
      }
    __syncthreads();  // the next load reuses this stage's buffers
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1;
      if (r < L)
        dq[((size_t)b * L + r) * H * D + h * D + dt * 8 + kq + (e & 1)] =
            __float2bfloat16_rn(dqa[dt][e]);
    }
}

// f32: 32 keys (dK/dV) or 32 queries (dQ) per CTA of 256 threads, tiles of
// 32 rows of the other side staged in shared memory; one warp per
// (query, 32 keys) for S, dP and dS; D <= 128 and a multiple of 8.
constexpr int BW_T32 = 32, BW_LDS = BW_T32 + 1;

static size_t bwd_f32_smem(int D) {
  return sizeof(float) * (4 * (size_t)BW_T32 * (D + 1) + 2 * BW_T32 * BW_LDS + 2 * BW_T32);
}

// P and dS of a 32 x 32 tile into shared memory, [query][key]: one warp
// per query row, a lane per key; pairs outside [0, L) give zeros
__device__ __forceinline__ void f32_scores(const float* Qs, const float* dOs, const float* Ks,
                                           const float* Vs, const float* lse_s,
                                           const float* di_s, int D, int q0, int k0, int L,
                                           float scale, float* P, float* dS) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < BW_T32; i += 8) {
    float s = 0.f, g = 0.f;
    for (int d = 0; d < D; ++d) {
      s = fmaf(Qs[i * (D + 1) + d], Ks[lane * (D + 1) + d], s);
      g = fmaf(dOs[i * (D + 1) + d], Vs[lane * (D + 1) + d], g);
    }
    const bool ok = q0 + i < L && k0 + lane < L;
    const float p = ok ? expf(__fsub_rn(__fmul_rn(s, scale), lse_s[i])) : 0.f;
    P[i * BW_LDS + lane] = p;
    dS[i * BW_LDS + lane] = ok ? __fmul_rn(__fmul_rn(__fsub_rn(g, di_s[i]), p), scale) : 0.f;
  }
}

// 32 rows of a [L, D] operand (row stride `stride`) into smem [32][D + 1], zero past L
__device__ __forceinline__ void f32_rows(float* dst, const float* src, size_t stride, int r0,
                                         int L, int D) {
  for (int e = threadIdx.x; e < BW_T32 * D; e += 256) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] = r0 + r < L ? src[(size_t)(r0 + r) * stride + d] : 0.f;
  }
}

__global__ void __launch_bounds__(256)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, long long sb, long long sl, long long sh,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ di, int L, int D, float scale,
                         float* __restrict__ dk, float* __restrict__ dv) {
  extern __shared__ float sm[];
  float* Ks = sm;                       // [32][D + 1]
  float* Vs = Ks + BW_T32 * (D + 1);    // [32][D + 1]
  float* Qs = Vs + BW_T32 * (D + 1);    // [32][D + 1]
  float* dOs = Qs + BW_T32 * (D + 1);   // [32][D + 1]
  float* P = dOs + BW_T32 * (D + 1);    // [query][key]
  float* dS = P + BW_T32 * BW_LDS;      // [query][key]
  float* lse_s = dS + BW_T32 * BW_LDS;  // [32]
  float* di_s = lse_s + BW_T32;         // [32]
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BW_T32, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const size_t off = (size_t)b * sb + (size_t)h * sh;
  const float* dob = dout + ((size_t)b * L * H + h) * D;
  const float *lseb = lse + ((size_t)b * H + h) * L, *dib = di + ((size_t)b * H + h) * L;
  f32_rows(Ks, k + off, sl, k0, L, D);
  f32_rows(Vs, v + off, sl, k0, L, D);

  constexpr int MAXE = BW_T32 * 128 / 256;
  float dka[MAXE], dva[MAXE];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) dka[e] = dva[e] = 0.f;
  const int nE = (BW_T32 * D) / 256;  // D multiple of 8

  for (int q0 = 0; q0 < L; q0 += BW_T32) {
    __syncthreads();
    f32_rows(Qs, q + off, sl, q0, L, D);
    f32_rows(dOs, dob, (size_t)H * D, q0, L, D);
    if (tid < BW_T32) {
      lse_s[tid] = q0 + tid < L ? lseb[q0 + tid] : 0.f;
      di_s[tid] = q0 + tid < L ? dib[q0 + tid] : 0.f;
    }
    __syncthreads();
    f32_scores(Qs, dOs, Ks, Vs, lse_s, di_s, D, q0, k0, L, scale, P, dS);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      if (e < nE) {
        const int idx = tid + 256 * e, j = idx / D, d = idx % D;
        float a = dva[e], c = dka[e];
        for (int i = 0; i < BW_T32; ++i) {
          a = fmaf(P[i * BW_LDS + j], dOs[i * (D + 1) + d], a);
          c = fmaf(dS[i * BW_LDS + j], Qs[i * (D + 1) + d], c);
        }
        dva[e] = a;
        dka[e] = c;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    if (e < nE) {
      const int idx = tid + 256 * e, j = idx / D, d = idx % D;
      if (k0 + j < L) {
        const size_t o = ((size_t)b * L + k0 + j) * H * D + h * D + d;
        dk[o] = dka[e];
        dv[o] = dva[e];
      }
    }
  }
}

__global__ void __launch_bounds__(256)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, long long sb, long long sl, long long sh,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ di, int L, int D, float scale,
                        float* __restrict__ dq) {
  extern __shared__ float sm[];
  float* Ks = sm;                       // [32][D + 1]
  float* Vs = Ks + BW_T32 * (D + 1);    // [32][D + 1]
  float* Qs = Vs + BW_T32 * (D + 1);    // [32][D + 1]
  float* dOs = Qs + BW_T32 * (D + 1);   // [32][D + 1]
  float* P = dOs + BW_T32 * (D + 1);    // [query][key]
  float* dS = P + BW_T32 * BW_LDS;      // [query][key]
  float* lse_s = dS + BW_T32 * BW_LDS;  // [32]
  float* di_s = lse_s + BW_T32;         // [32]
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BW_T32, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const size_t off = (size_t)b * sb + (size_t)h * sh;
  const float* dob = dout + ((size_t)b * L * H + h) * D;
  const float *lseb = lse + ((size_t)b * H + h) * L, *dib = di + ((size_t)b * H + h) * L;
  f32_rows(Qs, q + off, sl, q0, L, D);
  f32_rows(dOs, dob, (size_t)H * D, q0, L, D);
  if (tid < BW_T32) {
    lse_s[tid] = q0 + tid < L ? lseb[q0 + tid] : 0.f;
    di_s[tid] = q0 + tid < L ? dib[q0 + tid] : 0.f;
  }

  constexpr int MAXE = BW_T32 * 128 / 256;
  float dqa[MAXE];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) dqa[e] = 0.f;
  const int nE = (BW_T32 * D) / 256;

  for (int k0 = 0; k0 < L; k0 += BW_T32) {
    __syncthreads();
    f32_rows(Ks, k + off, sl, k0, L, D);
    f32_rows(Vs, v + off, sl, k0, L, D);
    __syncthreads();
    f32_scores(Qs, dOs, Ks, Vs, lse_s, di_s, D, q0, k0, L, scale, P, dS);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      if (e < nE) {
        const int idx = tid + 256 * e, i = idx / D, d = idx % D;
        float a = dqa[e];
        for (int j = 0; j < BW_T32; ++j) a = fmaf(dS[i * BW_LDS + j], Ks[j * (D + 1) + d], a);
        dqa[e] = a;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    if (e < nE) {
      const int idx = tid + 256 * e, i = idx / D, d = idx % D;
      if (q0 + i < L) dq[((size_t)b * L + q0 + i) * H * D + h * D + d] = dqa[e];
    }
  }
}

template <int D>
static int flash_bwd_bf16(const bf16* q, const bf16* k, const bf16* v, int B, int L, int H,
                          long long sb, long long sl, long long sh, const bf16* dout,
                          const float* lse, const float* di, bf16* dq, bf16* dk, bf16* dv,
                          cudaStream_t st) {
  const float scale = attn_scale(D);
  const size_t smem_kv = dkv_bf16_smem<D>();
  cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_kv);
  flash_bwd_dkv_bf16_kernel<D><<<dim3((L + BW_TK - 1) / BW_TK, H, B), 128, smem_kv, st>>>(
      q, k, v, sb, sl, sh, dout, lse, di, L, scale, dk, dv);
  PPT_CHECK_LAUNCH();
  const size_t smem_q = 4 * (size_t)FL_TK * (D + 8) * sizeof(bf16);
  cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_q);
  flash_bwd_dq_bf16_kernel<D><<<dim3((L + 63) / 64, H, B), 128, smem_q, st>>>(
      q, k, v, sb, sl, sh, dout, lse, di, L, scale, dq);
  PPT_CHECK_LAUNCH();
  return 0;
}

// q, k, v strided as the forward takes them; o, dout, dq, dk, dv contiguous
// [B, L, H, D]; lse the forward's [B, H, L]; di an f32 [B, H, L] scratch.
PPT_EXPORT int ppt_flash_mha_bwd(int dtype, const void* q, const void* k, const void* v, int B,
                                 int L, int H, int D, long long sb, long long sl, long long sh,
                                 const void* o, const void* dout, const void* lse, void* di,
                                 void* dq, void* dk, void* dv, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = B * L * H;
  const float* ls = (const float*)lse;
  float* dd = (float*)di;
  if (dtype == PPT_BF16) {
    flash_bwd_di_kernel<bf16><<<(rows + 7) / 8, 256, 0, st>>>((const bf16*)o, (const bf16*)dout,
                                                              rows, L, H, D, dd);
    PPT_CHECK_LAUNCH();
    const bf16 *qq = (const bf16*)q, *kk = (const bf16*)k, *vv = (const bf16*)v;
    const bf16* g = (const bf16*)dout;
    bf16 *gq = (bf16*)dq, *gk = (bf16*)dk, *gv = (bf16*)dv;
    if (D == 32)
      return flash_bwd_bf16<32>(qq, kk, vv, B, L, H, sb, sl, sh, g, ls, dd, gq, gk, gv, st);
    if (D == 64)
      return flash_bwd_bf16<64>(qq, kk, vv, B, L, H, sb, sl, sh, g, ls, dd, gq, gk, gv, st);
    if (D == 128)
      return flash_bwd_bf16<128>(qq, kk, vv, B, L, H, sb, sl, sh, g, ls, dd, gq, gk, gv, st);
    return (int)cudaErrorInvalidValue;
  }
  flash_bwd_di_kernel<float><<<(rows + 7) / 8, 256, 0, st>>>((const float*)o, (const float*)dout,
                                                             rows, L, H, D, dd);
  PPT_CHECK_LAUNCH();
  const size_t smem = bwd_f32_smem(D);
  const float scale = attn_scale(D);
  const dim3 grid((L + BW_T32 - 1) / BW_T32, H, B);
  cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  flash_bwd_dkv_f32_kernel<<<grid, 256, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, sb, sl, sh, (const float*)dout, ls, dd, L,
      D, scale, (float*)dk, (float*)dv);
  PPT_CHECK_LAUNCH();
  cudaFuncSetAttribute(flash_bwd_dq_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  flash_bwd_dq_f32_kernel<<<grid, 256, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, sb, sl, sh, (const float*)dout, ls, dd, L,
      D, scale, (float*)dq);
  PPT_CHECK_LAUNCH();
  return 0;
}
