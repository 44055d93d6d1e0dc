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
// Whole-row design: attention.cuh (bf16 on TMA and wgmma, hopper.cuh).
//
// Flash forward (bf16): flash_fwd_wgmma_kernel below, warp-specialised on
// TMA and wgmma as the whole-row kernel is. Online softmax: the running
// row max and sum in f32, the accumulator rescaled by exp(m_old - m_new),
// P = exp(s - m) rounded to bf16 before P V, one division by the f32 sum
// at the end (and, for training, lse = m + log(l) written per row). Keys
// >= L are masked by select (TMA zero-fills the tile past L); query rows
// >= L are computed on zeros and never written. The TPU version pads L to
// 512 and masks with segment ids; only the valid rows' semantics carry
// over: no padding tensor, no segment-id array. Deterministic: every sum
// runs in a fixed order, no atomics. f32 runs the same online softmax as
// FMA on the CUDA cores (32 queries per CTA, scores through shared
// memory).
#include "attention.cuh"

PPT_ERROR_STRING_FN

constexpr int FL_TK = 64;  // keys per tile

// bf16 flash forward on Hopper: grid (ceil(L / (64 FL_NC)), H, B), one CTA
// an SM of a producer and FL_NC consumer warpgroups (three; two at D =
// 128, whose accumulator needs the registers), as the whole-row kernel.
// The producer's one thread loads each consumer's 64 queries of Q once,
// then streams 64-key tiles of K and V through a ring of FL_STAGES stages
// (full and empty mbarriers) that every consumer reads: each K and V tile
// is read from L2 once per 192 queries, where the mma.sync kernel this
// replaces read it once per 64 (0.86 GB a call at [32, 1025, 6, 64]).
// A consumer owns 64 query rows. Per key tile t it issues S_t = Q K_t^T
// (wgmma, both operands in shared memory), rescales the accumulator by the
// previous tile's exp(m_old - m_new) and issues P_{t-1} V_{t-1} (wgmma with
// P_{t-1} as register A fragments, V MN-major); it waits for S_t alone and
// runs tile t's softmax in place in those f32 registers while P_{t-1}
// V_{t-1} is still on the tensor cores, then waits for that product,
// releases its stage and only then rounds P_t into the A fragments (a
// fragment rewritten while a product still reads it would make ptxas
// serialise every wgmma, C7513). The last tile's P V follows the loop.
// The softmax's arithmetic, not the tensor cores, bounds a tile: exp and a
// handful of f32 operations on each of a consumer's 4096 scores against
// two 64 x 64 x 64 products; the scale is folded into one fused
// multiply-add before the special function unit's 2^x. The consumers issue
// their products unordered: taking turns by named barriers (FlashAttention
// 3's ping-pong) measured the same on the H100.
template <int D> constexpr int FL_NC = D == 128 ? 2 : 3;
constexpr int FL_STAGES = 4;

template <int D> constexpr size_t flash_smem_bytes() {
  return 1024 + (FL_NC<D> + 2 * FL_STAGES) * (size_t)RowTile<D>::BYTES + 8 * (1 + 2 * FL_STAGES);
}

// 2^x on the special-function unit (denormal results flushed to 0)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one tile's online softmax on the raw scores s (C-fragment order), in
// place: keys at or past lim masked (MASK), the new row max m of the scaled
// scores (the raw max times the scale: rounding s * scale is monotone in s,
// so this is the max of the rounded scaled scores), the correction c =
// exp(m_old - m), l = l c + sum p, and s replaced by p = exp(s scale - m)
// in f32, taken as 2^(s scale log2(e) - m log2(e)) with one fused
// multiply-add (rounded to bf16 for P V by to_a_frags)
template <bool MASK>
__device__ __forceinline__ void flash_softmax(float (&s)[32], float scale, int lim, int kq,
                                              float& m0, float& m1, float& l0, float& l1,
                                              float& c0, float& c1) {
  constexpr float LOG2E = 1.4426950408889634f;
  float r0 = -INFINITY, r1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK && j * 8 + kq + (e & 1) >= lim) s[4 * j + e] = -INFINITY;
      if (e < 2) r0 = fmaxf(r0, s[4 * j + e]);
      else r1 = fmaxf(r1, s[4 * j + e]);
    }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {  // the 4 lanes of a row
    r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, o));
    r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, o));
  }
  // key 0 is in the first tile, so the max is finite from there on and the
  // first correction exp(-inf) is 0
  const float mt0 = fmaxf(m0, __fmul_rn(r0, scale)), mt1 = fmaxf(m1, __fmul_rn(r1, scale));
  c0 = __expf(__fsub_rn(m0, mt0));
  c1 = __expf(__fsub_rn(m1, mt1));
  m0 = mt0;
  m1 = mt1;
  l0 *= c0;
  l1 *= c1;
  const float sl = __fmul_rn(scale, LOG2E), b0 = -__fmul_rn(mt0, LOG2E),
              b1 = -__fmul_rn(mt1, LOG2E);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p0 = ex2_approx(fmaf(s[4 * j], sl, b0)), p1 = ex2_approx(fmaf(s[4 * j + 1], sl, b0));
    const float p2 = ex2_approx(fmaf(s[4 * j + 2], sl, b1)), p3 = ex2_approx(fmaf(s[4 * j + 3], sl, b1));
    l0 += p0 + p1;
    l1 += p2 + p3;
    s[4 * j] = p0;
    s[4 * j + 1] = p1;
    s[4 * j + 2] = p2;
    s[4 * j + 3] = p3;
  }
}

// x (64 x 64, C-fragment order) rounded to bf16 as the A fragments of four k16 steps
__device__ __forceinline__ void to_a_frags(uint32_t (&f)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    f[j >> 1][(j & 1) * 2] = pack_bf16(x[4 * j], x[4 * j + 1]);
    f[j >> 1][(j & 1) * 2 + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(128 * (FL_NC<D> + 1), 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, int L, float scale,
                       bf16* __restrict__ out, float* __restrict__ lse) {
  using T = RowTile<D>;
  constexpr int NC = FL_NC<D>, NS = FL_STAGES;
  using Regs = RegSplit<NC + 1, 1>;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* base = align1024(wg_smem);
  bf16* Qs = reinterpret_cast<bf16*>(base);  // [NC][64][D]
  bf16* Ks = Qs + NC * T::ELEMS;              // [NS][64][D]
  bf16* Vs = Ks + NS * T::ELEMS;              // [NS][64][D]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(Vs + NS * T::ELEMS);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + NS;
  const int q0 = blockIdx.x * 64 * NC, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int nt = (L + FL_TK - 1) / FL_TK;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    reg_dealloc<Regs::PRODUCER>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(qfull, NC * T::BYTES);
      for (int w = 0; w < NC; ++w) tma_tile<D>(Qs + w * T::ELEMS, &tq, qfull, h, q0 + 64 * w, b);
      for (int t = 0; t < nt; ++t) {
        const int s = t % NS;
        mbar_wait(&empty[s], ((t / NS) & 1) ^ 1);
        mbar_arrive_tx(&full[s], 2 * T::BYTES);
        tma_tile<D>(Ks + s * T::ELEMS, &tk, &full[s], h, t * FL_TK, b);
        tma_tile<D>(Vs + s * T::ELEMS, &tv, &full[s], h, t * FL_TK, b);
      }
    }
    return;
  }

  reg_alloc<Regs::CONSUMER>();
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, lane = tid & 31,
            warp = tid >> 5;
  const int r0 = q0 + 64 * wg + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int kq = (lane & 3) * 2;
  const bf16* Qw = Qs + wg * T::ELEMS;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, c0 = 0.f, c1 = 0.f;
  float o[D / 2];     // written by the first P V product
  uint32_t pf[4][4];  // P of the tile whose P V is issued next, bf16
  mbar_wait(qfull, 0);
  // P_{t-1} V_{t-1} into o: PVM 1 the first (o overwritten), 2 the others
  // (o rescaled first by the previous softmax's correction)
  auto issue_pv = [&](int sp, auto pvm) {
    constexpr int PVM = decltype(pvm)::value;
    // (a warp whose rows kept their max multiplies by 1: skipped, same bits)
    if (PVM == 2 && __any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }
    }
    fence_frags(pf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(o, pf[kk], desc_mn<D>(Vs + sp * T::ELEMS, kk), PVM == 2 || kk > 0);
    wgmma_commit();
  };
  // one key tile: S_t issued, then P_{t-1} V_{t-1} (PVM > 0), S_t waited
  // for and tile t's softmax run in f32 registers while P_{t-1} V_{t-1}
  // runs; then that product waited for, its stage released, and P_t
  // rounded into the A fragments it read
  auto step = [&](int t, auto mask, auto pvm) {
    constexpr int PVM = decltype(pvm)::value;
    const int st = t % NS, sp = (t + NS - 1) % NS;
    mbar_wait(&full[st], (t / NS) & 1);
    float s[32];  // fresh each tile: written by the product, not read
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<64>(s, desc_k<D>(Qw, ks), desc_k<D>(Ks + st * T::ELEMS, ks), ks > 0);
    wgmma_commit();
    if constexpr (PVM > 0) issue_pv(sp, pvm);
    if constexpr (PVM > 0) wgmma_wait<1>();
    else wgmma_wait<0>();
    fence_acc(s);
    flash_softmax<decltype(mask)::value>(s, scale, L - t * FL_TK, kq, m0, m1, l0, l1, c0, c1);
    if constexpr (PVM > 0) {
      wgmma_wait<0>();
      fence_acc(o);
      fence_frags(pf);
      if (lane == 0) mbar_arrive(&empty[sp]);
    }
    to_a_frags(pf, s);
  };
  using No = std::integral_constant<bool, false>;
  using Yes = std::integral_constant<bool, true>;
  using Pv0 = std::integral_constant<int, 0>;
  using Pv1 = std::integral_constant<int, 1>;
  using Pv2 = std::integral_constant<int, 2>;
  if (nt == 1) {
    step(0, Yes{}, Pv0{});
  } else {
    step(0, No{}, Pv0{});
    if (nt == 2) {
      step(1, Yes{}, Pv1{});
    } else {
      step(1, No{}, Pv1{});
      for (int t = 2; t < nt - 1; ++t) step(t, No{}, Pv2{});
      step(nt - 1, Yes{}, Pv2{});
    }
  }
  // the last tile's P V
  const int sl = (nt - 1) % NS;
  if (nt == 1) issue_pv(sl, Pv1{});
  else issue_pv(sl, Pv2{});
  wgmma_wait<0>();
  fence_acc(o);
  if (lane == 0) mbar_arrive(&empty[sl]);

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
  for (int j = 0; j < D / 8; ++j) {
    const int c = h * D + j * 8 + kq;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(out + ((size_t)b * L + r0) * H * D + c) =
          pack_bf16(__fdiv_rn(o[4 * j], l0), __fdiv_rn(o[4 * j + 1], l0));
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(out + ((size_t)b * L + r1) * H * D + c) =
          pack_bf16(__fdiv_rn(o[4 * j + 2], l1), __fdiv_rn(o[4 * j + 3], l1));
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
  constexpr int NC = FL_NC<D>;
  CUtensorMap tq, tk, tv;
  int rc = bhld_map<D>(&tq, q, B, L, H, sb, sl, sh);
  if (!rc) rc = bhld_map<D>(&tk, k, B, L, H, sb, sl, sh);
  if (!rc) rc = bhld_map<D>(&tv, v, B, L, H, sb, sl, sh);
  static const int pool = check_reg_pool(flash_fwd_wgmma_kernel<D>, RegSplit<NC + 1, 1>::NEED);
  if (!rc) rc = pool;
  if (rc) return rc;
  constexpr size_t smem = flash_smem_bytes<D>();
  cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((L + 64 * NC - 1) / (64 * NC), H, B);
  flash_fwd_wgmma_kernel<D><<<grid, 128 * (NC + 1), smem, st>>>(tq, tk, tv, L, attn_scale(D),
                                                                 out, lse);
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
//   di   di = sum_d o * do in f32 per (b, l, h) row, from the forward's
//        output rounded to the compute dtype (as the stock
//        _flash_attention_bwd forms it, flash_attention.py:274-276): one
//        warp a row in f32; in bf16 D / 8 lanes a row with 16-byte loads,
//        and the row's lse copied beside di into a [B * H][2][Lp] scratch,
//        Lp = L rounded up to 64, so that the dK/dV kernel takes both per
//        query tile by one bulk copy each.
//   dkv  one CTA per (b, h, 128 keys), 64 keys a consumer warpgroup
//        (32 keys per f32 CTA), walking every query tile, recomputing S^T =
//        K Q^T and P^T = exp(S^T * scale - lse) from the forward's row
//        log-sum-exp. dV += P^T(bf16) dO, dP^T = V dO^T, dS^T = (dP^T - di)
//        P^T scale, dK += dS^T(bf16) Q, both accumulated in f32 registers:
//        no atomics.
//   dq   one CTA per (b, h, 192 queries; 128 at D = 128), 64 queries a
//        consumer warpgroup (32 per f32 CTA), walking every key tile: S, P,
//        dP = dO V^T, dS as above, dQ += dS(bf16) K in f32 registers.
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
// moved: operations. bf16 runs its seven products on wgmma, the tiles
// arriving by TMA through a ring of stages that a producer warpgroup
// keeps full (hopper.cuh); f32 runs FMA on the CUDA cores with scores and
// gradients staged in shared memory.
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

// bf16: D / 8 lanes a row, 16 bytes of o and of do each; writes di and the
// row's lse side by side, [B * H][2][Lp]
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_di_bf16_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout, int rows,
                         int L, int H, const float* __restrict__ lse, int Lp,
                         float* __restrict__ stats) {
  constexpr int LPR = D / 8;  // lanes a row
  const int g = blockIdx.x * 256 + threadIdx.x;
  const int row = g / LPR, part = g % LPR;  // row = (b * L + l) * H + h
  float s = 0.f;
  if (row < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + (size_t)row * D + part * 8);
    const uint4 c = *reinterpret_cast<const uint4*>(dout + (size_t)row * D + part * 8);
    const bf16* ap = reinterpret_cast<const bf16*>(&a);
    const bf16* cp = reinterpret_cast<const bf16*>(&c);
#pragma unroll
    for (int i = 0; i < 8; ++i) s = __fadd_rn(s, __fmul_rn(to_f(ap[i]), to_f(cp[i])));
  }
#pragma unroll
  for (int x = LPR / 2; x; x >>= 1) s += __shfl_xor_sync(0xffffffffu, s, x);
  if (row < rows && part == 0) {
    const int h = row % H, l = (row / H) % L, b = row / (H * L);
    const size_t bh = (size_t)b * H + h;
    stats[bh * 2 * Lp + l] = s;
    stats[(bh * 2 + 1) * Lp + l] = lse[bh * L + l];
  }
}

// bf16 dK/dV on Hopper: grid (ceil(L / 128), H, B), one CTA an SM of a
// producer and two consumer warpgroups. The producer loads each consumer's
// 64 keys of K and V once, then streams 64-query tiles of Q and dO (TMA)
// and their di and lse rows (bulk copies of the padded [B * H][2][Lp]
// scratch that the di launch writes) through a ring of BW_STAGES stages,
// which both consumers read. A consumer owns 64 keys and walks every query
// tile: S^T = K Q^T, then dP^T = V dO^T, on wgmma with both operands in
// shared memory, the exp of P^T = exp(S^T scale - lse) overlapping the
// second product; dS^T = (dP^T - di) P^T scale in f32 registers; then dV +=
// P^T(bf16) dO and dK += dS^T(bf16) Q on wgmma with the rounded P^T and
// dS^T as register A fragments and dO, Q MN-major. dK and dV (2 D f32 a
// row) stay in registers to the end, which takes 240 a thread: hence one
// CTA of two consumers an SM rather than two CTAs of one, or three
// consumers (measured slower, with S^T and dP^T in 32-query halves to fit
// 160 registers). No atomics.
constexpr int BW_STAGES = 4, DKV_NC = 2;  // ring depth; dK/dV consumer warpgroups

template <int D> constexpr size_t dkv_smem_bytes() {
  return 1024 + 2 * DKV_NC * (size_t)RowTile<D>::BYTES +
         BW_STAGES * (2 * (size_t)RowTile<D>::BYTES + 512) + 8 * (1 + 2 * BW_STAGES);
}
static_assert(dkv_smem_bytes<128>() <= 232448, "dK/dV tiles exceed the SM's shared memory");

// 64 x 64 f32 products of two K-major tiles: acc = A B^T over the depth D
template <int D>
__device__ __forceinline__ void product_kk(float (&acc)[32], const bf16* a, const bf16* b) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) wgmma_ss<64>(acc, desc_k<D>(a, ks), desc_k<D>(b, ks), ks > 0);
}

template <int D>
__global__ void __launch_bounds__(128 * (DKV_NC + 1), 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ stats, int L, int Lp, float scale,
                           bf16* __restrict__ dk, bf16* __restrict__ dv) {
  using T = RowTile<D>;
  constexpr int NC = DKV_NC;  // consumer warpgroups, 64 keys each
  using Regs = RegSplit<NC + 1, 1>;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* base = align1024(wg_smem);
  bf16* Ks = reinterpret_cast<bf16*>(base);                         // [NC][64][D]
  bf16* Vs = Ks + NC * T::ELEMS;                                     // [NC][64][D]
  bf16* Qs = Vs + NC * T::ELEMS;                                     // [STAGES][64][D]
  bf16* dOs = Qs + BW_STAGES * T::ELEMS;                             // [STAGES][64][D]
  float* sts = reinterpret_cast<float*>(dOs + BW_STAGES * T::ELEMS);  // [STAGES][2][64]
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(sts + BW_STAGES * 128);
  uint64_t* full = kvfull + 1;
  uint64_t* empty = full + BW_STAGES;
  const int k0 = blockIdx.x * 64 * NC, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int nq = Lp / 64;

  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    reg_dealloc<Regs::PRODUCER>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(kvfull, 2 * NC * T::BYTES);
      for (int w = 0; w < NC; ++w) {
        tma_tile<D>(Ks + w * T::ELEMS, &tk, kvfull, h, k0 + 64 * w, b);
        tma_tile<D>(Vs + w * T::ELEMS, &tv, kvfull, h, k0 + 64 * w, b);
      }
      const float* srow = stats + ((size_t)b * H + h) * 2 * Lp;
      for (int t = 0; t < nq; ++t) {
        const int s = t % BW_STAGES;
        mbar_wait(&empty[s], ((t / BW_STAGES) & 1) ^ 1);
        mbar_arrive_tx(&full[s], 2 * T::BYTES + 512);
        tma_tile<D>(Qs + s * T::ELEMS, &tq, &full[s], h, t * 64, b);
        tma_tile<D>(dOs + s * T::ELEMS, &tdo, &full[s], h, t * 64, b);
        bulk_load(sts + s * 128, srow + t * 64, 256, &full[s]);
        bulk_load(sts + s * 128 + 64, srow + Lp + t * 64, 256, &full[s]);
      }
    }
    return;
  }

  reg_alloc<Regs::CONSUMER>();
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, lane = tid & 31,
            warp = tid >> 5;
  const int kq = (lane & 3) * 2;
  const int kw = k0 + 64 * wg;  // this warpgroup's first key (past L: zero tiles, no writes)
  const bf16 *kt = Ks + wg * T::ELEMS, *vt = Vs + wg * T::ELEMS;
  float dka[D / 2] = {}, dva[D / 2] = {};
  mbar_wait(kvfull, 0);
  for (int t = 0; t < nq; ++t) {
    const int s = t % BW_STAGES;
    const bf16 *qs = Qs + s * T::ELEMS, *dos = dOs + s * T::ELEMS;
    const float *dis = sts + s * 128, *lss = dis + 64;
    const int lim = L - t * 64;  // queries of this tile below L
    mbar_wait(&full[s], (t / BW_STAGES) & 1);
    float sa[32], ga[32];  // fresh each tile: written by the products, not read
    wgmma_fence();
    product_kk<D>(sa, kt, qs);  // S^T
    wgmma_commit();
    product_kk<D>(ga, vt, dos);  // dP^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(sa);
#pragma unroll
    for (int j = 0; j < 8; ++j)  // P^T, while dP^T runs
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + kq + (e & 1);  // this element's query in the tile
        const float p = __expf(__fsub_rn(__fmul_rn(sa[4 * j + e], scale), lss[c]));
        sa[4 * j + e] = lim < 64 && c >= lim ? 0.f : p;
      }
    wgmma_wait<0>();
    fence_acc(ga);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + kq + (e & 1);
        const float g =
            __fmul_rn(__fmul_rn(__fsub_rn(ga[4 * j + e], dis[c]), sa[4 * j + e]), scale);
        ga[4 * j + e] = lim < 64 && c >= lim ? 0.f : g;
      }
    uint32_t pf[4][4], gf[4][4];
    to_a_frags(pf, sa);
    to_a_frags(gf, ga);
    fence_frags(pf);
    fence_frags(gf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<D>(dva, pf[kk], desc_mn<D>(dos, kk), 1);  // dV += P^T dO
      wgmma_rs<D>(dka, gf[kk], desc_mn<D>(qs, kk), 1);   // dK += dS^T Q
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dva);
    fence_acc(dka);
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  const int r0 = kw + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + half * 8;
      if (r < L) {
        const size_t o = ((size_t)b * L + r) * H * D + h * D + j * 8 + kq;
        *reinterpret_cast<uint32_t*>(dk + o) =
            pack_bf16(dka[4 * j + 2 * half], dka[4 * j + 2 * half + 1]);
        *reinterpret_cast<uint32_t*>(dv + o) =
            pack_bf16(dva[4 * j + 2 * half], dva[4 * j + 2 * half + 1]);
      }
    }
}

// bf16 dQ on Hopper: grid (ceil(L / (64 DQ_NC)), H, B), one CTA an SM of a
// producer and DQ_NC consumer warpgroups (three; two at D = 128, whose dQ
// accumulator needs the registers). The producer loads each consumer's 64
// queries of Q and dO once, then streams 64-key tiles of K and V, which
// the consumers share: each K and V tile is read from L2 once per 192
// queries (the traffic, not the products, is what bounds this kernel, as
// attention.cuh's whole-row kernel). A consumer computes S = Q K^T and dP =
// dO V^T on wgmma from shared memory, P and dS in f32 registers from its
// rows' lse and di, and dQ += dS(bf16) K with dS as register A fragments
// and K MN-major; dQ stays in f32 registers to the end.
template <int D> constexpr int DQ_NC = D == 128 ? 2 : 3;

template <int D> constexpr size_t dq_smem_bytes() {
  return 1024 + (2 * DQ_NC<D> + 2 * BW_STAGES) * (size_t)RowTile<D>::BYTES +
         8 * (1 + 2 * BW_STAGES);
}

template <int D>
__global__ void __launch_bounds__(128 * (DQ_NC<D> + 1), 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ stats, int L, int Lp, float scale,
                          bf16* __restrict__ dq) {
  using T = RowTile<D>;
  constexpr int NC = DQ_NC<D>;
  using Regs = RegSplit<NC + 1, 1>;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* base = align1024(wg_smem);
  bf16* Qs = reinterpret_cast<bf16*>(base);  // [NC][64][D]
  bf16* dOs = Qs + NC * T::ELEMS;             // [NC][64][D]
  bf16* Ks = dOs + NC * T::ELEMS;             // [STAGES][64][D]
  bf16* Vs = Ks + BW_STAGES * T::ELEMS;       // [STAGES][64][D]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(Vs + BW_STAGES * T::ELEMS);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + BW_STAGES;
  const int q0 = blockIdx.x * 64 * NC, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int nk = (L + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    reg_dealloc<Regs::PRODUCER>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(qfull, 2 * NC * T::BYTES);
      for (int w = 0; w < NC; ++w) {
        tma_tile<D>(Qs + w * T::ELEMS, &tq, qfull, h, q0 + 64 * w, b);
        tma_tile<D>(dOs + w * T::ELEMS, &tdo, qfull, h, q0 + 64 * w, b);
      }
      for (int t = 0; t < nk; ++t) {
        const int s = t % BW_STAGES;
        mbar_wait(&empty[s], ((t / BW_STAGES) & 1) ^ 1);
        mbar_arrive_tx(&full[s], 2 * T::BYTES);
        tma_tile<D>(Ks + s * T::ELEMS, &tk, &full[s], h, t * 64, b);
        tma_tile<D>(Vs + s * T::ELEMS, &tv, &full[s], h, t * 64, b);
      }
    }
    return;
  }

  reg_alloc<Regs::CONSUMER>();
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, lane = tid & 31,
            warp = tid >> 5;
  const int kq = (lane & 3) * 2;
  const int r0 = q0 + 64 * wg + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const bf16 *Qw = Qs + wg * T::ELEMS, *dOw = dOs + wg * T::ELEMS;
  const float* srow = stats + ((size_t)b * H + h) * 2 * Lp;  // di, then lse
  const float di0 = r0 < L ? srow[r0] : 0.f, di1 = r1 < L ? srow[r1] : 0.f;
  const float lse0 = r0 < L ? srow[Lp + r0] : 0.f, lse1 = r1 < L ? srow[Lp + r1] : 0.f;
  float dqa[D / 2] = {};
  mbar_wait(qfull, 0);
  for (int t = 0; t < nk; ++t) {
    const int s = t % BW_STAGES;
    const bf16 *ks_ = Ks + s * T::ELEMS, *vs_ = Vs + s * T::ELEMS;
    mbar_wait(&full[s], (t / BW_STAGES) & 1);
    float sa[32], ga[32];  // fresh each tile: written by the products, not read
    wgmma_fence();
    product_kk<D>(sa, Qw, ks_);  // S
    wgmma_commit();
    product_kk<D>(ga, dOw, vs_);  // dP
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(sa);
#pragma unroll
    for (int j = 0; j < 8; ++j)  // P, while dP runs
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sa[4 * j + e] = __expf(__fsub_rn(__fmul_rn(sa[4 * j + e], scale), e < 2 ? lse0 : lse1));
    wgmma_wait<0>();
    fence_acc(ga);
    const int lim = L - t * 64;  // keys of this tile below L
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float g =
            __fmul_rn(__fmul_rn(__fsub_rn(ga[4 * j + e], e < 2 ? di0 : di1), sa[4 * j + e]), scale);
        ga[4 * j + e] = lim < 64 && j * 8 + kq + (e & 1) >= lim ? 0.f : g;
      }
    uint32_t gf[4][4];  // dS rounded to bf16 as A fragments, 16 keys each
    to_a_frags(gf, ga);
    fence_frags(gf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dqa, gf[kk], desc_mn<D>(ks_, kk), 1);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dqa);
    if (lane == 0) mbar_arrive(&empty[s]);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = h * D + j * 8 + kq;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(dq + ((size_t)b * L + r0) * H * D + c) =
          pack_bf16(dqa[4 * j], dqa[4 * j + 1]);
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(dq + ((size_t)b * L + r1) * H * D + c) =
          pack_bf16(dqa[4 * j + 2], dqa[4 * j + 3]);
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
                          const float* stats, int Lp, bf16* dq, bf16* dk, bf16* dv,
                          cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  int rc = bhld_map<D>(&tq, q, B, L, H, sb, sl, sh);
  if (!rc) rc = bhld_map<D>(&tk, k, B, L, H, sb, sl, sh);
  if (!rc) rc = bhld_map<D>(&tv, v, B, L, H, sb, sl, sh);
  if (!rc) rc = bhld_map<D>(&tdo, dout, B, L, H, (long long)L * H * D, (long long)H * D, D);
  static const int pool_kv =
      check_reg_pool(flash_bwd_dkv_wgmma_kernel<D>, RegSplit<DKV_NC + 1, 1>::NEED);
  static const int pool_q =
      check_reg_pool(flash_bwd_dq_wgmma_kernel<D>, RegSplit<DQ_NC<D> + 1, 1>::NEED);
  if (!rc) rc = pool_kv ? pool_kv : pool_q;
  if (rc) return rc;
  const float scale = attn_scale(D);
  constexpr size_t smem_kv = dkv_smem_bytes<D>(), smem_q = dq_smem_bytes<D>();
  cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_kv);
  const int kv_keys = 64 * DKV_NC;
  flash_bwd_dkv_wgmma_kernel<D><<<dim3((L + kv_keys - 1) / kv_keys, H, B), 128 * (DKV_NC + 1),
                                  smem_kv, st>>>(tq, tk, tv, tdo, stats, L, Lp, scale, dk, dv);
  PPT_CHECK_LAUNCH();
  cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_q);
  const int q_rows = 64 * DQ_NC<D>;
  flash_bwd_dq_wgmma_kernel<D><<<dim3((L + q_rows - 1) / q_rows, H, B), 128 * (DQ_NC<D> + 1),
                                 smem_q, st>>>(tq, tk, tv, tdo, stats, L, Lp, scale, dq);
  PPT_CHECK_LAUNCH();
  return 0;
}

// q, k, v strided as the forward takes them; o, dout, dq, dk, dv contiguous
// [B, L, H, D]; lse the forward's [B, H, L]; di an f32 scratch, [B, H, 2, Lp]
// (di and the lse, Lp = L rounded up to 64) in bf16, [B, H, L] in f32.
PPT_EXPORT int ppt_flash_mha_bwd(int dtype, const void* q, const void* k, const void* v, int B,
                                 int L, int H, int D, long long sb, long long sl, long long sh,
                                 const void* o, const void* dout, const void* lse, void* di,
                                 void* dq, void* dk, void* dv, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = B * L * H;
  const float* ls = (const float*)lse;
  float* dd = (float*)di;
  if (dtype == PPT_BF16) {
    const int Lp = (L + 63) / 64 * 64;
    const int blocks = (int)(((long long)rows * (D / 8) + 255) / 256);
    if (D == 32)
      flash_bwd_di_bf16_kernel<32><<<blocks, 256, 0, st>>>((const bf16*)o, (const bf16*)dout,
                                                           rows, L, H, ls, Lp, dd);
    else if (D == 64)
      flash_bwd_di_bf16_kernel<64><<<blocks, 256, 0, st>>>((const bf16*)o, (const bf16*)dout,
                                                           rows, L, H, ls, Lp, dd);
    else if (D == 128)
      flash_bwd_di_bf16_kernel<128><<<blocks, 256, 0, st>>>((const bf16*)o, (const bf16*)dout,
                                                            rows, L, H, ls, Lp, dd);
    else
      return (int)cudaErrorInvalidValue;
    PPT_CHECK_LAUNCH();
    const bf16 *qq = (const bf16*)q, *kk = (const bf16*)k, *vv = (const bf16*)v;
    const bf16* g = (const bf16*)dout;
    bf16 *gq = (bf16*)dq, *gk = (bf16*)dk, *gv = (bf16*)dv;
    if (D == 32)
      return flash_bwd_bf16<32>(qq, kk, vv, B, L, H, sb, sl, sh, g, dd, Lp, gq, gk, gv, st);
    if (D == 64)
      return flash_bwd_bf16<64>(qq, kk, vv, B, L, H, sb, sl, sh, g, dd, Lp, gq, gk, gv, st);
    if (D == 128)
      return flash_bwd_bf16<128>(qq, kk, vv, B, L, H, sb, sl, sh, g, dd, Lp, gq, gk, gv, st);
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
