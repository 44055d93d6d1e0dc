// Whole-row multi-head attention, shared by the ViT block (vitblock.cu,
// where q, k and v are column slices of the block's qkv product) and the
// standalone fused_mha entry point (attention.cu). One implementation, so
// the block's attention and fused_mha's agree bit for bit.
//
// Layout: q, k and v are [B, L, H, D] with D contiguous and shared strides
// (sb, sl, sh) in elements for batch, token and head; a strided view of a
// [B, L, 3C] qkv product has sb = 3CL, sl = 3C, sh = D. out is a
// contiguous [B, L, H, D].
//
// Rounding is the TPU kernel's (ppt_tpu/kernels/attention.py:_mha_kernel,
// and the block's _block_body): f32 scores times the f32 scale, the row
// max over ALL keys, p = exp(s - m) in f32, p rounded to the compute dtype
// before P @ V, the f32 accumulator divided by the f32 denominator at the
// end. No online rescale: a two-pass sweep keeps exactly that rounding.
//
// Kernels: f32 runs FMA on the CUDA cores (attention_f32_kernel); bf16 runs
// attention_wgmma_kernel, warp-specialised on TMA and wgmma (hopper.cuh).
// attention_bf16_kernel, on mma.sync, is the ViT-block ablation probe's own
// kernel for the modes the Hopper kernel does not take; no production path
// reaches it.
//
// The kernels are templated on an attention mode and a row count for the
// ablation probe (ppt_torch/tools/vitblock_probe.py, the port of
// ppt_tpu/tools/vitblock_probe.py:_variant_kernel); the production kernels
// are the defaults, ATT_SOFTMAX and R = 1, and their code path is the one
// above:
//   ATT_RAW      the masked raw scaled scores (invalid keys 0) rounded to
//                the compute dtype are P: no max, exp, sum or divide;
//   ATT_PV_ONES  p = exp(s - m) rounded to the dtype; the denominator is a
//                ones column appended to V in the P @ V product (f32 sum of
//                the rounded p), not a separate f32 sum;
//   ATT_PACKED2  two heads per launch: Q of the pair (2d wide) against a
//                block-diagonal K (depth 2d, half of it zeros) and P of
//                both heads against a block-diagonal V (2d wide): twice the
//                products of the plain head, the same sums;
//   R            clouds per block: a block walks R batch entries in turn.
// In bf16, ATT_SOFTMAX and ATT_RAW (R = 1 or 2) run the Hopper kernel;
// ATT_PV_ONES and ATT_PACKED2 run attention_bf16_kernel.
#pragma once

#include <type_traits>

#include "hopper.cuh"

constexpr int MHA_TQ = 32, MHA_TK = 64;
enum { ATT_SOFTMAX = 0, ATT_RAW = 1, ATT_PV_ONES = 2, ATT_PACKED2 = 3 };

// f32: grid (ceil(L / 32), H, B / R), 256 threads, D <= 128 and a multiple
// of 8; a 32-query tile's whole score rows sit in shared memory. In
// ATT_PACKED2, H counts head pairs, D is the pair's width 2d, and a row
// holds both heads' scores, [2][L].
template <int MODE = ATT_SOFTMAX, int R = 1>
__global__ void __launch_bounds__(256)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, long long sb, long long sl, long long sh,
                     int L, int D, float scale, float* __restrict__ out) {
  constexpr int NH = MODE == ATT_PACKED2 ? 2 : 1;  // key halves (heads of a pair)
  extern __shared__ float sm[];
  const int LS = NH * L;                 // score columns per row
  float* Qs = sm;                        // [TQ][D]
  float* KV = Qs + MHA_TQ * D;           // [TK][D + 1]
  float* S = KV + MHA_TK * (D + 1);      // [TQ][LS]
  float* den = S + (size_t)MHA_TQ * LS;  // [TQ][NH]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * MHA_TQ, h = blockIdx.y, H = gridDim.y;
  const int nq = min(MHA_TQ, L - q0);
  const int dh = D / NH;  // a half's columns (ATT_PACKED2)

  // a K or V element of key tile row j, column d; block-diagonal in ATT_PACKED2
  auto kv_elem = [&](const float* src, int k0, int j, int d, int half) {
    if (NH == 2 && d / dh != half) return 0.f;
    return src[(size_t)(k0 + j) * sl + d];
  };

  for (int rr = 0; rr < R; ++rr) {
  const int b = blockIdx.z * R + rr;
  const size_t off = (size_t)b * sb + (size_t)h * sh;
  const float *qb = q + off, *kb = k + off, *vb = v + off;
  if (rr) __syncthreads();  // the previous entry's readers of Qs, S and den are done

  for (int e = tid; e < MHA_TQ * D; e += 256) {
    const int r = e / D, d = e % D;
    Qs[e] = r < nq ? qb[(size_t)(q0 + r) * sl + d] : 0.f;
  }

  // pass 1: scores
  for (int half = 0; half < NH; ++half)
  for (int k0 = 0; k0 < L; k0 += MHA_TK) {
    const int nk = min(MHA_TK, L - k0);
    __syncthreads();
    for (int e = tid; e < MHA_TK * D; e += 256) {
      const int j = e / D, d = e % D;
      KV[j * (D + 1) + d] = j < nk ? kv_elem(kb, k0, j, d, half) : 0.f;
    }
    __syncthreads();
    const int j = tid & (MHA_TK - 1);
    if (j < nk) {
      for (int r = tid >> 6; r < nq; r += 4) {
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(Qs[r * D + d], KV[j * (D + 1) + d], s);
        S[(size_t)r * LS + half * L + k0 + j] = __fmul_rn(s, scale);
      }
    }
  }
  __syncthreads();

  // softmax numerators and f32 denominators, one warp per row and half
  // (ATT_RAW: the scores are P as they stand)
  if constexpr (MODE != ATT_RAW) {
    for (int r = warp; r < nq; r += 8) {
      for (int half = 0; half < NH; ++half) {
        float* row = S + (size_t)r * LS + half * L;
        float m = -INFINITY;
        for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
        for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        float sum = 0.f;
        for (int j = lane; j < L; j += 32) {
          const float p = expf(__fsub_rn(row[j], m));
          row[j] = p;
          sum += p;
        }
        if constexpr (MODE != ATT_PV_ONES) {
          for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
          if (lane == 0) den[r * NH + half] = sum;
        }
      }
    }
  }

  // pass 2: P @ V (ATT_PV_ONES: thread r < nq also sums row r against the
  // ones column, in key order)
  constexpr int MAXE = MHA_TQ * 128 / 256;
  float acc[MAXE];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) acc[e] = 0.f;
  float ones_acc = 0.f;
  const int nE = (MHA_TQ * D) / 256;  // D multiple of 8
  for (int half = 0; half < NH; ++half)
  for (int k0 = 0; k0 < L; k0 += MHA_TK) {
    const int nk = min(MHA_TK, L - k0);
    __syncthreads();
    for (int e = tid; e < MHA_TK * D; e += 256) {
      const int j = e / D, d = e % D;
      KV[j * (D + 1) + d] = j < nk ? kv_elem(vb, k0, j, d, half) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      if (e < nE) {
        const int idx = tid + 256 * e, r = idx / D, d = idx % D;
        if (r < nq) {
          const float* prow = S + (size_t)r * LS + half * L + k0;
          float a = acc[e];
          for (int j = 0; j < nk; ++j) a = fmaf(prow[j], KV[j * (D + 1) + d], a);
          acc[e] = a;
        }
      }
    }
    if constexpr (MODE == ATT_PV_ONES) {
      if (tid < nq) {
        const float* prow = S + (size_t)tid * LS + k0;
        for (int j = 0; j < nk; ++j) ones_acc = fmaf(prow[j], 1.f, ones_acc);
      }
    }
  }
  if constexpr (MODE == ATT_PV_ONES) {
    if (tid < nq) den[tid] = ones_acc;
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    if (e < nE) {
      const int idx = tid + 256 * e, r = idx / D, d = idx % D;
      if (r < nq) {
        float o = acc[e];
        if constexpr (MODE != ATT_RAW) o = __fdiv_rn(o, den[r * NH + d / dh]);
        out[((size_t)b * L + q0 + r) * H * D + h * D + d] = o;
      }
    }
  }
  }
}

// bf16 on mma.sync, the ablation probe's kernel for ATT_PV_ONES and
// ATT_PACKED2: grid (ceil(L / 64), H, B / R), 4 warps of 16 queries each,
// mma.sync for both products, no score matrix in memory. Pass 1 sweeps the key
// tiles for the row max; pass 2 recomputes the scores, forms
// p = exp(s - m) in f32 (summed in f32 for the denominator), rounds p to
// bf16 straight from the accumulator registers into the A fragments of
// P @ V, and divides the f32 result by the denominator at the end.
// Needs 16-byte aligned rows: q, k, v and sb, sl, sh multiples of 8.
// ATT_PACKED2 sweeps each pass once per head of the pair (D is the pair's
// width 2d), with a row max and a denominator per head; ATT_PV_ONES adds
// one 8-wide n-tile to P @ V whose first column is ones.
template <int D, int MODE, int R = 1>
__global__ void __launch_bounds__(128)
attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, long long sb, long long sl, long long sh,
                      int L, float scale, bf16* __restrict__ out) {
  constexpr int LD = D + 8, KS = D / 16;
  constexpr int NH = MODE == ATT_PACKED2 ? 2 : 1, DH = D / NH;
  __shared__ __align__(16) bf16 Ks[MHA_TK * LD];
  __shared__ __align__(16) bf16 Vs[MHA_TK * LD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, H = gridDim.y;
  const int r0 = blockIdx.x * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int kq = (lane & 3) * 2;

  for (int rr = 0; rr < R; ++rr) {
  const int b = blockIdx.z * R + rr;
  const size_t off = (size_t)b * sb + (size_t)h * sh;
  const bf16 *qb = q + off, *kb = k + off, *vb = v + off;

  uint32_t qf[KS][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bf16* q0p = qb + (size_t)r0 * sl + ks * 16 + kq;
    const bf16* q1p = qb + (size_t)r1 * sl + ks * 16 + kq;
    qf[ks][0] = r0 < L ? *reinterpret_cast<const uint32_t*>(q0p) : 0u;
    qf[ks][1] = r1 < L ? *reinterpret_cast<const uint32_t*>(q1p) : 0u;
    qf[ks][2] = r0 < L ? *reinterpret_cast<const uint32_t*>(q0p + 8) : 0u;
    qf[ks][3] = r1 < L ? *reinterpret_cast<const uint32_t*>(q1p + 8) : 0u;
  }

  // 64 keys x D, zero past L; ATT_PACKED2 keeps only head `half`'s columns
  auto load_tile = [&](bf16* dst, const bf16* src, int k0, int half) {
    for (int e = tid; e < MHA_TK * (D / 8); e += 128) {
      const int j = e / (D / 8), c = (e % (D / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + j < L && (NH == 1 || c / DH == half))
        val = *reinterpret_cast<const uint4*>(src + (size_t)(k0 + j) * sl + c);
      *reinterpret_cast<uint4*>(dst + j * LD + c) = val;
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
        uint32_t kf[4];
        ldmatrix_x4(kf, Ks + (p * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * p], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * p + 1], qf[ks], kf[2], kf[3]);
      }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = k0 + nt * 8 + kq + (e & 1) < L ? __fmul_rn(s[nt][e], scale) : -INFINITY;
  };

  // pass 1: row max over all keys, per head of the pair
  float m0[NH], m1[NH];
#pragma unroll
  for (int half = 0; half < NH; ++half) {
    m0[half] = -INFINITY;
    m1[half] = -INFINITY;
    for (int k0 = 0; k0 < L; k0 += MHA_TK) {
      __syncthreads();
      load_tile(Ks, kb, k0, half);
      __syncthreads();
      float s[8][4];
      scores(s, k0);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        m0[half] = fmaxf(m0[half], fmaxf(s[nt][0], s[nt][1]));
        m1[half] = fmaxf(m1[half], fmaxf(s[nt][2], s[nt][3]));
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {  // the 4 lanes of a row
      m0[half] = fmaxf(m0[half], __shfl_xor_sync(0xffffffffu, m0[half], o));
      m1[half] = fmaxf(m1[half], __shfl_xor_sync(0xffffffffu, m1[half], o));
    }
  }

  // pass 2: P @ V and the f32 denominators
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float d0[NH], d1[NH];
  float ones_o[4] = {0.f, 0.f, 0.f, 0.f};  // ATT_PV_ONES: the ones column's n-tile
  // B fragment of an 8-wide tile whose column 0 is ones: lanes 0-3 hold column 0
  const uint32_t ones_b = lane < 4 ? pack_bf16(1.f, 1.f) : 0u;
#pragma unroll
  for (int half = 0; half < NH; ++half) {
    d0[half] = 0.f;
    d1[half] = 0.f;
    for (int k0 = 0; k0 < L; k0 += MHA_TK) {
      __syncthreads();
      load_tile(Ks, kb, k0, half);
      load_tile(Vs, vb, k0, half);
      __syncthreads();
      float s[8][4];
      scores(s, k0);
      uint32_t pf[4][4];  // P as A fragments, 16 keys each
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float p0 = expf(__fsub_rn(s[nt][0], m0[half]));
        const float p1 = expf(__fsub_rn(s[nt][1], m0[half]));
        const float p2 = expf(__fsub_rn(s[nt][2], m1[half]));
        const float p3 = expf(__fsub_rn(s[nt][3], m1[half]));
        if constexpr (MODE != ATT_PV_ONES) {
          d0[half] += p0 + p1;
          d1[half] += p2 + p3;
        }
        pf[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
        pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int p = 0; p < D / 16; ++p) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, Vs + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                    p * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * p], pf[ks], vf[0], vf[1]);
          mma_bf16(o[2 * p + 1], pf[ks], vf[2], vf[3]);
        }
        if constexpr (MODE == ATT_PV_ONES) mma_bf16(ones_o, pf[ks], ones_b, ones_b);
      }
    }
#pragma unroll
    for (int off2 = 1; off2 <= 2; off2 <<= 1) {
      d0[half] += __shfl_xor_sync(0xffffffffu, d0[half], off2);
      d1[half] += __shfl_xor_sync(0xffffffffu, d1[half], off2);
    }
  }
  if constexpr (MODE == ATT_PV_ONES) {  // column 0 of the ones tile: lane 4(l/4), e 0 and 2
    d0[0] = __shfl_sync(0xffffffffu, ones_o[0], lane & ~3);
    d1[0] = __shfl_sync(0xffffffffu, ones_o[2], lane & ~3);
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1;
      const int half = (dt * 8) / DH;
      const float val = __fdiv_rn(o[dt][e], e < 2 ? d0[half] : d1[half]);
      if (r < L) out[((size_t)b * L + r) * H * D + h * D + dt * 8 + kq + (e & 1)] =
          __float2bfloat16_rn(val);
    }
  }
}

// the scale as JAX forms it: 1/sqrt(d) in double, then rounded to f32
static inline float attn_scale(int D) { return (float)(1.0 / sqrt((double)D)); }

static int whole_row_attention(const float* q, const float* k, const float* v, int B, int L,
                               int H, int D, long long sb, long long sl, long long sh,
                               float* out, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)MHA_TQ * D + MHA_TK * (D + 1) + (size_t)MHA_TQ * L + MHA_TQ);
  cudaFuncSetAttribute(attention_f32_kernel<>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((L + MHA_TQ - 1) / MHA_TQ, H, B);
  attention_f32_kernel<><<<grid, 256, smem, st>>>(q, k, v, sb, sl, sh, L, D, attn_scale(D), out);
  PPT_CHECK_LAUNCH();
  return 0;
}

// bf16 on Hopper: the production kernel behind whole_row_attention(bf16).
// Grid (ceil(L / (64 WR_NC)), H, B / R), one CTA an SM of a producer and
// WR_NC consumer warpgroups. The producer's one thread issues every load
// by TMA, and its warpgroup gives up registers (setmaxnreg) to the
// consumers, each of which owns 64 query rows and runs both products on
// wgmma: S = Q K^T with Q and K from shared memory (k16 steps over D), P V
// with P in registers, rounded from the f32 accumulator straight into A
// fragments, and V MN-major. Two passes, because the rounding contract
// above wants the row max over all keys before any exp: pass 1 computes S
// only for the max, pass 2 again for p = exp(s - m), the f32 denominator
// (from the unrounded p) and P V; one division at the end.
//
// Traffic from L2 into shared memory bounds a design that streams every
// tile to every 64-row query tile: at D = 64 such a tile does 64 FLOP a
// byte it reads, and a first version (one consumer a CTA, K read twice)
// drew ~373 MB from L2 at [32, 513, 6, 64] and ran no faster than the
// mma.sync kernel it replaced (PERF.md). Hence three consumers share each
// K and V tile, and K stays resident: for D <= 64 and L <= 1024 (KRES) the
// producer loads all of the head's K once, each tile to its own mbarrier,
// both passes read it from shared memory, and only V streams, through a
// ring of WR_STAGES stages, each guarded by a full and an empty mbarrier;
// D = 128 (or a longer L) streams K in pass 1 and K with V in pass 2
// through the ring. A tile's P V product is waited for with the next
// tile's scores; a consumer still waits for each tile's scores before its
// exp, as the 160 registers of a three-consumer split leave no room for a
// second score tile in flight (measured slower: ptxas serialises the
// products). The exp is the f32 fast exp (ex2 of x log2 e), and a tile
// holding no key past L skips the masking. Rows and keys past L arrive
// zero-filled and keys past L are masked (p = 0). At L = 513 the last key
// tile holds one key and the last CTA's third consumer one query row; each
// is computed whole (~11% of the products), as a product cut short on one
// path only would make ptxas serialise the others. ATT_RAW (the probe's
// mm_only and no_softmax) makes pass 2 alone with P the masked raw scaled
// scores and no division; R = 2 (the probe's rows = 2) walks two batch
// entries a CTA, Q and resident K reloaded once the consumers release
// them. D in {16, 32, 64, 128}.

// consumer warpgroups a CTA, 64 query rows each (two at D = 128, whose P V
// accumulator needs the registers)
template <int D> constexpr int WR_NC = D == 128 ? 2 : 3;
constexpr int WR_STAGES = 4;      // ring depth
constexpr int WR_KRES_TILES = 16;  // key tiles K-resident attention holds (L <= 1024)

template <int D, bool KRES> static size_t wr_smem_bytes(int L) {
  const size_t nt = (L + 63) / 64;
  const size_t tiles = WR_NC<D> + (KRES ? nt + WR_STAGES : 2 * WR_STAGES);
  return 1024 + tiles * RowTile<D>::BYTES + 8 * (2 + 2 * WR_STAGES + WR_KRES_TILES);
}

// p for one 64-key tile of scores s (C-fragment order): exp(s scale - m)
// (ATT_RAW: s scale), 0 for the keys at or past lim; the f32 row sums go
// to d0 / d1 and p, rounded to bf16, to the A fragments of four k16 steps
template <int MODE, bool MASK>
__device__ __forceinline__ void softmax_tile(const float (&s)[32], float scale, float m0,
                                             float m1, int lim, int kq, uint32_t (&pf)[4][4],
                                             float& d0, float& d1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = __fmul_rn(s[4 * j + e], scale);
      p[e] = MODE == ATT_RAW ? x : __expf(__fsub_rn(x, e < 2 ? m0 : m1));
      if (MASK && j * 8 + kq + (e & 1) >= lim) p[e] = 0.f;
    }
    if constexpr (MODE != ATT_RAW) {
      d0 += p[0] + p[1];
      d1 += p[2] + p[3];
    }
    pf[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
    pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
}

template <int D, int MODE, bool KRES, int R>
__global__ void __launch_bounds__(128 * (WR_NC<D> + 1), 1)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, int L, float scale,
                       bf16* __restrict__ out) {
  using T = RowTile<D>;
  constexpr int NS = WR_STAGES, NC = WR_NC<D>;
  using Regs = RegSplit<NC + 1, 1>;
  constexpr bool TWO_PASS = MODE != ATT_RAW;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const int q0 = blockIdx.x * 64 * NC, h = blockIdx.y, H = gridDim.y;
  const int nt = (L + 63) / 64;
  unsigned char* base = align1024(wg_smem);
  bf16* Qs = reinterpret_cast<bf16*>(base);    // [NC][64][D]
  bf16* Kr = Qs + NC * T::ELEMS;               // KRES: [nt][64][D]
  bf16* Ks = Kr + (KRES ? nt : 0) * T::ELEMS;  // !KRES: [NS][64][D]
  bf16* Vs = Ks + (KRES ? 0 : NS) * T::ELEMS;  // [NS][64][D]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(Vs + NS * T::ELEMS);
  uint64_t* qempty = qfull + 1;  // R = 2: Q (and resident K) free for the next entry
  uint64_t* full = qempty + 1;
  uint64_t* empty = full + NS;
  uint64_t* kfull = empty + NS;  // KRES: [nt]

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, 4 * NC);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);  // one arrival per consumer warp
    }
    if (KRES)
      for (int t = 0; t < nt; ++t) mbar_init(&kfull[t], 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    reg_dealloc<Regs::PRODUCER>();
    if (threadIdx.x == 0) {
      int it = 0;  // ring tiles loaded
      for (int rr = 0; rr < R; ++rr) {
        const int b = blockIdx.z * R + rr;
        if (rr) mbar_wait(qempty, (rr - 1) & 1);
        mbar_arrive_tx(qfull, NC * T::BYTES);
        for (int w = 0; w < NC; ++w)
          tma_tile<D>(Qs + w * T::ELEMS, &tq, qfull, h, q0 + 64 * w, b);
        if (KRES)
          for (int t = 0; t < nt; ++t) {
            mbar_arrive_tx(&kfull[t], T::BYTES);
            tma_tile<D>(Kr + t * T::ELEMS, &tk, &kfull[t], h, t * 64, b);
          }
        // the ring: V (KRES), else K in pass 1 and K with V in pass 2
        const int total = KRES || !TWO_PASS ? nt : 2 * nt;
        for (int i = 0; i < total; ++i, ++it) {
          const int s = it % NS;
          mbar_wait(&empty[s], ((it / NS) & 1) ^ 1);
          const bool pv = KRES || !TWO_PASS || i >= nt;
          const int k0 = (i < nt ? i : i - nt) * 64;
          mbar_arrive_tx(&full[s], ((KRES ? 0 : 1) + (pv ? 1 : 0)) * T::BYTES);
          if (!KRES) tma_tile<D>(Ks + s * T::ELEMS, &tk, &full[s], h, k0, b);
          if (pv) tma_tile<D>(Vs + s * T::ELEMS, &tv, &full[s], h, k0, b);
        }
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
  // S = Q K^T against key tile kt, f32 (C-fragment order); acc is written,
  // not read (a fresh array each tile keeps it dead between tiles). Its
  // wait also retires the P V product issued before it.
  auto scores = [&](float (&acc)[32], const bf16* kt) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<64>(acc, desc_k<D>(Qw, ks), desc_k<D>(kt, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  };
  int it = 0;  // ring tiles consumed

  for (int rr = 0; rr < R; ++rr) {
    const int b = blockIdx.z * R + rr;
    mbar_wait(qfull, rr & 1);
    float m0 = -INFINITY, m1 = -INFINITY;
    if constexpr (TWO_PASS) {  // pass 1: the row max over all keys
      for (int t = 0; t < nt; ++t) {
        const bf16* kt;
        if constexpr (KRES) {
          mbar_wait(&kfull[t], rr & 1);
          kt = Kr + t * T::ELEMS;
        } else {
          mbar_wait(&full[it % NS], (it / NS) & 1);
          kt = Ks + (it % NS) * T::ELEMS;
        }
        float s[32];
        scores(s, kt);
        if (!KRES && lane == 0) mbar_arrive(&empty[it % NS]);
        if (!KRES) ++it;
        const int lim = L - t * 64;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e];
            if (lim < 64 && j * 8 + kq + (e & 1) >= lim) x = -INFINITY;
            if (e < 2) m0 = fmaxf(m0, x);
            else m1 = fmaxf(m1, x);
          }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {  // the 4 lanes of a row
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
      }
      // the max of the scaled scores: rounding s * scale is monotone in s
      // (scale > 0), so scaling the raw max gives the same bits
      m0 = __fmul_rn(m0, scale);
      m1 = __fmul_rn(m1, scale);
    }

    // pass 2: P V and the f32 denominators; a tile's P V is waited for with
    // the next tile's scores, and its ring slot released then
    float o[D / 2] = {};
    float d0 = 0.f, d1 = 0.f;
    int prev = -1;  // the ring slot whose P V is in flight
    for (int t = 0; t < nt; ++t, ++it) {
      const int st = it % NS;
      if (KRES && !TWO_PASS) mbar_wait(&kfull[t], rr & 1);
      mbar_wait(&full[st], (it / NS) & 1);
      float s[32];
      scores(s, KRES ? Kr + t * T::ELEMS : Ks + st * T::ELEMS);
      if (prev >= 0) {
        fence_acc(o);
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      uint32_t pf[4][4];  // P as A fragments, 16 keys each
      const int lim = L - t * 64;
      if (lim >= 64) softmax_tile<MODE, false>(s, scale, m0, m1, lim, kq, pf, d0, d1);
      else softmax_tile<MODE, true>(s, scale, m0, m1, lim, kq, pf, d0, d1);
      fence_frags(pf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o, pf[kk], desc_mn<D>(Vs + st * T::ELEMS, kk), 1);
      wgmma_commit();
      prev = st;
    }
    wgmma_wait<0>();
    fence_acc(o);
    if (lane == 0) {
      mbar_arrive(&empty[prev]);
      mbar_arrive(qempty);  // this entry's Q and resident K are read
    }

    if constexpr (MODE != ATT_RAW) {
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        d0 += __shfl_xor_sync(0xffffffffu, d0, x);
        d1 += __shfl_xor_sync(0xffffffffu, d1, x);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      float v0 = o[4 * j], v1 = o[4 * j + 1], v2 = o[4 * j + 2], v3 = o[4 * j + 3];
      if constexpr (MODE != ATT_RAW) {
        v0 = __fdiv_rn(v0, d0);
        v1 = __fdiv_rn(v1, d0);
        v2 = __fdiv_rn(v2, d1);
        v3 = __fdiv_rn(v3, d1);
      }
      const int c = h * D + j * 8 + kq;
      if (r0 < L)
        *reinterpret_cast<uint32_t*>(out + ((size_t)b * L + r0) * H * D + c) = pack_bf16(v0, v1);
      if (r1 < L)
        *reinterpret_cast<uint32_t*>(out + ((size_t)b * L + r1) * H * D + c) = pack_bf16(v2, v3);
    }
  }
}

template <int D, int MODE, bool KRES, int R>
static int whole_row_launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                            int B, int L, int H, bf16* out, cudaStream_t st) {
  constexpr int NC = WR_NC<D>;
  auto kernel = attention_wgmma_kernel<D, MODE, KRES, R>;
  static const int pool = check_reg_pool(kernel, RegSplit<NC + 1, 1>::NEED);
  if (pool) return pool;
  const size_t smem = wr_smem_bytes<D, KRES>(L);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((L + 64 * NC - 1) / (64 * NC), H, B / R);
  kernel<<<grid, 128 * (NC + 1), smem, st>>>(tq, tk, tv, L, attn_scale(D), out);
  PPT_CHECK_LAUNCH();
  return 0;
}

// MODE ATT_SOFTMAX (production) or ATT_RAW, R clouds a CTA (the probe's rows
// = 2), D in {16, 32, 64, 128}
template <int MODE, int R>
static int whole_row_wgmma(const bf16* q, const bf16* k, const bf16* v, int B, int L, int H,
                           int D, long long sb, long long sl, long long sh, bf16* out,
                           cudaStream_t st) {
  if (B % R) return (int)cudaErrorInvalidValue;
  auto run = [&](auto d) -> int {
    constexpr int DD = decltype(d)::value;
    CUtensorMap tq, tk, tv;
    int rc = bhld_map<DD>(&tq, q, B, L, H, sb, sl, sh);
    if (!rc) rc = bhld_map<DD>(&tk, k, B, L, H, sb, sl, sh);
    if (!rc) rc = bhld_map<DD>(&tv, v, B, L, H, sb, sl, sh);
    if (rc) return rc;
    if constexpr (DD <= 64) {
      if (L <= 64 * WR_KRES_TILES)
        return whole_row_launch<DD, MODE, true, R>(tq, tk, tv, B, L, H, out, st);
    }
    return whole_row_launch<DD, MODE, false, R>(tq, tk, tv, B, L, H, out, st);
  };
  switch (D) {
    case 16: return run(std::integral_constant<int, 16>{});
    case 32: return run(std::integral_constant<int, 32>{});
    case 64: return run(std::integral_constant<int, 64>{});
    case 128: return run(std::integral_constant<int, 128>{});
  }
  return (int)cudaErrorInvalidValue;
}

static int whole_row_attention(const bf16* q, const bf16* k, const bf16* v, int B, int L, int H,
                               int D, long long sb, long long sl, long long sh, bf16* out,
                               cudaStream_t st) {
  return whole_row_wgmma<ATT_SOFTMAX, 1>(q, k, v, B, L, H, D, sb, sl, sh, out, st);
}

// The probe's attention (MODE, R as in the header). H and D are the block's
// heads and head dim: ATT_PACKED2 launches H / 2 pairs of width 2D, with
// the scale of the head dim D.
template <int MODE, int R>
static int attention_variant(const float* q, const float* k, const float* v, int B, int L,
                             int H, int D, long long sb, long long sl, long long sh, float* out,
                             cudaStream_t st) {
  constexpr int NH = MODE == ATT_PACKED2 ? 2 : 1;
  if (B % R || H % NH) return (int)cudaErrorInvalidValue;
  const int Dl = NH * D;
  const size_t smem = sizeof(float) * ((size_t)MHA_TQ * Dl + MHA_TK * (Dl + 1) +
                                       (size_t)MHA_TQ * NH * L + MHA_TQ * NH);
  cudaFuncSetAttribute(attention_f32_kernel<MODE, R>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((L + MHA_TQ - 1) / MHA_TQ, H / NH, B / R);
  attention_f32_kernel<MODE, R><<<grid, 256, smem, st>>>(q, k, v, sb, sl, sh * NH, L, Dl,
                                                         attn_scale(D), out);
  PPT_CHECK_LAUNCH();
  return 0;
}

// bf16: ATT_SOFTMAX and ATT_RAW on the Hopper kernel, R = 1 or 2; the other
// modes on the probe's mma.sync kernel
template <int MODE, int R>
static int attention_variant(const bf16* q, const bf16* k, const bf16* v, int B, int L, int H,
                             int D, long long sb, long long sl, long long sh, bf16* out,
                             cudaStream_t st) {
  if constexpr (MODE == ATT_SOFTMAX || MODE == ATT_RAW) {
    return whole_row_wgmma<MODE, R>(q, k, v, B, L, H, D, sb, sl, sh, out, st);
  } else {
    constexpr int NH = MODE == ATT_PACKED2 ? 2 : 1;
    if (B % R || H % NH) return (int)cudaErrorInvalidValue;
    const int Dl = NH * D;
    const float scale = attn_scale(D);
    dim3 grid((L + 63) / 64, H / NH, B / R);
    sh *= NH;
    if (NH == 1 && Dl == 16)
      attention_bf16_kernel<16, NH == 1 ? MODE : ATT_PV_ONES, R>
          <<<grid, 128, 0, st>>>(q, k, v, sb, sl, sh, L, scale, out);
    else if (Dl == 32)
      attention_bf16_kernel<32, MODE, R><<<grid, 128, 0, st>>>(q, k, v, sb, sl, sh, L, scale,
                                                               out);
    else if (Dl == 64)
      attention_bf16_kernel<64, MODE, R><<<grid, 128, 0, st>>>(q, k, v, sb, sl, sh, L, scale,
                                                               out);
    else if (Dl == 128)
      attention_bf16_kernel<128, MODE, R><<<grid, 128, 0, st>>>(q, k, v, sb, sl, sh, L, scale,
                                                                out);
    else
      return (int)cudaErrorInvalidValue;
    PPT_CHECK_LAUNCH();
    return 0;
  }
}
