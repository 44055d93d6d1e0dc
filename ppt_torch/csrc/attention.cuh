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
#pragma once

#include "common.cuh"

constexpr int MHA_TQ = 32, MHA_TK = 64;

// f32: grid (ceil(L / 32), H, B), 256 threads, D <= 128 and a multiple of
// 8; a 32-query tile's whole score rows sit in shared memory.
__global__ void __launch_bounds__(256)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, long long sb, long long sl, long long sh,
                     int L, int D, float scale, float* __restrict__ out) {
  extern __shared__ float sm[];
  float* Qs = sm;                        // [TQ][D]
  float* KV = Qs + MHA_TQ * D;           // [TK][D + 1]
  float* S = KV + MHA_TK * (D + 1);      // [TQ][L]
  float* den = S + (size_t)MHA_TQ * L;   // [TQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * MHA_TQ, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int nq = min(MHA_TQ, L - q0);
  const size_t off = (size_t)b * sb + (size_t)h * sh;
  const float *qb = q + off, *kb = k + off, *vb = v + off;

  for (int e = tid; e < MHA_TQ * D; e += 256) {
    const int r = e / D, d = e % D;
    Qs[e] = r < nq ? qb[(size_t)(q0 + r) * sl + d] : 0.f;
  }

  // pass 1: scores
  for (int k0 = 0; k0 < L; k0 += MHA_TK) {
    const int nk = min(MHA_TK, L - k0);
    __syncthreads();
    for (int e = tid; e < MHA_TK * D; e += 256) {
      const int j = e / D, d = e % D;
      KV[j * (D + 1) + d] = j < nk ? kb[(size_t)(k0 + j) * sl + d] : 0.f;
    }
    __syncthreads();
    const int j = tid & (MHA_TK - 1);
    if (j < nk) {
      for (int r = tid >> 6; r < nq; r += 4) {
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(Qs[r * D + d], KV[j * (D + 1) + d], s);
        S[(size_t)r * L + k0 + j] = __fmul_rn(s, scale);
      }
    }
  }
  __syncthreads();

  // softmax numerators and f32 denominators, one warp per row
  for (int r = warp; r < nq; r += 8) {
    float* row = S + (size_t)r * L;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
    for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float p = expf(__fsub_rn(row[j], m));
      row[j] = p;
      sum += p;
    }
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) den[r] = sum;
  }

  // pass 2: P @ V
  constexpr int MAXE = MHA_TQ * 128 / 256;
  float acc[MAXE];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) acc[e] = 0.f;
  const int nE = (MHA_TQ * D) / 256;  // D multiple of 8
  for (int k0 = 0; k0 < L; k0 += MHA_TK) {
    const int nk = min(MHA_TK, L - k0);
    __syncthreads();
    for (int e = tid; e < MHA_TK * D; e += 256) {
      const int j = e / D, d = e % D;
      KV[j * (D + 1) + d] = j < nk ? vb[(size_t)(k0 + j) * sl + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      if (e < nE) {
        const int idx = tid + 256 * e, r = idx / D, d = idx % D;
        if (r < nq) {
          const float* prow = S + (size_t)r * L + k0;
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
      const int idx = tid + 256 * e, r = idx / D, d = idx % D;
      if (r < nq)
        out[((size_t)b * L + q0 + r) * H * D + h * D + d] = __fdiv_rn(acc[e], den[r]);
    }
  }
}

// bf16: grid (ceil(L / 64), H, B), 4 warps of 16 queries each, mma.sync
// for both products, no score matrix in memory. Pass 1 sweeps the key
// tiles for the row max; pass 2 recomputes the scores, forms
// p = exp(s - m) in f32 (summed in f32 for the denominator), rounds p to
// bf16 straight from the accumulator registers into the A fragments of
// P @ V, and divides the f32 result by the denominator at the end.
// Needs 16-byte aligned rows: q, k, v and sb, sl, sh multiples of 8.
template <int D>
__global__ void __launch_bounds__(128)
attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, long long sb, long long sl, long long sh,
                      int L, float scale, bf16* __restrict__ out) {
  constexpr int LD = D + 8, KS = D / 16;
  __shared__ __align__(16) bf16 Ks[MHA_TK * LD];
  __shared__ __align__(16) bf16 Vs[MHA_TK * LD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int r0 = blockIdx.x * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int kq = (lane & 3) * 2;
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

  auto load_tile = [&](bf16* dst, const bf16* src, int k0) {  // 64 keys x D, zero past L
    for (int e = tid; e < MHA_TK * (D / 8); e += 128) {
      const int j = e / (D / 8), c = (e % (D / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + j < L) val = *reinterpret_cast<const uint4*>(src + (size_t)(k0 + j) * sl + c);
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

  // pass 1: row max over all keys
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int k0 = 0; k0 < L; k0 += MHA_TK) {
    __syncthreads();
    load_tile(Ks, kb, k0);
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
  for (int o = 1; o <= 2; o <<= 1) {  // the 4 lanes of a row
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }

  // pass 2: P @ V and the f32 denominators
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float d0 = 0.f, d1 = 0.f;
  for (int k0 = 0; k0 < L; k0 += MHA_TK) {
    __syncthreads();
    load_tile(Ks, kb, k0);
    load_tile(Vs, vb, k0);
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
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vs + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                  p * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * p], pf[ks], vf[0], vf[1]);
        mma_bf16(o[2 * p + 1], pf[ks], vf[2], vf[3]);
      }
  }
#pragma unroll
  for (int off2 = 1; off2 <= 2; off2 <<= 1) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, off2);
    d1 += __shfl_xor_sync(0xffffffffu, d1, off2);
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1;
      if (r < L)
        out[((size_t)b * L + r) * H * D + h * D + dt * 8 + kq + (e & 1)] =
            __float2bfloat16_rn(__fdiv_rn(o[dt][e], e < 2 ? d0 : d1));
    }
}

// the scale as JAX forms it: 1/sqrt(d) in double, then rounded to f32
static inline float attn_scale(int D) { return (float)(1.0 / sqrt((double)D)); }

static int whole_row_attention(const float* q, const float* k, const float* v, int B, int L,
                               int H, int D, long long sb, long long sl, long long sh,
                               float* out, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)MHA_TQ * D + MHA_TK * (D + 1) + (size_t)MHA_TQ * L + MHA_TQ);
  cudaFuncSetAttribute(attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((L + MHA_TQ - 1) / MHA_TQ, H, B);
  attention_f32_kernel<<<grid, 256, smem, st>>>(q, k, v, sb, sl, sh, L, D, attn_scale(D), out);
  PPT_CHECK_LAUNCH();
  return 0;
}

static int whole_row_attention(const bf16* q, const bf16* k, const bf16* v, int B, int L, int H,
                               int D, long long sb, long long sl, long long sh, bf16* out,
                               cudaStream_t st) {
  const float scale = attn_scale(D);
  dim3 grid((L + 63) / 64, H, B);
  if (D == 32)
    attention_bf16_kernel<32><<<grid, 128, 0, st>>>(q, k, v, sb, sl, sh, L, scale, out);
  else if (D == 64)
    attention_bf16_kernel<64><<<grid, 128, 0, st>>>(q, k, v, sb, sl, sh, L, scale, out);
  else if (D == 128)
    attention_bf16_kernel<128><<<grid, 128, 0, st>>>(q, k, v, sb, sl, sh, L, scale, out);
  else
    return (int)cudaErrorInvalidValue;
  PPT_CHECK_LAUNCH();
  return 0;
}
