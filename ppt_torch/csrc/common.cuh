// Shared helpers for the port's hand-written Hopper kernels: the C ABI's
// conventions, dtype conversion, the point clouds' exact distance, the
// mma.sync / ldmatrix / cp.async wrappers, and the LayerNorm row and f32
// GEMM main loop that vitblock.cu and text.cu build their kernels from
// (their bf16 GEMM is gemm.cuh's wgmma kernel).
//
// Every kernel library exposes a plain C ABI (loaded with ctypes by
// ppt_torch/kernels/_build.py): pointers and the stream arrive as
// void*, sizes as int, and each entry point returns the value of
// cudaGetLastError() after its last launch (0 = success).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PPT_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes shared with the Python wrappers
enum { PPT_F32 = 0, PPT_BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an f32 value to T's precision and keep it as f32: the port's
// counterpart of JAX's `.astype(dtype)` at the points the TPU kernels
// round to the compute dtype.
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

// ---------------------------------------------------------------------------
// Point-cloud helper shared by group.cu, cloud.cu and losses3d.cu: the exact squared
// distance ((dx*dx + dy*dy) + dz*dz), each step rounded on its own so nvcc
// cannot contract it into FMAs.
// ---------------------------------------------------------------------------
static __device__ __forceinline__ float sq3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// ---------------------------------------------------------------------------
// bf16 tensor-core building blocks (mma.sync m16n8k16, f32 accumulators).
// Fragment layouts are PTX's: for A (16x16, row-major) lane l holds rows
// l/4 and l/4+8 at columns 2(l%4)+{0,1} and +8; for B (16x8) columns l/4
// at rows 2(l%4)+{0,1} and +8; for C (16x8) rows l/4 and l/4+8 at columns
// 2(l%4)+{0,1}.
// ---------------------------------------------------------------------------
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a @ b for one 16x8x16 tile
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte global -> shared copy; zero-fills the destination when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Building blocks shared by vitblock.cu and text.cu. Each file wraps them in
// its own __global__ kernels (so a trace tells the point tower's launches
// from the text tower's) and brings its own epilogue functor
// `epi(acc, row, col)`, which rounds and stores one output element.
// ---------------------------------------------------------------------------

// One row of x0 = x + pos (optional) ; xn = LN(x0), by one warp, C <= 1024:
// f32 statistics, fast variance E[x^2] - E[x]^2.
template <typename T>
__device__ __forceinline__ void add_ln_row(const T* __restrict__ xr, const T* __restrict__ pr,
                                           int C, const float* __restrict__ s,
                                           const float* __restrict__ b, float eps,
                                           T* __restrict__ x0_row, T* __restrict__ xn_row) {
  const int lane = threadIdx.x & 31;
  float v[32];
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = lane + 32 * i;
    float t = 0.f;
    if (c < C) {
      t = to_f(xr[c]);
      if (pr) t = rnd<T>(__fadd_rn(t, to_f(pr[c])));
      if (x0_row) x0_row[c] = from_f<T>(t);
      sum += t;
      sq = fmaf(t, t, sq);
    }
    v[i] = t;
  }
  for (int off = 16; off; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const float mu = sum / C;
  const float var = __fsub_rn(sq / C, __fmul_rn(mu, mu));
  const float rs = rsqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = lane + 32 * i;
    if (c < C)
      xn_row[c] = from_f<T>(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[i], mu), rs), s[c]), b[c]));
  }
}

// GEMM out[M,N] = A[M,K] @ W. TB = false: W is [K, N]; TB = true: W is
// [N, K] and the product is A @ W^T (the weight is read as it lies).
//
// f32: plain FMA on the CUDA cores (f32 products are exact only there).
// Block tile 64 x 64, k-step 16, 256 threads, 4 x 4 outputs per thread.
constexpr int BM = 64, BN = 64, BK = 16;

template <bool TB, typename Epi>
__device__ __forceinline__ void gemm_f32_body(const float* __restrict__ A,
                                              const float* __restrict__ W, int M, int N, int K,
                                              const Epi& epi) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Ws[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {  // A tile: 64 rows x 16 k, 4 consecutive k per thread
      const int r = tid >> 2, kk = (tid & 3) * 4;
      const int gr = m0 + r;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gk = k0 + kk + e;
        As[kk + e][r] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : 0.f;
      }
    }
    if (TB) {  // W^T tile: 64 n x 16 k, read along k as A is
      const int r = tid >> 2, kk = (tid & 3) * 4;
      const int gc = n0 + r;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gk = k0 + kk + e;
        Ws[kk + e][r] = (gc < N && gk < K) ? W[(size_t)gc * K + gk] : 0.f;
      }
    } else {  // W tile: 16 k x 64 cols, 4 consecutive cols per thread
      const int kk = tid >> 4, c = (tid & 15) * 4;
      const int gk = k0 + kk;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gc = n0 + c + e;
        Ws[kk][c + e] = (gk < K && gc < N) ? W[(size_t)gk * N + gc] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < N) epi(acc[i][j], r, c);
    }
  }
}

// cudaGetLastError after a launch, as the C entry points return it.
#define PPT_CHECK_LAUNCH()                          \
  do {                                              \
    cudaError_t e__ = cudaGetLastError();           \
    if (e__ != cudaSuccess) return (int)e__;        \
  } while (0)

#define PPT_ERROR_STRING_FN                                     \
  PPT_EXPORT const char* ppt_error_string(int code) {           \
    return cudaGetErrorString((cudaError_t)code);               \
  }
