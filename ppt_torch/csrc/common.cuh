// Shared helpers for the port's hand-written Hopper kernels.
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
