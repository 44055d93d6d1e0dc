// Single-cloud k-nearest-neighbour indices: the port's counterpart of the JAX
// package's knn_pallas (ppt_tpu/kernels/knn.py, _knn_kernel).
//
// knn_single_kernel: the selection of knn_select.cuh (whose header says
//   what bounds it and how its design answers that), one warp a query, the
//   picks written out as indices; group.cu's knn_gather_kernel runs the same
//   selection and gathers the neighbourhood after each pass.
//
// The single-cloud FPS (ppt_tpu/kernels/fps.py:fps_pallas) has no kernel
// here: kernels/fps.py:fps_single launches group.cu's fps_batched_kernel,
// the same function, through the launcher it shares with fps_batched.
//
// Exactness: distances are ((dx*dx + dy*dy) + dz*dz) with the _rn
// intrinsics, the JAX kernel's order, so indices match the plain PyTorch
// version and group.cu's knn_gather_kernel bit for bit.
#include "common.cuh"
#include "knn_select.cuh"

PPT_ERROR_STRING_FN

// One warp a query, KNN_WARPS queries a CTA: knn_select.cuh's selection,
// the pass's picks written out as indices.
template <int Q>
__global__ void __launch_bounds__(KNN_THREADS)
knn_single_kernel(const float* __restrict__ xyz, const float* __restrict__ q, int N, int S,
                  int k, int chunk, int* __restrict__ out) {
  extern __shared__ float sm[];  // [2][chunk][3]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, s = blockIdx.x * KNN_WARPS + warp;
  const bool live = s < S;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const float* qp = q + ((size_t)b * S + s) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  int* io = out + ((size_t)b * S + (live ? s : 0)) * k;
  knn_select<Q>(xyz + (size_t)b * N * 3, N, k, chunk, sm, live, qx, qy, qz,
                [&](int k0, int kk, const int (&ix)[Q]) {
#pragma unroll
                  for (int r = 0; r < Q; ++r)
                    if (32 * r + lane < kk) io[k0 + 32 * r + lane] = ix[r];
                });
}

// grid (ceil(S / KNN_WARPS), B); `chunk` cloud points a stage (a multiple of 32)
PPT_EXPORT int ppt_knn_single(const void* xyz, const void* q, int B, int N, int S, int k,
                              int chunk, void* out, void* stream) {
  if (k < 1 || k > N || chunk < 32 || chunk % 32) return (int)cudaErrorInvalidValue;
  const float* x = (const float*)xyz;
  const float* qq = (const float*)q;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const int c = N < chunk ? N : chunk;
  const int smem = 2 * c * 3 * (int)sizeof(float);
  dim3 grid((S + KNN_WARPS - 1) / KNN_WARPS, B);
  if (k <= 32) {
    cudaFuncSetAttribute(knn_single_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    knn_single_kernel<1><<<grid, KNN_THREADS, smem, st>>>(x, qq, N, S, k, c, o);
  } else {
    cudaFuncSetAttribute(knn_single_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    knn_single_kernel<2><<<grid, KNN_THREADS, smem, st>>>(x, qq, N, S, k, c, o);
  }
  PPT_CHECK_LAUNCH();
  return 0;
}
