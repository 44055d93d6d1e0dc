// Single-cloud farthest point sampling and k-nearest-neighbour indices: the
// port's counterparts of the JAX package's two simplest reference kernels,
// kernels of their own beside group.cu's batched FPS and kNN + gather.
//
// Replaces ppt_tpu/kernels/fps.py:fps_pallas (_fps_kernel) and
// ppt_tpu/kernels/knn.py:knn_pallas (_knn_kernel).
//
// fps_single_kernel: one block per cloud, as the TPU grid has one instance
//   per cloud. Bound by latency: npoint dependent steps, each a block-wide
//   (value, lowest index) argmax. The TPU kernel keeps the cloud and its
//   running distance resident for every step; here each of the block's
//   1024 threads holds PER points (strided: point j = p * 1024 + tid) and
//   their running distances in registers, so a step reads no memory but
//   the two reduction slots. The winner's coordinates ride along the
//   reduction, so a step needs two barriers. At PER = 16 (N > 8192) the
//   coordinates no longer fit beside the distances (64 registers a
//   thread at 1024 threads) and are staged in shared memory instead; the
//   distances stay in registers. N above 16384 is refused by the wrapper.
// knn_single_kernel: the selection of knn_select.cuh (whose header says
//   what bounds it and how its design answers that), one warp a query, the
//   picks written out as indices; group.cu's knn_gather_kernel runs the same
//   selection and gathers the neighbourhood after each pass.
//
// Exactness: distances are ((dx*dx + dy*dy) + dz*dz) with the _rn
// intrinsics, the JAX kernels' order, so indices match the plain PyTorch
// versions and group.cu's fps_batched_kernel / knn_gather_kernel bit for bit.
#include <limits.h>

#include "common.cuh"
#include "knn_select.cuh"

PPT_ERROR_STRING_FN

constexpr int FPS_THREADS = 1024;

// ---------------------------------------------------------------------------
// FPS
// ---------------------------------------------------------------------------
template <int PER>
__global__ void __launch_bounds__(FPS_THREADS)
fps_single_kernel(const float* __restrict__ xyz, int N, int npoint, int* __restrict__ out) {
  constexpr bool SMEM_XYZ = PER > 8;  // coordinates in shared memory past 8192 points
  extern __shared__ float sm[];       // [3][N] when SMEM_XYZ
  __shared__ float red_v[32], red_x[32], red_y[32], red_z[32];
  __shared__ int red_i[32];
  __shared__ float s_c[3];
  __shared__ int s_far;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* p = xyz + (size_t)blockIdx.x * N * 3;
  float px[SMEM_XYZ ? 1 : PER], py[SMEM_XYZ ? 1 : PER], pz[SMEM_XYZ ? 1 : PER];
  float dist[PER];
#pragma unroll
  for (int s = 0; s < PER; ++s) {
    const int j = s * FPS_THREADS + tid;
    const bool ok = j < N;
    dist[s] = ok ? 1e10f : -INFINITY;  // a slot past N is never the argmax
    if constexpr (SMEM_XYZ) {
      if (ok) {
        sm[j] = p[3 * j];
        sm[N + j] = p[3 * j + 1];
        sm[2 * N + j] = p[3 * j + 2];
      }
    } else {
      px[s] = ok ? p[3 * j] : 0.f;
      py[s] = ok ? p[3 * j + 1] : 0.f;
      pz[s] = ok ? p[3 * j + 2] : 0.f;
    }
  }
  float cx = p[0], cy = p[1], cz = p[2];
  int far = 0;
  if (SMEM_XYZ) __syncthreads();
  int* o = out + (size_t)blockIdx.x * npoint;
  for (int i = 0; i < npoint; ++i) {
    if (tid == 0) o[i] = far;
    float bv = -INFINITY, bx = 0.f, by = 0.f, bz = 0.f;
    int bi = INT_MAX;
#pragma unroll
    for (int s = 0; s < PER; ++s) {
      const int j = s * FPS_THREADS + tid;
      float x, y, z;
      if constexpr (SMEM_XYZ) {
        const int jj = j < N ? j : 0;
        x = sm[jj];
        y = sm[N + jj];
        z = sm[2 * N + jj];
      } else {
        x = px[s];
        y = py[s];
        z = pz[s];
      }
      const float d = sq3(__fsub_rn(x, cx), __fsub_rn(y, cy), __fsub_rn(z, cz));
      const float r = fminf(dist[s], d);
      dist[s] = r;
      if (r > bv) {  // slots ascend in j: strict > keeps the lowest index
        bv = r; bi = j; bx = x; by = y; bz = z;
      }
    }
    for (int off = 16; off; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const float ox = __shfl_xor_sync(0xffffffffu, bx, off);
      const float oy = __shfl_xor_sync(0xffffffffu, by, off);
      const float oz = __shfl_xor_sync(0xffffffffu, bz, off);
      if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; bx = ox; by = oy; bz = oz; }
    }
    if (lane == 0) {
      red_v[warp] = bv; red_i[warp] = bi; red_x[warp] = bx; red_y[warp] = by; red_z[warp] = bz;
    }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane]; bi = red_i[lane]; bx = red_x[lane]; by = red_y[lane]; bz = red_z[lane];
      for (int off = 16; off; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        const float ox = __shfl_xor_sync(0xffffffffu, bx, off);
        const float oy = __shfl_xor_sync(0xffffffffu, by, off);
        const float oz = __shfl_xor_sync(0xffffffffu, bz, off);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; bx = ox; by = oy; bz = oz; }
      }
      if (lane == 0) { s_far = bi; s_c[0] = bx; s_c[1] = by; s_c[2] = bz; }
    }
    __syncthreads();
    far = s_far;
    cx = s_c[0]; cy = s_c[1]; cz = s_c[2];
  }
}

// N <= 1024 * 16; the wrapper checks it.
PPT_EXPORT int ppt_fps_single(const void* xyz, int B, int N, int npoint, void* out,
                              void* stream) {
  const float* x = (const float*)xyz;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const int per = (N + FPS_THREADS - 1) / FPS_THREADS;
  if (per <= 1) fps_single_kernel<1><<<B, FPS_THREADS, 0, st>>>(x, N, npoint, o);
  else if (per <= 2) fps_single_kernel<2><<<B, FPS_THREADS, 0, st>>>(x, N, npoint, o);
  else if (per <= 4) fps_single_kernel<4><<<B, FPS_THREADS, 0, st>>>(x, N, npoint, o);
  else if (per <= 8) fps_single_kernel<8><<<B, FPS_THREADS, 0, st>>>(x, N, npoint, o);
  else if (per <= 16) {
    const int smem = 12 * N;
    cudaFuncSetAttribute(fps_single_kernel<16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    fps_single_kernel<16><<<B, FPS_THREADS, smem, st>>>(x, N, npoint, o);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  PPT_CHECK_LAUNCH();
  return 0;
}

// ---------------------------------------------------------------------------
// kNN
// ---------------------------------------------------------------------------

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
