// Grouping kernels of the PointBERT tokenizer: batched farthest point
// sampling and k-nearest-neighbour search with the centre-relative
// coordinate gather.
//
// Replaces ppt_tpu/kernels/group.py:fps_batched (_fps_batched_kernel)
// and :knn_gather (_knn_gather_kernel).
//
// fps: bound by latency, not bytes or FLOPs. 512 dependent iterations,
//   each a block-wide (value, lowest index) argmax; only B=32 clouds for
//   132 SMs. Design: one block per cloud with the coordinates and the
//   running min distance in shared memory, each iteration one pass over
//   the points plus a two-level shuffle reduction (two barriers).
// knn: bound by the k=32 serial min-extractions per query. Design: one
//   warp per query, distances in shared memory, each lane keeps the
//   minimum of the points it owns, so a round is one warp argmin plus a
//   rescan by the single lane whose point was taken. Winners stay in
//   registers and are written coalesced, with xyz[idx] - q, so no
//   [B,G,K,3] gather goes through device memory twice.
//
// Exactness: distances are ((dx*dx + dy*dy) + dz*dz) with the _rn
// intrinsics so nvcc cannot contract them into FMAs; indices then match
// the plain PyTorch version bit for bit.
#include <limits.h>

#include "common.cuh"

PPT_ERROR_STRING_FN

static __device__ __forceinline__ float sq3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// larger value wins, ties to the lower index
static __device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
}

// smaller value wins, ties to the lower index
static __device__ __forceinline__ void argmin_merge(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) { v = ov; i = oi; }
}

__global__ void fps_kernel(const float* __restrict__ xyz, int N, int npoint,
                           int* __restrict__ out) {
  extern __shared__ float sm[];
  float* xs = sm;
  float* ys = xs + N;
  float* zs = ys + N;
  float* dist = zs + N;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_far;

  const int b = blockIdx.x;
  const float* p = xyz + (size_t)b * N * 3;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    xs[j] = p[3 * j];
    ys[j] = p[3 * j + 1];
    zs[j] = p[3 * j + 2];
    dist[j] = 1e10f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int* o = out + (size_t)b * npoint;
  int far = 0;
  for (int i = 0; i < npoint; ++i) {
    if (threadIdx.x == 0) o[i] = far;
    const float cx = xs[far], cy = ys[far], cz = zs[far];
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      const float d = sq3(__fsub_rn(xs[j], cx), __fsub_rn(ys[j], cy), __fsub_rn(zs[j], cz));
      const float r = fminf(dist[j], d);
      dist[j] = r;
      argmax_merge(bv, bi, r, j);
    }
    for (int off = 16; off; off >>= 1)
      argmax_merge(bv, bi, __shfl_xor_sync(0xffffffffu, bv, off),
                   __shfl_xor_sync(0xffffffffu, bi, off));
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -INFINITY;
      bi = lane < nwarps ? red_i[lane] : INT_MAX;
      for (int off = 16; off; off >>= 1)
        argmax_merge(bv, bi, __shfl_xor_sync(0xffffffffu, bv, off),
                     __shfl_xor_sync(0xffffffffu, bi, off));
      if (lane == 0) s_far = bi;
    }
    __syncthreads();
    far = s_far;
  }
}

// One warp per query; `wpb` warps (queries of one cloud) per block.
__global__ void knn_kernel(const float* __restrict__ xyz, const float* __restrict__ q,
                           int N, int S, int k, int* __restrict__ idx_out,
                           float* __restrict__ nb_out) {
  extern __shared__ float sm[];
  const int wpb = blockDim.x >> 5;
  float* xs = sm;
  float* ys = xs + N;
  float* zs = ys + N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* dist = zs + N + (size_t)warp * N;

  const int b = blockIdx.y;
  const float* p = xyz + (size_t)b * N * 3;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    xs[j] = p[3 * j];
    ys[j] = p[3 * j + 1];
    zs[j] = p[3 * j + 2];
  }
  __syncthreads();

  const int s = blockIdx.x * wpb + warp;
  if (s >= S) return;
  const float* qp = q + ((size_t)b * S + s) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];

  float lv = INFINITY;
  int li = INT_MAX;
  for (int j = lane; j < N; j += 32) {
    const float d = sq3(__fsub_rn(qx, xs[j]), __fsub_rn(qy, ys[j]), __fsub_rn(qz, zs[j]));
    dist[j] = d;
    argmin_merge(lv, li, d, j);
  }
  __syncwarp();

  int* io = idx_out + ((size_t)b * S + s) * k;
  float* no = nb_out + ((size_t)b * S + s) * k * 3;
  int mine = 0;
  for (int r = 0; r < k; ++r) {
    float v = lv;
    int i = li;
    for (int off = 16; off; off >>= 1)
      argmin_merge(v, i, __shfl_xor_sync(0xffffffffu, v, off),
                   __shfl_xor_sync(0xffffffffu, i, off));
    if (lane == (r & 31)) mine = i;
    if (lane == (i & 31)) {  // the owner evicts the winner and rescans
      dist[i] = INFINITY;
      lv = INFINITY;
      li = INT_MAX;
      for (int j = lane; j < N; j += 32) argmin_merge(lv, li, dist[j], j);
    }
    __syncwarp();
    if ((r & 31) == 31 || r == k - 1) {  // flush up to 32 winners coalesced
      const int base = r & ~31;
      if (lane <= (r & 31)) {
        io[base + lane] = mine;
        float* np = no + (size_t)(base + lane) * 3;
        np[0] = __fsub_rn(xs[mine], qx);
        np[1] = __fsub_rn(ys[mine], qy);
        np[2] = __fsub_rn(zs[mine], qz);
      }
    }
  }
}

PPT_EXPORT int ppt_fps(const void* xyz, int B, int N, int npoint, void* out, void* stream) {
  const int threads = N >= 1024 ? 1024 : ((N + 31) / 32) * 32;
  const size_t smem = (size_t)N * 4 * sizeof(float);
  cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  fps_kernel<<<B, threads, smem, (cudaStream_t)stream>>>((const float*)xyz, N, npoint,
                                                        (int*)out);
  PPT_CHECK_LAUNCH();
  return 0;
}

PPT_EXPORT int ppt_knn(const void* xyz, const void* q, int B, int N, int S, int k, int wpb,
                       void* idx, void* nb, void* stream) {
  const size_t smem = (size_t)N * (3 + wpb) * sizeof(float);
  cudaFuncSetAttribute(knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((S + wpb - 1) / wpb, B);
  knn_kernel<<<grid, wpb * 32, smem, (cudaStream_t)stream>>>(
      (const float*)xyz, (const float*)q, N, S, k, (int*)idx, (float*)nb);
  PPT_CHECK_LAUNCH();
  return 0;
}
