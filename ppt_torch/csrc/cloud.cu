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
// knn_single_kernel: one block per (cloud, tile of up to 128 queries), as
//   the TPU grid has, the cloud staged in shared memory once per block.
//   Each warp takes the tile's queries in turn. Bound by the k selection
//   passes, each a warp argmin: pass r takes the smallest (d, index) pair
//   strictly after pass r-1's pick in lexicographic order, which is the
//   TPU kernel's "argmin, record, mask to +inf" without a write. The
//   query's distance row lives in registers (32 a lane) up to N = 1024,
//   in shared memory (one row per warp) while cloud and rows fit, and
//   beyond that is recomputed in every pass from the cloud in device
//   memory (L2-resident), so every N runs.
//
// Exactness: distances are ((dx*dx + dy*dy) + dz*dz) with the _rn
// intrinsics, the JAX kernels' order, so indices match the plain PyTorch
// versions and group.cu's fps_kernel / knn_kernel bit for bit.
#include <limits.h>

#include "common.cuh"

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
enum { ROW_REGS = 0, ROW_SMEM = 1, ROW_RECOMPUTE = 2 };
constexpr int KNN_REG_SLOTS = 32;  // row in registers: N <= 32 * 32

// (d, j) strictly after (pd, pj) and before (bd, bj), lexicographically
static __device__ __forceinline__ bool next_pick(float d, int j, float pd, int pj, float bd,
                                                 int bj) {
  return (d > pd || (d == pd && j > pj)) && (d < bd || (d == bd && j < bj));
}

template <int ROW>
__global__ void knn_single_kernel(const float* __restrict__ xyz, const float* __restrict__ q,
                                  int N, int S, int s_blk, int k, int* __restrict__ out) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int b = blockIdx.y;
  const float* p = xyz + (size_t)b * N * 3;
  float* xs = sm;
  float* ys = xs + N;
  float* zs = ys + N;
  float* row = zs + N + (size_t)warp * N;  // ROW_SMEM
  if constexpr (ROW != ROW_RECOMPUTE) {
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      xs[j] = p[3 * j];
      ys[j] = p[3 * j + 1];
      zs[j] = p[3 * j + 2];
    }
    __syncthreads();
  }

  for (int t = warp; t < s_blk; t += nw) {
    const int s = blockIdx.x * s_blk + t;
    const float* qp = q + ((size_t)b * S + s) * 3;
    const float qx = qp[0], qy = qp[1], qz = qp[2];
    float reg[ROW == ROW_REGS ? KNN_REG_SLOTS : 1];
    auto dist = [&](int j) {
      if constexpr (ROW == ROW_RECOMPUTE)
        return sq3(__fsub_rn(qx, p[3 * j]), __fsub_rn(qy, p[3 * j + 1]),
                   __fsub_rn(qz, p[3 * j + 2]));
      return sq3(__fsub_rn(qx, xs[j]), __fsub_rn(qy, ys[j]), __fsub_rn(qz, zs[j]));
    };
    if constexpr (ROW == ROW_REGS) {
#pragma unroll
      for (int r = 0; r < KNN_REG_SLOTS; ++r) {
        const int j = lane + 32 * r;
        reg[r] = j < N ? dist(j) : INFINITY;
      }
    } else if constexpr (ROW == ROW_SMEM) {
      for (int j = lane; j < N; j += 32) row[j] = dist(j);
      __syncwarp();
    }

    int* io = out + ((size_t)b * S + s) * k;
    float pd = -INFINITY;
    int pj = -1, mine = 0;
    for (int r = 0; r < k; ++r) {
      float bd = INFINITY;
      int bj = INT_MAX;
      if constexpr (ROW == ROW_REGS) {
#pragma unroll
        for (int e = 0; e < KNN_REG_SLOTS; ++e) {
          const int j = lane + 32 * e;
          if (j < N && next_pick(reg[e], j, pd, pj, bd, bj)) { bd = reg[e]; bj = j; }
        }
      } else {
        for (int j = lane; j < N; j += 32) {
          const float d = ROW == ROW_SMEM ? row[j] : dist(j);
          if (next_pick(d, j, pd, pj, bd, bj)) { bd = d; bj = j; }
        }
      }
      for (int off = 16; off; off >>= 1)
        argmin_merge(bd, bj, __shfl_xor_sync(0xffffffffu, bd, off),
                     __shfl_xor_sync(0xffffffffu, bj, off));
      pd = bd;
      pj = bj;
      if (lane == (r & 31)) mine = bj;
      if ((r & 31) == 31 || r == k - 1) {  // up to 32 picks written coalesced
        const int base = r & ~31;
        if (lane <= (r & 31)) io[base + lane] = mine;
      }
    }
    if constexpr (ROW == ROW_SMEM) __syncwarp();  // the row is rewritten for the next query
  }
}

// One block per (tile of s_blk queries, cloud), `warps` warps; `row` picks
// where a query's distance row lives (the wrapper sizes it).
PPT_EXPORT int ppt_knn_single(const void* xyz, const void* q, int B, int N, int S, int s_blk,
                              int k, int row, int warps, void* out, void* stream) {
  const float* x = (const float*)xyz;
  const float* qq = (const float*)q;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (S % s_blk || k > N) return (int)cudaErrorInvalidValue;
  dim3 grid(S / s_blk, B);
  const int threads = 32 * warps;
  if (row == ROW_REGS) {
    if (N > 32 * KNN_REG_SLOTS) return (int)cudaErrorInvalidValue;
    knn_single_kernel<ROW_REGS><<<grid, threads, 12 * N, st>>>(x, qq, N, S, s_blk, k, o);
  } else if (row == ROW_SMEM) {
    const int smem = 4 * N * (3 + warps);
    cudaFuncSetAttribute(knn_single_kernel<ROW_SMEM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    knn_single_kernel<ROW_SMEM><<<grid, threads, smem, st>>>(x, qq, N, S, s_blk, k, o);
  } else {
    knn_single_kernel<ROW_RECOMPUTE><<<grid, threads, 0, st>>>(x, qq, N, S, s_blk, k, o);
  }
  PPT_CHECK_LAUNCH();
  return 0;
}
