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
// knn_single_kernel: bound on the H100 by the latency of each query's
//   selection, not by its distances (9 operations a point pair, 0.0023 ms
//   at the slice's 32 x 1024 points / 512 queries). The TPU kernel's k
//   argmin passes over a resident distance row are a chain of k x (N / 32
//   + 10) dependent steps a query, with too few queries in flight to hide
//   it. Here one warp takes one query and a CTA takes KNN_WARPS of them,
//   enough CTAs to fill every SM. The cloud streams through shared memory
//   in chunks of `chunk` points ([chunk][3] f32 as it lies, double-buffered
//   by cp.async, in ascending index order), each chunk read by all the
//   CTA's warps. A warp scans a chunk 32 points at a time and keeps a
//   running top-k queue of (distance, index) pairs in registers, sorted,
//   one pair a lane for k <= 32 and two for k <= 64 (the most any PPT
//   configuration takes). A ballot filters the 32 distances against the
//   queue's k-th pair; the few survivors are inserted one by one in index
//   order (a warp-wide shift), so the serial work per query is about k ln(N
//   / k) insertions instead of k full passes. Candidates arrive in
//   ascending index, and every comparison is lexicographic on (distance,
//   index), so ties go to the lowest index. k past 64 takes ceil(k / 64)
//   passes over the cloud with the same queue, each keeping the next 64
//   pairs after the previous pass's last pick. One design serves every N
//   and every k in [1, N].
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
constexpr int KNN_WARPS = 16;  // queries a CTA, one warp each
constexpr int KNN_THREADS = 32 * KNN_WARPS;
constexpr unsigned FULL_MASK = 0xffffffffu;

// (a, ai) before (b, bi): the smaller distance, ties to the lower index
static __device__ __forceinline__ bool lex_lt(float a, int ai, float b, int bi) {
  return a < b || (a == b && ai < bi);
}

// 4-byte global -> shared copy (a cloud's base need not be 16-byte aligned)
static __device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// A warp's queue of 32 Q (distance, index) pairs in ascending lexicographic
// order, position 32 r + lane in (d[r], i[r]). Inserts the warp-uniform
// pair (nd, ni): every pair after it moves up one position (the last one
// drops out), so the pair lands where its predecessors end.
template <int Q>
static __device__ __forceinline__ void queue_insert(float (&d)[Q], int (&i)[Q], float nd, int ni,
                                                    int lane) {
  unsigned gt[Q];
  float up_d[Q];
  int up_i[Q];
#pragma unroll
  for (int r = 0; r < Q; ++r) {
    gt[r] = __ballot_sync(FULL_MASK, lex_lt(nd, ni, d[r], i[r]));
    up_d[r] = __shfl_sync(FULL_MASK, d[r], (lane + 31) & 31);
    up_i[r] = __shfl_sync(FULL_MASK, i[r], (lane + 31) & 31);
  }
#pragma unroll
  for (int r = 0; r < Q; ++r) {
    if ((gt[r] >> lane) & 1) {
      // position 32 r + lane takes its predecessor's pair if that one moves too
      const bool prev = lane ? (gt[r] >> (lane - 1)) & 1 : (r ? gt[r - 1] >> 31 : 0u);
      const float pd = lane ? up_d[r] : (r ? up_d[r - 1] : nd);
      const int pi = lane ? up_i[r] : (r ? up_i[r - 1] : ni);
      d[r] = prev ? pd : nd;
      i[r] = prev ? pi : ni;
    }
  }
}

// One warp a query, KNN_WARPS queries a CTA; the cloud streams through
// shared memory in chunks of `chunk` points, double-buffered by cp.async,
// each chunk read by all the CTA's warps. A pass keeps the 32 Q smallest
// pairs lexicographically after (lo_d, lo_i) in the warp's queue; k picks
// take ceil(k / 32 Q) passes over the cloud, each bounded below by the last
// pick of the one before.
template <int Q>
__global__ void __launch_bounds__(KNN_THREADS)
knn_single_kernel(const float* __restrict__ xyz, const float* __restrict__ q, int N, int S,
                  int k, int chunk, int* __restrict__ out) {
  extern __shared__ float sm[];  // [2][chunk][3]
  constexpr int QN = 32 * Q;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, s = blockIdx.x * KNN_WARPS + warp;
  const bool live = s < S;
  const float* p = xyz + (size_t)b * N * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const float* qp = q + ((size_t)b * S + s) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  int* io = out + ((size_t)b * S + (live ? s : 0)) * k;
  const int n_chunks = (N + chunk - 1) / chunk;
  auto stage = [&](int c) {
    float* dst = sm + (c & 1) * chunk * 3;
    const float* src = p + (size_t)c * chunk * 3;
    const int n = min(chunk, N - c * chunk) * 3;
    for (int e = threadIdx.x; e < n; e += KNN_THREADS) cp_async4(dst + e, src + e);
    cp_async_commit();
  };

  float lo_d = -INFINITY;
  int lo_i = -1;
  for (int k0 = 0; k0 < k; k0 += QN) {
    const int kk = min(QN, k - k0);  // this pass's picks
    float d[Q];
    int ix[Q];
#pragma unroll
    for (int r = 0; r < Q; ++r) {
      d[r] = INFINITY;
      ix[r] = INT_MAX;
    }
    float td = INFINITY;  // the queue's pair kk - 1: a candidate must come before it
    int ti = INT_MAX;
    stage(0);
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) {
        stage(c + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* cs = sm + (c & 1) * chunk * 3;
      const int j0 = c * chunk, n = min(chunk, N - j0);
      if (live) {
        for (int t = 0; t < n; t += 32) {
          const int jl = t + lane, j = j0 + jl;
          bool ok = false;
          float dist = INFINITY;
          if (jl < n) {
            dist = sq3(__fsub_rn(qx, cs[3 * jl]), __fsub_rn(qy, cs[3 * jl + 1]),
                       __fsub_rn(qz, cs[3 * jl + 2]));
            ok = lex_lt(dist, j, td, ti) && lex_lt(lo_d, lo_i, dist, j);
          }
          // survivors in ascending index, each checked against the bound
          // the insertions before it have tightened
          for (unsigned m = __ballot_sync(FULL_MASK, ok); m; m &= m - 1) {
            const int src = __ffs(m) - 1;
            const float nd = __shfl_sync(FULL_MASK, dist, src);
            const int ni = j0 + t + src;
            if (lex_lt(nd, ni, td, ti)) {
              queue_insert<Q>(d, ix, nd, ni, lane);
              const float last_d = Q > 1 && kk > 32 ? d[Q - 1] : d[0];
              const int last_i = Q > 1 && kk > 32 ? ix[Q - 1] : ix[0];
              td = __shfl_sync(FULL_MASK, last_d, (kk - 1) & 31);
              ti = __shfl_sync(FULL_MASK, last_i, (kk - 1) & 31);
            }
          }
        }
      }
      __syncthreads();  // the buffer is restaged two chunks on
    }
    if (live) {
#pragma unroll
      for (int r = 0; r < Q; ++r)
        if (32 * r + lane < kk) io[k0 + 32 * r + lane] = ix[r];
    }
    lo_d = td;  // the pass's last pick bounds the next pass
    lo_i = ti;
  }
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
