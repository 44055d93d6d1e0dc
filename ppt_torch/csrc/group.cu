// Grouping kernels of the point towers: batched farthest point sampling,
// k-nearest-neighbour search with the centre-relative coordinate gather
// (PointBERT's tokenizer), and the ball queries of the set-abstraction
// towers (PointNet++, PointNeXt).
//
// Replaces ppt_tpu/kernels/group.py:fps_batched (_fps_batched_kernel),
// :knn_gather (_knn_gather_kernel), :ball_query_gather
// (_ball_query_kernel), :ball_query_gather_feats
// (_ball_query_feats_kernel) and :_ball_query_kernel_v2.
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
// ball query (three kernels, one function): the first `nsample` indices
//   with d <= r*r in ascending index order, short rows padded with the
//   first hit, a query with no hit gives N-1; with each pick its
//   coordinates minus the centre. Bound by bytes: the outputs (16 bytes a
//   pick, plus a feature row) outweigh the 8 operations a candidate
//   costs. An ordered, data-dependent compaction, so the design is warp
//   votes, not a selection product:
//   ball_query_kernel: one warp per query walks the cloud from device
//     memory (it stays in L1/L2) in ascending 32-point chunks; a ballot
//     and a population count give each hit its slot, the hit's own lane
//     writes index and coordinates from its registers, and the warp stops
//     as soon as `nsample` slots are full.
//   ball_query_feats_kernel: the same walk, picks kept in shared memory;
//     then the warp copies the picked feature rows into the query's
//     contiguous [nsample, F] output, 16 bytes a lane where the row
//     allows it. A copy is exact in any type.
//   ball_query_rank_kernel: the rank formulation. A block stages the
//     cloud's coordinates in shared memory once for a tile of queries and
//     makes one full pass with no early exit; a hit's inclusive prefix
//     count is its rank, and the hit with rank r <= nsample is pick r-1.
//     Padding afterwards.
//
// Exactness: distances are ((dx*dx + dy*dy) + dz*dz) with the _rn
// intrinsics so nvcc cannot contract them into FMAs; indices then match
// the plain PyTorch version bit for bit, and no point crosses a radius.
#include <limits.h>

#include "common.cuh"

PPT_ERROR_STRING_FN

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

// ---------------------------------------------------------------------------
// ball query
// ---------------------------------------------------------------------------

// Pads slots [count, nsample) of one query with the first hit, or with
// point N-1 when the ball is empty; `p` is the cloud, [N, 3].
static __device__ __forceinline__ void ball_pad(const float* __restrict__ p, int N, int nsample,
                                                int count, int first, float qx, float qy,
                                                float qz, int lane, int* __restrict__ io,
                                                float* __restrict__ ro) {
  if (count >= nsample) return;
  const int pad = count > 0 ? first : N - 1;
  const float rx = __fsub_rn(p[3 * pad], qx);
  const float ry = __fsub_rn(p[3 * pad + 1], qy);
  const float rz = __fsub_rn(p[3 * pad + 2], qz);
  for (int s = count + lane; s < nsample; s += 32) {
    io[s] = pad;
    ro[3 * s] = rx;
    ro[3 * s + 1] = ry;
    ro[3 * s + 2] = rz;
  }
}

// One warp's walk over the cloud for one query, with the early exit.
// Returns the number of hits seen before it stopped (>= nsample means
// full); `first` gets the first hit's index. Each hit's lane writes its
// own pick.
static __device__ __forceinline__ int ball_walk(const float* __restrict__ p, int N, int nsample,
                                                float r2, float qx, float qy, float qz, int lane,
                                                int* __restrict__ io, float* __restrict__ ro,
                                                int& first) {
  int count = 0;
  first = -1;
  for (int base = 0; base < N && count < nsample; base += 32) {
    const int j = base + lane;
    float x = 0.f, y = 0.f, z = 0.f;
    bool hit = false;
    if (j < N) {
      x = p[3 * j];
      y = p[3 * j + 1];
      z = p[3 * j + 2];
      hit = sq3(__fsub_rn(qx, x), __fsub_rn(qy, y), __fsub_rn(qz, z)) <= r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (!mask) continue;
    if (first < 0) first = base + __ffs(mask) - 1;
    const int slot = count + __popc(mask & ((1u << lane) - 1u));
    if (hit && slot < nsample) {
      io[slot] = j;
      ro[3 * slot] = __fsub_rn(x, qx);
      ro[3 * slot + 1] = __fsub_rn(y, qy);
      ro[3 * slot + 2] = __fsub_rn(z, qz);
    }
    count += __popc(mask);
  }
  return count;
}

// One warp per query; blockDim.x / 32 queries of one cloud per block.
__global__ void ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ q,
                                  int N, int S, int nsample, float r2,
                                  int* __restrict__ idx_out, float* __restrict__ rel_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int s = blockIdx.x * (blockDim.x >> 5) + warp;
  if (s >= S) return;
  const float* p = xyz + (size_t)b * N * 3;
  const float* qp = q + ((size_t)b * S + s) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  int* io = idx_out + ((size_t)b * S + s) * nsample;
  float* ro = rel_out + ((size_t)b * S + s) * nsample * 3;
  int first;
  const int count = ball_walk(p, N, nsample, r2, qx, qy, qz, lane, io, ro, first);
  ball_pad(p, N, nsample, count, first, qx, qy, qz, lane, io, ro);
}

// The feature rows of one query's picks, copied in units of V bytes
// (sizeof(V) divides the row): the output is one contiguous run, so
// neighbouring lanes write neighbouring units.
template <typename V>
static __device__ __forceinline__ void copy_rows(const char* __restrict__ feats,
                                                 const int* __restrict__ picks, int nsample,
                                                 int row_bytes, int lane,
                                                 char* __restrict__ out) {
  const int per_row = row_bytes / (int)sizeof(V);
  const int total = nsample * per_row;
  V* o = reinterpret_cast<V*>(out);
  for (int c = lane; c < total; c += 32) {
    const int slot = c / per_row, part = c - slot * per_row;
    o[c] = reinterpret_cast<const V*>(feats + (size_t)picks[slot] * row_bytes)[part];
  }
}

// ball_query_kernel plus the gather of the picks' feature rows
// ([N, row_bytes] per cloud, any element type). `unit` is 16, 4 or 2: the
// widest of them that divides the row.
__global__ void ball_query_feats_kernel(const float* __restrict__ xyz,
                                        const float* __restrict__ q,
                                        const char* __restrict__ feats, int N, int S,
                                        int nsample, float r2, int row_bytes, int unit,
                                        int* __restrict__ idx_out, float* __restrict__ rel_out,
                                        char* __restrict__ fj_out) {
  extern __shared__ int picks_sm[];  // [warps][nsample]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int s = blockIdx.x * (blockDim.x >> 5) + warp;
  if (s >= S) return;
  const float* p = xyz + (size_t)b * N * 3;
  const float* qp = q + ((size_t)b * S + s) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  int* io = idx_out + ((size_t)b * S + s) * nsample;
  float* ro = rel_out + ((size_t)b * S + s) * nsample * 3;
  int first;
  const int count = ball_walk(p, N, nsample, r2, qx, qy, qz, lane, io, ro, first);
  ball_pad(p, N, nsample, count, first, qx, qy, qz, lane, io, ro);
  // the warp's own writes to `io`, read back after a warp barrier
  __syncwarp();
  int* picks = picks_sm + warp * nsample;
  for (int k = lane; k < nsample; k += 32) picks[k] = io[k];
  __syncwarp();
  const char* f = feats + (size_t)b * N * row_bytes;
  char* fo = fj_out + ((size_t)b * S + s) * nsample * row_bytes;
  if (unit == 16) copy_rows<uint4>(f, picks, nsample, row_bytes, lane, fo);
  else if (unit == 4) copy_rows<uint32_t>(f, picks, nsample, row_bytes, lane, fo);
  else copy_rows<uint16_t>(f, picks, nsample, row_bytes, lane, fo);
}

// The rank formulation: a block of `blockDim.x / 32` warps serves a tile
// of `tile` queries of one cloud from coordinates staged in shared
// memory; every query makes the full pass over N.
__global__ void ball_query_rank_kernel(const float* __restrict__ xyz,
                                       const float* __restrict__ q, int N, int S, int nsample,
                                       float r2, int tile, int* __restrict__ idx_out,
                                       float* __restrict__ rel_out) {
  extern __shared__ float sm[];
  float* xs = sm;
  float* ys = xs + N;
  float* zs = ys + N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int b = blockIdx.y;
  const float* p = xyz + (size_t)b * N * 3;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    xs[j] = p[3 * j];
    ys[j] = p[3 * j + 1];
    zs[j] = p[3 * j + 2];
  }
  __syncthreads();

  const int s_end = min(S, (blockIdx.x + 1) * tile);
  for (int s = blockIdx.x * tile + warp; s < s_end; s += nwarps) {
    const float* qp = q + ((size_t)b * S + s) * 3;
    const float qx = qp[0], qy = qp[1], qz = qp[2];
    int* io = idx_out + ((size_t)b * S + s) * nsample;
    float* ro = rel_out + ((size_t)b * S + s) * nsample * 3;
    int count = 0, first = -1;
    for (int base = 0; base < N; base += 32) {
      const int j = base + lane;
      const bool hit = j < N && sq3(__fsub_rn(qx, xs[j]), __fsub_rn(qy, ys[j]),
                                    __fsub_rn(qz, zs[j])) <= r2;
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      // inclusive prefix count of the in-ball mask: the hit's rank
      const int rank = count + __popc(mask & (0xffffffffu >> (31 - lane)));
      if (hit && rank <= nsample) {
        io[rank - 1] = j;
        ro[3 * (rank - 1)] = __fsub_rn(xs[j], qx);
        ro[3 * (rank - 1) + 1] = __fsub_rn(ys[j], qy);
        ro[3 * (rank - 1) + 2] = __fsub_rn(zs[j], qz);
      }
      if (first < 0 && mask) first = base + __ffs(mask) - 1;
      count += __popc(mask);
    }
    if (count < nsample) {
      const int pad = count > 0 ? first : N - 1;
      const float rx = __fsub_rn(xs[pad], qx), ry = __fsub_rn(ys[pad], qy),
                  rz = __fsub_rn(zs[pad], qz);
      for (int k = count + lane; k < nsample; k += 32) {
        io[k] = pad;
        ro[3 * k] = rx;
        ro[3 * k + 1] = ry;
        ro[3 * k + 2] = rz;
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

PPT_EXPORT int ppt_ball_query(const void* xyz, const void* q, int B, int N, int S, int nsample,
                              float r2, int wpb, void* idx, void* rel, void* stream) {
  dim3 grid((S + wpb - 1) / wpb, B);
  ball_query_kernel<<<grid, wpb * 32, 0, (cudaStream_t)stream>>>(
      (const float*)xyz, (const float*)q, N, S, nsample, r2, (int*)idx, (float*)rel);
  PPT_CHECK_LAUNCH();
  return 0;
}

PPT_EXPORT int ppt_ball_query_feats(const void* xyz, const void* q, const void* feats, int B,
                                    int N, int S, int nsample, float r2, int row_bytes,
                                    int unit, int wpb, void* idx, void* rel, void* fj,
                                    void* stream) {
  dim3 grid((S + wpb - 1) / wpb, B);
  const size_t smem = (size_t)wpb * nsample * sizeof(int);
  ball_query_feats_kernel<<<grid, wpb * 32, smem, (cudaStream_t)stream>>>(
      (const float*)xyz, (const float*)q, (const char*)feats, N, S, nsample, r2, row_bytes,
      unit, (int*)idx, (float*)rel, (char*)fj);
  PPT_CHECK_LAUNCH();
  return 0;
}

PPT_EXPORT int ppt_ball_query_rank(const void* xyz, const void* q, int B, int N, int S,
                                   int nsample, float r2, int tile, int wpb, void* idx,
                                   void* rel, void* stream) {
  const size_t smem = (size_t)N * 3 * sizeof(float);
  cudaFuncSetAttribute(ball_query_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((S + tile - 1) / tile, B);
  ball_query_rank_kernel<<<grid, wpb * 32, smem, (cudaStream_t)stream>>>(
      (const float*)xyz, (const float*)q, N, S, nsample, r2, tile, (int*)idx, (float*)rel);
  PPT_CHECK_LAUNCH();
  return 0;
}
