// Grouping kernels of the point towers: batched farthest point sampling,
// k-nearest-neighbour search with the centre-relative coordinate gather
// (PointBERT's tokenizer), and the ball queries of the set-abstraction
// towers (PointNet++, PointNeXt).
//
// Replaces ppt_tpu/kernels/group.py:fps_batched (_fps_batched_kernel),
// :knn_gather (_knn_gather_kernel), :ball_query_gather
// (_ball_query_kernel), :ball_query_gather_feats
// (_ball_query_feats_kernel) and :_ball_query_kernel_v2; and
// ppt_tpu/kernels/fps.py:fps_pallas, the single-cloud FPS, which computes
// fps_batched's function: kernels/fps.py:fps_single launches
// fps_batched_kernel through ppt_fps, as kernels/group.py:fps_batched does.
//
// fps_batched_kernel: bound by the latency of npoint dependent steps, each a
//   (value, lowest index) argmax over the cloud's running distances, far
//   above its operations bound; and at large N by issuing about 12
//   instructions a point a step on the one SM a cloud runs on. A step's
//   chain: a thread's distances to the last pick and their running minimum;
//   the thread's best; the warp's; the CTA's through shared memory; the
//   winner's coordinates. Design: one CTA a cloud, W warps, P points a
//   thread, strided (point j = s T + tid), their running distances and
//   coordinates in registers (at P = 16, past 8192 points, the coordinates
//   are read from shared memory). A warp's best is two redux.sync: the
//   largest distance bits (non-negative f32 bits order as integers), then
//   the lowest index holding them. Lane 0 writes it to a double-buffered
//   slot array; after ONE barrier every warp reduces the W slots itself the
//   same way and reads the winner's coordinates from the CTA's copy of the
//   cloud in shared memory ([3][N], 12 N bytes). A warp runs at most one
//   step ahead of the slowest, so the other buffer is never in use. A
//   padding slot keeps distance -inf in registers and reaches the slots as
//   bits 0 with index INT_MAX: a real point at distance 0 beats it.
//   Plan (ppt_fps, which fps_batched and fps_single both launch): 4 points
//   a thread, 4 to 32 warps a cloud. Measured on
//   an H100 80GB HBM3 at 700 W in development builds that set the warp count
//   by hand (the rule beside 4, 8, 16 and 32 warps at the shapes below, ms;
//   chip_smoke.py times the rule alone): the slice (32 x 1024 ->
//   512) at its 8 warps 0.130, at 4, 16, 32 warps 0.186, 0.136, 0.154; the
//   long trunk (32 x 8192 -> 1024) at its 32 warps 0.858, at 16 (16
//   points a thread) 1.144; PointNeXt-S's stages (B = 128, N = 1024, 512,
//   256, 128) 0.129, 0.060, 0.029, 0.016 against the fastest count's
//   0.129, 0.055, 0.025, 0.015 (one point a thread wins below 1024
//   points, by at most 0.004 ms a launch; each call timed on its own, so
//   the two smallest stages, near the host's time a launch, rank the
//   counts loosely). A step of the chain at one point a thread (4 warps)
//   takes 0.155 us with the launches queued (chip_smoke.py's step-chain
//   line), 1.6x under a step at the slice and 5.4x under one on the long
//   trunk. Tried in development builds and
//   not kept, because each lost at every one of those shapes: the warp's
//   best as a packed 64-bit (bits, ~index) key through five shuffles
//   instead of two redux.sync; and a thread-block cluster of 2-8 CTAs a
//   cloud exchanging per-warp bests through distributed shared memory,
//   whose cluster barrier cost a step more than the instructions it spread
//   over the SMs saved.
// knn_gather_kernel: knn_select.cuh's selection (one warp a query, the
//   cloud streamed in chunks through shared memory, a register top-k
//   filtered by ballot; that header says what bounds it), shared with
//   cloud.cu's knn_single_kernel. After each pass lane r writes pick r's
//   index and its coordinates minus the query's (__fsub_rn, the JAX
//   kernel's order), the coordinates read from the cloud in device memory
//   (L2-resident: the staged chunk no longer holds a pass's picks), so no
//   [B,G,K,3] gather goes through device memory twice. The gather and its
//   writes cost 1-2% of the kernel (knn_gather against knn_single in
//   chip_smoke.py's alternated rounds: 0.136 / 0.134 ms at the slice,
//   0.724 / 0.714 on the long trunk), so no other source of the coordinates
//   could save more. Any S (queries past S are masked), any k in [1, N],
//   any N.
//
// ball query (two kernels behind three wrappers, one function): the first
//   `nsample` indices with d <= r*r in ascending index order, short rows
//   padded with the first hit, a query with no hit gives N-1; with each pick its
//   coordinates minus the centre. An ordered, data-dependent compaction,
//   so the design is warp votes, not a selection product.
//   ball_query_kernel and ball_query_feats_kernel: ball_select.cuh's walk
//   (the cloud staged once a CTA in shared memory, 4 points a lane a
//   128-point round, the picks compacted in a warp's ring in shared memory
//   and written out as contiguous rows; that header says how); the feature
//   kernel copies the picked feature rows from that ring. What bounds them
//   on an H100 80GB HBM3 at 700 W (development builds, launches queued):
//   the walk is bound by issue. A round without a hit is ~55 instructions,
//   36 of them the 4 exact distance tests (no FMA contraction: the
//   distance must round as the plain version's does), a round with hits
//   ~100; at PointNeXt-S's stage 1 (128 x 1024 points, 512 queries a cloud,
//   ~45% of them walking the whole cloud) ball_query_kernel takes 0.079 ms,
//   0.066 with no hit at all (radius 1e-6) and 0.035 when every ball fills
//   in its first round (radius 10); staging and the row writes alone (the
//   walk cut out) take 0.023, the staging L2-bound (0.038 at one query a
//   warp, four times the staged bytes). The feature kernel adds the `fj`
//   rows, bound by bytes (134 of the 178 MB at stage 1): 0.107 there,
//   0.053 at stage 4 against its bound of 0.044. What bound the earlier design (one
//   warp a query walking the cloud in device memory 32 points a round,
//   three 12-byte-strided loads a lane, the next round's loads waiting on
//   the exit test, scattered 4-byte stores, the feature copy reading the
//   picks back from device memory): 0.130 / 0.163 ms at stage 1. Slower
//   than that design where every ball fills in its first round (0.035
//   against 0.014 at radius 10, no tower's shape): the staging and the
//   ring's write-out cost more than its stores straight from the
//   hit lanes when the walk is one round. Tried and not kept: the lanes'
//   hit counts by three ballots, bit by bit, in place of one ballot a
//   point (the predicates' conversion to a count cost ~20 instructions a
//   round); each pick's coordinates computed at the hit and kept in the
//   ring (a longer hit path, and the feature kernel at 80 registers with
//   spills), now read from the staged cloud at the write-out; the centres
//   loaded at each query's start and the picks' coordinates read from
//   device memory (0.038 at radius 10, 0.035 with both from registers and
//   shared memory); the write-out as lambdas (ptxas outlined them, their
//   calls spilling), now functors; the staged and the streamed path in one
//   instantiation (ptxas recomputed the walk's addresses every round, 66
//   instructions a round without a hit); 4 feature loads in flight a lane
//   (spills at 64 registers; where it fit, 0.104 against 0.107 at stage 1)
//   and four picks' coordinates a lane as three 16-byte stores (spills);
//   1, 2 or 8 queries a warp against the rule's 4 (stage 1: 0.092, 0.082,
//   0.081 against 0.079; 1 or 2 where 4 would leave fewer than 2 CTAs an
//   SM). Testing fewer points, not cheaper tests, is what is left: a
//   per-CTA grid of the cloud with the picks selected by index.
//   The reference's rank formulation (_ball_query_kernel_v2: a hit's
//   inclusive prefix count is its slot) computes the same function, so
//   kernels/group.py:ball_query_gather_v2 runs ball_query_kernel through
//   ppt_ball_query too. Its own kernel here (a block staging the whole
//   cloud for a tile of queries, one point a lane a round, every query
//   testing all N points, each pick a scattered store from its lane) lost
//   at every tower shape (0.4042 against this walk's 0.2486 ms over the 12
//   shapes, same H100) and refused clouds past shared memory (N > 19370),
//   so it was removed.
//
// Exactness: distances are ((dx*dx + dy*dy) + dz*dz) with the _rn
// intrinsics so nvcc cannot contract them into FMAs; indices then match
// the plain PyTorch version bit for bit, and no point crosses a radius.
#include <limits.h>

#include <type_traits>

#include "ball_select.cuh"
#include "common.cuh"
#include "knn_select.cuh"

PPT_ERROR_STRING_FN

// ---------------------------------------------------------------------------
// FPS
// ---------------------------------------------------------------------------
constexpr int FPS_MAX_THREADS = 1024;

// The warp's argmax of (v, i): the largest distance bits v, ties to the
// lowest index i; every lane gets it.
static __device__ __forceinline__ void warp_argmax(unsigned& v, int& i) {
  const unsigned m = __reduce_max_sync(FULL_MASK, v);
  i = (int)__reduce_min_sync(FULL_MASK, v == m ? (unsigned)i : 0xffffffffu);
  v = m;
}

// One CTA a cloud, blockDim.x = 32 W threads, P points a thread.
template <int P>
__global__ void __launch_bounds__(FPS_MAX_THREADS)
fps_batched_kernel(const float* __restrict__ xyz, int N, int npoint, int* __restrict__ out) {
  constexpr bool SMEM_XYZ = P > 8;  // 16 points' coordinates do not fit beside their distances
  extern __shared__ float sm[];     // the cloud, [3][N]
  __shared__ uint2 slot[2][32];
  const int T = blockDim.x, W = T >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* p = xyz + (size_t)blockIdx.x * N * 3;
  float* sx = sm;
  float* sy = sm + N;
  float* sz = sm + 2 * N;
  for (int j = tid; j < N; j += T) {
    sx[j] = p[3 * j];
    sy[j] = p[3 * j + 1];
    sz[j] = p[3 * j + 2];
  }
  float px[SMEM_XYZ ? 1 : P], py[SMEM_XYZ ? 1 : P], pz[SMEM_XYZ ? 1 : P];
  float dist[P];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const int j = s * T + tid;
    const bool ok = j < N;
    dist[s] = ok ? 1e10f : -INFINITY;  // a padding slot never wins
    if constexpr (!SMEM_XYZ) {
      px[s] = ok ? p[3 * j] : 0.f;
      py[s] = ok ? p[3 * j + 1] : 0.f;
      pz[s] = ok ? p[3 * j + 2] : 0.f;
    }
  }
  __syncthreads();
  float cx = sx[0], cy = sy[0], cz = sz[0];
  int far = 0;
  int* o = out + (size_t)blockIdx.x * npoint;
  for (int it = 0; it < npoint; ++it) {
    if (tid == 0) o[it] = far;
    float bv = -INFINITY;
    int bs = 0;
#pragma unroll
    for (int s = 0; s < P; ++s) {
      float x, y, z;
      if constexpr (SMEM_XYZ) {
        const int j = min(s * T + tid, N - 1);
        x = sx[j];
        y = sy[j];
        z = sz[j];
      } else {
        x = px[s];
        y = py[s];
        z = pz[s];
      }
      const float r = fminf(dist[s], sq3(__fsub_rn(x, cx), __fsub_rn(y, cy), __fsub_rn(z, cz)));
      dist[s] = r;
      if (r > bv) {  // slots ascend in index: strict > keeps the lowest
        bv = r;
        bs = s;
      }
    }
    unsigned v = __float_as_uint(fmaxf(bv, 0.f));
    int bi = bv >= 0.f ? bs * T + tid : INT_MAX;
    warp_argmax(v, bi);
    uint2* sl = slot[it & 1];
    if (lane == 0) sl[warp] = make_uint2(v, bi);
    __syncthreads();  // the step's one barrier
    unsigned v2 = 0;
    int i2 = INT_MAX;
    if (lane < W) {
      const uint2 e = sl[lane];
      v2 = e.x;
      i2 = (int)e.y;
    }
    warp_argmax(v2, i2);
    far = i2;
    cx = sx[far];
    cy = sy[far];
    cz = sz[far];
  }
}

// ---------------------------------------------------------------------------
// kNN + gather
// ---------------------------------------------------------------------------

// One warp a query, KNN_WARPS queries of one cloud a CTA: knn_select.cuh's
// selection; after each pass, the picks' indices and coordinates minus the
// query's.
template <int Q>
__global__ void __launch_bounds__(KNN_THREADS)
knn_gather_kernel(const float* __restrict__ xyz, const float* __restrict__ q, int N, int S,
                  int k, int chunk, int* __restrict__ idx_out, float* __restrict__ nb_out) {
  extern __shared__ float sm[];  // [2][chunk][3]
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
  const size_t row = (size_t)b * S + (live ? s : 0);
  int* io = idx_out + row * k;
  float* no = nb_out + row * k * 3;
  knn_select<Q>(p, N, k, chunk, sm, live, qx, qy, qz, [&](int k0, int kk, const int (&ix)[Q]) {
#pragma unroll
    for (int r = 0; r < Q; ++r) {
      const int t = k0 + 32 * r + lane;
      if (32 * r + lane < kk) {
        const int j = ix[r];
        io[t] = j;
        no[3 * t] = __fsub_rn(__ldg(p + 3 * j), qx);
        no[3 * t + 1] = __fsub_rn(__ldg(p + 3 * j + 1), qy);
        no[3 * t + 2] = __fsub_rn(__ldg(p + 3 * j + 2), qz);
      }
    }
  });
}

// ---------------------------------------------------------------------------
// ball query
// ---------------------------------------------------------------------------

// A ball query's arguments: xyz [B][N][3], q [B][S][3] f32; feats [B][N]
// rows of row_bytes (the feature kernel); r2 the f32 of radius * radius;
// qw queries a warp, `chunk` points a stage; outputs idx [B][S][nsample]
// int32, rel [B][S][nsample][3] f32, fj [B][S][nsample] rows.
struct BallArgs {
  const float* xyz;
  const float* q;
  const char* feats;
  int N, S, nsample, row_bytes, qw, chunk;
  float r2;
  int* idx;
  float* rel;
  char* fj;
};

// Writes a query's slots [f, e) out of its ring: the query's rows of idx
// and rel, and with V (the feature kernel) its rows of fj, copied in units
// of V, the widest of 16, 4 or 2 bytes that divides a row.
template <bool VEC, typename V>
struct BallRows {
  int* idx;
  float* rel;
  char* fj;
  const char* feats;  // the cloud's feature rows
  int nsample, row_bytes;
  __device__ __forceinline__ void operator()(BallCoords xs, const BallQuery& w, int s, int f,
                                             int e, const int* ring) const {
    ball_store<VEC>(xs, w, ring, f, e, idx + (size_t)s * nsample, rel + (size_t)s * nsample * 3);
    if constexpr (!std::is_void<V>::value)
      ball_copy_rows<V>(feats, ring, f, e, row_bytes, fj + (size_t)s * nsample * row_bytes);
  }
};

// ball_select.cuh's walk, the picks written out as the query's rows of idx
// and rel. Grid (ceil(S / (qw BALL_WARPS)), B).
template <bool VEC, bool MULTI>
__global__ void __launch_bounds__(BALL_THREADS, MULTI ? 3 : 4) ball_query_kernel(const BallArgs a) {
  extern __shared__ __align__(16) float ball_sm[];
  const size_t row0 = (size_t)blockIdx.y * a.S;
  const BallRows<VEC, void> rows{a.idx + row0 * a.nsample, a.rel + row0 * a.nsample * 3,
                                 nullptr, nullptr, a.nsample, 0};
  ball_select<MULTI>(a.xyz, a.q, a.N, a.S, a.nsample, a.r2, a.qw, a.chunk, ball_sm, rows);
}

// ball_query_kernel plus the gather of the picks' feature rows (any element
// type).
template <bool VEC, bool MULTI, typename V>
__global__ void __launch_bounds__(BALL_THREADS, MULTI ? 3 : 4)
ball_query_feats_kernel(const BallArgs a) {
  extern __shared__ __align__(16) float ball_sm[];
  const size_t row0 = (size_t)blockIdx.y * a.S;
  const BallRows<VEC, V> rows{a.idx + row0 * a.nsample, a.rel + row0 * a.nsample * 3,
                              a.fj + row0 * a.nsample * a.row_bytes,
                              a.feats + (size_t)blockIdx.y * a.N * a.row_bytes, a.nsample,
                              a.row_bytes};
  ball_select<MULTI>(a.xyz, a.q, a.N, a.S, a.nsample, a.r2, a.qw, a.chunk, ball_sm, rows);
}

template <int P>
static void fps_launch(const float* x, int B, int N, int npoint, int W, int* o,
                       cudaStream_t st) {
  const int smem = 12 * N;
  cudaFuncSetAttribute(fps_batched_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  fps_batched_kernel<P><<<B, 32 * W, smem, st>>>(x, N, npoint, o);
}

// The rule: 4 points a thread, at least 4 warps and at most 32 a cloud (then
// up to 16 points a thread). N <= FPS_MAX_THREADS * 16 (the wrapper checks it).
PPT_EXPORT int ppt_fps(const void* xyz, int B, int N, int npoint, void* out, void* stream) {
  int W = (N + 127) / 128;
  W = W < 4 ? 4 : (W > 32 ? 32 : W);
  const int per = (N + 32 * W - 1) / (32 * W);
  const float* x = (const float*)xyz;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (per <= 1) fps_launch<1>(x, B, N, npoint, W, o, st);
  else if (per <= 2) fps_launch<2>(x, B, N, npoint, W, o, st);
  else if (per <= 4) fps_launch<4>(x, B, N, npoint, W, o, st);
  else if (per <= 8) fps_launch<8>(x, B, N, npoint, W, o, st);
  else if (per <= 16) fps_launch<16>(x, B, N, npoint, W, o, st);
  else return (int)cudaErrorInvalidValue;
  PPT_CHECK_LAUNCH();
  return 0;
}

// grid (ceil(S / KNN_WARPS), B); `chunk` cloud points a stage (a multiple of 32)
PPT_EXPORT int ppt_knn(const void* xyz, const void* q, int B, int N, int S, int k, int chunk,
                       void* idx, void* nb, void* stream) {
  if (k < 1 || k > N || chunk < 32 || chunk % 32) return (int)cudaErrorInvalidValue;
  const float* x = (const float*)xyz;
  const float* qq = (const float*)q;
  cudaStream_t st = (cudaStream_t)stream;
  const int c = N < chunk ? N : chunk;
  const int smem = 2 * c * 3 * (int)sizeof(float);
  dim3 grid((S + KNN_WARPS - 1) / KNN_WARPS, B);
  if (k <= 32) {
    cudaFuncSetAttribute(knn_gather_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    knn_gather_kernel<1><<<grid, KNN_THREADS, smem, st>>>(x, qq, N, S, k, c, (int*)idx,
                                                          (float*)nb);
  } else {
    cudaFuncSetAttribute(knn_gather_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    knn_gather_kernel<2><<<grid, KNN_THREADS, smem, st>>>(x, qq, N, S, k, c, (int*)idx,
                                                          (float*)nb);
  }
  PPT_CHECK_LAUNCH();
  return 0;
}

// A ball query's launch: grid (ceil(S / (qw BALL_WARPS)), B); stages of
// `chunk` points (a multiple of BALL_ROUND), a cloud of at most `chunk`
// points staged whole, N rounded up to a round; 16-byte row stores where
// nsample and the outputs allow. False for sizes it does not take.
static bool ball_launch(int B, int N, int S, int nsample, int qw, int chunk, BallArgs& a,
                        dim3& grid, int& smem, bool& vec, bool& multi) {
  if (B < 1 || S < 1 || nsample < 1 || nsample > N || qw < 1 || qw > 32 ||
      chunk < BALL_ROUND || chunk % BALL_ROUND)
    return false;
  a.N = N;
  a.S = S;
  a.nsample = nsample;
  a.qw = qw;
  multi = N > chunk;
  a.chunk = multi ? chunk : (N + BALL_ROUND - 1) / BALL_ROUND * BALL_ROUND;
  smem = ball_smem_floats(N, nsample, a.chunk) * (int)sizeof(float);
  grid = dim3((S + qw * BALL_WARPS - 1) / (qw * BALL_WARPS), B);
  vec = nsample % 4 == 0 && ((uintptr_t)a.idx | (uintptr_t)a.rel) % 16 == 0;
  return true;
}

template <typename K>
static void ball_go(K kernel, dim3 grid, int smem, cudaStream_t st, const BallArgs& a) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<grid, BALL_THREADS, smem, st>>>(a);
}

PPT_EXPORT int ppt_ball_query(const void* xyz, const void* q, int B, int N, int S, int nsample,
                              float r2, int qw, int chunk, void* idx, void* rel, void* stream) {
  BallArgs a{(const float*)xyz, (const float*)q, nullptr};
  a.r2 = r2;
  a.idx = (int*)idx;
  a.rel = (float*)rel;
  dim3 grid;
  int smem;
  bool vec, multi;
  if (!ball_launch(B, N, S, nsample, qw, chunk, a, grid, smem, vec, multi))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec && !multi) ball_go(ball_query_kernel<true, false>, grid, smem, st, a);
  else if (vec) ball_go(ball_query_kernel<true, true>, grid, smem, st, a);
  else if (!multi) ball_go(ball_query_kernel<false, false>, grid, smem, st, a);
  else ball_go(ball_query_kernel<false, true>, grid, smem, st, a);
  PPT_CHECK_LAUNCH();
  return 0;
}

template <bool VEC, bool MULTI>
static void ball_feats_go(int unit, dim3 grid, int smem, cudaStream_t st, const BallArgs& a) {
  if (unit == 16) ball_go(ball_query_feats_kernel<VEC, MULTI, uint4>, grid, smem, st, a);
  else if (unit == 4) ball_go(ball_query_feats_kernel<VEC, MULTI, uint32_t>, grid, smem, st, a);
  else ball_go(ball_query_feats_kernel<VEC, MULTI, uint16_t>, grid, smem, st, a);
}

// `unit` (16, 4 or 2 bytes) divides row_bytes and both feature bases
PPT_EXPORT int ppt_ball_query_feats(const void* xyz, const void* q, const void* feats, int B,
                                    int N, int S, int nsample, float r2, int row_bytes,
                                    int unit, int qw, int chunk, void* idx, void* rel, void* fj,
                                    void* stream) {
  BallArgs a{(const float*)xyz, (const float*)q, (const char*)feats};
  a.row_bytes = row_bytes;
  a.r2 = r2;
  a.idx = (int*)idx;
  a.rel = (float*)rel;
  a.fj = (char*)fj;
  dim3 grid;
  int smem;
  bool vec, multi;
  if (!ball_launch(B, N, S, nsample, qw, chunk, a, grid, smem, vec, multi) || row_bytes < 0 ||
      (unit != 16 && unit != 4 && unit != 2) || row_bytes % unit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec && !multi) ball_feats_go<true, false>(unit, grid, smem, st, a);
  else if (vec) ball_feats_go<true, true>(unit, grid, smem, st, a);
  else if (!multi) ball_feats_go<false, false>(unit, grid, smem, st, a);
  else ball_feats_go<false, true>(unit, grid, smem, st, a);
  PPT_CHECK_LAUNCH();
  return 0;
}

// Returns at once: launched on the grid, block and shared memory of
// ppt_ball_query at these sizes, its queued time is that launch's floor
// (chip_smoke.py).
__global__ void ball_floor_kernel(const BallArgs) {}

PPT_EXPORT int ppt_ball_launch_floor(int B, int N, int S, int nsample, int qw, int chunk,
                                     void* stream) {
  BallArgs a{};
  dim3 grid;
  int smem;
  bool vec, multi;
  if (!ball_launch(B, N, S, nsample, qw, chunk, a, grid, smem, vec, multi))
    return (int)cudaErrorInvalidValue;
  ball_go(ball_floor_kernel, grid, smem, (cudaStream_t)stream, a);
  PPT_CHECK_LAUNCH();
  return 0;
}
