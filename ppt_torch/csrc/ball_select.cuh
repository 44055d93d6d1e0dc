// The ball query's ordered compaction, which group.cu's ball_query_kernel
// and ball_query_feats_kernel both run: for each query the first `nsample`
// points of its cloud with d <= r2, in ascending index order, a short row
// padded with its first hit, an empty ball with point N - 1; with each
// pick its coordinates minus the centre.
//
// A CTA of BALL_WARPS warps serves a tile of queries of one cloud, one
// query a warp at a time, `qw` queries a warp in turn (their centres
// loaded up front, one a lane). The cloud is staged in shared memory as
// [3][chunk] f32 (SoA) by coalesced 4-byte cp.async copies that transpose
// it on the way, once a CTA when it fits one chunk, else in double-buffered
// chunks (any N), padded with NaN to a whole round so that no test needs a
// bound. A warp tests BALL_ROUND = 128 points a round, 4 a lane (points
// 4l..4l+3 of the round: one 16-byte shared load per coordinate), so the
// round's loads do not wait on each other and the exit test is paid once a
// round. Four ballots, one per point of the lane, skip a round without a
// hit and give each hit its slot (the count so far + the hits of the lower
// lanes + the lane's own earlier hits); the hit's lane writes its index to
// the warp's ring of picks in shared memory (BALL_RING slots: two rounds of
// hits). The padding is applied in the ring, which is written out
// BALL_FLUSH slots at a time as one contiguous run of the query's rows
// (16-byte stores where nsample allows): the indices, each pick's
// coordinates minus the centre (read from the staged cloud, or from device
// memory when the cloud is streamed), and for the feature kernel the picked
// feature rows.
//
// Exactness: d = ((dx*dx + dy*dy) + dz*dz) with the _rn intrinsics (no FMA
// contraction), a hit is d <= r2 (r2 the f32 of the caller's radius *
// radius), coordinates minus the centre by __fsub_rn: bit for bit the plain
// PyTorch versions. No atomics: repeats are bit-identical.
#pragma once

#include "common.cuh"
#include "knn_select.cuh"  // FULL_MASK, cp_async4

constexpr int BALL_WARPS = 8;  // warps a CTA, one query each at a time
constexpr int BALL_THREADS = 32 * BALL_WARPS;
constexpr int BALL_ROUND = 128;  // points a warp tests a round, 4 a lane
constexpr int BALL_RING = 256;   // pick slots a warp keeps in shared memory
constexpr int BALL_FLUSH = 128;  // slots written out at a time

// One warp's query; every lane holds the same values.
struct BallQuery {
  float qx, qy, qz;
  int count;    // hits seen, in ascending index
  int flushed;  // slots [0, flushed) are written out
  int first;    // the first hit's index, -1 before it
};

// Shared memory of a CTA, in floats: the staged cloud (one or two [3][chunk]
// f32 buffers), then each warp's ring of min(nsample, BALL_RING) indices.
static __host__ __device__ __forceinline__ int ball_smem_floats(int N, int nsample, int chunk) {
  const int cap = nsample < BALL_RING ? nsample : BALL_RING;
  return (N <= chunk ? 1 : 2) * 3 * chunk + BALL_WARPS * cap;
}

// Tests the staged points [0, n) of a chunk (cs: [3][chunk], padded with
// NaN to a whole round) whose first point is j0 against the warp's query,
// a round at a time, until nsample slots are full; each hit's index goes to
// its slot s at ring[s % BALL_RING]. flush(f, e) writes slots [f, e) out.
template <class Flush>
static __device__ __forceinline__ void ball_walk(const float* cs, int chunk, int j0, int n,
                                                 float r2, int nsample, BallQuery& w, int* ring,
                                                 const Flush& flush) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const float4* px4 = reinterpret_cast<const float4*>(cs) + lane;
  const float4* py4 = px4 + chunk / 4;
  const float4* pz4 = py4 + chunk / 4;
  int j = j0 + 4 * lane;  // the lane's first point of the round
  for (int t = 0; t < n && w.count < nsample;
       t += BALL_ROUND, j += BALL_ROUND, px4 += 32, py4 += 32, pz4 += 32) {
    const float4 X = *px4, Y = *py4, Z = *pz4;
    const float px[4] = {X.x, X.y, X.z, X.w};
    const float py[4] = {Y.x, Y.y, Y.z, Y.w};
    const float pz[4] = {Z.x, Z.y, Z.z, Z.w};
    bool hit[4];
    unsigned m[4];  // m[k]: the lanes whose point k is a hit
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      hit[k] = sq3(__fsub_rn(w.qx, px[k]), __fsub_rn(w.qy, py[k]), __fsub_rn(w.qz, pz[k])) <= r2;
      m[k] = __ballot_sync(FULL_MASK, hit[k]);
    }
    const unsigned any = m[0] | m[1] | m[2] | m[3];
    if (!any) continue;
    if (w.first < 0) {  // the lowest lane with a hit, its lowest point
      const int L = __ffs(any) - 1;
      const int k0 = (m[0] >> L) & 1 ? 0 : (m[1] >> L) & 1 ? 1 : (m[2] >> L) & 1 ? 2 : 3;
      w.first = j0 + t + 4 * L + k0;
    }
    // point k's slot: the count so far, the lower lanes' hits, the lane's
    // hits before k; stored without a branch
    int slot = w.count + __popc(m[0] & below) + __popc(m[1] & below) + __popc(m[2] & below) +
               __popc(m[3] & below);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (hit[k] && slot < nsample) ring[slot & (BALL_RING - 1)] = j + k;
      slot += hit[k];
    }
    w.count += __popc(m[0]) + __popc(m[1]) + __popc(m[2]) + __popc(m[3]);
    // fewer than BALL_FLUSH slots wait at a round's start, at most
    // BALL_ROUND join them: the ring never laps itself
    if (min(w.count, nsample) - w.flushed >= BALL_FLUSH) {
      __syncwarp();
      flush(w.flushed, w.flushed + BALL_FLUSH);
      w.flushed += BALL_FLUSH;
      __syncwarp();
    }
  }
}

// Pads slots [count, nsample) in the ring with the first hit, or with
// point N - 1 when the ball is empty, and writes out every slot not yet
// written, at most BALL_FLUSH at a time.
template <class Flush>
static __device__ __forceinline__ void ball_finish(int N, int nsample, BallQuery& w, int* ring,
                                                   const Flush& flush) {
  const int lane = threadIdx.x & 31;
  const int pad = w.first >= 0 ? w.first : N - 1;
  while (w.flushed < nsample) {
    const int e = min(w.flushed + BALL_FLUSH, nsample);
    for (int s = max(w.count, w.flushed) + lane; s < e; s += 32) ring[s & (BALL_RING - 1)] = pad;
    __syncwarp();
    flush(w.flushed, e);
    w.flushed = e;
    __syncwarp();
  }
}

// Where the store reads the picks' coordinates: coordinate k of point j is
// base[j * js + k * ks], the staged cloud in shared memory ([3][chunk]: js
// 1, ks chunk) when it is staged whole, else the cloud in device memory
// ([N][3]: js 3, ks 1).
struct BallCoords {
  const float* base;
  int js, ks;
};

// Writes slots [f, e) of the query's picks (ring) to its rows io ([nsample]
// int32) and ro ([nsample][3] f32): each pick's coordinates minus the
// centre. VEC (nsample a multiple of 4, rows on 16 bytes; then f and e are
// multiples of 4): 16-byte stores, a lane's four coordinates at a time
// (four picks' at a time spilled).
template <bool VEC>
static __device__ __forceinline__ void ball_store(BallCoords xs, const BallQuery& w,
                                                  const int* ring, int f, int e,
                                                  int* __restrict__ io, float* __restrict__ ro) {
  const int lane = threadIdx.x & 31;
  auto rel = [&](int c) {  // element c of the [nsample][3] row
    const int s = c / 3, k = c - 3 * s;
    return __fsub_rn(xs.base[(size_t)ring[s & (BALL_RING - 1)] * xs.js + k * xs.ks],
                     k == 0 ? w.qx : (k == 1 ? w.qy : w.qz));
  };
  if constexpr (VEC) {
    for (int g = f / 4 + lane; g < e / 4; g += 32)
      reinterpret_cast<int4*>(io)[g] = reinterpret_cast<const int4*>(ring)[g & (BALL_RING / 4 - 1)];
    for (int g = 3 * f / 4 + lane; g < 3 * e / 4; g += 32)
      reinterpret_cast<float4*>(ro)[g] = make_float4(rel(4 * g), rel(4 * g + 1), rel(4 * g + 2),
                                                     rel(4 * g + 3));
  } else {
    for (int s = f + lane; s < e; s += 32) io[s] = ring[s & (BALL_RING - 1)];
    for (int c = 3 * f + lane; c < 3 * e; c += 32) ro[c] = rel(c);
  }
}

// Copies the feature rows of slots [f, e) (row ring[slot] of `feats`,
// row_bytes each) to the query's output rows fo ([nsample][row_bytes]), in
// units of V, which divides a row: one contiguous run, neighbouring lanes
// on neighbouring units. Each lane has two loads in flight before it
// stores; the stores stream (the next layer reads fj once).
template <typename V>
static __device__ __forceinline__ void ball_copy_rows(const char* __restrict__ feats,
                                                      const int* ring, int f, int e,
                                                      int row_bytes, char* __restrict__ fo) {
  constexpr int U = 2;  // 4 in flight spilled at 64 registers
  const int lane = threadIdx.x & 31;
  const int per_row = row_bytes / (int)sizeof(V);
  const int c1 = e * per_row;
  V* o = reinterpret_cast<V*>(fo);
  for (int c = f * per_row + lane; c < c1; c += 32 * U) {
    V v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int cc = c + 32 * u;
      if (cc < c1) {
        const int s = cc / per_row;
        const V* row = reinterpret_cast<const V*>(
            feats + (size_t)ring[s & (BALL_RING - 1)] * row_bytes);
        v[u] = __ldg(row + (cc - s * per_row));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c + 32 * u < c1) __stcs(o + c + 32 * u, v[u]);
  }
}

// Stages chunk c of cloud p ([N][3]) into buffer c % 2 of sm as [3][chunk],
// transposed by 4-byte copies, NaN past its end to a whole round; one
// cp.async group. Every thread of the CTA calls it.
static __device__ __forceinline__ void ball_stage(const float* __restrict__ p, int N, int chunk,
                                                  int c, float* sm) {
  float* dst = sm + (c & 1) * 3 * chunk;
  const float* src = p + (size_t)c * chunk * 3;
  const int n = min(chunk, N - c * chunk);
  for (int e = threadIdx.x; e < 3 * n; e += BALL_THREADS) {
    const int j = e / 3;
    cp_async4(dst + (e - 3 * j) * chunk + j, src + e);
  }
  const int n_pad = (n + BALL_ROUND - 1) / BALL_ROUND * BALL_ROUND;  // <= chunk
  for (int j = n + threadIdx.x; j < n_pad; j += BALL_THREADS)
    dst[j] = dst[chunk + j] = dst[2 * chunk + j] = __int_as_float(0x7fc00000);
  cp_async_commit();
}

// flush(f, e): emit(xs, w, s, f, e, ring), inlined where the walk and the
// padding call it (a lambda there was outlined, its call spilling)
template <class Emit>
struct BallFlush {
  const Emit& emit;
  BallCoords xs;
  const BallQuery& w;
  int s;
  const int* ring;
  __device__ __forceinline__ void operator()(int f, int e) const { emit(xs, w, s, f, e, ring); }
};

// The ball query of one CTA: queries tile + i BALL_WARPS + warp (i < qw) of
// cloud blockIdx.y, tile = blockIdx.x qw BALL_WARPS; xyz [B][N][3], q
// [B][S][3]; `chunk` (a multiple of BALL_ROUND) points a stage: MULTI when
// N > chunk (chunks streamed), else the cloud in one stage of `chunk`
// points (a separate instantiation: the streamed path's state in the
// same code made ptxas recompute the walk's addresses every round); `sm`
// is ball_smem_floats() floats. emit(xs, w, s, f, e, ring) writes slots
// [f, e) of query s (its state w) out of the warp's ring, the picks'
// coordinates read from xs. Every thread of the CTA calls it; qw <= 32.
template <bool MULTI, class Emit>
static __device__ __forceinline__ void ball_select(const float* __restrict__ xyz,
                                                   const float* __restrict__ q, int N, int S,
                                                   int nsample, float r2, int qw, int chunk,
                                                   float* sm, const Emit& emit) {
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y, tile = blockIdx.x * qw * BALL_WARPS;
  const float* p = xyz + (size_t)b * N * 3;
  int* ring = reinterpret_cast<int*>(sm + (MULTI ? 2 : 1) * 3 * chunk) +
              warp * min(nsample, BALL_RING);
  auto stage = [&](int c) { ball_stage(p, N, chunk, c, sm); };
  // the coordinates of the warp's qw queries: query i's in lane i, loaded
  // before the cloud arrives
  const int lane = threadIdx.x & 31;
  const int s_lane = tile + lane * BALL_WARPS + warp;
  float qv[3] = {0.f, 0.f, 0.f};
  if (lane < qw && s_lane < S) {
    const float* qp = q + ((size_t)b * S + s_lane) * 3;
    qv[0] = qp[0];
    qv[1] = qp[1];
    qv[2] = qp[2];
  }
  auto query = [&](int i) {
    return BallQuery{__shfl_sync(FULL_MASK, qv[0], i), __shfl_sync(FULL_MASK, qv[1], i),
                     __shfl_sync(FULL_MASK, qv[2], i), 0, 0, -1};
  };

  if constexpr (!MULTI) {  // staged once; then each warp runs on alone
    stage(0);
    cp_async_wait<0>();
    __syncthreads();
    const BallCoords xs{sm, 1, chunk};
    for (int i = 0; i < qw; ++i) {
      const int s = tile + i * BALL_WARPS + warp;
      if (s >= S) break;
      BallQuery w = query(i);
      const BallFlush<Emit> flush{emit, xs, w, s, ring};
      ball_walk(sm, chunk, 0, N, r2, nsample, w, ring, flush);
      ball_finish(N, nsample, w, ring, flush);
    }
    return;
  }
  // chunks streamed once for each of a warp's queries, the CTA's warps in
  // step; the stream stops when every warp's ball is full
  const int n_chunks = (N + chunk - 1) / chunk;
  const BallCoords xs{p, 3, 1};
  for (int i = 0; i < qw && tile + i * BALL_WARPS < S; ++i) {
    const int s = tile + i * BALL_WARPS + warp;
    const bool live = s < S;
    BallQuery w = query(i);
    const BallFlush<Emit> flush{emit, xs, w, s, ring};
    bool open = live;
    stage(0);
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) {
        stage(c + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (open) {
        ball_walk(sm + (c & 1) * 3 * chunk, chunk, c * chunk, min(chunk, N - c * chunk), r2,
                  nsample, w, ring, flush);
        open = w.count < nsample;
      }
      // also the barrier before buffer c % 2 is restaged, two chunks on
      if (!__syncthreads_or(open)) break;
    }
    cp_async_wait<0>();  // a stage left in flight by the early stop
    __syncthreads();
    if (live) ball_finish(N, nsample, w, ring, flush);
  }
}
