// The k-nearest-neighbour selection that cloud.cu's knn_single_kernel and
// group.cu's knn_gather_kernel both run: one warp a query, the cloud
// streamed through shared memory in chunks, a sorted register queue of
// (distance, index) pairs filtered by a ballot against its k-th pair.
//
// Bound on the H100 by the latency of each query's selection, not by its
// distances (9 operations a point pair). A TPU kernel's k argmin passes over
// a resident distance row are a chain of k x (N / 32 + 10) dependent steps a
// query; here one warp takes one query and a CTA takes KNN_WARPS of them,
// enough CTAs to fill every SM. The cloud streams through shared memory in
// chunks of `chunk` points ([chunk][3] f32 as it lies, double-buffered by
// cp.async, in ascending index order), each chunk read by all the CTA's
// warps. A warp scans a chunk 32 points at a time and keeps a running top-k
// queue of (distance, index) pairs in registers, sorted, one pair a lane for
// k <= 32 and two for k <= 64 (the most any PPT configuration takes). A
// ballot filters the 32 distances against the queue's k-th pair; the few
// survivors are inserted one by one in index order (a warp-wide shift), so
// the serial work per query is about k ln(N / k) insertions instead of k
// full passes. Candidates arrive in ascending index, and every comparison is
// lexicographic on (distance, index), so ties go to the lowest index. k past
// 64 takes ceil(k / 64) passes over the cloud with the same queue, each
// keeping the next 64 pairs after the previous pass's last pick. One design
// serves every N and every k in [1, N]; the shared memory is two chunks
// (24 KB at 1024 points), whatever N is.
//
// Distances are ((dx*dx + dy*dy) + dz*dz) with the _rn intrinsics, the JAX
// kernels' order, so the picks match the plain PyTorch versions bit for bit.
#pragma once

#include <limits.h>

#include "common.cuh"

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

// The k nearest points of cloud p ([N][3] f32) to the warp's query (qx, qy,
// qz), nearest first. Every thread of a KNN_THREADS-thread CTA calls it (it
// stages chunks and synchronises the CTA); a warp whose query is past the
// end passes live = false and only helps to stage. `sm` holds 2 chunk x 3
// floats. A pass keeps the 32 Q smallest pairs lexicographically after (lo_d,
// lo_i) in the warp's queue; k picks take ceil(k / 32 Q) passes over the
// cloud, each bounded below by the last pick of the one before. After each
// pass a live warp calls emit(k0, kk, ix): the pass's kk picks are
// positions k0 + 32 r + lane (32 r + lane < kk) in ix[r].
template <int Q, class Emit>
static __device__ __forceinline__ void knn_select(const float* __restrict__ p, int N, int k,
                                                  int chunk, float* sm, bool live, float qx,
                                                  float qy, float qz, Emit&& emit) {
  constexpr int QN = 32 * Q;
  const int lane = threadIdx.x & 31;
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
    if (live) emit(k0, kk, ix);
    lo_d = td;  // the pass's last pick bounds the next pass
    lo_i = ti;
  }
}
