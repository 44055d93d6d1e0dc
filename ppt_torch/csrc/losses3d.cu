// Reconstruction-loss kernels of PointBERT's dVAE: the nearest-neighbour
// squared distances behind the Chamfer distance, and the auction
// approxmatch behind the EMD.
//
// Replaces ppt_tpu/kernels/chamfer.py:chamfer_pallas (_nn_dist_kernel,
// _nn_dists) and ppt_tpu/kernels/emd.py:approx_match_pallas
// (_approx_match_kernel).
//
// nn_dists: for each query q of cloud b, min over the support points x of
//   cloud b of ((qx-xs)^2 + (qy-ys)^2) + (qz-zs)^2, in f32, with the _rn
//   intrinsics so that nvcc cannot contract the sum into FMAs: the result
//   is the plain PyTorch version's bit for bit. Bound by issue at large
//   clouds: the exact form is 3 FADD, 3 FMUL, 2 FADD and an FMNMX a pair,
//   9 instructions with no FMA to pair them (the 9-operations bound at 67
//   TFLOP/s assumes pairing), ~0.58 ms at 4 x 16384 x 16384 both ways at
//   1.98 GHz; by launch and latency at the dVAE's 4096 clouds of 8 and 32
//   points. Design (nn_dists_kernel<Q>): a thread owns Q = 1, 2 or 4
//   queries of one cloud in registers, so that one 16-byte shared load of a
//   support point (x, y, z, pad) feeds Q pairs; the query groups of all
//   clouds are flattened, so many tiny clouds share a block of 128 threads;
//   the support points of the clouds a block touches stream through shared
//   memory in tiles of 1024, and each thread scans only the part of a tile
//   that is its own cloud's. A second grid dimension splits a block's
//   support range into `split` chunks (at most 8); the split CTAs of one
//   query block form a thread-block cluster, and rank 0 takes the min over
//   the others' partial minima through distributed shared memory: a min is
//   exact in any order, so the split changes no bit, and there are no
//   atomics and no second pass. Both directions of a Chamfer distance go
//   in one launch (two NnDir, one grid). kernels/chamfer.py:nn_plan picks
//   Q and the split: the most queries a thread whose grid reaches four CTAs
//   an SM (chip_smoke.py --only losses3d times every Q and split at its
//   shapes). The tail is masked by index: no padding copy, no [B, N, M]
//   matrix. Tried: 8 queries a thread (the fastest at no shape swept);
//   the first port's kernel, one query a thread with three shared floats a
//   pair, one block of 256 queries scanning its whole cloud (64 blocks for
//   132 SMs at 8 x 2048 x 2048).
//
// approx_match: Fan's ten-level auction over d2 [B, N, M] (the squared
//   distances, clamped at 0, computed outside as the reference does). Per
//   level, with w = expf(level * d2):
//     suml = 1e-9 + sum_m w remain_r;       ratio_l = remain_l / suml
//     sumr = (sum_n w ratio_l) remain_r;    consumption = min(remain_r / (sumr + 1e-9), 1)
//     ratio_r = consumption remain_r;       remain_r = max(0, remain_r - sumr)
//     match += w ratio_l ratio_r;           remain_l = max(0, remain_l - sum_m flow)
//   the update order of _approx_match_kernel, every op rounded on its own.
//   expf, not __expf: at level -16384 the argument is large, where the
//   fast intrinsic's error grows. No atomics: every sum has a fixed order
//   and repeats are bit-identical.
//
//   Clouds of at most 32 points a side (kAmWarpMax; the dVAE's 8 x 32 and
//   32 x 32: kernels/emd.py:warp_auction, which the plain version's order
//   follows) run approx_match_warp_kernel: one warp owns one cloud for all
//   ten levels, 4 clouds a block. The larger side sits on the lanes (M=32
//   for the dVAE's 8 x 32, so all 32 lanes work), the other in R
//   registers a lane (R = 8, 16 or 32, a template). Each lane holds its
//   d2, its bids w (computed once a level and used by all three updates)
//   and its match, which accumulates in registers and is written once.
//   Sums along the registers are lane-local; sums along the lanes go
//   through one transpose in shared memory (row stride 36 floats: the
//   lane-wide stores and the owning lanes' float4 row reads are free of
//   bank conflicts), each summed by the lane that owns the row. Every sum
//   is four partial sums in index order, then (s0 + s1) + (s2 + s3)
//   (Sum4): both orientations give the same bits, and four chains of adds
//   replace one. Rows and columns past the cloud carry no supply, as the
//   TPU kernel pads, so no loop has a guard. No shuffle trees, only
//   __syncwarp. Bound by issue: ~25 instructions a pair and level (the
//   accurate expf ~10, the transposes' stores, two IEEE divisions a lane),
//   1.3e9 thread instructions for the dVAE's 4096 x (256 + 1024) pairs,
//   ~40 us on 132 SMs; the 32 x 32 instance needs 168 registers (12 warps
//   an SM, 2.6 waves of the 4096 clouds). Tried: one chain of adds a sum
//   (as fast: the chains were not the bound), guards on every register and
//   lane past the cloud (slower at the dVAE's shapes), a cap of 128
//   registers (it spilled); the first port's kernel, below: one block of 32
//   threads a cloud, a five-shuffle warp sum for every row, the bid's expf
//   three times a level, 2% of its bound.
//
//   Larger clouds (no path sends them today) run approx_match_kernel,
//   unchanged: one block owns one cloud for all ten levels; rows go to
//   warps (lanes over m, coalesced, a fixed-order warp sum), columns to
//   threads (each sums its column over n in order). When d2 and match fit
//   shared memory they are staged there; otherwise d2 streams from device
//   memory (it stays in L2) in each of a level's three passes and match
//   accumulates in the output. The four supply vectors sit in shared
//   memory, or in a device scratch the wrapper allocates when even they do
//   not fit. Rows past N and columns past M do not exist: no padding and
//   no supply to mask.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

PPT_ERROR_STRING_FN

static constexpr int kSmemLimit = 232448;  // 227 KB, a block's dynamic shared memory

// ---------------------------------------------------------------------------
// nn_dists
// ---------------------------------------------------------------------------

// kernels/chamfer.py's plan mirrors these three; a thread's queries (Q, in
// registers) are 1, 2 or 4, the plan's choice
constexpr int kNnMaxQ = 4;
constexpr int kNnThreads = 128;
constexpr int kNnMaxSplit = 8;  // CTAs a cluster (the portable cluster size)
constexpr int kNnTile = 1024;   // support points staged a round, 16 bytes each

// One direction: queries q [B, N, 3] against support x [B, M, 3] -> out
// [B, N]; `blocks` CTAs along x (0: no direction).
struct NnDir {
  const float* q;
  const float* x;
  float* out;
  int B, N, M, blocks;
};

static int nn_blocks(int B, int N, int Q) {
  const long long groups = (long long)B * ((N + Q - 1) / Q);
  return (int)((groups + kNnThreads - 1) / kNnThreads);
}

template <int Q>
__global__ void __launch_bounds__(kNnThreads)
nn_dists_kernel(const NnDir d0, const NnDir d1, int split) {
  __shared__ float4 sx[kNnTile];
  __shared__ float part[Q * kNnThreads];  // the partial minima a cluster combines
  const bool second = blockIdx.x >= (unsigned)d0.blocks;
  const NnDir d = second ? d1 : d0;
  const long long bx = second ? blockIdx.x - d0.blocks : blockIdx.x;
  const int groups = (d.N + Q - 1) / Q;  // query groups a cloud
  const long long total = (long long)d.B * groups;
  const long long g0 = bx * kNnThreads;
  const long long g_last = min(g0 + kNnThreads, total) - 1;
  const long long gid = g0 + threadIdx.x;
  const bool valid = gid < total;
  const long long b = valid ? gid / groups : 0;
  const int n0 = valid ? (int)(gid - b * groups) * Q : 0;
  const int nq = valid ? min(Q, d.N - n0) : 0;

  // the support points of the clouds this block's queries belong to, this
  // CTA's chunk of them
  const long long s_begin = (g0 / groups) * d.M;
  const long long s_end = (g_last / groups + 1) * d.M;
  const long long chunk = (s_end - s_begin + split - 1) / split;
  const long long c_begin = min(s_end, s_begin + blockIdx.y * chunk);
  const long long c_end = min(s_end, c_begin + chunk);
  const long long my_begin = b * d.M;
  const long long my_end = valid ? my_begin + d.M : my_begin;

  float qx[Q], qy[Q], qz[Q], best[Q];
  const float* qp = d.q + (b * d.N + n0) * 3;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int kk = k < nq ? k : 0;  // slots past the cloud's last query repeat its first
    qx[k] = qp[kk * 3 + 0];
    qy[k] = qp[kk * 3 + 1];
    qz[k] = qp[kk * 3 + 2];
    best[k] = __int_as_float(0x7f800000);  // +inf, the reference's initial running min
  }

  for (long long t0 = c_begin; t0 < c_end; t0 += kNnTile) {
    const int len = (int)min((long long)kNnTile, c_end - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kNnThreads) {
      const float* p = d.x + (t0 + i) * 3;
      sx[i] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
    const int lo = (int)max(0LL, my_begin - t0);
    const int hi = (int)max(0LL, min(my_end, t0 + len) - t0);
#pragma unroll 4
    for (int j = lo; j < hi; ++j) {
      const float4 s = sx[j];
#pragma unroll
      for (int k = 0; k < Q; ++k)
        best[k] = fminf(best[k], sq3(__fsub_rn(qx[k], s.x), __fsub_rn(qy[k], s.y),
                                     __fsub_rn(qz[k], s.z)));
    }
  }

  if (split > 1) {  // the cluster's CTAs hold one query block's minima over `split` chunks
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int k = 0; k < Q; ++k) part[k * kNnThreads + threadIdx.x] = best[k];
    cluster.sync();
    const bool lead = cluster.block_rank() == 0;
    if (lead) {
      for (int r = 1; r < split; ++r) {
        const float* other = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int k = 0; k < Q; ++k)
          best[k] = fminf(best[k], other[k * kNnThreads + threadIdx.x]);
      }
    }
    cluster.sync();  // the others' shared memory stays until rank 0 has read it
    if (!lead) return;
  }
  float* o = d.out + b * d.N + n0;
#pragma unroll
  for (int k = 0; k < Q; ++k)
    if (k < nq) o[k] = best[k];
}

// A kernel that returns at once, launched as nn_dists_kernel is: the least
// time a launch of that shape takes.
__global__ void nn_floor_kernel(const NnDir, const NnDir, int) {}

using NnKernel = void (*)(const NnDir, const NnDir, int);

static NnKernel nn_instance(int Q) {
  switch (Q) {
    case 1: return nn_dists_kernel<1>;
    case 2: return nn_dists_kernel<2>;
    case kNnMaxQ: return nn_dists_kernel<kNnMaxQ>;
    default: return nullptr;
  }
}

static int nn_launch(NnKernel kernel, const NnDir& d0, const NnDir& d1, int split, size_t smem,
                     cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(d0.blocks + d1.blocks, split);
  cfg.blockDim = dim3(kNnThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, d0, d1, split);
  return e == cudaSuccess ? (int)cudaGetLastError() : (int)e;
}

static bool nn_dirs(const void* q0, const void* x0, void* out0, int B0, int N0, int M0,
                    const void* q1, const void* x1, void* out1, int B1, int N1, int M1,
                    int Q, int split, NnDir& d0, NnDir& d1) {
  if (nn_instance(Q) == nullptr || split < 1 || split > kNnMaxSplit) return false;
  d0 = NnDir{(const float*)q0, (const float*)x0, (float*)out0, B0, N0, M0, 0};
  d1 = NnDir{(const float*)q1, (const float*)x1, (float*)out1, B1, N1, M1, 0};
  NnDir* dirs[2] = {&d0, &d1};
  for (NnDir* d : dirs) {
    if (d->B < 0 || d->N < 0) return false;
    if ((long long)d->B * d->N == 0) continue;  // no queries: no blocks
    if (d->M < 1) return false;
    d->blocks = nn_blocks(d->B, d->N, Q);
  }
  return d0.blocks + d1.blocks > 0;
}

// ---------------------------------------------------------------------------
// approx_match
// ---------------------------------------------------------------------------

// -4^j for j = 7..-1, then an exact level 0 (ppt_tpu/kernels/emd.py:46)
__constant__ float kLevels[10] = {-16384.f, -4096.f, -1024.f, -256.f, -64.f,
                                  -16.f,    -4.f,    -1.f,    -0.25f, 0.f};

constexpr int kAmWarpMax = 32;  // the warp kernel's limit on either side (kernels/emd.py)
constexpr int kAmWarps = 4;     // clouds a block, one a warp
constexpr int kAmStride = 36;   // the transpose's row stride in floats: 32 lanes + 4

// The warp kernel's summation order, over v[0..n-1]: four partial sums of
// the entries k = j, j + 4, ... (j = 0..3), each in index order, then
// (s0 + s1) + (s2 + s3). Four independent chains of adds, where one chain
// of n would hold the warp for 4n cycles. kernels/emd.py:_sum4 is its
// plain counterpart.
struct Sum4 {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  __device__ __forceinline__ void add(int k, float v) { s[k & 3] = __fadd_rn(s[k & 3], v); }
  __device__ __forceinline__ float total() const {
    return __fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3]));
  }
};

// One owning lane's sum of its transposed row, all 32 lanes' entries (those
// past the lane axis are +0), in the Sum4 order, read as float4.
static __device__ __forceinline__ float lane_axis_sum(const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  Sum4 acc;
#pragma unroll
  for (int k = 0; k < 32; k += 4) {
    const float4 v = r4[k / 4];
    acc.add(k, v.x);
    acc.add(k + 1, v.y);
    acc.add(k + 2, v.z);
    acc.add(k + 3, v.w);
  }
  return acc.total();
}

// v[i] of a warp's broadcast vector, read 16 bytes at a time: in a fully
// unrolled loop over i the four reads of one float4 fold into one load.
static __device__ __forceinline__ float bcast(const float* v, int i) {
  const float4 q = reinterpret_cast<const float4*>(v)[i >> 2];
  return (i & 3) == 0 ? q.x : (i & 3) == 1 ? q.y : (i & 3) == 2 ? q.z : q.w;
}

// One warp a cloud. kLanesM: lane = column m, register i = row n (R >= N);
// else lane = row n, register i = column m (R >= M).
// One block an SM at least: ptxas takes the registers it needs, where its
// own cap, or one of 128, spilled a value kept across the division's
// slow-path call in one instance or another.
//
// Rows past N and columns past M (lanes past the lane axis, registers past
// the register axis) hold d2 = 0 and no supply, as the TPU kernel pads:
// their ratios are exactly 0, so every flow and every product they add to
// a real sum is +0, which changes no bit, and no loop needs a guard.
template <int R, bool kLanesM>
__global__ void __launch_bounds__(kAmWarps * 32, 1)
approx_match_warp_kernel(const float* __restrict__ d2, int B, int N, int M, float multi_l,
                         float multi_r, float* __restrict__ match) {
  __shared__ __align__(16) float tr[kAmWarps][R * kAmStride];
  __shared__ __align__(16) float vec[kAmWarps][2][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kAmWarps + warp;
  if (b >= B) return;  // whole warps only: nothing below syncs the block
  float* T = tr[warp];
  float* V0 = vec[warp][0];  // kLanesM: ratio_l; else remain_r
  float* V1 = vec[warp][1];  // else: ratio_r
  const int nl = kLanesM ? M : N;  // the lane axis
  const int nr = kLanesM ? N : M;  // the register axis
  const float* D = d2 + b * N * M;

  float d[R], w[R], mt[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    d[i] = 0.f;
    mt[i] = 0.f;
    if (lane < nl && i < nr) d[i] = kLanesM ? D[i * M + lane] : D[lane * M + i];
  }
  // the lane's own supplies: kLanesM, remain_r of column `lane` and remain_l
  // of row `lane`; else remain_l of row `lane` and remain_r of column `lane`
  // (broadcast through V0)
  float own_l = lane < N ? multi_l : 0.f;
  float own_r = lane < M ? multi_r : 0.f;
  if (!kLanesM) {
    V0[lane] = own_r;
    __syncwarp();
  }

#pragma unroll 1
  for (int lv = 0; lv < 10; ++lv) {
    const float level = kLevels[lv];
#pragma unroll
    for (int i = 0; i < R; ++i) w[i] = expf(__fmul_rn(level, d[i]));
    if (kLanesM) {
      // suml over the lanes: transpose w * remain_r, row n summed by lane n
#pragma unroll
      for (int i = 0; i < R; ++i) T[i * kAmStride + lane] = __fmul_rn(w[i], own_r);
      __syncwarp();
      if (lane < R) V0[lane] = own_l / __fadd_rn(1e-9f, lane_axis_sum(T + lane * kAmStride));
      __syncwarp();
      // sumr over the registers, with w now w * ratio_l
      Sum4 col;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        w[i] = __fmul_rn(w[i], bcast(V0, i));
        col.add(i, w[i]);
      }
      const float sumr = __fmul_rn(col.total(), own_r);
      const float consumption = fminf(own_r / __fadd_rn(sumr, 1e-9f), 1.f);
      const float ratio_r = __fmul_rn(consumption, own_r);
      own_r = fmaxf(0.f, __fsub_rn(own_r, sumr));
      // the flow into match, and its row sums over the lanes
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float f = __fmul_rn(w[i], ratio_r);
        mt[i] = __fadd_rn(mt[i], f);
        T[i * kAmStride + lane] = f;
      }
      __syncwarp();
      if (lane < R) own_l = fmaxf(0.f, __fsub_rn(own_l, lane_axis_sum(T + lane * kAmStride)));
      __syncwarp();
    } else {
      // suml over the registers
      Sum4 row;
#pragma unroll
      for (int i = 0; i < R; ++i) row.add(i, __fmul_rn(w[i], bcast(V0, i)));
      const float ratio_l = own_l / __fadd_rn(1e-9f, row.total());
      // sumr over the lanes: transpose w * ratio_l, column m summed by lane m
#pragma unroll
      for (int i = 0; i < R; ++i) {
        w[i] = __fmul_rn(w[i], ratio_l);
        T[i * kAmStride + lane] = w[i];
      }
      __syncwarp();
      if (lane < R) {
        const float sumr = __fmul_rn(lane_axis_sum(T + lane * kAmStride), own_r);
        const float consumption = fminf(own_r / __fadd_rn(sumr, 1e-9f), 1.f);
        V1[lane] = __fmul_rn(consumption, own_r);
        own_r = fmaxf(0.f, __fsub_rn(own_r, sumr));
        V0[lane] = own_r;
      }
      __syncwarp();
      // the flow into match, and its row sum over the registers
      Sum4 flow;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float f = __fmul_rn(w[i], bcast(V1, i));
        mt[i] = __fadd_rn(mt[i], f);
        flow.add(i, f);
      }
      own_l = fmaxf(0.f, __fsub_rn(own_l, flow.total()));
    }
  }
  // the thread's indices read anew: a value kept from before the levels
  // across the division's slow-path call was spilled to the stack
  unsigned tid, cta;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(cta));
  const unsigned lane_now = tid & 31;
  if (lane_now < (unsigned)nl) {
    float* out = match + ((long long)cta * kAmWarps + (tid >> 5)) * N * M;
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (i < nr) out[kLanesM ? i * M + lane_now : lane_now * M + i] = mt[i];
  }
}

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

static __device__ __forceinline__ float bid(float level, float d2) {
  return expf(__fmul_rn(level, d2));
}

__global__ void __launch_bounds__(1024)
approx_match_kernel(const float* __restrict__ d2, int N, int M, float multi_l, float multi_r,
                    int staged, float* __restrict__ vec_scratch, float* __restrict__ match) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = T >> 5;
  const size_t cloud = (size_t)N * M;

  float* vec = vec_scratch ? vec_scratch + (size_t)b * 2 * (N + M) : sm;
  float* remain_l = vec;
  float* ratio_l = vec + N;
  float* remain_r = vec + 2 * N;
  float* ratio_r = remain_r + M;
  const float* D = d2 + b * cloud;
  float* MT = match + b * cloud;
  if (staged) {
    float* sd = sm + 2 * (N + M);
    for (size_t i = tid; i < cloud; i += T) sd[i] = D[i];
    D = sd;
    MT = sd + cloud;
  }
  for (int i = tid; i < N; i += T) remain_l[i] = multi_l;
  for (int i = tid; i < M; i += T) remain_r[i] = multi_r;
  __syncthreads();

  for (int lv = 0; lv < 10; ++lv) {
    const float level = kLevels[lv];
    // rows: suml and ratio_l
    for (int n = warp; n < N; n += n_warps) {
      const float* row = D + (size_t)n * M;
      float s = 0.f;
      for (int m = lane; m < M; m += 32)
        s = __fadd_rn(s, __fmul_rn(bid(level, row[m]), remain_r[m]));
      s = warp_sum(s);
      if (lane == 0) ratio_l[n] = remain_l[n] / __fadd_rn(1e-9f, s);
    }
    __syncthreads();
    // columns: sumr, consumption, ratio_r, remain_r
    for (int m = tid; m < M; m += T) {
      float s = 0.f;
      for (int n = 0; n < N; ++n)
        s = __fadd_rn(s, __fmul_rn(bid(level, D[(size_t)n * M + m]), ratio_l[n]));
      const float rr = remain_r[m];
      const float sumr = __fmul_rn(s, rr);
      const float consumption = fminf(rr / __fadd_rn(sumr, 1e-9f), 1.f);
      ratio_r[m] = __fmul_rn(consumption, rr);
      remain_r[m] = fmaxf(0.f, __fsub_rn(rr, sumr));
    }
    __syncthreads();
    // rows: flow into match, remain_l
    for (int n = warp; n < N; n += n_warps) {
      const float* row = D + (size_t)n * M;
      float* mrow = MT + (size_t)n * M;
      const float rl = ratio_l[n];
      float s = 0.f;
      for (int m = lane; m < M; m += 32) {
        const float f = __fmul_rn(__fmul_rn(bid(level, row[m]), rl), ratio_r[m]);
        mrow[m] = lv == 0 ? f : __fadd_rn(mrow[m], f);
        s = __fadd_rn(s, f);
      }
      s = warp_sum(s);
      if (lane == 0) remain_l[n] = fmaxf(0.f, __fsub_rn(remain_l[n], s));
    }
    __syncthreads();
  }
  if (staged) {
    float* out = match + b * cloud;
    for (size_t i = tid; i < cloud; i += T) out[i] = MT[i];
  }
}

// A kernel that returns at once: launched on an approx_match launch's grid,
// block and shared memory, the least time that launch takes.
__global__ void approx_match_floor_kernel() {}

using WarpKernel = void (*)(const float*, int, int, int, float, float, float*);

// The warp kernel's instance for an N x M cloud, and its static shared
// memory; null past kAmWarpMax.
static WarpKernel approx_match_warp_instance(int N, int M, size_t* smem) {
  if (N < 1 || M < 1 || N > kAmWarpMax || M > kAmWarpMax) return nullptr;
  const bool lanes_m = M >= N;
  const int nr = lanes_m ? N : M;
  const int R = nr <= 8 ? 8 : (nr <= 16 ? 16 : 32);
  *smem = sizeof(float) * kAmWarps * (R * kAmStride + 64);
  if (R == 8) return lanes_m ? approx_match_warp_kernel<8, true> : approx_match_warp_kernel<8, false>;
  if (R == 16)
    return lanes_m ? approx_match_warp_kernel<16, true> : approx_match_warp_kernel<16, false>;
  return lanes_m ? approx_match_warp_kernel<32, true> : approx_match_warp_kernel<32, false>;
}

// Threads for one cloud of the block kernel: a warp per 32 rows or
// columns, at most 1024.
static int approx_match_threads(int N, int M) {
  const int wide = N > M ? N : M;
  const int warps = (wide + 31) / 32;
  return 32 * (warps < 1 ? 1 : (warps > 32 ? 32 : warps));
}

// Shared memory the block kernel asks for: the supply vectors, and d2 with
// match when both fit beside them (staged); 0 with vec_scratch when the
// vectors alone do not fit.
static size_t approx_match_smem(int N, int M, int* staged) {
  const size_t vec = (size_t)2 * (N + M) * sizeof(float);
  const size_t all = vec + (size_t)2 * N * M * sizeof(float);
  *staged = all <= (size_t)kSmemLimit;
  if (*staged) return all;
  return vec <= (size_t)kSmemLimit ? vec : 0;
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------

// Both directions' minima in one launch (either may have no queries); Q is
// the queries a thread (1, 2 or 4), split the support chunks a query
// block's cluster takes (1..kNnMaxSplit).
PPT_EXPORT int ppt_nn_dists(const void* q0, const void* x0, void* out0, int B0, int N0, int M0,
                            const void* q1, const void* x1, void* out1, int B1, int N1, int M1,
                            int Q, int split, void* stream) {
  NnDir d0, d1;
  if (!nn_dirs(q0, x0, out0, B0, N0, M0, q1, x1, out1, B1, N1, M1, Q, split, d0, d1))
    return (int)cudaErrorInvalidValue;
  return nn_launch(nn_instance(Q), d0, d1, split, 0, (cudaStream_t)stream);
}

PPT_EXPORT int ppt_nn_launch_floor(int B0, int N0, int M0, int B1, int N1, int M1, int Q,
                                   int split, void* stream) {
  NnDir d0, d1;
  float one = 0.f;  // nn_dirs reads only the sizes; the empty kernel reads nothing
  if (!nn_dirs(&one, &one, &one, B0, N0, M0, &one, &one, &one, B1, N1, M1, Q, split, d0, d1))
    return (int)cudaErrorInvalidValue;
  return nn_launch(nn_floor_kernel, d0, d1, split,
                   sizeof(float4) * kNnTile + sizeof(float) * Q * kNnThreads,
                   (cudaStream_t)stream);
}

PPT_EXPORT int ppt_approx_match_needs_scratch(int N, int M) {
  int staged;
  return approx_match_smem(N, M, &staged) == 0;
}

// Clouds of at most kAmWarpMax points a side, one warp each.
PPT_EXPORT int ppt_approx_match_warp(const void* d2, int B, int N, int M, float multi_l,
                                     float multi_r, void* match, void* stream) {
  size_t smem;
  const WarpKernel kernel = approx_match_warp_instance(N, M, &smem);
  if (kernel == nullptr || B < 1) return (int)cudaErrorInvalidValue;
  kernel<<<(B + kAmWarps - 1) / kAmWarps, kAmWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)d2, B, N, M, multi_l, multi_r, (float*)match);
  PPT_CHECK_LAUNCH();
  return 0;
}

// Any cloud, one block each.
PPT_EXPORT int ppt_approx_match(const void* d2, int B, int N, int M, float multi_l,
                                float multi_r, void* vec_scratch, void* match, void* stream) {
  int staged;
  const size_t smem = approx_match_smem(N, M, &staged);
  if (smem == 0 && vec_scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(approx_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  approx_match_kernel<<<B, approx_match_threads(N, M), smem, (cudaStream_t)stream>>>(
      (const float*)d2, N, M, multi_l, multi_r, staged,
      smem == 0 ? (float*)vec_scratch : nullptr, (float*)match);
  PPT_CHECK_LAUNCH();
  return 0;
}

// The launch floor of ppt_approx_match_warp (warp != 0) or ppt_approx_match.
PPT_EXPORT int ppt_approx_match_floor(int B, int N, int M, int warp, void* stream) {
  size_t smem;
  dim3 grid(B), block;
  if (warp) {
    if (approx_match_warp_instance(N, M, &smem) == nullptr || B < 1)
      return (int)cudaErrorInvalidValue;
    grid = dim3((B + kAmWarps - 1) / kAmWarps);
    block = dim3(kAmWarps * 32);
  } else {
    int staged;
    smem = approx_match_smem(N, M, &staged);
    block = dim3(approx_match_threads(N, M));
  }
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(approx_match_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  approx_match_floor_kernel<<<grid, block, smem, (cudaStream_t)stream>>>();
  PPT_CHECK_LAUNCH();
  return 0;
}
