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
//   is the plain PyTorch version's bit for bit. Bound by operations (9 a
//   pair: 3 sub, 3 mul, 2 add, 1 min) at large clouds, by launch and
//   latency at the dVAE's 4096 clouds of 32 points. Design: one thread
//   owns one query and keeps a running min; the queries of all clouds are
//   flattened, so many tiny clouds share a block of 256 threads; the
//   support points of the clouds the block touches stream through shared
//   memory in tiles of 2048 (structure of arrays), and each thread scans
//   only the part of a tile that is its own cloud's. The tail is masked by
//   index: no padding copy, no [B, N, M] matrix.
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
//   fast intrinsic's error grows. Bound by operations (an expf and ~9 more
//   a pair per level) and by the level-to-level dependence. Design: one
//   block owns one cloud for all ten levels (nothing carries across
//   blocks); rows go to warps (lanes over m, coalesced, a fixed-order warp
//   sum), columns to threads (each sums its column over n in order), so
//   every sum has a fixed order and repeats are bit-identical. When d2 and
//   match fit shared memory (the dVAE's 8 x 32 and 32 x 32 clouds: one
//   warp a cloud) they are staged there and match is written once;
//   otherwise d2 streams from device memory (it stays in L2) in each of a
//   level's three passes and match accumulates in the output. The four
//   supply vectors sit in shared memory, or in a device scratch the
//   wrapper allocates when even they do not fit. Rows past N and columns
//   past M do not exist: no padding and no supply to mask.
#include "common.cuh"

PPT_ERROR_STRING_FN

static constexpr int kSmemLimit = 232448;  // 227 KB, a block's dynamic shared memory

// ---------------------------------------------------------------------------
// nn_dists
// ---------------------------------------------------------------------------

constexpr int kNnThreads = 256;
constexpr int kNnTile = 2048;

__global__ void __launch_bounds__(kNnThreads)
nn_dist_kernel(const float* __restrict__ q, const float* __restrict__ x, int B, int N, int M,
               float* __restrict__ out) {
  __shared__ float xs[kNnTile], ys[kNnTile], zs[kNnTile];
  const long long total = (long long)B * N;
  const long long q0 = (long long)blockIdx.x * kNnThreads;
  const long long q_last = min(q0 + kNnThreads, total) - 1;
  // the support points of the clouds this block's queries belong to
  const long long s_begin = (q0 / N) * M;
  const long long s_end = (q_last / N + 1) * M;

  const long long gq = q0 + threadIdx.x;
  const bool valid = gq < total;
  const long long my_begin = valid ? (gq / N) * M : 0;
  const long long my_end = valid ? my_begin + M : 0;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (valid) {
    qx = q[gq * 3 + 0];
    qy = q[gq * 3 + 1];
    qz = q[gq * 3 + 2];
  }
  float best = __int_as_float(0x7f800000);  // +inf, the reference's initial running min

  for (long long t0 = s_begin; t0 < s_end; t0 += kNnTile) {
    const int len = (int)min((long long)kNnTile, s_end - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kNnThreads) {
      const float* p = x + (t0 + i) * 3;
      xs[i] = p[0];
      ys[i] = p[1];
      zs[i] = p[2];
    }
    __syncthreads();
    const int lo = (int)(max(my_begin, t0) - t0);
    const int hi = (int)(min(my_end, t0 + len) - t0);
    for (int j = lo; j < hi; ++j) {
      const float d = sq3(__fsub_rn(qx, xs[j]), __fsub_rn(qy, ys[j]), __fsub_rn(qz, zs[j]));
      best = fminf(best, d);
    }
  }
  if (valid) out[gq] = best;
}

// ---------------------------------------------------------------------------
// approx_match
// ---------------------------------------------------------------------------

// -4^j for j = 7..-1, then an exact level 0 (ppt_tpu/kernels/emd.py:46)
__constant__ float kLevels[10] = {-16384.f, -4096.f, -1024.f, -256.f, -64.f,
                                  -16.f,    -4.f,    -1.f,    -0.25f, 0.f};

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

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------

PPT_EXPORT int ppt_nn_dists(const void* q, const void* x, int B, int N, int M, void* out,
                            void* stream) {
  const long long total = (long long)B * N;
  const int blocks = (int)((total + kNnThreads - 1) / kNnThreads);
  nn_dist_kernel<<<blocks, kNnThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)x, B, N, M, (float*)out);
  PPT_CHECK_LAUNCH();
  return 0;
}

// Threads for one cloud: a warp per 32 rows or columns, at most 1024.
static int approx_match_threads(int N, int M) {
  const int wide = N > M ? N : M;
  const int warps = (wide + 31) / 32;
  return 32 * (warps < 1 ? 1 : (warps > 32 ? 32 : warps));
}

// Shared memory the kernel asks for: the supply vectors, and d2 with match
// when both fit beside them (staged); 0 with vec_scratch when the vectors
// alone do not fit.
static size_t approx_match_smem(int N, int M, int* staged) {
  const size_t vec = (size_t)2 * (N + M) * sizeof(float);
  const size_t all = vec + (size_t)2 * N * M * sizeof(float);
  *staged = all <= (size_t)kSmemLimit;
  if (*staged) return all;
  return vec <= (size_t)kSmemLimit ? vec : 0;
}

PPT_EXPORT int ppt_approx_match_needs_scratch(int N, int M) {
  int staged;
  return approx_match_smem(N, M, &staged) == 0;
}

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
