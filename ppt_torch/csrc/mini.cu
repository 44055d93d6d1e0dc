// MiniPointNet group encoder with both BatchNorms folded into the
// weights (eval mode):
//   x1 = relu(x @ fw1 + fb1)                      [M, C1]
//   x2 = x1 @ w2 + b2 ; g = max_M x2              [M, C2], [C2]
//   h  = relu(x2 @ fwl + g @ fwg + fbs)           [M, H]
//   y  = h @ w3 + b3 ; out = max_M y              [CO]
// per group of M <= 32 points; only out [B*G, CO] is written.
//
// Replaces ppt_tpu/kernels/mini.py:mini_forward (_forward_kernel). The
// train-mode statistics sweep (mini_stats, second half of this file)
// shares the first two stages.
//
// Bound: operations. ~3.1e11 FLOP per batch at B=32, G=512, M=32 (0.317
// ms at the H100's bf16 peak) against ~10 MB of input and output. In bf16
// (the serving dtype) mini_forward_wgmma_kernel runs the four products on
// Hopper's wgmma, its weights streamed by TMA (design below); a tile of
// 128 rows reads all 0.85 MB of bf16 weights from L2, about 3.5 GB a batch
// at B = 32 x 512 groups (90 FLOP a byte), which chip_smoke.py prices
// with a build that loads them once (PPT_MINI_WEIGHTS_ONCE). In f32
// (plain FMA on the CUDA cores, since TF32 would round the
// operands): one block per group, the stage activations (x1, x2, a
// 256-column chunk of h) in shared memory, each thread owning one output
// column for all M rows (32 independent f32 accumulators, weights read once
// per k from L2, activations as broadcast float4 loads). In both, h never
// leaves the SM: each chunk is folded into the y accumulators right away.
//
// Rounding: as _forward_kernel (mini.py:97-107, :148-175), every dot
// product accumulates in f32; in bf16 it is rounded to bf16, then the
// bias (in bf16) is added and rounded again. The f32 kernel rounds nowhere.
#include <type_traits>

#include "gemm.cuh"

PPT_ERROR_STRING_FN

constexpr int MAXM = 32;
constexpr int THREADS = 256;

// acc[r] = sum_k A[r*lda + k] * W[k*ldw + col] over r < MAXM (K % 4 == 0)
__device__ __forceinline__ void col_dot(const float* __restrict__ A, int lda, int K,
                                        const float* __restrict__ W, int ldw, int col,
                                        float (&acc)[MAXM]) {
#pragma unroll
  for (int r = 0; r < MAXM; ++r) acc[r] = 0.f;
  for (int k = 0; k < K; k += 4) {
    const float w0 = W[(size_t)(k + 0) * ldw + col];
    const float w1 = W[(size_t)(k + 1) * ldw + col];
    const float w2 = W[(size_t)(k + 2) * ldw + col];
    const float w3 = W[(size_t)(k + 3) * ldw + col];
#pragma unroll
    for (int r = 0; r < MAXM; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(A + r * lda + k);
      float s = acc[r];
      s = fmaf(a.x, w0, s);
      s = fmaf(a.y, w1, s);
      s = fmaf(a.z, w2, s);
      s = fmaf(a.w, w3, s);
      acc[r] = s;
    }
  }
}

// stage 1 (K = 3) of one group: x1 = relu(xin @ fw1 + fb1), xin [MAXM][3]
__device__ __forceinline__ void stage1_f32(const float* xin, const float* __restrict__ fw1,
                                           const float* __restrict__ fb1, int C1, float* x1) {
  for (int c = threadIdx.x; c < C1; c += THREADS) {
    const float wa = fw1[c], wb = fw1[C1 + c], wc = fw1[2 * C1 + c];
    const float bias = fb1[c];
    for (int r = 0; r < MAXM; ++r) {
      float s = xin[3 * r] * wa;
      s = fmaf(xin[3 * r + 1], wb, s);
      s = fmaf(xin[3 * r + 2], wc, s);
      x1[r * C1 + c] = fmaxf(s + bias, 0.f);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
mini_forward_kernel(const float* __restrict__ x, int M, int C1, int C2, int H, int CO,
                    const float* __restrict__ fw1, const float* __restrict__ fb1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ fwg, const float* __restrict__ fwl,
                    const float* __restrict__ fbs, const float* __restrict__ w3,
                    const float* __restrict__ b3, float* __restrict__ out) {
  extern __shared__ float sm[];
  float* x1 = sm;                 // [MAXM][C1]
  float* x2 = x1 + MAXM * C1;     // [MAXM][C2]
  float* hc = x2 + MAXM * C2;     // [MAXM][THREADS]
  float* g = hc + MAXM * THREADS; // [C2]
  float* gh = g + C2;             // [H]
  float* xin = gh + H;            // [MAXM][3]

  const int tid = threadIdx.x;
  const size_t grp = blockIdx.x;
  const float* xg = x + grp * M * 3;
  for (int e = tid; e < MAXM * 3; e += THREADS)
    xin[e] = e < M * 3 ? xg[e] : 0.f;
  __syncthreads();

  stage1_f32(xin, fw1, fb1, C1, x1);
  __syncthreads();

  float acc[MAXM];
  // stage 2 and the first max over the group's points
  for (int c = tid; c < C2; c += THREADS) {
    col_dot(x1, C1, C1, w2, C2, c, acc);
    const float bias = b2[c];
    float m = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAXM; ++r) {
      const float v = acc[r] + bias;
      x2[r * C2 + c] = v;
      if (r < M) m = fmaxf(m, v);
    }
    g[c] = m;
  }
  __syncthreads();

  // global half of the split dense: gh = g @ fwg (one row)
  for (int c = tid; c < H; c += THREADS) {
    float s = 0.f;
    for (int k = 0; k < C2; ++k) s = fmaf(g[k], fwg[(size_t)k * H + c], s);
    gh[c] = s;
  }
  __syncthreads();

  float yacc[MAXM];
#pragma unroll
  for (int r = 0; r < MAXM; ++r) yacc[r] = 0.f;
  for (int h0 = 0; h0 < H; h0 += THREADS) {
    const int c = h0 + tid;
    if (c < H) {
      col_dot(x2, C2, C2, fwl, H, c, acc);
      const float ghc = gh[c], bias = fbs[c];
#pragma unroll
      for (int r = 0; r < MAXM; ++r)
        hc[r * THREADS + tid] = fmaxf(acc[r] + ghc + bias, 0.f);
    } else {
#pragma unroll
      for (int r = 0; r < MAXM; ++r) hc[r * THREADS + tid] = 0.f;
    }
    __syncthreads();
    if (tid < CO) {
      const int kn = min(THREADS, H - h0);  // a multiple of 4
      for (int k = 0; k < kn; k += 4) {
        const float wa = w3[(size_t)(h0 + k) * CO + tid];
        const float wb = w3[(size_t)(h0 + k + 1) * CO + tid];
        const float wc = w3[(size_t)(h0 + k + 2) * CO + tid];
        const float wd = w3[(size_t)(h0 + k + 3) * CO + tid];
#pragma unroll
        for (int r = 0; r < MAXM; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(hc + r * THREADS + k);
          float s = yacc[r];
          s = fmaf(a.x, wa, s);
          s = fmaf(a.y, wb, s);
          s = fmaf(a.z, wc, s);
          s = fmaf(a.w, wd, s);
          yacc[r] = s;
        }
      }
    }
    __syncthreads();
  }

  if (tid < CO) {
    const float bias = b3[tid];
    float m = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAXM; ++r)
      if (r < M) m = fmaxf(m, yacc[r] + bias);
    out[grp * CO + tid] = m;
  }
}

// ---------------------------------------------------------------------------
// bf16 forward on Hopper: mini_forward_wgmma_kernel, for PointBERT's widths.
//
// What bounds it on the H100: the four products (19.1 MFLOP a group of 32
// rows) at the tensor cores' rate, reached only through wgmma, and, since
// a product of 64 rows reads both operands from shared memory, shared
// memory's bandwidth; then the L2 reads of the weights every tile streams
// (0.85 MB a tile of 128 rows). The mma.sync kernel it replaces ran one
// 256-thread CTA an SM, a barrier around each of seven staged products a
// tile, each cp.async stage's latency exposed, and g @ fwg as a 16-row tile
// with 12 rows zero.
//
// Design, after gemm.cuh: persistent CTAs (one an SM) walk tiles of 4
// groups x 32 rows with one producer warpgroup and two consumer
// warpgroups of 64 rows (two groups) each.
// - The producer's one thread streams every weight by TMA, as it lies
//   ([K, N] row-major; no transposed copy), in [64][64] boxes with the
//   128-byte swizzle, two boxes a 16 KB stage, through a ring of NS stages
//   with a full and an empty mbarrier each. A tile takes 52 stages: w2 by
//   64 k-rows and 128 columns (4), fwg likewise (16), then per 64-column
//   chunk of h fwl's chunk by 128 k-rows (2) and the chunk's 64 rows of w3
//   by 128 columns (2). The ring runs on across tiles; a consumer releases
//   a stage as soon as the products that read it are done.
// - Stage 1 (K = 3) runs on the CUDA cores into the consumer's x1 tile.
//   x2 = x1 @ w2 is m64n128k16 wgmma from shared memory (w2 read as an
//   MN-major B operand, the transpose bit). The epilogues write x1 and x2,
//   rounded as the TPU kernel rounds, into K-major tiles with the 128-byte
//   swizzle that the A descriptors read. They round and add on bf16 pairs
//   and reduce the group maxes with pair shuffles.
// - g @ fwg runs transposed, gh^T = fwg^T g^T, as m64n8k16 wgmma with fwg's
//   stage as an MN-major A operand and the tile's 4 group maxes (padded to
//   8) as a K-major B operand: no zero rows fed through the tensor cores'
//   M, half of n8's columns. Each consumer takes 256 of gh's 512 columns;
//   two named barriers between the consumers hand the group maxes and gh
//   across.
// - Per chunk of h: x2 @ fwl (m64n64k16, K = 256) into 32 registers; its
//   epilogue writes h straight into the A fragments of y += h @ w3
//   (m64n128k16 twice, A from registers), so h never touches shared
//   memory; y's 128 accumulators stay in registers across the 8 chunks
//   (setmaxnreg gives each consumer 232 registers a thread). The next
//   chunk's x2 @ fwl is issued before this chunk's h @ w3 and waited for
//   alone, so its epilogue runs on the CUDA cores while h @ w3 runs on the
//   tensor cores.
// - ptxas serialises every wgmma of a kernel if one product sits under a
//   branch it cannot prove uniform, if an accumulator stays live (and
//   spills) across tiles, or if a thread-divergent mbarrier spin lies
//   between a product and its wait: no product is issued under a branch,
//   each accumulator is zeroed before its first product of a tile, and
//   the consumers wait on full stages warp by warp (mbar_wait_warp).
// - Only out [n_groups, 256] is written. Padding rows (M < 32, a group
//   past n_groups) stay out of both maxes. No split-K, no atomics: repeats
//   are bit-identical.
// ---------------------------------------------------------------------------
namespace wg {
constexpr int C1 = 128, C2 = 256, H = 512, CO = 256;  // PointBERT's widths
constexpr int ROWS = 128, GPT = ROWS / MAXM;           // a tile's rows and groups
constexpr int HC = 64, NCH = H / HC;                   // h chunks
constexpr int BOX = 64 * 64;    // elements of a TMA box, [64 rows][64 columns]
constexpr int STAGE = 2 * BOX;  // elements of a ring stage, 16 KB
constexpr int NS = 7;           // ring stages
// shared memory, bytes from a 1024-byte aligned base
constexpr int XH_BYTES = 64 * C1 * 2;  // a consumer's x1 tile, then its partial maxes
constexpr int X2_BYTES = 64 * C2 * 2;  // a consumer's x2 tile
constexpr int XH_OFF = NS * STAGE * 2;
constexpr int X2_OFF = XH_OFF + 2 * XH_BYTES;
constexpr int G_OFF = X2_OFF + 2 * X2_BYTES;  // group maxes [8][256] bf16, rows 4-7 zero
constexpr int GH_OFF = G_OFF + 8 * C2 * 2;    // gh [4][512] bf16
constexpr int PAR_OFF = GH_OFF + GPT * H * 2;  // fw1 [3][128] f32, then fb1, b2, fbs, b3 bf16
constexpr int BAR_OFF = PAR_OFF + 3 * C1 * 4 + (C1 + C2 + H + CO) * 2;
constexpr int SMEM = 1024 + BAR_OFF + 2 * NS * 8;
static_assert(SMEM <= 232448, "one CTA an SM");
// registers a thread: the launch's 168, then 40 for the producer and 232
// for each consumer (y's 128 accumulators, a chunk of h's 32, the rest)
constexpr int LAUNCH_REGS = 168, PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(PRODUCER_REGS + 2 * CONSUMER_REGS <= 3 * LAUNCH_REGS, "register pool exceeded");

// The epilogues round, add biases and take maxes on bf16 pairs: for bf16
// operands, an add rounded once to bf16 equals the f32 add rounded to bf16
// (the TPU kernel's order), so T(T(acc) + b) is one conversion of the f32
// pair and one bf16x2 add.
typedef __nv_bfloat162 bf162;
__device__ __forceinline__ bf162 rnd2(float lo, float hi) {
  return __float22bfloat162_rn(make_float2(lo, hi));
}
__device__ __forceinline__ bf162 ld2(const bf16* p) { return *reinterpret_cast<const bf162*>(p); }
__device__ __forceinline__ uint32_t bits(bf162 v) { return *reinterpret_cast<uint32_t*>(&v); }
__device__ __forceinline__ bf162 from_bits(uint32_t u) { return *reinterpret_cast<bf162*>(&u); }
// the max over the warp's 16 accumulator rows of a column pair (lanes of one
// column pair differ in bits 2-4)
__device__ __forceinline__ bf162 rows_max(bf162 m) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
    m = __hmax2(m, from_bits(__shfl_xor_sync(0xffffffffu, bits(m), off)));
  return m;
}
constexpr uint32_t NEG_INF2 = 0xff80ff80u;  // two bf16 -inf

// byte offset of element (r, c) of a K-major tile of 64-column chunks
// `chunk` bytes apart, 128-byte swizzle: the layout TMA writes and the
// descriptors read
__device__ __forceinline__ int swz(int r, int c, int chunk) {
  return (c >> 6) * chunk + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// k16 step ks of a K-major tile of [64][64] chunks (8 KB apart) at shared
// address a: desc_k<64>'s descriptor, from an address the caller keeps
// opaque, so that the compiler builds each descriptor where it is used
// instead of holding a tile's sixteen in registers across the chunk loop
__device__ __forceinline__ uint64_t desc_ka(uint32_t a, int ks) {
  a += (ks >> 2) * 8192 + (ks & 3) * 32;
  return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ uint32_t opaque_addr(const void* p) {
  uint32_t a = smem_addr(p);
  asm volatile("" : "+r"(a));
  return a;
}

// the group maxes' k16 step ks as a K-major B operand [8 groups][256]
// (64-column chunks of 8 rows, 1 KB apart)
__device__ __forceinline__ uint64_t desc_g(const bf16* t, int ks) {
  return smem_desc<128>(reinterpret_cast<const char*>(t) + (ks >> 2) * 1024 + (ks & 3) * 32, 16,
                        1024);
}

// Each accumulator is defined (zeroed) before its first product of a tile:
// that product overwrites it, but its asm operand reads it, and an
// accumulator left undefined would stay live across the whole tile loop
// (every other accumulator's range), spill, and make ptxas serialise the
// kernel's wgmma.
template <int N> __device__ __forceinline__ void zero_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// h = relu(T(T(T(x2 @ fwl) + gh) + fbs)) of one chunk, from its product ha,
// as the A fragments of h @ w3 (k16 step ks: the accumulator's 8-column
// groups 2 ks and 2 ks + 1, rows rr0 and rr0 + 8); ghr and bsr are the
// chunk's gh (of the rows' group) and fbs
__device__ __forceinline__ void h_frags(const float (&ha)[32], uint32_t (&hf)[4][4],
                                        const bf16* ghr, const bf16* bsr, int lane) {
  const int cq = (lane & 3) * 2;
  const bf162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int j = 0; j < HC / 8; ++j) {
    const bf162 g = ld2(ghr + 8 * j + cq), b = ld2(bsr + 8 * j + cq);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      hf[j >> 1][2 * (j & 1) + h2] = bits(__hmax2(
          __hadd2(__hadd2(rnd2(ha[4 * j + 2 * h2], ha[4 * j + 2 * h2 + 1]), g), b), zero));
  }
}

// y += h @ w3[chunk rows, :], h from registers, w3 from the chunk's two
// stages (128 columns each), one commit group a stage
__device__ __forceinline__ void issue_y(float (&y)[2][64], uint32_t (&hf)[4][4], const bf16* s0,
                                        const bf16* s1) {
  fence_frags(hf);
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int ks = 0; ks < HC / 16; ++ks) wgmma_rs<128>(y[h], hf[ks], desc_w(h ? s1 : s0, ks), 1);
    wgmma_commit();
  }
}

// ha = x2 @ fwl[:, chunk] (K = 256) from the chunk's two fwl stages (128
// k-rows each), one commit group a stage
__device__ __forceinline__ void issue_h(float (&ha)[32], uint32_t x2a, const bf16* s0,
                                        const bf16* s1) {
  wgmma_fence();
#pragma unroll
  for (int kh = 0; kh < 2; ++kh) {
    const bf16* stg = kh ? s1 : s0;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_ss<64, 1>(ha, desc_ka(x2a, 8 * kh + ks), desc_w(stg + (ks >> 2) * BOX, ks & 3),
                      kh > 0 || ks > 0);
    wgmma_commit();
  }
}

__global__ void __launch_bounds__(384, 1)
mini_forward_wgmma_kernel(const __grid_constant__ CUtensorMap tw2,
                          const __grid_constant__ CUtensorMap twg,
                          const __grid_constant__ CUtensorMap twl,
                          const __grid_constant__ CUtensorMap tw3, const float* __restrict__ x,
                          int n_groups, int M, const bf16* __restrict__ fw1,
                          const bf16* __restrict__ fb1, const bf16* __restrict__ b2,
                          const bf16* __restrict__ fbs, const bf16* __restrict__ b3,
                          bf16* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* base = align1024(wg_smem);
  bf16* ring = reinterpret_cast<bf16*>(base);
  bf16* gt = reinterpret_cast<bf16*>(base + G_OFF);
  bf16* gh = reinterpret_cast<bf16*>(base + GH_OFF);
  float* pw1 = reinterpret_cast<float*>(base + PAR_OFF);
  bf16* pb1 = reinterpret_cast<bf16*>(pw1 + 3 * C1);
  bf16* pb2 = pb1 + C1;
  bf16* pbs = pb2 + C2;
  bf16* pb3 = pbs + H;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + BAR_OFF);
  uint64_t* empty = full + NS;
  const int n_tiles = (n_groups + GPT - 1) / GPT;

  for (int e = threadIdx.x; e < 3 * C1; e += blockDim.x) pw1[e] = __bfloat162float(fw1[e]);
  for (int e = threadIdx.x; e < C1; e += blockDim.x) pb1[e] = fb1[e];
  for (int e = threadIdx.x; e < C2; e += blockDim.x) pb2[e] = b2[e];
  for (int e = threadIdx.x; e < H; e += blockDim.x) pbs[e] = fbs[e];
  for (int e = threadIdx.x; e < CO; e += blockDim.x) pb3[e] = b3[e];
  for (int e = threadIdx.x; e < 8 * C2; e += blockDim.x) gt[e] = __float2bfloat16_rn(0.f);
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: thread 0 streams the weights
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;  // stages loaded
      // a stage: two boxes, at (col0, row0) and (col0 + dcol, row0 + drow)
      auto load = [&](const CUtensorMap* map, int col0, int dcol, int row0, int drow) {
        const int s = it % NS;
        mbar_wait(&empty[s], ((it / NS) & 1) ^ 1);
#ifdef PPT_MINI_WEIGHTS_ONCE
        // a measurement build (chip_smoke.py): after the ring's first fill
        // the stages are handed on as they are, wrong, without loads, so the
        // kernel runs without the weights' L2 traffic
        if (it >= NS) {
          mbar_arrive(&full[s]);
          ++it;
          return;
        }
#endif
        mbar_arrive_tx(&full[s], STAGE * 2);
        tma_load_2d(ring + s * STAGE, map, &full[s], col0, row0);
        tma_load_2d(ring + s * STAGE + BOX, map, &full[s], col0 + dcol, row0 + drow);
        ++it;
      };
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int kq = 0; kq < C1 / 64; ++kq)  // w2: 64 k-rows x 128 columns
          for (int hf = 0; hf < 2; ++hf) load(&tw2, 128 * hf, 64, 64 * kq, 0);
        for (int kq = 0; kq < C2 / 64; ++kq)  // fwg: 64 k-rows x 128 columns, by consumer
          for (int q = 0; q < 4; ++q) load(&twg, 128 * q, 64, 64 * kq, 0);
        for (int kh = 0; kh < 2; ++kh) load(&twl, 0, 0, 128 * kh, 64);
        for (int hb = 0; hb < NCH; ++hb) {  // fwl: a chunk's 128 k-rows; w3: 64 x 128
          if (hb + 1 < NCH)
            for (int kh = 0; kh < 2; ++kh) load(&twl, HC * (hb + 1), 0, 128 * kh, 64);
          for (int hf = 0; hf < 2; ++hf) load(&tw3, 128 * hf, 64, HC * hb, 0);
        }
      }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, lane = tid & 31, w = tid >> 5;
  unsigned char* xh = base + XH_OFF + c * XH_BYTES;
  unsigned char* x2t = base + X2_OFF + c * X2_BYTES;
  // this thread's accumulator rows rr0 and rr0 + 8 of the consumer's 64 (both
  // in the consumer's group gi) and its column pair cq of each 8-column group
  const int rr0 = 16 * w + (lane >> 2), gi = w >> 1, cq = (lane & 3) * 2;
  int it = 0;  // stages consumed
  auto wait_stage = [&](int i) -> const bf16* {
    mbar_wait_warp(&full[i % NS], (i / NS) & 1);
    return ring + (i % NS) * STAGE;
  };
  auto wait_full = [&]() { return wait_stage(it); };
  auto release = [&](int i) {
    if (lane == 0) mbar_arrive(&empty[i % NS]);
  };
  // a column pair's max over the warp's 16 rows, to scr[gi][w & 1][col / 2]
  // (bf16 pairs): the two warps of a group hold its two halves
  auto part_max = [&](bf162 m, uint32_t* scr, int col) {
    if (lane < 4) scr[(gi * 2 + (w & 1)) * 128 + col / 2] = bits(m);
  };

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int g0 = tile * GPT, grp = g0 + 2 * c + gi;
    const bool ok0 = grp < n_groups && (rr0 & 31) < M;
    const bool ok1 = grp < n_groups && ((rr0 + 8) & 31) < M;

    // x1 = relu(T(T(x @ fw1) + fb1)) on the CUDA cores: a row and 64 columns a thread
    {
      const int r = tid >> 1, half = tid & 1, g = g0 + 2 * c + (r >> 5), pt = r & 31;
      float xa = 0.f, xb = 0.f, xc = 0.f;
      if (g < n_groups && pt < M) {
        const float* xp = x + ((size_t)g * M + pt) * 3;
        xa = rnd<bf16>(xp[0]);
        xb = rnd<bf16>(xp[1]);
        xc = rnd<bf16>(xp[2]);
      }
      unsigned char* row = xh + half * (64 * 128) + r * 128;
      const bf162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float o[2];
          const int col = half * 64 + u * 8 + 2 * e;
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            float s = __fmul_rn(xa, pw1[col + f]);
            s = fmaf(xb, pw1[C1 + col + f], s);
            o[f] = fmaf(xc, pw1[2 * C1 + col + f], s);
          }
          v[e] = bits(__hmax2(__hadd2(rnd2(o[0], o[1]), ld2(pb1 + col)), zero));
        }
        *reinterpret_cast<uint4*>(row + ((u ^ (r & 7)) << 4)) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + c, 128);

    // x2 = T(T(x1 @ w2) + b2) -> x2t; the group maxes g -> rows 2c, 2c + 1 of gt
    {
      float acc[2][64];
      zero_acc(acc[0]);
      zero_acc(acc[1]);
      const uint32_t x1a = opaque_addr(xh);
#pragma unroll
      for (int kq = 0; kq < C1 / 64; ++kq)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const bf16* stg = wait_full();
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_ss<128, 1>(acc[hf], desc_ka(x1a, 4 * kq + ks), desc_w(stg, ks), kq > 0 || ks > 0);
          wgmma_commit();
          ++it;
        }
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
#pragma unroll
      for (int i = 4; i > 0; --i) release(it - i);
      uint32_t* scr = reinterpret_cast<uint32_t*>(xh);  // x1 is spent: partial maxes
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = hf * 128 + 8 * j + cq;
          const bf162 b = ld2(pb2 + col);
          bf162 m = from_bits(NEG_INF2);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const bf162 v = __hadd2(rnd2(acc[hf][4 * j + 2 * h2], acc[hf][4 * j + 2 * h2 + 1]), b);
            *reinterpret_cast<bf162*>(x2t + swz(rr0 + 8 * h2, col, 64 * 128)) = v;
            if (h2 ? ok1 : ok0) m = __hmax2(m, v);
          }
          part_max(rows_max(m), scr, col);
        }
      named_bar_sync(1 + c, 128);
      const int gg = tid >> 6, col = (tid & 63) * 4;
      const uint32_t* p = scr + gg * 256 + col / 2;
      uint2 v = {0u, 0u};  // an absent group's row stays finite
      if (g0 + 2 * c + gg < n_groups)
        v = {bits(__hmax2(from_bits(p[0]), from_bits(p[128]))),
             bits(__hmax2(from_bits(p[1]), from_bits(p[129])))};
      *reinterpret_cast<uint2*>(reinterpret_cast<unsigned char*>(gt) + swz(2 * c + gg, col, 1024)) = v;
    }
    fence_proxy_async();
    named_bar_sync(3, 256);  // both consumers' group maxes are in gt

    // gh^T = T(fwg^T g^T): this consumer's 256 columns of gh, 8 groups (4 real).
    // Each 64 k-rows of fwg come as four stages of 128 columns; consumer c
    // takes stages 2c and 2c + 1 and releases the other two once they are
    // in (no product sits under a branch on c: ptxas would serialise every
    // wgmma of the kernel)
    {
      float ga[4][4];
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) zero_acc(ga[mb]);
#pragma unroll 1
      for (int kq = 0; kq < C2 / 64; ++kq) {
        const int own = it + 2 * c, other = it + 2 - 2 * c;
        const bf16* sa = wait_stage(own);
        const bf16* sb = wait_stage(own + 1);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            wgmma_ss_n8_ta(ga[m], desc_w(sa + m * BOX, ks), desc_g(gt, 4 * kq + ks),
                           kq > 0 || ks > 0);
            wgmma_ss_n8_ta(ga[2 + m], desc_w(sb + m * BOX, ks), desc_g(gt, 4 * kq + ks),
                           kq > 0 || ks > 0);
          }
        wgmma_commit();
        wgmma_wait<1>();  // the previous 64 k-rows' products are done
        if (kq > 0) {  // before the wait below, which may need these slots refilled
          release(own - 4);
          release(own - 3);
        }
        wait_stage(other);
        wait_stage(other + 1);
        release(other);
        release(other + 1);
        it += 4;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) fence_acc(ga[mb]);
      release(it - 4 + 2 * c);
      release(it - 3 + 2 * c);
#pragma unroll
      for (int mb = 0; mb < 4; ++mb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int group = cq + (e & 1);
          if (group < GPT)
            gh[group * H + 256 * c + 64 * mb + rr0 + 8 * (e >> 1)] = __float2bfloat16_rn(ga[mb][e]);
        }
    }
    named_bar_sync(3, 256);  // gh is whole

    // h chunk by chunk, y = h @ w3 in registers, h never in shared memory:
    // each chunk's epilogue writes the A fragments of its h @ w3. The next
    // chunk's x2 @ fwl is issued before this chunk's h @ w3 and waited for
    // alone, so that its epilogue overlaps h @ w3; the fragments alternate
    // between two buffers (the loop takes chunks in pairs), as h @ w3 may
    // still read the last chunk's; the last chunk issues no x2 @ fwl (no
    // product is issued under a branch)
    float y[2][64];
    zero_acc(y[0]);
    zero_acc(y[1]);
    {
      float ha[32];
      uint32_t hf0[4][4], hf1[4][4];
      zero_acc(ha);
      const bf16* s0 = wait_full();
      const bf16* s1 = wait_stage(it + 1);
      issue_h(ha, opaque_addr(x2t), s0, s1);
      wgmma_wait<0>();
      fence_acc(ha);
      release(it);
      release(it + 1);
      it += 2;
      const bf16* ghr = gh + (2 * c + gi) * H;
      // chunk hb: its epilogue into hf, the next chunk's x2 @ fwl (NEXT), h @ w3
      auto chunk = [&](auto next, uint32_t (&hf)[4][4], int hb) {
        constexpr bool NEXT = decltype(next)::value;
        h_frags(ha, hf, ghr + HC * hb, pbs + HC * hb, lane);
        if constexpr (NEXT) {
          const bf16* n0 = wait_full();
          const bf16* n1 = wait_stage(it + 1);
          issue_h(ha, opaque_addr(x2t), n0, n1);
          it += 2;
        }
        const bf16* w0 = wait_full();
        const bf16* w1 = wait_stage(it + 1);
        issue_y(y, hf, w0, w1);
        if constexpr (NEXT) {
          wgmma_wait<2>();  // all but this chunk's h @ w3
          fence_acc(ha);
          release(it - 2);
          release(it - 1);
        } else {
          wgmma_wait<0>();
        }
        if (hb > 0) {  // the previous chunk's h @ w3 is done
          const int prev = it - (NEXT ? 4 : 2);
          release(prev);
          release(prev + 1);
        }
        it += 2;
      };
      using yes = std::true_type;
#pragma unroll 1
      for (int hb = 0; hb < NCH - 2; hb += 2) {
        chunk(yes(), hf0, hb);
        chunk(yes(), hf1, hb + 1);
      }
      chunk(yes(), hf0, NCH - 2);
      chunk(std::false_type(), hf1, NCH - 1);
      fence_acc(y[0]);
      fence_acc(y[1]);
      release(it - 2);
      release(it - 1);
    }

    // out = max over the group's valid rows of T(T(y) + b3)
    {
      uint32_t* scr = reinterpret_cast<uint32_t*>(x2t);  // x2 is spent
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = hf * 128 + 8 * j + cq;
          const bf162 b = ld2(pb3 + col);
          bf162 m = from_bits(NEG_INF2);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            if (h2 ? ok1 : ok0)
              m = __hmax2(m, __hadd2(rnd2(y[hf][4 * j + 2 * h2], y[hf][4 * j + 2 * h2 + 1]), b));
          part_max(rows_max(m), scr, col);
        }
      named_bar_sync(1 + c, 128);
      const int gg = tid >> 6, col = (tid & 63) * 4, g = g0 + 2 * c + gg;
      if (g < n_groups) {
        const uint32_t* p = scr + gg * 256 + col / 2;
        const uint2 v = {bits(__hmax2(from_bits(p[0]), from_bits(p[128]))),
                         bits(__hmax2(from_bits(p[1]), from_bits(p[129])))};
        *reinterpret_cast<uint2*>(out + (size_t)g * CO + col) = v;
      }
    }
  }
}

// w2, fwg, fwl, w3 by TMA (16-byte aligned bases; the wrapper checks them)
static int launch(const void* x, int n_groups, int M, const void* fw1, const void* fb1,
                  const void* w2, const void* b2, const void* fwg, const void* fwl, const void* fbs,
                  const void* w3, const void* b3, void* out, cudaStream_t st) {
  if (n_groups < 1) return 0;
  static const int pool = check_reg_pool(mini_forward_wgmma_kernel, LAUNCH_REGS);
  if (pool) return pool;
  CUtensorMap maps[4];
  int rc = mat_map(&maps[0], (const bf16*)w2, C1, C2, 64);
  if (!rc) rc = mat_map(&maps[1], (const bf16*)fwg, C2, H, 64);
  if (!rc) rc = mat_map(&maps[2], (const bf16*)fwl, C2, H, 64);
  if (!rc) rc = mat_map(&maps[3], (const bf16*)w3, H, CO, 64);
  if (rc) return rc;
  const int tiles = (n_groups + GPT - 1) / GPT, sms = sm_count();
  cudaFuncSetAttribute(mini_forward_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM);
  mini_forward_wgmma_kernel<<<tiles < sms ? tiles : sms, 384, SMEM, st>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)x, n_groups, M, (const bf16*)fw1,
      (const bf16*)fb1, (const bf16*)b2, (const bf16*)fbs, (const bf16*)b3, (bf16*)out);
  PPT_CHECK_LAUNCH();
  return 0;
}
}  // namespace wg

// ---------------------------------------------------------------------------
// bf16 building blocks of mini_stats's sweep (below): stages 1 and 2 of a
// tile of 4 groups x 32 rows on mma.sync (f32 accumulators) through
// ldmatrix, the weights streamed through a double-buffered shared tile (32
// k-rows at a time, cp.async). A group of M < 32 points is padded.
// ---------------------------------------------------------------------------
namespace tc {
constexpr int GPB = 4, R = GPB * MAXM;  // groups, rows per block
constexpr int C1 = 128, C2 = 256;       // widths
constexpr int X1_LD = C1 + 8, X2_LD = C2 + 8, WS_LD = 256 + 8;
constexpr int KT = 32;  // k-rows per staged weight tile

// acc[mt][nt] += A[a_row0 + 16 mt .., 0:K) @ W[0:K, n_base + w_col0 + 8 nt ..]
// A is bf16 in shared memory (row stride lda); W is bf16 in global memory
// (row stride ldw), staged NW columns from n_base at a time through ws.
// Every thread of the block calls it (it holds the block's barriers).
template <int MT, int NT>
__device__ __forceinline__ void block_mma(float (&acc)[MT][NT][4], const bf16* As, int lda,
                                          int a_row0, const bf16* __restrict__ W, int ldw,
                                          int n_base, int NW, int K, int w_col0, bf16* ws) {
  const int tid = threadIdx.x, lane = tid & 31;
  auto stage = [&](int buf, int k0) {
    const int chunks = NW / 8;
    for (int e = tid; e < KT * chunks; e += THREADS) {
      const int kr = e / chunks, nc = (e % chunks) * 8;
      cp_async16(ws + (buf * KT + kr) * WS_LD + nc, W + (size_t)(k0 + kr) * ldw + n_base + nc,
                 true);
    }
    cp_async_commit();
  };
  __syncthreads();  // earlier readers of ws (and of the caller's outputs) are done
  stage(0, 0);
  const int nk = K / KT;
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      stage((kt + 1) & 1, (kt + 1) * KT);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* wsb = ws + (kt & 1) * KT * WS_LD;
#pragma unroll
    for (int ks = 0; ks < KT; ks += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], As + (a_row0 + mt * 16 + (lane & 15)) * lda + kt * KT + ks +
                               (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, wsb + (ks + ((lane >> 3) & 1) * 8 + (lane & 7)) * WS_LD + w_col0 +
                                 p * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * p], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * p + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

__device__ __forceinline__ float bf(const bf16* p, int i) { return __bfloat162float(p[i]); }

// Stages 1 and 2 of one tile of GPB groups starting at group g0:
//   x1 = relu(T(T(x @ fw1) + fb1)) -> x1s,  x2 = T(T(x1 @ w2) + b2) -> x2s.
// With ZERO_PAD the x2 rows of absent points (r >= M, or a group past the
// end) are written as zeros, so that they drop out of sums over rows.
// Every thread of the block calls it; it ends with a barrier.
template <bool ZERO_PAD>
__device__ __forceinline__ void tile_x2(const float* __restrict__ x, int n_groups, int M, int g0,
                                        const bf16* __restrict__ fw1,
                                        const bf16* __restrict__ fb1,
                                        const bf16* __restrict__ w2,
                                        const bf16* __restrict__ b2, float* xin, bf16* x1s,
                                        bf16* x2s, bf16* ws) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // warp wm's 32 rows are group wm
  for (int e = tid; e < R * 3; e += THREADS) {
    const int row = e / 3, grp = g0 + row / MAXM, r = row % MAXM;
    xin[e] = (grp < n_groups && r < M) ? rnd<bf16>(x[((size_t)grp * M + r) * 3 + e % 3]) : 0.f;
  }
  __syncthreads();

  for (int e = tid; e < R * C1; e += THREADS) {
    const int row = e / C1, c = e % C1;
    float s = __fmul_rn(xin[3 * row], bf(fw1, c));
    s = fmaf(xin[3 * row + 1], bf(fw1, C1 + c), s);
    s = fmaf(xin[3 * row + 2], bf(fw1, 2 * C1 + c), s);
    x1s[row * X1_LD + c] = __float2bfloat16_rn(fmaxf(rnd<bf16>(rnd<bf16>(s) + bf(fb1, c)), 0.f));
  }

  // two 128-column halves
  for (int nb = 0; nb < C2; nb += 128) {
    float acc[2][8][4];
    zero(acc);
    block_mma(acc, x1s, X1_LD, wm * 32, w2, C2, nb, 128, C1, wn * 64, ws);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = wm * 32 + mt * 16 + (lane >> 2) + (e >> 1) * 8;
          const int c = nb + wn * 64 + nt * 8 + (lane & 3) * 2 + (e & 1);
          float v = rnd<bf16>(acc[mt][nt][e]) + bf(b2, c);
          if (ZERO_PAD && (g0 + wm >= n_groups || row % MAXM >= M)) v = 0.f;
          x2s[row * X2_LD + c] = __float2bfloat16_rn(v);
        }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// mini_stats, bf16: the train-mode BN2 statistics sweep. Replaces
// ppt_tpu/kernels/mini.py:mini_stats (_stats_kernel): per tile of groups
// it forms x2 as above and emits the second-moment matrix
// m2 = sum x2^T x2 [C2, C2] (f32, over ALL rows), per-group column sums
// sg [n_groups, C2] and per-group column maxes gmax [n_groups, C2] (f32);
// the closed-form epilogue that turns them into sum(h) and sum(h^2) is
// plain f32 tensor code in the wrapper, as it is plain XLA in the
// reference.
//
// Bound: operations (2 n (3 C1 + C1 C2 + C2 C2) against the input read
// once and sg/gmax written once). Design: the TPU grid runs in order and
// adds every tile into one m2 block; here a fixed number of persistent
// blocks each walk their tiles (tile = blockIdx.x, += gridDim.x) and keep
// their share of m2 in registers, so no atomics are needed and two runs
// give the same bits. 256 x 256 f32 accumulators do not fit one block's
// registers, so gridDim.y = 2 splits m2's columns: block (p, half) owns
// m2[:, 128 half .. 128 half + 127] (128 accumulators per thread, as the
// forward kernel's y) and that half of sg and gmax, and both halves
// recompute x2 for the tile (stages 1-2 are a third of the work). x2^T x2
// runs on the tensor cores straight from the bf16 x2 tile in shared
// memory: ldmatrix.trans gives the A fragments of x2^T as well as the B
// fragments. Each block writes one partial [C2, 128] slab; m2_reduce_kernel
// adds the partials in block order.
// ---------------------------------------------------------------------------
constexpr int STATS_BLOCKS = 66;  // x 2 column halves = one block per SM
constexpr size_t STATS_SMEM =
    sizeof(bf16) * ((size_t)R * X2_LD + (size_t)R * X1_LD + 2 * KT * WS_LD) +
    sizeof(float) * (R * 3);

__global__ void __launch_bounds__(THREADS, 1)
mini_stats_bf16_kernel(const float* __restrict__ x, int n_groups, int M,
                       const bf16* __restrict__ fw1, const bf16* __restrict__ fb1,
                       const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                       float* __restrict__ part, float* __restrict__ sg,
                       float* __restrict__ gmax) {
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* x2s = reinterpret_cast<bf16*>(smraw);           // [R][X2_LD]
  bf16* x1s = x2s + R * X2_LD;                          // [R][X1_LD]
  bf16* ws = x1s + R * X1_LD;                           // [2][KT][WS_LD]
  float* xin = reinterpret_cast<float*>(ws + 2 * KT * WS_LD);  // [R][3]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // 64 rows x 64 columns of the m2 half per warp
  const int col0 = blockIdx.y * 128;
  const int n_tiles = (n_groups + GPB - 1) / GPB;

  float acc[4][8][4];
  zero(acc);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int g0 = tile * GPB;
    tile_x2<true>(x, n_groups, M, g0, fw1, fb1, w2, b2, xin, x1s, x2s, ws);

    // per-group column sums (f32, rows in order) and maxes of this half
    for (int e = tid; e < GPB * 128; e += THREADS) {
      const int grp = e / 128, c = col0 + e % 128;
      if (g0 + grp < n_groups) {
        float s = 0.f, m = -INFINITY;
        for (int r = 0; r < M; ++r) {
          const float v = __bfloat162float(x2s[(grp * MAXM + r) * X2_LD + c]);
          s += v;
          m = fmaxf(m, v);
        }
        sg[(size_t)(g0 + grp) * C2 + c] = s;
        gmax[(size_t)(g0 + grp) * C2 + c] = m;
      }
    }

    // acc += x2[:, rows of this warp]^T @ x2[:, columns of this warp]
#pragma unroll 2
    for (int ks = 0; ks < R; ks += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4_trans(a[mt], x2s + (ks + (lane & 7) + ((lane >> 4) & 1) * 8) * X2_LD +
                                     wm * 64 + mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, x2s + (ks + ((lane >> 3) & 1) * 8 + (lane & 7)) * X2_LD + col0 +
                                 wn * 64 + p * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][2 * p], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * p + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // x2s is rewritten by the next tile
  }

  float* dst = part + (size_t)blockIdx.x * C2 * C2;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = wm * 64 + mt * 16 + (lane >> 2) + (e >> 1) * 8;
        const int j = col0 + wn * 64 + nt * 8 + (lane & 3) * 2 + (e & 1);
        dst[i * C2 + j] = acc[mt][nt][e];
      }
}
}  // namespace tc

static int launch_f32(const void* x, int n_groups, int M, int C1, int C2, int H, int CO,
                      const void* fw1, const void* fb1, const void* w2, const void* b2,
                      const void* fwg, const void* fwl, const void* fbs, const void* w3,
                      const void* b3, void* out, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)MAXM * (C1 + C2 + THREADS + 3) + C2 + H);
  cudaFuncSetAttribute(mini_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  mini_forward_kernel<<<n_groups, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, M, C1, C2, H, CO, (const float*)fw1, (const float*)fb1,
      (const float*)w2, (const float*)b2, (const float*)fwg, (const float*)fwl,
      (const float*)fbs, (const float*)w3, (const float*)b3, (float*)out);
  PPT_CHECK_LAUNCH();
  return 0;
}

PPT_EXPORT int ppt_mini_forward(int dtype, const void* x, int n_groups, int M, int C1, int C2,
                                int H, int CO, const void* fw1, const void* fb1,
                                const void* w2, const void* b2, const void* fwg,
                                const void* fwl, const void* fbs, const void* w3,
                                const void* b3, void* out, void* stream) {
  if (dtype == PPT_BF16) {
    if (C1 != wg::C1 || C2 != wg::C2 || H != wg::H || CO != wg::CO || M > MAXM)
      return (int)cudaErrorInvalidValue;
    return wg::launch(x, n_groups, M, fw1, fb1, w2, b2, fwg, fwl, fbs, w3, b3, out,
                      (cudaStream_t)stream);
  }
  return launch_f32(x, n_groups, M, C1, C2, H, CO, fw1, fb1, w2, b2, fwg, fwl, fbs, w3, b3,
                    out, stream);
}

// ---------------------------------------------------------------------------
// mini_stats, f32 (FMA on the CUDA cores): the same sweep and the same
// split as the bf16 kernel above, one group per tile. Block (p, half)
// keeps m2[:, 128 half ..] in registers: thread (ti, tj) owns rows
// {4 ti + e, 128 + 4 ti + e} x columns {32 q + 4 tj + f} (8 x 16
// accumulators), so a row of x2 is read as float4s without bank conflicts.
// ---------------------------------------------------------------------------
namespace st {
constexpr int C1 = 128, C2 = 256;
constexpr size_t SMEM = sizeof(float) * (MAXM * (C1 + C2 + 3));

__global__ void __launch_bounds__(THREADS, 1)
mini_stats_f32_kernel(const float* __restrict__ x, int n_groups, int M,
                      const float* __restrict__ fw1, const float* __restrict__ fb1,
                      const float* __restrict__ w2, const float* __restrict__ b2,
                      float* __restrict__ part, float* __restrict__ sg,
                      float* __restrict__ gmax) {
  extern __shared__ float sm[];
  float* x1 = sm;              // [MAXM][C1]
  float* x2 = x1 + MAXM * C1;  // [MAXM][C2]; rows >= M are zero
  float* xin = x2 + MAXM * C2; // [MAXM][3]

  const int tid = threadIdx.x, ti = tid >> 3, tj = tid & 7;
  const int col0 = blockIdx.y * 128;

  float m2[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) m2[i][j] = 0.f;

  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const float* xg = x + (size_t)grp * M * 3;
    for (int e = tid; e < MAXM * 3; e += THREADS) xin[e] = e < M * 3 ? xg[e] : 0.f;
    __syncthreads();
    stage1_f32(xin, fw1, fb1, C1, x1);
    __syncthreads();
    {  // THREADS == C2: one column of x2 per thread
      const int c = tid;
      float acc[MAXM];
      col_dot(x1, C1, C1, w2, C2, c, acc);
      const float bias = b2[c];
      float s = 0.f, m = -INFINITY;
#pragma unroll
      for (int r = 0; r < MAXM; ++r) {
        const float v = acc[r] + bias;
        x2[r * C2 + c] = r < M ? v : 0.f;
        if (r < M) {
          s += v;
          m = fmaxf(m, v);
        }
      }
      if (c >= col0 && c < col0 + 128) {
        sg[(size_t)grp * C2 + c] = s;
        gmax[(size_t)grp * C2 + c] = m;
      }
    }
    __syncthreads();
    for (int k = 0; k < M; ++k) {
      const float* row = x2 + k * C2;
      float a[8], b[16];
#pragma unroll
      for (int p = 0; p < 2; ++p)
        *reinterpret_cast<float4*>(a + 4 * p) =
            *reinterpret_cast<const float4*>(row + p * 128 + ti * 4);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float4*>(b + 4 * q) =
            *reinterpret_cast<const float4*>(row + col0 + q * 32 + tj * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) m2[i][j] = fmaf(a[i], b[j], m2[i][j]);
    }
    __syncthreads();  // x2 and xin are rewritten by the next group
  }

  float* dst = part + (size_t)blockIdx.x * C2 * C2;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      dst[((i >> 2) * 128 + ti * 4 + (i & 3)) * C2 + col0 + (j >> 2) * 32 + tj * 4 + (j & 3)] =
          m2[i][j];
}

// out[e] = part[0][e] + part[1][e] + ... in block order: the fixed-order sum
// that makes m2 the same bits from run to run.
__global__ void m2_reduce_kernel(const float* __restrict__ part, int P, int n,
                                 float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += part[(size_t)p * n + e];
  out[e] = s;
}
}  // namespace st

// Number of partial m2 slabs (persistent blocks per column half) that
// ppt_mini_stats writes for this many groups; the caller sizes `part` by it.
PPT_EXPORT int ppt_mini_stats_blocks(int dtype, int n_groups) {
  const int tiles = dtype == PPT_BF16 ? (n_groups + tc::GPB - 1) / tc::GPB : n_groups;
  return tiles < tc::STATS_BLOCKS ? tiles : tc::STATS_BLOCKS;
}

// x [n_groups * M, 3] f32; weights in the compute dtype; part
// [ppt_mini_stats_blocks, C2, C2], m2 [C2, C2], sg and gmax [n_groups, C2] f32.
PPT_EXPORT int ppt_mini_stats(int dtype, const void* x, int n_groups, int M, int C1, int C2,
                              const void* fw1, const void* fb1, const void* w2, const void* b2,
                              void* part, void* m2, void* sg, void* gmax, void* stream) {
  if (C1 != st::C1 || C2 != st::C2 || M > MAXM || n_groups < 1)
    return (int)cudaErrorInvalidValue;
  const int P = ppt_mini_stats_blocks(dtype, n_groups);
  const dim3 grid(P, 2);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == PPT_BF16) {
    cudaFuncSetAttribute(tc::mini_stats_bf16_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tc::STATS_SMEM);
    tc::mini_stats_bf16_kernel<<<grid, THREADS, tc::STATS_SMEM, s>>>(
        (const float*)x, n_groups, M, (const bf16*)fw1, (const bf16*)fb1, (const bf16*)w2,
        (const bf16*)b2, (float*)part, (float*)sg, (float*)gmax);
  } else {
    cudaFuncSetAttribute(st::mini_stats_f32_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)st::SMEM);
    st::mini_stats_f32_kernel<<<grid, THREADS, st::SMEM, s>>>(
        (const float*)x, n_groups, M, (const float*)fw1, (const float*)fb1, (const float*)w2,
        (const float*)b2, (float*)part, (float*)sg, (float*)gmax);
  }
  PPT_CHECK_LAUNCH();
  const int n = C2 * C2;
  st::m2_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>((const float*)part, P, n, (float*)m2);
  PPT_CHECK_LAUNCH();
  return 0;
}
