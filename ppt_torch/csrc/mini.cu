// MiniPointNet group encoder with both BatchNorms folded into the
// weights (eval mode):
//   x1 = relu(x @ fw1 + fb1)                      [M, C1]
//   x2 = x1 @ w2 + b2 ; g = max_M x2              [M, C2], [C2]
//   h  = relu(x2 @ fwl + g @ fwg + fbs)           [M, H]
//   y  = h @ w3 + b3 ; out = max_M y              [CO]
// per group of M <= 32 points; only out [B*G, CO] is written.
//
// Replaces ppt_tpu/kernels/mini.py:mini_forward (_forward_kernel). The
// train-mode statistics sweep (mini_stats, second half of this file; in
// bf16 mini_stats_wgmma_kernel) forms x1 and x2 as the forward does, but
// for the BN2 sums it needs only x2's second moment and group sums and
// maxes, so it keeps w2 resident instead of streaming four matrices.
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
// bf16 forward on Hopper: mini_forward_wgmma_kernel<CO>, for PointBERT's
// widths (C1, C2, H, CO) = (128, 256, 512, 256) and the masked-point
// autoencoder's (128, 256, 512, 128): only the last product's width differs,
// so the kernel is a template on CO, which sets the w3 stages a chunk of h
// takes (CO / 128), y's accumulators and the output's width.
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
//   by 128 columns (CO / 128): 52 stages at CO = 256, 44 at CO = 128. The
//   ring runs on across tiles; a consumer releases
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
//   (m64n128k16 CO / 128 times, A from registers), so h never touches
//   shared memory; y's CO / 2 accumulators stay in registers across the 8 chunks
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
// - Only out [n_groups, CO] is written. Padding rows (M < 32, a group
//   past n_groups) stay out of both maxes. No split-K, no atomics: repeats
//   are bit-identical.
// ---------------------------------------------------------------------------
namespace wg {
constexpr int C1 = 128, C2 = 256, H = 512;  // PointBERT's and MAE's widths
constexpr int CO_MAX = 256;  // the widest CO; shared memory is laid out for it
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
constexpr int BAR_OFF = PAR_OFF + 3 * C1 * 4 + (C1 + C2 + H + CO_MAX) * 2;
constexpr int SMEM = 1024 + BAR_OFF + 2 * NS * 8;
static_assert(SMEM <= 232448, "one CTA an SM");
// registers a thread: the launch's 168, then 40 for the producer and 232
// for each consumer (y's CO / 2 accumulators, a chunk of h's 32, the rest)
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

// y += h @ w3[chunk rows, :], h from registers, w3 from the chunk's NW3
// stages (128 columns each), one commit group a stage
template <int NW3>
__device__ __forceinline__ void issue_y(float (&y)[NW3][64], uint32_t (&hf)[4][4],
                                        const bf16* (&ws)[NW3]) {
  fence_frags(hf);
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < NW3; ++h) {
#pragma unroll
    for (int ks = 0; ks < HC / 16; ++ks) wgmma_rs<128>(y[h], hf[ks], desc_w(ws[h], ks), 1);
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

template <int CO>
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
  constexpr int NW3 = CO / 128;  // w3 stages a chunk of h; y's 128-column halves
  static_assert(CO == 128 || CO == 256, "CO is 128 or 256");

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
          for (int hf = 0; hf < NW3; ++hf) load(&tw3, 128 * hf, 64, HC * hb, 0);
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
    float y[NW3][64];
#pragma unroll
    for (int h = 0; h < NW3; ++h) zero_acc(y[h]);
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
        const bf16* ws[NW3];
#pragma unroll
        for (int h = 0; h < NW3; ++h) ws[h] = wait_stage(it + h);
        issue_y<NW3>(y, hf, ws);
        if constexpr (NEXT) {
          wgmma_wait<NW3>();  // all but this chunk's h @ w3
          fence_acc(ha);
          release(it - 2);
          release(it - 1);
        } else {
          wgmma_wait<0>();
        }
        if (hb > 0) {  // the previous chunk's h @ w3 is done
          const int prev = it - (NEXT ? 2 : 0) - NW3;
#pragma unroll
          for (int h = 0; h < NW3; ++h) release(prev + h);
        }
        it += NW3;
      };
      using yes = std::true_type;
#pragma unroll 1
      for (int hb = 0; hb < NCH - 2; hb += 2) {
        chunk(yes(), hf0, hb);
        chunk(yes(), hf1, hb + 1);
      }
      chunk(yes(), hf0, NCH - 2);
      chunk(std::false_type(), hf1, NCH - 1);
#pragma unroll
      for (int h = 0; h < NW3; ++h) {
        fence_acc(y[h]);
        release(it - NW3 + h);
      }
    }

    // out = max over the group's valid rows of T(T(y) + b3)
    {
      uint32_t* scr = reinterpret_cast<uint32_t*>(x2t);  // x2 is spent
#pragma unroll
      for (int hf = 0; hf < NW3; ++hf)
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
      // CO / 4 threads a group, 4 columns each
      const int gg = tid / (CO / 4), col = (tid % (CO / 4)) * 4, g = g0 + 2 * c + gg;
      if (gg < 2 && g < n_groups) {
        const uint32_t* p = scr + gg * 256 + col / 2;
        const uint2 v = {bits(__hmax2(from_bits(p[0]), from_bits(p[128]))),
                         bits(__hmax2(from_bits(p[1]), from_bits(p[129])))};
        *reinterpret_cast<uint2*>(out + (size_t)g * CO + col) = v;
      }
    }
  }
}

// w2, fwg, fwl, w3 by TMA (16-byte aligned bases; the wrapper checks them)
template <int CO>
static int launch(const void* x, int n_groups, int M, const void* fw1, const void* fb1,
                  const void* w2, const void* b2, const void* fwg, const void* fwl, const void* fbs,
                  const void* w3, const void* b3, void* out, cudaStream_t st) {
  if (n_groups < 1) return 0;
  static const int pool = check_reg_pool(mini_forward_wgmma_kernel<CO>, LAUNCH_REGS);
  if (pool) return pool;
  CUtensorMap maps[4];
  int rc = mat_map(&maps[0], (const bf16*)w2, C1, C2, 64);
  if (!rc) rc = mat_map(&maps[1], (const bf16*)fwg, C2, H, 64);
  if (!rc) rc = mat_map(&maps[2], (const bf16*)fwl, C2, H, 64);
  if (!rc) rc = mat_map(&maps[3], (const bf16*)w3, H, CO, 64);
  if (rc) return rc;
  const int tiles = (n_groups + GPT - 1) / GPT, sms = sm_count();
  cudaFuncSetAttribute(mini_forward_wgmma_kernel<CO>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  mini_forward_wgmma_kernel<CO><<<tiles < sms ? tiles : sms, 384, SMEM, st>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)x, n_groups, M, (const bf16*)fw1,
      (const bf16*)fb1, (const bf16*)b2, (const bf16*)fbs, (const bf16*)b3, (bf16*)out);
  PPT_CHECK_LAUNCH();
  return 0;
}
}  // namespace wg

// ---------------------------------------------------------------------------
// mini_stats, bf16, on Hopper: mini_stats_wgmma_kernel, the train-mode BN2
// statistics sweep. Replaces ppt_tpu/kernels/mini.py:mini_stats
// (_stats_kernel, and the pallas_call of _stats_pallas): per tile of groups
// it forms x2 = T(T(x1 @ w2) + b2) as mini_forward does and emits the
// second-moment matrix m2 = sum x2^T x2 [C2, C2] (f32, over ALL rows), each
// group's column sums sg and column maxes gmax [n_groups, C2] (f32); rows of
// absent points (r >= M, a group past n_groups) drop out of every sum and
// max. The closed-form epilogue that turns them into sum(h) and sum(h^2) is
// plain f32 tensor code in the wrapper, as it is plain XLA in the
// reference.
//
// What bounds it on the H100: operations on the tensor cores, 2 n C1 C2 for
// x2 and n C2 (C2 + 1) for the symmetric m2 (64.9 GFLOP at B = 30 x 512 x
// 32, 0.066 ms at the bf16 peak), against 12 bytes of input a row and 8 C2
// bytes of output a group (0.031 ms of HBM). That rate is reached only
// through wgmma, and then only while the CUDA-core work around the products
// (stage 1, x2's epilogue, the group maxes) and the barriers between the
// consumers leave the tensor cores fed; with one CTA of 8 warps an SM (m2's
// accumulators take the registers) that work is latency-bound. The
// mma.sync kernel it replaces ran 66 x 2 CTAs of 8 warps, each column half
// of m2 recomputing stages 1-2 (a third of its operations), m2 computed
// whole, w2 streamed from L2 in 32-row cp.async stages for every tile and
// half (~0.5 GB a call), and x2 read a second time, column by column, for
// the group sums and maxes.
//
// Design: persistent CTAs (one an SM) of two consumer warpgroups and no
// producer walk tiles of 128 rows (4 groups x 32); consumer c owns rows
// 64 c .. 64 c + 63 (the tile's groups 2 c and 2 c + 1).
// - w2 [128][256] (64 KB) is loaded once a CTA by TMA, as four [128 k][64 n]
//   boxes with the 128-byte swizzle, and stays in shared memory for every
//   tile: the sweep reads no other matrix, so it needs no ring.
// - Stage 1 (K = 3) runs on the CUDA cores into the consumer's K-major x1
//   tile, as in mini_forward_wgmma_kernel, one tile ahead (below).
// - Stage 2, x2 = x1 @ w2, runs in 64-column chunks as m64n64k16 wgmma (w2
//   an MN-major B operand), 32 accumulators a thread. Each chunk's
//   epilogue rounds and adds b2 on bf16 pairs, zeroes absent rows and
//   writes x2 into one swizzled [4 chunks][128 rows][64] tile that holds
//   both consumers' rows.
// - m2 += x2^T x2 runs as wgmma with K = the tile's 128 rows, both operands
//   from that x2 tile: A = x2^T and B = x2 are both MN-major (both
//   transpose bits). Only the upper triangle is computed, 10 of the 16
//   64 x 64 blocks, and its accumulators stay in registers across all of
//   the CTA's tiles. The strips (64 rows of m2) are split {0, 3} and {1, 2}
//   between the consumers: 4 + 1 and 3 + 2 blocks, 320 columns and 160
//   accumulators a thread each. ptxas serialises every wgmma of a kernel
//   if one product sits under a branch it cannot prove uniform, so both
//   consumers issue the same three shapes, only their descriptors
//   differ: consumer 0 strip 0 x chunks 0-1 (m64n128), strip 0 x chunks
//   2-3 (m64n128), strip 3 x chunk 3 (m64n64); consumer 1 strip 1 x chunks
//   1-2, strip 2 x chunks 2-3, strip 1 x chunk 3.
// - The group sums come from the tensor cores too: x2^T E, E [8][128] the
//   indicator of each row's group (x2's absent rows are zero), as m64n8
//   products on each consumer's two strips, in their own commit group
//   before m2's and waited for in the same tile (accumulators carried over
//   the tile loop's back-edge while in flight made ptxas serialise every
//   wgmma, C7514/C7515). The group maxes are read back from the x2 tile,
//   a column pair a thread, while m2's products run.
// - m2's products are issued in four commit groups of two k16 steps, each
//   followed by a quarter of the next tile's stage 1 (issued at once, the
//   24 products hold the issuing warps until they are nearly done); the
//   next tile's first stage-2 wait covers them. Two CTA barriers a tile:
//   after that wait (both consumers are done reading x2) and before m2's
//   products (x2 is whole).
// - Registers: 160 for m2, 32 for a stage-2 chunk; ptxas takes 246 of the
//   255 a thread that 256 threads at one CTA an SM allow, no spills, so no
//   setmaxnreg. The descriptors are built from an address made opaque at
//   each use (held across the tile loop, they spilled). A second stage-2
//   accumulator, to overlap a chunk's epilogue with the next chunk's
//   product, took 255 registers and spilled: slower. Shared memory: w2 64
//   KB, x2 64 KB, E 2 KB, x1 2 x 16 KB, fw1, fb1 and b2 2.25 KB: ~165 KB.
// - Between m2's products and their wait no thread spins or loads under
//   a branch: the x loads take clamped indices and a select; only the
//   stores of sg and gmax are guarded (by group). The w2 wait is
//   mbar_wait_warp; each stage-2 accumulator is zeroed before its chunk's
//   first product.
// - Each CTA writes its 10 blocks [10][64][64] as a partial slab;
//   mini_stats_reduce_kernel adds the slabs in CTA order and writes each
//   upper entry to both of its places: m2 is exactly symmetric, repeats are
//   bit-identical, and no atomics are used.
// ---------------------------------------------------------------------------
namespace ms {
constexpr int C1 = 128, C2 = 256;
constexpr int ROWS = 128, GPT = ROWS / MAXM;  // a tile's rows and groups
constexpr int CH = ROWS * 64 * 2;  // bytes of a [128][64] column chunk (w2's k-rows, x2's rows)
constexpr int X1_BYTES = 64 * C1 * 2;  // a consumer's x1 tile, [2 k chunks][64 rows][64]
constexpr int NBLK = 10, BLK = 64 * 64;  // m2's upper 64 x 64 blocks
// shared memory, bytes from a 1024-byte aligned base
constexpr int W2_OFF = 0;
constexpr int X2_OFF = W2_OFF + 4 * CH;
constexpr int E_OFF = X2_OFF + 4 * CH;  // E [8][128] bf16, K-major
constexpr int X1_OFF = E_OFF + 8 * ROWS * 2;
constexpr int PAR_OFF = X1_OFF + 2 * X1_BYTES;  // fw1 [3][128] f32, fb1 and b2 bf16
constexpr int BAR_OFF = PAR_OFF + 3 * C1 * 4 + (C1 + C2) * 2;
constexpr int SMEM = 1024 + BAR_OFF + 8;
static_assert(SMEM <= 232448, "one CTA an SM");
// the (strip, column chunk) of each block of the partial slab: consumer c
// writes blocks 5 c .. 5 c + 4
__constant__ int BLK_ROW[NBLK] = {0, 0, 0, 0, 3, 1, 1, 2, 2, 1};
__constant__ int BLK_COL[NBLK] = {0, 1, 2, 3, 3, 1, 2, 2, 3, 3};

using wg::bf162;
using wg::bits;
using wg::from_bits;

// k16 step ks (rows 16 ks ..) of a [4 chunks][128 rows][64] tile (w2 or x2)
// at shared address t, from column chunk `chunk` on, as an MN-major
// operand: chunks CH bytes apart, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_mn4(uint32_t t, int chunk, int ks) {
  const uint32_t a = t + chunk * CH + ks * 2048;
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(CH >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// k16 step ks of E at shared address t as a K-major B operand [8][128]
// (64-column chunks of 8 rows, 1 KB apart)
__device__ __forceinline__ uint64_t desc_e(uint32_t t, int ks) {
  const uint32_t a = t + (ks >> 2) * 1024 + (ks & 3) * 32;
  return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// x2^T E of strip `strip` (its 64 columns x 8 groups, the groups past 4
// E's zero columns): the thread's rows rr0 and rr0 + 8, groups cq and
// cq + 1, into sg's rows g0 + cq, g0 + cq + 1 where they exist
__device__ __forceinline__ void put_sums(const float (&d)[4], float* sg, int g0, int n_groups,
                                         int strip, int rr0, int cq) {
  float* p = sg + (size_t)(g0 + cq) * C2 + 64 * strip + rr0;
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (cq + e < GPT && g0 + cq + e < n_groups) {
      p[e * C2] = d[e];
      p[e * C2 + 8] = d[2 + e];
    }
}

// component i (a constant after unrolling) of v
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// a product's accumulators (N / 32 blocks of 64 columns) into the slab's
// blocks from `dst` on, at the thread's rows rr0 and rr0 + 8
template <int N>
__device__ __forceinline__ void store_blocks(const float (&d)[N], float* dst, int rr0, int cq) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    float* p = dst + (j >> 3) * BLK + 8 * (j & 7) + cq;
    *reinterpret_cast<float2*>(p + rr0 * 64) = make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(p + (rr0 + 8) * 64) = make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
}

__global__ void __launch_bounds__(256, 1)
mini_stats_wgmma_kernel(const __grid_constant__ CUtensorMap tw2, const float* __restrict__ x,
                        int n_groups, int M, const bf16* __restrict__ fw1,
                        const bf16* __restrict__ fb1, const bf16* __restrict__ b2,
                        float* __restrict__ part, float* __restrict__ sg,
                        float* __restrict__ gmax) {
  extern __shared__ __align__(1024) unsigned char ms_smem[];
  unsigned char* base = align1024(ms_smem);
  float* pw1 = reinterpret_cast<float*>(base + PAR_OFF);
  bf16* pb1 = reinterpret_cast<bf16*>(pw1 + 3 * C1);
  bf16* pb2 = pb1 + C1;
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + BAR_OFF);
  const int n_tiles = (n_groups + GPT - 1) / GPT;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
    mbar_arrive_tx(bar, 4 * CH);
    for (int q = 0; q < 4; ++q) tma_load_2d(base + W2_OFF + q * CH, &tw2, bar, 64 * q, 0);
  }
  for (int e = threadIdx.x; e < 3 * C1; e += blockDim.x) pw1[e] = __bfloat162float(fw1[e]);
  for (int e = threadIdx.x; e < C1; e += blockDim.x) pb1[e] = fb1[e];
  for (int e = threadIdx.x; e < C2; e += blockDim.x) pb2[e] = b2[e];
  if (threadIdx.x < ROWS) {  // E [8 groups][128 rows], K-major: row r's 1 in group r / 32
    const int r = threadIdx.x;
    for (int g = 0; g < 8; ++g)
      *reinterpret_cast<bf16*>(base + E_OFF + wg::swz(g, r, 1024)) =
          __float2bfloat16_rn(g == r / MAXM ? 1.f : 0.f);
  }
  __syncthreads();

  const int c = threadIdx.x >> 7, tid = threadIdx.x & 127, lane = tid & 31, w = tid >> 5;
  unsigned char* x1t = base + X1_OFF + c * X1_BYTES;
  unsigned char* x2t = base + X2_OFF;
  // this thread's accumulator rows rr0 and rr0 + 8 of the consumer's 64 (both
  // in the consumer's group gi) and its column pair cq of each 8-column group
  const int rr0 = 16 * w + (lane >> 2), gi = w >> 1, cq = (lane & 3) * 2;
  // m2's products: strips a0, a1, a2 against column chunks (b0, b0 + 1),
  // (2, 3) and 3; a1 and a2 are the consumer's two strips (and its sums')
  const int a0 = c, b0 = c, a1 = 2 * c, a2 = 3 - 2 * c;
  float q0[64], q1[64], q2[32];
  wg::zero_acc(q0);
  wg::zero_acc(q1);
  wg::zero_acc(q2);

  // stage 1's thread: row r1 of the consumer's 64, column half h1
  const int r1 = tid >> 1, h1 = tid & 1;
  auto load_x = [&](int tile, float (&xv)[3]) {  // clamped: no branch
    const int g = min(tile * GPT + 2 * c + (r1 >> 5), n_groups - 1), pt = min(r1 & 31, M - 1);
    const float* xp = x + ((size_t)g * M + pt) * 3;
    xv[0] = xp[0];
    xv[1] = xp[1];
    xv[2] = xp[2];
  };
  // x1 = relu(T(T(x @ fw1) + fb1)) of a tile on the CUDA cores, a row and
  // 64 columns a thread, in quarters of 16 columns (part p), from the
  // tile's x (xv): the two threads of a row take their 16-byte pieces in
  // orders that put them in different banks
  auto stage1 = [&](int tile, int p, const float (&xv)[3]) {
    const bool ok = tile * GPT + 2 * c + (r1 >> 5) < n_groups && (r1 & 31) < M;
    const float xa = ok ? rnd<bf16>(xv[0]) : 0.f, xb = ok ? rnd<bf16>(xv[1]) : 0.f,
                xc = ok ? rnd<bf16>(xv[2]) : 0.f;
    unsigned char* row = x1t + h1 * (64 * 128) + r1 * 128;
    const bf162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
    for (int u = 2 * p; u < 2 * p + 2; ++u) {
      const int uu = u ^ (h1 << 2), col = h1 * 64 + uu * 8;
      float4 wv[3][2];  // fw1's 8 columns of each of its 3 rows
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wv[k][h] = *reinterpret_cast<const float4*>(pw1 + k * C1 + col + 4 * h);
      const uint4 bb = *reinterpret_cast<const uint4*>(pb1 + col);
      const uint32_t bw[4] = {bb.x, bb.y, bb.z, bb.w};
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float o[2];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int i = 2 * e + f;
          float s = __fmul_rn(xa, comp(wv[0][i >> 2], i & 3));
          s = fmaf(xb, comp(wv[1][i >> 2], i & 3), s);
          o[f] = fmaf(xc, comp(wv[2][i >> 2], i & 3), s);
        }
        v[e] = bits(__hmax2(__hadd2(wg::rnd2(o[0], o[1]), from_bits(bw[e])), zero));
      }
      *reinterpret_cast<uint4*>(row + ((uu ^ (r1 & 7)) << 4)) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  };
  float xn[3];  // x of the tile whose stage 1 comes next
  load_x(blockIdx.x, xn);
#pragma unroll
  for (int p = 0; p < 4; ++p) stage1(blockIdx.x, p, xn);
  load_x(blockIdx.x + gridDim.x, xn);
  mbar_wait_warp(bar, 0);  // w2 is in

  float sa[32];  // a stage-2 chunk
  // x2[:, 64 cc ..] = x1 @ w2[:, 64 cc ..] into sa
  auto s2_product = [&](int cc) {
    wg::zero_acc(sa);
    const uint32_t x1a = wg::opaque_addr(x1t), w2a = wg::opaque_addr(base + W2_OFF);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < C1 / 16; ++ks)
      wgmma_ss<64, 1>(sa, wg::desc_ka(x1a, ks), desc_mn4(w2a, cc, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sa);
  };

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int g0 = tile * GPT, grp = g0 + 2 * c + gi;
    const bool ok0 = grp < n_groups && (rr0 & 31) < M;
    const bool ok1 = grp < n_groups && ((rr0 + 8) & 31) < M;

    fence_proxy_async();
    named_bar_sync(1 + c, 128);

    // chunk cc's epilogue: x2 = T(T(sa) + b2), absent rows zero, into x2t
    auto s2_epilogue = [&](int cc) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * cc + 8 * j + cq;
        const bf162 b = wg::ld2(pb2 + col);
        const uint32_t v0 = bits(__hadd2(wg::rnd2(sa[4 * j], sa[4 * j + 1]), b));
        const uint32_t v1 = bits(__hadd2(wg::rnd2(sa[4 * j + 2], sa[4 * j + 3]), b));
        *reinterpret_cast<uint32_t*>(x2t + wg::swz(64 * c + rr0, col, CH)) = ok0 ? v0 : 0u;
        *reinterpret_cast<uint32_t*>(x2t + wg::swz(64 * c + rr0 + 8, col, CH)) = ok1 ? v1 : 0u;
      }
    };

    s2_product(0);  // its wait also covers the last tile's m2 products
    fence_acc(q0);
    fence_acc(q1);
    fence_acc(q2);
    __syncthreads();  // both consumers are done with the last tile's x2
    s2_epilogue(0);
#pragma unroll 1
    for (int cc = 1; cc < C2 / 64; ++cc) {
      s2_product(cc);
      s2_epilogue(cc);
    }
    fence_proxy_async();
    __syncthreads();  // x2 is whole

    // the consumer's two strips' group sums x2^T E, then m2's upper blocks +=
    // x2^T x2 over the tile's 128 rows, waited for by the next tile's first
    // stage-2 product
    const uint32_t x2a = wg::opaque_addr(x2t), ea = wg::opaque_addr(base + E_OFF);
    float e1[4], e2[4];
    wg::zero_acc(e1);
    wg::zero_acc(e2);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < ROWS / 16; ++ks) {
      wgmma_ss_n8_ta(e1, desc_mn4(x2a, a1, ks), desc_e(ea, ks), ks > 0);
      wgmma_ss_n8_ta(e2, desc_mn4(x2a, a2, ks), desc_e(ea, ks), ks > 0);
    }
    wgmma_commit();
    // m2's products in four commit groups of two k16 steps, each followed by a
    // quarter of the next tile's stage 1 (its x1 is no longer read): the
    // tensor cores drain a group while the CUDA cores run a quarter (issued
    // at once, the products hold the issuing warps until they are nearly
    // done). The stage 1 past the last tile writes x1 to no use.
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int ks = 2 * p; ks < 2 * p + 2; ++ks) {
        wgmma_ss<128, 1, 1>(q0, desc_mn4(x2a, a0, ks), desc_mn4(x2a, b0, ks), 1);
        wgmma_ss<128, 1, 1>(q1, desc_mn4(x2a, a1, ks), desc_mn4(x2a, 2, ks), 1);
        wgmma_ss<64, 1, 1>(q2, desc_mn4(x2a, a2, ks), desc_mn4(x2a, 3, ks), 1);
      }
      wgmma_commit();
      stage1(tile + gridDim.x, p, xn);
    }
    load_x(tile + 2 * gridDim.x, xn);  // in flight until the next tile's end

    // gmax, read from the x2 tile while m2's products run: group gs (two
    // warps), the column pairs at col and col + 128 a thread, over its M
    // valid rows (a warp reads a row's 128 bytes of a chunk)
    if (g0 + (int)(threadIdx.x >> 6) < n_groups) {
      const int gs = threadIdx.x >> 6;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = (threadIdx.x & 63) * 2 + 128 * h;
        const unsigned char* p = x2t + (col >> 6) * CH + gs * MAXM * 128 + (col & 7) * 2;
        const int cg = (col & 63) >> 3;
        bf162 m = from_bits(wg::NEG_INF2);
#pragma unroll
        for (int r = 0; r < MAXM; ++r)
          if (r < M)
            m = __hmax2(m, *reinterpret_cast<const bf162*>(p + r * 128 + ((cg ^ (r & 7)) << 4)));
        *reinterpret_cast<float2*>(gmax + (size_t)(g0 + gs) * C2 + col) = __bfloat1622float2(m);
      }
    }
    wgmma_wait<4>();  // the sums are in; m2's products run on
    fence_acc(e1);
    fence_acc(e2);
    put_sums(e1, sg, g0, n_groups, a1, rr0, cq);
    put_sums(e2, sg, g0, n_groups, a2, rr0, cq);
  }
  wgmma_wait<0>();
  fence_acc(q0);
  fence_acc(q1);
  fence_acc(q2);
  float* dst = part + ((size_t)blockIdx.x * NBLK + 5 * c) * BLK;
  store_blocks(q0, dst, rr0, cq);
  store_blocks(q1, dst + 2 * BLK, rr0, cq);
  store_blocks(q2, dst + 4 * BLK, rr0, cq);
}

// m2[i][j] = m2[j][i] = part[0][e] + part[1][e] + ... in CTA order, for each
// entry e of the slab's blocks with i <= j: m2 exactly symmetric, the same
// bits from run to run
__global__ void mini_stats_reduce_kernel(const float* __restrict__ part, int P,
                                     float* __restrict__ m2) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= NBLK * BLK) return;
  const int blk = e / BLK;
  const int i = 64 * BLK_ROW[blk] + (e / 64) % 64, j = 64 * BLK_COL[blk] + e % 64;
  if (i > j) return;  // a diagonal block's lower half: its mirror's entry
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += part[(size_t)p * NBLK * BLK + e];
  m2[i * C2 + j] = s;
  m2[j * C2 + i] = s;
}

// persistent CTAs: one an SM, at most one a tile
static int blocks(int n_groups) {
  const int tiles = (n_groups + GPT - 1) / GPT, sms = sm_count();
  return tiles < sms ? tiles : sms;
}

// w2 by TMA (a 16-byte aligned base; the wrapper checks it); part
// [blocks, NBLK, 64, 64]
static int launch(const void* x, int n_groups, int M, const void* fw1, const void* fb1,
                  const void* w2, const void* b2, void* part, void* m2, void* sg, void* gmax,
                  cudaStream_t st) {
  CUtensorMap map;
  const int rc = mat_map(&map, (const bf16*)w2, C1, C2, ROWS);
  if (rc) return rc;
  const int P = blocks(n_groups);
  cudaFuncSetAttribute(mini_stats_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM);
  mini_stats_wgmma_kernel<<<P, 256, SMEM, st>>>(map, (const float*)x, n_groups, M,
                                                (const bf16*)fw1, (const bf16*)fb1,
                                                (const bf16*)b2, (float*)part, (float*)sg,
                                                (float*)gmax);
  PPT_CHECK_LAUNCH();
  mini_stats_reduce_kernel<<<NBLK * BLK / 256, 256, 0, st>>>((const float*)part, P, (float*)m2);
  PPT_CHECK_LAUNCH();
  return 0;
}
}  // namespace ms

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
    if (C1 != wg::C1 || C2 != wg::C2 || H != wg::H || (CO != 128 && CO != 256) || M > MAXM)
      return (int)cudaErrorInvalidValue;
    auto launch = CO == 128 ? wg::launch<128> : wg::launch<256>;
    return launch(x, n_groups, M, fw1, fb1, w2, b2, fwg, fwl, fbs, w3, b3, out,
                  (cudaStream_t)stream);
  }
  return launch_f32(x, n_groups, M, C1, C2, H, CO, fw1, fb1, w2, b2, fwg, fwl, fbs, w3, b3,
                    out, stream);
}

// ---------------------------------------------------------------------------
// mini_stats, f32 (FMA on the CUDA cores): the same sweep as the bf16
// kernel above, one group per tile, on a grid of (P, 2) blocks, P
// persistent blocks for each column half of m2. Block (p, half) keeps
// m2[:, 128 half ..] in registers (both halves recompute x2): thread
// (ti, tj) owns rows {4 ti + e, 128 + 4 ti + e} x columns {32 q + 4 tj + f}
// (8 x 16 accumulators), so a row of x2 is read as float4s without bank
// conflicts. m2[i][j] and m2[j][i] are the same fmaf chain over the same
// groups, so m2 is exactly symmetric here too; m2_reduce_kernel adds the
// partials in block order.
// ---------------------------------------------------------------------------
namespace st {
constexpr int C1 = 128, C2 = 256;
constexpr int BLOCKS = 66;  // x 2 column halves = one block an SM
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

// Number of partial m2 slabs that ppt_mini_stats writes for this many
// groups (bf16: one a persistent CTA, [NBLK, 64, 64]; f32: one a persistent
// block of each column half, [C2, C2]); the caller sizes `part` by it.
PPT_EXPORT int ppt_mini_stats_blocks(int dtype, int n_groups) {
  if (dtype == PPT_BF16) return ms::blocks(n_groups);
  return n_groups < st::BLOCKS ? n_groups : st::BLOCKS;
}

// x [n_groups * M, 3] f32; weights in the compute dtype; part
// [ppt_mini_stats_blocks, C2, C2] (bf16 uses NBLK / 16 of it), m2 [C2, C2],
// sg and gmax [n_groups, C2] f32.
PPT_EXPORT int ppt_mini_stats(int dtype, const void* x, int n_groups, int M, int C1, int C2,
                              const void* fw1, const void* fb1, const void* w2, const void* b2,
                              void* part, void* m2, void* sg, void* gmax, void* stream) {
  if (C1 != st::C1 || C2 != st::C2 || M > MAXM || M < 1 || n_groups < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == PPT_BF16)
    return ms::launch(x, n_groups, M, fw1, fb1, w2, b2, part, m2, sg, gmax, s);
  const int P = ppt_mini_stats_blocks(dtype, n_groups);
  cudaFuncSetAttribute(st::mini_stats_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)st::SMEM);
  st::mini_stats_f32_kernel<<<dim3(P, 2), THREADS, st::SMEM, s>>>(
      (const float*)x, n_groups, M, (const float*)fw1, (const float*)fb1, (const float*)w2,
      (const float*)b2, (float*)part, (float*)sg, (float*)gmax);
  PPT_CHECK_LAUNCH();
  const int n = C2 * C2;
  st::m2_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>((const float*)part, P, n, (float*)m2);
  PPT_CHECK_LAUNCH();
  return 0;
}
