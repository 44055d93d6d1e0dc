// The ViT block's bf16 GEMM on Hopper, out[M, N] = epi(A[M, K] @ W[K, N]),
// warp-specialised on TMA and wgmma (hopper.cuh). vitblock.cu wraps the
// body in its own __global__ kernel with the block's epilogues; the text
// kernels (text.cu) still run common.cuh's mma.sync body.
//
// Replaces the mma.sync GEMM (common.cuh:gemm_bf16_body) that every
// PointBERT block ran four times (qkv, proj, fc1, fc2): the counterpart of
// the jnp.dot calls inside ppt_tpu/kernels/vitblock.py:_block_body, which
// fused_vit_block, fused_vit_block_readout, fused_vit_tower and the
// ablation probe's _variant_kernel all run.
//
// Bound: operations. At PPT-Base's M = 32 x 513 rows a block's four
// products are 58.1 GFLOP (0.059 ms at the bf16 peak) against ~60 MB of
// operands and results. A CTA tile of BM x BN over a depth-K row does
// 2 BM BN K operations on (BM + BN) K 2 bytes it reads from L2: at 128 x
// 128 that is 64 FLOP a byte, which keeps the loads under the tensor
// cores' rate only with the whole A and W tiles shared by the CTA's
// products, each byte loaded once by TMA.
//
// Design. A persistent CTA an SM walks output tiles (tile = blockIdx.x +
// i gridDim.x, N fastest) with one producer and two consumer warpgroups.
// The producer's one thread streams, per 64-deep k-step, the A tile [128 x
// 64] (K-major, one 128-row box) and the W tile [64 x BN] as W lies, [K,
// N] row-major: BN / 64 boxes of [64 k][64 n], read by wgmma as an
// MN-major B operand (its transpose bit), so no transposed copy of a
// weight is ever made. Tiles land in a ring of STAGES stages, each with a
// full and an empty mbarrier; the ring runs on across tiles, so the next
// tile's loads overlap this tile's last products and epilogue. Each
// consumer owns 64 rows: per k-step four m64nBNk16 wgmma from shared
// memory into f32 registers, the stage released once the next k-step's
// products are issued. The epilogue functor is applied to each f32
// accumulator element in registers (what depends on the row or the column
// alone taken once); the results go out through shared memory by a TMA
// store, which clips rows >= M and columns >= N, while the consumers go on
// to the next tile, and a residual comes in by TMA the same way. TMA
// zero-fills the ragged tiles (M, N and K tails). No split-K, no atomics:
// each output element is one CTA's sum in a fixed order, so repeats are
// bit-identical. One tile width, BN = 128, serves every shape: a ring of
// six stages holds the whole depth of the three K = 384 GEMMs, and wider
// or narrower tiles chosen per shape measured the same on the H100.
#pragma once

#include "hopper.cuh"

constexpr int GM_BM = 128, GM_BN = 128;  // a CTA tile (two consumers of 64 rows)
constexpr int GM_BK = 64;                // a ring stage's depth
constexpr int GM_SMEM = 232448;          // an SM's dynamic shared memory for one CTA

struct GemmTile {
  static constexpr int A_BYTES = GM_BM * GM_BK * 2;  // [128][64], 128-byte swizzle
  static constexpr int W_BYTES = GM_BK * GM_BN * 2;  // [BN / 64][64 k][64 n]
  static constexpr int C_BYTES = GM_BM * GM_BN * 2;  // the output tile, [BN / 64][128][64]
  static constexpr int STAGE = A_BYTES + W_BYTES;
  // alignment slack, output tile, ring, two mbarriers a stage and three for the output tile
  static constexpr int STAGES = (GM_SMEM - 1024 - C_BYTES - 24) / (STAGE + 16);
  static constexpr int SMEM = 1024 + C_BYTES + STAGES * (STAGE + 16) + 24;
  static_assert(STAGES == 6 && SMEM == 230520, "tests/test_torch_vitblock.py mirrors the ring");
};

// the W tile's k16 step ks: rows 16 ks .. 16 ks + 15 of [BN / 64][64 k][64 n]
// (64-column chunks 8 KB apart, 8-row groups 1024 bytes apart)
__device__ __forceinline__ uint64_t desc_w(const bf16* tile, int ks) {
  return smem_desc<128>(reinterpret_cast<const char*>(tile) + ks * 16 * 128, 64 * 128, 8 * 128);
}

static int sm_count() {
  static int n[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!n[dev] && cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    n[dev] = 132;
  return n[dev];
}

// Grid: persistent CTAs, min(tiles, SMs); 384 threads (producer
// warpgroup, two consumers); dynamic shared memory GemmTile::SMEM. K, N
// multiples of 8 (16-byte rows for TMA); ta over A [M, K] with 128-row boxes, tw over W
// [K, N] with 64-row boxes, tc over the output [M, N] and tr over the
// residual [M, N] (read when Epi::RES) with 128-row boxes (mat_map).
//
// The output tile goes out through shared memory: each consumer writes its
// values, rounded to bf16, into the tile C (the layout TMA reads: 64-column
// chunks of 128 rows, 128-byte swizzle, conflict-free for the accumulator
// fragments) and arrives on c_ready; a second producer thread stores C by
// TMA (rows and columns past M and N clipped) and, once the store has read
// C, arrives on c_empty, so the consumers go on to the next tile while the
// store is in flight. With a residual (Epi::RES), the loading thread
// brings the residual tile into C by TMA once C is free (c_full), and the
// epilogue reads it from there and writes its result in its place.
template <typename Epi>
__device__ __forceinline__ void gemm_wgmma_body(const CUtensorMap* ta, const CUtensorMap* tw,
                                                const CUtensorMap* tc, const CUtensorMap* tr,
                                                int M, int N, int K, const Epi& epi) {
  using G = GemmTile;
  constexpr int BN = GM_BN, NS = G::STAGES, AE = G::A_BYTES / 2, WE = G::W_BYTES / 2, CH = 128 * 64;
  using Regs = RegSplit<3, 1>;
  extern __shared__ __align__(1024) unsigned char gm_smem[];
  unsigned char* base = align1024(gm_smem);
  bf16* Cs = reinterpret_cast<bf16*>(base);  // [BN / 64][128][64]
  bf16* As = Cs + G::C_BYTES / 2;            // [NS][128][64]
  bf16* Ws = As + NS * AE;                   // [NS][BN / 64][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(Ws + NS * WE);
  uint64_t* empty = full + NS;
  uint64_t* c_full = empty + NS;   // Epi::RES: the residual tile is in C
  uint64_t* c_ready = c_full + 1;  // the consumers' results are in C
  uint64_t* c_empty = c_ready + 1;  // the store has read C
  const int nt = (N + BN - 1) / BN, tiles = ((M + GM_BM - 1) / GM_BM) * nt;
  const int kt = (K + GM_BK - 1) / GM_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(c_full, 1);
    mbar_init(c_ready, 256);  // every consumer thread
    mbar_init(c_empty, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: thread 0 loads, thread 32 stores
    reg_dealloc<Regs::PRODUCER>();
    if (threadIdx.x == 0) {
      int it = 0;  // stages loaded
      for (int tile = blockIdx.x, u = 0; tile < tiles; tile += gridDim.x, ++u) {
        const int m0 = (tile / nt) * GM_BM, n0 = (tile % nt) * BN;
        for (int k = 0; k < kt; ++k, ++it) {
          const int s = it % NS;
          mbar_wait(&empty[s], ((it / NS) & 1) ^ 1);
          mbar_arrive_tx(&full[s], G::STAGE);
          tma_load_2d(As + s * AE, ta, &full[s], k * GM_BK, m0);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load_2d(Ws + s * WE + c * 64 * 64, tw, &full[s], n0 + 64 * c, k * GM_BK);
          // the residual once the ring holds what it can of this tile (by
          // then the previous tile's store has read C, or soon will)
          if (Epi::RES && k == (kt < NS ? kt : NS) - 1) {
            mbar_wait(c_empty, (u & 1) ^ 1);
            mbar_arrive_tx(c_full, G::C_BYTES);
#pragma unroll
            for (int c = 0; c < BN / 64; ++c) tma_load_2d(Cs + c * CH, tr, c_full, n0 + 64 * c, m0);
          }
        }
      }
    } else if (threadIdx.x == 32) {
      for (int tile = blockIdx.x, u = 0; tile < tiles; tile += gridDim.x, ++u) {
        const int m0 = (tile / nt) * GM_BM, n0 = (tile % nt) * BN;
        mbar_wait(c_ready, u & 1);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c) tma_store_2d(tc, Cs + c * CH, n0 + 64 * c, m0);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(c_empty);
      }
      bulk_wait();
    }
    return;
  }

  reg_alloc<Regs::CONSUMER>();
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, lane = tid & 31,
            warp = tid >> 5;
  const int kq = (lane & 3) * 2;
  // this thread's rows of the tile, and its 4-byte column pair within a
  // 16-byte unit of a 128-byte C row (swizzled by the row's low bits)
  const int rr0 = 64 * wg + 16 * warp + (lane >> 2), sw = lane >> 2;
  unsigned char* crow0 = reinterpret_cast<unsigned char*>(Cs) + rr0 * 128 + 4 * (lane & 3);
  int it = 0;  // stages consumed
  for (int tile = blockIdx.x, u = 0; tile < tiles; tile += gridDim.x, ++u) {
    const int m0 = (tile / nt) * GM_BM, n0 = (tile % nt) * BN;
    float acc[BN / 2];  // written by the first product, not read (fresh each tile)
    int prev = -1;      // the stage whose products are in flight
    for (int k = 0; k < kt; ++k, ++it) {
      const int s = it % NS;
      mbar_wait(&full[s], (it / NS) & 1);
      const bf16* a = As + s * AE + wg * 64 * 64;
      const bf16* w = Ws + s * WE;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < GM_BK / 16; ++ks)
        wgmma_ss<BN, 1>(acc, desc_k<64>(a, ks), desc_w(w, ks), k > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // C is free (and holds the residual) once the previous store has read it
    if (Epi::RES) mbar_wait(c_full, u & 1);
    else mbar_wait(c_empty, (u & 1) ^ 1);
    const int r0 = m0 + rr0, r1 = r0 + 8;
    const float rv0 = r0 < M ? epi.row(r0) : 0.f, rv1 = r1 < M ? epi.row(r1) : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + kq;
      const float cv0 = c < N ? epi.col(c) : 0.f, cv1 = c < N ? epi.col(c + 1) : 0.f;
      unsigned char* unit = crow0 + (j >> 3) * (CH * 2) + (((j & 7) ^ sw) << 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t* p = reinterpret_cast<uint32_t*>(unit + h * 8 * 128);
        float res0 = 0.f, res1 = 0.f;
        if (Epi::RES) {
          const __nv_bfloat162 rp = *reinterpret_cast<const __nv_bfloat162*>(p);
          res0 = __low2float(rp);
          res1 = __high2float(rp);
        }
        const float rv = h ? rv1 : rv0;
        *p = pack_bf16(epi.value(acc[4 * j + 2 * h], rv, cv0, res0),
                       epi.value(acc[4 * j + 2 * h + 1], rv, cv1, res1));
      }
    }
    fence_proxy_async();
    mbar_arrive(c_ready);
  }
}
