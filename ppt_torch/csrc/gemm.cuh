// The bf16 GEMM on Hopper, out[M, N] = epi(A[M, K] @ W), warp-specialised
// on TMA and wgmma (hopper.cuh), with W either [K, N] as a forward weight
// lies or [N, K] (the product A @ W^T of a backward against the same
// weight). vitblock.cu and text.cu each wrap the body in their own
// __global__ kernels with their own epilogue functors.
//
// Replaces the mma.sync GEMM that every PointBERT block ran four times
// (qkv, proj, fc1, fc2) and that the CLIP text kernels ran seven times a
// layer in their backward: the counterpart of the jnp.dot calls inside
// ppt_tpu/kernels/vitblock.py:_block_body (fused_vit_block,
// fused_vit_block_readout, fused_vit_tower, the ablation probe's
// _variant_kernel) and inside texttower.py's _tower_kernel and
// _tower_bwd_kernel and textblock.py's _text_kernel.
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
// 64] (K-major, one 128-row box) and the W tile as W lies: from [K, N],
// BN / 64 boxes of [64 k][64 n], read by wgmma as an MN-major B operand
// (its transpose bit); from [N, K] (WK), one box of [BN n][64 k], read
// K-major as A is. So no transposed copy of a weight is ever made. Tiles
// land in a ring of STAGES stages, each with a full and an empty mbarrier;
// the ring runs on across tiles, so the next tile's loads overlap this
// tile's last products and epilogue. Each consumer owns 64 rows: per
// k-step four m64nBNk16 wgmma from shared memory into f32 registers, the
// stage released once the next k-step's products are issued. The
// epilogue functor is applied to each f32 accumulator element in
// registers (what depends on the row or the column alone taken once, a
// 64-column chunk's column values read before any of its results is
// written, so their loads are in flight together). A bf16 result goes out
// through shared memory by a TMA store, which clips rows >= M and columns
// >= N, while the consumers go on to the next tile; a residual comes in by
// TMA the same way. An f32 result (Epi::OUT32: the text backward's
// LayerNorm cotangents) is stored from the registers, each thread two
// adjacent columns (8 bytes; a warp's store covers whole 32-byte sectors
// of 8 rows): a 128 x 128 f32 tile would take 64 KB, two stages of the
// ring. Epi::DUAL runs a second product into a second accumulator after
// the first, in the same CTA and ring, and hands the epilogue both: the
// text backward's dh = (dT @ wproj^T) * quick_gelu'(y2 @ wfc + bfc), whose
// GELU pre-activation so never leaves the registers (it was an f32 [R,
// hid] product written by one launch and read back by the next). TMA
// zero-fills the ragged tiles (M, N and K tails). No split-K, no atomics:
// each output element is one CTA's sum in a fixed order, so repeats are
// bit-identical.
//
// Tile width. The ViT block's products (M = 16416) run on 128 x 128 tiles:
// a ring of six stages holds the whole depth of the three K = 384 GEMMs,
// and wider or narrower tiles chosen per shape measured the same on the
// H100. The text tower's M = 40 x 48 = 1920 rows are 15 row tiles: every
// product with N = 512 (out-proj and fc2, and three of the backward's
// four input-cotangent products) is 60 tiles of 128 on 132 SMs, and qkv's
// N = 1536 180 of them (1.4 waves). There gemm_tile_n takes 128 x 64 tiles
// (120 and 360 CTA tiles; an eight-stage ring), by a rule on (M, N, SMs)
// alone: the narrower tile wherever its waves, in 64-column units, are
// fewer. On the H100 (80GB HBM3, 700 W), timed by chip_smoke.py's
// alternated rounds against a development build of text.cu with every
// product on 128-wide tiles, the rule took the tower's forward from 0.903
// to 0.839 ms and its backward from 1.499 to 1.406 ms, results identical;
// 128 x 256 tiles for N = 2048, tried in a development build, ran no
// faster than 128 x 128 ones. At these shapes the products run at
// 230-280 TFLOP/s: with one to three tiles a CTA, each tile's pipeline fill
// and epilogue are paid in full.

#pragma once

#include "hopper.cuh"

constexpr int GM_BM = 128, GM_BN = 128;  // a CTA tile (two consumers of 64 rows), widest
constexpr int GM_BK = 64;                // a ring stage's depth
constexpr int GM_SMEM = 232448;          // an SM's dynamic shared memory for one CTA

template <int BN>
struct GemmTile {
  static_assert(BN == 64 || BN == 128, "tile width 64 or 128");
  static constexpr int A_BYTES = GM_BM * GM_BK * 2;  // [128][64], 128-byte swizzle
  static constexpr int W_BYTES = GM_BK * BN * 2;     // [BN / 64][64 k][64 n] or [BN n][64 k]
  static constexpr int C_BYTES = GM_BM * BN * 2;     // the output tile, [BN / 64][128][64]
  static constexpr int STAGE = A_BYTES + W_BYTES;
  // alignment slack, output tile, ring, two mbarriers a stage and three for the output tile
  static constexpr int STAGES = (GM_SMEM - 1024 - C_BYTES - 24) / (STAGE + 16);
  static constexpr int SMEM = 1024 + C_BYTES + STAGES * (STAGE + 16) + 24;
  static_assert(BN == 64 ? STAGES == 8 && SMEM == 214168 : STAGES == 6 && SMEM == 230520,
                "tests/test_torch_vitblock.py mirrors the ring");
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

// The output tile's width for an M x N product on `sms` SMs: 64 where its
// waves of persistent CTAs take less time than the 128-wide tiles' (a
// 128-wide tile counted as two 64-wide ones), else 128.
static int gemm_tile_n(int M, int N, int sms) {
  const long long rows = (M + GM_BM - 1) / GM_BM;
  const long long w128 = (rows * ((N + 127) / 128) + sms - 1) / sms;
  const long long w64 = (rows * ((N + 63) / 64) + sms - 1) / sms;
  return w64 < 2 * w128 ? 64 : 128;
}

// One k-step loop of a consumer warpgroup: kt stages of the ring into acc
// (its 64 rows of A times W, W K-major when WK), each stage released once
// the next stage's products are issued. it and prev carry the ring's
// position and the stage whose products are in flight across calls.
template <int BN, bool WK, int NS, int AE, int WE>
__device__ __forceinline__ void gemm_k_loop(float (&acc)[BN / 2], const bf16* As, const bf16* Ws,
                                            uint64_t* full, uint64_t* empty, int kt, int wg,
                                            int lane, int& it, int& prev) {
  for (int k = 0; k < kt; ++k, ++it) {
    const int s = it % NS;
    mbar_wait(&full[s], (it / NS) & 1);
    const bf16* a = As + s * AE + wg * 64 * 64;
    const bf16* w = Ws + s * WE;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < GM_BK / 16; ++ks)
      wgmma_ss<BN, WK ? 0 : 1>(acc, desc_k<64>(a, ks), WK ? desc_k<64>(w, ks) : desc_w(w, ks),
                               k > 0 || ks > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = s;
  }
}

// Grid: persistent CTAs, min(tiles, SMs); 384 threads (producer
// warpgroup, two consumers); dynamic shared memory GemmTile<BN>::SMEM. K,
// N multiples of 8 (16-byte rows for TMA); ta over A [M, K] with 128-row
// boxes, tw over W [K, N] with 64-row boxes or (WK) over W [N, K] with
// BN-row boxes, tc over the output [M, N] and tr over the residual [M, N]
// (read when Epi::RES) with 128-row boxes (mat_map); tc and tr are not
// read when Epi::OUT32. Epi::DUAL: a second product A2 [M, K] @ W2 [K, N]
// (ta2 with 128-row boxes, tw2 with 64-row boxes, W2 as a forward weight
// lies) runs after the first in the same CTA, into a second accumulator.
//
// The bf16 output tile goes out through shared memory: each consumer
// writes its values, rounded to bf16, into the tile C (the layout TMA
// reads: 64-column chunks of 128 rows, 128-byte swizzle, conflict-free
// for the accumulator fragments) and arrives on c_ready; a second producer
// thread stores C by TMA (rows and columns past M and N clipped) and, once
// the store has read C, arrives on c_empty, so the consumers go on to the
// next tile while the store is in flight. With a residual (Epi::RES), the
// loading thread brings the residual tile into C by TMA once C is free
// (c_full), and the epilogue reads it from there and writes its result in
// its place.
//
// The functor gives row(r) and col(c), the parts that depend on the row or
// the column alone, and value(acc, rv, cv, ev), the value before its final
// rounding, where ev is the element's residual (RES) or, for DUAL,
// pre(acc2, col2(c)) of the second product's element; an f32 result
// (OUT32) leaves by store2(r, c, v0, v1). Each 64-column chunk's column
// values are read before any of its results is written.
template <int BN, bool WK, typename Epi>
__device__ __forceinline__ void gemm_wgmma_body(const CUtensorMap* ta, const CUtensorMap* tw,
                                                const CUtensorMap* tc, const CUtensorMap* tr,
                                                int M, int N, int K, const Epi& epi,
                                                const CUtensorMap* ta2 = nullptr,
                                                const CUtensorMap* tw2 = nullptr) {
  using G = GemmTile<BN>;
  constexpr int NS = G::STAGES, AE = G::A_BYTES / 2, WE = G::W_BYTES / 2, CH = 128 * 64;
  constexpr bool TILE_OUT = !Epi::OUT32;  // the result leaves through C by a TMA store
  static_assert(!(Epi::RES && Epi::DUAL), "the residual is loaded during the first product");
  using Regs = RegSplit<3, 1>;
  extern __shared__ __align__(1024) unsigned char gm_smem[];
  unsigned char* base = align1024(gm_smem);
  bf16* Cs = reinterpret_cast<bf16*>(base);  // [BN / 64][128][64]
  bf16* As = Cs + G::C_BYTES / 2;            // [NS][128][64]
  bf16* Ws = As + NS * AE;                   // [NS][BN / 64][64][64] or [NS][BN][64]
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
        for (int pass = 0; pass < (Epi::DUAL ? 2 : 1); ++pass) {
          for (int k = 0; k < kt; ++k, ++it) {
            const int s = it % NS;
            mbar_wait(&empty[s], ((it / NS) & 1) ^ 1);
            mbar_arrive_tx(&full[s], G::STAGE);
            tma_load_2d(As + s * AE, pass ? ta2 : ta, &full[s], k * GM_BK, m0);
            if (WK && pass == 0) {
              tma_load_2d(Ws + s * WE, tw, &full[s], k * GM_BK, n0);
            } else {
#pragma unroll
              for (int c = 0; c < BN / 64; ++c)
                tma_load_2d(Ws + s * WE + c * 64 * 64, pass ? tw2 : tw, &full[s], n0 + 64 * c,
                            k * GM_BK);
            }
            // the residual once the ring holds what it can of this tile (by
            // then the previous tile's store has read C, or soon will)
            if (Epi::RES && k == (kt < NS ? kt : NS) - 1) {
              mbar_wait(c_empty, (u & 1) ^ 1);
              mbar_arrive_tx(c_full, G::C_BYTES);
#pragma unroll
              for (int c = 0; c < BN / 64; ++c)
                tma_load_2d(Cs + c * CH, tr, c_full, n0 + 64 * c, m0);
            }
          }
        }
      }
    } else if (TILE_OUT && threadIdx.x == 32) {
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
    float acc2[Epi::DUAL ? BN / 2 : 1];  // DUAL: the second product
    int prev = -1;  // the stage whose products are in flight
    gemm_k_loop<BN, WK, NS, AE, WE>(acc, As, Ws, full, empty, kt, wg, lane, it, prev);
    if constexpr (Epi::DUAL)
      gemm_k_loop<BN, false, NS, AE, WE>(acc2, As, Ws, full, empty, kt, wg, lane, it, prev);
    wgmma_wait<0>();
    fence_acc(acc);
    if constexpr (Epi::DUAL) fence_acc(acc2);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // C is free (and holds the residual) once the previous store has read it
    if (Epi::RES) mbar_wait(c_full, u & 1);
    else if (TILE_OUT) mbar_wait(c_empty, (u & 1) ^ 1);
    const int r0 = m0 + rr0, r1 = r0 + 8;
    const float rv0 = r0 < M ? epi.row(r0) : 0.f, rv1 = r1 < M ? epi.row(r1) : 0.f;
#pragma unroll
    for (int q = 0; q < BN / 64; ++q) {  // a 64-column chunk, its column values read first
      float cv[8][2], cv2[8][2];  // the columns' values (cv2: of the second product, DUAL)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = n0 + 64 * q + 8 * jj + kq;
        cv[jj][0] = c < N ? epi.col(c) : 0.f;
        cv[jj][1] = c < N ? epi.col(c + 1) : 0.f;
        if constexpr (Epi::DUAL) {
          cv2[jj][0] = c < N ? epi.col2(c) : 0.f;
          cv2[jj][1] = c < N ? epi.col2(c + 1) : 0.f;
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * q + jj, c = n0 + 8 * j + kq;
        unsigned char* unit = crow0 + q * (CH * 2) + ((jj ^ sw) << 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = h ? r1 : r0;
          const float rv = h ? rv1 : rv0;
          float e0 = 0.f, e1 = 0.f;  // the residual, or the second product's element
          if constexpr (Epi::DUAL) {
            e0 = epi.pre(acc2[4 * j + 2 * h], cv2[jj][0]);
            e1 = epi.pre(acc2[4 * j + 2 * h + 1], cv2[jj][1]);
          }
          if constexpr (Epi::OUT32) {
            if (r < M && c < N)
              epi.store2(r, c, epi.value(acc[4 * j + 2 * h], rv, cv[jj][0], e0),
                         epi.value(acc[4 * j + 2 * h + 1], rv, cv[jj][1], e1));
          } else {
            uint32_t* p = reinterpret_cast<uint32_t*>(unit + h * 8 * 128);
            if (Epi::RES) {
              const __nv_bfloat162 rp = *reinterpret_cast<const __nv_bfloat162*>(p);
              e0 = __low2float(rp);
              e1 = __high2float(rp);
            }
            *p = pack_bf16(epi.value(acc[4 * j + 2 * h], rv, cv[jj][0], e0),
                           epi.value(acc[4 * j + 2 * h + 1], rv, cv[jj][1], e1));
          }
        }
      }
    }
    if (TILE_OUT) {
      fence_proxy_async();
      mbar_arrive(c_ready);
    }
  }
}
