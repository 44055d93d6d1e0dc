// Hopper (sm_90a) building blocks for the warp-specialised kernels
// (attention.cuh's whole-row kernel, attention.cu's flash forward and
// backward, gemm.cuh's GEMM, mini.cu's MiniPointNet forward):
// shared-memory tiles in the layout that TMA writes and wgmma reads, their
// wgmma matrix descriptors, the wgmma.mma_async wrappers (bf16 in, f32
// accumulators), mbarrier waits, named barriers, TMA tiled and bulk loads,
// programmatic dependent launch (text.cu's chains of launches), setmaxnreg,
// and the host-side tensor maps of a [B, L, H, D] operand and of a
// row-major matrix.
//
// Tiles. A tile is 64 rows of a bf16 operand whose D columns are
// contiguous, kept as D / CW chunks of [64][CW] with CW = min(D, 64), so
// that a chunk row is the swizzle span 2 CW bytes: 128 B for D = 64 (and
// two chunks for D = 128), 64 B for D = 32, 32 B for D = 16. TMA writes a
// chunk with that swizzle; wgmma reads it through a descriptor of the same
// swizzle, K-major (the tile's rows are the product's M or N, its columns
// the depth: Q, K, V, dO as the left operand or as the K^T of a score
// product) or MN-major (its rows are the depth: V in P V, dO and Q in the
// backward's dV and dK products, K in dQ), the transpose bit of
// wgmma.mma_async. Chunks start on 1024-byte boundaries, so every swizzle
// atom is aligned and the descriptors' base offset is 0.
//
// The tensor map's encoder is a driver-API function; it is taken through
// cudaGetDriverEntryPoint(ByVersion) from the runtime, so the libraries
// link no -lcuda (cuda.h is read for the types alone).
#pragma once

#include <cuda.h>

#include "common.cuh"

// ---------------------------------------------------------------------------
// Tiles and descriptors
// ---------------------------------------------------------------------------
template <int D> struct RowTile {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim 16, 32, 64 or 128");
  static constexpr int CW = D < 64 ? D : 64;  // columns a chunk row holds
  static constexpr int NCH = D / CW;          // chunks across D
  static constexpr int SW = 2 * CW;           // swizzle span, bytes
  static constexpr int CHUNK = 64 * SW;       // bytes of one [64][CW] chunk
  static constexpr int BYTES = NCH * CHUNK;   // bytes of the tile, 64 * D * 2
  static constexpr int ELEMS = BYTES / 2;
};

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode (1: 128 B, 2: 64 B, 3: 32 B).
template <int SW>
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t mode = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

// K-major: the tile's 64 rows are M or N, columns 16 ks .. 16 ks + 15 the
// depth of one k16 step (8-row groups SW * 8 bytes apart; within a chunk
// row the step moves the start address, as the swizzle is a function of
// the address)
template <int D> __device__ __forceinline__ uint64_t desc_k(const bf16* tile, int ks) {
  using T = RowTile<D>;
  const int col = ks * 16;
  return smem_desc<T::SW>(reinterpret_cast<const char*>(tile) + (col / T::CW) * T::CHUNK +
                              (col % T::CW) * 2,
                          16, 8 * T::SW);
}

// MN-major: rows 16 ks .. 16 ks + 15 are the depth of one k16 step, the D
// columns the product's N (chunks CHUNK bytes apart, 8-row groups SW * 8)
template <int D> __device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int ks) {
  using T = RowTile<D>;
  return smem_desc<T::SW>(reinterpret_cast<const char*>(tile) + ks * 16 * T::SW, T::CHUNK,
                          8 * T::SW);
}

// the first 1024-byte boundary at or after p
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// ---------------------------------------------------------------------------
// wgmma.mma_async, bf16 x bf16 -> f32, M = 64 rows a warpgroup. The
// accumulator of m64nN is, per warp w, rows 16 w + l / 4 and + 8 of the
// m16n8k16 C fragment for each 8-column group j: d[4 j + e]. An A operand
// in registers is the m16n8k16 A fragment of the warp's 16 rows. acc = 0
// overwrites d.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous product
template <int N> __device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// pins register A fragments before the wgmma.fence that precedes their
// products, so that no instruction writing them is scheduled after it
// (ptxas would otherwise insert a fence of its own before each product)
template <int K> __device__ __forceinline__ void fence_frags(uint32_t (&f)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(f[i][j])::"memory");
}

// d[64 x N] (+)= A[64 x 16] B[16 x N]: A in registers, B MN-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int acc);

// d[64 x N] (+)= A[64 x 16] B[16 x N], both in shared memory: A K-major, B
// K-major (TB = 0) or MN-major (TB = 1, the transpose bit)
template <int N, int TB> struct WgmmaSS;
template <int TB> struct WgmmaSS<64, TB> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc), "n"(TB));
  }
};

template <int TB> struct WgmmaSS<128, TB> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc), "n"(TB));
  }
};

template <int N, int TB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  WgmmaSS<N, TB>::run(d, a, b, acc);
}

// d[64 x 8] (+)= A[64 x 16] B[16 x 8], both in shared memory: A MN-major (the
// transpose bit: the tile's rows are the depth, its 64 columns the product's
// M), B K-major
__device__ __forceinline__ void wgmma_ss_n8_ta(float (&d)[4], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(acc));
}

template <> __device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                                        const uint32_t (&a)[4], uint64_t b,
                                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <> __device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                                        const uint32_t (&a)[4], uint64_t b,
                                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <> __device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                                        const uint32_t (&a)[4], uint64_t b,
                                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <> __device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                                        const uint32_t (&a)[4], uint64_t b,
                                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// ---------------------------------------------------------------------------
// mbarrier, TMA, setmaxnreg
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}
// Waits for the phase of the given parity to complete. A pipeline that
// never completes it (a fault in the protocol) traps after ~2^34 cycles,
// several seconds: the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

// mbar_wait for a whole warp, its loop warp-uniform (votes): where
// accumulators of wgmma in flight are live across the wait, a per-thread
// spin is a divergent path, and ptxas then serialises every wgmma of the
// kernel (C7520). Traps as mbar_wait does.
__device__ __forceinline__ void mbar_wait_warp(uint64_t* bar, int parity) {
  if (__all_sync(0xffffffffu, mbar_try_wait(bar, parity))) return;
  const long long t0 = clock64();
  while (!__all_sync(0xffffffffu, mbar_try_wait(bar, parity)))
    if (__any_sync(0xffffffffu, clock64() - t0 > (1LL << 34))) __trap();
}

// 4-D tiled TMA load into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// 2-D tiled TMA load into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// 2-D tiled TMA store from shared memory (a bulk group of the issuing
// thread; rows and columns past the map's edges are not written)
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// waits until the issuing thread's bulk groups have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// waits until the issuing thread's bulk groups have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// orders this thread's shared-memory writes before later async-proxy (TMA) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows r0 .. r0 + 63 of head h, batch entry b into a tile (every chunk);
// rows past L arrive zero-filled
template <int D>
__device__ __forceinline__ void tma_tile(bf16* tile, const CUtensorMap* map, uint64_t* bar, int h,
                                         int r0, int b) {
  using T = RowTile<D>;
#pragma unroll
  for (int c = 0; c < T::NCH; ++c)
    tma_load_4d(reinterpret_cast<unsigned char*>(tile) + c * T::CHUNK, map, bar, c * T::CW, h, r0,
                b);
}

// contiguous bulk copy (no tensor map): 16-byte aligned source, bytes a
// multiple of 16
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A barrier among `count` threads (a multiple of 32) under `id` (1-15; 0 is
// __syncthreads's), for the warpgroups of a warp-specialised kernel that
// synchronise without the producer.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Programmatic dependent launch: a kernel launched with launch_kernel(pdl)
// may start while the kernel before it on the stream drains. pdl_wait blocks
// until that kernel has completed and its writes are visible, so a kernel
// calls it before it reads or writes global memory; pdl_launch_dependents
// lets the next kernel launch (it waits in turn). Without the launch
// attribute both are no-ops.
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Register rebalancing between the producer and the consumer warpgroups;
// the whole warpgroup executes it.
template <int R> __device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R> __device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Producer / consumer register budgets of a CTA of NWG warpgroups (one
// producer, NWG - 1 consumers) at MINB CTAs an SM: together they fit in
// the registers the CTA is launched with, LAUNCH a thread.
template <int NWG, int MINB> struct RegSplit {
  static constexpr int FIT = 65536 / (128 * NWG * MINB) / 8 * 8;
  static constexpr int LAUNCH = FIT < 248 ? FIT : 248;
  static constexpr int PRODUCER = NWG > 2 ? 24 : 40;
  static constexpr int SHARE = (NWG * LAUNCH - PRODUCER) / (NWG - 1) / 8 * 8;
  static constexpr int CONSUMER = SHARE < 240 ? SHARE : 240;
  static_assert(PRODUCER + (NWG - 1) * CONSUMER <= NWG * LAUNCH, "register pool exceeded");
  // the launch register count below which the split would not fit
  static constexpr int NEED = (PRODUCER + (NWG - 1) * CONSUMER + NWG - 1) / NWG;
};

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// The tensor map of a bf16 [B, L, H, D] operand with D contiguous and
// element strides (sb, sl, sh) for batch, token and head: dims (D, H, L, B),
// a box of CW columns x 64 tokens of one head and batch entry, the tile's
// swizzle, zero fill past L. The strided q, k, v views of one [B, L, 3C]
// product load as they lie. Returns 0 or a cudaError_t code.
template <int D>
static int bhld_map(CUtensorMap* m, const bf16* base, int B, int L, int H, long long sb,
                    long long sl, long long sh) {
  using T = RowTile<D>;
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::CW, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = T::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : T::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, (void*)base, dims, strides, box,
                        unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The tensor map of a row-major bf16 [rows, cols] matrix (cols contiguous,
// cols * 2 bytes a row, a multiple of 16): dims (cols, rows), a box of 64
// columns (one 128-byte swizzle span) x box_rows rows, zero fill past
// either edge. Returns 0 or a cudaError_t code.
static int mat_map(CUtensorMap* m, const bf16* base, int rows, int cols, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)base, dims, strides, box,
                        unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Launches kernel<<<grid, block, smem, st>>>(args...), with programmatic
// stream serialisation when pdl (see pdl_wait); returns the launch's error
// code.
template <typename... Params, typename... Args>
static int launch_kernel(bool pdl, void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                         cudaStream_t st, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<Args&&>(args)...);
}

// A warp-specialised kernel may only launch when its register count leaves
// room for the producer / consumer split (setmaxnreg.inc would otherwise
// wait for registers that never come): cudaErrorInvalidConfiguration. The
// launchers ask once per kernel.
template <typename K> static int check_reg_pool(K kernel, int need_per_thread) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  return a.numRegs >= need_per_thread ? 0 : (int)cudaErrorInvalidConfiguration;
}
