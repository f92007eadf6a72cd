// Thin inline-PTX helpers for Hopper (sm_90a): wgmma on bf16 with f32
// accumulators, shared-memory matrix descriptors, mbarriers, TMA tile loads
// and setmaxnreg, plus the host-side tensor-map encoder.  Shared by the bf16
// attention kernels and the bf16 SSD forward; no CuTe, so a source builds in
// seconds.
//
// Fragment layouts (PTX ISA, "wgmma" register fragments), for thread
// `tid` of a 128-thread warpgroup, w = tid / 32, g = (tid % 32) / 4,
// c = tid % 4:
//   * accumulator of m64nN: d[4j + e] holds row 16w + g + 8 (e >> 1),
//     column 8j + 2c + (e & 1), for j < N / 8;
//   * register A of m64nNk16: a[0] = (row 16w + g, k 2c..2c+1),
//     a[1] = (row +8, k 2c..), a[2] = (row, k 2c+8..), a[3] = (row +8, k 2c+8..),
//     two bf16 a register, the lower k in the low half.
// So the accumulator columns 16s..16s+15 of one product, packed to bf16 as
// (d[8s], d[8s+1]), (d[8s+2], d[8s+3]), (d[8s+4], d[8s+5]), (d[8s+6], d[8s+7]),
// are the A fragment of k-step s of the next product (`pack_a`).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned address at or after p (a swizzled tile's base).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = 2^(x log2(e))

// 2^x, approximate (2 ulp); 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------------ mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0, so waiting on parity 1 returns at once.  A wait that lasts
// 10 s traps, so a broken pipeline fails its launch instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, n = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (++n == 4096) t0 = global_ns();
    if (n > 4096 && global_ns() - t0 > 10000000000ull) __trap();
  }
}

// ----------------------------------------------------------------------- TMA
// One box of a 4-D tensor map into shared memory; completion is reported to
// `bar` as transaction bytes.  Coordinates are innermost first.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// One contiguous run of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global into shared memory by the bulk-copy engine;
// completion is reported to `bar` as transaction bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ----------------------------------------------------------------- setmaxnreg
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------- matrix descriptors
// Swizzle of a tile whose rows are `row_bytes` long (128, 64 or 32): the
// layout code of the wgmma descriptor (1 = 128-byte, 2 = 64-byte, 3 =
// 32-byte swizzle).
__host__ __device__ constexpr int swizzle_code(int row_bytes) {
  return row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
}

// Descriptor of a bf16 tile in shared memory written by TMA with the swizzle
// of its `row_bytes`-long rows, its base aligned to 1024 bytes.  In either
// major-ness the stride between groups of 8 rows (SBO) is 8 rows; the
// leading offset is unused, since one product never spans two swizzle atoms
// along the contiguous dimension:
//   * K-major (the reduction runs along a row): k-step s starts 32 bytes
//     further along the row (16 bf16);
//   * MN-major (the reduction runs down the rows, transpose bit set): k-step
//     s starts 16 rows further down.
__device__ __forceinline__ uint64_t make_desc(const void* tile, int row_bytes) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t((8 * row_bytes) >> 4) << 32) | (uint64_t(swizzle_code(row_bytes)) << 62);
}

// Advance a descriptor by `bytes` (a multiple of 16) from its start address.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// --------------------------------------------------------------------- wgmma
// Makes this thread's ordinary shared-memory stores visible to the async
// proxy (wgmma operand reads, TMA); follow it with a barrier across the
// threads that stored.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma_wait (the asm statements stay in order).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Two floats to a bf16 pair, `lo` in the low half (round to nearest).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The register-A fragment of k-step s from accumulator columns 16s..16s+15.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 4], const float (&d)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

#define REPRO_ACC16(o)                                                                     \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),         \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]), "+f"(d[o + 8]), "+f"(d[o + 9]),     \
      "+f"(d[o + 10]), "+f"(d[o + 11]), "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]), \
      "+f"(d[o + 15])

// D(64 x 64, f32) (+)= A(64 x 16) B(16 x 64), A and B from shared memory.
// kTransB = 1 when B is MN-major, kTransA = 1 when A is (its 64 rows run
// along a tile row, the 16 k down the tile).  scale_d = 0 overwrites D.
template <int kTransB, int kTransA = 0>
__device__ __forceinline__ void wgmma_64x64_ss(float (&d)[32], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %36, %35;\n}\n"
      : REPRO_ACC16(0), REPRO_ACC16(16)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB), "n"(kTransA));
}

// D(64 x 128) (+)= A(64 x 16) B(16 x 128), both from shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_64x128_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : REPRO_ACC16(0), REPRO_ACC16(16), REPRO_ACC16(32), REPRO_ACC16(48)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
}

// D(64 x 64) (+)= A(64 x 16, registers) B(16 x 64, shared memory).
template <int kTransB>
__device__ __forceinline__ void wgmma_64x64_rs(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : REPRO_ACC16(0), REPRO_ACC16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
}

// D(64 x 32) (+)= A(64 x 16, registers) B(16 x 32, shared memory).
template <int kTransB>
__device__ __forceinline__ void wgmma_64x32_rs(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : REPRO_ACC16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
}

// D(64 x 16) (+)= A(64 x 16, registers) B(16 x 16, shared memory).
template <int kTransB>
__device__ __forceinline__ void wgmma_64x16_rs(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
}

#undef REPRO_ACC16

// The accumulator slice of columns [W i, W i + W) (W = 64, 32 or 16) of a
// wider one: the fragment of a wide product is its 64-column products' side
// by side.
template <int W, int N>
__device__ __forceinline__ float (&acc_slice(float (&d)[N], int i))[W / 2] {
  return *reinterpret_cast<float(*)[W / 2]>(&d[i * (W / 2)]);
}

// ----------------------------------------------------------- bf16 tile shapes
// A (rows x D) bf16 tile of a (B, S, heads, D) tensor as TMA lays it down:
// one sub-tile per 64 columns (128-byte rows, 128-byte swizzle) when D is a
// multiple of 64, a single 64-byte-row tile with the 64-byte swizzle when
// D = 32, and one sub-tile per 16 columns (32-byte rows, 32-byte swizzle)
// when D = 48 (reduced MLA's query / key head).
template <int D>
struct Tile {
  static constexpr int kCols = D % 64 == 0 ? 64 : D == 32 ? 32 : 16;  // columns of a sub-tile
  static constexpr int kRowBytes = 2 * kCols;      // 128, 64 or 32
  static constexpr int kSubs = D / kCols;          // sub-tiles side by side
  static_assert(D == 32 || D == 48 || D == 64 || D == 128 || D == 192, "head dim");
  static constexpr uint32_t sub_bytes(int rows) { return rows * kRowBytes; }
  static constexpr uint32_t bytes(int rows) { return rows * D * 2; }
};

// S (64 x N) (+)= A_rows . B_rows^T over D, both K-major tiles of Tile<D>
// in shared memory: `a` points at the A tile's first row of this warpgroup,
// `b` at the B tile's first row, whose sub-tiles are `a_sub` / `b_sub`
// bytes apart.  N is 64 or 128: one n64 or n128 product a k-step (the
// 128 rows of an n128 B operand lie in one sub-tile, 8-row groups SBO apart).
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&s)[N / 2], const void* a, uint32_t a_sub,
                                        const void* b, uint32_t b_sub) {
  using T = Tile<D>;
  const uint64_t da = make_desc(a, T::kRowBytes), db = make_desc(b, T::kRowBytes);
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    const int sub = k / (T::kCols / 16), col = k % (T::kCols / 16);
    const uint64_t dak = desc_add(da, sub * a_sub + col * 32);
    const uint64_t dbk = desc_add(db, sub * b_sub + col * 32);
    if constexpr (N == 128) {
      wgmma_64x128_ss<0>(s, dak, dbk, k > 0);
    } else {
      static_assert(N == 64, "n64 or n128");
      wgmma_64x64_ss<0>(s, dak, dbk, k > 0);
    }
  }
}

// O (64 x D) += P (64 x 16 KS, registers) . V (16 KS x D, MN-major Tile<D>
// in shared memory, sub-tiles v_sub bytes apart).  p holds 4 registers per
// k-step.  One n32 product at D = 32, one n16 product per 16-column
// sub-tile at D = 48, else one n64 product per 64-column sub-tile.
template <int D, int KS>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2], const uint32_t (&p)[4 * KS],
                                       const void* v, uint32_t v_sub) {
  using T = Tile<D>;
  static_assert(D == 32 || T::kCols == 16 || D % 64 == 0, "n32, n16 or n64 products");
  const uint64_t dv = make_desc(v, T::kRowBytes);
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const uint32_t(&pk)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&p[4 * k]);
#pragma unroll
    for (int sub = 0; sub < T::kSubs; ++sub) {
      const uint64_t dvk = desc_add(dv, sub * v_sub + k * 16 * T::kRowBytes);
      if constexpr (D == 32) {
        wgmma_64x32_rs<1>(o, pk, dvk, 1);
      } else if constexpr (T::kCols == 16) {
        wgmma_64x16_rs<1>(acc_slice<16>(o, sub), pk, dvk, 1);
      } else {
        wgmma_64x64_rs<1>(acc_slice<64>(o, sub), pk, dvk, 1);
      }
    }
  }
}

// ------------------------------------------------------------ host: tensor maps
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so the
// library needs no -lcuda.  Null if the driver has none.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return EncodeTiledFn(nullptr);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return EncodeTiledFn(nullptr);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                            : EncodeTiledFn(nullptr);
  }();
  return fn;
}

// Tensor map of a contiguous bf16 (B, S, heads, D) tensor as the 4-D
// {D, heads, S, B}, with boxes of {Tile<D>::kCols, 1, rows, 1}: one box is
// one sub-tile of `rows` positions of one head.  Rows past S read as 0.
template <int D>
inline bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  using T = Tile<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)(S > 0 ? S : 1),
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::kCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            T::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
            : T::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Load one (rows x D) tile: all its sub-tiles, onto `bar`.
template <int D>
__device__ __forceinline__ void tma_tile(void* dst, uint32_t sub_bytes, const CUtensorMap* map,
                                         uint64_t* bar, int head, int row0, int b) {
  using T = Tile<D>;
#pragma unroll
  for (int sub = 0; sub < T::kSubs; ++sub)
    tma_load_4d(static_cast<char*>(dst) + sub * sub_bytes, map, bar, sub * T::kCols, head, row0,
                b);
}

}  // namespace sm90
}  // namespace repro_torch
