// Device helpers shared by the bf16 SSD kernels on the Hopper tensor cores
// (ssd_scan_fwd.cu, the forward, and ssd_scan_bwd.cu, the backward): the
// 64-row bf16 tile in the 128-byte swizzle that sm90.cuh's wgmma descriptors
// read, its loads (cp.async with zero fill, or through registers with a row
// scale), a chunk's gates (dt and the cumsum of dt * A) and the wgmma
// accumulator's fragment layout.  Tensor maps come from sm90::make_map<64>
// (TMA at n = p = 64).
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace repro_torch {
namespace {
using bf16 = __nv_bfloat16;
constexpr int kT = 64;           // rows of a tile; n and p are padded to it
constexpr int kWG = 128;         // threads of a warpgroup
constexpr int kTB = 4;           // tiles a CTA loads at once (and t tiles a scan CTA)
constexpr int kMaxChunk = 1024;
constexpr uint32_t kTile = 64 * 128;  // bytes of a 64 x 64 bf16 tile

// Byte offset of 16-byte chunk c (8 bf16) of row r in a 128-byte-swizzled
// tile of 64-element rows.
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// rows [0, rows) x cols [0, cols) of a row-major bf16 global matrix (row
// stride `stride` elements), each row times rs[r] when rs is given, into a
// swizzled bf16 tile; everything else is 0.  Thread `tid` of `nthr` takes
// every nthr-th 16-byte chunk.  `vec`: cols and stride are multiples of 8,
// so a chunk is one 16-byte load.
__device__ __forceinline__ void load_tile(uint8_t* __restrict__ tile, const bf16* __restrict__ src,
                                          size_t stride, int rows, int cols,
                                          const float* __restrict__ rs, bool vec, int tid,
                                          int nthr) {
  for (int e = tid; e < kT * 8; e += nthr) {
    const int r = e / 8, c = e % 8;
    float f[8];
    if (r < rows && 8 * c < cols) {
      const bf16* p = src + (size_t)r * stride + 8 * c;
      if (vec) {
        load_vec<8>(p, f);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = 8 * c + i < cols ? to_float(p[i]) : 0.f;
      }
      if (rs) {
        const float sc = rs[r];
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] *= sc;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = 0.f;
    }
    uint4 u;
    u.x = sm90::pack_bf16(f[0], f[1]);
    u.y = sm90::pack_bf16(f[2], f[3]);
    u.z = sm90::pack_bf16(f[4], f[5]);
    u.w = sm90::pack_bf16(f[6], f[7]);
    *reinterpret_cast<uint4*>(tile + swz(r, c)) = u;
  }
}

// A bf16 tile (as load_tile, unscaled) copied by cp.async, 16 bytes a copy
// straight into its swizzled place, zero-filled past rows and cols: no
// register round trip, so a thread's copies are all in flight at once.
// Needs cols and stride multiples of 8 and 16-byte aligned rows.
__device__ __forceinline__ void cp_tile(uint8_t* __restrict__ tile, const bf16* __restrict__ src,
                                        size_t stride, int rows, int cols, int tid, int nthr) {
  for (int e = tid; e < kT * 8; e += nthr) {
    const int r = e / 8, c = e % 8;
    const bool ok = r < rows && 8 * c < cols;
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(tile + swz(r, c)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(ok ? src + (size_t)r * stride + 8 * c : src), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

// A raw bf16 operand tile: cp.async where the widths allow, else load_tile.
__device__ __forceinline__ void stage_tile(uint8_t* tile, const bf16* src, size_t stride, int rows,
                                           int cols, bool vec, int tid, int nthr) {
  if (vec)
    cp_tile(tile, src, stride, rows, cols, tid, nthr);
  else
    load_tile(tile, src, stride, rows, cols, (const float*)nullptr, false, tid, nthr);
}

// The threads' tile stores and copies, made visible to wgmma.
__device__ __forceinline__ void tiles_ready() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  sm90::fence_proxy_async();
  __syncthreads();
}

// dts[i] = dt at chunk row i and cs[i] = inclusive cumsum of dts * a, for
// rows [0, rows).  Ends with the block synchronised.
__device__ void gates(float* __restrict__ dts, float* __restrict__ cs,
                      const float* __restrict__ dt_col, int H, float a, int rows) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) dts[i] = dt_col[(size_t)i * H];
  __syncthreads();
  if (threadIdx.x < 32) {  // one warp: a segment per lane, then a scan of the segments
    const int lane = threadIdx.x, per = (rows + 31) / 32;
    const int lo = min(rows, lane * per), hi = min(rows, lo + per);
    float run = 0.f;
    for (int i = lo; i < hi; ++i) {
      run += dts[i] * a;
      cs[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    for (int i = lo; i < hi; ++i) cs[i] += incl - run;
  }
  __syncthreads();
}

// Accumulator element i of thread lt of a warpgroup: row 16 w + g + 8
// ((i >> 1) & 1), column 8 (i >> 2) + 2 c + (i & 1) (sm90.cuh's layout).
__device__ __forceinline__ int frag_row(int lt, int i) {
  return 16 * (lt / 32) + (lt % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int lt, int i) {
  return 8 * (i >> 2) + 2 * (lt % 4) + (i & 1);
}

}  // namespace
}  // namespace repro_torch
