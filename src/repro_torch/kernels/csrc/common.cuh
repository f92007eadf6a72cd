// Shared helpers for the kernels: vector and scalar loads that widen
// float32 / bfloat16 to float32, and the store back to the input type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// Dtype codes passed from the Python wrappers.
enum DtypeCode : int { kFloat32 = 0, kBFloat16 = 1 };

// Load N consecutive elements into floats, in 16-, 8- or 4-byte words.
// The caller guarantees that p is aligned to the widest word used.
template <int N>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 r = *reinterpret_cast<const float4*>(p + i);
      out[i] = r.x; out[i + 1] = r.y; out[i + 2] = r.z; out[i + 3] = r.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 r = *reinterpret_cast<const float2*>(p + i);
      out[i] = r.x; out[i + 1] = r.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// bfloat16 -> float32 is exact: the 16 bits are the top half of the float.
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p, float* out) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 r = *reinterpret_cast<const uint4*>(p + i);
      out[i] = bf16_lo(r.x); out[i + 1] = bf16_hi(r.x);
      out[i + 2] = bf16_lo(r.y); out[i + 3] = bf16_hi(r.y);
      out[i + 4] = bf16_lo(r.z); out[i + 5] = bf16_hi(r.z);
      out[i + 6] = bf16_lo(r.w); out[i + 7] = bf16_hi(r.w);
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint2 r = *reinterpret_cast<const uint2*>(p + i);
      out[i] = bf16_lo(r.x); out[i + 1] = bf16_hi(r.x);
      out[i + 2] = bf16_lo(r.y); out[i + 3] = bf16_hi(r.y);
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const unsigned r = *reinterpret_cast<const unsigned*>(p + i);
      out[i] = bf16_lo(r); out[i + 1] = bf16_hi(r);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __bfloat162float(p[i]);
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Copy rows [row0, row0 + rows) of one attention head (D values a row,
// consecutive positions src_row_stride elements apart) into a shared f32
// tile with row stride `stride`, 16 bytes a load; rows past `n_rows` are 0.
template <typename T, int D, int kThreads>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, int stride,
                                          const T* __restrict__ src, size_t src_row_stride,
                                          int row0, int rows, int n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int e = threadIdx.x; e < rows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e % kChunks) * kVec;
    float tmp[kVec];
    if (row0 + r < n_rows) {
      load_vec<kVec>(src + (size_t)(row0 + r) * src_row_stride + c, tmp);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) tmp[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[r * stride + c + i] = tmp[i];
  }
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

}  // namespace repro_torch
