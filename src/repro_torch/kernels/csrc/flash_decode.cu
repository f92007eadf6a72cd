// Flash decode: one query token per sequence against a KV cache, for
// Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_decode.py, flash_decode() and its Pallas
// body _kernel() -- attention of q (B, 1, H, D) over cache positions
// [0, vlen) of k (B, S, K, D) and v (B, S, K, Dv), with an f32 online softmax
// and all query heads of a GQA group served from one pass over their kv head.
//
// What bounds it on the H100: bytes.  Each cache element is used for G
// multiply-adds (G = H / K query heads per kv head, 4 for llama3-8b), about
// 2 FLOP per byte in bf16, against a 295 FLOP/byte ridge.  The least time is
// the valid prefix of K and V, B * vlen * K * (D + Dv) elements, streamed
// once at 3.35 TB/s.
//
// What the design does about it:
//   * one CTA per (kv head, batch, group of up to 8 query heads): each K/V
//     row is read from device memory once per group, as in the reference
//     (groups wider than 8 heads, e.g. MQA with 32 heads, take several CTAs);
//   * rows at or past vlen are never read;
//   * each warp streams its own runs of 4 consecutive rows; a lane holds D/32
//     contiguous elements of a row, loaded as one 4- to 16-byte word, so a
//     warp reads whole rows coalesced and keeps 4 rows of loads in flight;
//   * scores are reduced by warp shuffles, the softmax runs in f32 with the
//     scale applied in f32 inside the kernel, and the warps' partial
//     (m, l, acc) are merged once through shared memory at the end.
// At B = 8, K = 8 the grid is 64 CTAs, so it fills 64 of the 132 SMs;
// splitting the sequence across CTAs (split-KV) is later work.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGMax = 8;  // query heads per CTA
constexpr int kRows = 4;  // cache rows per warp step

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    int S, int H, int K, int vlen, float scale) {
  constexpr int EK = D / 32, EV = DV / 32;  // elements per lane
  __shared__ float sm_m[kWarps][kGMax];
  __shared__ float sm_l[kWarps][kGMax];
  __shared__ float sm_acc[kWarps][kGMax][DV];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / K;
  const int h0 = kh * G + blockIdx.z * kGMax;  // first query head of this CTA
  const int ng = min(kGMax, G - blockIdx.z * kGMax);
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;

  float qr[kGMax][EK];
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    if (g < ng) {
      load_vec<EK>(q + ((size_t)b * H + h0 + g) * D + lane * EK, qr[g]);
#pragma unroll
      for (int e = 0; e < EK; ++e) qr[g][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < EK; ++e) qr[g][e] = 0.f;
    }
  }
  float m[kGMax], l[kGMax], acc[kGMax][EV];
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EV; ++e) acc[g][e] = 0.f;
  }

  const size_t row = (size_t)K * D, vrow = (size_t)K * DV;
  const T* kb = k + ((size_t)b * S * K + kh) * D + lane * EK;
  const T* vb = v + ((size_t)b * S * K + kh) * DV + lane * EV;

  for (int t0 = w * kRows; t0 < vlen; t0 += kWarps * kRows) {
    float kr[kRows][EK], vr[kRows][EV];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (t0 + u < vlen) {
        load_vec<EK>(kb + (t0 + u) * row, kr[u]);
        load_vec<EV>(vb + (t0 + u) * vrow, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EK; ++e) kr[u][e] = 0.f;
#pragma unroll
        for (int e = 0; e < EV; ++e) vr[u][e] = 0.f;
      }
    }
    // Head slots g >= ng are idle; ng is the same for the whole CTA, so the
    // branches below do not diverge.
    float s[kRows][kGMax];
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      if (g >= ng) break;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < EK; ++e) x = fmaf(qr[g][e], kr[u][e], x);
        s[u][g] = x;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < kRows; ++u) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
    }

#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      if (g >= ng) break;
      float mx = s[0][g];  // row t0 < vlen is always valid
#pragma unroll
      for (int u = 1; u < kRows; ++u)
        if (t0 + u < vlen) mx = fmaxf(mx, s[u][g]);
      const float m_new = fmaxf(m[g], mx);
      const float alpha = __expf(m[g] - m_new);
      float p[kRows];
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        p[u] = t0 + u < vlen ? __expf(s[u][g] - m_new) : 0.f;
        ps += p[u];
      }
      l[g] = l[g] * alpha + ps;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < EV; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < kRows; ++u) a = fmaf(p[u], vr[u][e], a);
        acc[g][e] = a;
      }
    }
  }

  // Merge the warps' partial softmaxes.
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    if (lane == 0) {
      sm_m[w][g] = m[g];
      sm_l[w][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EV; ++e) sm_acc[w][g][lane * EV + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ng * DV; idx += kThreads) {
    const int g = idx / DV, d = idx % DV;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) mx = fmaxf(mx, sm_m[i][g]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {  // vlen >= 1
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        const float c = __expf(sm_m[i][g] - mx);
        num = fmaf(c, sm_acc[i][g][d], num);
        den = fmaf(c, sm_l[i][g], den);
      }
    }
    o[((size_t)b * H + h0 + g) * DV + d] = from_float<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int K, int vlen, float scale, cudaStream_t stream) {
  const int G = H / K;
  const dim3 grid(K, B, (G + kGMax - 1) / kGMax);
  flash_decode_kernel<T, D, DV><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, K, vlen, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_dv(int Dv, const void* q, const void* k, const void* v, void* o, int B,
                        int S, int H, int K, int vlen, float scale, cudaStream_t stream) {
  switch (Dv) {
    case 32: return launch<T, D, 32>(q, k, v, o, B, S, H, K, vlen, scale, stream);
    case 64: return launch<T, D, 64>(q, k, v, o, B, S, H, K, vlen, scale, stream);
    case 128: return launch<T, D, 128>(q, k, v, o, B, S, H, K, vlen, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(int D, int Dv, const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int K, int vlen, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return dispatch_dv<T, 32>(Dv, q, k, v, o, B, S, H, K, vlen, scale, stream);
    case 64: return dispatch_dv<T, 64>(Dv, q, k, v, o, B, S, H, K, vlen, scale, stream);
    case 128: return dispatch_dv<T, 128>(Dv, q, k, v, o, B, S, H, K, vlen, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q: (B, 1, H, D), k: (B, S, K, D), v: (B, S, K, Dv), o: (B, 1, H, Dv), all
// contiguous and 16-byte aligned, H % K == 0.  Positions >= vlen are masked
// (vlen is clamped to S).  Launches on `stream`, allocates nothing, and
// returns the cudaError_t of the launch (0 on success).
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                int S, int H, int K, int D, int Dv, int vlen, float scale,
                                int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S < 0 || H <= 0 || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  vlen = vlen < 0 ? 0 : (vlen > S ? S : vlen);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch_d<float>(D, Dv, q, k, v, o, B, S, H, K, vlen, scale, s);
    case kBFloat16:
      return dispatch_d<__nv_bfloat16>(D, Dv, q, k, v, o, B, S, H, K, vlen, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
