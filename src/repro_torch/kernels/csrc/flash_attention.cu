// Flash attention forward (prefill self-attention) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention() and its
// Pallas body _kernel() -- softmax(scale * Q K^T) V with an f32 online
// softmax, GQA (query head h reads kv head h / (H / K)), and a causal mask
// aligned to the end (query i sits at key position i + Skv - Sq).
//
// What bounds it on the H100: causal attention does about S/2 FLOP per byte
// of Q, K, V and O in bf16 (D = 128).  At the serving shapes (S = 384..512)
// that is 150..205 FLOP/byte, just under the 295 FLOP/byte ridge of the
// tensor cores, so by the card's peaks the bytes bound it (25 us at B = 8,
// S = 512, H = 32); from S of about 600 the operations do.  This kernel
// multiplies on the SIMT f32 pipe (67 TFLOP/s), not the tensor cores, so
// its own limit is its operations: 257 us at those shapes.
//
// What the design does about it:
//   * one CTA per (64-row query tile, query head, batch); the heaviest causal
//     tiles are scheduled first, since blocks run in no order on 132 SMs;
//   * an in-CTA loop over 64-row K/V tiles that stops at the causal diagonal,
//     so fully masked tiles cost neither bytes nor operations;
//   * Q, K and V tiles are widened to f32 in shared memory with 16-byte
//     loads; each K/V element is read from device memory once per CTA;
//   * each thread owns a 4 x 4 block of the score tile and a 4 x D/16 block
//     of the f32 accumulator, with padded shared rows (no bank conflicts);
//     the 16 threads that share a row reduce its max and sum by shuffles;
//   * ragged tails (any Sq, Skv) are masked, never asserted.
// Tensor-core products (mma.sync / wgmma) and TMA are later work.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBKV = 64;       // key/value rows per inner step
constexpr int kThreads = 256;  // 16 x 16 threads: ty picks 4 rows, tx 4 columns

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBKV * (D + 1) + kBKV * D + kBQ * (kBKV + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                       int Sq, int Skv, int H, int K, int causal, float scale) {
  constexpr int QS = D + 1, KS = D + 1, VS = D, PS = kBKV + 1;
  constexpr int C = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBKV * KS;
  float* Ps = Vs + kBKV * VS;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int shift = Skv - Sq;  // query i sits at key position i + shift

  load_rows<T, D, kThreads>(Qs, QS, q + ((size_t)b * Sq * H + h) * D, (size_t)H * D, q0, kBQ, Sq);

  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  int kv_end = Skv;
  if (causal) kv_end = min(Skv, max(0, min(q0 + kBQ, Sq) + shift));
  const T* kb = k + ((size_t)b * Skv * K + kh) * D;
  const T* vb = v + ((size_t)b * Skv * K + kh) * D;

  for (int t0 = 0; t0 < kv_end; t0 += kBKV) {
    __syncthreads();  // the previous tile is consumed
    load_rows<T, D, kThreads>(Ks, KS, kb, (size_t)K * D, t0, kBKV, Skv);
    load_rows<T, D, kThreads>(Vs, VS, vb, (size_t)K * D, t0, kBKV, Skv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Scale, mask and fold the tile into the running (m, l, acc) per row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + shift;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + tx + 16 * j;
        const bool ok = t < Skv && (!causal || t <= qpos);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
      const float alpha = __expf(m[i] - base);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __expf(s[i][j] - base);
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row of P is written and read by the same 16 lanes

#pragma unroll 4
    for (int t = 0; t < kBKV; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + t];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float vv = Vs[t * VS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    // per-row logsumexp of the scaled scores, for the backward; a row with
    // no key gets +inf, so exp(s - lse) is 0 there
    if (lse && tx == 0)
      lse[((size_t)b * H + h) * Sq + qi] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    T* orow = o + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) orow[tx + 16 * c] = from_float<T>(acc[i][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Skv, int H, int K, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(o), lse, Sq,
                                         Skv, H, K, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int Sq, int Skv, int H, int K, int causal, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, lse, B, Sq, Skv, H, K, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, Sq, Skv, H, K, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, Sq, Skv, H, K, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q: (B, Sq, H, D), k/v: (B, Skv, K, D), o: (B, Sq, H, D), all contiguous and
// 16-byte aligned, H % K == 0.  lse, if not null, receives the per-row
// logsumexp of the scaled scores, (B, H, Sq) float32, for the backward.
// Launches on `stream`, allocates nothing, and returns the cudaError_t of
// the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int Sq, int Skv, int H, int K, int D,
                                   int causal, float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Sq <= 0 || H <= 0 || K <= 0 || H % K != 0 || Skv < 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case kFloat32:
      return dispatch_d<float>(D, q, k, v, o, l, B, Sq, Skv, H, K, causal, scale, s);
    case kBFloat16:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, o, l, B, Sq, Skv, H, K, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
