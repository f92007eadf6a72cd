// Flash attention backward for Hopper, sm_90a: dQ, dK and dV of
// softmax(scale * Q K^T) V with GQA and the end-aligned causal mask.
//
// Replaces: the gradient of src/repro/kernels/flash_attention.py,
// flash_attention() / _kernel().  The reference has no VJP (its gradients
// come from autodiff of the jnp path); this is the standard flash
// backward, from the forward's per-row logsumexp (lse) and
// Delta = rowsum(dO * O):
//   P = exp(scale S - lse), dP = dO V^T, dS = P * (dP - Delta),
//   dQ = scale dS K, dK = scale dS^T Q, dV = P^T dO.
//
// What bounds it on the H100: 2.5x the forward's multiply-adds over the
// same bytes plus dO, O, dQ, dK, dV; at the zamba2 shared block's shape
// (B = 2, S = 2048, H = K = 32, D = 64) the operations bound it by the
// card's bf16 peak.  These kernels multiply on the SIMT f32 pipe, so
// their own limit is their operations.
//
// What the design does about it:
//   * two kernels, so no thread block needs atomics: dQ one CTA per
//     (64-row query tile, query head, batch), looping over K/V tiles up to
//     the causal diagonal (it also computes Delta and writes it for the
//     second); dK/dV one CTA per (64-row key tile, kv head, batch), looping
//     over the G query heads of its group and the query tiles from the
//     diagonal down, so the GQA sum over heads happens in registers;
//   * P is recomputed from lse, never stored (no S x S buffer);
//   * masked and ragged positions get P = 0 by construction;
//   * each thread owns a 4 x 4 block of every 64 x 64 score tile and a
//     4 x D/16 block of its accumulators; shared rows are padded.
// Tensor-core products (mma.sync / wgmma) and TMA are later work.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kB = 64;         // rows of a query or key tile
constexpr int kThreads = 256;  // 16 x 16 threads: ty picks 4 rows, tx 4 columns
constexpr int kPS = kB + 1;

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kB * (D + 1) + kB * kPS + 2 * kB);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kB * (D + 1) + 2 * kB * kPS + 2 * kB);
}

// 4 x 4 dot products of rows ty*4+i of X with rows tx+16j of Y over D.
template <int D>
__device__ __forceinline__ void dots(float (&out)[4][4], const float* __restrict__ X,
                                     const float* __restrict__ Y, int tx, int ty) {
  constexpr int RS = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float xv[4], yv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = X[(ty * 4 + i) * RS + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) yv[j] = Y[(tx + 16 * j) * RS + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(xv[i], yv[j], out[i][j]);
  }
}

// acc[i][c] += sum_r M[ty*4+i][r] * Y[r][tx+16c] over r < kB (M is kB x kB).
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[4][D / 16], const float* __restrict__ M,
                                           const float* __restrict__ Y, int tx, int ty) {
  constexpr int RS = D + 1;
#pragma unroll 4
  for (int r = 0; r < kB; ++r) {
    float mv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) mv[i] = M[(ty * 4 + i) * kPS + r];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float yv = Y[r * RS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(mv[i], yv, acc[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
          T* __restrict__ dq, float* __restrict__ delta, int Sq, int Skv, int H, int K,
          int causal, float scale) {
  constexpr int RS = D + 1, C = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * RS;
  float* Ks = dOs + kB * RS;
  float* Vs = Ks + kB * RS;
  float* dSs = Vs + kB * RS;
  float* lse_s = dSs + kB * kPS;
  float* del_s = lse_s + kB;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int shift = Skv - Sq;
  const size_t qrow = (size_t)H * D, krow = (size_t)K * D;
  const size_t qoff = (size_t)b * Sq * H * D + (size_t)h * D;
  const size_t hrow = ((size_t)b * H + h) * Sq;

  load_rows<T, D, kThreads>(Qs, RS, q + qoff, qrow, q0, kB, Sq);
  load_rows<T, D, kThreads>(dOs, RS, dout + qoff, qrow, q0, kB, Sq);
  load_rows<T, D, kThreads>(Ks, RS, o + qoff, qrow, q0, kB, Sq);  // O, for Delta only
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qi = q0 + r;
    float dsum = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) dsum = fmaf(dOs[r * RS + tx + 16 * c], Ks[r * RS + tx + 16 * c], dsum);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
    if (tx == 0) {
      del_s[r] = dsum;
      lse_s[r] = qi < Sq ? lse[hrow + qi] : INFINITY;
      if (qi < Sq) delta[hrow + qi] = dsum;
    }
  }

  float acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;

  int kv_end = Skv;
  if (causal) kv_end = min(Skv, max(0, min(q0 + kB, Sq) + shift));
  const T* kb = k + (size_t)b * Skv * krow + (size_t)kh * D;
  const T* vb = v + (size_t)b * Skv * krow + (size_t)kh * D;
  for (int t0 = 0; t0 < kv_end; t0 += kB) {
    __syncthreads();  // the previous tiles (and O) are consumed
    load_rows<T, D, kThreads>(Ks, RS, kb, krow, t0, kB, Skv);
    load_rows<T, D, kThreads>(Vs, RS, vb, krow, t0, kB, Skv);
    __syncthreads();
    float s[4][4], dp[4][4];
    dots<D>(s, Qs, Ks, tx, ty);
    dots<D>(dp, dOs, Vs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qpos = q0 + r + shift;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + tx + 16 * j;
        const bool ok = q0 + r < Sq && t < Skv && (!causal || t <= qpos);
        const float p = ok ? __expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dSs[r * kPS + tx + 16 * j] = p * (dp[i][j] - del_s[r]);
      }
    }
    __syncwarp();  // a row of dS is written and read by the same 16 lanes
    accumulate<D>(acc, dSs, Ks, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    T* row = dq + qoff + (size_t)qi * qrow;
#pragma unroll
    for (int c = 0; c < C; ++c) row[tx + 16 * c] = from_float<T>(acc[i][c] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq,
           int Skv, int H, int K, int causal, float scale) {
  constexpr int RS = D + 1, C = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * RS;
  float* Qs = Vs + kB * RS;
  float* dOs = Qs + kB * RS;
  float* Ps = dOs + kB * RS;  // P^T: rows t, columns i
  float* dSs = Ps + kB * kPS; // dS^T
  float* lse_s = dSs + kB * kPS;
  float* del_s = lse_s + kB;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int t0 = blockIdx.x * kB;  // the first key tiles see the most queries
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int shift = Skv - Sq;
  const size_t qrow = (size_t)H * D, krow = (size_t)K * D;
  const size_t koff = (size_t)b * Skv * krow + (size_t)kh * D;

  load_rows<T, D, kThreads>(Ks, RS, k + koff, krow, t0, kB, Skv);
  load_rows<T, D, kThreads>(Vs, RS, v + koff, krow, t0, kB, Skv);

  float dka[4][C], dva[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dka[i][c] = dva[i][c] = 0.f;

  // queries i see key t when t <= i + shift: the first tile that can
  const int q_first = causal ? max(0, t0 - shift) / kB * kB : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t qoff = (size_t)b * Sq * qrow + (size_t)h * D;
    const size_t hrow = ((size_t)b * H + h) * Sq;
    for (int q0 = q_first; q0 < Sq; q0 += kB) {
      __syncthreads();  // the previous tiles are consumed
      load_rows<T, D, kThreads>(Qs, RS, q + qoff, qrow, q0, kB, Sq);
      load_rows<T, D, kThreads>(dOs, RS, dout + qoff, qrow, q0, kB, Sq);
      if (threadIdx.x < kB) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < Sq ? lse[hrow + qi] : INFINITY;
        del_s[threadIdx.x] = qi < Sq ? delta[hrow + qi] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      dots<D>(s, Ks, Qs, tx, ty);   // rows t, columns i
      dots<D>(dp, Vs, dOs, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, t = t0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, qi = q0 + c;
          const bool ok = t < Skv && qi < Sq && (!causal || t <= qi + shift);
          const float p = ok ? __expf(s[i][j] * scale - lse_s[c]) : 0.f;
          Ps[r * kPS + c] = p;
          dSs[r * kPS + c] = p * (dp[i][j] - del_s[c]);
        }
      }
      __syncwarp();  // rows of P^T and dS^T are written and read by the same 16 lanes
      accumulate<D>(dva, Ps, dOs, tx, ty);
      accumulate<D>(dka, dSs, Qs, tx, ty);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= Skv) continue;
    T* krow_p = dk + koff + (size_t)t * krow;
    T* vrow_p = dv + koff + (size_t)t * krow;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      krow_p[tx + 16 * c] = from_float<T>(dka[i][c] * scale);
      vrow_p[tx + 16 * c] = from_float<T>(dva[i][c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, void* dq, void* dk, void* dv, float* delta, int B, int Sq,
                   int Skv, int H, int K, int causal, float scale, cudaStream_t stream) {
  auto kq = dq_kernel<T, D>;
  auto kkv = dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dq_smem<D>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_smem<D>());
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  kq<<<dim3((Sq + kB - 1) / kB, H, B), kThreads, dq_smem<D>(), stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, lse, static_cast<T*>(dq), delta, Sq, Skv, H, K,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<dim3((Skv + kB - 1) / kB, K, B), kThreads, dkv_smem<D>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, K,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, void* dq, void* dk, void* dv,
                       float* delta, int B, int Sq, int Skv, int H, int K, int causal,
                       float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, Sq, Skv, H, K, causal,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, Sq, Skv, H, K, causal,
                           scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, Sq, Skv, H, K, causal,
                            scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q, o, dout, dq: (B, Sq, H, D); k, v, dk, dv: (B, Skv, K, D), all in `dtype`,
// contiguous and 16-byte aligned, H % K == 0.  lse: the forward's (B, H, Sq)
// float32 logsumexp; delta: (B, H, Sq) float32 scratch.  Launches the dQ
// kernel, then the dK/dV kernel, on `stream`; allocates nothing; returns the
// first cudaError_t (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* dq, void* dk,
                                   void* dv, void* delta, int B, int Sq, int Skv, int H, int K,
                                   int D, int causal, float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || K <= 0 || H % K != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (dtype) {
    case kFloat32:
      return dispatch_d<float>(D, q, k, v, o, dout, l, dq, dk, dv, dl, B, Sq, Skv, H, K, causal,
                               scale, s);
    case kBFloat16:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, o, dout, l, dq, dk, dv, dl, B, Sq, Skv, H, K,
                                       causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
