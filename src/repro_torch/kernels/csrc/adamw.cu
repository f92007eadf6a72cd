// AdamW over one leaf of the params' tree, for Hopper, sm_90a: the global
// clip norm's sum of squares, and the update of a leaf in one pass.
//
// Replaces no TPU kernel: the reference's AdamW is plain jnp
// (`repro.training.optimizer`), which XLA fuses.  In plain torch the same
// update is about 20 elementwise passes a leaf, each writing an f32
// temporary to HBM and reading it back.  Per element, with the clip scale s,
// the schedule's lr and the bias corrections c1 = 1 - b1^t, c2 = 1 - b2^t:
//   g' = g s
//   m  = b1 m + (1 - b1) g'
//   v  = b2 v + ((1 - b2) g') g'
//   u  = (m / c1) / (sqrt(v / c2) + eps) + wd p
//   p  = p - lr u
// m and v are f32; p and g are each f32 or bf16, and p is written back in
// its own dtype with round-to-nearest-even.  Every operation is the IEEE
// f32 one that torch's elementwise kernels make, in the same order and
// never contracted into an FMA (the __f*_rn intrinsics), so a leaf's update
// is bit for bit the plain version's given the same four scalars.
//
// What bounds it on the H100: memory.  About 15 operations an element for
// 2 esize(g) + 2 esize(p) + 16 bytes moved (g read twice: once for the
// norm, once for the update), far below the card's ridge.
//
// What the design does about it:
//   * the update reads g, p, m and v once and writes p, m and v once: a
//     thread owns 8 consecutive elements (one 16-byte load of bf16, two of
//     f32) and walks the leaf in a grid-stride loop over 64-bit offsets (a
//     stacked expert weight is 1.07e9 elements, 4.3 GB of each moment), the
//     grid one wave of resident CTAs; leaves whose pointers are not all
//     16-byte aligned take the same loop an element at a time;
//   * the sum of squares reads g once in its own dtype and accumulates in
//     f64: each thread over its elements, the CTA in a fixed tree, one f64
//     partial a CTA; the CTAs of a leaf are a function of its size alone,
//     and `adamw_norm_finish` sums every leaf's partials in a fixed order.
//     No atomics: a step repeats bit for bit.  A mesh job's leaves run on
//     each rank's shards: `adamw_sum_parts` sums the partials of the leaves
//     split over one set of mesh dims, the caller all-reduces that f64 over
//     those dims, and `adamw_norm_finish` sums the groups' totals;
//   * s, lr, c1 and c2 are read from device memory (the norm's result, and
//     scalars made on the device from the step counter): the host neither
//     waits for the backward nor copies a scalar.
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;              // elements a thread owns on the aligned path
constexpr int kNormMaxParts = 1024;  // CTAs (f64 partials) of a leaf's sum of squares
constexpr int kFinishThreads = 1024;

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;  // omb = 1 - b, rounded from double as torch does
};

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <int N>
__device__ __forceinline__ void store_vec(float* __restrict__ p, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* __restrict__ p, const float* v) {
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                              pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// Sum of a CTA's values in a fixed order: each warp by xor butterflies,
// then the warps' sums in warp order by thread 0.
template <int kN>
__device__ __forceinline__ double cta_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __shared__ double warp_sum[kN / 32];
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kN / 32; ++w) s += warp_sum[w];
  }
  return s;
}

template <typename G, int V>
__global__ void __launch_bounds__(kThreads)
adamw_sumsq_kernel(const G* __restrict__ g, int64_t n, double* __restrict__ part) {
  double acc = 0.0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t nv = n / V;
  for (int64_t i = first; i < nv; i += stride) {
    float x[V];
    load_vec<V>(g + i * V, x);
#pragma unroll
    for (int j = 0; j < V; ++j) acc = fma((double)x[j], (double)x[j], acc);
  }
  for (int64_t i = nv * V + first; i < n; i += stride) {
    const double x = to_float(g[i]);
    acc = fma(x, x, acc);
  }
  const double s = cta_sum<kThreads>(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// One CTA: thread t sums partials t, t + 1024, ... in order, then a fixed
// tree; the total at thread 0.
__device__ __forceinline__ double fixed_order_sum(const double* __restrict__ part, int parts) {
  __shared__ double s[kFinishThreads];
  double acc = 0.0;
  for (int i = threadIdx.x; i < parts; i += kFinishThreads) acc += part[i];
  s[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int w = kFinishThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  return s[0];
}

// out[0] = the global norm, out[1] = the clip scale min(clip / (norm +
// 1e-9), 1) in f32 as torch computes `clip / t` (the reciprocal of t, then
// times clip; NaN stays NaN).
__global__ void __launch_bounds__(kFinishThreads)
adamw_norm_finish_kernel(const double* __restrict__ part, int parts, float clip,
                         float* __restrict__ out) {
  const double total = fixed_order_sum(part, parts);
  if (threadIdx.x == 0) {
    const float norm = (float)sqrt(total);
    const float scale = __fmul_rn(__frcp_rn(__fadd_rn(norm, 1e-9f)), clip);
    out[0] = norm;
    out[1] = scale > 1.f ? 1.f : scale;
  }
}

__global__ void __launch_bounds__(kFinishThreads)
adamw_sum_parts_kernel(const double* __restrict__ part, int parts, double* __restrict__ out) {
  const double total = fixed_order_sum(part, parts);
  if (threadIdx.x == 0) *out = total;
}

template <int V, typename P, typename G>
__device__ __forceinline__ void update_elems(const G* __restrict__ g, P* __restrict__ p,
                                             float* __restrict__ m, float* __restrict__ v,
                                             const Hyper& h, float scale, float lr, float c1,
                                             float c2) {
  float gf[V], pf[V], mf[V], vf[V];
  load_vec<V>(g, gf);
  load_vec<V>(p, pf);
  load_vec<V>(m, mf);
  load_vec<V>(v, vf);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float gs = __fmul_rn(gf[j], scale);
    mf[j] = __fadd_rn(__fmul_rn(mf[j], h.b1), __fmul_rn(h.omb1, gs));
    vf[j] = __fadd_rn(__fmul_rn(vf[j], h.b2), __fmul_rn(__fmul_rn(h.omb2, gs), gs));
    float u = __fdiv_rn(__fdiv_rn(mf[j], c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(vf[j], c2)), h.eps));
    u = __fadd_rn(u, __fmul_rn(h.wd, pf[j]));
    pf[j] = __fsub_rn(pf[j], __fmul_rn(lr, u));
  }
  store_vec<V>(m, mf);
  store_vec<V>(v, vf);
  store_vec<V>(p, pf);
}

template <typename P, typename G, int V>
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const G* __restrict__ g, P* __restrict__ p, float* __restrict__ m,
                    float* __restrict__ v, int64_t n, Hyper h, const float* __restrict__ scale_p,
                    const float* __restrict__ lr_p, const float* __restrict__ c1_p,
                    const float* __restrict__ c2_p) {
  const float scale = *scale_p, lr = *lr_p, c1 = *c1_p, c2 = *c2_p;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t nv = n / V;
  for (int64_t i = first; i < nv; i += stride) {
    const int64_t o = i * V;
    update_elems<V>(g + o, p + o, m + o, v + o, h, scale, lr, c1, c2);
  }
  for (int64_t i = nv * V + first; i < n; i += stride)
    update_elems<1>(g + i, p + i, m + i, v + i, h, scale, lr, c1, c2);
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename G>
int launch_sumsq(const void* g, int64_t n, bool vec, void* part, int parts, cudaStream_t st) {
  const G* gp = static_cast<const G*>(g);
  double* out = static_cast<double*>(part);
  if (vec) adamw_sumsq_kernel<G, kVec><<<parts, kThreads, 0, st>>>(gp, n, out);
  else adamw_sumsq_kernel<G, 1><<<parts, kThreads, 0, st>>>(gp, n, out);
  return cudaGetLastError();
}

// One wave of the kernel's resident CTAs on the current device, at most one
// vector a thread; 0 if the device cannot be queried.
template <typename Kernel>
int wave_blocks(Kernel kernel, int64_t work) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess)
    return 0;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t need = cdiv(work > 0 ? work : 1, kThreads);
  return (int)(need < resident ? need : resident);
}

template <typename P, typename G>
int launch_update(const void* g, void* p, void* m, void* v, int64_t n, bool vec, const Hyper& h,
                  const void* scale, const void* lr, const void* c1, const void* c2,
                  cudaStream_t st) {
  const auto args = [&](auto kernel, int64_t work) {
    const int blocks = wave_blocks(kernel, work);
    if (blocks == 0) return (int)cudaErrorInvalidValue;
    kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const G*>(g), static_cast<P*>(p), static_cast<float*>(m),
        static_cast<float*>(v), n, h, static_cast<const float*>(scale),
        static_cast<const float*>(lr), static_cast<const float*>(c1),
        static_cast<const float*>(c2));
    return (int)cudaGetLastError();
  };
  return vec ? args(adamw_update_kernel<P, G, kVec>, n / kVec)
             : args(adamw_update_kernel<P, G, 1>, n);
}

}  // namespace
}  // namespace repro_torch

// The f64 sum of squares of one gradient leaf g (n elements of `gdtype`)
// into `parts` partials, parts = min(ceil(n / 2048), 1024): a function of
// n alone.  vec: g is 16-byte aligned (8 elements a thread).
extern "C" int adamw_sumsq(const void* g, int64_t n, int gdtype, int vec, void* part,
                           int parts, void* stream) {
  using namespace repro_torch;
  const int64_t want = cdiv(n, (int64_t)kThreads * kVec);
  if (n <= 0 || parts != (want < kNormMaxParts ? want : kNormMaxParts))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (gdtype) {
    case kFloat32: return launch_sumsq<float>(g, n, vec != 0, part, parts, st);
    case kBFloat16: return launch_sumsq<__nv_bfloat16>(g, n, vec != 0, part, parts, st);
    default: return cudaErrorInvalidValue;
  }
}

// The global norm from every leaf's partials (`parts` f64 values, summed in
// a fixed order) and the clip scale: out[0] = norm, out[1] = scale (f32).
extern "C" int adamw_norm_finish(const void* part, int parts, float clip, void* out,
                                 void* stream) {
  using namespace repro_torch;
  if (parts <= 0) return cudaErrorInvalidValue;
  adamw_norm_finish_kernel<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(part), parts, clip, static_cast<float*>(out));
  return cudaGetLastError();
}

// The f64 sum of `parts` partials (0 or more) in the fixed order of
// `adamw_norm_finish`, into out[0]: one group of a mesh job's leaves, whose
// total the caller adds across the ranks holding the group's shards before
// `adamw_norm_finish` sums the groups' totals.
extern "C" int adamw_sum_parts(const void* part, int parts, void* out, void* stream) {
  using namespace repro_torch;
  if (parts < 0) return cudaErrorInvalidValue;
  adamw_sum_parts_kernel<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(part), parts, static_cast<double*>(out));
  return cudaGetLastError();
}

// The AdamW update of one leaf in place: p (`pdtype`) and f32 m, v read and
// written, g (`gdtype`) read, n elements; b1, b2 with 1 - b1 and 1 - b2
// (each rounded from double), eps and wd as f32; scale, lr, c1 and c2 each
// an f32 scalar in device memory.  vec: all four pointers 16-byte aligned.
extern "C" int adamw_update(const void* g, void* p, void* m, void* v, int64_t n, int pdtype,
                            int gdtype, int vec, float b1, float omb1, float b2, float omb2,
                            float eps, float wd, const void* scale, const void* lr,
                            const void* c1, const void* c2, void* stream) {
  using namespace repro_torch;
  if (n <= 0) return cudaErrorInvalidValue;
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vc = vec != 0;
  if (pdtype == kBFloat16 && gdtype == kBFloat16)
    return launch_update<__nv_bfloat16, __nv_bfloat16>(g, p, m, v, n, vc, h, scale, lr, c1, c2, st);
  if (pdtype == kBFloat16 && gdtype == kFloat32)
    return launch_update<__nv_bfloat16, float>(g, p, m, v, n, vc, h, scale, lr, c1, c2, st);
  if (pdtype == kFloat32 && gdtype == kBFloat16)
    return launch_update<float, __nv_bfloat16>(g, p, m, v, n, vc, h, scale, lr, c1, c2, st);
  if (pdtype == kFloat32 && gdtype == kFloat32)
    return launch_update<float, float>(g, p, m, v, n, vc, h, scale, lr, c1, c2, st);
  return cudaErrorInvalidValue;
}
