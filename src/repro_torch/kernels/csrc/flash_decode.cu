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
// 2 FLOP per byte in bf16, against a 295 FLOP/byte ridge, so the tensor
// cores cannot lower the bound.  The least time is the valid prefix of K
// and V, B * vlen * K * (D + Dv) elements, streamed once at 3.35 TB/s.
//
// What the design does about it (split-KV):
//   * the valid prefix is cut into `splits` runs of `rows` positions, and
//     one CTA serves one (run, kv head, batch, group of up to 8 query
//     heads): at the serve shape (B = 8, K = 8) that is 64 CTAs a run, and
//     the wrapper picks the run count so that the grid covers the 132 SMs at
//     least twice (at vlen = 1 one run remains).  Each K/V row is still read
//     once per GQA group (groups wider than 8 heads, e.g. MQA with 32 heads,
//     take several CTAs);
//   * a CTA streams its run through a ring of shared-memory stages of 32
//     rows, up to 3 stages in flight (48 KB a CTA in bf16 at D = 128): one
//     warp issues a bulk copy (cp.async.bulk) per K and per V row, and an
//     mbarrier per stage counts the bytes in;
//   * each warp takes 4 rows of a stage: a lane holds D/32 contiguous
//     elements of a row; the warp's (head, row) scores are summed by a
//     reduce-scatter of shuffles that leaves one score a lane, so each exp
//     is taken once; the softmax runs in f32 with the scale applied in f32;
//   * the warps' (m, l, acc) merge through shared memory; with one run the
//     CTA writes the output, else it writes f32 partial (m, l, acc) rows,
//     and the last CTA of its (kv head, batch, head group) to finish -- a
//     device counter per group, reset by that CTA -- merges the runs in run
//     order, so the result does not depend on which CTA came last, and no
//     second kernel is launched.
// What holds it back now, measured: not the bytes in flight (16-byte
// cp.async and bulk copies ran alike) but instruction issue on the SIMT
// pipe (per 4 rows and head: the dot-product partials, the reduction, the
// online softmax and the rescale) and each CTA's fixed work (barriers, the
// merge); QK^T and PV on mma.sync would cut the instructions a row.
#include "common.cuh"
#include "sm90.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGMax = 8;   // query heads per CTA, at most
constexpr int kRows = 4;   // cache rows per warp in a stage
constexpr int kT = kWarps * kRows;  // rows per stage

template <typename T, int D, int DV>
struct Ring {
  static constexpr int kStageBytes = kT * (D + DV) * (int)sizeof(T);
  static constexpr int kStages = 65536 / kStageBytes < 2   ? 2
                                 : 65536 / kStageBytes > 4 ? 4
                                                           : 65536 / kStageBytes;
  static constexpr int kMergeBytes = kWarps * kGMax * (DV + 2) * (int)sizeof(float);  // any GM
  static constexpr int kBytes =
      kStages * kStageBytes > kMergeBytes ? kStages * kStageBytes : kMergeBytes;
  // the runs' merge weights, 2 GM splits floats, fit in it
  static constexpr int kMaxSplits = kBytes / (2 * kGMax * (int)sizeof(float));
};

// Issue the bulk copies of rows [t0, min(t0 + kT, end)) of one kv head
// into a stage (K rows, then V rows), completing on `bar`.  Called by one
// warp; rows past `end` are not copied (their shared memory is stale, and
// the compute masks it).
template <typename T, int D, int DV>
__device__ __forceinline__ void issue_stage(T* __restrict__ dst, const T* __restrict__ kb,
                                            const T* __restrict__ vb, size_t row, size_t vrow,
                                            int t0, int end, uint64_t* bar) {
  const int lane = threadIdx.x % 32, n = min(kT, end - t0);
  if (lane == 0) sm90::mbar_arrive_expect_tx(bar, n * (D + DV) * (int)sizeof(T));
  __syncwarp();
  if (lane < n) {
    sm90::bulk_load(dst + lane * D, kb + (size_t)(t0 + lane) * row, D * sizeof(T), bar);
    sm90::bulk_load(dst + kT * D + lane * DV, vb + (size_t)(t0 + lane) * vrow, DV * sizeof(T),
                    bar);
  }
}

// GM: head slots per CTA (1, 4 or 8), a compile-time count so that every
// slot's reductions interleave; slots past the group's heads compute on a
// zero query and are not written.  Up to 4 slots, 3 CTAs fit an SM.
template <typename T, int D, int DV, int GM>
__global__ void __launch_bounds__(kThreads, GM <= 4 ? 3 : 2)
split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, float* __restrict__ part, unsigned* __restrict__ counters,
             int S, int H, int K, int vlen, int rows, float scale) {
  using R = Ring<T, D, DV>;
  constexpr int EK = D / 32, EV = DV / 32;  // elements per lane
  constexpr int kStageElems = R::kStageBytes / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t full[R::kStages];  // a stage's bytes have landed
  T* ring = reinterpret_cast<T*>(smem);

  const int split = blockIdx.x, b = blockIdx.z;
  const int G = H / K, n_hg = (G + GM - 1) / GM;
  const int kh = blockIdx.y / n_hg, hg = blockIdx.y % n_hg;
  const int h0 = kh * G + hg * GM;  // first query head of this CTA
  const int ng = min(GM, G - hg * GM);
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int begin = split * rows, end = min(vlen, begin + rows);
  const int n_st = end > begin ? (end - begin + kT - 1) / kT : 0;

  const size_t row = (size_t)K * D, vrow = (size_t)K * DV;
  const T* kb = k + ((size_t)b * S * K + kh) * D;
  const T* vb = v + ((size_t)b * S * K + kh) * DV;
  if (threadIdx.x == 0) {
    for (int i = 0; i < R::kStages; ++i) sm90::mbar_init(&full[i], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  // Prologue: the first kStages - 1 stages in flight.
  if (w == 0)
    for (int i = 0; i < R::kStages - 1 && i < n_st; ++i)
      issue_stage<T, D, DV>(ring + i * kStageElems, kb, vb, row, vrow, begin + i * kT, end,
                            &full[i]);

  float qr[GM][EK];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < ng) {
      load_vec<EK>(q + ((size_t)b * H + h0 + g) * D + lane * EK, qr[g]);
#pragma unroll
      for (int e = 0; e < EK; ++e) qr[g][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < EK; ++e) qr[g][e] = 0.f;
    }
  }
  float m[GM], l[GM], acc[GM][EV];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EV; ++e) acc[g][e] = 0.f;
  }

  for (int st = 0; st < n_st; ++st) {
    const int nxt = st + R::kStages - 1;  // refills the slot that stage st - 1 used
    if (w == 0 && nxt < n_st)
      issue_stage<T, D, DV>(ring + (nxt % R::kStages) * kStageElems, kb, vb, row, vrow,
                            begin + nxt * kT, end, &full[nxt % R::kStages]);
    sm90::mbar_wait(&full[st % R::kStages], (st / R::kStages) & 1);
    const T* ks = ring + (st % R::kStages) * kStageElems;
    const T* vs = ks + kT * D;
    const int t0 = begin + st * kT + w * kRows;  // this warp's first row
    float kr[kRows][EK], vr[kRows][EV];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      load_vec<EK>(ks + (w * kRows + u) * D + lane * EK, kr[u]);
      load_vec<EV>(vs + (w * kRows + u) * DV + lane * EV, vr[u]);
      if (t0 + u >= end) {  // not copied: stale bytes, possibly not finite
#pragma unroll
        for (int e = 0; e < EK; ++e) kr[u][e] = 0.f;
#pragma unroll
        for (int e = 0; e < EV; ++e) vr[u][e] = 0.f;
      }
    }
    if (t0 < end) {  // warp-uniform
      // Partial dot products over this lane's elements, v = g kRows + u.
      constexpr int NV = GM * kRows, LV = NV == 4 ? 2 : NV == 16 ? 4 : 5;  // log2 NV
      constexpr int SH = 5 - LV;  // lane bit of v's lowest bit
      float sv[NV];
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < EK; ++e) x = fmaf(qr[g][e], kr[u][e], x);
          sv[g * kRows + u] = x;
        }
      // Reduce-scatter over the warp: at each level a lane keeps half of its
      // sums and adds its partner's half, so after LV levels lane L holds
      // sum v = L >> SH (NV - 1 shuffles instead of 5 NV), then the rest of
      // the warp is reduced on that one value.
#pragma unroll
      for (int lvl = 0; lvl < LV; ++lvl) {
        const int off = 16 >> lvl, half = NV >> (lvl + 1);
        const bool up = lane & off;
#pragma unroll
        for (int i = 0; i < half; ++i) {
          const float send = up ? sv[i] : sv[i + half];
          const float keep = up ? sv[i + half] : sv[i];
          sv[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
#pragma unroll
      for (int off = 16 >> LV; off > 0; off >>= 1)
        sv[0] += __shfl_xor_sync(0xffffffffu, sv[0], off);
      // The online softmax of head slot gv on row uv, one (gv, uv) a lane:
      // max and sum over the kRows rows are over lane bits SH and SH + 1.
      const int v = lane >> SH, gv = v / kRows, uv = v % kRows;
      const bool valid = t0 + uv < end;
      float mo = m[0];
#pragma unroll
      for (int g = 1; g < GM; ++g)
        if (gv == g) mo = m[g];
      float mx = valid ? sv[0] : -INFINITY;
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1 << SH));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2 << SH));
      const float m_new = fmaxf(mo, mx);  // finite: row t0 < end is valid
      const float p = valid ? __expf(sv[0] - m_new) : 0.f;
      float ps = p + __shfl_xor_sync(0xffffffffu, p, 1 << SH);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2 << SH);
      const float alpha = __expf(mo - m_new);
      // every lane takes each head's new state and row weights from the
      // lanes that hold them, and updates its columns of acc
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const int src = (g * kRows) << SH;
        const float al = __shfl_sync(0xffffffffu, alpha, src);
        l[g] = fmaf(l[g], al, __shfl_sync(0xffffffffu, ps, src));
        m[g] = __shfl_sync(0xffffffffu, m_new, src);
        float pu[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) pu[u] = __shfl_sync(0xffffffffu, p, src + (u << SH));
#pragma unroll
        for (int e = 0; e < EV; ++e) {
          float a = acc[g][e] * al;
#pragma unroll
          for (int u = 0; u < kRows; ++u) a = fmaf(pu[u], vr[u][e], a);
          acc[g][e] = a;
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // Merge the warps' partial softmaxes (the ring's memory is free now).
  float* sm_acc = reinterpret_cast<float*>(smem);            // [kWarps][kGMax][DV]
  float* sm_m = sm_acc + kWarps * kGMax * DV;                // [kWarps][kGMax]
  float* sm_l = sm_m + kWarps * kGMax;                       // [kWarps][kGMax]
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (lane == 0) {
      sm_m[w * kGMax + g] = m[g];
      sm_l[w * kGMax + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EV; ++e) sm_acc[(w * kGMax + g) * DV + lane * EV + e] = acc[g][e];
  }
  __syncthreads();
  const int BH = gridDim.z * H;
  for (int idx = threadIdx.x; idx < ng * DV; idx += kThreads) {
    const int g = idx / DV, d = idx % DV;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) mx = fmaxf(mx, sm_m[i * kGMax + g]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {  // the run has a valid row
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        const float c = __expf(sm_m[i * kGMax + g] - mx);
        num = fmaf(c, sm_acc[(i * kGMax + g) * DV + d], num);
        den = fmaf(c, sm_l[i * kGMax + g], den);
      }
    }
    const size_t bh = (size_t)b * H + h0 + g;
    if (part == nullptr) {
      o[bh * DV + d] = from_float<T>(num / fmaxf(den, 1e-30f));
    } else {  // partial rows: acc (splits, B H, DV), then (m, l) (splits, B H, 2)
      part[((size_t)split * BH + bh) * DV + d] = num;
      if (d == 0) {
        float* ml = part + (size_t)gridDim.x * BH * DV + ((size_t)split * BH + bh) * 2;
        ml[0] = mx;
        ml[1] = den;
      }
    }
  }
  if (part == nullptr) return;

  // The last CTA of the group to get here merges every run's rows.
  __shared__ bool last;
  __threadfence();  // this CTA's partial rows are visible before it counts itself
  __syncthreads();
  unsigned* cnt = counters + (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0) last = atomicAdd(cnt, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every run's (m, l) of the CTA's heads into shared memory at once, as
  // weights exp(m_s - max m) (the merge area is free again), then the
  // acc rows, several runs' loads in flight
  const int splits = gridDim.x;
  const float* ml = part + (size_t)splits * BH * DV;
  float* wt = reinterpret_cast<float*>(smem);  // [GM][splits]: weights, then l
  float* ls = wt + GM * splits;
  for (int i = threadIdx.x; i < ng * splits; i += kThreads) {
    const int g = i / splits, sp = i % splits;
    const float2 v = __ldcg(reinterpret_cast<const float2*>(ml) +
                            (size_t)sp * BH + (size_t)b * H + h0 + g);
    wt[i] = v.x;
    ls[i] = v.y;
  }
  __syncthreads();
  if (threadIdx.x < ng) {
    float* wg = wt + threadIdx.x * splits;
    const float* lg = ls + threadIdx.x * splits;
    float mx = -INFINITY;
    for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, wg[sp]);
    float den = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      wg[sp] = mx == -INFINITY ? 0.f : __expf(wg[sp] - mx);
      den = fmaf(wg[sp], lg[sp], den);
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    for (int sp = 0; sp < splits; ++sp) wg[sp] *= inv;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ng * DV; idx += kThreads) {
    const int g = idx / DV, d = idx % DV;
    const size_t bh = (size_t)b * H + h0 + g;
    float num = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp)
      num = fmaf(wt[g * splits + sp], __ldcg(part + ((size_t)sp * BH + bh) * DV + d), num);
    o[bh * DV + d] = from_float<T>(num);
  }
  if (threadIdx.x == 0) *cnt = 0;  // ready for the next call on this stream
}

struct Args {  // one launch's arguments, as flash_decode_fwd takes them
  const void *q, *k, *v;
  void *o, *part, *counters;
  int B, S, H, K, vlen, splits, rows;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int DV, int GM>
cudaError_t launch_gm(const Args& a) {
  using R = Ring<T, D, DV>;
  if (a.splits > R::kMaxSplits) return cudaErrorInvalidValue;
  auto kern = split_kernel<T, D, DV, GM>;
  // once per instance and process (the port drives one card)
  static cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(a.splits, a.K * ((a.H / a.K + GM - 1) / GM), a.B);
  kern<<<grid, kThreads, R::kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.splits > 1 ? static_cast<float*>(a.part) : nullptr,
      static_cast<unsigned*>(a.counters), a.S, a.H, a.K, a.vlen, a.rows, a.scale);
  return cudaGetLastError();
}

// Head slots per CTA: 1 for MHA, 4 for groups of 2 to 4 (llama3-8b's G = 4),
// else 8.
template <typename T, int D, int DV>
cudaError_t launch(const Args& a) {
  const int G = a.H / a.K;
  if (G == 1) return launch_gm<T, D, DV, 1>(a);
  if (G <= 4) return launch_gm<T, D, DV, 4>(a);
  return launch_gm<T, D, DV, 8>(a);
}

template <typename T, int D>
cudaError_t dispatch_dv(int Dv, const Args& a) {
  switch (Dv) {
    case 32: return launch<T, D, 32>(a);
    case 64: return launch<T, D, 64>(a);
    case 128: return launch<T, D, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(int D, int Dv, const Args& a) {
  switch (D) {
    case 32: return dispatch_dv<T, 32>(Dv, a);
    case 64: return dispatch_dv<T, 64>(Dv, a);
    case 128: return dispatch_dv<T, 128>(Dv, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q: (B, 1, H, D), k: (B, S, K, D), v: (B, S, K, Dv), o: (B, 1, H, Dv), all
// contiguous and 16-byte aligned, H % K == 0.  Positions >= vlen are masked
// (vlen is clamped to S).  The valid prefix is cut into `splits` runs of
// `rows` positions (rows a multiple of 32, splits * rows >= vlen); with
// splits > 1, `part` is f32 scratch of splits * B * H * (Dv + 2) floats and
// `counters` B * H unsigned ints that are 0 (the kernel leaves them 0; one
// buffer per stream, since two launches in flight must not share it).
// Launches on `stream`, allocates nothing, and returns the cudaError_t of
// the launch (0 on success).
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v, void* o,
                                void* part, void* counters, int B, int S, int H, int K, int D,
                                int Dv, int vlen, int splits, int rows, float scale, int dtype,
                                void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S < 0 || H <= 0 || K <= 0 || H % K != 0 || splits <= 0 || rows <= 0 ||
      rows % kT != 0 || (splits > 1 && (part == nullptr || counters == nullptr)) ||
      B > 65535 || H > 65535)  // grid: (splits, <= H, B)
    return cudaErrorInvalidValue;
  vlen = vlen < 0 ? 0 : (vlen > S ? S : vlen);
  if ((long long)splits * rows < vlen) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, part, counters, B, S, H, K, vlen, splits, rows, scale,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kFloat32: return dispatch_d<float>(D, Dv, a);
    case kBFloat16: return dispatch_d<__nv_bfloat16>(D, Dv, a);
    default: return cudaErrorInvalidValue;
  }
}
