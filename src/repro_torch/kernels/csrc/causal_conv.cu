// Causal depthwise conv along time, then SiLU: forward and backward, for
// Hopper, sm_90a, in float32 and bfloat16.
//
// Replaces no TPU kernel.  The reference writes the conv in jnp
// (`repro.models.ssm._causal_conv`: W shifted multiplies and adds, then
// jax.nn.silu) and leaves it to XLA to fuse.  In plain torch the same chain
// is a zero pad, W strided multiplies, W adds, a bias add and a SiLU, each a
// pass over the (B, S, C) activations, and its autograd backward twice as
// many.  Per batch row b, time t and channel c, with zero history before
// t = 0 in every batch row:
//   pre[b, t, c] = bias[c] + sum_{i < W} w[i, c] x[b, t - (W - 1) + i, c]
//   y[b, t, c]   = silu(pre) = pre / (1 + exp(-pre))
// and for an upstream gradient dy, with g = dy silu'(pre):
//   dx[b, u, c] = sum_{i < W} w[i, c] g[b, u + (W - 1) - i, c]   (g = 0 past S)
//   dw[i, c]    = sum_{b, t} g[b, t, c] x[b, t - (W - 1) + i, c]
//   dbias[c]    = sum_{b, t} g[b, t, c]
//
// What bounds it on the H100: memory.  About 2 W + 10 operations an element
// for 2 elements moved forward (x read, y written) and some 4 W + 20 for 3
// backward (x and dy read, dx written): far below the card's ridge.
//
// What the design does about it:
//   * a thread owns consecutive channels (8 forward: one 16-byte load of
//     bf16; 4 backward, to keep its sums in registers with 4 CTAs a
//     multiprocessor) and walks a segment of consecutive times of one batch
//     row (8 forward: the most CTAs, so the last wave is short; backward 32
//     where the channels give the card enough threads, so the recomputed
//     rows after a segment are a tenth, 8 where they are few), its taps and
//     bias in registers and the last 3 inputs in a register window, so each
//     element is loaded once from HBM and written once; the 3 halo rows
//     before a segment (and, backward, after it) are loaded again by the
//     neighbouring segment's thread, from L1 or L2;
//   * a segment never leaves its batch row: times before 0 read as zero and
//     times past S are never used, so no row of another batch element is
//     read;
//   * every row index is clamped into the batch row, so the unrolled walk is
//     one basic block and the loads of later rows issue ahead of the
//     arithmetic of earlier ones;
//   * always 4 taps: a conv of W < 4 runs with its first 4 - W taps zero
//     (0 x adds an exact 0), one kernel per dtype and segment length;
//   * arithmetic in f32, the SiLU's exp and reciprocal in the fast
//     approximations (a few ulp: far below bf16's rounding, within the f32
//     tolerance), since at bf16 the exact ones cost more issue slots than the
//     bytes leave; the forward writes silu(pre) alone (no pre-activation is
//     stored), the backward recomputes pre;
//   * dw and dbias: each thread sums its segment's terms in registers, the
//     CTA sums its threads in shared memory in a fixed order into one row of
//     f32 partials, and a second kernel sums the rows in a fixed order and
//     writes dw and dbias in the weights' dtype.  No atomics: a backward
//     repeats bit for bit.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kW = 4;           // taps computed; the first 4 - W are zero
constexpr int kTx = 16;         // threads of a CTA across channels
constexpr int kTy = 8;          // ... across segments
constexpr int kThreads = kTx * kTy;
constexpr int kFwdVec = 8;      // channels a forward thread owns
constexpr int kBwdVec = 4;      // ... a backward thread
constexpr int kFwdRows = 8;     // times a forward segment walks

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <int N>
__device__ __forceinline__ void store_vec(float* __restrict__ p, const float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* __restrict__ p, const float* v) {
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                              pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  } else {
    static_assert(N == 4, "4 or 8 channels a thread");
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
}

// Row t of a batch row (rows C elements apart) at the thread's channels,
// t clamped into [0, S): the caller discards or zeroes what lies outside.
template <int N, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ row0, int t, int S, int C,
                                         float* out) {
  load_vec<N>(row0 + (size_t)min(max(t, 0), S - 1) * C, out);
}

template <int N>
__device__ __forceinline__ void zero_unless(bool keep, float* v) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = keep ? v[i] : 0.f;
}

// wr[j] = w[j - (kW - W)] at the thread's channels, 0 for j < kW - W.
template <int N, typename T>
__device__ __forceinline__ void load_taps(const T* __restrict__ w, const T* __restrict__ bias,
                                          int W, int C, int c0, float (&wr)[kW][N],
                                          float (&br)[N]) {
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    if (j >= kW - W) {
      load_vec<N>(w + (size_t)(j - (kW - W)) * C + c0, wr[j]);
    } else {
#pragma unroll
      for (int v = 0; v < N; ++v) wr[j][v] = 0.f;
    }
  }
  load_vec<N>(bias + c0, br);
}

__device__ __forceinline__ float sigmoid(float p) { return __fdividef(1.f, 1.f + __expf(-p)); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
causal_conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ bias, T* __restrict__ y, int S, int C, int W,
                       int segs_per_row, int n_seg) {
  constexpr int N = kFwdVec, kRows = kFwdRows;
  const int c0 = (blockIdx.x * kTx + threadIdx.x) * N;
  if (c0 >= C) return;
  float wr[kW][N], br[N];
  load_taps<N>(w, bias, W, C, c0, wr, br);
  for (int seg = blockIdx.y * kTy + threadIdx.y; seg < n_seg; seg += gridDim.y * kTy) {
    const int b = seg / segs_per_row;
    const int t0 = (seg - b * segs_per_row) * kRows;
    const T* xb = x + (size_t)b * S * C + c0;
    T* yb = y + (size_t)b * S * C + c0;
    float win[kW][N];  // x at t - 3 .. t, the newest last
#pragma unroll
    for (int i = 0; i < kW - 1; ++i) {
      load_row<N>(xb, t0 - (kW - 1) + i, S, C, win[i]);
      zero_unless<N>(t0 - (kW - 1) + i >= 0, win[i]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = t0 + r;
      load_row<N>(xb, t, S, C, win[kW - 1]);  // past S: computed, never stored
      float out[N];
#pragma unroll
      for (int v = 0; v < N; ++v) {
        float p = br[v];
#pragma unroll
        for (int j = 0; j < kW; ++j) p = fmaf(wr[j][v], win[j][v], p);
        out[v] = p * sigmoid(p);
      }
      if (t < S) store_vec<N>(yb + (size_t)t * C, out);
#pragma unroll
      for (int j = 0; j + 1 < kW; ++j)
#pragma unroll
        for (int v = 0; v < N; ++v) win[j][v] = win[j + 1][v];
    }
  }
}

template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads, 4)
causal_conv_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ bias, const T* __restrict__ dy,
                       T* __restrict__ dx, float* __restrict__ part, int S, int C, int W,
                       int segs_per_row, int n_seg) {
  constexpr int N = kBwdVec;
  __shared__ float red[kThreads][(kW + 1) * N + 1];  // +1: no bank conflicts
  const int c0 = (blockIdx.x * kTx + threadIdx.x) * N;
  const bool live = c0 < C;
  float acc[kW + 1][N];  // dw's 4 tap rows, then dbias
#pragma unroll
  for (int j = 0; j <= kW; ++j)
#pragma unroll
    for (int v = 0; v < N; ++v) acc[j][v] = 0.f;
  if (live) {
    float wr[kW][N], br[N];
    load_taps<N>(w, bias, W, C, c0, wr, br);
    for (int seg = blockIdx.y * kTy + threadIdx.y; seg < n_seg; seg += gridDim.y * kTy) {
      const int b = seg / segs_per_row;
      const int t0 = (seg - b * segs_per_row) * kRows;
      const size_t off = (size_t)b * S * C + c0;
      const T* xb = x + off;
      const T* dyb = dy + off;
      T* dxb = dx + off;
      float xw[kW][N];  // x at t - 3 .. t, the newest last
      float gw[kW][N];  // g at t - 3 .. t
#pragma unroll
      for (int i = 0; i < kW - 1; ++i) {
        load_row<N>(xb, t0 - (kW - 1) + i, S, C, xw[i]);
        zero_unless<N>(t0 - (kW - 1) + i >= 0, xw[i]);
      }
      // walk t over the segment and the 3 times after it: dx at u = t - 3
      // needs g at u .. u + 3
#pragma unroll
      for (int r = 0; r < kRows + kW - 1; ++r) {
        const int t = t0 + r;
        float d[N];
        load_row<N>(xb, t, S, C, xw[kW - 1]);  // past S: row S - 1's, finite
        load_row<N>(dyb, t, S, C, d);
        zero_unless<N>(t < S, d);  // so g is 0 past S
#pragma unroll
        for (int v = 0; v < N; ++v) {
          float p = br[v];
#pragma unroll
          for (int j = 0; j < kW; ++j) p = fmaf(wr[j][v], xw[j][v], p);
          const float s = sigmoid(p);
          const float g = d[v] * (s * fmaf(p, 1.f - s, 1.f));
          gw[kW - 1][v] = g;
          if (r < kRows) {  // t's terms of dw and dbias are this segment's
#pragma unroll
            for (int j = 0; j < kW; ++j) acc[j][v] = fmaf(g, xw[j][v], acc[j][v]);
            acc[kW][v] += g;
          }
        }
        if (r >= kW - 1) {
          const int u = t - (kW - 1);
          float o[N];
#pragma unroll
          for (int v = 0; v < N; ++v) {
            float s = 0.f;
#pragma unroll
            for (int j = 0; j < kW; ++j) s = fmaf(wr[j][v], gw[kW - 1 - j][v], s);
            o[v] = s;
          }
          if (u < S) store_vec<N>(dxb + (size_t)u * C, o);
        }
#pragma unroll
        for (int j = 0; j + 1 < kW; ++j)
#pragma unroll
          for (int v = 0; v < N; ++v) {
            xw[j][v] = xw[j + 1][v];
            gw[j][v] = gw[j + 1][v];
          }
      }
    }
  }
  // the CTA's row of partials: its threads of one channel group summed in order
  const int tid = threadIdx.y * kTx + threadIdx.x;
#pragma unroll
  for (int j = 0; j <= kW; ++j)
#pragma unroll
    for (int v = 0; v < N; ++v) red[tid][j * N + v] = acc[j][v];
  __syncthreads();
  if (threadIdx.y == 0 && live) {
#pragma unroll
    for (int j = 0; j <= kW; ++j) {
      float s[N];
#pragma unroll
      for (int v = 0; v < N; ++v) {
        s[v] = 0.f;
        for (int yy = 0; yy < kTy; ++yy) s[v] += red[yy * kTx + threadIdx.x][j * N + v];
      }
      store_vec<N>(part + ((size_t)blockIdx.y * (kW + 1) + j) * C + c0, s);
    }
  }
}

// dw (W, C) and dbias (C) from the (parts, 5, C) partials: 32 columns a
// CTA, 8 lanes a column, lane l summing parts l, l + 8, ... in order, then
// the 8 lanes in order.
template <typename T>
__global__ void __launch_bounds__(256)
causal_conv_bwd_reduce(const float* __restrict__ part, T* __restrict__ dw,
                       T* __restrict__ db, int C, int W, int parts) {
  __shared__ float lanes[8][33];
  const int e = blockIdx.x * 32 + threadIdx.x;
  const int n = (kW + 1) * C;
  float s = 0.f;
  if (e < n)
    for (int p = threadIdx.y; p < parts; p += 8) s += part[(size_t)p * n + e];
  lanes[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || e >= n) return;
  float t = 0.f;
#pragma unroll
  for (int l = 0; l < 8; ++l) t += lanes[l][threadIdx.x];
  const int j = e / C, c = e - j * C;
  if (j == kW) db[c] = from_float<T>(t);
  else if (j >= kW - W) dw[(size_t)(j - (kW - W)) * C + c] = from_float<T>(t);
}

struct Shape {
  int B, S, C, W, rows;
  int segs_per_row() const { return (S + rows - 1) / rows; }
  int n_seg() const { return B * segs_per_row(); }
  dim3 grid(int vec) const {
    const int ys = (n_seg() + kTy - 1) / kTy;
    return dim3((C / vec + kTx - 1) / kTx, ys < 65535 ? ys : 65535);
  }
  bool bad() const {
    return B <= 0 || S <= 0 || C <= 0 || C % kFwdVec != 0 || W < 1 || W > kW ||
           (rows != 8 && rows != 32) || (long long)B * ((S + rows - 1) / rows) > (1LL << 30);
  }
};

template <typename T>
int launch_fwd(const void* x, const void* w, const void* b, void* y, const Shape& sh,
               cudaStream_t stream) {
  causal_conv_fwd_kernel<T><<<sh.grid(kFwdVec), dim3(kTx, kTy), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), sh.S, sh.C, sh.W, sh.segs_per_row(), sh.n_seg());
  return cudaGetLastError();
}

template <typename T, int kRows>
int launch_bwd(const void* x, const void* w, const void* b, const void* dy, void* dx, void* dw,
               void* db, void* part, const Shape& sh, cudaStream_t stream) {
  const dim3 grid = sh.grid(kBwdVec);
  causal_conv_bwd_kernel<T, kRows><<<grid, dim3(kTx, kTy), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<float*>(part), sh.S, sh.C,
      sh.W, sh.segs_per_row(), sh.n_seg());
  const int err = cudaGetLastError();
  if (err) return err;
  causal_conv_bwd_reduce<T><<<((kW + 1) * sh.C + 31) / 32, dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(dw), static_cast<T*>(db), sh.C, sh.W,
      (int)grid.y);
  return cudaGetLastError();
}

template <typename T>
int bwd_rows(const void* x, const void* w, const void* b, const void* dy, void* dx, void* dw,
             void* db, void* part, const Shape& sh, cudaStream_t st) {
  return sh.rows == 32 ? launch_bwd<T, 32>(x, w, b, dy, dx, dw, db, part, sh, st)
                       : launch_bwd<T, 8>(x, w, b, dy, dx, dw, db, part, sh, st);
}

}  // namespace
}  // namespace repro_torch

// y (B, S, C) = silu(causal depthwise conv of x (B, S, C) with taps w (W, C),
// W <= 4, and bias b (C)), every tensor contiguous, 16-byte aligned and of
// `dtype`.  Launches on `stream`, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).
extern "C" int causal_conv_silu_fwd(const void* x, const void* w, const void* b, void* y,
                                    int B, int S, int C, int W, int dtype, void* stream) {
  using namespace repro_torch;
  const Shape sh{B, S, C, W, kFwdRows};
  if (sh.bad()) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_fwd<float>(x, w, b, y, sh, st);
    case kBFloat16: return launch_fwd<__nv_bfloat16>(x, w, b, y, sh, st);
    default: return cudaErrorInvalidValue;
  }
}

// The backward of causal_conv_silu_fwd for an upstream gradient dy (B, S,
// C): writes dx (B, S, C), dw (W, C) and db (C) in `dtype`.  A thread walks
// segments of `rows` (8 or 32) times.  `part` is f32 scratch of parts * 5 *
// C, where parts = min(ceil(B ceil(S / rows) / 8), 65535), the CTAs along
// the segments: a function of the shape alone, so a backward repeats bit
// for bit.
extern "C" int causal_conv_silu_bwd(const void* x, const void* w, const void* b,
                                    const void* dy, void* dx, void* dw, void* db, void* part,
                                    int B, int S, int C, int W, int rows, int parts, int dtype,
                                    void* stream) {
  using namespace repro_torch;
  const Shape sh{B, S, C, W, rows};
  if (sh.bad() || (int)sh.grid(kBwdVec).y != parts) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return bwd_rows<float>(x, w, b, dy, dx, dw, db, part, sh, st);
    case kBFloat16: return bwd_rows<__nv_bfloat16>(x, w, b, dy, dx, dw, db, part, sh, st);
    default: return cudaErrorInvalidValue;
  }
}
