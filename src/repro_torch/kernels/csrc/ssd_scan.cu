// Mamba-2 SSD chunked scan, forward and backward in float32, for Hopper,
// sm_90a.  In bf16 both run on the tensor cores: ssd_scan_fwd.cu and
// ssd_scan_bwd.cu.
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_scan() and its Pallas body
// _kernel().  Per (batch b, head h), over chunks of `chunk` positions with
// cs = cumsum(dt * A) inside the chunk and the (n x p) f32 state S entering
// the chunk:
//   y_t = sum_{u <= t} (C_t . B_u) exp(cs_t - cs_u) dt_u x_u
//         + exp(cs_t) C_t . S + D x_t
//   S  <- exp(cs_last) S + sum_u exp(cs_last - cs_u) dt_u B_u x_u^T
// B and C (b, s, n) are shared by all heads.  The reference has no
// backward (its gradients come from autodiff of the jnp path); the
// backward here is written out by hand from the recurrence above.
//
// What bounds it on the H100: at zamba2-1.2b's widths (n = p = 64,
// chunk 256) a chunk does ~4 c^2 (n + p) / 2 + 4 c n p FLOP per head for
// ~c (p + 2 n / h) elements, some 300 FLOP per byte in bf16: about the
// tensor cores' ridge, so by the card's peaks both bound it (~0.02 ms per
// layer and microbatch of 2 x 2048 tokens).  This kernel multiplies on the
// SIMT f32 pipe (67 TFLOP/s), so its own limit is its operations.
//
// What the design does about it:
//   * one CTA per (head, batch) that loops over the chunks in order, the
//     state in shared memory: the Pallas grid's sequential chunk axis
//     becomes a loop, since Hopper blocks run in no order;
//   * inside a chunk, 64-row tiles of t against 64-row tiles of u <= t,
//     so the c x c gate matrix never exists whole (256 KB in f32 at
//     chunk 256); tiles above the diagonal are skipped;
//   * a masked gate is 0 by construction, never exp() of a positive sum;
//   * the backward recomputes each chunk's entering state in a first pass
//     (one state update per chunk, a quarter of the forward's work) into a
//     scratch buffer, then walks the chunks in reverse carrying dS in
//     shared memory; dB and dC (shared across heads) are written per head
//     and summed over heads by the caller in a fixed order, so a step is
//     deterministic (no atomics anywhere);
//   * each thread owns a 4 x 4 block of every 64 x 64 tile product, with
//     padded shared rows (no bank conflicts on the reduction axis);
//   * ddt and dA come from d cs, whose reverse cumsum is a small difference
//     of large row and column sums of the gated terms at the model's decay
//     (hundreds of e-folds a chunk), and each gate exp(cs_t - cs_u) takes
//     the rounding of cs (some 300 in size) into its exponent: the backward
//     keeps cs, those sums and their reverse cumsum in f64.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kT = 64;         // rows of a t or u tile
constexpr int kMax = 64;       // largest n and p the kernels take
constexpr int kS = kMax + 1;   // padded row stride of every shared tile
constexpr int kTile = kT * kS;
constexpr int kThreads = 256;  // 16 x 16: ty picks 4 rows, tx 4 columns

// rows [0, rows) x cols [0, cols) of a row-major global matrix with row
// stride `stride` into a 64 x 64 shared f32 tile; everything else is 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          size_t stride, int rows, int cols) {
  for (int e = threadIdx.x; e < kT * kMax; e += kThreads) {
    const int r = e / kMax, c = e % kMax;
    dst[r * kS + c] = (r < rows && c < cols) ? to_float(src[(size_t)r * stride + c]) : 0.f;
  }
}

// dts[i] = dt at chunk row i, cs = inclusive cumsum of dts * a, summed in
// Cs (float in the forward, double in the backward).  Ends with the block
// synchronised.
template <typename Cs>
__device__ void chunk_gates(float* __restrict__ dts, Cs* __restrict__ cs,
                           const float* __restrict__ dt_col, int H, float a, int chunk) {
  __syncthreads();  // the previous chunk's readers are done
  for (int i = threadIdx.x; i < chunk; i += kThreads) dts[i] = dt_col[(size_t)i * H];
  __syncthreads();
  if (threadIdx.x < 32) {  // one warp: a segment per lane, then a scan of the segments
    const int lane = threadIdx.x, per = (chunk + 31) / 32;
    const int lo = min(chunk, lane * per), hi = min(chunk, lo + per);
    Cs run = 0;
    for (int i = lo; i < hi; ++i) {
      run += (Cs)dts[i] * (Cs)a;
      cs[i] = run;
    }
    Cs incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Cs v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    for (int i = lo; i < hi; ++i) cs[i] += incl - run;
  }
  __syncthreads();
}

// S <- exp(cs_last) S + sum_u exp(cs_last - cs_u) dt_u B_u x_u^T over one
// chunk.  Bc / xc point at the chunk's first row.  Ends synchronised.
template <typename T, typename Cs>
__device__ void advance_state(float* __restrict__ St, float* __restrict__ Bu,
                              float* __restrict__ Xu, const Cs* __restrict__ cs,
                              const float* __restrict__ dts, const T* __restrict__ Bc,
                              const T* __restrict__ xc, size_t xs, int N, int P, int chunk) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const Cs total = cs[chunk - 1];
  float acc[4][4];  // rows n = ty*4+i, columns p = tx+16j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = St[(ty * 4 + i) * kS + tx + 16 * j] * expf((float)total);
  for (int u0 = 0; u0 < chunk; u0 += kT) {
    const int ur = min(kT, chunk - u0);
    __syncthreads();
    load_tile(Bu, Bc + (size_t)u0 * N, N, ur, N);
    load_tile(Xu, xc + (size_t)u0 * xs, xs, ur, P);
    __syncthreads();
    for (int r = 0; r < ur; ++r) {
      const float g = expf((float)(total - cs[u0 + r])) * dts[u0 + r];
      float bv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) bv[i] = Bu[r * kS + ty * 4 + i] * g;
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = Xu[r * kS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) St[(ty * 4 + i) * kS + tx + 16 * j] = acc[i][j];
  __syncthreads();
}

// Sum of v over the block, in a fixed order; every thread gets it.
__device__ double block_sum(double v, double* __restrict__ red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// Sum over the 16 lanes that share ty (one half-warp).
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ D, T* __restrict__ y,
               int S, int H, int N, int P, int chunk) {
  extern __shared__ float sm[];
  float* St = sm;           // state entering the chunk: rows n, columns p
  float* Ct = St + kTile;   // C rows of the t tile
  float* Bu = Ct + kTile;   // B rows of the u tile
  float* Xu = Bu + kTile;   // x rows of the u tile
  float* W = Xu + kTile;    // gated (C_t . B_u) dt_u for one (t, u) tile pair
  float* cs = W + kTile;
  float* dts = cs + chunk;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float a = A[h], d_skip = D[h];
  const size_t xs = (size_t)H * P;
  const T* xb = x + (size_t)b * S * xs + (size_t)h * P;
  T* yb = y + (size_t)b * S * xs + (size_t)h * P;
  const T* Bb = Bm + (size_t)b * S * N;
  const T* Cb = Cm + (size_t)b * S * N;
  const float* dtb = dt + (size_t)b * S * H + h;

  for (int e = threadIdx.x; e < kTile; e += kThreads) St[e] = 0.f;
  for (int c0 = 0; c0 < S; c0 += chunk) {
    chunk_gates(dts, cs, dtb + (size_t)c0 * H, H, a, chunk);
    for (int t0 = 0; t0 < chunk; t0 += kT) {
      const int tr = min(kT, chunk - t0);
      __syncthreads();
      load_tile(Ct, Cb + (size_t)(c0 + t0) * N, N, tr, N);
      __syncthreads();
      // inter-chunk: exp(cs_t) C_t . S
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Ct[(ty * 4 + i) * kS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = St[n * kS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const float e = r < tr ? expf(cs[t0 + r]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
      // intra-chunk: u tiles up to and including the diagonal one
      for (int u0 = 0; u0 <= t0; u0 += kT) {
        const int ur = min(kT, chunk - u0);
        __syncthreads();
        load_tile(Bu, Bb + (size_t)(c0 + u0) * N, N, ur, N);
        load_tile(Xu, xb + (size_t)(c0 + u0) * xs, xs, ur, P);
        __syncthreads();
        float w[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) w[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Ct[(ty * 4 + i) * kS + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bu[(tx + 16 * j) * kS + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) w[i][j] = fmaf(cv[i], bv[j], w[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int u = u0 + tx + 16 * j;
            const bool ok = u <= t && t < t0 + tr && u < u0 + ur;
            W[(ty * 4 + i) * kS + tx + 16 * j] =
                ok ? w[i][j] * expf(cs[t] - cs[u]) * dts[u] : 0.f;
          }
        }
        __syncthreads();
        for (int r = 0; r < ur; ++r) {
          float wv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = W[(ty * 4 + i) * kS + r];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = Xu[r * kS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
        }
      }
      // the last u tile was the diagonal one: Xu holds this t tile's x
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= tr) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          if (col < P)
            yb[(size_t)(c0 + t0 + r) * xs + col] =
                from_float<T>(acc[i][j] + d_skip * Xu[r * kS + col]);
        }
      }
    }
    advance_state(St, Bu, Xu, cs, dts, Bb + (size_t)c0 * N, xb + (size_t)c0 * xs, xs, N, P,
                  chunk);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ D,
               const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ dBh, float* __restrict__ dCh, float* __restrict__ dA_part,
               float* __restrict__ dD_part, float* __restrict__ states, int S, int H, int N,
               int P, int chunk) {
  extern __shared__ float sm[];
  float* St = sm;            // state entering chunk k
  float* dS = St + kTile;    // gradient of the state leaving chunk k
  float* Ct = dS + kTile;    // C rows of the t tile
  float* dYt = Ct + kTile;   // dy rows of the t tile
  float* Bu = dYt + kTile;   // B rows of the u tile
  float* Xu = Bu + kTile;    // x rows of the u tile
  float* Ks = Xu + kTile;    // (C_t . B_u) exp(cs_t - cs_u), masked
  float* Es = Ks + kTile;    // exp(cs_t - cs_u) dt_u (x_u . dy_t), masked
  float* Zs = Es + kTile;    // Ks * (x_u . dy_t)
  // the cumsum and the gate gradients in f64 (9 tiles of floats end 8-byte
  // aligned), then dt
  double* cs = reinterpret_cast<double*>(Zs + kTile);
  double* dcs = cs + chunk;   // d loss / d cs, row-side terms
  double* dcu = dcs + chunk;  // d loss / d cs, column-side terms
  double* ddd = dcu + chunk;  // d loss / d dt, direct terms
  double* red = ddd + chunk;  // 8 doubles for block sums
  float* dts = reinterpret_cast<float*>(red + 8);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float a = A[h], d_skip = D[h];
  const int nc = S / chunk;
  const size_t xs = (size_t)H * P, ns = (size_t)H * N;
  const size_t xoff = (size_t)b * S * xs + (size_t)h * P;
  const size_t noff = (size_t)b * S * ns + (size_t)h * N;
  const T* xb = x + xoff;
  const T* dyb = dy + xoff;
  T* dxb = dx + xoff;
  float* dBb = dBh + noff;
  float* dCb = dCh + noff;
  const T* Bb = Bm + (size_t)b * S * N;
  const T* Cb = Cm + (size_t)b * S * N;
  const float* dtb = dt + (size_t)b * S * H + h;
  float* ddtb = ddt + (size_t)b * S * H + h;
  float* stb = states + ((size_t)b * H + h) * nc * kMax * kMax;

  // ---- pass 1: the state entering every chunk, into the scratch buffer
  for (int e = threadIdx.x; e < kTile; e += kThreads) St[e] = 0.f;
  for (int k = 0; k < nc; ++k) {
    const int c0 = k * chunk;
    __syncthreads();
    for (int e = threadIdx.x; e < kMax * kMax; e += kThreads)
      stb[(size_t)k * kMax * kMax + e] = St[(e / kMax) * kS + e % kMax];
    if (k == nc - 1) break;
    chunk_gates(dts, cs, dtb + (size_t)c0 * H, H, a, chunk);
    advance_state(St, Bu, Xu, cs, dts, Bb + (size_t)c0 * N, xb + (size_t)c0 * xs, xs, N, P,
                  chunk);
  }

  // ---- pass 2: chunks in reverse, dS carried
  for (int e = threadIdx.x; e < kTile; e += kThreads) dS[e] = 0.f;
  double dA_acc = 0.0;
  float dD_acc = 0.f;
  for (int k = nc - 1; k >= 0; --k) {
    const int c0 = k * chunk;
    __syncthreads();
    for (int e = threadIdx.x; e < kMax * kMax; e += kThreads)
      St[(e / kMax) * kS + e % kMax] = stb[(size_t)k * kMax * kMax + e];
    for (int i = threadIdx.x; i < chunk; i += kThreads) dcu[i] = ddd[i] = 0.0;
    chunk_gates(dts, cs, dtb + (size_t)c0 * H, H, a, chunk);
    const double total = cs[chunk - 1];

    // dS entering this chunk: exp(total) dS + sum_t exp(cs_t) C_t dy_t^T
    // (rows n = ty*4+i, columns p = tx+16j); and exp(total) <S, dS>.
    float dsn[4][4];
    float last = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = (ty * 4 + i) * kS + tx + 16 * j;
        dsn[i][j] = dS[e] * expf((float)total);
        last = fmaf(St[e], dsn[i][j], last);
      }

    // pre-pass over t tiles: the inter-chunk terms
    for (int t0 = 0; t0 < chunk; t0 += kT) {
      const int tr = min(kT, chunk - t0);
      __syncthreads();
      load_tile(Ct, Cb + (size_t)(c0 + t0) * N, N, tr, N);
      load_tile(dYt, dyb + (size_t)(c0 + t0) * xs, xs, tr, P);
      __syncthreads();
      // w[t][n] = (S dy_t)[n]; dC_t = exp(cs_t) w; dcs_t = exp(cs_t) C_t . w
      float w[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) w[i][j] = 0.f;
      for (int p = 0; p < P; ++p) {
        float yv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) yv[i] = dYt[(ty * 4 + i) * kS + p];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = St[(tx + 16 * j) * kS + p];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) w[i][j] = fmaf(yv[i], sv[j], w[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const float e = r < tr ? expf((float)cs[t0 + r]) : 0.f;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = tx + 16 * j;
          rs = fmaf(Ct[r * kS + n], w[i][j], rs);
          if (r < tr && n < N) dCb[(size_t)(c0 + t0 + r) * ns + n] = e * w[i][j];
        }
        rs = row_sum16(rs);
        if (tx == 0 && r < tr) dcs[t0 + r] = (double)e * rs;
      }
      for (int r = 0; r < tr; ++r) {
        const float e = expf((float)cs[t0 + r]);
        float cv[4], yv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Ct[r * kS + ty * 4 + i] * e;
#pragma unroll
        for (int j = 0; j < 4; ++j) yv[j] = dYt[r * kS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dsn[i][j] = fmaf(cv[i], yv[j], dsn[i][j]);
      }
    }

    // main pass: u tiles outer, t tiles from the last down to the diagonal
    double sum_p = 0.0;
    for (int u0 = 0; u0 < chunk; u0 += kT) {
      const int ur = min(kT, chunk - u0);
      __syncthreads();
      load_tile(Bu, Bb + (size_t)(c0 + u0) * N, N, ur, N);
      load_tile(Xu, xb + (size_t)(c0 + u0) * xs, xs, ur, P);
      float dxa[4][4], dba[4][4];  // rows u = ty*4+i; columns p (dx) and n (dB)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dxa[i][j] = dba[i][j] = 0.f;
      const int last_t0 = ((chunk - 1) / kT) * kT;
      for (int t0 = last_t0; t0 >= u0; t0 -= kT) {
        const int tr = min(kT, chunk - t0);
        __syncthreads();
        load_tile(Ct, Cb + (size_t)(c0 + t0) * N, N, tr, N);
        load_tile(dYt, dyb + (size_t)(c0 + t0) * xs, xs, tr, P);
        __syncthreads();
        // tiles of (t, u): cb = C_t . B_u and xdy = x_u . dy_t
        float cb[4][4], xdy[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cb[i][j] = xdy[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Ct[(ty * 4 + i) * kS + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bu[(tx + 16 * j) * kS + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) cb[i][j] = fmaf(cv[i], bv[j], cb[i][j]);
        }
        for (int p = 0; p < P; ++p) {
          float yv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) yv[i] = dYt[(ty * 4 + i) * kS + p];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = Xu[(tx + 16 * j) * kS + p];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) xdy[i][j] = fmaf(yv[i], xv[j], xdy[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int u = u0 + tx + 16 * j;
            const bool ok = u <= t && t < t0 + tr && u < u0 + ur;
            const float g = ok ? expf((float)(cs[t] - cs[u])) : 0.f;
            const int e = (ty * 4 + i) * kS + tx + 16 * j;
            Ks[e] = cb[i][j] * g;
            Es[e] = ok ? g * dts[u] * xdy[i][j] : 0.f;
            Zs[e] = cb[i][j] * g * xdy[i][j];
          }
        }
        __syncthreads();
        // dx_u += K^T dy_t (dt_u applied at the end); dB_u += E^T C_t
        for (int r = 0; r < tr; ++r) {
          float kv[4], ev[4], yv[4], cv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            kv[i] = Ks[r * kS + ty * 4 + i];
            ev[i] = Es[r * kS + ty * 4 + i];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            yv[j] = dYt[r * kS + tx + 16 * j];
            cv[j] = Ct[r * kS + tx + 16 * j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              dxa[i][j] = fmaf(kv[i], yv[j], dxa[i][j]);
              dba[i][j] = fmaf(ev[i], cv[j], dba[i][j]);
            }
        }
        // dC_t += E B_u: each (t, n) belongs to the thread that wrote it
        // in the pre-pass, so the read-modify-write needs no barrier
        {
          float dc[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) dc[i][j] = 0.f;
          for (int r = 0; r < ur; ++r) {
            float ev[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) ev[i] = Es[(ty * 4 + i) * kS + r];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = Bu[r * kS + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) dc[i][j] = fmaf(ev[i], bv[j], dc[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = ty * 4 + i;
            if (r >= tr) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int n = tx + 16 * j;
              if (n < N) dCb[(size_t)(c0 + t0 + r) * ns + n] += dc[i][j];
            }
          }
        }
        // row and column sums of Z: dcs_t += sum_u Z dt_u, dcs_u -= dt_u sum_t Z,
        // ddt_u += sum_t Z
        if (threadIdx.x < kT) {
          const int c = threadIdx.x;
          if (c < ur) {
            double s = 0.0;
            for (int r = 0; r < tr; ++r) s += Zs[r * kS + c];
            ddd[u0 + c] += s;
            dcu[u0 + c] -= dts[u0 + c] * s;
          }
        } else if (threadIdx.x < 2 * kT) {
          const int r = threadIdx.x - kT;
          if (r < tr) {
            double s = 0.0;
            for (int c = 0; c < ur; ++c) s = fma((double)Zs[r * kS + c], (double)dts[u0 + c], s);
            dcs[t0 + r] += s;
          }
        }
      }
      __syncthreads();
      // the last t tile was the diagonal one: dYt holds this u tile's dy.
      // State terms: v[u][n] = (dS x_u)[n] and (B_u . dS)[p].
      float bs[4][4], v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) bs[i][j] = v[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float bv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) bv[i] = Bu[(ty * 4 + i) * kS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = dS[n * kS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) bs[i][j] = fmaf(bv[i], sv[j], bs[i][j]);
      }
      for (int p = 0; p < P; ++p) {
        float xv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = Xu[(ty * 4 + i) * kS + p];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = dS[(tx + 16 * j) * kS + p];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) v[i][j] = fmaf(xv[i], sv[j], v[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const bool okr = r < ur;
        const int u = u0 + (okr ? r : 0);
        const float g = okr ? expf((float)(total - cs[u])) : 0.f;
        const float dtu = okr ? dts[u] : 0.f;
        float pn = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) pn = fmaf(Bu[r * kS + tx + 16 * j], v[i][j], pn);
        pn = row_sum16(pn) * g;
        if (!okr) continue;
        if (tx == 0) {
          ddd[u] += pn;
          dcu[u] -= (double)dtu * pn;
          sum_p += (double)dtu * pn;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          const size_t row = (size_t)(c0 + u);
          if (col < P) {
            const float dyv = dYt[r * kS + col], xv = Xu[r * kS + col];
            dxb[row * xs + col] = from_float<T>(dtu * (dxa[i][j] + g * bs[i][j]) + d_skip * dyv);
            dD_acc = fmaf(dyv, xv, dD_acc);
          }
          if (col < N) dBb[row * ns + col] = dba[i][j] + g * dtu * v[i][j];
        }
      }
    }
    // the last row's cs also carries exp(total) <S, dS> and sum_u dt_u Pn_u
    const double extra = block_sum(last + sum_p, red);
    if (threadIdx.x == 0) dcs[chunk - 1] += extra;
    __syncthreads();
    // d la = reverse cumsum of dcs; ddt = direct + A d la; dA += dt d la
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x, per = (chunk + 31) / 32;
      const int lo = min(chunk, lane * per), hi = min(chunk, lo + per);
      double run = 0.0;
      for (int i = hi - 1; i >= lo; --i) run += dcs[i] + dcu[i];
      double incl = run;  // suffix sum over this lane's segment and those after
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double vv = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += vv;
      }
      double acc = incl - run;
      for (int i = hi - 1; i >= lo; --i) {
        acc += dcs[i] + dcu[i];
        ddtb[(size_t)(c0 + i) * H] = (float)(ddd[i] + (double)a * acc);
        dA_acc = fma((double)dts[i], acc, dA_acc);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dS[(ty * 4 + i) * kS + tx + 16 * j] = dsn[i][j];
  }
  const float dA_sum = (float)block_sum(dA_acc, red);
  const float dD_sum = (float)block_sum(dD_acc, red);
  if (threadIdx.x == 0) {
    dA_part[(size_t)b * H + h] = dA_sum;
    dD_part[(size_t)b * H + h] = dD_sum;
  }
}

size_t fwd_smem(int chunk) { return sizeof(float) * (5 * kTile + 2 * chunk); }
size_t bwd_smem(int chunk) {
  return sizeof(float) * (9 * kTile + chunk) + sizeof(double) * (4 * chunk + 8);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, const void* D, void* y, int b, int s, int h, int p, int n,
                       int chunk, cudaStream_t stream) {
  const size_t smem = fwd_smem(chunk);
  auto kern = ssd_fwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(h, b), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<T*>(y), s, h, n, p, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, const void* D, const void* dy, void* dx, void* ddt,
                       void* dBh, void* dCh, void* dA, void* dD, void* states, int b, int s,
                       int h, int p, int n, int chunk, cudaStream_t stream) {
  const size_t smem = bwd_smem(chunk);
  auto kern = ssd_bwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(h, b), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dBh), static_cast<float*>(dCh), static_cast<float*>(dA),
      static_cast<float*>(dD), static_cast<float*>(states), s, h, n, p, chunk);
  return cudaGetLastError();
}

bool bad_shape(int b, int s, int h, int p, int n, int chunk) {
  return b <= 0 || s <= 0 || h <= 0 || p <= 0 || p > kMax || n <= 0 || n > kMax ||
         chunk <= 0 || chunk > 1024 || s % chunk != 0 || h > 65535 || b > 65535;
}

}  // namespace
}  // namespace repro_torch

// float32 only (bf16: ssd_scan_fwd.cu).  x: (b, s, h, p) and B, C: (b, s, n);
// dt: (b, s, h), A, D: (h,); y: (b, s, h, p).  All contiguous.  n, p <= 64,
// s % chunk == 0, chunk <= 1024.  Launches on `stream`, allocates nothing,
// returns the cudaError_t of the launch.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, const void* D, void* y, int b, int s, int h, int p,
                            int n, int chunk, int dtype, void* stream) {
  using namespace repro_torch;
  if (bad_shape(b, s, h, p, n, chunk) || dtype != kFloat32) return cudaErrorInvalidValue;
  return launch_fwd<float>(x, dt, A, B, C, D, y, b, s, h, p, n, chunk,
                           static_cast<cudaStream_t>(stream));
}

// The backward of ssd_scan_fwd for an upstream gradient dy (b, s, h, p),
// float32 only (bf16: ssd_scan_bwd.cu).  Writes dx (b, s, h, p), ddt
// (b, s, h), the per-head dB and dC (b, s, h, n), dA and dD per (b, h);
// `states` is scratch of b * h * (s / chunk) * 64 * 64 floats.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, const void* D, const void* dy, void* dx, void* ddt,
                            void* dBh, void* dCh, void* dA, void* dD, void* states, int b,
                            int s, int h, int p, int n, int chunk, int dtype, void* stream) {
  using namespace repro_torch;
  if (bad_shape(b, s, h, p, n, chunk) || dtype != kFloat32) return cudaErrorInvalidValue;
  return launch_bwd<float>(x, dt, A, B, C, D, dy, dx, ddt, dBh, dCh, dA, dD, states, b, s, h, p,
                           n, chunk, static_cast<cudaStream_t>(stream));
}
