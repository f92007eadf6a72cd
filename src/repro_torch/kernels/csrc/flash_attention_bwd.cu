// Flash attention backward for Hopper, sm_90a: dQ, dK and dV of
// softmax(scale * Q K^T) V with GQA and the end-aligned causal mask.
//
// Head dims: the query / key head D and the value head Dv are template
// arguments, the pairs the forward builds: D = Dv in {32, 64, 128}, and
// multi-head latent attention's (192, 128) and (48, 32) (deepseek-v2's
// d_nope + d_rope against d_v, and its reduced sibling's).  dQ and dK are
// (..., D); dV, O, dO and Delta's row sum are over Dv; S = Q K^T contracts
// over D and dP = dO V^T over Dv.
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
// card's bf16 tensor-core peak.
//
// Both dtypes keep the split into two kernels, so no thread block needs
// atomics and a train step is deterministic: a dQ kernel per query tile
// (it also computes Delta and writes it for the second) and a dK/dV kernel
// per key tile, looping over the G query heads of its group and the query
// tiles from the diagonal down, so the GQA sum over heads stays in
// registers.  P is recomputed from lse, never stored.  Together they run 7
// products where 5 would do (S and dP in both kernels): the price of having
// no atomics.
//
// bfloat16 (every main path), `dq_sm90` and `dkv_sm90`: wgmma for all
// seven products and TMA for every tile, as in the forward -- a producer
// warpgroup (setmaxnreg 24) and two consumer warpgroups (240) of 64 rows
// each, a 2-stage mbarrier ring of 64-row tiles:
//   * dQ, per 128-row query tile: Q and dO are loaded once, K/V streamed;
//     S = Q K^T and dP = dO V^T with both operands in shared memory; P and
//     dS = P (dP - Delta) on the accumulator fragments in registers; dS,
//     rounded to bf16 in registers, is the A operand of dQ += dS K with K
//     as the MN-major B operand;
//   * dK/dV, per 128-row key tile: K and V are loaded once; Q, dO and each
//     query row's lse and Delta are streamed (the producer warp copies the
//     two f32 vectors into the ring stage beside the TMA tiles).  It works
//     in the transposed form, so no shared tile is ever transposed:
//     S^T = K Q^T and dP^T = V dO^T -> P^T and dS^T in registers ->
//     dV += P^T dO and dK += dS^T Q (dO and Q MN-major).
//   Registers bound the design: at D = 128 the dK and dV accumulators take
//   128 registers a thread of a 64-row warpgroup tile, S^T and dP^T 64
//   more, P^T and dS^T in bf16 32 more, so the D = 128 dK/dV kernel spills
//   and ptxas serializes its wgmma.  Issuing one tile's products with the
//   next tile's (as the forward does) needs more registers still, and
//   measured slower at every head dim, so each step's products wait for its
//   elementwise work.  At (192, 128) the two accumulators alone would take
//   160 registers a thread (96 for dK, 64 for dV), so that pair runs the
//   dK/dV kernel as two passes over the same tiles: one accumulates dV
//   (S^T, P^T, P^T dO), the other dK (S^T, dP^T, dS^T Q); the price is
//   S^T computed twice.
//   A head of 48 (reduced MLA) is three 16-column sub-tiles with the 32-byte
//   swizzle, so its dQ and dK products are three n16 wgmma a k-step.
// float32 keeps the SIMT kernels below (`dq_kernel`, `dkv_kernel`): their
// callers hold them at 1e-4 of the f32 plain version, which TF32 products
// cannot meet, and no main path runs f32 at full width.  Each thread owns
// a 4 x 4 block of every 64 x 64 score tile and a 4 x D/16 block of its
// accumulators (4 x Dv/16 for dV), on the f32 FMA pipe; masked and ragged
// positions get P = 0 by construction.
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace repro_torch {
namespace {

constexpr int kB = 64;         // rows of a query or key tile
constexpr int kThreads = 256;  // 16 x 16 threads: ty picks 4 rows, tx 4 columns
constexpr int kPS = kB + 1;

// Two kB-row tiles of D columns (Q, K) and two of Dv (dO, V), each row
// padded by one float, the score tile(s), lse and Delta.
template <int D, int DV>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kB * (D + 1) + 2 * kB * (DV + 1) + kB * kPS + 2 * kB);
}
template <int D, int DV>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * kB * (D + 1) + 2 * kB * (DV + 1) + 2 * kB * kPS + 2 * kB);
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

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
          T* __restrict__ dq, float* __restrict__ delta, int Sq, int Skv, int H, int K,
          int causal, float scale) {
  constexpr int RS = D + 1, RV = DV + 1, C = D / 16, CV = DV / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * RS;
  float* Ks = dOs + kB * RV;
  float* Vs = Ks + kB * RS;
  float* dSs = Vs + kB * RV;
  float* lse_s = dSs + kB * kPS;
  float* del_s = lse_s + kB;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int shift = Skv - Sq;
  const size_t qrow = (size_t)H * D, orow = (size_t)H * DV;
  const size_t krow = (size_t)K * D, vrow = (size_t)K * DV;
  const size_t qoff = (size_t)b * Sq * qrow + (size_t)h * D;
  const size_t ooff = (size_t)b * Sq * orow + (size_t)h * DV;
  const size_t hrow = ((size_t)b * H + h) * Sq;

  load_rows<T, D, kThreads>(Qs, RS, q + qoff, qrow, q0, kB, Sq);
  load_rows<T, DV, kThreads>(dOs, RV, dout + ooff, orow, q0, kB, Sq);
  load_rows<T, DV, kThreads>(Vs, RV, o + ooff, orow, q0, kB, Sq);  // O, for Delta only
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qi = q0 + r;
    float dsum = 0.f;
#pragma unroll
    for (int c = 0; c < CV; ++c) dsum = fmaf(dOs[r * RV + tx + 16 * c], Vs[r * RV + tx + 16 * c], dsum);
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
  const T* vb = v + (size_t)b * Skv * vrow + (size_t)kh * DV;
  for (int t0 = 0; t0 < kv_end; t0 += kB) {
    __syncthreads();  // the previous tiles (and O) are consumed
    load_rows<T, D, kThreads>(Ks, RS, kb, krow, t0, kB, Skv);
    load_rows<T, DV, kThreads>(Vs, RV, vb, vrow, t0, kB, Skv);
    __syncthreads();
    float s[4][4], dp[4][4];
    dots<D>(s, Qs, Ks, tx, ty);
    dots<DV>(dp, dOs, Vs, tx, ty);
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

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq,
           int Skv, int H, int K, int causal, float scale) {
  constexpr int RS = D + 1, RV = DV + 1, C = D / 16, CV = DV / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * RS;
  float* Qs = Vs + kB * RV;
  float* dOs = Qs + kB * RS;
  float* Ps = dOs + kB * RV;  // P^T: rows t, columns i
  float* dSs = Ps + kB * kPS; // dS^T
  float* lse_s = dSs + kB * kPS;
  float* del_s = lse_s + kB;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int t0 = blockIdx.x * kB;  // the first key tiles see the most queries
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int shift = Skv - Sq;
  const size_t qrow = (size_t)H * D, orow = (size_t)H * DV;
  const size_t krow = (size_t)K * D, vrow = (size_t)K * DV;
  const size_t koff = (size_t)b * Skv * krow + (size_t)kh * D;
  const size_t voff = (size_t)b * Skv * vrow + (size_t)kh * DV;

  load_rows<T, D, kThreads>(Ks, RS, k + koff, krow, t0, kB, Skv);
  load_rows<T, DV, kThreads>(Vs, RV, v + voff, vrow, t0, kB, Skv);

  float dka[4][C], dva[4][CV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) dka[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < CV; ++c) dva[i][c] = 0.f;
  }

  // queries i see key t when t <= i + shift: the first tile that can
  const int q_first = causal ? max(0, t0 - shift) / kB * kB : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t qoff = (size_t)b * Sq * qrow + (size_t)h * D;
    const size_t ooff = (size_t)b * Sq * orow + (size_t)h * DV;
    const size_t hrow = ((size_t)b * H + h) * Sq;
    for (int q0 = q_first; q0 < Sq; q0 += kB) {
      __syncthreads();  // the previous tiles are consumed
      load_rows<T, D, kThreads>(Qs, RS, q + qoff, qrow, q0, kB, Sq);
      load_rows<T, DV, kThreads>(dOs, RV, dout + ooff, orow, q0, kB, Sq);
      if (threadIdx.x < kB) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < Sq ? lse[hrow + qi] : INFINITY;
        del_s[threadIdx.x] = qi < Sq ? delta[hrow + qi] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      dots<D>(s, Ks, Qs, tx, ty);   // rows t, columns i
      dots<DV>(dp, Vs, dOs, tx, ty);
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
      accumulate<DV>(dva, Ps, dOs, tx, ty);
      accumulate<D>(dka, dSs, Qs, tx, ty);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= Skv) continue;
    T* krow_p = dk + koff + (size_t)t * krow;
    T* vrow_p = dv + voff + (size_t)t * vrow;
#pragma unroll
    for (int c = 0; c < C; ++c) krow_p[tx + 16 * c] = from_float<T>(dka[i][c] * scale);
#pragma unroll
    for (int c = 0; c < CV; ++c) vrow_p[tx + 16 * c] = from_float<T>(dva[i][c]);
  }
}

template <typename T, int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, void* dq, void* dk, void* dv, float* delta, int B, int Sq,
                   int Skv, int H, int K, int causal, float scale, cudaStream_t stream) {
  static_assert(dkv_smem<D, DV>() <= 227 * 1024, "shared memory");
  auto kq = dq_kernel<T, D, DV>;
  auto kkv = dkv_kernel<T, D, DV>;
  cudaError_t err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dq_smem<D, DV>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_smem<D, DV>());
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  kq<<<dim3((Sq + kB - 1) / kB, H, B), kThreads, dq_smem<D, DV>(), stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, lse, static_cast<T*>(dq), delta, Sq, Skv, H, K,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<dim3((Skv + kB - 1) / kB, K, B), kThreads, dkv_smem<D, DV>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, K,
      causal, scale);
  return cudaGetLastError();
}

// ------------------------------------------------ bfloat16: wgmma + TMA
namespace tc {

constexpr int kBig = 128;      // rows of the tile a CTA owns: 64 per consumer warpgroup
constexpr int kStep = 64;      // rows of a streamed ring stage
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups

// Shared memory of either kernel: a (kBig x D) tile and a (kBig x Dv) tile
// (Q and dO for dQ, K and V for dK/dV), then a 2-stage ring whose stage is
// a (kStep x D) tile and a (kStep x Dv) tile (K and V; Q and dO).  Every
// tile size is a multiple of 1024 bytes, so each stays swizzle-aligned.
template <int D, int DV>
struct Smem {
  using T = sm90::Tile<D>;
  using TV = sm90::Tile<DV>;
  static constexpr uint32_t kBigD = T::bytes(kBig), kBigV = TV::bytes(kBig);
  static constexpr uint32_t kStepD = T::bytes(kStep), kStepV = TV::bytes(kStep);
  static constexpr uint32_t kBigSubD = T::sub_bytes(kBig), kBigSubV = TV::sub_bytes(kBig);
  static constexpr uint32_t kStepSubD = T::sub_bytes(kStep), kStepSubV = TV::sub_bytes(kStep);
  static constexpr size_t kBytes = 1024 + kBigD + kBigV + 2 * (kStepD + kStepV);  // + slack
  static_assert(kBytes <= 227 * 1024, "shared memory");
};

__device__ __forceinline__ void init_barriers(uint64_t* once, uint64_t* full, uint64_t* empty,
                                              uint32_t full_count) {
  using namespace sm90;
  if (threadIdx.x == 0) {
    mbar_init(once, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], full_count);
      mbar_init(&empty[s], 2 * 128);  // every consumer thread releases the stage
    }
    fence_barrier_init();
  }
  __syncthreads();
}

// dQ per (128-row query tile, query head, batch), and Delta on the way.
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
dq_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
        const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
        int Sq, int Skv, int H, int K, int causal, float scale) {
  using namespace sm90;
  using L = Smem<D, DV>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_q, full[2], empty[2];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* dOs = Qs + L::kBigD;
  uint8_t* KV = dOs + L::kBigV;  // stage s: K at KV + s (kStepD + kStepV), V after it

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBig;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / K);
  const int shift = Skv - Sq;
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, max(0, min(q0 + kBig, Sq) + shift));
  const int n_kv = (kv_end + kStep - 1) / kStep;
  const int tid = threadIdx.x;
  init_barriers(&bar_q, full, empty, 1);

  if (tid < 128) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_arrive_expect_tx(&bar_q, L::kBigD + L::kBigV);
      tma_tile<D>(Qs, L::kBigSubD, &tm_q, &bar_q, h, q0, b);
      tma_tile<DV>(dOs, L::kBigSubV, &tm_do, &bar_q, h, q0, b);
      for (int it = 0; it < n_kv; ++it) {
        const int st = it & 1;
        mbar_wait(&empty[st], ((it >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], L::kStepD + L::kStepV);
        uint8_t* Ks = KV + st * (L::kStepD + L::kStepV);
        tma_tile<D>(Ks, L::kStepSubD, &tm_k, &full[st], kh, it * kStep, b);
        tma_tile<DV>(Ks + L::kStepD, L::kStepSubV, &tm_v, &full[st], kh, it * kStep, b);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int c = tid / 128 - 1;
  const int lt = tid % 128, g = (lt % 32) / 4, tq = lt % 4;
  const int wrow = q0 + 64 * c;
  const int row0 = wrow + 16 * (lt / 32) + g;  // this thread's rows: row0, row0 + 8
  const float sl2 = scale * kLog2e;
  const size_t hrow = ((size_t)b * H + h) * Sq;

  // Delta = rowsum(dO * O) over Dv and lse (in log2 units) of this thread's
  // two rows; the 4 lanes of a row each sum a quarter of it.  Rows past Sq
  // get lse = +inf, so P = 0 there.
  float dl[2], nl2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    float sum = 0.f;
    if (qi < Sq) {
      const size_t off = (((size_t)b * Sq + qi) * H + h) * DV + tq * (DV / 4);
#pragma unroll
      for (int i = 0; i < DV / 4; i += 8) {
        float ov[8], dv[8];
        load_vec<8>(o + off + i, ov);
        load_vec<8>(dout + off + i, dv);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum = fmaf(ov[e], dv[e], sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dl[r] = sum;
    nl2[r] = qi < Sq ? -lse[hrow + qi] * kLog2e : -INFINITY;
    if (qi < Sq && tq == 0) delta[hrow + qi] = sum;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(&bar_q, 0);
  const uint8_t* Qw = Qs + 64 * c * Tile<D>::kRowBytes;
  const uint8_t* dOw = dOs + 64 * c * Tile<DV>::kRowBytes;
  for (int it = 0; it < n_kv; ++it) {
    const int st = it & 1, t0 = it * kStep;
    const uint8_t* Ks = KV + st * (L::kStepD + L::kStepV);
    mbar_wait(&full[st], (it >> 1) & 1);

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
    mma_abt<D, kStep>(s, Qw, L::kBigSubD, Ks, L::kStepSubD);  // S = Q K^T
    wgmma_commit();
    mma_abt<DV, kStep>(dp, dOw, L::kBigSubV, Ks + L::kStepD, L::kStepSubV);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    const bool edge = t0 + kStep > Skv || (causal && t0 + kStep - 1 > wrow + shift);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + 8 * j + 2 * tq + (e & 1);
        const bool ok = !edge || (key < Skv && (!causal || key <= row0 + 8 * (e >> 1) + shift));
        s[4 * j + e] = ok ? ex2(fmaf(s[4 * j + e], sl2, nl2[e >> 1])) : 0.f;
      }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= dp[i] - dl[(i >> 1) & 1];  // dS
    uint32_t a[16];
    pack_a<kStep>(a, s);
    wgmma_fence();
    mma_pv<D, kStep / 16>(acc, a, Ks, L::kStepSubD);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* row = dq + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * tq) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

// What a dK/dV launch accumulates: both, or (for head pairs whose two
// accumulators pass the register budget) one of them per pass.
constexpr int kDK = 1, kDV = 2;

// dK and/or dV per (128-row key tile, kv head, batch), summed over the G
// query heads of the group and the query tiles from the diagonal down.
template <int D, int DV, int kParts>
__global__ void __launch_bounds__(kThreads, 1)
dkv_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
         const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
         const float* __restrict__ lse, const float* __restrict__ delta,
         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H,
         int K, int causal, float scale) {
  using namespace sm90;
  using L = Smem<D, DV>;
  constexpr bool do_dk = kParts & kDK, do_dv = kParts & kDV;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_kv, full[2], empty[2];
  __shared__ float nl2_s[2][kStep], dl_s[2][kStep];  // -lse log2(e) and Delta per query
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + L::kBigD;
  uint8_t* QD = Vs + L::kBigV;  // stage s: Q at QD + s (kStepD + kStepV), dO after it

  const int t0 = blockIdx.x * kBig;  // the first key tiles see the most queries
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int shift = Skv - Sq;
  // queries i see key t when t <= i + shift: the first tile that can
  const int q_first = causal ? max(0, t0 - shift) / kStep * kStep : 0;
  const int n_q = (Sq - q_first + kStep - 1) / kStep;  // query tiles per head
  const int tid = threadIdx.x;
  init_barriers(&bar_kv, full, empty, 32);  // the producer warp's lanes fill a stage

  if (tid < 128) {  // producer warpgroup: warp 0 loads, the others idle
    setmaxnreg_dec<24>();
    if (tid < 32) {
      if (tid == 0) {
        mbar_arrive_expect_tx(&bar_kv, L::kBigD + L::kBigV);
        tma_tile<D>(Ks, L::kBigSubD, &tm_k, &bar_kv, kh, t0, b);
        tma_tile<DV>(Vs, L::kBigSubV, &tm_v, &bar_kv, kh, t0, b);
      }
      for (int it = 0; it < G * n_q; ++it) {  // query head kh G + it / n_q, tile it % n_q
        const int st = it & 1, h = kh * G + it / n_q, q0 = q_first + (it % n_q) * kStep;
        const float* lse_h = lse + ((size_t)b * H + h) * Sq;
        const float* delta_h = delta + ((size_t)b * H + h) * Sq;
        mbar_wait(&empty[st], ((it >> 1) & 1) ^ 1);
        for (int i = tid; i < kStep; i += 32) {
          const bool in = q0 + i < Sq;
          nl2_s[st][i] = in ? -lse_h[q0 + i] * kLog2e : -INFINITY;
          dl_s[st][i] = in ? delta_h[q0 + i] : 0.f;
        }
        if (tid == 0) {
          mbar_arrive_expect_tx(&full[st], L::kStepD + L::kStepV);  // also publishes lse, Delta
          uint8_t* Qs = QD + st * (L::kStepD + L::kStepV);
          tma_tile<D>(Qs, L::kStepSubD, &tm_q, &full[st], h, q0, b);
          tma_tile<DV>(Qs + L::kStepD, L::kStepSubV, &tm_do, &full[st], h, q0, b);
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int c = tid / 128 - 1;
  const int lt = tid % 128, g = (lt % 32) / 4, tq = lt % 4;
  const int wkey = t0 + 64 * c;                 // this warpgroup's first key
  const int key0 = wkey + 16 * (lt / 32) + g;   // this thread's keys: key0, key0 + 8
  const float sl2 = scale * kLog2e;

  float dka[do_dk ? D / 2 : 1], dva[do_dv ? DV / 2 : 1];
#pragma unroll
  for (int i = 0; i < (do_dk ? D / 2 : 1); ++i) dka[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (do_dv ? DV / 2 : 1); ++i) dva[i] = 0.f;

  mbar_wait(&bar_kv, 0);
  const uint8_t* Kw = Ks + 64 * c * Tile<D>::kRowBytes;
  const uint8_t* Vw = Vs + 64 * c * Tile<DV>::kRowBytes;
  for (int it = 0; it < G * n_q; ++it) {
    const int st = it & 1, q0 = q_first + (it % n_q) * kStep;
    const uint8_t* Qs = QD + st * (L::kStepD + L::kStepV);
    const uint8_t* dOs = Qs + L::kStepD;
    mbar_wait(&full[st], (it >> 1) & 1);

    float s[32], dp[32];  // S^T and dP^T: rows are keys, columns queries
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
    mma_abt<D, kStep>(s, Kw, L::kBigSubD, Qs, L::kStepSubD);  // S^T = K Q^T
    wgmma_commit();
    if constexpr (do_dk) {
      mma_abt<DV, kStep>(dp, Vw, L::kBigSubV, dOs, L::kStepSubV);  // dP^T = V dO^T
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(s);
    if constexpr (do_dk) fence_regs(dp);
    const bool edge = causal && wkey + 63 > q0 + shift;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tq + (e & 1);
        const bool ok = !edge || key0 + 8 * (e >> 1) <= q0 + col + shift;
        s[4 * j + e] = ok ? ex2(fmaf(s[4 * j + e], sl2, nl2_s[st][col])) : 0.f;
      }
    uint32_t pa[16], da[16];
    if constexpr (do_dv) pack_a<kStep>(pa, s);
    if constexpr (do_dk) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * tq + (e & 1);
          s[4 * j + e] *= dp[4 * j + e] - dl_s[st][col];  // dS^T
        }
      pack_a<kStep>(da, s);
    }
    wgmma_fence();
    if constexpr (do_dv) mma_pv<DV, kStep / 16>(dva, pa, dOs, L::kStepSubV);  // dV += P^T dO
    if constexpr (do_dk) mma_pv<D, kStep / 16>(dka, da, Qs, L::kStepSubD);    // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (do_dv) fence_regs(dva);
    if constexpr (do_dk) fence_regs(dka);
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = key0 + 8 * r;
    if (t >= Skv) continue;
    if constexpr (do_dk) {
      __nv_bfloat16* row = dk + (((size_t)b * Skv + t) * K + kh) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * tq) = __floats2bfloat162_rn(
            dka[4 * j + 2 * r] * scale, dka[4 * j + 2 * r + 1] * scale);
    }
    if constexpr (do_dv) {
      __nv_bfloat16* row = dv + (((size_t)b * Skv + t) * K + kh) * DV;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
  }
}

template <int D, int DV, int kParts>
cudaError_t launch_dkv(const CUtensorMap& q_step, const CUtensorMap& k_big,
                       const CUtensorMap& v_big, const CUtensorMap& do_step, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int Sq, int Skv, int H,
                       int K, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = Smem<D, DV>::kBytes;
  auto kern = dkv_sm90<D, DV, kParts>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((Skv + kBig - 1) / kBig, K, B), kThreads, smem, stream>>>(
      q_step, k_big, v_big, do_step, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Skv, H, K, causal, scale);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, void* dq, void* dk, void* dv, float* delta, int B, int Sq,
                   int Skv, int H, int K, int causal, float scale, cudaStream_t stream) {
  using sm90::make_map;
  constexpr size_t smem = Smem<D, DV>::kBytes;
  using bf = __nv_bfloat16;
  // the dQ kernel owns 128 query rows and streams 64 key rows; dK/dV the other way
  CUtensorMap q_big, do_big, k_step, v_step, k_big, v_big, q_step, do_step;
  if (!make_map<D>(&q_big, q, B, Sq, H, kBig) || !make_map<DV>(&do_big, dout, B, Sq, H, kBig) ||
      !make_map<D>(&k_step, k, B, Skv, K, kStep) || !make_map<DV>(&v_step, v, B, Skv, K, kStep) ||
      !make_map<D>(&k_big, k, B, Skv, K, kBig) || !make_map<DV>(&v_big, v, B, Skv, K, kBig) ||
      !make_map<D>(&q_step, q, B, Sq, H, kStep) || !make_map<DV>(&do_step, dout, B, Sq, H, kStep))
    return cudaErrorInvalidValue;
  auto kq = dq_sm90<D, DV>;
  cudaError_t err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kq<<<dim3((Sq + kBig - 1) / kBig, H, B), kThreads, smem, stream>>>(
      q_big, k_step, v_step, do_big, static_cast<const bf*>(o), static_cast<const bf*>(dout),
      lse, static_cast<bf*>(dq), delta, Sq, Skv, H, K, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dK and dV together while their accumulators, D / 2 + Dv / 2 registers
  // a thread, stay within 128 (up to D = Dv = 128); else one pass each
  if constexpr (D / 2 + DV / 2 <= 128) {
    return launch_dkv<D, DV, kDK | kDV>(q_step, k_big, v_big, do_step, lse, delta, dk, dv, B,
                                        Sq, Skv, H, K, causal, scale, stream);
  } else {
    err = launch_dkv<D, DV, kDV>(q_step, k_big, v_big, do_step, lse, delta, dk, dv, B, Sq, Skv,
                                 H, K, causal, scale, stream);
    if (err != cudaSuccess) return err;
    return launch_dkv<D, DV, kDK>(q_step, k_big, v_big, do_step, lse, delta, dk, dv, B, Sq, Skv,
                                  H, K, causal, scale, stream);
  }
}

}  // namespace tc

// The (D, Dv) pairs built, as in the forward: D = Dv in {32, 64, 128}, and
// MLA's (192, 128) and (48, 32).
template <typename F>
cudaError_t dispatch_dims(int D, int Dv, F&& f) {
  if (D == Dv) {
    switch (D) {
      case 32: return f(std::integral_constant<int, 32>{}, std::integral_constant<int, 32>{});
      case 64: return f(std::integral_constant<int, 64>{}, std::integral_constant<int, 64>{});
      case 128: return f(std::integral_constant<int, 128>{}, std::integral_constant<int, 128>{});
      default: return cudaErrorInvalidValue;
    }
  }
  if (D == 192 && Dv == 128)
    return f(std::integral_constant<int, 192>{}, std::integral_constant<int, 128>{});
  if (D == 48 && Dv == 32)
    return f(std::integral_constant<int, 48>{}, std::integral_constant<int, 32>{});
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_d(int D, int Dv, int dtype, const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse, void* dq, void* dk,
                       void* dv, float* delta, int B, int Sq, int Skv, int H, int K, int causal,
                       float scale, cudaStream_t s) {
  if (dtype == kFloat32)
    return dispatch_dims(D, Dv, [&](auto d, auto dvv) {
      return launch<float, decltype(d)::value, decltype(dvv)::value>(
          q, k, v, o, dout, lse, dq, dk, dv, delta, B, Sq, Skv, H, K, causal, scale, s);
    });
  if (dtype == kBFloat16)
    return dispatch_dims(D, Dv, [&](auto d, auto dvv) {
      return tc::launch<decltype(d)::value, decltype(dvv)::value>(
          q, k, v, o, dout, lse, dq, dk, dv, delta, B, Sq, Skv, H, K, causal, scale, s);
    });
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// q, dq: (B, Sq, H, D); o, dout: (B, Sq, H, Dv); k, dk: (B, Skv, K, D);
// v, dv: (B, Skv, K, Dv), all in `dtype`, contiguous and 16-byte aligned,
// H % K == 0, (D, Dv) a pair that `dispatch_dims` builds.  lse: the
// forward's (B, H, Sq) float32 logsumexp; delta: (B, H, Sq) float32 scratch.
// Launches the dQ kernel, then the dK/dV kernel (or its two passes), on
// `stream`; allocates nothing; returns the first cudaError_t (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* dq, void* dk,
                                   void* dv, void* delta, int B, int Sq, int Skv, int H, int K,
                                   int D, int Dv, int causal, float scale, int dtype,
                                   void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || K <= 0 || H % K != 0)
    return cudaErrorInvalidValue;
  return dispatch_d(D, Dv, dtype, q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
                    static_cast<float*>(delta), B, Sq, Skv, H, K, causal, scale,
                    static_cast<cudaStream_t>(stream));
}
