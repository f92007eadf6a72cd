// Flash attention forward (prefill self-attention) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention() and its
// Pallas body _kernel() -- softmax(scale * Q K^T) V with an f32 online
// softmax, GQA (query head h reads kv head h / (H / K)), and a causal mask
// aligned to the end (query i sits at key position i + Skv - Sq).
//
// Head dims: the query / key head D and the value head Dv are template
// arguments.  D = Dv in {32, 64, 128}, and the two pairs of multi-head latent
// attention's prefill (deepseek-v2): D = 192, Dv = 128 (d_nope + d_rope,
// d_v) and its reduced sibling's D = 48, Dv = 32.  The Pallas kernel assumes
// Dv = D; with Dv != D only the P V product and the output narrow.
//
// What bounds it on the H100: causal attention does about S/2 FLOP per byte
// of Q, K, V and O in bf16 (D = 128).  At the serving shapes (S = 384..512)
// that is 150..205 FLOP/byte, just under the 295 FLOP/byte ridge of the
// tensor cores, so the bytes bound it (25 us at B = 8, S = 512, H = 32);
// from S of about 600 the operations do (35 us at the zamba2 block's
// B = 2, S = 2048, H = 32, D = 64).  Both bounds assume the tensor cores.
//
// bfloat16 (every main path), `fwd_sm90`:
//   * a persistent grid, one CTA per SM, each walking (128-row query tile,
//     query head, batch) tiles heaviest first; a CTA is a producer
//     warpgroup, of which one thread issues TMA loads, and two consumer
//     warpgroups of 64 query rows each; setmaxnreg gives the consumers 240
//     registers a thread and leaves the producer 24;
//   * the producer loads a tile's Q, then streams 128-row K/V tiles into a
//     shared-memory ring (2 stages from D = 128, 3 below; "full" / "empty"
//     mbarriers per stage), and loads the next tile's Q and K/V as soon as
//     the consumers release them, so copies overlap the arithmetic and one
//     tile's epilogue; TMA writes each tile with the 128-byte swizzle
//     (64-byte for a head of 32, 32-byte for 48) that the wgmma descriptors
//     read, and zero-fills rows past S;
//   * S = Q K^T is wgmma (m64n128k16) with both operands in shared memory,
//     K-major; the online softmax runs on the accumulator fragment in
//     registers (row max and sum over the 4 lanes of a row, exp2 with
//     scale * log2(e) folded in, f32 m and l); P is rounded to bf16 in
//     registers and is the register A operand of O += P V, whose
//     accumulator layout is the A layout of the next product; V is the
//     MN-major B operand;
//   * K/V tile j issues S_j together with P_{j-1} V_{j-1}, so the softmax
//     of tile j overlaps the product of tile j - 1 (no wgmma is issued
//     under a branch: ptxas would serialize them all);
//   * the loop stops at the causal diagonal and only edge tiles (diagonal
//     or past Skv) are masked;
//   * a row with no key writes O = 0 and lse = +inf.
// float32 keeps the SIMT kernel below (`flash_attention_kernel`): its
// callers hold it at 1e-4 of the f32 plain version, which TF32 tensor-core
// products (10-bit mantissa) cannot meet, and no main path runs f32 at
// full width.  It widens tiles into shared f32 and multiplies on the FMA
// pipe: each thread owns a 4 x 4 block of the score tile and a 4 x Dv/16
// block of the accumulator; its limit is the f32 SIMT peak (67 TFLOP/s).
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace repro_torch {
namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBKV = 64;       // key/value rows per inner step
constexpr int kThreads = 256;  // 16 x 16 threads: ty picks 4 rows, tx 4 columns

template <int D, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBKV * (D + 1) + kBKV * DV + kBQ * (kBKV + 1));
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                       int Sq, int Skv, int H, int K, int causal, float scale) {
  constexpr int QS = D + 1, KS = D + 1, VS = DV, PS = kBKV + 1;
  constexpr int C = DV / 16;  // accumulator columns per thread
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
  const T* vb = v + ((size_t)b * Skv * K + kh) * DV;

  for (int t0 = 0; t0 < kv_end; t0 += kBKV) {
    __syncthreads();  // the previous tile is consumed
    load_rows<T, D, kThreads>(Ks, KS, kb, (size_t)K * D, t0, kBKV, Skv);
    load_rows<T, DV, kThreads>(Vs, VS, vb, (size_t)K * DV, t0, kBKV, Skv);
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
    T* orow = o + (((size_t)b * Sq + qi) * H + h) * DV;
#pragma unroll
    for (int c = 0; c < C; ++c) orow[tx + 16 * c] = from_float<T>(acc[i][c] * inv);
  }
}

template <typename T, int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Skv, int H, int K, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, DV>();
  auto kern = flash_attention_kernel<T, D, DV>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(o), lse, Sq,
                                         Skv, H, K, causal, scale);
  return cudaGetLastError();
}

// ------------------------------------------------ bfloat16: wgmma + TMA
namespace tc {

constexpr int kBQ = 128;       // query rows per tile: 64 per consumer warpgroup
constexpr int kBKV = 128;      // key/value rows per ring stage
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups

template <int D, int DV>
struct Smem {  // Q | ring of (K, V) stages, each tile 1024-byte aligned
  using T = sm90::Tile<D>;
  using TV = sm90::Tile<DV>;
  static constexpr int kStages = D >= 128 ? 2 : 3;
  static constexpr uint32_t kQ = T::bytes(kBQ), kK = T::bytes(kBKV), kV = TV::bytes(kBKV);
  static constexpr uint32_t kQSub = T::sub_bytes(kBQ), kKSub = T::sub_bytes(kBKV),
                            kVSub = TV::sub_bytes(kBKV);
  static constexpr size_t kBytes = 1024 + kQ + kStages * (kK + kV);  // + alignment slack
  static_assert(kBytes <= 227 * 1024, "shared memory");
};

// The tiles of one launch, heaviest causal tiles first: tile t is query
// tile n_qt - 1 - t / (H B) of head (t % (H B)) % H and batch (t % (H B)) / H.
struct Tiles {
  int n_qt, H, B, Sq, Skv, causal;
  __device__ int count() const { return n_qt * H * B; }
  __device__ void at(int t, int& q0, int& h, int& b, int& n_kv) const {
    const int hb = H * B, r = t % hb;
    q0 = (n_qt - 1 - t / hb) * kBQ;
    h = r % H;
    b = r / H;
    int kv_end = Skv;  // the loop stops at the causal diagonal
    if (causal) kv_end = min(Skv, max(0, min(q0 + kBQ, Sq) + Skv - Sq));
    n_kv = (kv_end + kBKV - 1) / kBKV;
  }
};

// The online softmax of one (64 x N) score tile in its accumulator fragment
// (rows row0, row0 + 8; keys t0 + 8 jj + 2 tq + (0, 1)): masks the edge
// tiles (past Skv, or past some row's diagonal), updates the row max m and
// this lane's part of the row sum l, leaves exp(scale (s - m)) in s and
// the factor for the old accumulator in alpha.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int t0, int row0, int wrow,
                                             int Skv, int causal, int shift, int tq, float sl2) {
  if (t0 + N > Skv || (causal && t0 + N - 1 > wrow + shift)) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int key = t0 + 8 * (i >> 2) + 2 * tq + (i & 1);
      if (key >= Skv || (causal && key > row0 + 8 * ((i >> 1) & 1) + shift)) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY}, nb[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    const float base = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
    alpha[r] = sm90::ex2((m[r] - base) * sl2);
    nb[r] = -base * sl2;
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    s[i] = sm90::ex2(fmaf(s[i], sl2, nb[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

// Persistent: each CTA walks tiles blockIdx.x, blockIdx.x + gridDim.x, ...,
// so the producer loads the next tile's Q and K/V while the consumers
// finish this one.
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
fwd_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
         const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
         float* __restrict__ lse, Tiles tiles, int K, float scale) {
  using namespace sm90;
  using L = Smem<D, DV>;
  constexpr int kS = L::kStages, kRB = Tile<D>::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, q_empty, full[kS], empty[kS];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* KV = Qs + L::kQ;  // stage s: K at KV + s (kK + kV), V after it
  const int H = tiles.H, Sq = tiles.Sq, Skv = tiles.Skv, causal = tiles.causal;
  const int shift = Skv - Sq;  // query i sits at key position i + shift
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, 2 * 128);
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);  // every consumer thread releases a stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<24>();
    if (tid == 0) {
      int it = 0, n = 0;  // K/V stages and tiles loaded so far
      for (int t = blockIdx.x; t < tiles.count(); t += gridDim.x, ++n) {
        int q0, h, b, n_kv;
        tiles.at(t, q0, h, b, n_kv);
        const int kh = h / (H / K);
        mbar_wait(&q_empty, (n & 1) ^ 1);  // the consumers are done with the last Q
        mbar_arrive_expect_tx(&q_full, L::kQ);
        tma_tile<D>(Qs, L::kQSub, &tm_q, &q_full, h, q0, b);
        for (int j = 0; j < n_kv; ++j, ++it) {
          const int st = it % kS;
          mbar_wait(&empty[st], ((it / kS) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], L::kK + L::kV);
          uint8_t* Ks = KV + st * (L::kK + L::kV);
          tma_tile<D>(Ks, L::kKSub, &tm_k, &full[st], kh, j * kBKV, b);
          tma_tile<DV>(Ks + L::kK, L::kVSub, &tm_v, &full[st], kh, j * kBKV, b);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int c = tid / 128 - 1;  // consumer warpgroup: tile rows 64 c .. 64 c + 63
  const int lt = tid % 128, g = (lt % 32) / 4, tq = lt % 4;
  const int roff = 64 * c + 16 * (lt / 32) + g;  // this thread's rows: q0 + roff (+ 8)
  const float sl2 = scale * kLog2e;
  const uint8_t* Qw = Qs + 64 * c * kRB;
  auto Kst = [&](int it) { return KV + (it % kS) * (L::kK + L::kV); };  // K of stage it
  auto Vst = [&](int it) { return Kst(it) + L::kK; };                      // V of stage it


  int it = 0, n = 0;
  for (int t = blockIdx.x; t < tiles.count(); t += gridDim.x, ++n) {
    int q0, h, b, n_kv;
    tiles.at(t, q0, h, b, n_kv);
    const int row0 = q0 + roff, wrow = q0 + 64 * c;

    float acc[DV / 2], s[kBKV / 2];
    uint32_t p[kBKV / 4];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    mbar_wait(&q_full, n & 1);
    if (n_kv == 0) {
      mbar_arrive(&q_empty);
    } else {
      // Tile j >= 1 issues S_j = Q K_j^T together with O += P_{j-1} V_{j-1},
      // so the softmax of S_j overlaps the P V product of the tile before;
      // tile 0 issues S_0 alone and the last P V follows the loop.
      mbar_wait(&full[it % kS], (it / kS) & 1);
      wgmma_fence();
      mma_abt<D, kBKV>(s, Qw, L::kQSub, Kst(it), L::kKSub);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if (n_kv == 1) mbar_arrive(&q_empty);  // the last read of Q is done
      softmax_tile<kBKV>(s, m, l, alpha, 0, row0, wrow, Skv, causal, shift, tq, sl2);
      pack_a<kBKV>(p, s);
      for (int j = 1; j < n_kv; ++j) {
        ++it;
        mbar_wait(&full[it % kS], (it / kS) & 1);
          wgmma_fence();  // p and acc were written outside wgmma
        mma_abt<D, kBKV>(s, Qw, L::kQSub, Kst(it), L::kKSub);
        wgmma_commit();
        mma_pv<DV, kBKV / 16>(acc, p, Vst(it - 1), L::kVSub);
        wgmma_commit();
          wgmma_wait<1>();  // S_j is in; P_{j-1} V_{j-1} may still run
        fence_regs(s);
        if (j == n_kv - 1) mbar_arrive(&q_empty);
        softmax_tile<kBKV>(s, m, l, alpha, j * kBKV, row0, wrow, Skv, causal, shift, tq, sl2);
        wgmma_wait<0>();  // P_{j-1} V_{j-1} is in: its stage is free
        fence_regs(acc);
        fence_regs(p);
        mbar_arrive(&empty[(it - 1) % kS]);
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        pack_a<kBKV>(p, s);
      }
      wgmma_fence();
      mma_pv<DV, kBKV / 16>(acc, p, Vst(it), L::kVSub);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[it % kS]);
      ++it;
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int qi = row0 + 8 * r;
      if (qi >= Sq) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      __nv_bfloat16* orow = o + (((size_t)b * Sq + qi) * H + h) * DV;
#pragma unroll
      for (int jj = 0; jj < DV / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj + 2 * tq) =
            __floats2bfloat162_rn(acc[4 * jj + 2 * r] * inv, acc[4 * jj + 2 * r + 1] * inv);
      // per-row logsumexp of the scaled scores, for the backward; a row with
      // no key gets +inf, so exp(s - lse) is 0 there
      if (lse && tq == 0)
        lse[((size_t)b * H + h) * Sq + qi] = l[r] > 0.f ? m[r] * scale + logf(l[r]) : INFINITY;
    }
  }
}

template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Skv, int H, int K, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  if (!sm90::make_map<D>(&tm_q, q, B, Sq, H, kBQ) ||
      !sm90::make_map<D>(&tm_k, k, B, Skv, K, kBKV) ||
      !sm90::make_map<DV>(&tm_v, v, B, Skv, K, kBKV))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Smem<D, DV>::kBytes;
  auto kern = fwd_sm90<D, DV>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const Tiles tiles{(Sq + kBQ - 1) / kBQ, H, B, Sq, Skv, causal};
  const int n_tiles = tiles.n_qt * H * B;
  kern<<<n_tiles < sms ? n_tiles : sms, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, tiles, K, scale);
  return cudaGetLastError();
}

}  // namespace tc

// The (D, Dv) pairs built: D = Dv in {32, 64, 128}, and MLA's (192, 128)
// and (48, 32).
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
                       void* o, float* lse, int B, int Sq, int Skv, int H, int K, int causal,
                       float scale, cudaStream_t s) {
  if (dtype == kFloat32)
    return dispatch_dims(D, Dv, [&](auto d, auto dv) {
      return launch<float, decltype(d)::value, decltype(dv)::value>(
          q, k, v, o, lse, B, Sq, Skv, H, K, causal, scale, s);
    });
  if (dtype == kBFloat16)
    return dispatch_dims(D, Dv, [&](auto d, auto dv) {
      return tc::launch<decltype(d)::value, decltype(dv)::value>(
          q, k, v, o, lse, B, Sq, Skv, H, K, causal, scale, s);
    });
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// q: (B, Sq, H, D), k: (B, Skv, K, D), v: (B, Skv, K, Dv), o: (B, Sq, H, Dv),
// all contiguous and 16-byte aligned, H % K == 0, (D, Dv) a pair that
// `dispatch_dims` builds.  lse, if not null, receives the per-row
// logsumexp of the scaled scores, (B, H, Sq) float32, for the backward.
// Launches on `stream`, allocates nothing, and returns the cudaError_t of
// the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int Sq, int Skv, int H, int K, int D,
                                   int Dv, int causal, float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Sq <= 0 || H <= 0 || K <= 0 || H % K != 0 || Skv < 0)
    return cudaErrorInvalidValue;
  return dispatch_d(D, Dv, dtype, q, k, v, o, static_cast<float*>(lse), B, Sq, Skv, H, K,
                    causal, scale, static_cast<cudaStream_t>(stream));
}
