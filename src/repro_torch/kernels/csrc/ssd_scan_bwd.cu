// Mamba-2 SSD chunked scan, backward, bfloat16, on the Hopper tensor cores
// (sm_90a): the chunk-parallel decomposition of the gradient.
//
// Replaces: the gradient of src/repro/kernels/ssd_scan.py, ssd_scan() (the
// Pallas kernel has no VJP; the reference's gradient is autodiff of the jnp
// path, src/repro/kernels/ops.py:269 _ssd_jnp), in bfloat16 (float32 keeps
// the SIMT backward of ssd_scan.cu).  Per (batch b, head h) and chunk k,
// with cs = cumsum(dt * A) inside the chunk, total = cs_last, the gate
// G[t,u] = exp(cs_t - cs_u) for u <= t (else 0), S_{k-1} the state entering
// the chunk and dS_k the gradient of the state leaving it:
//   ds_k   = (C o exp(cs))^T dY                      (n x p per chunk)
//   dS_{k-1} = exp(total_k) dS_k + ds_k,  dtot_k = exp(total_k) <S_{k-1}, dS_k>
//   K = (C B^T) o G,  E = G o dt_u o (dY X^T),  Z = K o (dY X^T)
//   dx_u = dt_u (K^T dY + exp(total - cs_u) B_u dS_k)_u + D dy_u
//   dB_u = sum_h (E^T C + exp(total - cs_u) dt_u X dS_k^T)_u
//   dC_t = sum_h (E B + exp(cs_t) dY S_{k-1}^T)_t
//   ddd_u = sum_t Z[t,u] + Pn_u,  Pn_u = exp(total - cs_u) <B_u dS_k, x_u>
//   dcs_t = sum_u Z[t,u] dt_u + exp(cs_t) <C_t, S_{k-1} dy_t> - dt_t ddd_t
//           (+ dtot_k + sum_u dt_u Pn_u at the last row)
//   ddt = ddd + A acc,  dA = sum dt acc,  acc_i = sum_{j >= i} dcs_j
// The split is Dao & Gu, "Transformers are SSMs" (2024), section 6, as
// mamba_ssm's backward runs it (chunk states, state passing, then the
// chunks in parallel):
//   1. ssd_dstate_sm90, one warpgroup per (head, chunk, batch): on wgmma
//      (transposed A, as the forward's ssd_state_sm90), the chunk's state
//      contribution s_k and its gradient's ds_k, into f32 scratch, and the
//      chunk's cs and dt per row for the kernels below;
//   2. ssd_dpass, one thread per (batch, head, 1 or 2 state elements),
//      sequential over the chunks only: the entering states S_{k-1}
//      forward, then dS in reverse, each written as a bf16 pair (high and
//      low half) for the products, dtot_k's partial sums per warp;
//   3. ssd_bwd_dx_sm90, one CTA per (group of heads, chunk and batch,
//      64-row u tile): per head, B_u dS and X_u dS^T, then for every t tile
//      at or after u, C B^T and X dY^T (u-major) on wgmma, K, E and Z formed
//      in f32 registers (0 by construction outside the causal pairs), K^T
//      dY into dx and E^T C into dB, which sums the group's heads in one
//      accumulator; dx written in bf16, the Z column sums and Pn per row;
//   4. ssd_bwd_dc_sm90, one CTA per (group of heads, chunk and batch, 64-row
//      t tile): per head, dY S^T, then for every u tile up to t, C B^T and
//      dY X^T (t-major), E B into dC, summed over the group's heads; the
//      rows' Z sums and the inter-chunk dcs term;
//   5. ssd_bwd_dt, one warp per (batch, chunk, head): the reverse cumsum of
//      dcs, ddt, and the dA partial;
//   6. ssd_bwd_groups, one thread per element of dB and dC: the head groups'
//      partials summed in order, in bf16; and dA and dD from their partials
//      per chunk.
// Every sum runs in a fixed order, no atomics: two calls give the same bits.
//
// What bounds it on the H100: bytes.  x, dy and dx (b, s, h, p) in bf16
// dominate: about 0.0313 ms at zamba2-1.2b's microbatch (b = 2, s = 2048,
// h = 64, p = n = 64, chunk 256); the products, some 30 GFLOP, take 0.03 ms
// at the bf16 peak.  What the design does about the four limits of the
// SIMT backward (ssd_scan.cu) that it replaces for bf16:
//   * its grid of b * h = 128 CTAs: these grids are groups * b * nc * tiles
//     (512 CTAs of 8 heads each at zamba2's shape), heavy tiles first;
//   * its two sequential walks over the chunks (a state recompute, then the
//     chunks in reverse): the states are recomputed chunk-parallel on the
//     tensor cores, and only the state passes (2) are sequential, over
//     (n x p) elements;
//   * its SIMT f32 products: every product is on wgmma;
//   * its per-head (b, s, h, n) f32 dB and dC partials: the heads of a group
//     are summed in registers, so the partials are (b, s, groups, n).
// What holds it back now: inside a CTA each head's tiles load, then its
// products run (two CTAs an SM overlap one's loads with the other's
// products), and the per-head work outside the causal pairs (the loads, the
// state products, the dx epilogue) costs about as much as the pairs'
// products (PERF.md, PR 15's ablation).
//
// Precision: ddt and dA are small differences of large sums.  The bf16
// forward's own entering states round B o g and S_{k-1} to bf16, which moved
// dA by up to 5e-2 of its scale in the CPU emulation
// (tests/test_torch_ssm.py, _ssd_bwd_split), so they are recomputed here
// with B o g, C o exp(cs), S_{k-1} and dS each as a bf16 pair (two products
// each, about 16 bits); K and E are rounded to bf16 once.  Z, the cumsum,
// dtot, ddt, dA and dD stay in f32.  Operands are the forward's
// (ssd_sm90.cuh): 64-row bf16 tiles in the 128-byte swizzle, by TMA at
// n = p = 64 and by cp.async otherwise, rows past the chunk holding the next
// chunk's values (or 0 past s), masked by the gate.
#include "ssd_sm90.cuh"

namespace repro_torch {
namespace {

// Eight floats to bf16, high half and the low half of what remains.
__device__ __forceinline__ void split_bf16(const float (&f)[8], uint4& hi, uint4& lo) {
  uint32_t* ph = &hi.x;
  uint32_t* pl = &lo.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    ph[i] = *reinterpret_cast<const uint32_t*>(&v);
    pl[i] = sm90::pack_bf16(f[2 * i] - __low2float(v), f[2 * i + 1] - __high2float(v));
  }
}

// The bf16 pair at (row r, columns c and c + 1, c even) of a swizzled tile,
// as floats: an accumulator's columns 2c' and 2c' + 1 in one load.
__device__ __forceinline__ float2 tile_pair(const uint8_t* tile, int r, int c) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(tile + swz(r, c / 8) + 2 * (c % 8)));
}

// The gate exp(cs_t - cs_u), the difference taken first: exact for nearby
// rows, whose gates are near 1 and whose Z terms cancel between the row
// and the column sums of dcs (a cumsum hundreds below 0 scaled by log2(e)
// first would round each gate by ~1e-4).  Both product kernels form their
// gates and Z terms the same way, so that the two sums cancel as in f32.
__device__ __forceinline__ float gate(float cs_t, float cs_u) {
  return sm90::ex2((cs_t - cs_u) * sm90::kLog2e);
}

// Sum over the four lanes that share an accumulator row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------ 1. chunk states and chunk state gradients
// One warpgroup per (head, chunk, batch), over the chunk's rows kTS tiles at
// a time: the chunk's state contribution s_k = (B o g)^T X, g_u =
// exp(total - cs_u) dt_u (the forward's ssd_state_sm90, computed again),
// and its gradient's ds_k = (C o exp(cs))^T dY.  B and C land raw and are
// scaled in place into bf16 pairs (high half Bh / Ch, low half Bl / Cl), so
// both products keep about 16 bits.
constexpr int kTS = 2;  // 64-row tiles a block (six tiles of each: 96 KB)

__global__ void __launch_bounds__(kWG)
ssd_dstate_sm90(const __grid_constant__ CUtensorMap tm_b, const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_c, const __grid_constant__ CUtensorMap tm_dy,
                const bf16* __restrict__ Bm, const bf16* __restrict__ x,
                const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                const float* __restrict__ dt, const float* __restrict__ A,
                float* __restrict__ sk, float* __restrict__ ds, float* __restrict__ totals,
                float* __restrict__ csb, float* __restrict__ dtb, int S, int H, int N, int P,
                int chunk, int use_tma) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cs[kMaxChunk], dts[kMaxChunk];
  __shared__ uint64_t bar;  // TMA: a block's tiles have landed
  uint8_t* Bh = align1024(smem_raw);  // kTS tiles each, rows t: MN-major A ...
  uint8_t* Bl = Bh + kTS * kTile;
  uint8_t* Ch = Bl + kTS * kTile;
  uint8_t* Cl = Ch + kTS * kTile;
  uint8_t* Xs = Cl + kTS * kTile;     // ... and MN-major B
  uint8_t* Ys = Xs + kTS * kTile;
  const int h = blockIdx.x, k = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int c0 = k * chunk, tid = threadIdx.x;
  const size_t xs = (size_t)H * P, bkh = ((size_t)b * nc + k) * H + h;
  const bool vec_n = N % 8 == 0, vec_p = P % 8 == 0;

  auto load_t = [&](int t0) {  // the raw B, C, x and dy tiles of the block at row t0
    if (use_tma) {
      if (tid == 0) {
        const int nt = min(kTS, (chunk - t0 + kT - 1) / kT);
        mbar_arrive_expect_tx(&bar, 4 * nt * kTile);
        for (int j = 0; j < nt; ++j) {
          const int r0 = c0 + t0 + j * kT;
          tma_tile<64>(Bh + j * kTile, kTile, &tm_b, &bar, 0, r0, b);
          tma_tile<64>(Ch + j * kTile, kTile, &tm_c, &bar, 0, r0, b);
          tma_tile<64>(Xs + j * kTile, kTile, &tm_x, &bar, h, r0, b);
          tma_tile<64>(Ys + j * kTile, kTile, &tm_dy, &bar, h, r0, b);
        }
      }
      return;
    }
    for (int j = 0; j < kTS; ++j) {
      const int r0 = t0 + j * kT, tr = max(0, min(kT, chunk - r0));
      const size_t row = (size_t)b * S + c0 + r0;
      stage_tile(Bh + j * kTile, Bm + row * N, N, tr, N, vec_n, tid, kWG);
      stage_tile(Ch + j * kTile, Cm + row * N, N, tr, N, vec_n, tid, kWG);
      stage_tile(Xs + j * kTile, x + row * xs + (size_t)h * P, xs, tr, P, vec_p, tid, kWG);
      stage_tile(Ys + j * kTile, dy + row * xs + (size_t)h * P, xs, tr, P, vec_p, tid, kWG);
    }
  };
  if (tid == 0) {
    mbar_init(&bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  load_t(0);  // in flight while the gates are computed
  gates(dts, cs, dt + ((size_t)b * S + c0) * H + h, H, A[h], chunk);
  for (int i = tid; i < chunk; i += kWG) {
    csb[bkh * chunk + i] = cs[i];
    dtb[bkh * chunk + i] = dts[i];
  }
  const float total = cs[chunk - 1];
  if (tid == 0) totals[bkh] = total;

  float accs[32], accd[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) accs[i] = accd[i] = 0.f;
  for (int t0 = 0, ph = 0; t0 < chunk; t0 += kTS * kT, ph ^= 1) {
    if (t0 > 0) {
      __syncthreads();  // the last block's products are done
      load_t(t0);
    }
    const int nt = min(kTS, (chunk - t0 + kT - 1) / kT);  // tiles inside the chunk
    if (use_tma)
      mbar_wait(&bar, ph);
    else
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // B rows times g_t and C rows times exp(cs_t), each as a bf16 pair; 0 past the chunk
    for (int e = tid; e < nt * kT * 8; e += kWG) {
      const int r = e / 8, t = t0 + r;
      const uint32_t off = (r / kT) * kTile + swz(r % kT, e % 8);
      const bool ok = t < chunk;
      const float sb = ok ? expf(total - cs[t]) * dts[t] : 0.f, sc = ok ? expf(cs[t]) : 0.f;
      float fb[8], fc[8];
      load_vec<8>(reinterpret_cast<const bf16*>(Bh + off), fb);
      load_vec<8>(reinterpret_cast<const bf16*>(Ch + off), fc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        fb[i] *= sb;
        fc[i] *= sc;
      }
      split_bf16(fb, *reinterpret_cast<uint4*>(Bh + off), *reinterpret_cast<uint4*>(Bl + off));
      split_bf16(fc, *reinterpret_cast<uint4*>(Ch + off), *reinterpret_cast<uint4*>(Cl + off));
    }
    tiles_ready();
    wgmma_fence();
    for (int j = 0; j < nt; ++j) {
      const uint32_t o = j * kTile;
      const uint64_t dbh = make_desc(Bh + o, 128), dbl = make_desc(Bl + o, 128);
      const uint64_t dch = make_desc(Ch + o, 128), dcl = make_desc(Cl + o, 128);
      const uint64_t dx = make_desc(Xs + o, 128), dyd = make_desc(Ys + o, 128);
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {  // 16 rows of t a k-step
        const uint32_t a = kk * 16 * 128;
        wgmma_64x64_ss<1, 1>(accs, desc_add(dbh, a), desc_add(dx, a), 1);
        wgmma_64x64_ss<1, 1>(accs, desc_add(dbl, a), desc_add(dx, a), 1);
        wgmma_64x64_ss<1, 1>(accd, desc_add(dch, a), desc_add(dyd, a), 1);
        wgmma_64x64_ss<1, 1>(accd, desc_add(dcl, a), desc_add(dyd, a), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(accs);
    fence_regs(accd);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int n = frag_row(tid, i), p = frag_col(tid, i);
    if (n < N && p < P) {
      sk[bkh * N * P + n * P + p] = accs[i];
      ds[bkh * N * P + n * P + p] = accd[i];
    }
  }
}

// ------------------------------------------------------- 2. state passes
// One thread per (batch, head, V state elements), in f32, sequential over
// the chunks only.  Forward: S_{k-1}, the state entering chunk k (0 for the
// first), is written as a bf16 pair (Sh, Sl), then S_k = exp(total_k)
// S_{k-1} + s_k.  Reverse: dS_k (the gradient of the state leaving chunk k;
// 0 for the last) is written as a bf16 pair, each warp's share of dtot_k =
// exp(total_k) <S_{k-1}, dS_k> (S_{k-1} read back as its pair) goes to
// dtotp[b, k, h, 8 blockIdx.x + warp] (a shuffle sum in a fixed order), then
// dS_{k-1} = exp(total_k) dS_k + ds_k.  Loads of 8 chunks are issued
// together; nothing synchronises the block.  V = 2 where n p is even
// (8-byte f32 and 4-byte bf16 accesses), else 1.
constexpr int kPassThreads = 256;

template <int V>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x, v[1] = f.y;
  } else {
    v[0] = *p;
  }
}

// v as a bf16 pair: the high half at hi[0..V), the low half of the rest at lo.
template <int V>
__device__ __forceinline__ void store_pair(bf16* hi, bf16* lo, const float (&v)[V]) {
  float h[V], l[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    h[i] = __bfloat162float(__float2bfloat16_rn(v[i]));
    l[i] = v[i] - h[i];
  }
  if constexpr (V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(hi) = __floats2bfloat162_rn(h[0], h[1]);
    *reinterpret_cast<__nv_bfloat162*>(lo) = __floats2bfloat162_rn(l[0], l[1]);
  } else {
    *hi = __float2bfloat16_rn(h[0]);
    *lo = __float2bfloat16_rn(l[0]);
  }
}

template <int V>
__global__ void __launch_bounds__(kPassThreads)
ssd_dpass(const float* __restrict__ sk, const float* __restrict__ ds,
          const float* __restrict__ totals, bf16* Sh, bf16* Sl, bf16* __restrict__ dSh,
          bf16* __restrict__ dSl, float* __restrict__ dtotp, int nc, int H, int NP) {
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * V, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, part_at = blockIdx.x * kPassThreads / 32 + threadIdx.x / 32;
  const int parts = gridDim.x * kPassThreads / 32;
  const bool live = e < NP;  // the others join the warp sums; V = 2 has NP even
  auto at = [&](int k) { return (((size_t)b * nc + k) * H + h) * NP + e; };
  float run[V];
#pragma unroll
  for (int v = 0; v < V; ++v) run[v] = 0.f;
  for (int k0 = 0; k0 < nc; k0 += 8) {  // forward: chunks k0 to k0 + 7
    float sv[8][V], dv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = min(k0 + i, nc - 1);
      if (k0 + i < nc && live)
        load_f32<V>(sk + at(k), sv[i]);
      else
#pragma unroll
        for (int v = 0; v < V; ++v) sv[i][v] = 0.f;
      dv[i] = expf(totals[((size_t)b * nc + k) * H + h]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (k0 + i >= nc) break;  // uniform over the block
      if (live) store_pair<V>(Sh + at(k0 + i), Sl + at(k0 + i), run);
#pragma unroll
      for (int v = 0; v < V; ++v) run[v] = fmaf(run[v], dv[i], sv[i][v]);
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) run[v] = 0.f;
  for (int k1 = nc; k1 > 0; k1 -= 8) {  // reverse: chunks k1 - 1 down to k1 - 8
    float sv[8][V], pv[8][V], dv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = max(k1 - 1 - i, 0);
      const bool ok = k1 - 1 - i >= 0 && live;
#pragma unroll
      for (int v = 0; v < V; ++v) sv[i][v] = pv[i][v] = 0.f;
      if (ok) {
        load_f32<V>(ds + at(k), sv[i]);
#pragma unroll
        for (int v = 0; v < V; ++v)  // S_{k-1}, as this thread wrote it above
          pv[i][v] = __bfloat162float(Sh[at(k) + v]) + __bfloat162float(Sl[at(k) + v]);
      }
      dv[i] = expf(totals[((size_t)b * nc + k) * H + h]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = k1 - 1 - i;
      if (k < 0) break;  // uniform over the block
      float part = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) part = fmaf(pv[i][v], run[v], part);
      if (live) store_pair<V>(dSh + at(k), dSl + at(k), run);
      part *= dv[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) dtotp[(((size_t)b * nc + k) * H + h) * parts + part_at] = part;
#pragma unroll
      for (int v = 0; v < V; ++v) run[v] = fmaf(run[v], dv[i], sv[i][v]);
    }
  }
}

// --------------------------------------------- 3. dx, dB and the u-side terms
// One CTA (a warpgroup) per (group of hg heads, chunk and batch, 64-row u
// tile); u tile 0, with the most t tiles, in the first wave.  B_u and the
// C tiles are loaded once for the group where the chunk's t tiles fit one
// block of kTB (chunk <= 256); x_u, dS_k and the dy tiles per head.
__global__ void __launch_bounds__(kWG)
ssd_bwd_dx_sm90(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
                const __grid_constant__ CUtensorMap tm_c, const __grid_constant__ CUtensorMap tm_dy,
                const __grid_constant__ CUtensorMap tm_sh, const __grid_constant__ CUtensorMap tm_sl,
                const bf16* __restrict__ x, const bf16* __restrict__ Bm,
                const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                const float* __restrict__ D, const bf16* __restrict__ dSh,
                const bf16* __restrict__ dSl, const float* __restrict__ csb,
                const float* __restrict__ dtb, bf16* __restrict__ dx, float* __restrict__ dBg,
                float* __restrict__ ddd, float* __restrict__ pn, float* __restrict__ dDp, int S,
                int H, int N, int P, int chunk, int hg, int use_tma) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cs[kMaxChunk], dts[kMaxChunk], red[kWG / 32];
  __shared__ uint64_t bar;  // TMA: a batch of tiles has landed
  uint8_t* Bu = align1024(smem_raw);  // rows u, columns n: K-major A
  uint8_t* Xu = Bu + kTile;           // rows u, columns p: K-major A
  uint8_t* Sh = Xu + kTile;           // dS_k, high half: rows n, columns p
  uint8_t* Sl = Sh + kTile;           // its low half
  uint8_t* Ct = Sl + kTile;           // kTB tiles, rows t, columns n: K-major B, then MN-major B
  uint8_t* Yt = Ct + kTB * kTile;     // kTB tiles of dy, rows t, columns p: likewise
  const int nc = S / chunk, k = blockIdx.y % nc, b = blockIdx.y / nc, ut = blockIdx.z;
  const int n_t = (chunk + kT - 1) / kT, n_tt = n_t - ut, u0 = ut * kT, c0 = k * chunk;
  const int g = blockIdx.x, G = gridDim.x, h0 = g * hg, nh = min(hg, H - h0);
  const int tid = threadIdx.x;
  const size_t xs = (size_t)H * P, NP = (size_t)N * P;
  const bool vec_n = N % 8 == 0, vec_p = P % 8 == 0;
  int ph = 0, c_blk = -1;  // the TMA barrier's phase; the t block whose C tiles are loaded

  // t block tb's dy tiles of head h and, unless loaded, its C tiles; with
  // `head`, also the head's x_u and dS_k (and B_u for the group's first).
  auto load = [&](int h, int tb, bool head, bool first) {
    const int tt0 = ut + tb * kTB, nt = min(kTB, n_tt - tb * kTB);
    const bool need_c = c_blk != tb;
    const int bkh = (b * nc + k) * H + h;
    if (use_tma) {
      if (tid == 0) {
        mbar_arrive_expect_tx(&bar, (nt * (need_c ? 2 : 1) + (head ? 3 + first : 0)) * kTile);
        if (head) {
          if (first) tma_tile<64>(Bu, kTile, &tm_b, &bar, 0, c0 + u0, b);
          tma_tile<64>(Xu, kTile, &tm_x, &bar, h, c0 + u0, b);
          tma_tile<64>(Sh, kTile, &tm_sh, &bar, 0, 0, bkh);
          tma_tile<64>(Sl, kTile, &tm_sl, &bar, 0, 0, bkh);
        }
        for (int j = 0; j < nt; ++j) {
          const int r0 = c0 + (tt0 + j) * kT;
          tma_tile<64>(Yt + j * kTile, kTile, &tm_dy, &bar, h, r0, b);
          if (need_c) tma_tile<64>(Ct + j * kTile, kTile, &tm_c, &bar, 0, r0, b);
        }
      }
    } else {
      if (head) {
        const int ur = min(kT, chunk - u0);
        if (first) stage_tile(Bu, Bm + ((size_t)b * S + c0 + u0) * N, N, ur, N, vec_n, tid, kWG);
        stage_tile(Xu, x + ((size_t)b * S + c0 + u0) * xs + (size_t)h * P, xs, ur, P, vec_p, tid,
                   kWG);
        stage_tile(Sh, dSh + bkh * NP, P, N, P, vec_p, tid, kWG);
        stage_tile(Sl, dSl + bkh * NP, P, N, P, vec_p, tid, kWG);
      }
      for (int j = 0; j < nt; ++j) {
        const int r0 = (tt0 + j) * kT, tr = min(kT, chunk - r0);
        stage_tile(Yt + j * kTile, dy + ((size_t)b * S + c0 + r0) * xs + (size_t)h * P, xs, tr,
                   P, vec_p, tid, kWG);
        if (need_c)
          stage_tile(Ct + j * kTile, Cm + ((size_t)b * S + c0 + r0) * N, N, tr, N, vec_n, tid,
                     kWG);
      }
    }
    c_blk = tb;
  };
  auto wait = [&]() {
    if (use_tma) mbar_wait(&bar, (ph++) & 1);
    tiles_ready();
  };
  if (tid == 0) {
    mbar_init(&bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int r_lo = frag_row(tid, 0);  // this thread's rows r_lo and r_lo + 8 of a tile
  float dB[32], dxa[32], s[32], s2[32];
  uint32_t kp[16], ep[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dB[i] = 0.f;
  for (int hi = 0; hi < nh; ++hi) {
    const int h = h0 + hi;
    const size_t bkh = ((size_t)b * nc + k) * H + h;
    __syncthreads();  // the last head's products and reads are done
    load(h, 0, true, hi == 0);
    for (int i = u0 + tid; i < n_t * kT; i += kWG) {  // rows u0 to the chunk's end, then 0
      cs[i] = i < chunk ? csb[bkh * chunk + i] : 0.f;
      dts[i] = i < chunk ? dtb[bkh * chunk + i] : 0.f;
    }
    wait();
    const float total = cs[chunk - 1];
    int uu[2];
    float cu[2], dtu[2], eu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uu[r] = u0 + r_lo + 8 * r;
      const bool ok = uu[r] < chunk;
      cu[r] = ok ? cs[uu[r]] : 0.f;
      dtu[r] = ok ? dts[uu[r]] : 0.f;
      eu[r] = ok ? expf(total - cs[uu[r]]) : 0.f;
    }

    // state terms: s = B_u dS_k (rows u, columns p), s2 = X_u dS_k^T (rows
    // u, columns n), dS_k as its two halves
    wgmma_fence();
    {
      const uint64_t db = make_desc(Bu, 128), dxu = make_desc(Xu, 128);
      const uint64_t dh = make_desc(Sh, 128), dl = make_desc(Sl, 128);
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        wgmma_64x64_ss<1>(s, desc_add(db, kk * 32), desc_add(dh, kk * 16 * 128), kk > 0);
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        wgmma_64x64_ss<1>(s, desc_add(db, kk * 32), desc_add(dl, kk * 16 * 128), 1);
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        wgmma_64x64_ss<0>(s2, desc_add(dxu, kk * 32), desc_add(dh, kk * 32), kk > 0);
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        wgmma_64x64_ss<0>(s2, desc_add(dxu, kk * 32), desc_add(dl, kk * 32), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(s2);
    float pr[2] = {0.f, 0.f};  // <B_u dS_k, x_u>, then Pn_u
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const float2 xv = tile_pair(Xu, r_lo + 8 * r, frag_col(tid, i));
      pr[r] = fmaf(s[i + 1], xv.y, fmaf(s[i], xv.x, pr[r]));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dxa[i + e] = s[i + e] * eu[r];
        dB[i + e] = fmaf(eu[r] * dtu[r], s2[i + e], dB[i + e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) pr[r] = quad_sum(pr[r]) * eu[r];

    // the causal pairs: every t tile from u's on
    float zr[2] = {0.f, 0.f};  // this thread's share of sum_t Z[t,u]
    for (int tb = 0; tb * kTB < n_tt; ++tb) {
      if (tb > 0) {
        __syncthreads();  // the last block's products are done
        load(h, tb, false, false);
        wait();
      }
      const int tt0 = ut + tb * kTB, nt = min(kTB, n_tt - tb * kTB);
      for (int j = 0; j < nt; ++j) {
        const int t0 = (tt0 + j) * kT;
        wgmma_fence();
        mma_abt<64, 64>(s, Bu, 0, Ct + j * kTile, 0);   // s = B_u C_t^T: (C B^T)^T
        mma_abt<64, 64>(s2, Xu, 0, Yt + j * kTile, 0);  // s2 = X_u dY_t^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(s2);
        // K^T = s o G^T and E^T = G^T o dt_u o s2 where u <= t < chunk, else
        // 0 (never the exp of a positive sum); Z^T = K^T o s2
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = t0 + 8 * jj + 2 * (tid % 4) + e;
            const float ct = cs[t];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * jj + 2 * r + e;
              const bool ok = t < chunk && uu[r] <= t;
              const float gt = ok ? gate(ct, cu[r]) : 0.f;
              const float kv = ok ? __fmul_rn(s[i], gt) : 0.f;
              zr[r] += __fmul_rn(kv, s2[i]);  // Z, rounded as ssd_bwd_dc_sm90 rounds it
              s2[i] = ok ? gt * dtu[r] * s2[i] : 0.f;
              s[i] = kv;
            }
          }
        }
        pack_a<64>(kp, s);
        pack_a<64>(ep, s2);
        wgmma_fence();
        mma_pv<64, kT / 16>(dxa, kp, Yt + j * kTile, 0);  // dx += K^T dY_t
        mma_pv<64, kT / 16>(dB, ep, Ct + j * kTile, 0);   // dB += E^T C_t
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dxa);
        fence_regs(dB);
      }
    }

    // dx = dt_u dxa + D dy_u (bf16, written once), x . dy for dD; dy_u is
    // the first dy tile when the t tiles fit one block, else read again
    const bool dy_tile = n_tt <= kTB;
    const float d_skip = D[h];
    const size_t hoff = ((size_t)b * S + c0) * xs + (size_t)h * P;
    float dd = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1, u = uu[r], p = frag_col(tid, i);
      if (u >= chunk || p >= P) continue;
      const size_t off = hoff + (size_t)u * xs + p;
      float2 y = {0.f, 0.f};
      if (dy_tile) {
        y = tile_pair(Yt, u - u0, p);  // 0 past P
      } else if (P % 2 == 0) {
        y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dy + off));
      } else {
        y.x = __bfloat162float(dy[off]);
        if (p + 1 < P) y.y = __bfloat162float(dy[off + 1]);
      }
      const float2 xv = tile_pair(Xu, u - u0, p);  // 0 past P
      const float d0 = fmaf(d_skip, y.x, dtu[r] * dxa[i]);
      const float d1 = fmaf(d_skip, y.y, dtu[r] * dxa[i + 1]);
      dd = fmaf(xv.y, y.y, fmaf(xv.x, y.x, dd));
      if (P % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dx + off) = __floats2bfloat162_rn(d0, d1);
      } else {
        dx[off] = __float2bfloat16_rn(d0);
        if (p + 1 < P) dx[off + 1] = __float2bfloat16_rn(d1);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dd += __shfl_xor_sync(0xffffffffu, dd, off);
    if (tid % 32 == 0) red[tid / 32] = dd;
#pragma unroll
    for (int r = 0; r < 2; ++r) zr[r] = quad_sum(zr[r]);
    if (tid % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (uu[r] >= chunk) continue;
        ddd[bkh * chunk + uu[r]] = zr[r] + pr[r];
        pn[bkh * chunk + uu[r]] = dtu[r] * pr[r];
      }
    }
    __syncthreads();
    if (tid == 0)
      dDp[(((size_t)b * nc + k) * n_t + ut) * H + h] = red[0] + red[1] + red[2] + red[3];
  }
  // dB, summed over the group's heads: (b, s, groups, n)
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int u = u0 + frag_row(tid, i), n = frag_col(tid, i);
    if (u < chunk && n < N) dBg[(((size_t)b * S + c0 + u) * G + g) * N + n] = dB[i];
  }
}

// ------------------------------------------------- 4. dC and the t-side terms
// One CTA (a warpgroup) per (group of hg heads, chunk and batch, 64-row t
// tile); the last t tile, with the most u tiles, in the first wave.  C_t and
// the B tiles are loaded once for the group where the u tiles fit one block
// of kTB; dy_t, S_{k-1} and the x tiles per head.
__global__ void __launch_bounds__(kWG)
ssd_bwd_dc_sm90(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
                const __grid_constant__ CUtensorMap tm_c, const __grid_constant__ CUtensorMap tm_dy,
                const __grid_constant__ CUtensorMap tm_sh, const __grid_constant__ CUtensorMap tm_sl,
                const bf16* __restrict__ x, const bf16* __restrict__ Bm,
                const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                const bf16* __restrict__ Sh, const bf16* __restrict__ Sl,
                const float* __restrict__ csb, const float* __restrict__ dtb,
                float* __restrict__ dCg, float* __restrict__ dcsr, int S, int H, int N, int P,
                int chunk, int hg, int use_tma) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cs[kMaxChunk], dts[kMaxChunk];
  __shared__ uint64_t bar;  // TMA: a batch of tiles has landed
  uint8_t* Ct = align1024(smem_raw);  // rows t, columns n: K-major A
  uint8_t* Yt = Ct + kTile;           // dy, rows t, columns p: K-major A
  uint8_t* Ss = Yt + kTile;           // S_{k-1}, rows n, columns p: K-major B
  uint8_t* Sls = Ss + kTile;          // its low half
  uint8_t* Bu = Sls + kTile;          // kTB tiles, rows u, columns n: K-major B, then MN-major B
  uint8_t* Xu = Bu + kTB * kTile;     // kTB tiles, rows u, columns p: K-major B
  const int nc = S / chunk, k = blockIdx.y % nc, b = blockIdx.y / nc;
  const int n_t = (chunk + kT - 1) / kT, tt = n_t - 1 - blockIdx.z, n_ut = tt + 1;
  const int t0 = tt * kT, c0 = k * chunk;
  const int g = blockIdx.x, G = gridDim.x, h0 = g * hg, nh = min(hg, H - h0);
  const int tid = threadIdx.x;
  const size_t xs = (size_t)H * P, NP = (size_t)N * P;
  const bool vec_n = N % 8 == 0, vec_p = P % 8 == 0;
  int ph = 0, b_blk = -1;  // the TMA barrier's phase; the u block whose B tiles are loaded

  // u block ub's x tiles of head h and, unless loaded, its B tiles; with
  // `head`, also the head's dy_t and S_{k-1} (and C_t for the group's first).
  auto load = [&](int h, int ub, bool head, bool first) {
    const int nu = min(kTB, n_ut - ub * kTB);
    const bool need_b = b_blk != ub;
    const int bkh = (b * nc + k) * H + h;
    if (use_tma) {
      if (tid == 0) {
        mbar_arrive_expect_tx(&bar, (nu * (need_b ? 2 : 1) + (head ? 3 + first : 0)) * kTile);
        if (head) {
          if (first) tma_tile<64>(Ct, kTile, &tm_c, &bar, 0, c0 + t0, b);
          tma_tile<64>(Yt, kTile, &tm_dy, &bar, h, c0 + t0, b);
          tma_tile<64>(Ss, kTile, &tm_sh, &bar, 0, 0, bkh);
          tma_tile<64>(Sls, kTile, &tm_sl, &bar, 0, 0, bkh);
        }
        for (int j = 0; j < nu; ++j) {
          const int r0 = c0 + (ub * kTB + j) * kT;
          tma_tile<64>(Xu + j * kTile, kTile, &tm_x, &bar, h, r0, b);
          if (need_b) tma_tile<64>(Bu + j * kTile, kTile, &tm_b, &bar, 0, r0, b);
        }
      }
    } else {
      if (head) {
        const int tr = min(kT, chunk - t0);
        if (first) stage_tile(Ct, Cm + ((size_t)b * S + c0 + t0) * N, N, tr, N, vec_n, tid, kWG);
        stage_tile(Yt, dy + ((size_t)b * S + c0 + t0) * xs + (size_t)h * P, xs, tr, P, vec_p,
                   tid, kWG);
        stage_tile(Ss, Sh + bkh * NP, P, N, P, vec_p, tid, kWG);
        stage_tile(Sls, Sl + bkh * NP, P, N, P, vec_p, tid, kWG);
      }
      for (int j = 0; j < nu; ++j) {
        const int r0 = (ub * kTB + j) * kT, ur = min(kT, chunk - r0);
        stage_tile(Xu + j * kTile, x + ((size_t)b * S + c0 + r0) * xs + (size_t)h * P, xs, ur,
                   P, vec_p, tid, kWG);
        if (need_b)
          stage_tile(Bu + j * kTile, Bm + ((size_t)b * S + c0 + r0) * N, N, ur, N, vec_n, tid,
                     kWG);
      }
    }
    b_blk = ub;
  };
  auto wait = [&]() {
    if (use_tma) mbar_wait(&bar, (ph++) & 1);
    tiles_ready();
  };
  if (tid == 0) {
    mbar_init(&bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int r_lo = frag_row(tid, 0);
  float dC[32], s[32], s2[32];
  uint32_t ep[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dC[i] = 0.f;
  for (int hi = 0; hi < nh; ++hi) {
    const int h = h0 + hi;
    const size_t bkh = ((size_t)b * nc + k) * H + h;
    __syncthreads();  // the last head's products and reads are done
    load(h, 0, true, hi == 0);
    for (int i = tid; i < n_ut * kT; i += kWG) {  // rows 0 to this t tile's end, 0 past the chunk
      cs[i] = i < chunk ? csb[bkh * chunk + i] : 0.f;
      dts[i] = i < chunk ? dtb[bkh * chunk + i] : 0.f;
    }
    wait();
    int tr_[2];
    float ct[2], et[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tr_[r] = t0 + r_lo + 8 * r;
      const bool ok = tr_[r] < chunk;
      ct[r] = ok ? cs[tr_[r]] : 0.f;
      et[r] = ok ? expf(cs[tr_[r]]) : 0.f;
    }

    // state term: s = dY_t S_{k-1}^T (rows t, columns n), S_{k-1} as its two halves
    wgmma_fence();
    {
      const uint64_t dyd = make_desc(Yt, 128), dh = make_desc(Ss, 128), dl = make_desc(Sls, 128);
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        wgmma_64x64_ss<0>(s, desc_add(dyd, kk * 32), desc_add(dh, kk * 32), kk > 0);
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        wgmma_64x64_ss<0>(s, desc_add(dyd, kk * 32), desc_add(dl, kk * 32), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    float ri[2] = {0.f, 0.f};  // <C_t, S_{k-1} dy_t>
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const float2 cv = tile_pair(Ct, r_lo + 8 * r, frag_col(tid, i));
      ri[r] = fmaf(s[i + 1], cv.y, fmaf(s[i], cv.x, ri[r]));
#pragma unroll
      for (int e = 0; e < 2; ++e) dC[i + e] = fmaf(et[r], s[i + e], dC[i + e]);
    }

    float rz[2] = {0.f, 0.f};  // this thread's share of sum_u Z[t,u] dt_u
    for (int ub = 0; ub * kTB < n_ut; ++ub) {
      if (ub > 0) {
        __syncthreads();  // the last block's products are done
        load(h, ub, false, false);
        wait();
      }
      const int nu = min(kTB, n_ut - ub * kTB);
      for (int j = 0; j < nu; ++j) {
        const int u0 = (ub * kTB + j) * kT;
        wgmma_fence();
        mma_abt<64, 64>(s, Ct, 0, Bu + j * kTile, 0);   // s = C_t B_u^T
        mma_abt<64, 64>(s2, Yt, 0, Xu + j * kTile, 0);  // s2 = dY_t X_u^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(s2);
        // E = G o dt_u o s2 where u <= t < chunk, else 0; Z = s o G o s2
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int u = u0 + 8 * jj + 2 * (tid % 4) + e;
            const float cu = cs[u], du = dts[u];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * jj + 2 * r + e;
              const bool ok = tr_[r] < chunk && u <= tr_[r];
              const float gt = ok ? gate(ct[r], cu) : 0.f;
              const float z = ok ? __fmul_rn(__fmul_rn(s[i], gt), s2[i]) : 0.f;
              rz[r] = fmaf(z, du, rz[r]);
              s2[i] = ok ? gt * du * s2[i] : 0.f;
            }
          }
        }
        pack_a<64>(ep, s2);
        wgmma_fence();
        mma_pv<64, kT / 16>(dC, ep, Bu + j * kTile, 0);  // dC += E B_u
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dC);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rz[r] = quad_sum(rz[r]);
      ri[r] = quad_sum(ri[r]);
    }
    if (tid % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (tr_[r] < chunk) dcsr[bkh * chunk + tr_[r]] = rz[r] + et[r] * ri[r];
    }
  }
  // dC, summed over the group's heads: (b, s, groups, n)
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int t = t0 + frag_row(tid, i), n = frag_col(tid, i);
    if (t < chunk && n < N) dCg[(((size_t)b * S + c0 + t) * G + g) * N + n] = dC[i];
  }
}

// ----------------------------------------------------- 5. ddt and dA, in f32
// One warp per (batch, chunk, head): dcs_i = dcsr_i - dt_i ddd_i, plus
// dtot_k and sum_u dt_u Pn_u at the last row; acc = its reverse cumsum
// (a segment per lane, then a suffix scan of the segments); ddt = ddd + A
// acc; the chunk's dA partial sum dt acc.  Sums in a fixed order.
constexpr int kDtWarps = 4;

__global__ void __launch_bounds__(32 * kDtWarps)
ssd_bwd_dt(const float* __restrict__ dtb, const float* __restrict__ ddd,
           const float* __restrict__ pn, const float* __restrict__ dcsr,
           const float* __restrict__ dtotp, const float* __restrict__ A, float* __restrict__ ddt,
           float* __restrict__ dAp, int n_bkh, int S, int H, int chunk, int parts) {
  const int lane = threadIdx.x % 32, bkh = blockIdx.x * kDtWarps + threadIdx.x / 32;
  if (bkh >= n_bkh) return;  // a whole warp; nothing below synchronises the block
  const int nc = S / chunk, h = bkh % H, k = (bkh / H) % nc, b = bkh / H / nc;
  const size_t base = (size_t)bkh * chunk;
  float psum = 0.f;
  for (int i = lane; i < chunk; i += 32) psum += pn[base + i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
  float dtot = 0.f;
  for (int j = 0; j < parts; ++j) dtot += dtotp[(size_t)bkh * parts + j];
  const float extra = dtot + psum, a = A[h];
  auto dcs = [&](int i) {
    const float v = dcsr[base + i] - dtb[base + i] * ddd[base + i];
    return i == chunk - 1 ? v + extra : v;
  };
  const int per = (chunk + 31) / 32, lo = min(chunk, lane * per), hi = min(chunk, lo + per);
  float run = 0.f;
  for (int i = hi - 1; i >= lo; --i) run += dcs(i);
  float incl = run;  // sum over this lane's segment and the later ones
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += v;
  }
  float acc = incl - run, dA = 0.f;
  float* ddt_b = ddt + ((size_t)b * S + (size_t)k * chunk) * H + h;
  for (int i = hi - 1; i >= lo; --i) {
    acc += dcs(i);
    ddt_b[(size_t)i * H] = fmaf(a, acc, ddd[base + i]);
    dA = fmaf(dtb[base + i], acc, dA);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dA += __shfl_xor_sync(0xffffffffu, dA, off);
  if (lane == 0) dAp[bkh] = dA;
}

// ------------------------------- 6. dB and dC over the head groups; dA, dD
// dAp (na, H) and dDp (nd, H) are summed over their first axis for the
// first H threads.
__global__ void __launch_bounds__(256)
ssd_bwd_groups(const float* __restrict__ dBg, const float* __restrict__ dCg,
               bf16* __restrict__ dB, bf16* __restrict__ dC, size_t rows, int G, int N,
               const float* __restrict__ dAp, const float* __restrict__ dDp,
               float* __restrict__ dA, float* __restrict__ dD, int H, int na, int nd) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < (size_t)H) {
    float sa = 0.f, sd = 0.f;
    for (int j = 0; j < na; ++j) sa += dAp[(size_t)j * H + e];
    for (int j = 0; j < nd; ++j) sd += dDp[(size_t)j * H + e];
    dA[e] = sa;
    dD[e] = sd;
  }
  if (e >= rows * N) return;
  const size_t at = (e / N) * G * N + e % N;
  float sb = 0.f, sc = 0.f;
  for (int g = 0; g < G; ++g) {
    sb += dBg[at + (size_t)g * N];
    sc += dCg[at + (size_t)g * N];
  }
  dB[e] = __float2bfloat16_rn(sb);
  dC[e] = __float2bfloat16_rn(sc);
}

constexpr int kDstateSmem = 1024 + 6 * kTS * kTile;   // + alignment slack
constexpr int kDxSmem = 1024 + (4 + 2 * kTB) * kTile;
constexpr int kDcSmem = 1024 + (4 + 2 * kTB) * kTile;

}  // namespace
}  // namespace repro_torch

// bfloat16 only (float32: ssd_scan.cu's ssd_scan_bwd).  Inputs: x, dy
// (b, s, h, p) and B, C (b, s, n) in bf16; dt (b, s, h), A, D (h,) in f32.
// Outputs: dx (b, s, h, p), dB and dC (b, s, n) in bf16; ddt (b, s, h), dA
// and dD (h,) in f32.  Scratch (nc = s / chunk): dAp and totals
// (b, nc, h), dDp (b, nc, ceil(chunk / 64), h), dBg and dCg
// (b, s, ceil(h / hg), n), csb, dtb, ddd, pn, dcsr (b, nc, h, chunk), sk and
// ds (b, nc, h, n, p) in f32; Sh, Sl, dSh, dSl (b, nc, h, n, p) in bf16;
// dtotp of b nc h 8 ceil(n p / 256) floats.  All contiguous, 16-byte
// aligned; n, p <= 64, s % chunk == 0, chunk <= 1024.  Launches six kernels
// on `stream`, allocates nothing, returns the cudaError_t of the launches.
extern "C" int ssd_scan_bwd_sm90(const void* x, const void* dt, const void* A, const void* B,
                                 const void* C, const void* D, const void* dy, void* dx,
                                 void* dB, void* dC, void* ddt, void* dA, void* dD, void* dAp,
                                 void* totals, void* dDp, void* dBg, void* dCg, void* csb,
                                 void* dtb, void* ddd, void* pn, void* dcsr, void* sk, void* ds,
                                 void* Sh, void* Sl, void* dSh, void* dSl, void* dtotp, int b,
                                 int s, int h, int p, int n, int chunk, int hg, void* stream) {
  using namespace repro_torch;
  const int nc = chunk > 0 ? s / chunk : 0, n_t = (chunk + kT - 1) / kT;
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || p > kT || n <= 0 || n > kT || chunk <= 0 ||
      chunk > kMaxChunk || s % chunk != 0 || h > 65535 || b > 65535 || hg <= 0 || hg > h ||
      (long long)nc * b > 65535)
    return cudaErrorInvalidValue;
  const int groups = (h + hg - 1) / hg, pv = n * p % 2 == 0 ? 2 : 1;  // state elements a thread
  const int nbx = (n * p + pv * kPassThreads - 1) / (pv * kPassThreads);
  // once per process (the port drives one card): the tiles exceed 48 KB
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(ssd_dstate_sm90,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDstateSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_dx_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_dc_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDcSmem);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  // TMA tensor maps where the tiles are whole 64-column boxes (n = p = 64,
  // zamba2's widths); else the kernels copy with cp.async
  CUtensorMap tm_x{}, tm_dy{}, tm_b{}, tm_c{}, tm_sh{}, tm_sl{}, tm_dsh{}, tm_dsl{};
  const int use_tma = p == kT && n == kT;
  if (use_tma && !(sm90::make_map<64>(&tm_x, x, b, s, h, kT) &&
                   sm90::make_map<64>(&tm_dy, dy, b, s, h, kT) &&
                   sm90::make_map<64>(&tm_b, B, b, s, 1, kT) &&
                   sm90::make_map<64>(&tm_c, C, b, s, 1, kT) &&
                   sm90::make_map<64>(&tm_sh, Sh, b * nc * h, n, 1, kT) &&
                   sm90::make_map<64>(&tm_sl, Sl, b * nc * h, n, 1, kT) &&
                   sm90::make_map<64>(&tm_dsh, dSh, b * nc * h, n, 1, kT) &&
                   sm90::make_map<64>(&tm_dsl, dSl, b * nc * h, n, 1, kT)))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* dyb = static_cast<const bf16*>(dy);
  const auto* Bb = static_cast<const bf16*>(B);
  const auto* Cb = static_cast<const bf16*>(C);
  auto* csf = static_cast<float*>(csb);
  auto* dtf = static_cast<float*>(dtb);
  auto* tot = static_cast<float*>(totals);
  auto* skf = static_cast<float*>(sk);
  auto* dsf = static_cast<float*>(ds);
  auto* shb = static_cast<bf16*>(Sh);
  auto* slb = static_cast<bf16*>(Sl);
  auto* dshb = static_cast<bf16*>(dSh);
  auto* dslb = static_cast<bf16*>(dSl);
  auto* tp = static_cast<float*>(dtotp);
  auto* dddf = static_cast<float*>(ddd);
  auto* pnf = static_cast<float*>(pn);
  auto* dcsf = static_cast<float*>(dcsr);
  ssd_dstate_sm90<<<dim3(h, nc, b), kWG, kDstateSmem, st>>>(
      tm_b, tm_x, tm_c, tm_dy, Bb, xb, Cb, dyb, static_cast<const float*>(dt),
      static_cast<const float*>(A), skf, dsf, tot, csf, dtf, s, h, n, p, chunk, use_tma);
  if (pv == 2)
    ssd_dpass<2><<<dim3(nbx, h, b), kPassThreads, 0, st>>>(skf, dsf, tot, shb, slb, dshb, dslb,
                                                            tp, nc, h, n * p);
  else
    ssd_dpass<1><<<dim3(nbx, h, b), kPassThreads, 0, st>>>(skf, dsf, tot, shb, slb, dshb, dslb,
                                                            tp, nc, h, n * p);
  ssd_bwd_dx_sm90<<<dim3(groups, nc * b, n_t), kWG, kDxSmem, st>>>(
      tm_x, tm_b, tm_c, tm_dy, tm_dsh, tm_dsl, xb, Bb, Cb, dyb, static_cast<const float*>(D),
      dshb, dslb, csf, dtf, static_cast<bf16*>(dx), static_cast<float*>(dBg), dddf, pnf,
      static_cast<float*>(dDp), s, h, n, p, chunk, hg, use_tma);
  ssd_bwd_dc_sm90<<<dim3(groups, nc * b, n_t), kWG, kDcSmem, st>>>(
      tm_x, tm_b, tm_c, tm_dy, tm_sh, tm_sl, xb, Bb, Cb, dyb, shb, slb, csf, dtf,
      static_cast<float*>(dCg), dcsf, s, h, n, p, chunk, hg, use_tma);
  const int n_bkh = b * nc * h;
  ssd_bwd_dt<<<(n_bkh + kDtWarps - 1) / kDtWarps, 32 * kDtWarps, 0, st>>>(
      dtf, dddf, pnf, dcsf, tp, static_cast<const float*>(A), static_cast<float*>(ddt),
      static_cast<float*>(dAp), n_bkh, s, h, chunk, nbx * kPassThreads / 32);
  const size_t rows = (size_t)b * s;
  const size_t n_el = rows * n > (size_t)h ? rows * n : (size_t)h;
  ssd_bwd_groups<<<(unsigned)((n_el + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(dBg), static_cast<const float*>(dCg), static_cast<bf16*>(dB),
      static_cast<bf16*>(dC), rows, groups, n, static_cast<const float*>(dAp),
      static_cast<const float*>(dDp), static_cast<float*>(dA), static_cast<float*>(dD), h, b * nc,
      b * nc * n_t);
  return cudaGetLastError();
}
