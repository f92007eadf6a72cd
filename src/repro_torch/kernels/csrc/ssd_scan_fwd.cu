// Mamba-2 SSD chunked scan, forward, bfloat16, on the Hopper tensor cores
// (sm_90a): the chunk-parallel decomposition.
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_scan() and its Pallas body
// _kernel(), in bfloat16 (float32 keeps the SIMT forward of ssd_scan.cu).
// Per (batch b, head h), over chunks of `chunk` positions with
// cs = cumsum(dt * A) inside the chunk and S_{k-1} the (n x p) f32 state
// entering chunk k:
//   y_t = sum_{u <= t} (C_t . B_u) exp(cs_t - cs_u) dt_u x_u
//         + exp(cs_t) C_t . S_{k-1} + D x_t
//   S_k = exp(cs_last) S_{k-1} + sum_u exp(cs_last - cs_u) dt_u B_u x_u^T
// B and C (b, s, n) are shared by all heads.
//
// The split is that of Dao & Gu, "Transformers are SSMs" (2024), section 6
// (the mamba_ssm kernels' chunk cumsum -> chunk state -> state passing ->
// chunk scan), so that the chunks run in parallel and only a small pass is
// sequential:
//   1. ssd_state_sm90, one CTA per (head, chunk, batch): the chunk's cs and
//      its state contribution s_k = (B o g)^T x, g_u = exp(cs_last - cs_u)
//      dt_u, an (n x chunk) . (chunk x p) wgmma product, into f32 scratch
//      (b, nc, h, n, p), and cs_last into (b, nc, h);
//   2. ssd_pass, one thread per (batch, head, state element): S_k =
//      exp(cs_last) S_{k-1} + s_k over the chunks in order, in f32, each
//      S_{k-1} written in bf16 for the scan, and on request the final state
//      S_nc in f32 (hybrid prefill hands it to decode);
//   3. ssd_scan_sm90, one CTA per (head, chunk, block of four 64-row t tiles,
//      batch), two warpgroups taking two t tiles each, the B and x tiles of
//      u loaded once for the four: acc = exp(cs_t) (C_t . S_{k-1}) on wgmma,
//      then for every u tile up to the diagonal W = (C_t . B_u^T) on wgmma,
//      gated in f32 registers (exp(cs_t - cs_u) dt_u, 0 by construction
//      where u > t, never exp of a positive sum), rounded to bf16 as the
//      register A operand of acc += W . x_u; then y = acc + D x_t.
// C . B^T is shared by the heads, yet each head's CTA computes it again on
// the tensor cores: it is a quarter of the kernel's 13 GFLOP at zamba2's
// shape (13 us at the bf16 peak, under the 21 us byte bound), and sharing
// it would write and re-read a (b, nc, chunk, chunk) f32 tensor instead.
//
// What bounds it on the H100: bytes (x read and y written once, about
// 67 MB at zamba2-1.2b's microbatch, 21 us); the products are some 200 FLOP
// per byte, under the tensor cores' 295.  The grids are b * nc * h CTAs
// (1,024 at zamba2's microbatch) instead of the SIMT kernel's b * h = 128.
// What holds it back now: each CTA loads, then multiplies, then stores, and
// only two scan CTAs fit an SM, so its loads overlap little with the
// products; the three kernels also move the states (b, nc, h, n, p) through
// memory twice.
//
// Operands: every tile is 64 rows of 64 bf16 in shared memory in the
// 128-byte swizzle that the wgmma descriptors of sm90.cuh read (16-byte
// chunk c of row r at chunk c ^ (r % 8)).  At n = p = 64 (zamba2) every
// bf16 tile (x, B, C, S_{k-1}) comes by TMA, one box a tile, issued before
// the cumsum so that the two overlap; rows past the chunk hold the next
// chunk's values (or 0 past s), finite, and are masked or multiplied by 0.
// TMA's boxes cannot pad n or p below 64 with zeros, so other widths copy
// with cp.async, 16 bytes a copy straight to the swizzled place, zero-filled
// past the edges.  The state product's B is scaled in place after it lands,
// then a proxy fence makes it visible to wgmma.  Rounding to bf16: the gated
// W, the scaled B of the state product and S_{k-1}; the products accumulate
// in f32.
#include "ssd_sm90.cuh"

namespace repro_torch {
namespace {

// ---------------------------------------------------- 1. chunk states
// One warpgroup per (head, chunk, batch); the u rows in blocks of kTB tiles.
__global__ void __launch_bounds__(kWG)
ssd_state_sm90(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
               const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const bf16* __restrict__ Bm,
               float* __restrict__ states, float* __restrict__ totals, int S, int H, int N,
               int P, int chunk, int use_tma) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cs[kMaxChunk], dts[kMaxChunk], g[kTB * kT];
  __shared__ uint64_t bar;  // TMA: a u block's tiles have landed
  uint8_t* Bs = align1024(smem_raw);  // kTB tiles, rows u, columns n: MN-major A
  uint8_t* Xs = Bs + kTB * kTile;     // kTB tiles, rows u, columns p: MN-major B
  const int h = blockIdx.x, k = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int c0 = k * chunk, tid = threadIdx.x;
  const size_t xs = (size_t)H * P;
  const bool vec_b = N % 8 == 0, vec_x = P % 8 == 0;

  // the raw B (scaled in place below) and x tiles of u block u0; with
  // vec_b false B is loaded scaled, so after the gates are known.  By TMA
  // (n = p = 64): the block's tiles that start inside the chunk, on `bar`.
  auto load_u = [&](int u0) {
    if (use_tma) {
      if (tid == 0) {
        const int nt = min(kTB, (chunk - u0 + kT - 1) / kT);
        mbar_arrive_expect_tx(&bar, 2 * nt * kTile);
        for (int j = 0; j < nt; ++j) {
          tma_tile<64>(Bs + j * kTile, kTile, &tm_b, &bar, 0, c0 + u0 + j * kT, b);
          tma_tile<64>(Xs + j * kTile, kTile, &tm_x, &bar, h, c0 + u0 + j * kT, b);
        }
      }
      return;
    }
    for (int j = 0; j < kTB; ++j) {
      const int r0 = u0 + j * kT, ur = max(0, min(kT, chunk - r0));
      const bf16* bsrc = Bm + ((size_t)b * S + c0 + r0) * N;
      if (vec_b)
        cp_tile(Bs + j * kTile, bsrc, N, ur, N, tid, kWG);
      else
        load_tile(Bs + j * kTile, bsrc, N, ur, N, g + j * kT, false, tid, kWG);
      stage_tile(Xs + j * kTile, x + ((size_t)b * S + c0 + r0) * xs + (size_t)h * P, xs, ur, P,
                 vec_x, tid, kWG);
    }
  };
  if (tid == 0) {
    mbar_init(&bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (vec_b) load_u(0);  // in flight while the gates are computed
  gates(dts, cs, dt + ((size_t)b * S + c0) * H + h, H, A[h], chunk);
  const float total = cs[chunk - 1];

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int u0 = 0, ph = 0; u0 < chunk; u0 += kTB * kT, ph ^= 1) {
    __syncthreads();  // the last block's products are done
    for (int r = tid; r < kTB * kT; r += kWG)
      g[r] = u0 + r < chunk ? expf(total - cs[u0 + r]) * dts[u0 + r] : 0.f;
    __syncthreads();
    if (u0 > 0 || !vec_b) load_u(u0);
    const int nt = min(kTB, (chunk - u0 + kT - 1) / kT);  // tiles inside the chunk
    if (vec_b) {  // B rows times g, rounded to bf16 as load_tile rounds them
      if (use_tma)
        mbar_wait(&bar, ph);
      else
        asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      for (int e = tid; e < nt * kT * 8; e += kWG) {
        const int r = e / 8;  // row of the kTB stacked tiles
        uint4* q = reinterpret_cast<uint4*>(Bs + (r / kT) * kTile + swz(r % kT, e % 8));
        float f[8];
        load_vec<8>(reinterpret_cast<const bf16*>(q), f);
        const float sc = g[r];
        uint4 u;
        u.x = pack_bf16(f[0] * sc, f[1] * sc);
        u.y = pack_bf16(f[2] * sc, f[3] * sc);
        u.z = pack_bf16(f[4] * sc, f[5] * sc);
        u.w = pack_bf16(f[6] * sc, f[7] * sc);
        *q = u;
      }
    }
    tiles_ready();
    wgmma_fence();
    for (int j = 0; j < nt; ++j) {
      const uint64_t db = make_desc(Bs + j * kTile, 128), dx = make_desc(Xs + j * kTile, 128);
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)  // 16 rows of u a k-step
        wgmma_64x64_ss<1, 1>(acc, desc_add(db, kk * 16 * 128), desc_add(dx, kk * 16 * 128), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  float* out = states + (((size_t)b * nc + k) * H + h) * N * P;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int n = frag_row(tid, i), p = frag_col(tid, i);
    if (n < N && p < P) out[n * P + p] = acc[i];
  }
  if (tid == 0) totals[((size_t)b * nc + k) * H + h] = total;
}

// ---------------------------------------------------- 2. state passing
// One thread per (batch, head, state element): S_k = exp(total_k) S_{k-1}
// + s_k over the chunks in order, in f32; S_{k-1}, the state entering chunk
// k, is written in bf16 (the scan's operand, rounded where the scan would
// round it).  The loads of 8 chunks are issued together.  With `fin` set,
// the state after the last chunk is written there in f32, (b, h, p, n).
__global__ void __launch_bounds__(256)
ssd_pass(const float* __restrict__ states, const float* __restrict__ totals,
         bf16* __restrict__ sprev, float* __restrict__ fin, int nc, int H, int N, int P) {
  const int NP = N * P;
  const int e = blockIdx.x * blockDim.x + threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  if (e >= NP) return;
  float run = 0.f;
  for (int k0 = 0; k0 < nc; k0 += 8) {
    float sv[8], dv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const size_t bkh = ((size_t)b * nc + k0 + i) * H + h;
      sv[i] = k0 + i < nc ? states[bkh * NP + e] : 0.f;
      dv[i] = k0 + i < nc ? expf(totals[bkh]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (k0 + i >= nc) break;
      sprev[(((size_t)b * nc + k0 + i) * H + h) * NP + e] = __float2bfloat16_rn(run);
      run = fmaf(run, dv[i], sv[i]);
    }
  }
  if (fin) fin[(((size_t)b * H + h) * P + e % P) * N + e / P] = run;  // e = n * P + p
}

// ---------------------------------------------------- 3. chunk scan
// One CTA per (head, chunk, block of kTB t tiles, batch): two warpgroups,
// taking t tiles 0, 3 and 1, 2 of the block in turn, so that two CTAs
// fit an SM and one's loads overlap the other's products.  The B and x
// tiles of u are loaded once for the block's t tiles, kTB u tiles at a time
// (once in all for chunk <= 256).  A t tile past the chunk (a ragged last
// block) runs its products on zero rows and writes nothing, so no wgmma
// sits under a branch.
constexpr int kScanWG = 2;

__global__ void __launch_bounds__(kScanWG * kWG, 2)
ssd_scan_sm90(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
              const __grid_constant__ CUtensorMap tm_c, const __grid_constant__ CUtensorMap tm_s,
              const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bm,
              const bf16* __restrict__ Cm, const float* __restrict__ D,
              const bf16* __restrict__ sprev, bf16* __restrict__ y, int S, int H, int N,
              int P, int chunk, int use_tma) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar;  // TMA: a batch of tiles has landed
  uint8_t* Ss = align1024(smem_raw);  // rows n, columns p: MN-major B of C . S
  uint8_t* Cs = Ss + kTile;           // kTB tiles, rows t, columns n: K-major A
  uint8_t* Bs = Cs + kTB * kTile;     // kTB tiles, rows u, columns n: K-major B of C . B^T
  uint8_t* Xs = Bs + kTB * kTile;     // kTB tiles, rows u, columns p: MN-major B of W . x
  const int n_t = (chunk + kT - 1) / kT, n_tb = (n_t + kTB - 1) / kTB;
  float* cs = reinterpret_cast<float*>(Xs + kTB * kTile);  // n_t * kT floats each
  float* dts = cs + n_t * kT;
  const int h = blockIdx.x, b = blockIdx.z;
  const int k = blockIdx.y / n_tb, tb = n_tb - 1 - blockIdx.y % n_tb;  // heavy blocks first
  const int nc = gridDim.y / n_tb, c0 = k * chunk;
  const int tid = threadIdx.x, nthr = blockDim.x, wg = tid / kWG, lt = tid % kWG;
  const int rows = min(chunk, (tb + 1) * kTB * kT);  // chunk rows any tile of the block needs
  const size_t xs = (size_t)H * P;
  const bool vec_n = N % 8 == 0, vec_p = P % 8 == 0;
  const bf16* xb = x + ((size_t)b * S + c0) * xs + (size_t)h * P;
  const bf16* Bb = Bm + ((size_t)b * S + c0) * N;

  // By TMA (n = p = 64), thread 0 issues every tile that starts inside the
  // chunk on `bar` (rows past the chunk come from the next one, or are 0
  // past s: finite, and masked or multiplied by 0); else cp.async.
  const int nt_t = min(kTB, n_t - tb * kTB);  // t tiles of this block inside the chunk
  auto load_u = [&](int ub, uint32_t extra) {  // the B and x tiles of u block ub
    const int nt = min(kTB, n_t - ub * kTB);
    if (use_tma) {
      if (tid == 0) {
        mbar_arrive_expect_tx(&bar, 2 * nt * kTile + extra);
        for (int j = 0; j < nt; ++j) {
          const int r0 = c0 + (ub * kTB + j) * kT;
          tma_tile<64>(Bs + j * kTile, kTile, &tm_b, &bar, 0, r0, b);
          tma_tile<64>(Xs + j * kTile, kTile, &tm_x, &bar, h, r0, b);
        }
      }
      return;
    }
    for (int j = 0; j < kTB; ++j) {
      const int r0 = (ub * kTB + j) * kT, ur = max(0, min(kT, chunk - r0));
      stage_tile(Bs + j * kTile, Bb + (size_t)r0 * N, N, ur, N, vec_n, tid, nthr);
      stage_tile(Xs + j * kTile, xb + (size_t)r0 * xs, xs, ur, P, vec_p, tid, nthr);
    }
  };
  if (use_tma) {
    if (tid == 0) {
      mbar_init(&bar, 1);
      fence_barrier_init();
    }
    __syncthreads();  // the barrier is initialised before anyone uses it
    if (tid == 0) {   // S_{k-1} and the block's C tiles, counted by load_u(0)
      tma_tile<64>(Ss, kTile, &tm_s, &bar, 0, 0, ((int)b * nc + k) * H + h);
      for (int j = 0; j < nt_t; ++j)
        tma_tile<64>(Cs + j * kTile, kTile, &tm_c, &bar, 0, c0 + (tb * kTB + j) * kT, b);
    }
  } else {
    stage_tile(Ss, sprev + (((size_t)b * nc + k) * H + h) * N * P, P, N, P, vec_p, tid, nthr);
    for (int j = 0; j < kTB; ++j) {
      const int r0 = (tb * kTB + j) * kT;
      stage_tile(Cs + j * kTile, Cm + ((size_t)b * S + c0 + r0) * N, N,
                 max(0, min(kT, chunk - r0)), N, vec_n, tid, nthr);
    }
  }
  load_u(0, (1 + nt_t) * kTile);  // in flight while the gates are computed
  gates(dts, cs, dt + ((size_t)b * S + c0) * H + h, H, A[h], rows);
  for (int i = rows + tid; i < n_t * kT; i += nthr) cs[i] = dts[i] = 0.f;  // padding rows
  int ph = 0;  // the TMA barrier's phase
  if (use_tma)
    mbar_wait(&bar, (ph++) & 1);
  else
    tiles_ready();
  int loaded = 0;  // the u block in shared memory

  const int r_lo = frag_row(lt, 0);  // this thread's rows r_lo and r_lo + 8 of a tile
  const float d_skip = D[h];
  bf16* yb = y + ((size_t)b * S + c0) * xs + (size_t)h * P;
  float acc[32], s[32];
  uint32_t w[16];
  for (int pass = 0; pass * kScanWG < nt_t; ++pass) {  // passes with a t tile inside
    // tiles {0, 3} and {1, 2}: each warpgroup 5 u tiles of products in a full block
    const int slot = pass == 0 ? wg : kTB - 1 - wg, it = tb * kTB + slot, t0 = it * kT;
    const int j_last = min(it, n_t - 1);  // the last u tile of this t tile
    const uint8_t* Cw = Cs + slot * kTile;
    // the rows' log2-scaled cumsums, f32; rows past the chunk read padding
    float ct[2];
    bool tv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + r_lo + 8 * r;
      tv[r] = t < chunk;
      ct[r] = tv[r] ? cs[t] * kLog2e : 0.f;
    }

    // acc = C_t . S_{k-1}, then each row times exp(cs_t)
    wgmma_fence();
    {
      const uint64_t dc = make_desc(Cw, 128), ds = make_desc(Ss, 128);
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        wgmma_64x64_ss<1>(acc, desc_add(dc, kk * 32), desc_add(ds, kk * 16 * 128), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      acc[i] *= tv[r] ? ex2(ct[r]) : 0.f;
    }

    for (int ub = 0; ub <= tb; ++ub) {  // blocks of kTB u tiles
      if (ub != loaded) {                // uniform over the CTA
        __syncthreads();                 // the last block's products are done
        load_u(ub, 0);
        if (use_tma)
          mbar_wait(&bar, (ph++) & 1);
        else
          tiles_ready();
        loaded = ub;
      }
      const int nj = min(kTB, j_last - ub * kTB + 1);
      for (int jj = 0; jj < nj; ++jj) {
        const int u0 = (ub * kTB + jj) * kT;
        wgmma_fence();
        mma_abt<64, 64>(s, Cw, 0, Bs + jj * kTile, 0);  // s = C_t . B_u^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        // gate: s * exp(cs_t - cs_u) dt_u where u <= t, else 0 (never the
        // exp of a positive sum); each of this thread's 16 columns u once
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int u = u0 + 8 * j + 2 * (lt % 4) + e;
            const float cu = cs[u] * kLog2e, du = dts[u];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * j + 2 * r + e;
              const bool ok = tv[r] && u <= t0 + r_lo + 8 * r;
              s[i] = ok ? s[i] * ex2(ct[r] - cu) * du : 0.f;
            }
          }
        }
        pack_a<64>(w, s);
        wgmma_fence();
        mma_pv<64, kT / 16>(acc, w, Xs + jj * kTile, 0);  // acc += W . x_u
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
    }

    // y = acc + D x_t, x_t from tile `slot` of the last u block (this t
    // tile, in shared memory); columns 2c and 2c + 1 as one bf16 pair
    const uint8_t* Xw = Xs + slot * kTile;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = frag_row(lt, i), p = frag_col(lt, i), t = t0 + r;
      if (t >= chunk || p >= P) continue;
      const __nv_bfloat162 xv =
          *reinterpret_cast<const __nv_bfloat162*>(Xw + swz(r, p / 8) + 2 * (p % 8));
      const float y0 = fmaf(d_skip, __low2float(xv), acc[i]);
      const float y1 = fmaf(d_skip, __high2float(xv), acc[i + 1]);
      const size_t off = (size_t)t * xs + p;
      if (P % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(yb + off) = __floats2bfloat162_rn(y0, y1);
      } else {
        yb[off] = __float2bfloat16_rn(y0);
        if (p + 1 < P) yb[off + 1] = __float2bfloat16_rn(y1);
      }
    }
  }
}

constexpr int kStateSmem = 1024 + 2 * kTB * kTile;  // + alignment slack
// the tiles, then cs and dts (the chunk's rows rounded up to whole tiles)
constexpr int scan_smem(int chunk) {
  return 1024 + (1 + 3 * kTB) * kTile + 8 * kT * ((chunk + kT - 1) / kT);
}

}  // namespace
}  // namespace repro_torch

// bfloat16 only.  x: (b, s, h, p) and B, C: (b, s, n) in bf16; dt: (b, s, h),
// A, D: (h,) in float32; y: (b, s, h, p) in bf16; scratch: states, f32,
// and sprev, bf16, of b * (s / chunk) * h * n * p elements each, totals,
// f32, of b * (s / chunk) * h.  `fin`, null or f32 (b, h, p, n): the state
// after the last token.  All contiguous, 16-byte aligned.  n, p <= 64,
// s % chunk == 0, chunk <= 1024.  Launches three kernels on `stream`,
// allocates nothing, returns the cudaError_t of the launches.
extern "C" int ssd_scan_fwd_sm90(const void* x, const void* dt, const void* A, const void* B,
                                 const void* C, const void* D, void* y, void* states,
                                 void* sprev, void* totals, void* fin, int b, int s, int h,
                                 int p, int n, int chunk, void* stream) {
  using namespace repro_torch;
  const int nc = chunk > 0 ? s / chunk : 0, n_t = (chunk + kT - 1) / kT;
  const int n_tb = (n_t + kTB - 1) / kTB;
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || p > kT || n <= 0 || n > kT || chunk <= 0 ||
      chunk > kMaxChunk || s % chunk != 0 || h > 65535 || b > 65535 ||
      (long long)nc * n_tb > 65535)
    return cudaErrorInvalidValue;
  // once per process (the port drives one card): the tiles exceed 48 KB
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(ssd_state_sm90,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kStateSmem);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(
                                  ssd_scan_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  scan_smem(kMaxChunk));
  }();
  if (attr != cudaSuccess) return attr;
  // TMA tensor maps where the tiles are whole 64-column boxes (n = p = 64,
  // zamba2's widths); else the kernels copy with cp.async
  CUtensorMap tm_x{}, tm_b{}, tm_c{}, tm_s{};
  const int use_tma = p == kT && n == kT;
  if (use_tma && !(sm90::make_map<64>(&tm_x, x, b, s, h, kT) &&
                   sm90::make_map<64>(&tm_b, B, b, s, 1, kT) &&
                   sm90::make_map<64>(&tm_c, C, b, s, 1, kT) &&
                   sm90::make_map<64>(&tm_s, sprev, b * nc * h, n, 1, kT)))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* Bb = static_cast<const bf16*>(B);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  auto* sf = static_cast<float*>(states);
  auto* tf = static_cast<float*>(totals);
  ssd_state_sm90<<<dim3(h, nc, b), kWG, kStateSmem, st>>>(tm_x, tm_b, xb, dtf, Af, Bb, sf, tf, s,
                                                          h, n, p, chunk, use_tma);
  auto* sp = static_cast<bf16*>(sprev);
  ssd_pass<<<dim3((n * p + 255) / 256, h, b), 256, 0, st>>>(sf, tf, sp, static_cast<float*>(fin),
                                                           nc, h, n, p);
  ssd_scan_sm90<<<dim3(h, nc * n_tb, b), kScanWG * kWG, scan_smem(chunk), st>>>(
      tm_x, tm_b, tm_c, tm_s, xb, dtf, Af, Bb, static_cast<const bf16*>(C),
      static_cast<const float*>(D), sp, static_cast<bf16*>(y), s, h, n, p, chunk, use_tma);
  return cudaGetLastError();
}
