// Kernel M, display mode: the fused shear-warp slab march over the int8
// payload, designed for Hopper (sm_90a).
//
// Replaces volrend_tpu/ops/pallas_slab.py:_make_kernel in its display
// option set (sig2 int8 payload, dir_win=True), the Pallas TPU kernel
// behind pallas_slab.march_slabs; its plain PyTorch twin is
// volrend_torch/ops/slab_march.py:march_slabs_ref. The training mode (bf16
// payload, per-slab directions) is slab_march.cu.
//
// What it computes, per pose and intermediate pixel (j, k) of the (gi, gi)
// slope grid, for each occupied slab in march order: dequantize the
// payload (colour codes x qscale, sigma = (hi*128 + lo) x qscale over two
// planes, Dp = 3*bd + 2), mask sigma by the threshold, shade srgb = sigma *
// sigmoid(sum_k code * basis_k * qs_k) with the view direction taken once
// per K-slab window at the window centre, warp [sigma, sigma*r, sigma*g,
// sigma*b] onto the pixel with the separable box-integration two-tap
// weights (edge cells extended to +-inf, global cell indices under the
// crop), then composite tau = sigma_w * dt_pix * frac_z front to back with
// the stop-threshold freeze. Output acc (P, 4, gi, gi) = [r, g, b, T].
//
// What bounds it on the H100: every pose shades every voxel its rays cross
// (the direction is per pose), ~9*bd + 30 fp32 operations a voxel, so a
// 51-pose group is bound by operations (~2.5 ms); the payload is 0.84 GB
// for G=256, SH16. The kernel this one replaced took 14.6x that bound:
// each code was a scalar byte load from device memory and an I2F, each
// 16x16 tile shaded ~1.27x its voxels, each slab ran one synchronous
// chain. This one takes ~10x (25.5 ms, PERF.md). Measured on the card
// (PERF.md's ablations): the conversion is not the limit (one I2F a code
// in place of the byte permute: +6 % on orbit group 0), nor the prefetch
// depth (a ring of two or three smaller stages was slower on every
// display launch measured, +8 % / +20 % on group 0), nor the grid order
// (tile-major: +9 %); what costs is the number of jobs, one (slab,
// footprint piece) each with its block barriers, and the shading work of
// each (an estimate: there is no ncu on the machine).
//
// Design:
// - One block of 256 threads per tile of intermediate pixels and pose,
//   pose-fastest (the blocks resident together read nearly the same
//   footprints of different poses, so L2 serves most of the payload), the
//   tiles in row-major order (launching the central tiles first was
//   slower on 22 of the 27 display launches measured, PERF.md). The
//   tile is 32x16 (two pixels a thread, rows ty and ty + 8), which shades
//   ~1.13 cells a pixel at gi = G, or 32x8 (one pixel a thread, twice the
//   blocks), which balances a launch of few tiles better;
//   slab_march.display_config picks it from the launch's size (measured
//   on every display launch by volrend_torch/probes/display_tiles.py).
// - Staging: per slab the tile's cell footprint (from the affine slope
//   map, extremes at the tile corners, +-1 cell of margin), all Dp planes
//   of it, goes global -> shared with 16-byte cp.async copies, rows of
//   whole 16-byte chunks; each thread walks one (plane, chunk) column down
//   the rows. The copies of the next piece are issued as soon as the
//   current one is shaded, so they overlap its tap sums and the other
//   resident block's work. One stage takes most of the shared memory, so
//   most footprints stage whole; a larger one goes in pieces (the warp is
//   linear, so pieces add). Payloads whose rows are not whole chunks (Gx
//   not a multiple of 16) are staged by the same kernel with plain byte
//   copies, in step. A first version staged with TMA (a 4-D tensor map a
//   box width, one box a footprint row) and faulted on the card with an
//   illegal instruction; a one-box load alone works
//   (volrend_torch/probes/tma_box.py), so the fault lay in that version,
//   which was not pursued: the staging is cp.async.
// - Shading from shared memory: a thread takes two neighbouring cells of
//   one 32-bit word of each plane and turns each int8 code into an exact
//   f32 without I2F: byte-permute the biased byte (w ^ 0x80808080) under
//   the exponent 0x4B00_00xx (2^23 + code + 128), then one FADD of
//   -(2^23 + 128). The basis dot products stay f32 FMAs; sigma's hi*128 +
//   lo stays exact; the sigmoids use the fast exponential and divide. The
//   shaded [sigma, sigma*r, sigma*g, sigma*b] of a cell is one float4, so
//   a pixel's tap reads 16 bytes a cell.
// - Each pixel sums its own separable overlap weights over the cells its
//   span covers (pallas_slab._overlap_mats in f32), composites after the
//   slab's last piece, and the block leaves when no pixel can still
//   accumulate; windows no pixel's z interval meets are never staged, and
//   windows whose pixels all saturated are skipped (__syncthreads_or).
// - __launch_bounds__(256, 2): two blocks (16 warps) per SM, what 123-128
//   registers a thread and ~110 KB of shared memory a block allow; the
//   copies are asynchronous and the other resident block covers them.

#include "slab_common.cuh"

namespace {

constexpr int DTX = 32;            // tile columns: one warp's pixels
constexpr int DWARPS = 8;
constexpr int DNT = DTX * DWARPS;  // threads per block
constexpr int MAX_COLS = 240;      // a piece's columns (its row <= 256 B)
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block can use

struct DispArgs {
  const int8_t* payload;
  const float* params;
  const float* qscale;
  const float* zb;
  const int* wins;
  const int* masks;
  float* acc;
  int n_win, P, G, gi, Dp, Gy, Gx, y0, x0, K, flip;
  int stage_bytes, chan_cells, async, ntx;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// this thread's copies have landed
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// one 32-bit word of codes (four neighbouring cells of one plane), each
// byte biased by 128 for code()
__device__ __forceinline__ uint32_t word(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
}

// code i of a biased word as an exact f32: 0x4B0000uu is 2^23 + uu, uu =
// code + 128, so one FADD of -(2^23 + 128) leaves the code
__device__ __forceinline__ float code(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | i)) -
         8388736.f;
}

__device__ __forceinline__ float fast_sigmoid(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

// the SH basis at the voxel's view direction (slab_common.cuh voxel_rgb's
// direction, at camera distance s of the window centre)
template <int BD>
__device__ __forceinline__ void voxel_basis(const float* prm, float ycm,
                                            float xcm, float s, float ssign,
                                            float* bk) {
  const float dw0 = (prm[21] * ycm + prm[22] * xcm) + prm[20] * s;
  const float dw1 = (prm[24] * ycm + prm[25] * xcm) + prm[23] * s;
  const float dw2 = (prm[27] * ycm + prm[28] * xcm) + prm[26] * s;
  const float rn = rsqrtf(dw0 * dw0 + dw1 * dw1 + dw2 * dw2) * ssign;
  sh_basis<BD>(dw0 * rn, dw1 * rn, dw2 * rn, bk);
}

struct ShadeCtx {
  float invG, cy, cx, sc, ssign, thr;
  const float* prm;
  const float* qs;
};

// Two neighbouring cells, bytes i and i + 1 (i = 0 or 2) of the words at
// ``wp`` (plane 0; planes ``plane`` bytes apart), into out[0..1] as
// [sigma, sigma*r, sigma*g, sigma*b]; zero under the sigma threshold.
// ``gy``/``gx``: the first cell's global indices.
template <int BD>
__device__ __forceinline__ void shade_pair(const uint8_t* wp, int plane,
                                           int i, const ShadeCtx& c, int gy,
                                           int gx, float4* out) {
  constexpr int D = 3 * BD + 1;
  const uint32_t hw = word(wp + (D - 1) * plane);
  const uint32_t lw = word(wp + D * plane);
  const float qsig = c.qs[D - 1];
  const float sa = (code(hw, i) * 128.f + code(lw, i)) * qsig;
  const float sb =
      (code(hw, i + 1) * 128.f + code(lw, i + 1)) * qsig;
  const bool oka = sa > c.thr, okb = sb > c.thr;
  float4 oa = make_float4(0.f, 0.f, 0.f, 0.f), ob = oa;
  if (oka || okb) {
    const float ycm = ((float)gy + 0.5f) * c.invG - c.cy;
    float bka[BD], bkb[BD];
    voxel_basis<BD>(c.prm, ycm, ((float)gx + 0.5f) * c.invG - c.cx, c.sc,
                    c.ssign, bka);
    voxel_basis<BD>(c.prm, ycm, ((float)(gx + 1) + 0.5f) * c.invG - c.cx,
                    c.sc, c.ssign, bkb);
    float ra0 = 0.f, ra1 = 0.f, ra2 = 0.f, rb0 = 0.f, rb1 = 0.f, rb2 = 0.f;
#pragma unroll
    for (int kk = 0; kk < BD; ++kk) {
      const float q = c.qs[kk];
      const float qa = bka[kk] * q, qb = bkb[kk] * q;
      const uint32_t w0 = word(wp + kk * plane);
      const uint32_t w1 = word(wp + (BD + kk) * plane);
      const uint32_t w2 = word(wp + (2 * BD + kk) * plane);
      ra0 += code(w0, i) * qa;
      ra1 += code(w1, i) * qa;
      ra2 += code(w2, i) * qa;
      rb0 += code(w0, i + 1) * qb;
      rb1 += code(w1, i + 1) * qb;
      rb2 += code(w2, i + 1) * qb;
    }
    if (oka)
      oa = make_float4(sa, sa * fast_sigmoid(ra0), sa * fast_sigmoid(ra1),
                       sa * fast_sigmoid(ra2));
    if (okb)
      ob = make_float4(sb, sb * fast_sigmoid(rb0), sb * fast_sigmoid(rb1),
                       sb * fast_sigmoid(rb2));
  }
  out[0] = oa;
  out[1] = ob;
}

// What a block's walk shares: its windows, the slab geometry and its
// tile's corner rays.
struct WalkGeo {
  const int* w;
  const int* m;
  const int* live;
  int n_win, K, flip, G, Dp, stage_bytes, chan_cells, ylo, yhi, xlo, xhi;
  float zbase, cz, cyG, cxG, hG, Gf, ujGa, ujGb, vkGa, vkGb;
};

// The block's walk over its staged jobs, one per (slab, footprint piece),
// in march order: the windows some pixel's z interval meets (live[wi]),
// their occupied slabs, the pieces of each slab's non-empty tile
// footprint: columns of up to MAX_COLS cells, staged from the 16-byte
// chunk of the payload row that holds the first (cs, payload-relative;
// the piece starts xoff cells into it) over BX cells (whole chunks), and
// rows as many as the stage and the shaded-cell buffer hold (RP). The
// producer walks it one job ahead of the consumer.
struct Walk {
  int wi, t, sid, py, px;
  float z;
  Footprint f;

  __device__ int cols() const { return min(MAX_COLS, f.x_hi - px + 1); }
  __device__ int cs(const WalkGeo& g) const { return (px - g.xlo) & ~15; }
  __device__ int xoff(const WalkGeo& g) const { return (px - g.xlo) & 15; }
  __device__ int BX(const WalkGeo& g) const {
    return (xoff(g) + cols() + 15) & ~15;
  }
  __device__ int RP(const WalkGeo& g) const {
    const int bx = BX(g);
    return min(g.stage_bytes / (g.Dp * bx), g.chan_cells / bx);
  }
  __device__ int rows(const WalkGeo& g) const {
    return min(RP(g), f.y_hi - py + 1);
  }
  __device__ bool first_piece() const { return py == f.y_lo && px == f.x_lo; }
  __device__ bool last_piece(const WalkGeo& g) const {
    return px + MAX_COLS > f.x_hi && py + RP(g) > f.y_hi;
  }

  __device__ bool from(const WalkGeo& g, int wi0, int t0) {
    for (wi = wi0, t = t0; wi < g.n_win; ++wi, t = 0) {
      if (!g.live[wi]) continue;
      for (; t < g.K; ++t) {
        const int dzi = g.flip ? (g.K - 1 - t) : t;
        if (!((g.m[wi] >> dzi) & 1)) continue;
        sid = g.w[wi] * g.K + dzi;
        z = ((float)sid + 0.5f) / g.Gf + g.zbase;
        f = tile_footprint(g.cyG, g.cxG, z - g.hG - g.cz, z + g.hG - g.cz,
                           g.ujGa, g.ujGb, g.vkGa, g.vkGb, g.G, g.ylo, g.yhi,
                           g.xlo, g.xhi);
        if (f.y_lo > f.y_hi || f.x_lo > f.x_hi) continue;
        py = f.y_lo;
        px = f.x_lo;
        return true;
      }
    }
    return false;
  }

  __device__ bool next(const WalkGeo& g) {
    py += RP(g);
    if (py <= f.y_hi) return true;
    py = f.y_lo;
    px += MAX_COLS;
    if (px <= f.x_hi) return true;
    return from(g, wi, t + 1);
  }
};

// every thread: its share of the walk's current piece into ``st`` as
// 16-byte cp.async copies, stage row ly holding the DP planes of BX cells
// of payload row py + ly. A thread takes one (plane, chunk) column of the
// piece and walks it down the rows, so each copy costs two adds; the
// caller commits the group.
template <int DP>
__device__ __forceinline__ void copy_piece(const int8_t* payload,
                                           const Walk& pw, const WalkGeo& g,
                                           uint8_t* st, int tid, int Gy,
                                           int Gx, int y0) {
  const int bx = pw.BX(g);
  const int nch = bx >> 4;
  const int rows = pw.rows(g);
  const size_t plane = (size_t)Gy * Gx;
  const int8_t* base = payload + (size_t)pw.sid * DP * plane +
                       (size_t)(pw.py - y0) * Gx + pw.cs(g);
  const int rstride = DP * bx;
  for (int u = tid; u < DP * nch; u += DNT) {
    const int d = u / nch, ch = u - d * nch;
    const int8_t* src = base + d * plane + 16 * ch;
    uint8_t* dst = st + d * bx + 16 * ch;
    for (int ly = 0; ly < rows; ++ly) {
      cp_async16(dst, src);
      src += Gx;
      dst += rstride;
    }
  }
}

// A block: one tile of ROWS x 8 rows and 32 columns of one pose; a
// thread owns column k of rows j0 + warp + 8 * rr.
template <int BD, int ROWS>
__global__ void __launch_bounds__(DNT, 2) display_kernel(const DispArgs a) {
  constexpr int DP = 3 * BD + 2;
  constexpr int TY = DWARPS * ROWS;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float s_prm[NP];
  __shared__ float s_qs[DP];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int bid = (int)blockIdx.x;
  const int p = bid % a.P, tile = bid / a.P;  // pose fastest
  const int j0 = (tile / a.ntx) * TY, k0 = (tile % a.ntx) * DTX;
  const int G = a.G, gi = a.gi;
  float4* s_chan = reinterpret_cast<float4*>(smem + a.stage_bytes);
  int* s_w = reinterpret_cast<int*>(s_chan + a.chan_cells);
  int* s_m = s_w + a.n_win;
  int* s_live = s_m + a.n_win;

  if (tid < NP) s_prm[tid] = a.params[(size_t)p * NP + tid];
  for (int i = tid; i < DP; i += DNT) s_qs[i] = a.qscale[i];
  for (int i = tid; i < a.n_win; i += DNT) {
    s_w[i] = a.wins[i];
    s_m[i] = a.masks[i];
    s_live[i] = 0;
  }
  __syncthreads();

  const float Gf = (float)G;
  const float cz = s_prm[0], cy = s_prm[1], cx = s_prm[2];
  const float u0 = s_prm[3], du = s_prm[4], v0 = s_prm[5], dv = s_prm[6];
  const float sigma_thresh = s_prm[14], stop_thresh = s_prm[15];
  const float zbase = s_prm[30];
  const float cyG = cy * Gf, cxG = cx * Gf;
  const float hG = 0.5f / Gf;
  const int K = a.K;

  // this thread's pixels: column k, rows j0 + warp + 8 * rr
  const size_t npx = (size_t)gi * gi;
  const int k = k0 + lane;
  bool inpix[ROWS];
  float zlo[ROWS], zhi[ROWS], dtp[ROWS], ujG[ROWS];
  float r[ROWS], g[ROWS], b[ROWS], T[ROWS];
  float4 w4[ROWS];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int j = j0 + warp + DWARPS * rr;
    inpix[rr] = (j < gi) && (k < gi);
    zlo[rr] = 1.f;  // an empty interval off-grid
    zhi[rr] = 0.f;
    dtp[rr] = 0.f;
    if (inpix[rr]) {
      const float* zbp = a.zb + (size_t)p * 4 * npx + (size_t)j * gi + k;
      zlo[rr] = zbp[0];
      zhi[rr] = zbp[npx];
      dtp[rr] = zbp[2 * npx];
    }
    ujG[rr] = (u0 + du * (float)j) * Gf;
    r[rr] = g[rr] = b[rr] = 0.f;
    T[rr] = 1.f;
    w4[rr] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float vkG = (v0 + dv * (float)k) * Gf;

  // the windows some pixel's z interval meets: only these are staged
  for (int wi = 0; wi < a.n_win; ++wi) {
    const int w = s_w[wi];
    const float zw0 = (float)(w * K) / Gf + zbase;
    const float zw1 = ((float)(w * K) + (float)K) / Gf + zbase;
    bool any = false;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr)
      any |= inpix[rr] && (zlo[rr] <= zhi[rr]) && (zlo[rr] <= zw1) &&
             (zhi[rr] >= zw0);
    if (__ballot_sync(0xffffffffu, any) && lane == 0) s_live[wi] = 1;
  }
  __syncthreads();

  const int jl = min(j0 + TY, gi) - 1, kl = min(k0 + DTX, gi) - 1;
  WalkGeo wg;
  wg.w = s_w;
  wg.m = s_m;
  wg.live = s_live;
  wg.n_win = a.n_win;
  wg.K = K;
  wg.flip = a.flip;
  wg.G = G;
  wg.Dp = DP;
  wg.stage_bytes = a.stage_bytes;
  wg.chan_cells = a.chan_cells;
  wg.ylo = a.y0;
  wg.yhi = a.y0 + a.Gy - 1;
  wg.xlo = a.x0;
  wg.xhi = a.x0 + a.Gx - 1;
  wg.zbase = zbase;
  wg.cz = cz;
  wg.cyG = cyG;
  wg.cxG = cxG;
  wg.hG = hG;
  wg.Gf = Gf;
  wg.ujGa = (u0 + du * (float)j0) * Gf;
  wg.ujGb = (u0 + du * (float)jl) * Gf;
  wg.vkGa = (v0 + dv * (float)k0) * Gf;
  wg.vkGb = (v0 + dv * (float)kl) * Gf;
  Walk cw;
  bool has = cw.from(wg, 0, 0);

  // the producer: every thread copies its share, one job ahead
  Walk pw = cw;
  bool p_has = has;
  uint8_t* const st = smem;
  if (a.async) {
    if (p_has) {
      copy_piece<DP>(a.payload, pw, wg, st, tid, a.Gy, a.Gx, a.y0);
      p_has = pw.next(wg);
    }
    cp_async_commit();
    cp_async_wait();
    __syncthreads();
  }

  ShadeCtx sh;
  sh.invG = 1.f / Gf;
  sh.cy = cy;
  sh.cx = cx;
  sh.thr = sigma_thresh;
  sh.prm = s_prm;
  sh.qs = s_qs;
  sh.sc = 0.f;
  sh.ssign = 0.f;

  int cur_wi = -1;
  bool work = false;
  while (has) {
    if (cw.wi != cur_wi) {
      // a new window: leave when no pixel can still accumulate; skip the
      // window's shading when no live pixel meets it
      cur_wi = cw.wi;
      const int w = s_w[cw.wi];
      const float zw0 = (float)(w * K) / Gf + zbase;
      const float zw1 = ((float)(w * K) + (float)K) / Gf + zbase;
      bool alive_any = false, live_any = false;
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const bool passed = a.flip ? (zw1 < zlo[rr]) : (zw0 > zhi[rr]);
        const bool alive = inpix[rr] && (T[rr] >= stop_thresh) &&
                           (zlo[rr] <= zhi[rr]) && !passed;
        alive_any |= alive;
        live_any |= alive && (zlo[rr] <= zw1) && (zhi[rr] >= zw0);
      }
      if (!__syncthreads_or(alive_any)) break;
      work = __syncthreads_or(live_any);
      // view directions once per window, at the window centre
      sh.sc = ((float)(w * K) + 0.5f * (float)K) / Gf + zbase - cz;
      sh.ssign = sign_of(sh.sc);
    }
    const int FY = cw.rows(wg), FX = cw.cols(), BX = cw.BX(wg);
    // the piece's cells are row bytes [xoff, xoff + FX) of the stage, from
    // payload column cs (global column x0 + cs + byte)
    const int xoff = cw.xoff(wg), gx0 = a.x0 + cw.cs(wg);
    if (!a.async) {
      // synchronous staging: the piece's rows, lanes along x
      const int8_t* src = a.payload + (size_t)cw.sid * DP * a.Gy * a.Gx;
      const int cs = cw.cs(wg);
      for (int row = warp; row < FY * DP; row += DWARPS) {
        const int ly = row / DP, d = row - ly * DP;
        const int gy = cw.py - a.y0 + ly;
        for (int lx = lane; lx < BX; lx += 32) {
          const int gx = cs + lx;
          st[row * BX + lx] =
              gx < a.Gx ? (uint8_t)src[((size_t)d * a.Gy + gy) * a.Gx + gx]
                        : 0;
        }
      }
      __syncthreads();
    }

    if (work) {
      // two cells a thread: pairs p_lo .. of each row
      const int p_lo = xoff >> 1;
      const int pcols = ((xoff + FX - 1) >> 1) - p_lo + 1;
      const int units = FY * pcols;
      for (int u = tid; u < units; u += DNT) {
        const int ly = u / pcols, x = 2 * (p_lo + u - ly * pcols);
        shade_pair<BD>(st + ly * DP * BX + (x & ~3), BX, x & 3, sh,
                       cw.py + ly, gx0 + x, s_chan + ly * BX + x);
      }
    }
    __syncthreads();  // the stage is consumed, s_chan is complete
    if (a.async) {
      if (p_has) {
        copy_piece<DP>(a.payload, pw, wg, st, tid, a.Gy, a.Gx, a.y0);
        p_has = pw.next(wg);
      }
      cp_async_commit();
    }
    if (work) {
      const float z = cw.z;
      const float s0 = z - hG - cz, s1 = z + hG - cz;
      const bool first = cw.first_piece(), last = cw.last_piece(wg);
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        if (!inpix[rr]) continue;
        if (first) w4[rr] = make_float4(0.f, 0.f, 0.f, 0.f);
        const PixelSpan sp = pixel_span(cyG, cxG, s0, s1, ujG[rr], vkG, G,
                                        cw.f);
        const int ya = max(sp.ry_lo, cw.py);
        const int yb = min(sp.ry_hi, cw.py + FY - 1);
        const int xa = max(sp.rx_lo, cw.px);
        const int xb = min(sp.rx_hi, cw.px + FX - 1);
        float4 acc = w4[rr];
        for (int cyy = ya; cyy <= yb; ++cyy) {
          const float wr = overlap(cyy, G, sp.pmin, sp.pmax, sp.inv_r);
          const float4* row = s_chan + (cyy - cw.py) * BX;
          for (int cxx = xa; cxx <= xb; ++cxx) {
            const float wgt = wr * overlap(cxx, G, sp.qmin, sp.qmax, sp.inv_c);
            const float4 v = row[cxx - gx0];
            acc.x += wgt * v.x;
            acc.y += wgt * v.y;
            acc.z += wgt * v.z;
            acc.w += wgt * v.w;
          }
        }
        w4[rr] = acc;
        if (last) {
          // boundary slabs contribute by their overlap with [zlo, zhi]
          const float frac = fminf(
              fmaxf((fminf(z + hG, zhi[rr]) - fmaxf(z - hG, zlo[rr])) * Gf,
                    0.f),
              1.f);
          const float tau = acc.x * dtp[rr] * frac;
          const float att = __expf(-tau);
          const float sig_inv = 1.f / fmaxf(acc.x, 1e-12f);
          if (T[rr] >= stop_thresh && tau > 0.f) {
            const float wn = (T[rr] * (1.f - att)) * sig_inv;
            r[rr] += wn * acc.y;
            g[rr] += wn * acc.z;
            b[rr] += wn * acc.w;
            T[rr] = T[rr] * att;
          }
        }
      }
    }
    has = cw.next(wg);
    if (a.async) cp_async_wait();  // the next job's copies
    __syncthreads();  // ... are in for all threads; s_chan has been read
  }
  // a block that leaves early waits for the copies it still has in flight
  if (a.async) asm volatile("cp.async.wait_all;" ::: "memory");

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    if (!inpix[rr]) continue;
    const int j = j0 + warp + DWARPS * rr;
    float* out = a.acc + (size_t)p * 4 * npx + (size_t)j * gi + k;
    out[0] = r[rr];
    out[npx] = g[rr];
    out[2 * npx] = b[rr];
    out[3 * npx] = T[rr];
  }
}

using KernFn = void (*)(const DispArgs);

template <int BD>
KernFn pick_rows(int rows) {
  switch (rows) {
    case 1: return display_kernel<BD, 1>;
    case 2: return display_kernel<BD, 2>;
    default: return nullptr;
  }
}

KernFn pick(int bd, int rows) {
  switch (bd) {
    case 1: return pick_rows<1>(rows);
    case 4: return pick_rows<4>(rows);
    case 9: return pick_rows<9>(rows);
    case 16: return pick_rows<16>(rows);
    case 25: return pick_rows<25>(rows);
    default: return nullptr;
  }
}

// Let ``fn`` take ``smem`` bytes of dynamic shared memory; the attribute is
// set again only when a kernel's size changes (one host call saved a
// launch, which counts for one-pose launches).
cudaError_t allow_smem(KernFn fn, int smem) {
  static KernFn fns[32];
  static int sizes[32];
  static int n = 0;
  int i = 0;
  while (i < n && fns[i] != fn) ++i;
  if (i < n && sizes[i] == smem) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && i < 32) {
    fns[i] = fn;
    sizes[i] = smem;
    if (i == n) ++n;
  }
  return e;
}

// The dynamic shared memory of a launch (slab_march.display_config): the
// stage, the float4 shaded cells, three ints a window.
int display_smem(int stage_bytes, int chan_cells, int n_win) {
  return stage_bytes + 16 * chan_cells + 12 * n_win;
}

}  // namespace

// wins_masks: (2, n_win) int32 on the device — window ids then occupancy
// bit masks, in march order. rows: pixel rows a thread (1: 32x8 tiles, 2:
// 32x16). stage_bytes: the stage's size (a multiple of 16, at least one
// 256-cell row of Dp planes); chan_cells: the shaded-cell buffer's cells
// (>= 256). A payload whose rows are whole 16-byte chunks of a 16-byte
// aligned base is staged with cp.async, any other with byte copies.
// Returns cudaGetLastError() after the launch.
extern "C" int vt_march_display(const void* payload, const void* params,
                                const void* qscale, const void* zb,
                                const void* wins_masks, int n_win, void* acc,
                                int P, int G, int gi, int Dp, int Gy, int Gx,
                                int y0, int x0, int bd, int K, int flip,
                                int rows, int stage_bytes, int chan_cells,
                                void* stream) {
  if (Dp != 3 * bd + 2 || P < 1 || gi < 1 || K < 1 || n_win < 1 ||
      Dp > 256 || stage_bytes % 16 || stage_bytes < Dp * 256 ||
      chan_cells < 256)
    return (int)cudaErrorInvalidValue;
  // cp.async moves whole 16-byte chunks of 16-byte aligned rows
  const bool async = Gx % 16 == 0 && (uintptr_t)payload % 16 == 0;
  const KernFn fn = pick(bd, rows);
  if (!fn) return (int)cudaErrorInvalidValue;
  const int ntx = (gi + DTX - 1) / DTX;
  const int nty = (gi + DWARPS * rows - 1) / (DWARPS * rows);
  const long long blocks = (long long)P * ntx * nty;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = display_smem(stage_bytes, chan_cells, n_win);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int* wins = (const int*)wins_masks;
  DispArgs a;
  a.payload = (const int8_t*)payload;
  a.params = (const float*)params;
  a.qscale = (const float*)qscale;
  a.zb = (const float*)zb;
  a.wins = wins;
  a.masks = wins + n_win;
  a.acc = (float*)acc;
  a.n_win = n_win;
  a.P = P;
  a.G = G;
  a.gi = gi;
  a.Dp = Dp;
  a.Gy = Gy;
  a.Gx = Gx;
  a.y0 = y0;
  a.x0 = x0;
  a.K = K;
  a.flip = flip;
  a.stage_bytes = stage_bytes;
  a.chan_cells = chan_cells;
  a.async = async ? 1 : 0;
  a.ntx = ntx;
  const cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<(unsigned)blocks, DNT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// What the card makes of the kernel for ``bd`` and ``rows`` at ``smem``
// bytes of dynamic shared memory: out[0] resident blocks per SM, out[1]
// registers a thread, out[2] local (spill) bytes a thread, out[3] static
// shared bytes.
extern "C" int vt_march_display_info(int bd, int rows, int smem, int* out) {
  const KernFn fn = pick(bd, rows);
  if (!fn || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, DNT, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes at;
  e = cudaFuncGetAttributes(&at, fn);
  if (e != cudaSuccess) return (int)e;
  out[1] = at.numRegs;
  out[2] = (int)at.localSizeBytes;
  out[3] = (int)at.sharedSizeBytes;
  return 0;
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
