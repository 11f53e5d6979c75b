// Kernel M, display mode: the fused shear-warp slab march over the int8
// or bf16 display payload, designed for Hopper (sm_90a).
//
// Replaces volrend_tpu/ops/pallas_slab.py:_make_kernel in its display
// option set (dir_win=True: the sig2 int8 payload or the f16 bake's bf16
// one; SH, SG, ASG and RGBA; depth, rot, a non-full bbox, the basis
// window), the Pallas TPU kernel behind pallas_slab.march_slabs; its plain
// PyTorch twin is volrend_torch/ops/slab_march.py:march_slabs_ref. The
// training mode (f32/bf16 bake, per-slab directions) is slab_march.cu.
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
// - __launch_bounds__(256, 2): two blocks (16 warps) per SM, what <= 128
//   registers a thread and ~110 KB of shared memory a block allow; the
//   copies are asynchronous and the other resident block covers them.
// - One kernel template, display_kernel<BD, ROWS, V>; the variant V
//   (Var<bf16, format, options>) picks the payload element, the format
//   and whether the run-time options are compiled in. The default, SH on
//   the int8 payload with no option, is Var<false, F_SH, false>. The bf16
//   payload (the f16 bake) holds two cells in a 32-bit word (each to f32
//   by an exact 16-bit shift), a 16-byte chunk 8 cells, and its stage is
//   sized in bytes (half the cells of an int8 stage: more footprints go in
//   pieces, which add). The option variants (one tile height, 32x8) take
//   the rest at run time:
//   SG and ASG (lobe counts up to 4, 9, 16 or 25 compiled, the count at
//   run time; the lobes loaded once a block into shared memory; the
//   int8 bake shares each lobe's scale across rgb, so the per-k basis x
//   qs[k] trick holds), RGBA (no basis, no sigmoid, a scale a channel),
//   depth (sigma alone warped: one tap channel, and the composite adds
//   w * |z - z0| * tview), rot (9 floats on the window direction), the
//   basis window (the MACs of the dropped planes skipped) and the bbox (an
//   in-plane voxel-extent mask ANDed into the sigma mask).
// - The display knobs (the reference's pallas_slab._DIR_WIN and
//   _BF16_SHADE, pallas_slab.py:85-107): per-slab view directions
//   (dir_win=False) need nothing of the kernel: each voxel's basis is
//   evaluated at the window centre's distance, so a launch with one-slab
//   windows (K = 1, slab_march.march_slabs) takes each slab's own; bf16 SH
//   shading is an option variant of its own,
//   Var<bf16, F_SH, true, true> at 32x8 on both payloads (degrees 0-4):
//   each cell pair's basis planes times their scale are rounded to a bf16
//   pair (__floats2bfloat162_rn) and each colour's sum over the planes is
//   one __hfma2 a plane (fused, rounded to bf16), the codes exact in bf16;
//   the sigmoid stays f32. It halves the multiply-adds but takes the 32x8
//   tile of the option variants and packs the pairs: on an orbit group
//   it runs slower than the default (PERF.md), as the reference's knob,
//   off by default, is a TPU lane-packing trick.

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

struct ShadeCtx {
  float invG, cy, cx, sc, ssign, thr;
  const float* prm;
  const float* qs;
};

// What a block's walk shares: its windows, the slab geometry and its
// tile's corner rays.
struct WalkGeo {
  const int* w;
  const int* m;
  const int* live;
  int n_win, K, flip, G, Dp, stage_bytes, chan_cells, ylo, yhi, xlo, xhi;
  float zbase, cz, cyG, cxG, hG, Gf, ujGa, ujGb, vkGa, vkGb;
};

// A variant: the payload's element, the basis format, whether the
// run-time options (depth, rot, bbox, basis window, lobe count) are
// compiled in, and whether each pixel resumes from the state ``acc``
// holds (RS: a z-segment after upstream ones; only in the resume build).
template <bool BF, int FM, bool O, bool BS = false, bool RS = false>
struct Var {
  static constexpr bool BF16 = BF;         // bf16 (Dp = D), else int8 (D + 1)
  static constexpr int FMT = FM;
  static constexpr bool OPT = O;
  static constexpr bool BSH = BS;          // SH shading in bf16 pairs
  static constexpr bool RESUME = RS;       // start from acc, not (0, 1)
  static constexpr int ESZ = BF ? 2 : 1;   // bytes a cell of one plane
  static constexpr int CH = 16 / ESZ;      // cells a 16-byte chunk
  static constexpr int SIGP = BF ? 1 : 2;  // sigma planes
};

// a launch's arguments: the payload, geometry and stage, and the run-time
// options (read by the option variants only)
struct LaunchArgs {
  DispArgs a;
  const float* extra;
  int nb, depth, rot_on, bbox, blo, bhi;
  float rot[9];
};

// The two neighbouring cells of one plane a shading unit takes: int8 codes
// i and i + 1 of the (biased) word at p, or the bf16 pair of the word at p
// (each an exact f32 by a 16-bit shift).
template <bool BF>
__device__ __forceinline__ float2 cell_pair(const uint8_t* p, int i) {
  if constexpr (BF) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  } else {
    const uint32_t w = word(p);
    return make_float2(code(w, i), code(w, i + 1));
  }
}

// the same pair as a bf16 pair (exact: an int8 code has 8 significant
// bits; a bf16 payload word holds the pair as it is)
template <bool BF>
__device__ __forceinline__ __nv_bfloat162 cell_pair16(const uint8_t* p,
                                                      int i) {
  if constexpr (BF) {
    return *reinterpret_cast<const __nv_bfloat162*>(p);
  } else {
    const float2 c = cell_pair<false>(p, i);
    return __floats2bfloat162_rn(c.x, c.y);
  }
}

// The option variants' run-time state: the rotation (9 floats in shared
// memory, or null), the lobes' parameters (shared memory; SG 4, ASG 11
// floats a lobe), the lobe count, the basis window [blo, bhi], depth mode,
// and the in-plane box of params 16-19 with the half cell h.
struct OptCtx {
  const float* rot;
  const float* ext;
  int nb, blo, bhi, depth, bbox;
  float inv_nb, lo1, hi1, lo2, hi2, h;
};

// The basis of variant V at the voxel's view direction (slab_common.cuh
// view_dir, at camera distance c.sc of the window centre, rotated by o.rot
// first); lobes past the count are zero.
template <int BD, class V>
__device__ __forceinline__ void voxel_basis(const ShadeCtx& c,
                                            const OptCtx& o, float ycm,
                                            float xcm, float* bk) {
  float x, y, z;
  view_dir(c.prm, ycm, xcm, c.sc, c.ssign, x, y, z);
  if constexpr (V::OPT) {
    if (o.rot) rotate(o.rot, x, y, z);
  }
  basis_at<BD, V::FMT>(x, y, z, o.ext, o.nb, o.inv_nb, bk);
}

// Two neighbouring cells of the stage at ``wp`` (int8: the word that
// holds them, cells i and i + 1, i = 0 or 2; bf16: their word), planes
// ``plane`` bytes apart, D data planes (int8: sigma's hi plane D - 1 and
// lo plane D; bf16: sigma in plane D - 1), into out[0..1] as [sigma,
// sigma*r, sigma*g, sigma*b]; zero under the sigma threshold. ``gy``/
// ``gx``: the first cell's global indices.
template <int BD, class V>
__device__ __forceinline__ void shade_pair(const uint8_t* wp, int plane,
                                           int i, const ShadeCtx& c,
                                           const OptCtx& o, int D, int gy,
                                           int gx, float4* out) {
  const float qsig = c.qs[D - 1];
  float sa, sb;
  if constexpr (V::BF16) {
    const float2 s = cell_pair<true>(wp + (D - 1) * plane, i);
    sa = s.x * qsig;
    sb = s.y * qsig;
  } else {
    const float2 h = cell_pair<false>(wp + (D - 1) * plane, i);
    const float2 l = cell_pair<false>(wp + D * plane, i);
    sa = (h.x * 128.f + l.x) * qsig;
    sb = (h.y * 128.f + l.y) * qsig;
  }
  bool oka = sa > c.thr, okb = sb > c.thr;
  if constexpr (V::OPT) {
    if (o.bbox) {
      // the voxel's extent meets the in-plane box (pallas_slab._shade_pre)
      const float yc = ((float)gy + 0.5f) * c.invG;
      const float xa = ((float)gx + 0.5f) * c.invG;
      const float xb = ((float)(gx + 1) + 0.5f) * c.invG;
      const bool yin = (yc + o.h > o.lo1) && (yc - o.h < o.hi1);
      oka = oka && yin && (xa + o.h > o.lo2) && (xa - o.h < o.hi2);
      okb = okb && yin && (xb + o.h > o.lo2) && (xb - o.h < o.hi2);
    }
    if (o.depth) {
      out[0] = make_float4(oka ? sa : 0.f, 0.f, 0.f, 0.f);
      out[1] = make_float4(okb ? sb : 0.f, 0.f, 0.f, 0.f);
      return;
    }
  }
  float4 oa = make_float4(0.f, 0.f, 0.f, 0.f), ob = oa;
  if (oka || okb) {
    if constexpr (V::FMT == F_RGBA) {
      // raw colours: no basis, no sigmoid, a scale a channel
      const float2 c0 = cell_pair<V::BF16>(wp, i);
      const float2 c1 = cell_pair<V::BF16>(wp + plane, i);
      const float2 c2 = cell_pair<V::BF16>(wp + 2 * plane, i);
      const float q0 = c.qs[0], q1 = c.qs[1], q2 = c.qs[2];
      if (oka)
        oa = make_float4(sa, sa * (c0.x * q0), sa * (c1.x * q1),
                         sa * (c2.x * q2));
      if (okb)
        ob = make_float4(sb, sb * (c0.y * q0), sb * (c1.y * q1),
                         sb * (c2.y * q2));
    } else {
      const int nb = V::FMT == F_SH ? BD : o.nb;
      const float ycm = ((float)gy + 0.5f) * c.invG - c.cy;
      float bka[BD], bkb[BD];
      voxel_basis<BD, V>(c, o, ycm, ((float)gx + 0.5f) * c.invG - c.cx,
                         bka);
      voxel_basis<BD, V>(c, o, ycm,
                         ((float)(gx + 1) + 0.5f) * c.invG - c.cx, bkb);
      float ra0 = 0.f, ra1 = 0.f, ra2 = 0.f, rb0 = 0.f, rb1 = 0.f,
            rb2 = 0.f;
      if constexpr (V::BSH) {
        // bf16 SH shading: the pair's scaled basis planes as a bf16 pair,
        // one fused bf16 multiply-add a colour and plane
        __nv_bfloat162 r0 = __float2bfloat162_rn(0.f), r1 = r0, r2 = r0;
#pragma unroll
        for (int kk = 0; kk < BD; ++kk) {
          if (kk < o.blo || kk > o.bhi) continue;
          const float q = c.qs[kk];
          const __nv_bfloat162 qab =
              __floats2bfloat162_rn(bka[kk] * q, bkb[kk] * q);
          r0 = __hfma2(cell_pair16<V::BF16>(wp + kk * plane, i), qab, r0);
          r1 = __hfma2(cell_pair16<V::BF16>(wp + (nb + kk) * plane, i), qab,
                       r1);
          r2 = __hfma2(cell_pair16<V::BF16>(wp + (2 * nb + kk) * plane, i),
                       qab, r2);
        }
        ra0 = __low2float(r0);
        rb0 = __high2float(r0);
        ra1 = __low2float(r1);
        rb1 = __high2float(r1);
        ra2 = __low2float(r2);
        rb2 = __high2float(r2);
      } else {
#pragma unroll
        for (int kk = 0; kk < BD; ++kk) {
          if constexpr (V::OPT) {
            // the basis window and the lobe count: skip the plane's MACs
            if (kk < o.blo || kk > o.bhi || kk >= nb) continue;
          }
          const float q = c.qs[kk];
          const float qa = bka[kk] * q, qb = bkb[kk] * q;
          const float2 c0 = cell_pair<V::BF16>(wp + kk * plane, i);
          const float2 c1 = cell_pair<V::BF16>(wp + (nb + kk) * plane, i);
          const float2 c2 =
              cell_pair<V::BF16>(wp + (2 * nb + kk) * plane, i);
          ra0 += c0.x * qa;
          ra1 += c1.x * qa;
          ra2 += c2.x * qa;
          rb0 += c0.y * qb;
          rb1 += c1.y * qb;
          rb2 += c2.y * qb;
        }
      }
      if (oka)
        oa = make_float4(sa, sa * fast_sigmoid(ra0), sa * fast_sigmoid(ra1),
                         sa * fast_sigmoid(ra2));
      if (okb)
        ob = make_float4(sb, sb * fast_sigmoid(rb0), sb * fast_sigmoid(rb1),
                         sb * fast_sigmoid(rb2));
    }
  }
  out[0] = oa;
  out[1] = ob;
}

// The block's walk over its staged jobs, one per (slab, footprint piece),
// in march order: the windows some pixel's z interval meets (live[wi]),
// their occupied slabs, the pieces of each slab's non-empty tile
// footprint: columns of up to MAX_COLS cells, staged from the 16-byte
// chunk of the payload row that holds the first (cs, payload-relative;
// the piece starts xoff cells into it) over BX cells (whole chunks of CH
// cells of ESZ bytes), and rows as many as the stage (in bytes) and the
// shaded-cell buffer hold (RP). The producer walks it one job ahead of the
// consumer.
template <int CH, int ESZ>
struct Walk {
  int wi, t, sid, py, px;
  float z;
  Footprint f;

  __device__ int cols() const { return min(MAX_COLS, f.x_hi - px + 1); }
  __device__ int cs(const WalkGeo& g) const {
    return (px - g.xlo) & ~(CH - 1);
  }
  __device__ int xoff(const WalkGeo& g) const {
    return (px - g.xlo) & (CH - 1);
  }
  __device__ int BX(const WalkGeo& g) const {
    return (xoff(g) + cols() + CH - 1) & ~(CH - 1);
  }
  __device__ int RP(const WalkGeo& g) const {
    const int bx = BX(g);
    return min(g.stage_bytes / (g.Dp * bx * ESZ), g.chan_cells / bx);
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
// (ESZ bytes each) of payload row py + ly. A thread takes one (plane,
// chunk) column of the piece and walks it down the rows, so each copy
// costs two adds; the caller commits the group.
template <int ESZ, class W>
__device__ __forceinline__ void copy_piece(const int8_t* payload,
                                           const W& pw, const WalkGeo& g,
                                           uint8_t* st, int tid, int Gy,
                                           int Gx, int y0, const int DP) {
  const int bx = pw.BX(g);
  const int rows = pw.rows(g);
  const size_t plane = (size_t)Gy * Gx;
  const int nch = (bx * ESZ) >> 4;
  const uint8_t* base =
      reinterpret_cast<const uint8_t*>(payload) +
      ((size_t)pw.sid * DP * plane + (size_t)(pw.py - y0) * Gx + pw.cs(g)) *
          ESZ;
  const int rstride = DP * bx * ESZ;
  for (int u = tid; u < DP * nch; u += DNT) {
    const int d = u / nch, ch = u - d * nch;
    const uint8_t* src = base + d * plane * ESZ + 16 * ch;
    uint8_t* dst = st + d * bx * ESZ + 16 * ch;
    for (int ly = 0; ly < rows; ++ly) {
      cp_async16(dst, src);
      src += Gx * ESZ;
      dst += rstride;
    }
  }
}

// A block: one tile of ROWS x 8 rows and 32 columns of one pose; a
// thread owns column k of rows j0 + warp + 8 * rr. V: the payload
// element, format and options; BD: the SH basis dimension, the largest
// SG/ASG lobe count of the instantiation, or 1 for RGBA.
template <int BD, int ROWS, class V>
__global__ void __launch_bounds__(DNT, 2)
    display_kernel(const LaunchArgs args) {
  const DispArgs& a = args.a;
  // planes: compile-time for SH and RGBA, the lobe count's for SG/ASG
  constexpr int DPC = V::FMT == F_SH     ? 3 * BD + V::SIGP
                      : V::FMT == F_RGBA ? 3 + V::SIGP
                                         : 0;
  constexpr int DPMAX = DPC ? DPC : 3 * BD + V::SIGP;
  const int DP = DPC ? DPC : a.Dp;
  constexpr int TY = DWARPS * ROWS;
  using WalkV = Walk<V::CH, V::ESZ>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float s_prm[NP];
  __shared__ float s_qs[DPMAX];

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
  OptCtx o{};  // read by the option variants only
  if constexpr (V::OPT) {
    constexpr int EXW = V::FMT == F_SG ? 4 : V::FMT == F_ASG ? 11 : 0;
    float* s_opt = opt_smem<9 + EXW * BD>();
#pragma unroll
    for (int r = 0; r < 9; ++r)
      if (tid == r) s_opt[r] = args.rot[r];
    for (int i = tid; i < EXW * args.nb; i += DNT)
      s_opt[9 + i] = args.extra[i];
    o.rot = args.rot_on ? s_opt : nullptr;
    o.ext = s_opt + 9;
    o.nb = args.nb;
    o.blo = args.blo;
    o.bhi = args.bhi;
    o.depth = args.depth;
    o.bbox = args.bbox;
    o.inv_nb = 1.f / (float)args.nb;
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
  bool depth = false;  // the sigma channel alone is warped
  if constexpr (V::OPT) {
    o.lo1 = s_prm[16];
    o.hi1 = s_prm[17];
    o.lo2 = s_prm[18];
    o.hi2 = s_prm[19];
    o.h = hG;
    depth = args.depth != 0;
  }

  // this thread's pixels: column k, rows j0 + warp + 8 * rr
  const size_t npx = (size_t)gi * gi;
  const int k = k0 + lane;
  bool inpix[ROWS];
  float zlo[ROWS], zhi[ROWS], dtp[ROWS], ujG[ROWS];
  float r[ROWS], g[ROWS], b[ROWS], T[ROWS];
  float tvb[ROWS];  // depth mode's tview base (zb plane 3)
  float4 w4[ROWS];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int j = j0 + warp + DWARPS * rr;
    inpix[rr] = (j < gi) && (k < gi);
    zlo[rr] = 1.f;  // an empty interval off-grid
    zhi[rr] = 0.f;
    dtp[rr] = 0.f;
    tvb[rr] = 0.f;
    if (inpix[rr]) {
      const float* zbp = a.zb + (size_t)p * 4 * npx + (size_t)j * gi + k;
      zlo[rr] = zbp[0];
      zhi[rr] = zbp[npx];
      dtp[rr] = zbp[2 * npx];
      if (depth) tvb[rr] = zbp[3 * npx];
    }
    ujG[rr] = (u0 + du * (float)j) * Gf;
    r[rr] = g[rr] = b[rr] = 0.f;
    T[rr] = 1.f;
    if constexpr (V::RESUME) {
      if (inpix[rr]) {
        const float* in = a.acc + (size_t)p * 4 * npx + (size_t)j * gi + k;
        r[rr] = in[0];
        g[rr] = in[npx];
        b[rr] = in[2 * npx];
        T[rr] = in[3 * npx];
      }
    }
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
  WalkV cw;
  bool has = cw.from(wg, 0, 0);

  // the producer: every thread copies its share, one job ahead
  WalkV pw = cw;
  bool p_has = has;
  uint8_t* const st = smem;
  if (a.async) {
    if (p_has) {
      copy_piece<V::ESZ>(a.payload, pw, wg, st, tid, a.Gy, a.Gx, a.y0, DP);
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
    // the piece's cells are row cells [xoff, xoff + FX) of the stage, from
    // payload column cs (global column x0 + cs + cell)
    const int xoff = cw.xoff(wg), gx0 = a.x0 + cw.cs(wg);
    if (!a.async) {
      // synchronous staging: the piece's rows, lanes along x
      const int cs = cw.cs(wg);
      if constexpr (V::BF16) {
        const uint16_t* src =
            reinterpret_cast<const uint16_t*>(a.payload) +
            (size_t)cw.sid * DP * a.Gy * a.Gx;
        uint16_t* st16 = reinterpret_cast<uint16_t*>(st);
        for (int row = warp; row < FY * DP; row += DWARPS) {
          const int ly = row / DP, d = row - ly * DP;
          const int gy = cw.py - a.y0 + ly;
          for (int lx = lane; lx < BX; lx += 32) {
            const int gx = cs + lx;
            st16[row * BX + lx] =
                gx < a.Gx ? src[((size_t)d * a.Gy + gy) * a.Gx + gx]
                          : (uint16_t)0;
          }
        }
      } else {
        const int8_t* src = a.payload + (size_t)cw.sid * DP * a.Gy * a.Gx;
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
        if constexpr (V::BF16) {
          shade_pair<BD, V>(st + 2 * (ly * DP * BX + x), 2 * BX, 0, sh, o,
                            DP, cw.py + ly, gx0 + x, s_chan + ly * BX + x);
        } else {
          shade_pair<BD, V>(st + ly * DP * BX + (x & ~3), BX, x & 3, sh, o,
                            DP - 1, cw.py + ly, gx0 + x,
                            s_chan + ly * BX + x);
        }
      }
    }
    __syncthreads();  // the stage is consumed, s_chan is complete
    if (a.async) {
      if (p_has) {
        copy_piece<V::ESZ>(a.payload, pw, wg, st, tid, a.Gy, a.Gx, a.y0, DP);
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
        if (depth) {
          for (int cyy = ya; cyy <= yb; ++cyy) {
            const float wr = overlap(cyy, G, sp.pmin, sp.pmax, sp.inv_r);
            const float4* row = s_chan + (cyy - cw.py) * BX;
            for (int cxx = xa; cxx <= xb; ++cxx)
              acc.x += wr * overlap(cxx, G, sp.qmin, sp.qmax, sp.inv_c) *
                       row[cxx - gx0].x;
          }
        } else {
          for (int cyy = ya; cyy <= yb; ++cyy) {
            const float wr = overlap(cyy, G, sp.pmin, sp.pmax, sp.inv_r);
            const float4* row = s_chan + (cyy - cw.py) * BX;
            for (int cxx = xa; cxx <= xb; ++cxx) {
              const float wgt =
                  wr * overlap(cxx, G, sp.qmin, sp.qmax, sp.inv_c);
              const float4 v = row[cxx - gx0];
              acc.x += wgt * v.x;
              acc.y += wgt * v.y;
              acc.z += wgt * v.z;
              acc.w += wgt * v.w;
            }
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
          if (depth) {
            // depth: w * |z - z0| * tview (pallas_slab.py's depth mode)
            if (T[rr] >= stop_thresh && tau > 0.f) {
              r[rr] += (T[rr] * (1.f - att)) * fabsf(z - s_prm[29]) *
                       tvb[rr];
              T[rr] = T[rr] * att;
            }
          } else {
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

using KernFn = void (*)(const LaunchArgs);

// The instantiations: SH (degrees 0-4) without options on both payloads
// at both tile heights; SH with options, SH with bf16 shading (which takes
// the options too), SG and ASG (lobe counts up to 4, 9, 16, 25) and RGBA,
// on both payloads, at 32x8.
template <int BD, class V>
KernFn pick_rows(int rows) {
  if (rows == 1) return display_kernel<BD, 1, V>;
  if constexpr (!V::OPT) {
    if (rows == 2) return display_kernel<BD, 2, V>;
  }
  return nullptr;
}

template <class V>
KernFn pick_sh(int bd, int rows) {
  switch (bd) {
    case 1: return pick_rows<1, V>(rows);
    case 4: return pick_rows<4, V>(rows);
    case 9: return pick_rows<9, V>(rows);
    case 16: return pick_rows<16, V>(rows);
    case 25: return pick_rows<25, V>(rows);
    default: return nullptr;
  }
}

template <class V>
KernFn pick_lobes(int nb, int rows) {
  if (nb < 1 || rows != 1) return nullptr;
  if (nb <= 4) return display_kernel<4, 1, V>;
  if (nb <= 9) return display_kernel<9, 1, V>;
  if (nb <= 16) return display_kernel<16, 1, V>;
  if (nb <= 25) return display_kernel<25, 1, V>;
  return nullptr;
}

// The source is built twice (volrend_torch/kernels): VT_DISPLAY_SET 0
// holds every variant above; 1, the resume build
// (slab_march_display_resume), holds the option variants (opt 1 and 3)
// with RS, which a z-segment's launch with an upstream state takes (SH
// without options as the option variant at its defaults), so the
// defaults' code stays as it is.
#ifndef VT_DISPLAY_SET
#define VT_DISPLAY_SET 0
#endif
constexpr bool RS_SET = VT_DISPLAY_SET == 1;

// opt: 0 the defaults, 1 the option variants, 3 SH's bf16 shading
template <bool BF>
KernFn pick_payload(int bd, int rows, int fmt, int opt) {
  if (opt == 3)
    return fmt == F_SH
               ? pick_sh<Var<BF, F_SH, true, true, RS_SET>>(bd, rows)
               : nullptr;
  if (opt != 0 && opt != 1) return nullptr;
  if (fmt == F_SH) {
    if (opt) return pick_sh<Var<BF, F_SH, true, false, RS_SET>>(bd, rows);
    if constexpr (RS_SET) return nullptr;
    else return pick_sh<Var<BF, F_SH, false>>(bd, rows);
  }
  if (!opt || rows != 1) return nullptr;
  switch (fmt) {
    case F_SG:
      return pick_lobes<Var<BF, F_SG, true, false, RS_SET>>(bd, rows);
    case F_ASG:
      return pick_lobes<Var<BF, F_ASG, true, false, RS_SET>>(bd, rows);
    case F_RGBA:
      return display_kernel<1, 1, Var<BF, F_RGBA, true, false, RS_SET>>;
    default: return nullptr;
  }
}

// the kernel of (bd, rows, fmt, bf16, opt); null when none is built
const void* pick_any(int bd, int rows, int fmt, int bf16, int opt) {
  return bf16 ? (const void*)pick_payload<true>(bd, rows, fmt, opt)
              : (const void*)pick_payload<false>(bd, rows, fmt, opt);
}

// Let ``fn`` take ``smem`` bytes of dynamic shared memory; the attribute is
// set again only when a kernel's size changes (one host call saved a
// launch, which counts for one-pose launches).
cudaError_t allow_smem(const void* fn, int smem) {
  static const void* fns[64];
  static int sizes[64];
  static int n = 0;
  int i = 0;
  while (i < n && fns[i] != fn) ++i;
  if (i < n && sizes[i] == smem) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && i < 64) {
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

// wins_masks: (2, n_win) int32 on the device — window ids then occupancy bit
// masks, in march order. acc: the (P, 4, gi, gi) [r, g, b, T] output; in the
// resume build it holds on entry the state each pixel starts from (a
// z-segment's upstream segments'; the payload a z-segment of the grid whose
// global z is params[30]), and only opt 1 and 3 are built there. rows: pixel
// rows a thread (1: 32x8 tiles, 2: 32x16). stage_bytes: the stage's size (a
// multiple of 16, at least one 256-cell row of Dp planes); chan_cells: the
// shaded-cell buffer's cells (>= 256). A payload whose rows are whole 16-byte
// chunks of a 16-byte aligned base is staged with cp.async, any other with
// element copies. The variant: fmt (0 RGBA, bd = -1; 1 SH; 2 SG, 3 ASG with bd
// lobes, 1 to 25, whose parameters ``extra`` holds on the device), bf16 (the
// f16 bake's payload, Dp = D; else int8, Dp = D + 1) and opt (1: the option
// variant, which every format but SH needs, and SH with depth, rot (9 floats
// on the host), bbox (params 16-19), a basis window [basis_lo, basis_hi] that
// drops planes; 3: SH's bf16-shading variant, which takes the same options).
// Returns cudaGetLastError() after the launch.
extern "C" int vt_march_display(const void* payload, const void* params,
                                const void* qscale, const void* zb,
                                const void* wins_masks, int n_win, void* acc,
                                int P, int G, int gi, int Dp, int Gy, int Gx,
                                int y0, int x0, int bd, int K, int flip,
                                int rows, int stage_bytes, int chan_cells,
                                int fmt, int bf16, int opt, const void* extra,
                                int depth, int rot_on, const void* rot,
                                int bbox, int basis_lo, int basis_hi,
                                void* stream) {
  const int esz = bf16 ? 2 : 1, sigp = bf16 ? 1 : 2;
  const int D = fmt == F_RGBA ? 4 : 3 * bd + 1;
  const bool cuts = fmt == F_SH && (basis_lo > 0 || basis_hi < bd - 1);
  if ((fmt == F_RGBA) != (bd < 0) || Dp != D - 1 + sigp || P < 1 ||
      gi < 1 || K < 1 || n_win < 1 || Dp > 256 || stage_bytes % 16 ||
      stage_bytes < Dp * 256 * esz || chan_cells < 256 ||
      (!opt && (fmt != F_SH || depth || rot_on || bbox || cuts)) ||
      (rot_on && !rot) || (fmt >= F_SG && !extra))
    return (int)cudaErrorInvalidValue;
  // cp.async moves whole 16-byte chunks of 16-byte aligned rows
  const bool async = (Gx * esz) % 16 == 0 && (uintptr_t)payload % 16 == 0;
  const void* fn = pick_any(bd, rows, fmt, bf16, opt);
  if (!fn) return (int)cudaErrorInvalidValue;
  const int ntx = (gi + DTX - 1) / DTX;
  const int nty = (gi + DWARPS * rows - 1) / (DWARPS * rows);
  const long long blocks = (long long)P * ntx * nty;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = display_smem(stage_bytes, chan_cells, n_win);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int* wins = (const int*)wins_masks;
  LaunchArgs v;
  DispArgs& a = v.a;
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
  v.extra = (const float*)extra;
  v.nb = fmt == F_RGBA ? 1 : bd;
  v.depth = depth;
  v.rot_on = rot_on;
  v.bbox = bbox;
  v.blo = basis_lo;
  v.bhi = basis_hi;
  for (int i = 0; i < 9; ++i)
    v.rot[i] = rot_on ? ((const float*)rot)[i] : (i % 4 == 0 ? 1.f : 0.f);
  const cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  ((KernFn)fn)<<<(unsigned)blocks, DNT, smem, (cudaStream_t)stream>>>(v);
  return (int)cudaGetLastError();
}

// What the card makes of the variant (bd, rows, fmt, bf16, opt as for
// vt_march_display) at ``smem`` bytes of dynamic shared memory: out[0]
// resident blocks per SM, out[1] registers a thread, out[2] local (spill)
// bytes a thread, out[3] static shared bytes.
extern "C" int vt_march_display_info(int bd, int rows, int fmt, int bf16,
                                     int opt, int smem, int* out) {
  const void* fn = pick_any(bd, rows, fmt, bf16, opt);
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
