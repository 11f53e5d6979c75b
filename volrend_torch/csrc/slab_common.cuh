// Device helpers shared by kernel M (slab_march.cu) and its backward
// (slab_march_bwd.cu): the SH basis, the box-integration overlap weight,
// payload loads for both payload types, the per-voxel shading, and the
// per-slab footprint shading with each pixel's tap sum. Both kernels
// include this one copy, so the backward's forward recompute does the same
// float operations as the forward march.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;              // intermediate pixels per block side
constexpr int NTHREADS = TILE * TILE;
constexpr int FMAX = 40;              // footprint piece side, in cells
constexpr int NP = 31;                // params per pose (see _pack_params)

// SH normalization constants (lumisphere.hpp:38-80)
constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
constexpr float C2_0 = 1.0925484305920792f, C2_1 = -1.0925484305920792f,
                C2_2 = 0.31539156525252005f, C2_3 = -1.0925484305920792f,
                C2_4 = 0.5462742152960396f;
constexpr float C3_0 = -0.5900435899266435f, C3_1 = 2.890611442640554f,
                C3_2 = -0.4570457994644658f, C3_3 = 0.3731763325901154f,
                C3_4 = -0.4570457994644658f, C3_5 = 1.445305721320277f,
                C3_6 = -0.5900435899266435f;
constexpr float C4_0 = 2.5033429417967046f, C4_1 = -1.7701307697799304f,
                C4_2 = 0.9461746957575601f, C4_3 = -0.6690465435572892f,
                C4_4 = 0.10578554691520431f, C4_5 = -0.6690465435572892f,
                C4_6 = 0.47308734787878004f, C4_7 = -1.7701307697799304f,
                C4_8 = 0.6258357354491761f;

// real SH basis at unit direction (x, y, z), in the reference's order
template <int BD>
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* bk) {
  bk[0] = C0;
  if constexpr (BD >= 4) {
    bk[1] = -C1 * y;
    bk[2] = C1 * z;
    bk[3] = -C1 * x;
  }
  if constexpr (BD >= 9) {
    const float xx = x * x, yy = y * y, zz = z * z;
    bk[4] = C2_0 * x * y;
    bk[5] = C2_1 * y * z;
    bk[6] = C2_2 * (2.f * zz - xx - yy);
    bk[7] = C2_3 * x * z;
    bk[8] = C2_4 * (xx - yy);
    if constexpr (BD >= 16) {
      bk[9] = C3_0 * y * (3.f * xx - yy);
      bk[10] = C3_1 * x * y * z;
      bk[11] = C3_2 * y * (4.f * zz - xx - yy);
      bk[12] = C3_3 * z * (2.f * zz - 3.f * xx - 3.f * yy);
      bk[13] = C3_4 * x * (4.f * zz - xx - yy);
      bk[14] = C3_5 * z * (xx - yy);
      bk[15] = C3_6 * x * (xx - 3.f * yy);
    }
    if constexpr (BD >= 25) {
      bk[16] = C4_0 * x * y * (xx - yy);
      bk[17] = C4_1 * y * z * (3.f * xx - yy);
      bk[18] = C4_2 * x * y * (7.f * zz - 1.f);
      bk[19] = C4_3 * y * z * (7.f * zz - 3.f);
      bk[20] = C4_4 * (zz * (35.f * zz - 30.f) + 3.f);
      bk[21] = C4_5 * x * z * (7.f * zz - 3.f);
      bk[22] = C4_6 * (xx - yy) * (7.f * zz - 1.f);
      bk[23] = C4_7 * x * z * (xx - 3.f * yy);
      bk[24] = C4_8 * (xx * (xx - 3.f * yy) - yy * (3.f * xx - yy));
    }
  }
}

// floor(v) clamped to [lo, hi], safe for any float (incl. huge values)
__device__ __forceinline__ int cell_floor(float v, int lo, int hi) {
  return (int)fminf(fmaxf(floorf(v), (float)lo), (float)hi);
}

// overlap of the span [pmin, pmax] with GLOBAL cell c, divided by the span
// length (edge cells extend to +-inf: out-of-grid span mass clamps to
// them, as the octree query clamps positions into the unit cube)
__device__ __forceinline__ float overlap(int c, int G, float pmin,
                                         float pmax, float inv) {
  const float hi = (c >= G - 1) ? 1e9f : (float)(c + 1);
  const float lo = (c <= 0) ? -1e9f : (float)c;
  return fminf(fmaxf((fminf(hi, pmax) - fmaxf(lo, pmin)) * inv, 0.f), 1.f);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float sign_of(float s) {
  return (s > 0.f) ? 1.f : ((s < 0.f) ? -1.f : 0.f);
}

// one payload value as f32: an int8 code or a bf16 value
__device__ __forceinline__ float ld(const int8_t* p) { return (float)*p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// sigma of the voxel at ``src`` (plane 0 of that voxel; planes ``plane``
// apart): int8 payloads split a 14-bit code over planes D-1 (hi) and D
// (lo); bf16 payloads hold sigma in plane D-1
template <int D>
__device__ __forceinline__ float voxel_sigma(const int8_t* src, size_t plane,
                                             const float* qs) {
  return ((float)src[(size_t)(D - 1) * plane] * 128.f +
          (float)src[(size_t)D * plane]) * qs[D - 1];
}
template <int D>
__device__ __forceinline__ float voxel_sigma(const __nv_bfloat16* src,
                                             size_t plane, const float* qs) {
  return __bfloat162float(src[(size_t)(D - 1) * plane]) * qs[D - 1];
}

// the SH basis at the voxel's view direction and the voxel's rgb. The
// direction is affine in the voxel's slope coordinates: s * dir =
// dirM[:,0] * s + dirM[:,1] * ycm + dirM[:,2] * xcm (params 20:29), for the
// camera distance ``s`` of the slab (per slab) or of the window centre
// (display path); ``ssign`` = sign(s). The basis is scaled once per k by
// qs[k] (the bake shares each basis function's scale across rgb).
template <int BD, typename PayT>
__device__ __forceinline__ void voxel_rgb(const PayT* src, size_t plane,
                                          const float* qs, const float* prm,
                                          float ycm, float xcm, float s,
                                          float ssign, float* bk,
                                          float* rgb) {
  const float dw0 = (prm[21] * ycm + prm[22] * xcm) + prm[20] * s;
  const float dw1 = (prm[24] * ycm + prm[25] * xcm) + prm[23] * s;
  const float dw2 = (prm[27] * ycm + prm[28] * xcm) + prm[26] * s;
  const float rn = rsqrtf(dw0 * dw0 + dw1 * dw1 + dw2 * dw2) * ssign;
  sh_basis<BD>(dw0 * rn, dw1 * rn, dw2 * rn, bk);
  float raw0 = 0.f, raw1 = 0.f, raw2 = 0.f;
#pragma unroll
  for (int kk = 0; kk < BD; ++kk) {
    const float bq = bk[kk] * qs[kk];
    raw0 += ld(src + (size_t)kk * plane) * bq;
    raw1 += ld(src + (size_t)(BD + kk) * plane) * bq;
    raw2 += ld(src + (size_t)(2 * BD + kk) * plane) * bq;
  }
  rgb[0] = sigmoid(raw0);
  rgb[1] = sigmoid(raw1);
  rgb[2] = sigmoid(raw2);
}

// A tile's cell footprint at one slab, in global cells (+-1 cell of
// rounding margin), clipped to [lo, hi] on each axis. The slope map is
// affine in the pixel index, so the span extremes are at the tile's first
// and last rows/columns (ray slopes x G: ujGa/ujGb, vkGa/vkGb).
struct Footprint {
  int y_lo, y_hi, x_lo, x_hi;
};

__device__ __forceinline__ Footprint tile_footprint(
    float cyG, float cxG, float s0, float s1, float ujGa, float ujGb,
    float vkGa, float vkGb, int G, int ylo, int yhi, int xlo, int xhi) {
  const float ya0 = cyG + s0 * ujGa, ya1 = cyG + s1 * ujGa;
  const float yb0 = cyG + s0 * ujGb, yb1 = cyG + s1 * ujGb;
  const float xa0 = cxG + s0 * vkGa, xa1 = cxG + s1 * vkGa;
  const float xb0 = cxG + s0 * vkGb, xb1 = cxG + s1 * vkGb;
  Footprint f;
  f.y_lo = max(cell_floor(fminf(fminf(ya0, ya1), fminf(yb0, yb1)), 0, G - 1)
               - 1, ylo);
  f.y_hi = min(cell_floor(fmaxf(fmaxf(ya0, ya1), fmaxf(yb0, yb1)), 0, G - 1)
               + 1, yhi);
  f.x_lo = max(cell_floor(fminf(fminf(xa0, xa1), fminf(xb0, xb1)), 0, G - 1)
               - 1, xlo);
  f.x_hi = min(cell_floor(fmaxf(fmaxf(xa0, xa1), fmaxf(xb0, xb1)), 0, G - 1)
               + 1, xhi);
  return f;
}

// One pixel's spans through a slab along rows (p) and columns (q), in
// global cells (ujG/vkG: its ray slopes x G), with the cells they cover
// inside the tile's footprint.
struct PixelSpan {
  float pmin, pmax, inv_r, qmin, qmax, inv_c;
  int ry_lo, ry_hi, rx_lo, rx_hi;
};

__device__ __forceinline__ PixelSpan pixel_span(float cyG, float cxG,
                                                float s0, float s1, float ujG,
                                                float vkG, int G,
                                                const Footprint& f) {
  PixelSpan sp;
  const float p0 = cyG + s0 * ujG, p1 = cyG + s1 * ujG;
  sp.pmin = fminf(p0, p1);
  sp.pmax = fmaxf(p0, p1);
  sp.inv_r = 1.f / fmaxf(sp.pmax - sp.pmin, 1e-9f);
  const float q0 = cxG + s0 * vkG, q1 = cxG + s1 * vkG;
  sp.qmin = fminf(q0, q1);
  sp.qmax = fmaxf(q0, q1);
  sp.inv_c = 1.f / fmaxf(sp.qmax - sp.qmin, 1e-9f);
  sp.ry_lo = max(cell_floor(sp.pmin, 0, G - 1), f.y_lo);
  sp.ry_hi = min(cell_floor(sp.pmax, 0, G - 1), f.y_hi);
  sp.rx_lo = max(cell_floor(sp.qmin, 0, G - 1), f.x_lo);
  sp.rx_hi = min(cell_floor(sp.qmax, 0, G - 1), f.x_hi);
  return sp;
}

// The forward's per-slab work, shared by kernel M and the backward's
// recompute so that both follow the same trajectory: the block shades its
// footprint into shared memory as [sigma, sigma*r, sigma*g, sigma*b] (zero
// under the sigma threshold; the colour planes are read only above it), in
// pieces of FMAX x FMAX cells, and each pixel sums its overlap-weighted
// taps. Returns (sw, rw, gw, bw) for this thread's pixel (zero if !inpix).
// Every thread of the block must call it (it synchronizes). ``slab`` is the
// slab's plane 0 in a (Dp, Gy, Gx) payload cropped at (y0, x0); ``sd`` and
// ``sdsign`` the camera distance of the shading directions and its sign.
template <int BD, typename PayT>
__device__ __forceinline__ float4 shade_and_sum(
    const PayT* slab, size_t plane, int Gx, int y0, int x0,
    const Footprint& f, const PixelSpan& sp, bool inpix, int tid, int G,
    float cy, float cx, float sigma_thresh, float sd, float sdsign,
    const float* s_qs, const float* s_prm, float (*s_chan)[FMAX][FMAX + 1]) {
  constexpr int D = 3 * BD + 1;
  const float Gf = (float)G;
  float sw = 0.f, rw = 0.f, gw = 0.f, bw = 0.f;
  for (int py0 = f.y_lo; py0 <= f.y_hi; py0 += FMAX) {
    const int FY = min(FMAX, f.y_hi - py0 + 1);
    for (int px0 = f.x_lo; px0 <= f.x_hi; px0 += FMAX) {
      const int FX = min(FMAX, f.x_hi - px0 + 1);
      __syncthreads();  // the previous piece has been consumed
      for (int i = tid; i < FY * FX; i += NTHREADS) {
        const int ly = i / FX, lx = i - ly * FX;
        const int gy = py0 + ly, gx = px0 + lx;
        const PayT* src = slab + (size_t)(gy - y0) * Gx + (gx - x0);
        const float sig = voxel_sigma<D>(src, plane, s_qs);
        float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
        if (sig > sigma_thresh) {
          const float ycm = ((float)gy + 0.5f) * (1.f / Gf) - cy;
          const float xcm = ((float)gx + 0.5f) * (1.f / Gf) - cx;
          float bk[BD], rgb[3];
          voxel_rgb<BD>(src, plane, s_qs, s_prm, ycm, xcm, sd, sdsign, bk,
                        rgb);
          o0 = sig;
          o1 = sig * rgb[0];
          o2 = sig * rgb[1];
          o3 = sig * rgb[2];
        }
        s_chan[0][ly][lx] = o0;
        s_chan[1][ly][lx] = o1;
        s_chan[2][ly][lx] = o2;
        s_chan[3][ly][lx] = o3;
      }
      __syncthreads();
      if (inpix) {
        const int ya = max(sp.ry_lo, py0), yb = min(sp.ry_hi, py0 + FY - 1);
        const int xa = max(sp.rx_lo, px0), xb = min(sp.rx_hi, px0 + FX - 1);
        for (int cyy = ya; cyy <= yb; ++cyy) {
          const float wr = overlap(cyy, G, sp.pmin, sp.pmax, sp.inv_r);
          const int ly = cyy - py0;
          for (int cxx = xa; cxx <= xb; ++cxx) {
            const float wgt = wr * overlap(cxx, G, sp.qmin, sp.qmax, sp.inv_c);
            const int lx = cxx - px0;
            sw += wgt * s_chan[0][ly][lx];
            rw += wgt * s_chan[1][ly][lx];
            gw += wgt * s_chan[2][ly][lx];
            bw += wgt * s_chan[3][ly][lx];
          }
        }
      }
    }
  }
  return make_float4(sw, rw, gw, bw);
}

}  // namespace
