// Kernel W: the fused superquad display warp, for Hopper (sm_90a).
//
// Replaces, on the display path, the pair of TPU kernels
// volrend_tpu/ops/display_warp.py:_make_build (the window-table build) and
// display_warp.py:_make_combine_kernel (the tent-combine and emit), with
// the geometry the reference computes in XLA between them
// (_level_geometry and the fit predicates _pixel_slopes/_level_fits,
// display_warp.py:389-575). Its plain PyTorch twins are
// volrend_torch/ops/display_warp.py:warp_display_ref and
// level_fit_counts_ref. Kernels B (csrc/warp_build.cu) and C
// (csrc/warp_combine.cu) keep their table modes for the precise training
// warp.
//
// What it computes, for one cascade level ((By, Bx) screen blocks, a
// Wy x Wx window) and the poses of a list, from the (P, 4, gi, gi) f32
// planar intermediate image and a (P, 16) f32 row of per-pose scalars
// (the three linear forms of the pixel -> slope homography, fx, fy, u0,
// du, v0, dv; display_warp.display_params):
// - each pixel's slope-grid position with the operations and rounding of
//   display_warp._sub_slopes, every multiply, add and divide rounded on its
//   own (nvcc would contract them into FMAs), so the ok masks, the window
//   corners and the fit decisions are bit-equal to the plain version's;
// - the block's window corner from the minimum over its in-grid subpixels,
//   clamped to [0, gi - W];
// - the window's cells read straight from the planar image and quantized
//   on load with kernel B's rule, round_half_even(clip(v, 0, 1) * 255) -
//   128, so the codes equal B's table;
// - the tent-combine in kernel C's cell order (cy outer, cx inner) and
//   arithmetic, the affine dequant, the ok mask and the composite over the
//   background;
// - RGBA8 (rounded half to even after a [0, 1] clamp) or f32, written in
//   place into the listed poses' frames of a (P, H, W, 4) output.
// Fit mode (vt_warp_fit): per cascade level and pose, in one launch, the
// count of blocks whose extents over their in-grid subpixels overflow the
// window (a block with none fits), summed with integer atomics, so the
// count is deterministic. A pixel's position does not depend on the level:
// the production cascade ((4, 4) x (5, 5) over (2, 2) x (4, 4)) has a
// kernel of its own (fit_cascade: the divides of screen_x and screen_y
// and the forms' products taken once a column and a row, the positions
// kept in registers, the (4, 4) extents the min and max of the (2, 2)
// ones); other levels whose blocks nest in a super block of at most 16
// pixels compute each position once for all levels through shared memory
// (fit_nested), any other each level its own (fit_kernel). Its bound is
// the arithmetic of its correctly rounded divides: one reciprocal and two
// divides a pixel, which the reference's fit rule needs bit for bit.
//
// What bounds it on the H100: bytes. Per pose at 800^2, gi = 256 and the
// (4, 4) x (5, 5) level it reads the 1 MB intermediate once and writes the
// 2.56 MB RGBA8 frame: a 51-pose group is ~0.055 ms at 3.35 TB/s. A
// pixel's position is clamped into its window, so at most 2 x 2 of its
// tent weights are non-zero: the function needs the homography, those
// taps and the composite (~90 flops a pixel, ~0.045 ms of fp32 work).
//
// Design: one thread per screen block (16 pixels at the production level),
// so the block's window corner, its 25 cells and their quantization are
// computed once for its pixels. The production levels are instantiated
// with their sizes as constants (the loops unroll fully): the pixels'
// positions stay in registers from the corner pass to the emit, and the
// window's cells, read through L1 from the planar image (neighbouring
// threads read neighbouring windows) and quantized on load, go to shared
// memory as four byte codes a cell, cell-major, so that each pixel reads
// only the 2 x 2 cells its tent weights reach (64 registers, 12.8 KB of
// shared memory a 128-thread block, no spills). The cells it skips have
// weight 0: the sums equal kernel C's over the whole window bit for bit.
// Any other level (any block side that tiles the screen, windows up to
// 8 x 8, as kernel C takes) runs a generic kernel with rolled loops that
// reads each pixel's 2 x 2 cells straight from the planar image. No index
// division or modulus runs per pixel (one 32-bit division a thread); a row
// of a block's RGBA8 pixels leaves as one 16-byte (4-wide blocks) or
// 8-byte (2-wide) store, so a warp writes 512 contiguous bytes of a screen
// row. The kernel writes nothing but the frames: no window table, no
// per-subpixel geometry, no index-put.
//
// Mesh-background mode (vt_warp_display_mesh): replaces the reference
// combine kernel's has_mesh mode (display_warp.py:228, its mesh planes at
// :282-293, fed by _combine_emit(mesh_planes=) and warp_to_screen_sq's
// bg_pix). Each pixel also reads its pose's (P, H, W, 4) f16 background
// [r, g, b, hit] (display_warp.mesh_background; 8 bytes a pixel) and
// composites over it: the colour is tent + bgc * (1 - a) where the pixel is
// in the grid and bgc elsewhere, bgc the mesh colour where hit and the flat
// background where not, and alpha is 1 where hit. It adds 8 bytes a pixel
// to the bytes that bound the warp (5.1 MB a pose at 800^2 beside the
// 2.56 MB RGBA8 frame) and nothing to the window's work. The mode is a
// template flag of the same kernels, so every cascade level composites the
// mesh, and the no-mesh instantiations, whose entry points keep their
// parameters, compile as before (their registers and spills are pinned by
// tests/test_torch_cuda.py). One pose at the production level takes about
// W's time on the same inputs (PERF.md: 0.0119 against 0.0116 ms): at one
// pose both are bound by the launch, not by the extra bytes.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NPRM = 16;   // floats per pose in the parameter rows
constexpr int MAXW = 8;    // largest window side (as kernel C)
constexpr int THREADS = 128;

struct Pose {
  float a[9];  // den, nu, nv: x, y and constant coefficients each
  float fx, fy, u0, du, v0, dv;
};

__device__ __forceinline__ Pose load_pose(const float* __restrict__ prm) {
  Pose s;
#pragma unroll
  for (int i = 0; i < 9; ++i) s.a[i] = __ldg(prm + i);
  s.fx = __ldg(prm + 9);
  s.fy = __ldg(prm + 10);
  s.u0 = __ldg(prm + 11);
  s.du = __ldg(prm + 12);
  s.v0 = __ldg(prm + 13);
  s.dv = __ldg(prm + 14);
  return s;
}

// screen column x (row y) as the homography's x (y) coordinate:
// display_warp._sub_slopes's (x - W/2) / fx and -(y - H/2) / fy
__device__ __forceinline__ float screen_x(int x, int W, float fx) {
  return __fdiv_rn((float)x - 0.5f * (float)W, fx);
}

__device__ __forceinline__ float screen_y(int y, int H, float fy) {
  return __fdiv_rn(-((float)y - 0.5f * (float)H), fy);
}

// one linear form of _lin_forms: (xs * a[0] + ys * a[1]) - a[2]
__device__ __forceinline__ float lin(const float* a, float xs, float ys) {
  return __fsub_rn(__fadd_rn(__fmul_rn(xs, a[0]), __fmul_rn(ys, a[1])),
                   a[2]);
}

// the slope-grid position (gy, gx) of the pixel at (xs, ys):
// (nu * inv - u0) / du and (nv * inv - v0) / dv with inv = 1 / den
// (|den| < 1e-12 taken as 1e-12, display_warp._safe_inv)
__device__ __forceinline__ void position(const Pose& s, float xs, float ys,
                                         float& gy, float& gx) {
  const float den = lin(s.a, xs, ys);
  const float nu = lin(s.a + 3, xs, ys);
  const float nv = lin(s.a + 6, xs, ys);
  const float inv = __frcp_rn(fabsf(den) < 1e-12f ? 1e-12f : den);
  gy = __fdiv_rn(__fsub_rn(__fmul_rn(nu, inv), s.u0), s.du);
  gx = __fdiv_rn(__fsub_rn(__fmul_rn(nv, inv), s.v0), s.dv);
}

// kernel B's affine int8 code of a value, as an exact float
__device__ __forceinline__ float code(float v) {
  return rintf(fminf(fmaxf(v, 0.f), 1.f) * 255.f) - 128.f;
}

__device__ __forceinline__ uint32_t rgba8(float o0, float o1, float o2,
                                          float o3) {
  const uint32_t r = (uint32_t)rintf(fminf(fmaxf(o0, 0.f), 1.f) * 255.f);
  const uint32_t g = (uint32_t)rintf(fminf(fmaxf(o1, 0.f), 1.f) * 255.f);
  const uint32_t b = (uint32_t)rintf(fminf(fmaxf(o2, 0.f), 1.f) * 255.f);
  const uint32_t a = (uint32_t)rintf(fminf(fmaxf(o3, 0.f), 1.f) * 255.f);
  return r | (g << 8) | (b << 16) | (a << 24);
}

// the window corner (Y0, X0) of the block at (hh, wh) of pose s: the
// floor of the minimum over its in-grid subpixels, clamped to [0, gi - w]
// (0 for a block with none); by, bx may be run-time values
__device__ __forceinline__ void corner(const Pose& s, int hh, int wh, int by,
                                       int bx, int gi, int H, int W, int wy,
                                       int wx, int& Y0, int& X0) {
  const float gmax = (float)(gi - 1);
  const float hi = (float)((double)(gi - 1) - 1e-6);  // the clamp's f32
  float ymin = 1e9f, xmin = 1e9f;
  bool any = false;
  for (int r = 0; r < by; ++r) {
    const float ys = screen_y(hh * by + r, H, s.fy);
    for (int q = 0; q < bx; ++q) {
      float gy, gx;
      position(s, screen_x(wh * bx + q, W, s.fx), ys, gy, gx);
      if (gy >= 0.f && gy <= gmax && gx >= 0.f && gx <= gmax) {
        any = true;
        ymin = fminf(ymin, fminf(gy, hi));
        xmin = fminf(xmin, fminf(gx, hi));
      }
    }
  }
  Y0 = any ? min(max((int)floorf(ymin), 0), gi - wy) : 0;
  X0 = any ? min(max((int)floorf(xmin), 0), gi - wx) : 0;
}

// kernel C's dequant, ok mask and composite over the background of one
// pixel's tent sums
__device__ __forceinline__ float4 composite(float a0, float a1, float a2,
                                            float a3, bool ok, float bg,
                                            float qscale, float qshift) {
  a0 = a0 * qscale + qshift;
  a1 = a1 * qscale + qshift;
  a2 = a2 * qscale + qshift;
  a3 = a3 * qscale + qshift;
  const float rem = bg * (1.f - a3);
  return ok ? make_float4(a0 + rem, a1 + rem, a2 + rem, a3)
            : make_float4(bg, bg, bg, 0.f);
}

// the mesh mode's composite of one pixel's tent sums: over the pixel's
// background m (four f16 [r, g, b, hit]) where the mesh pass hit, over
// the flat background elsewhere; alpha 1 where hit (the reference
// combine's has_mesh planes)
__device__ __forceinline__ float4 composite_mesh(float a0, float a1,
                                                 float a2, float a3, bool ok,
                                                 float bg, float qscale,
                                                 float qshift, uint2 m) {
  const bool hit =
      __half2float(__ushort_as_half((unsigned short)(m.y >> 16))) > 0.5f;
  const float m0 = __half2float(__ushort_as_half((unsigned short)m.x));
  const float m1 = __half2float(__ushort_as_half((unsigned short)(m.x >> 16)));
  const float m2 = __half2float(__ushort_as_half((unsigned short)m.y));
  const float b0 = hit ? m0 : bg, b1 = hit ? m1 : bg, b2 = hit ? m2 : bg;
  a0 = a0 * qscale + qshift;
  a1 = a1 * qscale + qshift;
  a2 = a2 * qscale + qshift;
  a3 = a3 * qscale + qshift;
  const float rem = 1.f - a3;
  return ok ? make_float4(a0 + b0 * rem, a1 + b1 * rem, a2 + b2 * rem,
                          hit ? 1.f : a3)
            : make_float4(b0, b1, b2, hit ? 1.f : 0.f);
}

// one pixel's composite: over its mesh background (MESH; the pixel's is
// mesh[i]) or the flat one
template <bool MESH>
__device__ __forceinline__ float4 composite_px(float a0, float a1, float a2,
                                               float a3, bool ok, float bg,
                                               float qscale, float qshift,
                                               const uint2* mesh, size_t i) {
  if constexpr (MESH)
    return composite_mesh(a0, a1, a2, a3, ok, bg, qscale, qshift,
                          __ldg(mesh + i));
  else
    return composite(a0, a1, a2, a3, ok, bg, qscale, qshift);
}

// byte k of a cell packed by rgba8 (the code + 128) back to its exact code
// as a float: the byte under the exponent of 2^23 (a byte permute, no
// integer conversion), less 2^23 + 128
template <int K>
__device__ __forceinline__ float unpack(uint32_t w) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + K)) -
         8388736.f;
}

// the production levels: BY x BX blocks, a WY x WX window, all constants
// (the loops unroll fully). Each thread keeps its block's pixel positions
// in registers from the corner pass and its window's packed codes in
// shared memory, cell-major ([cell][thread]: a warp's reads of any cells
// fall in distinct banks), so that each pixel reads only the 2 x 2 cells
// its tent weights reach. The cells it skips have weight 0, so the sums
// equal kernel C's over the whole window bit for bit.
// MESH: the mesh mode, ``mesh`` the (P, H, W) pixels' f16 backgrounds.
template <int BY, int BX, int WY, int WX, bool U8, bool MESH>
__device__ __forceinline__ void display_body(
    const float* __restrict__ inter, const float* __restrict__ prm,
    const int* __restrict__ sel, void* __restrict__ out, int P, int gi,
    int H, int W, float bg, float qscale, float qshift,
    const uint2* __restrict__ mesh) {
  static_assert(WY >= 2 && WX >= 2, "the 2 x 2 taps need a 2 x 2 window");
  __shared__ uint32_t cells[WY * WX][THREADS];
  const int Hh = H / BY, Wh = W / BX;
  const int blk = blockIdx.x * THREADS + threadIdx.x;
  const int p = sel[blockIdx.y];
  if (blk >= Hh * Wh || p < 0 || p >= P) return;
  const int hh = blk / Wh, wh = blk - hh * Wh;
  const Pose s = load_pose(prm + (size_t)p * NPRM);
  const float gmax = (float)(gi - 1);
  const float hi = (float)((double)(gi - 1) - 1e-6);  // the clamp's f32
  float xs[BX];
#pragma unroll
  for (int q = 0; q < BX; ++q) xs[q] = screen_x(wh * BX + q, W, s.fx);

  // the pixels' positions, and the window corner from the in-grid ones
  float gy[BY][BX], gx[BY][BX];
  float ymin = 1e9f, xmin = 1e9f;
  bool any = false;
#pragma unroll
  for (int r = 0; r < BY; ++r) {
    const float ys = screen_y(hh * BY + r, H, s.fy);
#pragma unroll
    for (int q = 0; q < BX; ++q) {
      position(s, xs[q], ys, gy[r][q], gx[r][q]);
      if (gy[r][q] >= 0.f && gy[r][q] <= gmax && gx[r][q] >= 0.f &&
          gx[r][q] <= gmax) {
        any = true;
        ymin = fminf(ymin, fminf(gy[r][q], hi));
        xmin = fminf(xmin, fminf(gx[r][q], hi));
      }
    }
  }
  const int Y0 = any ? min(max((int)floorf(ymin), 0), gi - WY) : 0;
  const int X0 = any ? min(max((int)floorf(xmin), 0), gi - WX) : 0;

  // the window's cells, quantized as kernel B quantizes them
  const size_t npx = (size_t)gi * gi;
  const float* src = inter + (size_t)p * 4 * npx + (size_t)Y0 * gi + X0;
#pragma unroll
  for (int cy = 0; cy < WY; ++cy)
#pragma unroll
    for (int cx = 0; cx < WX; ++cx) {
      const float* c = src + cy * gi + cx;
      // each byte code + 128: kernel B's rounding, as the RGBA8 emit's
      cells[cy * WX + cx][threadIdx.x] =
          rgba8(__ldg(c), __ldg(c + npx), __ldg(c + 2 * npx),
                __ldg(c + 3 * npx));
    }
  const uint32_t* mine = &cells[0][threadIdx.x];

  // each pixel: kernel C's tent-combine over its non-zero taps, dequant,
  // mask and composite
#pragma unroll
  for (int r = 0; r < BY; ++r) {
    uint32_t row8[BX];
    float4 row32[U8 ? 1 : BX];
#pragma unroll
    for (int q = 0; q < BX; ++q) {
      const float py = gy[r][q], px = gx[r][q];
      const bool ok = py >= 0.f && py <= gmax && px >= 0.f && px <= gmax;
      const float ry = __fsub_rn(fminf(fmaxf(py, 0.f), hi), (float)Y0);
      const float rx = __fsub_rn(fminf(fmaxf(px, 0.f), hi), (float)X0);
      const float ryv = fminf(fmaxf(ry, 0.f), (float)(WY - 1));
      const float rxv = fminf(fmaxf(rx, 0.f), (float)(WX - 1));
      // cells iy, iy + 1 (ix, ix + 1) hold every non-zero tent weight
      const int iy = min((int)ryv, WY - 2), ix = min((int)rxv, WX - 2);
      const float wy0 = fmaxf(0.f, 1.f - fabsf(ryv - (float)iy));
      const float wy1 = fmaxf(0.f, 1.f - fabsf(ryv - (float)(iy + 1)));
      const float wx0 = fmaxf(0.f, 1.f - fabsf(rxv - (float)ix));
      const float wx1 = fmaxf(0.f, 1.f - fabsf(rxv - (float)(ix + 1)));
      const uint32_t* c = mine + (iy * WX + ix) * THREADS;
      const uint32_t e00 = c[0], e01 = c[THREADS];
      const uint32_t e10 = c[WX * THREADS], e11 = c[(WX + 1) * THREADS];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#define VT_TAP(w, e)          \
  a0 += (w) * unpack<0>(e);   \
  a1 += (w) * unpack<1>(e);   \
  a2 += (w) * unpack<2>(e);   \
  a3 += (w) * unpack<3>(e);
      VT_TAP(wy0 * wx0, e00)
      VT_TAP(wy0 * wx1, e01)
      VT_TAP(wy1 * wx0, e10)
      VT_TAP(wy1 * wx1, e11)
#undef VT_TAP
      const float4 o = composite_px<MESH>(
          a0, a1, a2, a3, ok, bg, qscale, qshift, mesh,
          ((size_t)p * H + hh * BY + r) * W + (size_t)wh * BX + q);
      if constexpr (U8)
        row8[q] = rgba8(o.x, o.y, o.z, o.w);
      else
        row32[q] = o;
    }
    const size_t pix = ((size_t)p * H + hh * BY + r) * W + (size_t)wh * BX;
    if constexpr (U8) {
      uint32_t* dst = (uint32_t*)out + pix;
      if constexpr (BX == 4) {
        *(uint4*)dst = make_uint4(row8[0], row8[1], row8[2], row8[3]);
      } else if constexpr (BX == 2) {
        *(uint2*)dst = make_uint2(row8[0], row8[1]);
      } else {
#pragma unroll
        for (int q = 0; q < BX; ++q) dst[q] = row8[q];
      }
    } else {
      float4* dst = (float4*)out + pix;
#pragma unroll
      for (int q = 0; q < BX; ++q) dst[q] = row32[q];
    }
  }
}

template <int BY, int BX, int WY, int WX, bool U8>
__global__ void __launch_bounds__(THREADS)
    display_kernel(const float* __restrict__ inter,
                   const float* __restrict__ prm,
                   const int* __restrict__ sel, void* __restrict__ out,
                   int P, int gi, int H, int W, float bg, float qscale,
                   float qshift) {
  display_body<BY, BX, WY, WX, U8, false>(inter, prm, sel, out, P, gi, H, W,
                                          bg, qscale, qshift, nullptr);
}

template <int BY, int BX, int WY, int WX, bool U8>
__global__ void __launch_bounds__(THREADS)
    display_mesh(const float* __restrict__ inter,
                 const float* __restrict__ prm, const int* __restrict__ sel,
                 void* __restrict__ out, int P, int gi, int H, int W,
                 float bg, float qscale, float qshift,
                 const uint2* __restrict__ mesh) {
  display_body<BY, BX, WY, WX, U8, true>(inter, prm, sel, out, P, gi, H, W,
                                         bg, qscale, qshift, mesh);
}

// any other level: block sides at run time, windows up to 8 x 8. The
// loops stay rolled and nothing is held in arrays (no local memory): each
// pixel reads the (at most 2 x 2) window cells its tent weights reach
// straight from the planar image. The cells it skips have weight 0, so the
// sums equal kernel C's over the whole window bit for bit.
template <bool U8, bool MESH>
__device__ __forceinline__ void generic_body(
    const float* __restrict__ inter, const float* __restrict__ prm,
    const int* __restrict__ sel, void* __restrict__ out, int P, int gi,
    int H, int W, int by, int bx, int wy, int wx, float bg, float qscale,
    float qshift, const uint2* __restrict__ mesh) {
  const int Hh = H / by, Wh = W / bx;
  const int blk = blockIdx.x * THREADS + threadIdx.x;
  const int p = sel[blockIdx.y];
  if (blk >= Hh * Wh || p < 0 || p >= P) return;
  const int hh = blk / Wh, wh = blk - hh * Wh;
  const Pose s = load_pose(prm + (size_t)p * NPRM);
  const float gmax = (float)(gi - 1);
  const float hi = (float)((double)(gi - 1) - 1e-6);
  int Y0, X0;
  corner(s, hh, wh, by, bx, gi, H, W, wy, wx, Y0, X0);
  const size_t npx = (size_t)gi * gi;
  const float* src = inter + (size_t)p * 4 * npx + (size_t)Y0 * gi + X0;
  for (int r = 0; r < by; ++r) {
    const float ys = screen_y(hh * by + r, H, s.fy);
    const size_t row = ((size_t)p * H + hh * by + r) * W + (size_t)wh * bx;
    for (int q = 0; q < bx; ++q) {
      float gy, gx;
      position(s, screen_x(wh * bx + q, W, s.fx), ys, gy, gx);
      const bool ok = gy >= 0.f && gy <= gmax && gx >= 0.f && gx <= gmax;
      const float ry = __fsub_rn(fminf(fmaxf(gy, 0.f), hi), (float)Y0);
      const float rx = __fsub_rn(fminf(fmaxf(gx, 0.f), hi), (float)X0);
      const float ryv = fminf(fmaxf(ry, 0.f), (float)(wy - 1));
      const float rxv = fminf(fmaxf(rx, 0.f), (float)(wx - 1));
      // cells iy..iy+1 (ix..ix+1) hold every non-zero tent weight
      const int iy = (int)ryv, ix = (int)rxv;
      const int ey = min(iy + 1, wy - 1), ex = min(ix + 1, wx - 1);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int cy = iy; cy <= ey; ++cy) {
        const float wyv = fmaxf(0.f, 1.f - fabsf(ryv - (float)cy));
        for (int cx = ix; cx <= ex; ++cx) {
          const float wyx = wyv * fmaxf(0.f, 1.f - fabsf(rxv - (float)cx));
          const float* c = src + cy * gi + cx;
          a0 += wyx * code(__ldg(c));
          a1 += wyx * code(__ldg(c + npx));
          a2 += wyx * code(__ldg(c + 2 * npx));
          a3 += wyx * code(__ldg(c + 3 * npx));
        }
      }
      const float4 o = composite_px<MESH>(a0, a1, a2, a3, ok, bg, qscale,
                                          qshift, mesh, row + q);
      if constexpr (U8)
        ((uint32_t*)out)[row + q] = rgba8(o.x, o.y, o.z, o.w);
      else
        ((float4*)out)[row + q] = o;
    }
  }
}

template <bool U8>
__global__ void __launch_bounds__(THREADS)
    display_generic(const float* __restrict__ inter,
                    const float* __restrict__ prm,
                    const int* __restrict__ sel, void* __restrict__ out,
                    int P, int gi, int H, int W, int by, int bx, int wy,
                    int wx, float bg, float qscale, float qshift) {
  generic_body<U8, false>(inter, prm, sel, out, P, gi, H, W, by, bx, wy, wx,
                          bg, qscale, qshift, nullptr);
}

template <bool U8>
__global__ void __launch_bounds__(THREADS)
    generic_mesh(const float* __restrict__ inter,
                 const float* __restrict__ prm, const int* __restrict__ sel,
                 void* __restrict__ out, int P, int gi, int H, int W, int by,
                 int bx, int wy, int wx, float bg, float qscale,
                 float qshift, const uint2* __restrict__ mesh) {
  generic_body<U8, true>(inter, prm, sel, out, P, gi, H, W, by, bx, wy, wx,
                         bg, qscale, qshift, mesh);
}

// the cascade levels of one fit-mode launch
constexpr int MAXL = 4;
struct Levels {
  int by[MAXL], bx[MAXL], wy[MAXL], wx[MAXL];
};

// fit mode for levels that nest: one thread per LY x LX super block (the
// least common multiple of the levels' blocks, at most MAXS pixels) of
// every pose (grid y). Each pixel's position is computed once and kept in
// shared memory (the clamped in-grid position, NaN off the grid); each
// level then takes its blocks' extents from it. counts (L, P)
constexpr int MAXS = 16;

__global__ void __launch_bounds__(THREADS)
    fit_nested(const float* __restrict__ prm, int* __restrict__ counts,
               int P, int L, int gi, int H, int W, int LY, int LX,
               Levels lv) {
  __shared__ float2 pos[MAXS][THREADS];
  const int Hs = H / LY, Ws = W / LX;
  const int blk = blockIdx.x * THREADS + threadIdx.x;
  const int p = blockIdx.y;
  int n[MAXL] = {};
  if (blk < Hs * Ws) {
    const int hh = blk / Ws, wh = blk - hh * Ws;
    const Pose s = load_pose(prm + (size_t)p * NPRM);
    const float gmax = (float)(gi - 1);
    const float hi = (float)((double)(gi - 1) - 1e-6);
    for (int r = 0; r < LY; ++r) {
      const float ysr = screen_y(hh * LY + r, H, s.fy);
      for (int q = 0; q < LX; ++q) {
        float gy, gx;
        position(s, screen_x(wh * LX + q, W, s.fx), ysr, gy, gx);
        const bool ok = gy >= 0.f && gy <= gmax && gx >= 0.f && gx <= gmax;
        pos[r * LX + q][threadIdx.x] =
            ok ? make_float2(fminf(gy, hi), fminf(gx, hi))
               : make_float2(__int_as_float(0x7fc00000),
                             __int_as_float(0x7fc00000));
      }
    }
#pragma unroll
    for (int l = 0; l < MAXL; ++l) {
      if (l >= L) break;
      const int by = lv.by[l], bx = lv.bx[l], wy = lv.wy[l], wx = lv.wx[l];
      for (int y0 = 0; y0 < LY; y0 += by)
        for (int x0 = 0; x0 < LX; x0 += bx) {
          float ymin = 1e9f, ymax = -1e9f, xmin = 1e9f, xmax = -1e9f;
          bool any = false;
          for (int r = y0; r < y0 + by; ++r)
            for (int q = x0; q < x0 + bx; ++q) {
              const float2 c = pos[r * LX + q][threadIdx.x];
              if (c.x == c.x) {  // in the grid
                any = true;
                ymin = fminf(ymin, c.x);
                ymax = fmaxf(ymax, c.x);
                xmin = fminf(xmin, c.y);
                xmax = fmaxf(xmax, c.y);
              }
            }
          if (!any) ymin = ymax = xmin = xmax = 0.f;
          n[l] += ymax >= __fadd_rn(floorf(ymin), (float)(wy - 1)) ||
                  xmax >= __fadd_rn(floorf(xmin), (float)(wx - 1));
        }
    }
  }
#pragma unroll
  for (int l = 0; l < MAXL; ++l) {
    if (l >= L) break;
    const int c = __reduce_add_sync(0xffffffffu, n[l]);
    if ((threadIdx.x & 31) == 0 && c) atomicAdd(counts + (size_t)l * P + p, c);
  }
}

// fit mode for the production cascade, (4, 4) x (5, 5) over (2, 2) x
// (4, 4), its sizes constants: one thread per 4 x 4 super block of every
// pose (grid y). screen_x and each linear form's x product are taken
// once a column, screen_y and the y products once a row, and each pixel
// keeps _lin_forms's add and subtract in lin's order, so every position
// is bit-equal to position()'s. The positions never leave registers: each
// updates the extents of its (2, 2) block as it is computed, and the
// (4, 4) block's extents are the min and max of its four (2, 2) blocks'
// (a block with no in-grid subpixel adds nothing to them). counts rows lc
// (the (4, 4) level) and lf (the (2, 2) level) of (L, P).
__global__ void __launch_bounds__(THREADS)
    fit_cascade(const float* __restrict__ prm, int* __restrict__ counts,
                int P, int gi, int H, int W, int lc, int lf) {
  const int Hs = H / 4, Ws = W / 4;
  const int blk = blockIdx.x * THREADS + threadIdx.x;
  const int p = blockIdx.y;
  int nc = 0, nf = 0;
  if (blk < Hs * Ws) {
    const int hh = blk / Ws, wh = blk - hh * Ws;
    const Pose s = load_pose(prm + (size_t)p * NPRM);
    const float gmax = (float)(gi - 1);
    const float hi = (float)((double)(gi - 1) - 1e-6);
    float fx[3][4], fy[3][4];  // each form's x product a column, y a row
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float xs = screen_x(wh * 4 + q, W, s.fx);
      const float ys = screen_y(hh * 4 + q, H, s.fy);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        fx[i][q] = __fmul_rn(xs, s.a[3 * i]);
        fy[i][q] = __fmul_rn(ys, s.a[3 * i + 1]);
      }
    }
    // the (2, 2) blocks' extents over their in-grid subpixels
    float ymin[4], ymax[4], xmin[4], xmax[4];
    bool any[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      ymin[b] = xmin[b] = 1e9f;
      ymax[b] = xmax[b] = -1e9f;
      any[b] = false;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float den = __fsub_rn(__fadd_rn(fx[0][q], fy[0][r]), s.a[2]);
        const float nu = __fsub_rn(__fadd_rn(fx[1][q], fy[1][r]), s.a[5]);
        const float nv = __fsub_rn(__fadd_rn(fx[2][q], fy[2][r]), s.a[8]);
        const float inv = __frcp_rn(fabsf(den) < 1e-12f ? 1e-12f : den);
        const float gy = __fdiv_rn(__fsub_rn(__fmul_rn(nu, inv), s.u0), s.du);
        const float gx = __fdiv_rn(__fsub_rn(__fmul_rn(nv, inv), s.v0), s.dv);
        if (gy >= 0.f && gy <= gmax && gx >= 0.f && gx <= gmax) {
          const int b = (r >> 1) * 2 + (q >> 1);
          const float cy = fminf(gy, hi), cx = fminf(gx, hi);
          any[b] = true;
          ymin[b] = fminf(ymin[b], cy);
          ymax[b] = fmaxf(ymax[b], cy);
          xmin[b] = fminf(xmin[b], cx);
          xmax[b] = fmaxf(xmax[b], cx);
        }
      }
    float cymin = 1e9f, cymax = -1e9f, cxmin = 1e9f, cxmax = -1e9f;
    bool cany = false;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      cany |= any[b];
      cymin = fminf(cymin, ymin[b]);
      cymax = fmaxf(cymax, ymax[b]);
      cxmin = fminf(cxmin, xmin[b]);
      cxmax = fmaxf(cxmax, xmax[b]);
      const float y0 = any[b] ? ymin[b] : 0.f, y1 = any[b] ? ymax[b] : 0.f;
      const float x0 = any[b] ? xmin[b] : 0.f, x1 = any[b] ? xmax[b] : 0.f;
      nf += y1 >= __fadd_rn(floorf(y0), 3.f) ||
            x1 >= __fadd_rn(floorf(x0), 3.f);
    }
    if (!cany) cymin = cymax = cxmin = cxmax = 0.f;
    nc = cymax >= __fadd_rn(floorf(cymin), 4.f) ||
         cxmax >= __fadd_rn(floorf(cxmin), 4.f);
  }
  const int c = __reduce_add_sync(0xffffffffu, nc);
  const int f = __reduce_add_sync(0xffffffffu, nf);
  if ((threadIdx.x & 31) == 0) {
    if (c) atomicAdd(counts + (size_t)lc * P + p, c);
    if (f) atomicAdd(counts + (size_t)lf * P + p, f);
  }
}

// fit mode for levels that do not nest in MAXS pixels: one thread per
// screen block of every pose (grid y) and level (grid z); counts (L, P)
__global__ void __launch_bounds__(THREADS)
    fit_kernel(const float* __restrict__ prm, int* __restrict__ counts,
               int P, int gi, int H, int W, Levels lv) {
  const int l = blockIdx.z;
  const int by = lv.by[l], bx = lv.bx[l], wy = lv.wy[l], wx = lv.wx[l];
  const int Hh = H / by, Wh = W / bx;
  const int blk = blockIdx.x * THREADS + threadIdx.x;
  const int p = blockIdx.y;
  bool mis = false;
  if (blk < Hh * Wh) {
    const int hh = blk / Wh, wh = blk - hh * Wh;
    const Pose s = load_pose(prm + (size_t)p * NPRM);
    const float gmax = (float)(gi - 1);
    const float hi = (float)((double)(gi - 1) - 1e-6);
    float ymin = 1e9f, ymax = -1e9f, xmin = 1e9f, xmax = -1e9f;
    bool any = false;
    for (int r = 0; r < by; ++r) {
      const float ysr = screen_y(hh * by + r, H, s.fy);
      for (int q = 0; q < bx; ++q) {
        float gy, gx;
        position(s, screen_x(wh * bx + q, W, s.fx), ysr, gy, gx);
        if (gy >= 0.f && gy <= gmax && gx >= 0.f && gx <= gmax) {
          any = true;
          const float cy = fminf(gy, hi), cx = fminf(gx, hi);
          ymin = fminf(ymin, cy);
          ymax = fmaxf(ymax, cy);
          xmin = fminf(xmin, cx);
          xmax = fmaxf(xmax, cx);
        }
      }
    }
    if (!any) ymin = ymax = xmin = xmax = 0.f;
    mis = ymax >= __fadd_rn(floorf(ymin), (float)(wy - 1)) ||
          xmax >= __fadd_rn(floorf(xmin), (float)(wx - 1));
  }
  const unsigned m = __ballot_sync(0xffffffffu, mis);
  if ((threadIdx.x & 31) == 0 && m)
    atomicAdd(counts + (size_t)l * P + p, __popc(m));
}

template <bool U8>
void dispatch(dim3 grid, cudaStream_t st, const float* inter,
              const float* prm, const int* sel, void* out, int P, int gi,
              int H, int W, int By, int Bx, int Wy, int Wx, float bg,
              float qscale, float qshift) {
  if (By == 4 && Bx == 4 && Wy == 5 && Wx == 5)
    display_kernel<4, 4, 5, 5, U8><<<grid, THREADS, 0, st>>>(
        inter, prm, sel, out, P, gi, H, W, bg, qscale, qshift);
  else if (By == 2 && Bx == 2 && Wy == 4 && Wx == 4)
    display_kernel<2, 2, 4, 4, U8><<<grid, THREADS, 0, st>>>(
        inter, prm, sel, out, P, gi, H, W, bg, qscale, qshift);
  else
    display_generic<U8><<<grid, THREADS, 0, st>>>(
        inter, prm, sel, out, P, gi, H, W, By, Bx, Wy, Wx, bg, qscale,
        qshift);
}

template <bool U8>
void dispatch_mesh(dim3 grid, cudaStream_t st, const float* inter,
                   const float* prm, const int* sel, void* out, int P,
                   int gi, int H, int W, int By, int Bx, int Wy, int Wx,
                   float bg, float qscale, float qshift, const uint2* mesh) {
  if (By == 4 && Bx == 4 && Wy == 5 && Wx == 5)
    display_mesh<4, 4, 5, 5, U8><<<grid, THREADS, 0, st>>>(
        inter, prm, sel, out, P, gi, H, W, bg, qscale, qshift, mesh);
  else if (By == 2 && Bx == 2 && Wy == 4 && Wx == 4)
    display_mesh<2, 2, 4, 4, U8><<<grid, THREADS, 0, st>>>(
        inter, prm, sel, out, P, gi, H, W, bg, qscale, qshift, mesh);
  else
    generic_mesh<U8><<<grid, THREADS, 0, st>>>(inter, prm, sel, out, P, gi,
                                               H, W, By, Bx, Wy, Wx, bg,
                                               qscale, qshift, mesh);
}

int lcm(int a, int b) {
  int x = a, y = b;
  while (y) {
    const int t = x % y;
    x = y;
    y = t;
  }
  return (int)std::min<long long>((long long)a / x * b, 1 << 20);
}

// a level the kernels take: blocks that tile the screen (any side, as
// kernel C), windows up to 8 x 8 inside the grid
bool bad_level(int gi, int H, int W, int By, int Bx, int Wy, int Wx) {
  return By < 1 || Bx < 1 || H % By || W % Bx || Wy < 1 || Wx < 1 ||
         Wy > MAXW || Wx > MAXW || gi < Wy || gi < Wx;
}

}  // namespace

// inter: (P, 4, gi, gi) f32; prm: (P, 16) f32; sel: (n_sel) int32 pose
// indices; out: (P, H, W, 4) uint8 (out_u8) or f32, 16-byte aligned,
// written at the listed poses only. Returns cudaGetLastError() after the
// launch.
extern "C" int vt_warp_display(const void* inter, const void* prm,
                               const void* sel, void* out, int n_sel,
                               int out_u8, int P, int gi, int H, int W,
                               int By, int Bx, int Wy, int Wx, float bg,
                               float qscale, float qshift, void* stream) {
  if (n_sel < 1 || n_sel > 65535 || P < 1 ||
      bad_level(gi, H, W, By, Bx, Wy, Wx))
    return (int)cudaErrorInvalidValue;
  const int nblk = (H / By) * (W / Bx);
  const dim3 grid((nblk + THREADS - 1) / THREADS, n_sel);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_u8)
    dispatch<true>(grid, st, (const float*)inter, (const float*)prm,
                   (const int*)sel, out, P, gi, H, W, By, Bx, Wy, Wx, bg,
                   qscale, qshift);
  else
    dispatch<false>(grid, st, (const float*)inter, (const float*)prm,
                    (const int*)sel, out, P, gi, H, W, By, Bx, Wy, Wx, bg,
                    qscale, qshift);
  return (int)cudaGetLastError();
}

// vt_warp_display's mesh mode: mesh is the (P, H, W, 4) f16 background
// [r, g, b, hit], 8-byte aligned, read at the listed poses' pixels.
extern "C" int vt_warp_display_mesh(const void* inter, const void* prm,
                                    const void* sel, void* out, int n_sel,
                                    int out_u8, int P, int gi, int H, int W,
                                    int By, int Bx, int Wy, int Wx, float bg,
                                    float qscale, float qshift,
                                    const void* mesh, void* stream) {
  if (n_sel < 1 || n_sel > 65535 || P < 1 || !mesh ||
      (uintptr_t)mesh % 8 || bad_level(gi, H, W, By, Bx, Wy, Wx))
    return (int)cudaErrorInvalidValue;
  const int nblk = (H / By) * (W / Bx);
  const dim3 grid((nblk + THREADS - 1) / THREADS, n_sel);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_u8)
    dispatch_mesh<true>(grid, st, (const float*)inter, (const float*)prm,
                        (const int*)sel, out, P, gi, H, W, By, Bx, Wy, Wx,
                        bg, qscale, qshift, (const uint2*)mesh);
  else
    dispatch_mesh<false>(grid, st, (const float*)inter, (const float*)prm,
                         (const int*)sel, out, P, gi, H, W, By, Bx, Wy, Wx,
                         bg, qscale, qshift, (const uint2*)mesh);
  return (int)cudaGetLastError();
}

// prm: (P, 16) f32; counts: (L, P) int32, zeroed by the caller, each
// (level, pose) count of blocks that misfit the level added to it; dims:
// host int[4 * L], each level's By, Bx, Wy, Wx. One launch for all levels.
// Returns cudaGetLastError() after the launch.
extern "C" int vt_warp_fit(const void* prm, void* counts, int P, int L,
                           const void* dims, int gi, int H, int W,
                           void* stream) {
  if (P < 1 || P > 65535 || L < 1 || L > MAXL)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  int nblk = 0, LY = 1, LX = 1;  // LY x LX: the levels' common super block
  for (int l = 0; l < L; ++l) {
    const int* d = (const int*)dims + 4 * l;
    if (bad_level(gi, H, W, d[0], d[1], d[2], d[3]))
      return (int)cudaErrorInvalidValue;
    lv.by[l] = d[0];
    lv.bx[l] = d[1];
    lv.wy[l] = d[2];
    lv.wx[l] = d[3];
    nblk = max(nblk, (H / d[0]) * (W / d[1]));
    LY = lcm(LY, d[0]);
    LX = lcm(LX, d[1]);
  }
  cudaStream_t st = (cudaStream_t)stream;
  // the production cascade: its own kernel, the sizes constants
  const auto is = [&](int l, int by, int wy) {
    return lv.by[l] == by && lv.bx[l] == by && lv.wy[l] == wy &&
           lv.wx[l] == wy;
  };
  if (L == 2 &&
      ((is(0, 4, 5) && is(1, 2, 4)) || (is(0, 2, 4) && is(1, 4, 5)))) {
    const int lc = is(0, 4, 5) ? 0 : 1;
    const int nsup = (H / 4) * (W / 4);
    fit_cascade<<<dim3((nsup + THREADS - 1) / THREADS, P), THREADS, 0, st>>>(
        (const float*)prm, (int*)counts, P, gi, H, W, lc, 1 - lc);
  } else if ((long long)LY * LX <= MAXS) {
    // LY and LX divide H and W, as every level's block does
    const int nsup = (H / LY) * (W / LX);
    fit_nested<<<dim3((nsup + THREADS - 1) / THREADS, P), THREADS, 0, st>>>(
        (const float*)prm, (int*)counts, P, L, gi, H, W, LY, LX, lv);
  } else {
    fit_kernel<<<dim3((nblk + THREADS - 1) / THREADS, P, L), THREADS, 0,
                 st>>>((const float*)prm, (int*)counts, P, gi, H, W, lv);
  }
  return (int)cudaGetLastError();
}

// What the card makes of kernel W's instantiation for a level (By, Bx,
// Wy, Wx; the generic kernel for any level but the two production ones),
// RGBA8 or f32 frames (out_u8), with or without the mesh mode: out[0]
// resident blocks per SM, out[1] registers a thread, out[2] local (spill)
// bytes a thread, out[3] static shared bytes.
extern "C" int vt_warp_display_info(int By, int Bx, int Wy, int Wx,
                                    int out_u8, int mesh, int* out) {
  const bool p4 = By == 4 && Bx == 4 && Wy == 5 && Wx == 5;
  const bool p2 = By == 2 && Bx == 2 && Wy == 4 && Wx == 4;
  const void* fn;
  if (mesh)
    fn = out_u8 ? (p4   ? (const void*)display_mesh<4, 4, 5, 5, true>
                   : p2 ? (const void*)display_mesh<2, 2, 4, 4, true>
                        : (const void*)generic_mesh<true>)
                : (p4   ? (const void*)display_mesh<4, 4, 5, 5, false>
                   : p2 ? (const void*)display_mesh<2, 2, 4, 4, false>
                        : (const void*)generic_mesh<false>);
  else
    fn = out_u8 ? (p4   ? (const void*)display_kernel<4, 4, 5, 5, true>
                   : p2 ? (const void*)display_kernel<2, 2, 4, 4, true>
                        : (const void*)display_generic<true>)
                : (p4   ? (const void*)display_kernel<4, 4, 5, 5, false>
                   : p2 ? (const void*)display_kernel<2, 2, 4, 4, false>
                        : (const void*)display_generic<false>);
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, THREADS, 0);
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
