// Kernel M: the fused shear-warp slab march, for Hopper (sm_90a).
//
// Replaces volrend_tpu/ops/pallas_slab.py:_make_kernel, the Pallas TPU
// kernel behind pallas_slab.march_slabs (its plain PyTorch twin is
// volrend_torch/ops/slab_march.py:march_slabs_ref).
//
// What it computes, per pose and intermediate pixel (j, k) of the (gi, gi)
// slope grid, for each occupied slab in march order: dequantize the int8
// payload (colour codes x qscale, sigma = (hi*128 + lo) x qscale), mask
// sigma by the threshold, shade srgb = sigma * sigmoid(sum_k code * basis_k
// * qs_k) with the view direction taken once per K-slab window at the
// window centre, warp [sigma, sigma*r, sigma*g, sigma*b] onto the pixel
// with the separable box-integration two-tap weights, then composite
// tau = sigma_w * dt_pix * frac_z front to back with the stop-threshold
// freeze. Output acc (P, 4, gi, gi) = [r, g, b, T].
//
// What bounds it on the H100: for one pose, the payload read. A dense pose
// streams the whole (G, Dp, G, G) int8 payload once (256^3 x 50 B =
// 0.84 GB, about 0.25 ms at 3.35 TB/s); shading is ~170 fp32 operations
// per voxel (~2.9 GFLOP, about 0.04 ms at 67 TFLOP/s). The display path
// launches a whole (perm, flip) pose group at once, and shading is per
// pose, so for a group of ~50 poses the operations bound the function
// (~3 ms), while this kernel re-reads the payload for every pose (~13 ms of
// traffic for 51 poses). Either way it is the reverse of the TPU, where
// the march was bound by vector compute.
//
// Design:
// - One block per 16x16 tile of intermediate pixels and per pose
//   (blockIdx.z), so one launch covers a whole (perm, flip) pose group.
//   Each thread owns one pixel and keeps r, g, b, T, its z interval and its
//   slab thickness in registers across the whole march; the TPU's
//   sequential grid over windows becomes a loop inside the block.
// - Per slab, the tile's cell footprint comes from the affine slope map
//   (linear in the pixel index, so its extremes are at the tile corners).
//   The block loads the footprint's planes with reads coalesced along x
//   and shades each footprint voxel ONCE into shared memory as
//   [sigma, sigma*r, sigma*g, sigma*b]; voxels under the sigma threshold
//   skip the colour planes entirely (their contribution is exactly zero).
//   A footprint larger than the shared buffer (steep slopes up to
//   MAX_SLAB_SLOPE, gi != G) is processed in pieces: the warp is linear,
//   so the pieces' partial sums simply add.
// - Each pixel then sums its own separable overlap weights (the same
//   formula as pallas_slab._overlap_mats, in f32) over the few cells its
//   span covers: direct indexed reads instead of the one-hot MXU matmul.
// - A block leaves its loop when no pixel of the tile can still
//   accumulate, and skips a window no pixel can see (__syncthreads_or):
//   the per-tile form of the reference's _window_live gate, exact because
//   a skipped slab would have composited with zero weight.
// - Poses share nothing: each pose's blocks load and shade their own
//   footprints (the shading direction is per pose). Making a group's poses
//   share the payload read is the next step for a pose group.

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

template <int BD>
__global__ void __launch_bounds__(NTHREADS)
march_kernel(const int8_t* __restrict__ payload,
             const float* __restrict__ params,
             const float* __restrict__ qscale,
             const float* __restrict__ zb,
             const int* __restrict__ wins, const int* __restrict__ masks,
             int n_win, float* __restrict__ acc, int G, int gi, int Dp,
             int Gy, int Gx, int y0, int x0, int K, int flip) {
  constexpr int D = 3 * BD + 1;  // colour planes + sigma; Dp = D + 1
  __shared__ float s_chan[4][FMAX][FMAX + 1];
  __shared__ float s_prm[NP];
  __shared__ float s_qs[D + 1];

  const int p = blockIdx.z;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  const int j0 = blockIdx.y * TILE, k0 = blockIdx.x * TILE;
  const int j = j0 + threadIdx.y, k = k0 + threadIdx.x;
  const bool inpix = (j < gi) && (k < gi);

  if (tid < NP) s_prm[tid] = params[(size_t)p * NP + tid];
  for (int i = tid; i < D + 1; i += NTHREADS) s_qs[i] = qscale[i];
  __syncthreads();

  const float Gf = (float)G;
  const float cz = s_prm[0], cy = s_prm[1], cx = s_prm[2];
  const float u0 = s_prm[3], du = s_prm[4], v0 = s_prm[5], dv = s_prm[6];
  const float sigma_thresh = s_prm[14], stop_thresh = s_prm[15];
  const float zbase = s_prm[30];
  const float cyG = cy * Gf, cxG = cx * Gf;
  const float hG = 0.5f / Gf;

  const size_t npx = (size_t)gi * gi;
  const size_t pix = (size_t)j * gi + k;
  float zlo = 1.f, zhi = 0.f, dtp = 0.f;  // an empty interval off-grid
  if (inpix) {
    const float* zbp = zb + (size_t)p * 4 * npx + pix;
    zlo = zbp[0];
    zhi = zbp[npx];
    dtp = zbp[2 * npx];
  }
  float r = 0.f, g = 0.f, b = 0.f, T = 1.f;

  // ray slopes x G: this pixel's, and the tile's first/last row and column
  const int jl = min(j0 + TILE, gi) - 1, kl = min(k0 + TILE, gi) - 1;
  const float ujG = (u0 + du * (float)j) * Gf;
  const float vkG = (v0 + dv * (float)k) * Gf;
  const float ujGa = (u0 + du * (float)j0) * Gf;
  const float ujGb = (u0 + du * (float)jl) * Gf;
  const float vkGa = (v0 + dv * (float)k0) * Gf;
  const float vkGb = (v0 + dv * (float)kl) * Gf;

  const size_t plane = (size_t)Gy * Gx;
  const int yend = y0 + Gy - 1, xend = x0 + Gx - 1;  // crop, global cells

  for (int wi = 0; wi < n_win; ++wi) {
    const int w = wins[wi], m = masks[wi];
    const float zw0 = (float)(w * K) / Gf + zbase;
    const float zw1 = ((float)(w * K) + (float)K) / Gf + zbase;
    // windows arrive in march order: once the march is past a pixel's z
    // interval (or the pixel saturated) no later slab can touch it
    const bool passed = flip ? (zw1 < zlo) : (zw0 > zhi);
    const bool alive = inpix && (T >= stop_thresh) && (zlo <= zhi) && !passed;
    if (!__syncthreads_or(alive)) break;
    const bool live = alive && (zlo <= zw1) && (zhi >= zw0);
    if (!__syncthreads_or(live)) continue;

    // shading view directions: once per window, at the window centre
    const float sc = ((float)(w * K) + 0.5f * (float)K) / Gf + zbase - cz;
    const float ssign = (sc > 0.f) ? 1.f : ((sc < 0.f) ? -1.f : 0.f);

    for (int t = 0; t < K; ++t) {
      const int dzi = flip ? (K - 1 - t) : t;
      if (!((m >> dzi) & 1)) continue;
      const int sid = w * K + dzi;
      const float z = ((float)sid + 0.5f) / Gf + zbase;
      const float s0 = z - hG - cz;
      const float s1 = z + hG - cz;

      // tile footprint in global cells (+-1 cell of rounding margin),
      // clipped to the payload's crop
      const float ya0 = cyG + s0 * ujGa, ya1 = cyG + s1 * ujGa;
      const float yb0 = cyG + s0 * ujGb, yb1 = cyG + s1 * ujGb;
      const float xa0 = cxG + s0 * vkGa, xa1 = cxG + s1 * vkGa;
      const float xb0 = cxG + s0 * vkGb, xb1 = cxG + s1 * vkGb;
      const int fy_lo = max(cell_floor(fminf(fminf(ya0, ya1),
                                             fminf(yb0, yb1)), 0, G - 1) - 1,
                            y0);
      const int fy_hi = min(cell_floor(fmaxf(fmaxf(ya0, ya1),
                                             fmaxf(yb0, yb1)), 0, G - 1) + 1,
                            yend);
      const int fx_lo = max(cell_floor(fminf(fminf(xa0, xa1),
                                             fminf(xb0, xb1)), 0, G - 1) - 1,
                            x0);
      const int fx_hi = min(cell_floor(fmaxf(fmaxf(xa0, xa1),
                                             fmaxf(xb0, xb1)), 0, G - 1) + 1,
                            xend);

      // this pixel's spans along rows (p) and columns (q)
      const float p0 = cyG + s0 * ujG, p1 = cyG + s1 * ujG;
      const float pmin = fminf(p0, p1), pmax = fmaxf(p0, p1);
      const float inv_r = 1.f / fmaxf(pmax - pmin, 1e-9f);
      const float q0 = cxG + s0 * vkG, q1 = cxG + s1 * vkG;
      const float qmin = fminf(q0, q1), qmax = fmaxf(q0, q1);
      const float inv_c = 1.f / fmaxf(qmax - qmin, 1e-9f);
      const int ry_lo = max(cell_floor(pmin, 0, G - 1), fy_lo);
      const int ry_hi = min(cell_floor(pmax, 0, G - 1), fy_hi);
      const int rx_lo = max(cell_floor(qmin, 0, G - 1), fx_lo);
      const int rx_hi = min(cell_floor(qmax, 0, G - 1), fx_hi);

      float sw = 0.f, rw = 0.f, gw = 0.f, bw = 0.f;
      const int8_t* slab = payload + (size_t)sid * Dp * plane;
      for (int py0 = fy_lo; py0 <= fy_hi; py0 += FMAX) {
        const int FY = min(FMAX, fy_hi - py0 + 1);
        for (int px0 = fx_lo; px0 <= fx_hi; px0 += FMAX) {
          const int FX = min(FMAX, fx_hi - px0 + 1);
          __syncthreads();  // the previous piece has been consumed
          for (int i = tid; i < FY * FX; i += NTHREADS) {
            const int ly = i / FX, lx = i - ly * FX;
            const int gy = py0 + ly, gx = px0 + lx;
            const int8_t* src = slab + (size_t)(gy - y0) * Gx + (gx - x0);
            const float sig =
                ((float)src[(size_t)(D - 1) * plane] * 128.f +
                 (float)src[(size_t)D * plane]) * s_qs[D - 1];
            float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
            if (sig > sigma_thresh) {
              const float ycm = ((float)gy + 0.5f) * (1.f / Gf) - cy;
              const float xcm = ((float)gx + 0.5f) * (1.f / Gf) - cx;
              const float dw0 = (s_prm[21] * ycm + s_prm[22] * xcm)
                                + s_prm[20] * sc;
              const float dw1 = (s_prm[24] * ycm + s_prm[25] * xcm)
                                + s_prm[23] * sc;
              const float dw2 = (s_prm[27] * ycm + s_prm[28] * xcm)
                                + s_prm[26] * sc;
              const float rn =
                  rsqrtf(dw0 * dw0 + dw1 * dw1 + dw2 * dw2) * ssign;
              float bk[BD];
              sh_basis<BD>(dw0 * rn, dw1 * rn, dw2 * rn, bk);
              float raw0 = 0.f, raw1 = 0.f, raw2 = 0.f;
#pragma unroll
              for (int kk = 0; kk < BD; ++kk) {
                const float bq = bk[kk] * s_qs[kk];
                raw0 += (float)src[(size_t)kk * plane] * bq;
                raw1 += (float)src[(size_t)(BD + kk) * plane] * bq;
                raw2 += (float)src[(size_t)(2 * BD + kk) * plane] * bq;
              }
              o0 = sig;
              o1 = sig * sigmoid(raw0);
              o2 = sig * sigmoid(raw1);
              o3 = sig * sigmoid(raw2);
            }
            s_chan[0][ly][lx] = o0;
            s_chan[1][ly][lx] = o1;
            s_chan[2][ly][lx] = o2;
            s_chan[3][ly][lx] = o3;
          }
          __syncthreads();
          if (inpix) {
            const int ya = max(ry_lo, py0), yb = min(ry_hi, py0 + FY - 1);
            const int xa = max(rx_lo, px0), xb = min(rx_hi, px0 + FX - 1);
            for (int cyy = ya; cyy <= yb; ++cyy) {
              const float wr = overlap(cyy, G, pmin, pmax, inv_r);
              const int ly = cyy - py0;
              for (int cxx = xa; cxx <= xb; ++cxx) {
                const float wgt = wr * overlap(cxx, G, qmin, qmax, inv_c);
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

      if (inpix) {
        // boundary slabs contribute by their overlap with [zlo, zhi]
        const float frac = fminf(fmaxf(
            (fminf(z + hG, zhi) - fmaxf(z - hG, zlo)) * Gf, 0.f), 1.f);
        const float tau = sw * dtp * frac;
        const float att = expf(-tau);
        const float sig_inv = 1.f / fmaxf(sw, 1e-12f);
        if (T >= stop_thresh && tau > 0.f) {
          const float wn = (T * (1.f - att)) * sig_inv;
          r += wn * rw;
          g += wn * gw;
          b += wn * bw;
          T = T * att;
        }
      }
    }
  }

  if (inpix) {
    float* out = acc + (size_t)p * 4 * npx + pix;
    out[0] = r;
    out[npx] = g;
    out[2 * npx] = b;
    out[3 * npx] = T;
  }
}

template <int BD>
cudaError_t launch(const void* payload, const void* params,
                   const void* qscale, const void* zb, const int* wins,
                   const int* masks, int n_win, void* acc, int P, int G,
                   int gi, int Dp, int Gy, int Gx, int y0, int x0, int K,
                   int flip, cudaStream_t stream) {
  const dim3 block(TILE, TILE);
  const dim3 grid((gi + TILE - 1) / TILE, (gi + TILE - 1) / TILE, P);
  march_kernel<BD><<<grid, block, 0, stream>>>(
      (const int8_t*)payload, (const float*)params, (const float*)qscale,
      (const float*)zb, wins, masks, n_win, (float*)acc, G, gi, Dp, Gy, Gx,
      y0, x0, K, flip);
  return cudaGetLastError();
}

}  // namespace

// wins_masks: (2, n_win) int32 on the device — window ids then occupancy
// bit masks, in march order. Returns cudaGetLastError() after the launch.
extern "C" int vt_march_slabs(const void* payload, const void* params,
                              const void* qscale, const void* zb,
                              const void* wins_masks, int n_win, void* acc,
                              int P, int G, int gi, int Dp, int Gy, int Gx,
                              int y0, int x0, int bd, int K, int flip,
                              void* stream) {
  if (Dp != 3 * bd + 2 || P < 1 || P > 65535 || gi < 1 || K < 1 ||
      n_win < 1)
    return (int)cudaErrorInvalidValue;
  const int* wins = (const int*)wins_masks;
  const int* masks = wins + n_win;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bd) {
    case 1:
      return (int)launch<1>(payload, params, qscale, zb, wins, masks, n_win,
                            acc, P, G, gi, Dp, Gy, Gx, y0, x0, K, flip, s);
    case 4:
      return (int)launch<4>(payload, params, qscale, zb, wins, masks, n_win,
                            acc, P, G, gi, Dp, Gy, Gx, y0, x0, K, flip, s);
    case 9:
      return (int)launch<9>(payload, params, qscale, zb, wins, masks, n_win,
                            acc, P, G, gi, Dp, Gy, Gx, y0, x0, K, flip, s);
    case 16:
      return (int)launch<16>(payload, params, qscale, zb, wins, masks, n_win,
                             acc, P, G, gi, Dp, Gy, Gx, y0, x0, K, flip, s);
    case 25:
      return (int)launch<25>(payload, params, qscale, zb, wins, masks, n_win,
                             acc, P, G, gi, Dp, Gy, Gx, y0, x0, K, flip, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
