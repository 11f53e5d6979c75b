// Kernel M, training mode: the fused shear-warp slab march over the bf16
// training payload, for Hopper (sm_90a).
//
// Replaces volrend_tpu/ops/pallas_slab.py:_make_kernel in its training
// option set (bf16 payload, Dp = D, sigma in plane D-1, dir_win=False), the
// Pallas TPU kernel behind pallas_slab.march_slabs; its plain PyTorch twin
// is volrend_torch/ops/slab_march.py:march_slabs_ref. The display mode
// (int8 payload, window directions) is slab_march_display.cu.
//
// What it computes, per pose and intermediate pixel (j, k) of the (gi, gi)
// slope grid, for each slab in march order: mask sigma by the threshold,
// shade srgb = sigma * sigmoid(sum_k value * basis_k) with the view
// direction per slab (the backward kernel, slab_march_bwd.cu, recomputes
// this forward per slab and the two must match), warp [sigma, sigma*r,
// sigma*g, sigma*b] onto the pixel with the separable box-integration
// two-tap weights, then composite tau = sigma_w * dt_pix * frac_z front to
// back with the stop-threshold freeze. Output acc (P, 4, gi, gi) = [r, g,
// b, T].
//
// What bounds it on the H100: for one pose, the payload read: the bf16 SH9
// payload is 256^3 x 56 B = 0.94 GB (about 0.28 ms at 3.35 TB/s), shading
// ~110 fp32 operations a voxel (~1.8 GFLOP, 0.03 ms at 67 TFLOP/s). The
// march of the training bench's data needs less (its bound counts the
// slabs the rays meet and the voxels above the threshold).
//
// Design:
// - One block per 16x16 tile of intermediate pixels and per pose
//   (blockIdx.z). Each thread owns one pixel and keeps r, g, b, T, its z
//   interval and its slab thickness in registers across the whole march;
//   the TPU's sequential grid over windows becomes a loop inside the block.
// - Per slab, the tile's cell footprint comes from the affine slope map
//   (linear in the pixel index, so its extremes are at the tile corners).
//   shade_and_sum (slab_common.cuh, shared with the backward's recompute)
//   loads the footprint's planes with reads coalesced along x and shades
//   each footprint voxel ONCE into shared memory as [sigma, sigma*r,
//   sigma*g, sigma*b] (voxels under the sigma threshold skip the colour
//   planes), in FMAX x FMAX pieces; each pixel then sums its own separable
//   overlap weights over the few cells its span covers.
// - A block leaves its loop when no pixel of the tile can still
//   accumulate, and skips a window no pixel can see (__syncthreads_or):
//   the per-tile form of the reference's _window_live gate, exact because
//   a skipped slab would have composited with zero weight.

#include "slab_common.cuh"

namespace {

template <int BD>
__global__ void __launch_bounds__(NTHREADS)
march_kernel(const __nv_bfloat16* __restrict__ payload,
             const float* __restrict__ params,
             const float* __restrict__ qscale,
             const float* __restrict__ zb,
             const int* __restrict__ wins, const int* __restrict__ masks,
             int n_win, float* __restrict__ acc, int G, int gi, int Dp,
             int Gy, int Gx, int y0, int x0, int K, int flip) {
  constexpr int D = 3 * BD + 1;  // colour planes + sigma
  __shared__ float s_chan[4][FMAX][FMAX + 1];
  __shared__ float s_prm[NP];
  __shared__ float s_qs[D];

  const int p = blockIdx.z;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  const int j0 = blockIdx.y * TILE, k0 = blockIdx.x * TILE;
  const int j = j0 + threadIdx.y, k = k0 + threadIdx.x;
  const bool inpix = (j < gi) && (k < gi);

  if (tid < NP) s_prm[tid] = params[(size_t)p * NP + tid];
  for (int i = tid; i < D; i += NTHREADS) s_qs[i] = qscale[i];
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

    for (int t = 0; t < K; ++t) {
      const int dzi = flip ? (K - 1 - t) : t;
      if (!((m >> dzi) & 1)) continue;
      const int sid = w * K + dzi;
      const float z = ((float)sid + 0.5f) / Gf + zbase;
      const float s0 = z - hG - cz;
      const float s1 = z + hG - cz;
      // view directions per slab, at the slab's distance
      const float sd = z - cz;
      const float sdsign = sign_of(sd);

      const Footprint f = tile_footprint(cyG, cxG, s0, s1, ujGa, ujGb, vkGa,
                                         vkGb, G, y0, yend, x0, xend);
      const PixelSpan sp = pixel_span(cyG, cxG, s0, s1, ujG, vkG, G, f);
      const float4 w4 = shade_and_sum<BD>(
          payload + (size_t)sid * Dp * plane, plane, Gx, y0, x0, f, sp,
          inpix, tid, G, cy, cx, sigma_thresh, sd, sdsign, s_qs, s_prm,
          s_chan);

      if (inpix) {
        // boundary slabs contribute by their overlap with [zlo, zhi]
        const float frac = fminf(fmaxf(
            (fminf(z + hG, zhi) - fmaxf(z - hG, zlo)) * Gf, 0.f), 1.f);
        const float tau = w4.x * dtp * frac;
        const float att = expf(-tau);
        const float sig_inv = 1.f / fmaxf(w4.x, 1e-12f);
        if (T >= stop_thresh && tau > 0.f) {
          const float wn = (T * (1.f - att)) * sig_inv;
          r += wn * w4.y;
          g += wn * w4.z;
          b += wn * w4.w;
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
      (const __nv_bfloat16*)payload, (const float*)params,
      (const float*)qscale, (const float*)zb, wins, masks, n_win, (float*)acc,
      G, gi, Dp, Gy, Gx, y0, x0, K, flip);
  return cudaGetLastError();
}

}  // namespace

// wins_masks: (2, n_win) int32 on the device — window ids then occupancy
// bit masks, in march order. The payload is bf16 with Dp = 3*bd + 1.
// Returns cudaGetLastError() after the launch.
extern "C" int vt_march_slabs(const void* payload, const void* params,
                              const void* qscale, const void* zb,
                              const void* wins_masks, int n_win, void* acc,
                              int P, int G, int gi, int Dp, int Gy, int Gx,
                              int y0, int x0, int bd, int K, int flip,
                              void* stream) {
  if (Dp != 3 * bd + 1 || P < 1 || P > 65535 || gi < 1 || K < 1 ||
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
