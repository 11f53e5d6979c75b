// Kernel M-bwd: the payload cotangent of the training-mode slab march, for
// Hopper (sm_90a).
//
// Replaces volrend_tpu/ops/pallas_slab.py:_make_bwd_kernel, the Pallas TPU
// kernel behind pallas_slab.march_slabs_bwd (its plain PyTorch twin is
// volrend_torch/ops/slab_march.py:march_slabs_bwd_ref).
//
// What it computes, for one pose: the gradient of the march's output
// acc (4, gi, gi) = [r, g, b, T] with respect to the bf16 channel-planar
// payload (Gz, D, G, G), given the upstream cotangent gacc = [g_r, g_g,
// g_b, g_T]. It re-marches the slabs in forward order carrying per pixel
// (T, A) from an initial state (1, 0 for the whole grid) and applies the
// suffix-reconstruction algebra of ops/grad.py:
//   ctot = sum_c gacc_c * acc_c,    gT = gacc_3 * acc_3 (precomputed aux)
//   A   += w * G_pix,               G_pix = sum_c gacc_c * rgb_w_c
//   g_tau    = m * (T * att * G_pix - (ctot - A) - gT)
//   g_srgb_w = gacc_c * w / sig_w
//   g_sig_w  = g_tau * dt - [sig_w >= 1e-12] sum_c gacc_c w srgb_w_c / sig_w^2
// then the transposed box-overlap warp onto the slab's voxels and the shade
// adjoint (sigmoid' times the SH basis; sigma masked by the threshold).
// Output (Gz, D, G, G) in f32 or bf16.
//
// What bounds it on the H100: the bytes. The function reads the bf16
// payload once (256^3 x 28 x 2 B = 0.94 GB at SH9) and writes the f32
// cotangent once (1.88 GB): ~0.84 ms at 3.35 TB/s. Its operations (the
// forward recompute, ~110 fp32 operations per voxel at SH9 plus ~60 per
// pixel and slab, and the adjoint, about as many again) come to ~0.3 ms at
// 67 TFLOP/s.
//
// Design (atomics, the second of the two designs the port's plan allows):
// - Pass 1 (bwd_march_kernel) is kernel M's block structure: one block per
//   16x16 pixel tile, one thread per pixel, the slab loop inside the block.
//   Per slab the block shades its footprint into shared memory and each
//   pixel sums its taps with kernel M's own code (shade_and_sum in
//   slab_common.cuh, so T follows the forward's trajectory), then computes its
//   four pixel-space cotangents [g_sig_w, g_srgb_w x 3]. The transpose of
//   the warp is a scatter: each pixel adds weight x cotangent onto the cells
//   of its span in a shared-memory copy of the footprint (shared-memory
//   atomics), and the block then adds the footprint's nonzero cells into a
//   (Gz, 4, G, G) f32 buffer with global atomics: neighbouring tiles'
//   footprints overlap by a few cells, so a cell collects up to four tiles'
//   sums. The order of those additions varies from run to run; the result
//   agrees with the plain version to f32 rounding (the tolerance is stated
//   in chip_smoke.py and tests/test_torch_cuda.py).
// - Pass 2 (bwd_shade_kernel) is elementwise over voxels: it recomputes
//   sigma and rgb at the slab's per-slab view direction and turns the four
//   voxel cotangents into the D payload planes, written once each (f32, or
//   bf16 for the lean trainer). Voxels whose four cotangents are zero
//   (dead windows, empty space) write zeros without shading.
// - As in the forward, a block leaves its slab loop once no pixel of its
//   tile can still accumulate, and skips slabs no pixel can see.

#include "slab_common.cuh"

namespace {

template <int BD>
__global__ void __launch_bounds__(NTHREADS)
bwd_march_kernel(const __nv_bfloat16* __restrict__ payload,
                 const float* __restrict__ params,
                 const float* __restrict__ qscale,
                 const float* __restrict__ zb,
                 const float* __restrict__ gacc,
                 const float* __restrict__ aux,
                 float* __restrict__ gbuf, int Gz, int G, int gi, int flip) {
  constexpr int D = 3 * BD + 1;
  __shared__ float s_chan[4][FMAX][FMAX + 1];
  __shared__ float s_prm[NP];
  __shared__ float s_qs[D];

  const int tid = threadIdx.y * TILE + threadIdx.x;
  const int j0 = blockIdx.y * TILE, k0 = blockIdx.x * TILE;
  const int j = j0 + threadIdx.y, k = k0 + threadIdx.x;
  const bool inpix = (j < gi) && (k < gi);

  if (tid < NP) s_prm[tid] = params[tid];
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
  // per pixel: z interval, slab thickness, upstream cotangent, the aux
  // planes [ctot, T_end * g_T] and the incoming (T, A) state
  float zlo = 1.f, zhi = 0.f, dtp = 0.f;
  float ga0 = 0.f, ga1 = 0.f, ga2 = 0.f, ctot = 0.f, gT = 0.f;
  float T = 1.f, A = 0.f;
  if (inpix) {
    zlo = zb[pix];
    zhi = zb[npx + pix];
    dtp = zb[2 * npx + pix];
    ga0 = gacc[pix];
    ga1 = gacc[npx + pix];
    ga2 = gacc[2 * npx + pix];
    ctot = aux[pix];
    gT = aux[npx + pix];
    T = aux[2 * npx + pix];
    A = aux[3 * npx + pix];
  }

  const int jl = min(j0 + TILE, gi) - 1, kl = min(k0 + TILE, gi) - 1;
  const float ujG = (u0 + du * (float)j) * Gf;
  const float vkG = (v0 + dv * (float)k) * Gf;
  const float ujGa = (u0 + du * (float)j0) * Gf;
  const float ujGb = (u0 + du * (float)jl) * Gf;
  const float vkGa = (v0 + dv * (float)k0) * Gf;
  const float vkGb = (v0 + dv * (float)kl) * Gf;
  const size_t plane = (size_t)G * G;

  for (int t = 0; t < Gz; ++t) {
    const int sid = flip ? (Gz - 1 - t) : t;
    const float z = ((float)sid + 0.5f) / Gf + zbase;
    const bool passed = flip ? (z + hG < zlo) : (z - hG > zhi);
    const bool alive = inpix && (T >= stop_thresh) && (zlo <= zhi) && !passed;
    if (!__syncthreads_or(alive)) break;
    const bool live = alive && (zlo <= z + hG) && (zhi >= z - hG);
    if (!__syncthreads_or(live)) continue;

    const float s0 = z - hG - cz;
    const float s1 = z + hG - cz;
    const float sd = z - cz;
    const float sdsign = sign_of(sd);
    const Footprint f = tile_footprint(cyG, cxG, s0, s1, ujGa, ujGb, vkGa,
                                       vkGb, G, 0, G - 1, 0, G - 1);
    const PixelSpan sp = pixel_span(cyG, cxG, s0, s1, ujG, vkG, G, f);

    // ---- forward recompute (kernel M's training mode, the same code) -----
    const float4 w4 = shade_and_sum<BD>(
        payload + (size_t)sid * D * plane, plane, G, 0, 0, f, sp, inpix, tid,
        G, cy, cx, sigma_thresh, sd, sdsign, s_qs, s_prm, s_chan);
    const float sw = w4.x, rw = w4.y, gw = w4.z, bw = w4.w;

    // ---- pixel-space cotangents (suffix algebra) -------------------------
    float gs0 = 0.f, gs1 = 0.f, gs2 = 0.f, gs3 = 0.f;
    if (inpix) {
      const float frac = fminf(fmaxf(
          (fminf(z + hG, zhi) - fmaxf(z - hG, zlo)) * Gf, 0.f), 1.f);
      const float dt = dtp * frac;
      const float tau = sw * dt;
      const float att = expf(-tau);
      const float sig_inv = 1.f / fmaxf(sw, 1e-12f);
      const bool m = (T >= stop_thresh) && (tau > 0.f);
      const float w = m ? T * (1.f - att) : 0.f;
      const float G_pix =
          ga0 * (rw * sig_inv) + ga1 * (gw * sig_inv) + ga2 * (bw * sig_inv);
      A = A + w * G_pix;
      const float g_tau = m ? (T * att * G_pix - (ctot - A) - gT) : 0.f;
      const float sum_term = ga0 * w * rw + ga1 * w * gw + ga2 * w * bw;
      gs0 = g_tau * dt - ((sw >= 1e-12f) ? sum_term * sig_inv * sig_inv
                                         : 0.f);
      gs1 = ga0 * w * sig_inv;
      gs2 = ga1 * w * sig_inv;
      gs3 = ga2 * w * sig_inv;
      if (m) T = T * att;
    }
    const bool has_g =
        inpix && (gs0 != 0.f || gs1 != 0.f || gs2 != 0.f || gs3 != 0.f);
    if (!__syncthreads_or(has_g)) continue;

    // ---- adjoint warp: scatter onto the footprint, then into gbuf --------
    float* gslab = gbuf + (size_t)sid * 4 * plane;
    for (int py0 = f.y_lo; py0 <= f.y_hi; py0 += FMAX) {
      const int FY = min(FMAX, f.y_hi - py0 + 1);
      for (int px0 = f.x_lo; px0 <= f.x_hi; px0 += FMAX) {
        const int FX = min(FMAX, f.x_hi - px0 + 1);
        __syncthreads();
        for (int i = tid; i < FY * FX; i += NTHREADS) {
          const int ly = i / FX, lx = i - ly * FX;
          s_chan[0][ly][lx] = 0.f;
          s_chan[1][ly][lx] = 0.f;
          s_chan[2][ly][lx] = 0.f;
          s_chan[3][ly][lx] = 0.f;
        }
        __syncthreads();
        if (has_g) {
          const int ya = max(sp.ry_lo, py0), yb = min(sp.ry_hi, py0 + FY - 1);
          const int xa = max(sp.rx_lo, px0), xb = min(sp.rx_hi, px0 + FX - 1);
          for (int cyy = ya; cyy <= yb; ++cyy) {
            const float wr = overlap(cyy, G, sp.pmin, sp.pmax, sp.inv_r);
            const int ly = cyy - py0;
            for (int cxx = xa; cxx <= xb; ++cxx) {
              const float wgt =
                  wr * overlap(cxx, G, sp.qmin, sp.qmax, sp.inv_c);
              if (wgt == 0.f) continue;
              const int lx = cxx - px0;
              atomicAdd(&s_chan[0][ly][lx], wgt * gs0);
              atomicAdd(&s_chan[1][ly][lx], wgt * gs1);
              atomicAdd(&s_chan[2][ly][lx], wgt * gs2);
              atomicAdd(&s_chan[3][ly][lx], wgt * gs3);
            }
          }
        }
        __syncthreads();
        for (int i = tid; i < FY * FX; i += NTHREADS) {
          const int ly = i / FX, lx = i - ly * FX;
          const size_t cell = (size_t)(py0 + ly) * G + (px0 + lx);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float v = s_chan[c][ly][lx];
            if (v != 0.f) atomicAdd(gslab + (size_t)c * plane + cell, v);
          }
        }
      }
    }
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// the shade adjoint, one thread per voxel of one slab (blockIdx.y)
template <int BD, typename OutT>
__global__ void __launch_bounds__(NTHREADS)
bwd_shade_kernel(const __nv_bfloat16* __restrict__ payload,
                 const float* __restrict__ params,
                 const float* __restrict__ qscale,
                 const float* __restrict__ gbuf, OutT* __restrict__ out,
                 int G) {
  constexpr int D = 3 * BD + 1;
  __shared__ float s_prm[NP];
  __shared__ float s_qs[D];
  const int tid = threadIdx.x;
  if (tid < NP) s_prm[tid] = params[tid];
  for (int i = tid; i < D; i += NTHREADS) s_qs[i] = qscale[i];
  __syncthreads();

  const size_t plane = (size_t)G * G;
  const size_t cell = (size_t)blockIdx.x * NTHREADS + tid;
  if (cell >= plane) return;
  const int sid = blockIdx.y;
  const float* gv = gbuf + (size_t)sid * 4 * plane + cell;
  const float g0 = gv[0], g1 = gv[plane], g2 = gv[2 * plane],
              g3 = gv[3 * plane];
  OutT* o = out + (size_t)sid * D * plane + cell;
  const __nv_bfloat16* src = payload + (size_t)sid * D * plane + cell;
  const float sigma = voxel_sigma<D>(src, plane, s_qs);
  // a voxel under the sigma threshold is masked out of the forward: its
  // cotangent is zero whatever reached it
  if ((g0 == 0.f && g1 == 0.f && g2 == 0.f && g3 == 0.f) ||
      !(sigma > s_prm[14])) {
#pragma unroll
    for (int c = 0; c < D; ++c) store(o + (size_t)c * plane, 0.f);
    return;
  }
  const float Gf = (float)G;
  const int gy = (int)(cell / G), gx = (int)(cell % G);
  const float z = ((float)sid + 0.5f) / Gf + s_prm[30];
  const float sd = z - s_prm[0];
  const float ycm = ((float)gy + 0.5f) * (1.f / Gf) - s_prm[1];
  const float xcm = ((float)gx + 0.5f) * (1.f / Gf) - s_prm[2];
  float bk[BD], rgb[3];
  voxel_rgb<BD>(src, plane, s_qs, s_prm, ycm, xcm, sd, sign_of(sd), bk, rgb);

  const float gsig = g0 + g1 * rgb[0] + g2 * rgb[1] + g3 * rgb[2];
  store(o + (size_t)(D - 1) * plane, gsig * s_qs[D - 1]);
  const float graw[3] = {g1 * sigma * rgb[0] * (1.f - rgb[0]),
                         g2 * sigma * rgb[1] * (1.f - rgb[1]),
                         g3 * sigma * rgb[2] * (1.f - rgb[2])};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int kk = 0; kk < BD; ++kk)
      store(o + (size_t)(c * BD + kk) * plane,
            graw[c] * bk[kk] * s_qs[c * BD + kk]);
  }
}

template <int BD>
cudaError_t launch(const void* payload, const void* params,
                   const void* qscale, const void* zb, const void* gacc,
                   const void* aux, void* gbuf, void* out, int out_bf16,
                   int Gz, int G, int gi, int flip, cudaStream_t stream) {
  const dim3 block(TILE, TILE);
  const dim3 grid((gi + TILE - 1) / TILE, (gi + TILE - 1) / TILE);
  bwd_march_kernel<BD><<<grid, block, 0, stream>>>(
      (const __nv_bfloat16*)payload, (const float*)params,
      (const float*)qscale, (const float*)zb, (const float*)gacc,
      (const float*)aux, (float*)gbuf, Gz, G, gi, flip);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 sgrid((unsigned)((size_t)G * G + NTHREADS - 1) / NTHREADS, Gz);
  if (out_bf16)
    bwd_shade_kernel<BD, __nv_bfloat16><<<sgrid, NTHREADS, 0, stream>>>(
        (const __nv_bfloat16*)payload, (const float*)params,
        (const float*)qscale, (const float*)gbuf, (__nv_bfloat16*)out, G);
  else
    bwd_shade_kernel<BD, float><<<sgrid, NTHREADS, 0, stream>>>(
        (const __nv_bfloat16*)payload, (const float*)params,
        (const float*)qscale, (const float*)gbuf, (float*)out, G);
  return cudaGetLastError();
}

}  // namespace

// payload (Gz, D, G, G) bf16; params (31,) f32; qscale (D,) f32; zb
// (4, gi, gi) f32 (_zb_planes); gacc (4, gi, gi) f32; aux (4, gi, gi) f32 =
// [ctot, T_end * g_T, T_in, A_in]; gbuf (Gz, 4, G, G) f32, zeroed by the
// caller; out (Gz, D, G, G) f32 or bf16 (out_bf16). Returns
// cudaGetLastError() after the launches.
extern "C" int vt_march_slabs_bwd(const void* payload, const void* params,
                                  const void* qscale, const void* zb,
                                  const void* gacc, const void* aux,
                                  void* gbuf, void* out, int out_bf16,
                                  int Gz, int G, int gi, int bd, int flip,
                                  void* stream) {
  if (Gz < 1 || Gz > 65535 || G < 1 || gi < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bd) {
    case 1:
      return (int)launch<1>(payload, params, qscale, zb, gacc, aux, gbuf,
                            out, out_bf16, Gz, G, gi, flip, s);
    case 4:
      return (int)launch<4>(payload, params, qscale, zb, gacc, aux, gbuf,
                            out, out_bf16, Gz, G, gi, flip, s);
    case 9:
      return (int)launch<9>(payload, params, qscale, zb, gacc, aux, gbuf,
                            out, out_bf16, Gz, G, gi, flip, s);
    case 16:
      return (int)launch<16>(payload, params, qscale, zb, gacc, aux, gbuf,
                             out, out_bf16, Gz, G, gi, flip, s);
    case 25:
      return (int)launch<25>(payload, params, qscale, zb, gacc, aux, gbuf,
                             out, out_bf16, Gz, G, gi, flip, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
