// Kernel 5: the adjoint of the precise superquad tent-combine, added
// straight into the window table's cotangent, for Hopper (sm_90a).
//
// Replaces volrend_tpu/ops/display_warp.py:_combine_adjoint_kernel, the
// Pallas TPU kernel behind display_warp._combine_adjoint, together with the
// scatter its caller runs after it (`.at[flat].add(rows)`, display_warp.py:
// 874-884). Its plain PyTorch twin is volrend_torch/ops/display_warp.py:
// combine_adjoint_ref.
//
// What it computes: the transpose of kernel C's f32 combine with the
// composite adjoint, at the precise level ((2, 2) screen blocks, a 4 x 4
// window). For each screen block and each of its window cells (cy, cx),
// summed over the block's subpixels s in order:
//   wy, wx  = tent weights of the subpixel's window position (ry, rx),
//             clamped to the window as the forward clamps it;
//   d_c     = ok ? g_c : 0 (c < 3), d_3 = ok ? g_3 - bg*(g_0+g_1+g_2) : 0
//             (the adjoint of out_c = rgba_c + bg*(1 - alpha), out_3 =
//             alpha, both masked by ok);
//   row[cell*4 + c] += wy[cy]*wx[cx]*d_c;
// then each block's row is added into the table cotangent at the block's
// table row, p*H3*W3 + Y0*W3 + X0, where blocks that share a row sum. The
// cotangent g is read in the (P, H, W, 4) layout of the forward's output,
// which folds in the reference's subpixel split (display_warp.py:878-880);
// the table cotangent is written in kernel B's (P, H3*W3, 64) layout, which
// folds in its transpose (:882).
//
// What bounds it on the H100: bytes. At 800^2 and gi = 256 it reads 10.2 MB
// of cotangent, 7.7 MB of geometry and 1.3 MB of window corners, and the
// caller's zero-filled 16.4 MB table is written (L2-resident: the blocks'
// rows are ~12.4 MB of it): ~0.011 ms at 3.35 TB/s; ~0.01 GFLOP.
//
// Design: one thread per screen block, 32-bit index math within a pose;
// neighbouring lanes take neighbouring blocks of a screen row, so the
// planar geometry loads coalesce and each screen row's cotangent is one
// 32-byte run a lane. The thread issues all of its loads (its subpixels'
// cotangent, position and mask, its window corner) before it uses any, so
// that they are in flight together, and accumulates the 16 window cells in
// registers, adding for each subpixel only the 2 x 2 cells its tent weights
// reach (at the floor of its clamped position); the other cells weigh
// exactly 0, so each cell's sum equals the one over the whole window bit
// for bit. Each cell
// that an unmasked subpixel reached is then added into the table with one
// vector atomic (atomicAdd on float4, sm_90's 16-byte reduction): no block
// rows in device memory, no second pass (summing a warp's blocks that
// share a row in shared memory first measured no faster on the H100: the
// reductions are not what limits it). The table's values are exact up to
// the order in which the blocks that share a row add (an order that
// changes from run to run).

#include "warp_table.cuh"

namespace {

constexpr int BY = 2, BX = 2;  // the precise level's screen blocks
constexpr int WY = 4, WX = 4;  // and window
constexpr int S = BY * BX, NCELL = WY * WX;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    combine_adj_kernel(const float4* __restrict__ g,
                       const float* __restrict__ ry,
                       const float* __restrict__ rx,
                       const float* __restrict__ okm,
                       const int* __restrict__ Y0,
                       const int* __restrict__ X0,
                       float4* __restrict__ dtbl, int Hh, int Wh, int H3,
                       int W3, float bg) {
  const int nb = Hh * Wh;
  const int blk = blockIdx.x * THREADS + threadIdx.x;
  if (blk >= nb) return;
  const int p = blockIdx.y;
  const int hh = blk / Wh, wh = blk - hh * Wh;
  const int W = Wh * BX;
  const float4* gp = g + (size_t)p * nb * S + (hh * BY) * W + wh * BX;
  const size_t geo = (size_t)p * S * nb + blk;

  float4 acc[NCELL];
#pragma unroll
  for (int c = 0; c < NCELL; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  // every load first, so that they are all in flight at once
  const int y0 = Y0[p * nb + blk], x0 = X0[p * nb + blk];
  float okv[S], ryv[S], rxv[S];
  float4 d[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    okv[s] = okm[geo + s * nb];
    ryv[s] = ry[geo + s * nb];
    rxv[s] = rx[geo + s * nb];
    d[s] = gp[(s / BX) * W + s % BX];
  }
  unsigned reached = 0;  // bit c: an unmasked subpixel reached cell c
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (okv[s] > 0.5f) {
      const float4 e = make_float4(d[s].x, d[s].y, d[s].z,
                                   d[s].w - bg * (d[s].x + d[s].y + d[s].z));
      const float yv = fminf(fmaxf(ryv[s], 0.f), (float)(WY - 1));
      const float xv = fminf(fmaxf(rxv[s], 0.f), (float)(WX - 1));
      // cells iy, iy + 1 (ix, ix + 1) hold every non-zero tent weight
      const int iy = min((int)yv, WY - 2), ix = min((int)xv, WX - 2);
      float wy[WY], wx[WX];
#pragma unroll
      for (int c = 0; c < WY; ++c)
        wy[c] = fmaxf(0.f, 1.f - fabsf(yv - (float)c));
#pragma unroll
      for (int c = 0; c < WX; ++c)
        wx[c] = fmaxf(0.f, 1.f - fabsf(xv - (float)c));
#pragma unroll
      for (int cy = 0; cy < WY; ++cy)
#pragma unroll
        for (int cx = 0; cx < WX; ++cx) {
          if ((unsigned)(cy - iy) < 2u && (unsigned)(cx - ix) < 2u) {
            const float wyx = wy[cy] * wx[cx];
            float4& a = acc[table_cell(cy, cx, WX)];
            a.x += wyx * e.x;
            a.y += wyx * e.y;
            a.z += wyx * e.z;
            a.w += wyx * e.w;
          }
        }
      reached |= (3u | 3u << WX) << table_cell(iy, ix, WX);
    }
  }
  if (!reached) return;
  float4* row = dtbl + (size_t)p * H3 * W3 * NCELL
                + (y0 * W3 + x0) * NCELL;
#pragma unroll
  for (int c = 0; c < NCELL; ++c)
    if (reached >> c & 1u) atomicAdd(row + c, acc[c]);
}

}  // namespace

// g: (P, H, W, 4) f32 with H = 2*Hh, W = 2*Wh; ry, rx, okm: (P, 4, Hh, Wh)
// f32; Y0, X0: (P, Hh, Wh) int32 window corners in [0, H3) x [0, W3);
// dtbl: (P, H3*W3, 64) f32, 16-byte aligned and zero-filled by the caller,
// each block's row added into it. Returns cudaGetLastError() after the
// launch.
extern "C" int vt_warp_combine_adj(const void* g, const void* ry,
                                   const void* rx, const void* okm,
                                   const void* Y0, const void* X0,
                                   void* dtbl, int P, int Hh, int Wh,
                                   int H3, int W3, float bg, void* stream) {
  const long long px = (long long)Hh * Wh * S;
  if (P < 1 || P > 65535 || Hh < 1 || Wh < 1 || H3 < 1 || W3 < 1 ||
      (long long)P * px >= (1LL << 31) ||
      (long long)H3 * W3 * NCELL >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int nb = Hh * Wh;
  combine_adj_kernel<<<dim3((nb + THREADS - 1) / THREADS, P), THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const float4*)g, (const float*)ry, (const float*)rx,
      (const float*)okm, (const int*)Y0, (const int*)X0, (float4*)dtbl, Hh,
      Wh, H3, W3, bg);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
