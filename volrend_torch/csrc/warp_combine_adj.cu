// Kernel 5: the adjoint of the precise superquad tent-combine, for Hopper
// (sm_90a).
//
// Replaces volrend_tpu/ops/display_warp.py:_combine_adjoint_kernel, the
// Pallas TPU kernel behind display_warp._combine_adjoint (its plain
// PyTorch twin is volrend_torch/ops/display_warp.py:combine_adjoint_ref).
//
// What it computes: the transpose of kernel C's f32 combine with the
// composite adjoint. For each (By, Bx) screen block and each of its
// Wy x Wx window cells (cy, cx), summed over the block's subpixels s in
// order:
//   wy, wx  = tent weights of the subpixel's window position (ry, rx),
//             clamped to the window as the forward clamps it;
//   d_c     = ok ? g_c : 0 (c < 3), d_3 = ok ? g_3 - bg*(g_0+g_1+g_2) : 0
//             (the adjoint of out_c = rgba_c + bg*(1 - alpha), out_3 =
//             alpha, both masked by ok);
//   row[cell*4 + c] += wy[cy]*wx[cx]*d_c.
// The cotangent g is read in the (P, H, W, 4) layout of the forward's
// output, which folds in the reference's subpixel split (display_warp.py:
// 878-880); the (P, Hh*Wh, 4*Wy*Wx) rows are written in the layout the
// scatter into the table cotangent reads, which folds in its transpose
// (:882).
//
// What bounds it on the H100: bytes. At 800^2 with (2,2) blocks and a 4x4
// window it reads 10.2 MB of cotangent and 7.7 MB of geometry and writes
// 41 MB of rows: ~17.6 us at 3.35 TB/s; ~0.08 GFLOP.
//
// Design: one thread per (block, window cell) accumulates that cell's four
// colours in registers and writes them as one 16-byte store, so a warp
// writes 512 contiguous bytes. There are no collisions (each block owns
// its row) and no atomics: the result is deterministic. The 16 threads of
// a block read the same subpixel cotangents and geometry, from L1.

#include "warp_table.cuh"

namespace {

__global__ void combine_adj_kernel(const float4* __restrict__ g,
                                   const float* __restrict__ ry,
                                   const float* __restrict__ rx,
                                   const float* __restrict__ okm,
                                   float4* __restrict__ rows, long long n,
                                   int Hh, int Wh, int By, int Bx, int Wy,
                                   int Wx, float bg) {
  const int S = By * Bx, ncell = Wy * Wx, W = Wh * Bx;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const int cell = (int)(i % ncell);
    const long long blk = i / ncell;           // (p * Hh + hh) * Wh + wh
    const int wh = (int)(blk % Wh);
    const long long t = blk / Wh;
    const int hh = (int)(t % Hh);
    const long long p = t / Hh;
    const int cy = cell / Wx, cx = cell - cy * Wx;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int s = 0; s < S; ++s) {
      const int sy = s / Bx, sx = s - sy * Bx;
      const size_t geo = (((size_t)p * S + s) * Hh + hh) * Wh + wh;
      const float ryv = fminf(fmaxf(ry[geo], 0.f), (float)(Wy - 1));
      const float rxv = fminf(fmaxf(rx[geo], 0.f), (float)(Wx - 1));
      const float wyx = fmaxf(0.f, 1.f - fabsf(ryv - (float)cy))
                        * fmaxf(0.f, 1.f - fabsf(rxv - (float)cx));
      float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
      if (okm[geo] > 0.5f) {
        d = g[((size_t)p * Hh * By + (size_t)hh * By + sy) * W
              + (size_t)wh * Bx + sx];
        d.w = d.w - bg * (d.x + d.y + d.z);
      }
      a0 += wyx * d.x;
      a1 += wyx * d.y;
      a2 += wyx * d.z;
      a3 += wyx * d.w;
    }
    rows[blk * ncell + table_cell(cy, cx, Wx)] = make_float4(a0, a1, a2, a3);
  }
}

}  // namespace

// g: (P, Hh*By, Wh*Bx, 4) f32; ry, rx, okm: (P, By*Bx, Hh, Wh) f32; rows:
// (P, Hh*Wh, 4*Wy*Wx) f32. Returns cudaGetLastError() after the launch.
extern "C" int vt_warp_combine_adj(const void* g, const void* ry,
                                   const void* rx, const void* okm,
                                   void* rows, int P, int Hh, int Wh, int By,
                                   int Bx, int Wy, int Wx, float bg,
                                   void* stream) {
  if (P < 1 || Hh < 1 || Wh < 1 || By < 1 || Bx < 1 || Wy < 1 || Wx < 1)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)P * Hh * Wh * Wy * Wx;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 65535LL * 8 ? want : 65535LL * 8);
  combine_adj_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)g, (const float*)ry, (const float*)rx,
      (const float*)okm, (float4*)rows, n, Hh, Wh, By, Bx, Wy, Wx, bg);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
