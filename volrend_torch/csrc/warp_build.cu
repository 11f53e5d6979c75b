// Kernel B: the superquad window-table build, for Hopper (sm_90a).
//
// Replaces volrend_tpu/ops/display_warp.py:_make_build, the Pallas TPU
// kernel behind display_warp._build_table (its plain PyTorch twin is
// volrend_torch/ops/display_warp.py:build_table_ref).
//
// What it computes: every window position (Y, X) of the (H3, W3) =
// (gi-Wy+1, gi-Wx+1) grid of the (P, 4, gi, gi) f32 intermediate image
// gets one table row holding its Wy x Wx cells' four channels, channel
// (cy*Wx + cx)*4 + c (csrc/warp_table.cuh). Two table types:
// - int8 (the display path): the cells quantized to affine int8,
//   q = round_half_even(clip(v, 0, 1) * 255) - 128 (display_warp.py:
//   188-191), bit-equal to the reference table;
// - f32 (the precise training warp, display_warp.py:864): a plain copy.
// The input is channel-planar (P, 4, gi, gi) (the march's emit layout) or
// interleaved (P, gi, gi, 4) (the training path's intermediate image).
// Output (P, H3*W3, 4*Wy*Wx).
//
// What bounds it on the H100: bytes. Per pose it reads the 1 MB
// intermediate (gi = 256) and writes the table: 6.35 MB int8 (Wy = Wx = 5)
// or 16.4 MB f32 (4 x 4): a few microseconds at 3.35 TB/s.
//
// Design: one thread per (pose, window row, window cell) writes that
// cell's four channels as one 4- or 16-byte store, so a warp writes
// consecutive bytes of consecutive rows; the row-major table is written
// directly, which folds in the transpose the reference did in XLA after
// its planar Pallas build (and, for an interleaved input, the relayout
// before it). The input reads repeat each pixel Wy*Wx times, from L1/L2.

#include "warp_table.cuh"

namespace {

__device__ __forceinline__ signed char quant(float v) {
  return (signed char)(int)(rintf(fminf(fmaxf(v, 0.f), 1.f) * 255.f)
                            - 128.f);
}

__device__ __forceinline__ void store_cell(char4* table, long long i,
                                           float a, float b, float c,
                                           float d) {
  char4 q;
  q.x = quant(a);
  q.y = quant(b);
  q.z = quant(c);
  q.w = quant(d);
  table[i] = q;
}

__device__ __forceinline__ void store_cell(float4* table, long long i,
                                           float a, float b, float c,
                                           float d) {
  table[i] = make_float4(a, b, c, d);
}

template <typename Cell, bool PLANAR>
__global__ void build_kernel(const float* __restrict__ inter,
                             Cell* __restrict__ table, long long n,
                             int gi, int Wx, int ncell, int H3, int W3) {
  const size_t npx = (size_t)gi * gi;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const int cell = (int)(i % ncell);
    const long long rowg = i / ncell;        // pose * H3*W3 + row
    const int row = (int)(rowg % ((long long)H3 * W3));
    const long long p = rowg / ((long long)H3 * W3);
    const int Y = row / W3, X = row - Y * W3;
    const int cy = cell / Wx, cx = cell - cy * Wx;
    const size_t pix = (size_t)(Y + cy) * gi + (X + cx);
    if (PLANAR) {
      const float* src = inter + (size_t)p * 4 * npx + pix;
      store_cell(table, i, src[0], src[npx], src[2 * npx], src[3 * npx]);
    } else {
      const float4 v = ((const float4*)inter)[(size_t)p * npx + pix];
      store_cell(table, i, v.x, v.y, v.z, v.w);
    }
  }
}

template <typename Cell, bool PLANAR>
void launch(const void* inter, void* table, long long n, int gi, int Wx,
            int ncell, int H3, int W3, cudaStream_t s) {
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 65535LL * 8 ? want : 65535LL * 8);
  build_kernel<Cell, PLANAR><<<blocks, threads, 0, s>>>(
      (const float*)inter, (Cell*)table, n, gi, Wx, ncell, H3, W3);
}

}  // namespace

// inter: (P, 4, gi, gi) f32 (planar) or (P, gi, gi, 4) f32; table:
// (P, H3*W3, 4*Wy*Wx) int8, or f32 with table_f32. Returns
// cudaGetLastError() after the launch.
extern "C" int vt_warp_build(const void* inter, void* table, int P, int gi,
                             int Wy, int Wx, int table_f32, int planar,
                             void* stream) {
  if (P < 1 || Wy < 1 || Wx < 1 || gi < Wy || gi < Wx)
    return (int)cudaErrorInvalidValue;
  const int H3 = gi - Wy + 1, W3 = gi - Wx + 1, ncell = Wy * Wx;
  const long long n = (long long)P * H3 * W3 * ncell;
  cudaStream_t s = (cudaStream_t)stream;
  if (table_f32) {
    if (planar)
      launch<float4, true>(inter, table, n, gi, Wx, ncell, H3, W3, s);
    else
      launch<float4, false>(inter, table, n, gi, Wx, ncell, H3, W3, s);
  } else {
    if (planar)
      launch<char4, true>(inter, table, n, gi, Wx, ncell, H3, W3, s);
    else
      launch<char4, false>(inter, table, n, gi, Wx, ncell, H3, W3, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
