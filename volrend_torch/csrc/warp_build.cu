// Kernel B: the superquad window-table build, for Hopper (sm_90a).
//
// Replaces volrend_tpu/ops/display_warp.py:_make_build, the Pallas TPU
// kernel behind display_warp._build_table (its plain PyTorch twin is
// volrend_torch/ops/display_warp.py:build_table_ref).
//
// What it computes: the planar (P, 4, gi, gi) f32 intermediate image is
// quantized to affine int8, q = round_half_even(clip(v, 0, 1) * 255) - 128
// (display_warp.py:188-191), and every window position (Y, X) of the
// (H3, W3) = (gi-Wy+1, gi-Wx+1) grid gets one table row holding its
// Wy x Wx cells' four channels, channel (cy*Wx + cx)*4 + c. Output
// (P, H3*W3, 4*Wy*Wx) int8, bit-equal to the reference table.
//
// What bounds it on the H100: bytes. Per pose it reads the 1 MB
// intermediate (gi = 256) and writes the 6.35 MB table: a few microseconds
// at 3.35 TB/s.
//
// Design: one thread per (pose, window row, window cell) writes that
// cell's four channels as one 4-byte store, so a warp writes consecutive
// bytes of consecutive rows; the row-major table is written directly,
// which folds in the transpose the reference did in XLA after its planar
// Pallas build. The input reads repeat each pixel Wy*Wx times, from L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ signed char quant(float v) {
  return (signed char)(int)(rintf(fminf(fmaxf(v, 0.f), 1.f) * 255.f)
                            - 128.f);
}

__global__ void build_kernel(const float* __restrict__ inter,
                             char4* __restrict__ table, long long n,
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
    const float* src = inter + (size_t)p * 4 * npx
                       + (size_t)(Y + cy) * gi + (X + cx);
    char4 q;
    q.x = quant(src[0]);
    q.y = quant(src[npx]);
    q.z = quant(src[2 * npx]);
    q.w = quant(src[3 * npx]);
    table[i] = q;  // char4 index == (rowg * ncell + cell)
  }
}

}  // namespace

// inter: (P, 4, gi, gi) f32; table: (P, H3*W3, 4*Wy*Wx) int8.
// Returns cudaGetLastError() after the launch.
extern "C" int vt_warp_build(const void* inter, void* table, int P, int gi,
                             int Wy, int Wx, void* stream) {
  if (P < 1 || Wy < 1 || Wx < 1 || gi < Wy || gi < Wx)
    return (int)cudaErrorInvalidValue;
  const int H3 = gi - Wy + 1, W3 = gi - Wx + 1;
  const long long n = (long long)P * H3 * W3 * Wy * Wx;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 65535LL * 8 ? want : 65535LL * 8);
  build_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)inter, (char4*)table, n, gi, Wx, Wy * Wx, H3, W3);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
