// Kernel 6: the adjoint of the precise superquad table build, for Hopper
// (sm_90a).
//
// Replaces volrend_tpu/ops/display_warp.py:_build_adjoint, the Pallas TPU
// kernel of the precise warp's backward (its plain PyTorch twin is
// volrend_torch/ops/display_warp.py:build_adjoint_ref).
//
// What it computes: the transpose of kernel B's f32 table build. Every
// intermediate pixel (y, x) appears in Wy x Wx window rows, once per cell:
//   d_inter[p, y, x, c] = sum over (cy, cx), in order, with
//       0 <= y - cy < H3 and 0 <= x - cx < W3, of
//       dtbl[p, (y - cy)*W3 + (x - cx), table_cell(cy, cx, Wx)*4 + c].
// Output (P, gi, gi, 4) f32, the layout of the training path's
// intermediate image (the reference writes planar and transposes in XLA,
// display_warp.py:854).
//
// What bounds it on the H100: bytes. At gi = 256 with a 4x4 window it reads
// the 16.4 MB table cotangent and writes 1 MB: ~5.2 us at 3.35 TB/s.
//
// Design: the gather form, one thread per (pose, y, x) summing its 16
// cells' four colours (one 16-byte load each) and writing them as one
// 16-byte store. The window bounds are tested per cell, so it needs no
// padding (the reference pads the cotangent by 3 on each side, :829) and
// no atomics: the result is deterministic. Neighbouring threads read
// neighbouring table rows; each row is read by 16 threads, from L1/L2.

#include "warp_table.cuh"

namespace {

__global__ void build_adj_kernel(const float4* __restrict__ dtbl,
                                 float4* __restrict__ out, long long n,
                                 int gi, int Wy, int Wx, int H3, int W3) {
  const int ncell = Wy * Wx;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const int x = (int)(i % gi);
    const long long t = i / gi;
    const int y = (int)(t % gi);
    const long long p = t / gi;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int cy = 0; cy < Wy; ++cy) {
      const int Y = y - cy;
      if (Y < 0 || Y >= H3) continue;
      for (int cx = 0; cx < Wx; ++cx) {
        const int X = x - cx;
        if (X < 0 || X >= W3) continue;
        const float4 v = dtbl[(((size_t)p * H3 + Y) * W3 + X) * ncell
                              + table_cell(cy, cx, Wx)];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
    out[i] = acc;
  }
}

}  // namespace

// dtbl: (P, H3*W3, 4*Wy*Wx) f32 with H3, W3 = gi-Wy+1, gi-Wx+1; out:
// (P, gi, gi, 4) f32. Returns cudaGetLastError() after the launch.
extern "C" int vt_warp_build_adj(const void* dtbl, void* out, int P, int gi,
                                 int Wy, int Wx, void* stream) {
  if (P < 1 || Wy < 1 || Wx < 1 || gi < Wy || gi < Wx)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)P * gi * gi;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 65535LL * 8 ? want : 65535LL * 8);
  build_adj_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)dtbl, (float4*)out, n, gi, Wy, Wx, gi - Wy + 1,
      gi - Wx + 1);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
