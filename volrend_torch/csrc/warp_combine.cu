// Kernel C: the superquad tent-combine and screen emit, for Hopper
// (sm_90a).
//
// Replaces volrend_tpu/ops/display_warp.py:_make_combine_kernel, the Pallas
// TPU kernel behind display_warp._combine_emit (its plain PyTorch twin is
// volrend_torch/ops/display_warp.py:combine_emit_ref).
//
// What it computes, per screen pixel of a (By, Bx) block: the block's
// window row of the int8 table (at Y0*W3 + X0), tent weights from the
// subpixel's window position (ry, rx) clamped to the window,
// sum over the Wy x Wx cells per channel, the affine dequant
// (x qscale + qshift; the tent weights sum to 1, so the zero point is a
// constant add), the ok-mask and the composite over the background. It
// writes interleaved (P, H, W, 4) RGBA directly: uint8 rounded half to
// even after a [0, 1] clamp (as jnp.round), or f32.
//
// What bounds it on the H100: bytes. Per pose at 800^2 with (4,4) blocks
// and a 5x5 window: 4 MB of table rows, 7.7 MB of subpixel geometry
// (ry, rx, ok), 2.6 MB of uint8 output.
//
// Design: one thread per screen pixel, computing in f32. The thread reads
// its block's table row itself, which folds in the reference's XLA gather
// and its planar transpose (display_warp.py:702-703); the reference's bf16
// one-hot lane-placement matmuls (an MXU artifact) become a plain
// interleaved store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WMAX = 8;  // largest window side the unrolled loops take

template <bool U8>
__global__ void combine_kernel(const int8_t* __restrict__ table,
                               const int* __restrict__ Y0,
                               const int* __restrict__ X0,
                               const float* __restrict__ ry,
                               const float* __restrict__ rx,
                               const float* __restrict__ okm,
                               void* __restrict__ out, long long n, int H,
                               int W, int By, int Bx, int Wy, int Wx, int H3,
                               int W3, float bg, float qscale,
                               float qshift) {
  const int Hh = H / By, Wh = W / Bx, S = By * Bx, C = 4 * Wy * Wx;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const int px = (int)(i % W);
    const long long t = i / W;
    const int py = (int)(t % H);
    const long long p = t / H;
    const int hh = py / By, wh = px / Bx;
    const int s = (py - hh * By) * Bx + (px - wh * Bx);
    const size_t blk = ((size_t)p * Hh + hh) * Wh + wh;
    const int8_t* q = table + ((size_t)p * H3 * W3
                               + (size_t)Y0[blk] * W3 + X0[blk]) * C;
    const size_t geo = (((size_t)p * S + s) * Hh + hh) * Wh + wh;
    const float ryv = fminf(fmaxf(ry[geo], 0.f), (float)(Wy - 1));
    const float rxv = fminf(fmaxf(rx[geo], 0.f), (float)(Wx - 1));
    float wx[WMAX];
#pragma unroll
    for (int c = 0; c < WMAX; ++c)
      wx[c] = fmaxf(0.f, 1.f - fabsf(rxv - (float)c));
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int cy = 0; cy < WMAX; ++cy) {
      if (cy < Wy) {
        const float wy = fmaxf(0.f, 1.f - fabsf(ryv - (float)cy));
#pragma unroll
        for (int cx = 0; cx < WMAX; ++cx) {
          if (cx < Wx) {
            const float wyx = wy * wx[cx];
            const char4 e = *(const char4*)(q + (cy * Wx + cx) * 4);
            a0 += wyx * (float)e.x;
            a1 += wyx * (float)e.y;
            a2 += wyx * (float)e.z;
            a3 += wyx * (float)e.w;
          }
        }
      }
    }
    a0 = a0 * qscale + qshift;
    a1 = a1 * qscale + qshift;
    a2 = a2 * qscale + qshift;
    a3 = a3 * qscale + qshift;
    const bool ok = okm[geo] > 0.5f;
    const float rem = bg * (1.f - a3);
    const float o0 = ok ? a0 + rem : bg;
    const float o1 = ok ? a1 + rem : bg;
    const float o2 = ok ? a2 + rem : bg;
    const float o3 = ok ? a3 : 0.f;
    if (U8) {
      uchar4 v;
      v.x = (unsigned char)rintf(fminf(fmaxf(o0, 0.f), 1.f) * 255.f);
      v.y = (unsigned char)rintf(fminf(fmaxf(o1, 0.f), 1.f) * 255.f);
      v.z = (unsigned char)rintf(fminf(fmaxf(o2, 0.f), 1.f) * 255.f);
      v.w = (unsigned char)rintf(fminf(fmaxf(o3, 0.f), 1.f) * 255.f);
      ((uchar4*)out)[i] = v;
    } else {
      ((float4*)out)[i] = make_float4(o0, o1, o2, o3);
    }
  }
}

}  // namespace

// table: (P, H3*W3, 4*Wy*Wx) int8; Y0, X0: (P, H/By, W/Bx) int32;
// ry, rx, okm: (P, By*Bx, H/By, W/Bx) f32; out: (P, H, W, 4) uint8
// (out_u8) or f32. Returns cudaGetLastError() after the launch.
extern "C" int vt_warp_combine(const void* table, const void* Y0,
                               const void* X0, const void* ry,
                               const void* rx, const void* okm, void* out,
                               int out_u8, int P, int H, int W, int By,
                               int Bx, int Wy, int Wx, int H3, int W3,
                               float bg, float qscale, float qshift,
                               void* stream) {
  if (P < 1 || By < 1 || Bx < 1 || H % By || W % Bx || Wy < 1 || Wx < 1 ||
      Wy > WMAX || Wx > WMAX)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)P * H * W;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 65535LL * 8 ? want : 65535LL * 8);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_u8)
    combine_kernel<true><<<blocks, threads, 0, s>>>(
        (const int8_t*)table, (const int*)Y0, (const int*)X0,
        (const float*)ry, (const float*)rx, (const float*)okm, out, n, H, W,
        By, Bx, Wy, Wx, H3, W3, bg, qscale, qshift);
  else
    combine_kernel<false><<<blocks, threads, 0, s>>>(
        (const int8_t*)table, (const int*)Y0, (const int*)X0,
        (const float*)ry, (const float*)rx, (const float*)okm, out, n, H, W,
        By, Bx, Wy, Wx, H3, W3, bg, qscale, qshift);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
