// Kernel C: the superquad tent-combine and screen emit, for Hopper
// (sm_90a).
//
// Replaces volrend_tpu/ops/display_warp.py:_make_combine_kernel, the Pallas
// TPU kernel behind display_warp._combine_emit (its plain PyTorch twin is
// volrend_torch/ops/display_warp.py:combine_emit_ref).
//
// What it computes, per screen pixel of a (By, Bx) block: the block's
// window row of the table (at Y0*W3 + X0), tent weights from the
// subpixel's window position (ry, rx) clamped to the window,
// sum over the Wy x Wx cells per channel, the affine dequant
// (x qscale + qshift; the tent weights sum to 1, so the zero point is a
// constant add), the ok-mask and the composite over the background. It
// writes interleaved (P, H, W, 4) RGBA directly: uint8 rounded half to
// even after a [0, 1] clamp (as jnp.round), or f32. The table is the
// display path's int8 one, or the precise training warp's f32 one
// (qscale 1, qshift 0: display_warp.py:870).
//
// What bounds it on the H100: bytes. Per pose at 800^2 with (4,4) blocks
// and a 5x5 window: 4 MB of int8 table rows, 7.7 MB of subpixel geometry
// (ry, rx, ok), 2.6 MB of uint8 output; the precise warp's (2,2) blocks
// read the 12.4 MB of f32 rows they use, 8.96 MB of geometry and corners,
// and write a 10.2 MB f32 frame (~0.0094 ms at 3.35 TB/s).
//
// Design: the generic kernel takes one thread per screen pixel, computing
// in f32. The thread reads its block's table row itself, which folds in
// the reference's XLA gather and its planar transpose (display_warp.py:
// 702-703, 866-867); the reference's bf16 one-hot lane-placement matmuls
// (an MXU artifact, whose precise-path hi/lo split reconstructs f32 to
// ~2^-17) become a plain interleaved f32 store. The precise level's f32
// table and f32 frame (the training warp's forward) take a kernel with its
// sizes as constants, as kernel W's production levels do: one thread per
// screen block, 32-bit index math within a pose, neighbouring lanes on
// neighbouring blocks of a screen row (the geometry loads coalesce). The
// thread reads its block's row once, and of it only the 2 x 2 cells each
// subpixel's tent weights reach; the cells it skips weigh exactly 0 and
// the sums keep the generic kernel's expressions and cell order, so its
// frames equal the generic kernel's bit for bit. It writes a screen row of
// its block as two float4 stores, so a warp writes 1 KB contiguous. Every
// other level and mode (the int8 table, the uint8 emit) runs the generic
// kernel.

#include "warp_table.cuh"

namespace {

constexpr int WMAX = 8;  // largest window side the unrolled loops take

template <typename TQ, bool U8>
__global__ void combine_kernel(const TQ* __restrict__ table,
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
    const TQ* q = table + ((size_t)p * H3 * W3
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
            const float4 e = load_cell(q, table_cell(cy, cx, Wx));
            a0 += wyx * e.x;
            a1 += wyx * e.y;
            a2 += wyx * e.z;
            a3 += wyx * e.w;
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

// the precise level's f32 table and f32 frame: BY x BX blocks, a WY x WX
// window, all constants; one thread per screen block
constexpr int THREADS = 128;

template <int BY, int BX, int WY, int WX>
__global__ void __launch_bounds__(THREADS)
    combine_f32_kernel(const float* __restrict__ table,
                       const int* __restrict__ Y0,
                       const int* __restrict__ X0,
                       const float* __restrict__ ry,
                       const float* __restrict__ rx,
                       const float* __restrict__ okm,
                       float4* __restrict__ out, int Hh, int Wh, int H3,
                       int W3, float bg, float qscale, float qshift) {
  static_assert(WY >= 2 && WX >= 2, "the 2 x 2 taps need a 2 x 2 window");
  constexpr int S = BY * BX, C = 4 * WY * WX;
  const int nb = Hh * Wh;
  const int blk = blockIdx.x * THREADS + threadIdx.x;
  if (blk >= nb) return;
  const int p = blockIdx.y;
  const int hh = blk / Wh, wh = blk - hh * Wh;
  const int W = Wh * BX;
  const float* q = table + (size_t)p * H3 * W3 * C
                   + (Y0[p * nb + blk] * W3 + X0[p * nb + blk]) * C;
  const size_t geo = (size_t)p * S * nb + blk;
  float4* o = out + (size_t)p * nb * S + (hh * BY) * W + wh * BX;
#pragma unroll
  for (int sy = 0; sy < BY; ++sy) {
    float4 v[BX];
#pragma unroll
    for (int sx = 0; sx < BX; ++sx) {
      const int s = sy * BX + sx;
      const float ryv = fminf(fmaxf(ry[geo + s * nb], 0.f), (float)(WY - 1));
      const float rxv = fminf(fmaxf(rx[geo + s * nb], 0.f), (float)(WX - 1));
      // cells iy, iy + 1 (ix, ix + 1) hold every non-zero tent weight
      const int iy = min((int)ryv, WY - 2), ix = min((int)rxv, WX - 2);
      const float wy0 = fmaxf(0.f, 1.f - fabsf(ryv - (float)iy));
      const float wy1 = fmaxf(0.f, 1.f - fabsf(ryv - (float)(iy + 1)));
      const float wx0 = fmaxf(0.f, 1.f - fabsf(rxv - (float)ix));
      const float wx1 = fmaxf(0.f, 1.f - fabsf(rxv - (float)(ix + 1)));
      const int c0 = table_cell(iy, ix, WX);
      const float4 e00 = load_cell(q, c0), e01 = load_cell(q, c0 + 1);
      const float4 e10 = load_cell(q, c0 + WX);
      const float4 e11 = load_cell(q, c0 + WX + 1);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      // the generic kernel's cell order (cy outer, cx inner)
#define VT_TAP(WT, E) \
  {                   \
    const float wyx = (WT); \
    a0 += wyx * E.x;  \
    a1 += wyx * E.y;  \
    a2 += wyx * E.z;  \
    a3 += wyx * E.w;  \
  }
      VT_TAP(wy0 * wx0, e00)
      VT_TAP(wy0 * wx1, e01)
      VT_TAP(wy1 * wx0, e10)
      VT_TAP(wy1 * wx1, e11)
#undef VT_TAP
      a0 = a0 * qscale + qshift;
      a1 = a1 * qscale + qshift;
      a2 = a2 * qscale + qshift;
      a3 = a3 * qscale + qshift;
      const bool ok = okm[geo + s * nb] > 0.5f;
      const float rem = bg * (1.f - a3);
      const float o0 = ok ? a0 + rem : bg;
      const float o1 = ok ? a1 + rem : bg;
      const float o2 = ok ? a2 + rem : bg;
      const float o3 = ok ? a3 : 0.f;
      v[sx] = make_float4(o0, o1, o2, o3);
    }
#pragma unroll
    for (int sx = 0; sx < BX; ++sx) o[sy * W + sx] = v[sx];
  }
}

template <typename TQ, bool U8>
void launch(const void* table, const void* Y0, const void* X0,
            const void* ry, const void* rx, const void* okm, void* out,
            long long n, int H, int W, int By, int Bx, int Wy, int Wx,
            int H3, int W3, float bg, float qscale, float qshift,
            cudaStream_t s) {
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 65535LL * 8 ? want : 65535LL * 8);
  combine_kernel<TQ, U8><<<blocks, threads, 0, s>>>(
      (const TQ*)table, (const int*)Y0, (const int*)X0, (const float*)ry,
      (const float*)rx, (const float*)okm, out, n, H, W, By, Bx, Wy, Wx, H3,
      W3, bg, qscale, qshift);
}

}  // namespace

// table: (P, H3*W3, 4*Wy*Wx) int8, or f32 with table_f32; Y0, X0:
// (P, H/By, W/Bx) int32; ry, rx, okm: (P, By*Bx, H/By, W/Bx) f32; out:
// (P, H, W, 4) uint8 (out_u8) or f32. An f32 table and frame at the
// precise level ((2, 2) blocks, a 4 x 4 window) take the constant-size
// kernel unless ``generic`` (set only by the checks that hold the two
// kernels bit-equal) asks for the generic one. Returns
// cudaGetLastError() after the launch.
extern "C" int vt_warp_combine(const void* table, const void* Y0,
                               const void* X0, const void* ry,
                               const void* rx, const void* okm, void* out,
                               int out_u8, int table_f32, int generic, int P,
                               int H, int W, int By, int Bx, int Wy, int Wx,
                               int H3, int W3, float bg, float qscale,
                               float qshift, void* stream) {
  if (P < 1 || By < 1 || Bx < 1 || H % By || W % Bx || Wy < 1 || Wx < 1 ||
      Wy > WMAX || Wx > WMAX)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)P * H * W;
  cudaStream_t s = (cudaStream_t)stream;
  if (table_f32 && !out_u8 && !generic && By == 2 && Bx == 2 && Wy == 4 &&
      Wx == 4 && P <= 65535 && n < (1LL << 31) &&
      (long long)H3 * W3 * 64 < (1LL << 31)) {
    const int nb = (H / 2) * (W / 2);
    combine_f32_kernel<2, 2, 4, 4>
        <<<dim3((nb + THREADS - 1) / THREADS, P), THREADS, 0, s>>>(
            (const float*)table, (const int*)Y0, (const int*)X0,
            (const float*)ry, (const float*)rx, (const float*)okm,
            (float4*)out, H / 2, W / 2, H3, W3, bg, qscale, qshift);
  } else if (table_f32) {
    if (out_u8)
      launch<float, true>(table, Y0, X0, ry, rx, okm, out, n, H, W, By, Bx,
                          Wy, Wx, H3, W3, bg, qscale, qshift, s);
    else
      launch<float, false>(table, Y0, X0, ry, rx, okm, out, n, H, W, By, Bx,
                           Wy, Wx, H3, W3, bg, qscale, qshift, s);
  } else {
    if (out_u8)
      launch<int8_t, true>(table, Y0, X0, ry, rx, okm, out, n, H, W, By,
                           Bx, Wy, Wx, H3, W3, bg, qscale, qshift, s);
    else
      launch<int8_t, false>(table, Y0, X0, ry, rx, okm, out, n, H, W, By,
                            Bx, Wy, Wx, H3, W3, bg, qscale, qshift, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
