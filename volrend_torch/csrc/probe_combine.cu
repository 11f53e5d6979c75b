// Probe P7: the planar tent-combine of the superquad warp probe, for
// Hopper (sm_90a).
//
// Replaces tools/perf_sq3.py:combine_pallas (kernel body
// make_combine_kernel, perf_sq3.py:56-80), the Pallas TPU probe that
// tent-combines a planar gathered window table (its plain PyTorch twin is
// volrend_torch/probes/perf_sq3.py:combine_probe_ref).
//
// What it computes, per half-resolution pixel (h, w) of an (Hh, Wh) plane
// and subpixel s = p*2 + q: the unclamped tents wy[cy] = max(0, 1 -
// |ry[s] - cy|) and wx[cx] = max(0, 1 - |rx[s] - cx|), cy, cx in 0..3;
// per colour c the sum over the 16 cells of (wy[cy] * wx[cx]) *
// qgp[chan(cy, cx, c)] with chan = (cy/2)*32 + (cx/2)*16 + (cy%2)*8 +
// (cx%2)*4 + c (perf_sq3.py:50-53); then the composite over the
// background bg where okm[s] > 0.5 (rgb + bg * (1 - alpha), alpha), else
// (bg, bg, bg, 0). In: qgp (64, Hh, Wh) bf16, ry, rx, okm (4, Hh, Wh) f32.
// Out: (16, Hh, Wh) f32 planes [s*4 + c]. The reference leaves rows past
// its last full 8-row block unwritten; this kernel writes every row.
//
// What bounds it on the H100: bytes. At 800^2 (Hh = Wh = 400) it reads
// 20.48 MB of bf16 table planes and 7.68 MB of subpixel geometry and
// writes 10.24 MB: 38.4 MB, 0.0115 ms at 3.35 TB/s; ~700 f32 operations
// per half-pixel (0.11 GFLOP) are far below the operations bound.
//
// Design: one thread per half-pixel, consecutive threads on consecutive
// pixels, so every plane read and write is coalesced. The thread loads its
// 64 table values once into registers (bf16 widened to f32, as the Pallas
// body's .astype(f32)) and computes its four subpixels from them; the
// TPU's 8-row blocks become a grid-stride loop over pixels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_to_f32(uint16_t u) {
  return __uint_as_float((unsigned)u << 16);
}

__host__ __device__ constexpr int chan(int cy, int cx, int c) {
  return (cy / 2) * 32 + (cx / 2) * 16 + (cy % 2) * 8 + (cx % 2) * 4 + c;
}

__global__ void __launch_bounds__(256)
combine_kernel(const uint16_t* __restrict__ qgp,
               const float* __restrict__ ry, const float* __restrict__ rx,
               const float* __restrict__ okm, float* __restrict__ out,
               int npx, float bg) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < npx;
       i += gridDim.x * blockDim.x) {
    float q[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) q[k] = bf16_to_f32(qgp[(size_t)k * npx + i]);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float ryv = ry[(size_t)s * npx + i];
      const float rxv = rx[(size_t)s * npx + i];
      const bool ok = okm[(size_t)s * npx + i] > 0.5f;
      float wy[4], wx[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wy[k] = fmaxf(0.f, 1.f - fabsf(ryv - (float)k));
        wx[k] = fmaxf(0.f, 1.f - fabsf(rxv - (float)k));
      }
      float rgba[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int cy = 0; cy < 4; ++cy)
#pragma unroll
          for (int cx = 0; cx < 4; ++cx)
            acc += (wy[cy] * wx[cx]) * q[chan(cy, cx, c)];
        rgba[c] = acc;
      }
      const float alpha = rgba[3];
      const float rem = bg * (1.f - alpha);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        out[(size_t)(s * 4 + c) * npx + i] = ok ? rgba[c] + rem : bg;
      out[(size_t)(s * 4 + 3) * npx + i] = ok ? alpha : 0.f;
    }
  }
}

}  // namespace

// qgp: (64, Hh, Wh) bf16; ry, rx, okm: (4, Hh, Wh) f32; out: (16, Hh, Wh)
// f32. Returns cudaGetLastError() after the launch.
extern "C" int vt_probe_combine(const void* qgp, const void* ry,
                                const void* rx, const void* okm, void* out,
                                int Hh, int Wh, float bg, void* stream) {
  if (Hh < 1 || Wh < 1 || (long long)Hh * Wh > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const int npx = Hh * Wh;
  const int threads = 256;
  const int want = (npx + threads - 1) / threads;
  const int blocks = want < 65535 * 8 ? want : 65535 * 8;
  combine_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)qgp, (const float*)ry, (const float*)rx,
      (const float*)okm, (float*)out, npx, bg);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
