// Probe P9: the 64-channel window-table build of the table-build probe,
// for Hopper (sm_90a), in both of its layouts.
//
// Replaces tools/perf_sq4.py:build_pallas (interleaved output, :47) and
// tools/perf_sq4.py:build_pallas_planar (planar output, :75), the Pallas
// TPU probes that build the superquad warp's 4x4-window table from a
// planar bf16 intermediate image (their plain PyTorch twin is
// volrend_torch/probes/perf_sq4.py:build_probe_ref).
//
// What it computes, from it (4, gi, gi) bf16, with n = gi - 3 and
// Hp = ceil(n / 16) * 16 (the reference's 16-row blocks): for every window
// (Y, X) < (n, n) and cell (cy, cx) in 4 x 4, colour c, the value
// it[c, Y + cy, X + cx], copied bit for bit.
// - interleaved (PLANAR = false): out (Hp, n, 64), channel
//   (cy*4 + cx)*4 + c (the reference's stack order, perf_sq4.py:56-62);
// - planar (PLANAR = true): out (64, Hp, n), channel chan(cy, cx, c) =
//   (cy/2)*32 + (cx/2)*16 + (cy%2)*8 + (cx%2)*4 + c (perf_sq4.py:100-103).
// The two orders differ. Rows Y >= n are padding: the reference's last
// block reads past its input there (its values are undefined); this
// kernel writes zeros.
//
// What bounds it on the H100: bytes. At gi = 448 it reads the 1.6 MB input
// and writes 25.5 MB of table: 27.1 MB, 0.0081 ms at 3.35 TB/s. It does no
// arithmetic. The table is 16x the input, so the stores set the time.
//
// Design, interleaved: one thread per (window, cell) gathers the cell's
// four colour planes and stores its 8 bytes, consecutive threads on
// consecutive cells, so a warp writes 256 consecutive bytes; blocks take
// their output row from the grid's indices. The input (1.6 MB) is re-read
// 16 times, from L2.
//
// Design, planar: each channel's (Hp, n) plane is one contiguous run of
// bf16 whose base is a multiple of 32 bytes (Hp is a multiple of 16). A
// block takes an R = 8 row tile Y0..Y0+7, one window row offset cy and
// one colour c from the grid's indices ((Hp / 8) x 4 x 4 blocks: 896 at
// gi = 448, 5 resident a SM at 44 registers, so 1.36 waves), and writes
// the tile of the four channels chan(cy, cx, c), cx = 0..3: for each,
// one flat span of 8n values starting 16-byte aligned, whatever n's
// parity. It stages the tile's input rows Y0+cy..Y0+cy+7 of plane c once
// (4-byte loads of two values where rows have even length), writing each
// value into four shifted copies T_cx[r*n + x] = it[c, Y0+cy+r, x+cx] in
// shared memory (x < n; the padding rows zero), so that channel
// chan(cy, cx, c)'s span is T_cx itself: the write phase is a copy of
// 16-byte units, 8 consecutive flat values each (X wraps to the next row
// inside a unit, read from shared memory, not from global memory),
// coalesced, conflict-free. A tile whose four copies would not fit 48 KB
// of shared memory (n > 768) writes the same 16-byte units from its
// input rows in global memory instead, walking (row, column) per value;
// no gi the wrapper takes is refused. The TPU's VMEM-resident input and
// dynamic halo slices become the stage.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int R = 8;                  // planar: window rows a block
constexpr int SMEM_MAX = 48 * 1024;   // dynamic shared memory, no opt-in

// Interleaved: grid (ceil(16n / THREADS), Hp), blockIdx.y the window row
// Y, the threads along the row's (X, cell) pairs.
__global__ void __launch_bounds__(THREADS)
interleaved_kernel(const uint16_t* __restrict__ it, uint2* __restrict__ out,
                   int gi) {
  const int n = gi - 3;
  const size_t plane = (size_t)gi * gi;
  const int Y = blockIdx.y;
  const int j = blockIdx.x * THREADS + threadIdx.x;
  // one thread per (window X, cell): its four colours, 8 bytes
  if (j >= n * 16) return;
  const int X = j >> 4, cell = j & 15;
  uint2 v = make_uint2(0u, 0u);
  if (Y < n) {
    const size_t pix = (size_t)(Y + (cell >> 2)) * gi + X + (cell & 3);
    v.x = (unsigned)it[pix] | ((unsigned)it[plane + pix] << 16);
    v.y = (unsigned)it[2 * plane + pix]
          | ((unsigned)it[3 * plane + pix] << 16);
  }
  out[(size_t)Y * n * 16 + j] = v;
}

// the planar channel of window cell (cy, cx), colour c (perf_sq3.chan)
__device__ __forceinline__ int chan(int cy, int cx, int c) {
  return (cy >> 1) * 32 + (cx >> 1) * 16 + (cy & 1) * 8 + (cx & 1) * 4 + c;
}

// Planar: grid (Hp / R, 4, 4) = (row tile, cy, colour). STAGED: dynamic
// shared memory 4 * R * n bf16, the shifted copies T_cx.
template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
planar_kernel(const uint16_t* __restrict__ it, uint16_t* __restrict__ out,
              int gi, int Hp) {
  extern __shared__ __align__(16) uint16_t T[];
  const int tid = threadIdx.x, n = gi - 3, L = R * n;
  const int Y0 = blockIdx.x * R, cy = blockIdx.y, c = blockIdx.z;
  // the tile's window rows inside the table; the rest are padding (zero)
  const int rows = max(0, min(R, n - Y0)), fz = rows * n;
  // input rows Y0+cy.. of plane c, contiguous in memory
  const uint16_t* src = it + ((size_t)c * gi + Y0 + cy) * gi;
  if constexpr (STAGED) {
    auto put = [&](int r, int x, uint16_t v) {
#pragma unroll
      for (int cx = 0; cx < 4; ++cx) {
        const int xx = x - cx;
        if (xx >= 0 && xx < n) T[cx * L + r * n + xx] = v;
      }
    };
    if ((gi & 1) == 0 && ((uintptr_t)src & 3) == 0) {
      // even rows: 2 values a 4-byte load, consecutive lanes on
      // consecutive words, so the four copies' 2-byte stores fall in
      // distinct banks; U loads in flight a thread
      constexpr int U = 4;
      const int g2 = gi >> 1, m = rows * g2;
      for (int i0 = tid; i0 < m; i0 += U * THREADS) {
        unsigned w[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int i = i0 + k * THREADS;
          w[k] = i < m ? ((const unsigned*)src)[i] : 0u;
        }
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int i = i0 + k * THREADS;
          if (i >= m) break;
          const int r = i / g2, x = (i - r * g2) << 1;
          put(r, x, (uint16_t)w[k]);
          put(r, x + 1, (uint16_t)(w[k] >> 16));
        }
      }
    } else {
      for (int i = tid; i < rows * gi; i += THREADS) {
        const int r = i / gi;
        put(r, i - r * gi, src[i]);
      }
    }
    for (int i = fz + tid; i < L; i += THREADS)
#pragma unroll
      for (int cx = 0; cx < 4; ++cx) T[cx * L + i] = 0;
    __syncthreads();
  }
  // channel chan(cy, cx, c)'s tile: L values, L / 8 16-byte units
  const int step = 8 * THREADS, dr = step / n, dx = step - dr * n;
  for (int cx = 0; cx < 4; ++cx) {
    uint4* dst = (uint4*)(out + ((size_t)chan(cy, cx, c) * Hp + Y0) * n);
    if constexpr (STAGED) {
      const uint4* t = (const uint4*)(T + cx * L);
      for (int u = tid; u < L / 8; u += THREADS) dst[u] = t[u];
    } else {
      int r = (8 * tid) / n, x = 8 * tid - r * n;
      for (int u = tid; u < L / 8; u += THREADS) {
        unsigned w[4] = {0u, 0u, 0u, 0u};
        int rk = r, xk = x;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (8 * u + k < fz)
            w[k >> 1] |= (unsigned)src[(size_t)rk * gi + xk + cx]
                         << (16 * (k & 1));
          if (++xk == n) { xk = 0; ++rk; }
        }
        dst[u] = make_uint4(w[0], w[1], w[2], w[3]);
        r += dr;
        x += dx;
        if (x >= n) { x -= n; ++r; }
      }
    }
  }
}

bool staged(int gi) { return 4 * R * (gi - 3) * 2 <= SMEM_MAX; }

}  // namespace

// it: (4, gi, gi) bf16; out: (Hp, gi-3, 64) bf16, or (64, Hp, gi-3) bf16
// with planar; Hp >= gi - 3, a multiple of 16 with planar (the wrapper's
// 16-row blocks). Returns cudaGetLastError() after the launch.
extern "C" int vt_probe_build(const void* it, void* out, int gi, int Hp,
                              int planar, void* stream) {
  if (gi < 4 || Hp < gi - 3 || Hp > 65535 || (planar && Hp % 16))
    return (int)cudaErrorInvalidValue;
  const int n = gi - 3;
  cudaStream_t s = (cudaStream_t)stream;
  const uint16_t* in = (const uint16_t*)it;
  if (!planar)
    interleaved_kernel<<<dim3((n * 16 + THREADS - 1) / THREADS, Hp),
                         THREADS, 0, s>>>(in, (uint2*)out, gi);
  else if (staged(gi))
    planar_kernel<true><<<dim3(Hp / R, 4, 4), THREADS, 4 * R * n * 2, s>>>(
        in, (uint16_t*)out, gi, Hp);
  else
    planar_kernel<false><<<dim3(Hp / R, 4, 4), THREADS, 0, s>>>(
        in, (uint16_t*)out, gi, Hp);
  return (int)cudaGetLastError();
}

// The planar launch vt_probe_build makes at gi: out (int[6]) = resident
// blocks per SM, registers a thread, spill (local) bytes a thread, dynamic
// shared memory a block, staged (0/1), threads a block.
extern "C" int vt_probe_build_info(int gi, int* out) {
  if (gi < 4) return (int)cudaErrorInvalidValue;
  const bool st = staged(gi);
  const void* fn = st ? (const void*)planar_kernel<true>
                      : (const void*)planar_kernel<false>;
  const int smem = st ? 4 * R * (gi - 3) * 2 : 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], fn, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes at;
  e = cudaFuncGetAttributes(&at, fn);
  if (e != cudaSuccess) return (int)e;
  out[1] = at.numRegs;
  out[2] = (int)at.localSizeBytes;
  out[3] = smem;
  out[4] = st;
  out[5] = THREADS;
  return 0;
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
