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
// arithmetic.
//
// Design: the output is written once, in order, with coalesced stores:
// interleaved, one thread per (window, cell) gathers the cell's four
// colour planes and stores its 8 bytes; planar, one thread per output
// value, consecutive threads on consecutive X, so the reads of each input
// row are coalesced as well. Blocks take their output row (interleaved)
// or channel and rows (planar) from the grid's indices, so no thread
// divides an index, and a planar block writes several rows (the first
// version, one thread per value of a flat grid-stride loop with 64-bit
// index divisions, ran at 10x its bound). The input (1.6 MB) is re-read
// 16 times, from L2. The TPU's VMEM-resident input and dynamic halo
// slices become direct indexed loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;  // planar: output rows per block

// Interleaved: grid (ceil(16n / THREADS), Hp), blockIdx.y the window row
// Y, the threads along the row's (X, cell) pairs. Planar: grid
// (ceil(Hp / ROWS), 64), blockIdx.y the channel, each block ROWS rows of
// it, the threads along X. No thread divides an index.
template <bool PLANAR>
__global__ void __launch_bounds__(THREADS)
build_kernel(const uint16_t* __restrict__ it, void* __restrict__ out,
             int gi, int Hp) {
  const int n = gi - 3;
  const size_t plane = (size_t)gi * gi;
  if (PLANAR) {
    const int k = blockIdx.y;
    const int c = k & 3;
    const int cx = ((k >> 4) & 1) * 2 + ((k >> 2) & 1);
    const int cy = ((k >> 5) & 1) * 2 + ((k >> 3) & 1);
    const uint16_t* src = it + c * plane + (size_t)cy * gi + cx;
    uint16_t* dst = (uint16_t*)out + (size_t)k * Hp * n;
    const int y1 = min(Hp, (int)(blockIdx.x + 1) * ROWS);
    for (int Y = blockIdx.x * ROWS; Y < y1; ++Y)
      for (int X = threadIdx.x; X < n; X += THREADS)
        dst[(size_t)Y * n + X] = Y < n ? src[(size_t)Y * gi + X] : 0;
  } else {
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
    ((uint2*)out)[(size_t)Y * n * 16 + j] = v;
  }
}

}  // namespace

// it: (4, gi, gi) bf16; out: (Hp, gi-3, 64) bf16, or (64, Hp, gi-3) bf16
// with planar; Hp >= gi - 3. Returns cudaGetLastError() after the launch.
extern "C" int vt_probe_build(const void* it, void* out, int gi, int Hp,
                              int planar, void* stream) {
  if (gi < 4 || Hp < gi - 3 || Hp > 65535) return (int)cudaErrorInvalidValue;
  const int n = gi - 3;
  cudaStream_t s = (cudaStream_t)stream;
  if (planar)
    build_kernel<true><<<dim3((Hp + ROWS - 1) / ROWS, 64), THREADS, 0, s>>>(
        (const uint16_t*)it, out, gi, Hp);
  else
    build_kernel<false><<<dim3((n * 16 + THREADS - 1) / THREADS, Hp),
                          THREADS, 0, s>>>((const uint16_t*)it, out, gi, Hp);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
