// Probe P8: the payload stream floor, for Hopper (sm_90a).
//
// Replaces tools/perf_overlap.py:dma_once (its kernel dma_kernel and grid
// spec, perf_overlap.py:87-108), the Pallas TPU probe whose block DMA
// moves each (4, Dp, G, G) window of the march's int8 payload into VMEM
// and adds one (8, 128) corner of it to its output (its plain PyTorch
// twin is volrend_torch/probes/perf_overlap.py:stream_probe_ref).
//
// What it computes, for each window id w = ids[i]: win_sums[i] = the sum
// of every int8 byte of slabs 4w .. 4w+3, and out (8, 128) f32 += plane 0
// of slab 4w at rows :8, columns :128 (the reference probe's output). An
// id outside [0, n_win) streams nothing.
//
// What bounds it on the H100: bytes. The dense bench payload at full width
// is 256 x 50 x 256 x 256 B = 838,860,800 B (64 windows of 13,107,200 B):
// 0.250 ms at 3.35 TB/s. The probe's purpose is to measure how close a
// plain stream gets to that figure, the floor kernel M's payload read
// is held against.
//
// Design: the TPU's DMA moves the whole window whatever the body reads; a
// CUDA kernel reads only what it uses, so this one reads every byte, with
// 16-byte streaming loads (__ldcs: evict-first, the data is used once),
// four in flight per thread, and folds them into an integer sum
// (__dp4a against 0x01010101 adds four signed bytes), the consumer that
// keeps the loads from being dropped. Blocks (blockIdx.x) split a window,
// one window per blockIdx.y; each block reduces through warp shuffles and
// shared memory and adds its partial sum with one 64-bit atomic. Integer
// adds are associative, so the sums are bit-equal to the plain version in
// any order; so is out, whose f32 atomics add integer values far below
// 2^24.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__device__ __forceinline__ int sum16(int4 v) {
  int s = __dp4a(v.x, 0x01010101, 0);
  s = __dp4a(v.y, 0x01010101, s);
  s = __dp4a(v.z, 0x01010101, s);
  return __dp4a(v.w, 0x01010101, s);
}

__global__ void __launch_bounds__(THREADS)
stream_kernel(const int8_t* __restrict__ pay, const int* __restrict__ ids,
              int n_win, long long win_bytes, int Gx,
              float* __restrict__ out, long long* __restrict__ sums) {
  const int i = blockIdx.y;
  const int w = ids[i];
  if (w < 0 || w >= n_win) return;
  const int8_t* base = pay + (size_t)w * (size_t)win_bytes;
  const int4* v = reinterpret_cast<const int4*>(base);
  const long long nvec = win_bytes / 16;
  const long long stride = (long long)gridDim.x * THREADS;
  long long acc = 0;
  long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (; j + (UNROLL - 1) * stride < nvec; j += UNROLL * stride) {
    int4 a[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) a[u] = __ldcs(v + j + u * stride);
    int s = 0;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) s += sum16(a[u]);
    acc += s;
  }
  for (; j < nvec; j += stride) acc += sum16(__ldcs(v + j));

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ long long s_part[THREADS / 32];
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t = 0;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) t += s_part[k];
    atomicAdd(reinterpret_cast<unsigned long long*>(sums + i),
              (unsigned long long)t);
  }

  // the reference probe's output: plane 0 of slab 4w, rows :8, cols :128
  if (blockIdx.x == 0) {
    const int r = threadIdx.x >> 5, c0 = (threadIdx.x & 31) * 4;
    const int8_t* row = base + (size_t)r * Gx + c0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      atomicAdd(out + r * 128 + c0 + k, (float)row[k]);
  }
}

}  // namespace

// pay: (G, Dp, Gy, Gx) int8, contiguous, 16-byte aligned; ids: (n,) int32;
// n_win = G / 4; planes = 4 * Dp (the planes of one window); out: (8, 128)
// f32 and win_sums: (n,) int64, both zeroed by the caller. Returns
// cudaGetLastError() after the launch.
extern "C" int vt_probe_stream(const void* pay, const void* ids, int n,
                               int n_win, int planes, int Gy, int Gx,
                               void* out, void* win_sums, void* stream) {
  const long long win_bytes = (long long)planes * Gy * Gx;
  if (n < 1 || n > 65535 || n_win < 1 || Gy < 8 || Gx < 128 ||
      win_bytes % 16 || ((uintptr_t)pay & 15))
    return (int)cudaErrorInvalidValue;
  // about two waves of blocks over the card's 132 SMs, split over the
  // windows, each thread streaming at least UNROLL vectors
  const long long nvec = win_bytes / 16;
  const long long most = (nvec + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  long long per_win = (2 * 132 * 8 + n - 1) / n;
  if (per_win > most) per_win = most;
  if (per_win < 1) per_win = 1;
  const dim3 grid((unsigned)per_win, (unsigned)n);
  stream_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)pay, (const int*)ids, n_win, win_bytes, Gx,
      (float*)out, (long long*)win_sums);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
