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
// - int8 (the display path's table, held on the card): the cells
//   quantized to affine int8, q = round_half_even(clip(v, 0, 1) * 255) -
//   128 (display_warp.py:188-191), bit-equal to the reference table;
// - f32 (the precise training warp, display_warp.py:864): a plain copy.
// The input is channel-planar (P, 4, gi, gi) (the march's emit layout) or
// interleaved (P, gi, gi, 4) (the training path's intermediate image).
// Output (P, H3*W3, 4*Wy*Wx).
//
// What bounds it on the H100: bytes. Per pose it reads the 1 MB
// intermediate (gi = 256) and writes the table: 6.35 MB int8 (Wy = Wx = 5)
// or 16.4 MB f32 (4 x 4): a few microseconds at 3.35 TB/s. The table is
// ~16x the input, so the stores set the time.
//
// Design: a block takes its pose, window row Y and a chunk of window
// columns X0..X0+nx-1 from the grid's indices (32-bit index math; no
// thread divides a 64-bit index). Its output is one contiguous span of
// the row-major table, nx rows of Wy*Wx cells. It stages the Wy input
// rows the span reads (its columns plus the Wx-1 halo) in shared memory
// once: a float4 a pixel for an f32 table, the pixel's four channels
// gathered from the planes and quantized once for an int8 table (one
// packed 4-byte cell, not once per cell that copies it). Then it writes
// the span in order with 16-byte stores: one cell a store in f32 (a
// warp writes 512 consecutive bytes), four consecutive cells a store in
// int8 from the span's first 16-byte boundary on (4-byte stores for the
// at most three cells before it and after the last whole group; at the
// display levels, W3 = 252 and chunks of a multiple of 4 rows, every
// span starts aligned). A thread walks its cells with a (column, cell)
// pair stepped by constants, so the write loop divides nothing; a cell's
// offset in the stage comes from a table of Wy*Wx offsets in shared
// memory. The chunk is sized to ~16 KB of table, so one pose at gi = 256
// is 4 x 253 blocks in f32 (~7.7 a SM, one wave) and 2 x 252 in int8. A
// window whose stage would not fit 48 KB of shared memory even for one
// column reads its cells from global memory instead (same loop and
// stores); no window the wrapper takes is refused. The writes keep the
// default cache policy: kernel C reads the f32 table straight after, from
// the 50 MB L2.

#include "warp_table.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SPAN_BYTES = 16384;     // a block's target share of the table
constexpr int SMEM_MAX = 48 * 1024;   // dynamic shared memory, no opt-in
constexpr int MAX_GRID_Z = 65535;     // poses a launch

__device__ __forceinline__ unsigned quant(float v) {
  return (unsigned)(unsigned char)(signed char)(int)(
      rintf(fminf(fmaxf(v, 0.f), 1.f) * 255.f) - 128.f);
}

// one pixel's four channels as a table cell: the f32 copy, or the four
// int8 codes packed little-endian (a char4's bytes)
__device__ __forceinline__ void to_cell(float4 v, float4* c) { *c = v; }
__device__ __forceinline__ void to_cell(float4 v, unsigned* c) {
  *c = quant(v.x) | (quant(v.y) << 8) | (quant(v.z) << 16)
       | (quant(v.w) << 24);
}

template <bool PLANAR>
__device__ __forceinline__ float4 load_pixel(const float* __restrict__ src,
                                             size_t npx, size_t pix) {
  if (PLANAR)
    return make_float4(src[pix], src[npx + pix], src[2 * npx + pix],
                       src[3 * npx + pix]);
  return ((const float4*)src)[pix];
}

// grid (chunks, H3, poses); dynamic shared memory: the stage (Wy rows of
// S cells) and the Wy*Wx cell offsets, when STAGED
template <typename Cell, bool PLANAR, bool STAGED>
__global__ void __launch_bounds__(THREADS)
build_kernel(const float* __restrict__ inter, Cell* __restrict__ table,
             int gi, int Wy, int Wx, int H3, int W3, int nX, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, Y = blockIdx.y, X0 = blockIdx.x * nX;
  const int nx = min(nX, W3 - X0);   // the span's table rows
  const int ncell = Wy * Wx, n = nx * ncell;
  const size_t npx = (size_t)gi * gi;
  const float* src = inter + (size_t)blockIdx.z * 4 * npx;
  const size_t pix0 = (size_t)Y * gi + X0;
  Cell* stage = (Cell*)smem;
  int* coff = (int*)(stage + Wy * S);
  if constexpr (STAGED) {
    const int SW = nx + Wx - 1;
    for (int i = tid; i < Wy * SW; i += THREADS) {
      const int cy = i / SW, x = i - cy * SW;
      to_cell(load_pixel<PLANAR>(src, npx, pix0 + (size_t)cy * gi + x),
              &stage[cy * S + x]);
    }
    for (int c = tid; c < ncell; c += THREADS) {
      const int cy = c / Wx;
      coff[c] = cy * S + c - cy * Wx;
    }
    __syncthreads();
  }
  // cell c of span column x
  auto fetch = [&](int x, int c) -> Cell {
    if constexpr (STAGED) return stage[coff[c] + x];
    const int cy = c / Wx;
    Cell v;
    to_cell(load_pixel<PLANAR>(src, npx, pix0 + (size_t)cy * gi + x + c
                                             - cy * Wx), &v);
    return v;
  };
  Cell* out = table + (((size_t)blockIdx.z * H3 + Y) * W3 + X0) * ncell;
  // a thread's cells advance by `step` a pass: (column, cell) steps by
  // (step / ncell, step % ncell), carrying the cell into the column
  auto walk = [&](int j, int step, int& x, int& c, int& dx, int& dc) {
    x = j / ncell;
    c = j - x * ncell;
    dx = step / ncell;
    dc = step - dx * ncell;
  };
  int x, c, dx, dc;
  if constexpr (sizeof(Cell) == 16) {
    // f32: one cell a 16-byte store
    walk(tid, THREADS, x, c, dx, dc);
    for (int j = tid; j < n; j += THREADS) {
      out[j] = fetch(x, c);
      x += dx;
      c += dc;
      if (c >= ncell) { c -= ncell; ++x; }
    }
  } else {
    // int8: four cells a 16-byte store from the span's first 16-byte
    // boundary; single cells before it and after the last whole group
    const int head = min(n, (int)((16 - ((uintptr_t)out & 15)) & 15) >> 2);
    const int groups = (n - head) >> 2, tail0 = head + 4 * groups;
    if (tid < head) {
      walk(tid, 0, x, c, dx, dc);
      out[tid] = fetch(x, c);
    }
    if (tail0 + tid < n) {
      walk(tail0 + tid, 0, x, c, dx, dc);
      out[tail0 + tid] = fetch(x, c);
    }
    uint4* out4 = (uint4*)(out + head);
    walk(head + 4 * tid, 4 * THREADS, x, c, dx, dc);
    for (int g = tid; g < groups; g += THREADS) {
      unsigned w[4];
      int xk = x, ck = c;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w[k] = fetch(xk, ck);
        if (++ck == ncell) { ck = 0; ++xk; }
      }
      out4[g] = make_uint4(w[0], w[1], w[2], w[3]);
      x += dx;
      c += dc;
      if (c >= ncell) { c -= ncell; ++x; }
    }
  }
}

// The launch plan: the chunk of window columns a block takes, the stage's
// row stride in cells, the dynamic shared memory and whether it stages.
struct Plan {
  int nX, chunks, S, smem;
  bool staged;
};

Plan plan(int Wy, int Wx, int W3, bool f32) {
  const int cellb = f32 ? 16 : 4, ncell = Wy * Wx;
  // chunks of ~SPAN_BYTES of table, evened out, a multiple of 4 columns
  const int want = max(1, SPAN_BYTES / (ncell * cellb));
  int chunks = (W3 + want - 1) / want;
  int nX = ((W3 + chunks - 1) / chunks + 3) & ~3;
  // the stage's row stride: f32 rows padded to 4 mod 8 cells, so a
  // quarter warp's float4 reads of 2 x 4 neighbouring cells of two
  // window rows fall in distinct banks
  auto stride = [&](int n) {
    const int sw = n + Wx - 1;
    return f32 ? sw + (12 - sw % 8) % 8 : sw;
  };
  auto bytes = [&](int n) { return Wy * stride(n) * cellb + ncell * 4; };
  while (nX > 1 && bytes(nX) > SMEM_MAX) nX = nX > 4 ? nX - 4 : nX - 1;
  chunks = (W3 + nX - 1) / nX;
  const bool staged = bytes(nX) <= SMEM_MAX;
  return {nX, chunks, stride(nX), staged ? bytes(nX) : 0, staged};
}

template <typename Cell, bool PLANAR, bool STAGED>
void run(const float* inter, Cell* table, int P, int gi, int Wy, int Wx,
         const Plan& pl, cudaStream_t s) {
  const int H3 = gi - Wy + 1, W3 = gi - Wx + 1;
  const size_t in_pose = (size_t)4 * gi * gi;
  const size_t out_pose = (size_t)H3 * W3 * Wy * Wx;
  for (int p0 = 0; p0 < P; p0 += MAX_GRID_Z) {
    const dim3 grid(pl.chunks, H3, min(P - p0, MAX_GRID_Z));
    build_kernel<Cell, PLANAR, STAGED><<<grid, THREADS, pl.smem, s>>>(
        inter + p0 * in_pose, table + p0 * out_pose, gi, Wy, Wx, H3, W3,
        pl.nX, pl.S);
  }
}

template <typename Cell, bool PLANAR>
void launch(const void* inter, void* table, int P, int gi, int Wy, int Wx,
            const Plan& pl, cudaStream_t s) {
  if (pl.staged)
    run<Cell, PLANAR, true>((const float*)inter, (Cell*)table, P, gi, Wy, Wx,
                            pl, s);
  else
    run<Cell, PLANAR, false>((const float*)inter, (Cell*)table, P, gi, Wy,
                             Wx, pl, s);
}

using KernFn = void (*)(const float*, void*, int, int, int, int, int, int,
                        int);

template <typename Cell, bool PLANAR, bool STAGED>
KernFn fn_of() {
  return (KernFn)build_kernel<Cell, PLANAR, STAGED>;
}

KernFn pick(bool f32, bool planar, bool staged) {
  const KernFn f[2][2][2] = {
      {{fn_of<unsigned, false, false>(), fn_of<unsigned, false, true>()},
       {fn_of<unsigned, true, false>(), fn_of<unsigned, true, true>()}},
      {{fn_of<float4, false, false>(), fn_of<float4, false, true>()},
       {fn_of<float4, true, false>(), fn_of<float4, true, true>()}}};
  return f[f32][planar][staged];
}

bool args_ok(int P, int gi, int Wy, int Wx) {
  return P >= 1 && Wy >= 1 && Wx >= 1 && gi >= Wy && gi >= Wx
         && gi - Wy + 1 <= 65535;
}

}  // namespace

// inter: (P, 4, gi, gi) f32 (planar) or (P, gi, gi, 4) f32; table:
// (P, H3*W3, 4*Wy*Wx) int8, or f32 with table_f32 (16-byte aligned, as
// torch allocates it). Returns cudaGetLastError() after the launch.
extern "C" int vt_warp_build(const void* inter, void* table, int P, int gi,
                             int Wy, int Wx, int table_f32, int planar,
                             void* stream) {
  if (!args_ok(P, gi, Wy, Wx)) return (int)cudaErrorInvalidValue;
  const Plan pl = plan(Wy, Wx, gi - Wx + 1, table_f32 != 0);
  cudaStream_t s = (cudaStream_t)stream;
  if (table_f32) {
    if (planar)
      launch<float4, true>(inter, table, P, gi, Wy, Wx, pl, s);
    else
      launch<float4, false>(inter, table, P, gi, Wy, Wx, pl, s);
  } else {
    if (planar)
      launch<unsigned, true>(inter, table, P, gi, Wy, Wx, pl, s);
    else
      launch<unsigned, false>(inter, table, P, gi, Wy, Wx, pl, s);
  }
  return (int)cudaGetLastError();
}

// The launch vt_warp_build makes for these arguments: out (int[8]) =
// resident blocks per SM, registers a thread, spill (local) bytes a
// thread, dynamic shared memory a block, blocks a pose, window columns a
// block, staged (0/1), threads a block.
extern "C" int vt_warp_build_info(int P, int gi, int Wy, int Wx,
                                  int table_f32, int planar, int* out) {
  if (!args_ok(P, gi, Wy, Wx)) return (int)cudaErrorInvalidValue;
  const Plan pl = plan(Wy, Wx, gi - Wx + 1, table_f32 != 0);
  const KernFn fn = pick(table_f32 != 0, planar != 0, pl.staged);
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], fn, THREADS, pl.smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes at;
  e = cudaFuncGetAttributes(&at, fn);
  if (e != cudaSuccess) return (int)e;
  out[1] = at.numRegs;
  out[2] = (int)at.localSizeBytes;
  out[3] = pl.smem;
  out[4] = pl.chunks * (gi - Wy + 1);
  out[5] = pl.nX;
  out[6] = pl.staged;
  out[7] = THREADS;
  return 0;
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
