// The superquad window table's layout, shared by kernels B (build), C
// (tent-combine), 5 (combine adjoint) and 6 (build adjoint).
//
// A table row holds the Wy x Wx window cells at one window position (Y, X)
// of the (H3, W3) = (gi-Wy+1, gi-Wx+1) grid, 4 colours per cell, colour
// minor: channel (cy*Wx + cx)*4 + c (volrend_torch/ops/display_warp.py:
// _chan, the reference's _chan). The kernels move one cell's four colours
// as one 4-wide vector, so they index cells, not channels.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// the cell of window position (cy, cx) inside a table row
__device__ __forceinline__ int table_cell(int cy, int cx, int Wx) {
  return cy * Wx + cx;
}

// one cell's four colours as floats: the int8 display table's codes, or the
// f32 precise table's values
__device__ __forceinline__ float4 load_cell(const int8_t* row, int cell) {
  const char4 e = *(const char4*)(row + cell * 4);
  return make_float4((float)e.x, (float)e.y, (float)e.z, (float)e.w);
}

__device__ __forceinline__ float4 load_cell(const float* row, int cell) {
  return *(const float4*)(row + cell * 4);
}
