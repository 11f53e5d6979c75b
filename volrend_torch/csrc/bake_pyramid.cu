// The pyramid bake: the training step's dense (G, G, G, D) grid gathered
// from the trainable pyramid's levels, with each voxel's live bit, for
// Hopper (sm_90a).
//
// Replaces the forward of volrend_tpu/ops/slab_grad.py:bake_from_pyramid,
// which has no Pallas kernel: XLA fuses its upsamples and wheres. Its plain
// PyTorch twins are volrend_torch/ops/slab_grad.py:bake_from_pyramid_ref
// (the coarse-to-fine expand / where chain) and live_bits_ref.
//
// What it computes: bake[v] = p_j[v / (G / B_j)], j the one level whose
// mask covers voxel v (build_bake_map checks that one does), so bit for bit
// the chain's result: both copy. In the same pass, a bit a
// voxel: its sigma (channel D - 1) rounded to bf16 (__float2bfloat16_rn, as
// the training march stages it) above the threshold; int32 words
// (G, G, ceil(G / 32)) in the bake's (z, y, x) order, bit i of word w the
// voxel x = 32 w + i, padding bits 0. The coarse occupancy of any pose
// group's view is then a reduction over these bits
// (slab_march.cu:vt_march_occupancy_live) instead of a sector read a voxel.
//
// What bounds it on the H100: bytes. The bake's write (G^3 D 4 bytes: 1.88
// GB at the training bench's G = 256 SH9, 0.56 ms at 3.35 TB/s), each
// level's masked records read once, the masks but the finest (the sum of
// B_j^3 bytes) and the bits (G^3 / 8 bytes). The chain writes and reads
// each level's upsample and the where's output: ~5.6 GB at the finest
// level alone.
//
// Design:
// - One warp a word of bits, i.e. 32 x-neighbours of one (z, y) row. Each
//   lane finds its voxel's level by walking the levels' masks coarse to
//   fine (the bake map's own bool masks: a stored (G, G, G) level map
//   would add G^3 bytes at the training step's peak; the coarse masks stay
//   in L1/L2, and the finest, as large as such a map, is never read: a
//   voxel no coarser level covers is the finest's; the port hands it only
//   the levels with leaves, slab_grad.walked_levels). A voxel's block at level j is its
//   coordinates divided by G / B_j, taken as a multiply by a magic number
//   (exact for coordinates and factors below 2^16): the walk's steps wait
//   on their loads, not on integer divisions (probing 2, 4 and 8 levels
//   at once, and a warp taking 2, 4 and 8 words, were measured slower at
//   D = 4: PERF.md §6).
// - The warp's 32 records are one contiguous run of the bake: lane l moves
//   elements l, l + 32, ... of the run, 16-byte units where a record is a
//   multiple of 16 bytes (D = 4, 28, 76) and 4-byte words otherwise,
//   taking each element's source address from the lane that owns its
//   voxel (__shfl_sync). A whole word's loads are all issued before its
//   stores (D / 4 or D registers a lane), so a warp keeps its run's reads
//   in flight. Stores are coalesced, and so are the finest level's loads;
//   a coarse level's record is re-read by its neighbours from L1/L2.
// - A whole word's live bits take each voxel's sigma from the run the warp
//   loads anyway: at D = 4 the lane's own record's last float (.w), at
//   other widths a shuffle from the lane that holds element D - 1 of the
//   voxel's record; no load waits on the walk for it. Each lane votes
//   (__ballot_sync); lane 0 stores the word, no atomics.
// - The SH widths (D = 4, 13, 28, 49, 76: one instantiation each) keep
//   their record width at compile time. Every other width the trainer's
//   formats take (SG and ASG of nb lobes, D = 3 nb + 1 up to 76) goes
//   through one instantiation with D at run time (bake_kernel<0>), whose
//   lanes load the live bit's sigma first and then move the run's 4-byte
//   words one at a time (a load, then its store), as a row's last, partial
//   word does at any width.
// - The levels' and masks' pointers, sides and magic numbers are kernel
//   parameters (indexed per lane from the constant bank).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_LEVELS = 24;
constexpr int WARPS = 8;  // warps a block

struct Levels {
  const float* p[MAX_LEVELS];     // level j: (B_j, B_j, B_j, D) f32
  const uint8_t* m[MAX_LEVELS];   // its mask: (B_j, B_j, B_j) bool
  // floor(2^32 / f) + 1 for f = G / B_j: c / f = (c * mag) >> 32
  unsigned long long mag[MAX_LEVELS];
  int side[MAX_LEVELS];           // B_j
  int L;
};

// c / f for a coordinate c < 2^16 and f <= 2^16 (exact: the magic's excess
// adds less than 2^-16 <= 1 / f to c / f)
__device__ __forceinline__ int div_by(int c, unsigned long long mag) {
  return (int)(((unsigned long long)(unsigned)c * mag) >> 32);
}

// the flat block index of voxel (z, y, x) at level j
__device__ __forceinline__ long long block_of(const Levels& lv, int j, int z,
                                              int y, int x) {
  const unsigned long long mg = lv.mag[j];
  const long long B = lv.side[j];
  return ((long long)div_by(z, mg) * B + div_by(y, mg)) * B + div_by(x, mg);
}

// a record element's last float: sigma, where the element ends a record
__device__ __forceinline__ float last_of(float4 v) { return v.w; }
__device__ __forceinline__ float last_of(float v) { return v; }

__device__ __forceinline__ bool live_of(float sigma, float thresh) {
  return __bfloat162float(__float2bfloat16_rn(sigma)) > thresh;
}

template <int DC>
__global__ void __launch_bounds__(32 * WARPS)
bake_kernel(Levels lv, int G, int NW, float thresh, float* __restrict__ out,
            unsigned* __restrict__ live, int d_rt) {
  // the record width: the instantiation's, or the run-time one (DC = 0)
  const int D = DC ? DC : d_rt;
  const int lane = threadIdx.x & 31;
  const long long word = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long row = word / NW;  // z * G + y
  if (row >= (long long)G * G) return;  // uniform across the warp
  const int x0 = 32 * (int)(word - row * NW);
  const int z = (int)(row / G), y = (int)(row - (long long)z * G);
  const int n = min(32, G - x0);  // the run's voxels
  // a lane past the row's end walks its last voxel, unused
  const int x = min(x0 + lane, G - 1);
  // the finest, where no coarser level covers the voxel: every voxel has
  // one level, so the finest mask decides nothing and is not read
  int j = lv.L - 1;
#ifdef VT_BK_LEVEL_KNOWN
  // a probe build (probes/bake.py): the voxel's level read from a stored
  // (G, G, G) level map handed as the finest mask, one load for the walk
  j = __ldg(lv.m[lv.L - 1] + ((long long)z * G + y) * G + x);
#else
  for (int i = 0; i < lv.L - 1; ++i) {  // the one level whose mask covers it
    if (__ldg(lv.m[i] + block_of(lv, i, z, y, x))) {
      j = i;
      break;
    }
  }
#endif
  const float* src = lv.p[j] + block_of(lv, j, z, y, x) * D;
  const unsigned long long sp = reinterpret_cast<unsigned long long>(src);
  // the run's elements: 16-byte units where a record is a multiple of 16
  // bytes, else 4-byte words; E a record
  using T = typename std::conditional<DC && DC % 4 == 0, float4, float>::type;
  const int E = DC && DC % 4 == 0 ? D / 4 : D;
  T* dst = reinterpret_cast<T*>(out + (row * G + x0) * D);
  if constexpr (DC != 0) {
    if (n == 32) {  // a whole word: all its loads in flight, then stores
      constexpr int EC = DC % 4 == 0 ? DC / 4 : DC;
      T v[EC];
#pragma unroll
      for (int i = 0; i < EC; ++i) {
        const int q = 32 * i + lane, u = q / EC;
        const T* s =
            reinterpret_cast<const T*>(__shfl_sync(0xffffffffu, sp, u));
        v[i] = __ldg(s + (q - u * EC));
      }
      if (live) {
        // the lane's voxel's sigma from the loaded run: element EC - 1 of
        // its record, held by lane qs % 32 as its element qs / 32 (its own
        // at D = 4)
        float sig = last_of(v[0]);
        if constexpr (EC > 1) {
          const int qs = lane * EC + EC - 1;
#pragma unroll
          for (int i = 0; i < EC; ++i) {
            const float s = __shfl_sync(0xffffffffu, last_of(v[i]), qs & 31);
            if (i == qs >> 5) sig = s;
          }
        }
        const unsigned b = __ballot_sync(0xffffffffu, live_of(sig, thresh));
        if (lane == 0) live[word] = b;
      }
#pragma unroll
      for (int i = 0; i < EC; ++i) dst[32 * i + lane] = v[i];
      return;
    }
  }
  // a run of any width, or the row's last, partial word: the live bit from
  // a load of its own, then the run's elements one at a time
  if (live) {
    const bool on = lane < n && live_of(__ldg(src + D - 1), thresh);
    const unsigned b = __ballot_sync(0xffffffffu, on);
    if (lane == 0) live[word] = b;
  }
  const int elems = n * E;
  for (int base = 0; base < elems; base += 32) {  // uniform trip count
    const int q = base + lane;
    const int u = min(q / E, n - 1);
    const T* s = reinterpret_cast<const T*>(__shfl_sync(0xffffffffu, sp, u));
    if (q < elems) dst[q] = __ldg(s + (q - u * E));
  }
}

template <int DC>
int launch(const Levels& lv, int G, int D, float thresh, float* out,
           unsigned* live, cudaStream_t stream) {
  const int NW = (G + 31) / 32;
  const long long words = (long long)G * G * NW;
  bake_kernel<DC><<<(unsigned)((words + WARPS - 1) / WARPS), 32 * WARPS, 0,
                    stream>>>(lv, G, NW, thresh, out, live, D);
  return (int)cudaGetLastError();
}

}  // namespace

// The bake of L pyramid levels into out (G, G, G, D) f32, contiguous.
// levels: a host array of L device pointers, level j a contiguous
// (B_j, B_j, B_j, D) f32 tensor, 16-byte aligned; masks: a host array of L
// device pointers, level j's (B_j, B_j, B_j) bool mask, every voxel covered
// by exactly one level; sides: a host array of the L sides B_j (each
// dividing G; G below 2^16); live: (G, G, ceil(G / 32)) int32 words of the
// voxels' live bits at ``thresh``, or null for none. D is 3 nb + 1 for nb =
// 1 to 25 (SH of 1 to 25 basis functions, SG and ASG of nb lobes; 4 is also
// RGBA). Returns cudaGetLastError() after the launch.
extern "C" int vt_bake_pyramid(const void* levels, const void* masks,
                               const void* sides, int L, int G, int D,
                               float thresh, void* out, void* live,
                               void* stream) {
  if (L < 1 || L > MAX_LEVELS || G < 1 || G >= 65536 || D < 4 || D > 76 ||
      D % 3 != 1 || (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  Levels lv{};
  const void* const* ptrs = static_cast<const void* const*>(levels);
  const void* const* mks = static_cast<const void* const*>(masks);
  const int* sd = static_cast<const int*>(sides);
  for (int j = 0; j < L; ++j) {
    if (sd[j] < 1 || G % sd[j] || (reinterpret_cast<uintptr_t>(ptrs[j]) & 15))
      return (int)cudaErrorInvalidValue;
    lv.p[j] = static_cast<const float*>(ptrs[j]);
    lv.m[j] = static_cast<const uint8_t*>(mks[j]);
    lv.side[j] = sd[j];
    lv.mag[j] = (1ull << 32) / (unsigned long long)(G / sd[j]) + 1;
  }
  lv.L = L;
  float* o = static_cast<float*>(out);
  unsigned* lb = static_cast<unsigned*>(live);
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 4: return launch<4>(lv, G, D, thresh, o, lb, s);
    case 13: return launch<13>(lv, G, D, thresh, o, lb, s);
    case 28: return launch<28>(lv, G, D, thresh, o, lb, s);
    case 49: return launch<49>(lv, G, D, thresh, o, lb, s);
    case 76: return launch<76>(lv, G, D, thresh, o, lb, s);
    default: return launch<0>(lv, G, D, thresh, o, lb, s);
  }
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
