// Kernel M, training mode: the fused shear-warp slab march over the bake's
// own tensor, for Hopper (sm_90a).
//
// Replaces volrend_tpu/ops/pallas_slab.py:_make_kernel in its training
// option set (bf16 payload, Dp = D, sigma in plane D-1, dir_win=False), the
// Pallas TPU kernel behind pallas_slab.march_slabs; its plain PyTorch twin
// is volrend_torch/ops/slab_march.py:march_slabs_ref. The display mode
// (int8 payload, window directions) is slab_march_display.cu.
//
// What it computes, per pose and intermediate pixel (j, k) of the (gi, gi)
// slope grid, for each slab in march order: mask sigma by the threshold,
// shade srgb = sigma * sigmoid(sum_k value * basis_k) with the view
// direction per slab (the backward kernel, slab_march_bwd.cu, recomputes
// this forward per slab and the two must match), warp [sigma, sigma*r,
// sigma*g, sigma*b] onto the pixel with the separable box-integration
// two-tap weights, then composite tau = sigma_w * dt_pix * frac_z front to
// back with the stop-threshold freeze. Output acc (P, 4, gi, gi) = [r, g,
// b, T].
//
// Its input is the bake's (G, G, G, D) tensor itself, seen as the
// (Gz, D, Gy, Gx) view of the pose group's permutation: the kernel takes
// the view's data pointer and element strides (channel stride 1: each
// voxel's D values are one record), f32 for the default trainer, bf16 for
// the lean one, and rounds f32 to bf16 as it reads it (__float2bfloat16_rn,
// as PyTorch's copy rounds): it marches the values of the bf16 planar copy
// that the training step no longer makes.
//
// What bounds it on the H100: the bytes the data needs, the sigma of the
// slabs the rays meet and the colour of the voxels above the threshold, at
// the tensor's element size (the training bench's pose 0: 67 MB of sigma
// and 95 MB of colour in f32, 0.048 ms at 3.35 TB/s); its operations (~110
// fp32 a shaded voxel, ~60 a marched (pixel, slab) pair) are fewer. The
// kernel this one replaced took 0.853 ms there (PERF.md): one block a
// 16x16 tile walked every slab its rays meet through a synchronous chain of
// scalar loads, ~95 % of them over empty space.
//
// Design (the shared loop is tmarch::march_loop in slab_common.cuh):
// - A coarse occupancy of the payload (vt_march_occupancy: per slab a bit
//   per 8x8 cell block holding a voxel above the threshold) is built once
//   a step and shared with the backward; the march reads no payload for a
//   footprint piece whose blocks are all empty. Its cost is the sigma read
//   of every voxel: one 32-byte sector a record (~0.35 ms at G = 256 SH9
//   f32, PERF.md).
// - One block per tile of intermediate pixels and pose (blockIdx.z), NT
//   threads: the first TY * TX own a pixel each (r, g, b, T, z interval
//   and slab thickness in registers across the march), all of them stage
//   and shade cells. The TPU's sequential grid over windows is the loop
//   inside the block, over the slab list (march order) cut to the slabs
//   the tile's z intervals meet.
// - The block lists the footprint pieces (at most PS x PS cells) whose
//   coarse occupancy is set, a thread a slab with one scan (no thread
//   walks the empty ones; a slab with more such pieces than a round of
//   the list holds is split across rounds), then runs the list through a
//   ring: the sigma words of the next RING - 1 pieces are copied ahead
//   with cp.async, each cell by the thread that later reads it (no
//   barrier), and the colour records of the cells above the threshold of
//   the piece DC ahead are queued into per-thread slots as soon as its
//   sigma has landed (16-byte copies where a record is 16-byte aligned,
//   aligned 4-byte words elsewhere; slots an odd number of 16-byte units
//   or words apart, so their reads hit distinct banks).
// - A piece whose staged sigma has no cell above the threshold is skipped
//   after one __syncthreads_or: it would shade to zero and change nothing.
//   Otherwise the threads shade its cells into shared memory as [sigma,
//   sigma*r, sigma*g, sigma*b] and each pixel sums its own separable
//   overlap weights over the few cells its span covers.
// - A block leaves its loop when no pixel of the tile can still
//   accumulate (checked once a slab with a cell above the threshold).
// - The launch's time is its slowest tiles': those at the object's
//   silhouette, whose rays that miss it keep the tile marching through all
//   of its slabs. Small tiles with several threads a pixel shorten their
//   chain; the configuration is fixed at compile time (tmarch::CONFIG:
//   4x8 tiles of 128 threads, pieces of 24 x 24 cells, ring 4, colour 2
//   pieces ahead), the fastest of those probes/train_march.py built and
//   timed (PERF.md).

#include "slab_common.cuh"

namespace {

struct TrainArgs {
  tmarch::PayView pv;
  const float* params;
  const float* qscale;
  const float* zb;
  const int* ids;
  const unsigned long long* occ;
  float* acc;
  unsigned long long* counts;
  int n_ids, G, gi, Gy, Gx, y0, x0, flip;
};

template <int BD, typename PT>
__global__ void __launch_bounds__(tmarch::NT)
march_kernel(const TrainArgs a) {
  using tmarch::NT;
  using tmarch::TX;
  using tmarch::TY;
  constexpr int D = 3 * BD + 1;  // colour values + sigma
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_prm[NP];
  __shared__ float s_qs[D];
  __shared__ tmarch::MarchStatic s_st;

  const int p = blockIdx.z;
  // the tile's pixels belong to the block's first TY * TX threads, one
  // each; every thread stages and shades cells
  const int tid = threadIdx.x;
  const bool owner = tid < TY * TX;
  const int j0 = blockIdx.y * TY, k0 = blockIdx.x * TX;
  const int j = j0 + (owner ? tid / TX : 0), k = k0 + (owner ? tid % TX : 0);
  const int gi = a.gi;

  for (int i = tid; i < NP; i += NT) s_prm[i] = a.params[(size_t)p * NP + i];
  for (int i = tid; i < D; i += NT) s_qs[i] = a.qscale[i];
  __syncthreads();

  tmarch::MarchCtx c;
  c.pv = a.pv;
  c.ids = a.ids;
  c.occ = a.occ;
  c.occ_rows = (a.Gy + tmarch::OCC - 1) / tmarch::OCC;
  c.occ_words = tmarch::occ_words(a.Gx);
  c.n_ids = a.n_ids;
  c.G = a.G;
  c.y0 = a.y0;
  c.x0 = a.x0;
  c.yend = a.y0 + a.Gy - 1;
  c.xend = a.x0 + a.Gx - 1;
  c.flip = a.flip;
  c.Gf = (float)a.G;
  c.hG = 0.5f / c.Gf;
  c.cz = s_prm[0];
  c.cy = s_prm[1];
  c.cx = s_prm[2];
  c.cyG = c.cy * c.Gf;
  c.cxG = c.cx * c.Gf;
  c.zbase = s_prm[30];
  c.sigma_thresh = s_prm[14];
  c.stop_thresh = s_prm[15];
  const float u0 = s_prm[3], du = s_prm[4], v0 = s_prm[5], dv = s_prm[6];
  // ray slopes x G: this pixel's, and the tile's first/last row and column
  const int jl = min(j0 + TY, gi) - 1, kl = min(k0 + TX, gi) - 1;
  c.ujG = (u0 + du * (float)j) * c.Gf;
  c.vkG = (v0 + dv * (float)k) * c.Gf;
  c.ujGa = (u0 + du * (float)j0) * c.Gf;
  c.ujGb = (u0 + du * (float)jl) * c.Gf;
  c.vkGa = (v0 + dv * (float)k0) * c.Gf;
  c.vkGb = (v0 + dv * (float)kl) * c.Gf;
  c.tid = tid;
  c.inpix = owner && (j < gi) && (k < gi);

  const size_t npx = (size_t)gi * gi;
  const size_t pix = (size_t)j * gi + k;
  float dtp = 0.f;
  c.zlo = 1.f;  // an empty interval off-grid
  c.zhi = 0.f;
  if (c.inpix) {
    const float* zbp = a.zb + (size_t)p * 4 * npx + pix;
    c.zlo = zbp[0];
    c.zhi = zbp[npx];
    dtp = zbp[2 * npx];
  }

  const tmarch::MarchSmem sm = tmarch::carve(smem, s_st);

  float r = 0.f, g = 0.f, b = 0.f, T = 1.f;
  const float Gf = c.Gf, hG = c.hG, zlo = c.zlo, zhi = c.zhi;
  const float stop_thresh = c.stop_thresh;
  const bool inpix = c.inpix;
  tmarch::march_loop<BD, PT>(
      c, sm, s_qs, s_prm, T, a.counts,
      [&](const tmarch::Job& jb, const PixelSpan&, float4 w4) {
        if (!inpix) return;
        const float z = jb.z;
        // boundary slabs contribute by their overlap with [zlo, zhi]
        const float frac = fminf(
            fmaxf((fminf(z + hG, zhi) - fmaxf(z - hG, zlo)) * Gf, 0.f), 1.f);
        const float tau = w4.x * dtp * frac;
        const float att = expf(-tau);
        const float sig_inv = 1.f / fmaxf(w4.x, 1e-12f);
        if (T >= stop_thresh && tau > 0.f) {
          const float wn = (T * (1.f - att)) * sig_inv;
          r += wn * w4.y;
          g += wn * w4.z;
          b += wn * w4.w;
          T = T * att;
        }
      });

  if (c.inpix) {
    float* out = a.acc + (size_t)p * 4 * npx + pix;
    out[0] = r;
    out[npx] = g;
    out[2 * npx] = b;
    out[3 * npx] = T;
  }
}

using KernFn = void (*)(const TrainArgs);

// one launch of the march (on a coarse occupancy vt_march_occupancy built)
template <int BD, typename PT>
struct Launch {
  static constexpr size_t SMEM = tmarch::march_smem<BD, PT>();
  static int run(const TrainArgs& a, int P, cudaStream_t s) {
    const KernFn fn = march_kernel<BD, PT>;
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((a.gi + tmarch::TX - 1) / tmarch::TX,
                    (a.gi + tmarch::TY - 1) / tmarch::TY, P);
    fn<<<grid, tmarch::NT, SMEM, s>>>(a);
    return (int)cudaGetLastError();
  }
  static int occupancy(tmarch::PayView pv, const float* params, int P,
                       const float* qscale, int Gz, int Gy, int Gx,
                       unsigned long long* occ, cudaStream_t s) {
    return (int)tmarch::build_occupancy<3 * BD + 1, PT>(
        pv, params, P, qscale, Gz, Gy, Gx, occ, s);
  }
  static int info(int* out) {
    const KernFn fn = march_kernel<BD, PT>;
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn,
                                                      tmarch::NT, SMEM);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes at;
    e = cudaFuncGetAttributes(&at, fn);
    if (e != cudaSuccess) return (int)e;
    out[1] = at.numRegs;
    out[2] = (int)at.localSizeBytes;
    out[3] = (int)SMEM;
    for (int i = 0; i < 7; ++i) out[4 + i] = tmarch::CONFIG[i];
    return 0;
  }
};

#define VT_BD_DTYPE(bd, f32, CALL)                                       \
  switch (bd) {                                                          \
    case 1: return f32 ? Launch<1, float>::CALL                          \
                       : Launch<1, __nv_bfloat16>::CALL;                 \
    case 4: return f32 ? Launch<4, float>::CALL                          \
                       : Launch<4, __nv_bfloat16>::CALL;                 \
    case 9: return f32 ? Launch<9, float>::CALL                          \
                       : Launch<9, __nv_bfloat16>::CALL;                 \
    case 16: return f32 ? Launch<16, float>::CALL                        \
                        : Launch<16, __nv_bfloat16>::CALL;               \
    case 25: return f32 ? Launch<25, float>::CALL                        \
                        : Launch<25, __nv_bfloat16>::CALL;               \
    default: return (int)cudaErrorInvalidValue;                          \
  }

}  // namespace

// The launch of kernel M's training mode. payload: element (0, 0, 0, 0) of
// a (Gz, D, Gy, Gx) view with channel stride 1 and slab/row/column element
// strides ss, sr, sc, f32 (pay_f32) or bf16, 16-byte aligned; params
// (P, 31) f32; qscale (D,) f32; zb (P, 4, gi, gi) f32; ids (n_ids,) int32
// slab ids in march order; occ: Gz * ceil(Gy / 8) * ceil(Gx / 512) uint64,
// the payload's coarse occupancy (vt_march_occupancy); acc (P, 4, gi, gi)
// f32; counts: tmarch::N_COUNTS uint64 (tmarch::add_counts) or null.
// Returns cudaGetLastError() after the launch.
extern "C" int vt_march_slabs(const void* payload, int pay_f32,
                              long long ss, long long sr, long long sc,
                              const void* params, const void* qscale,
                              const void* zb, const void* ids, int n_ids,
                              void* occ, void* acc, void* counts, int P,
                              int Gz, int G, int gi, int Gy, int Gx, int y0,
                              int x0, int bd, int flip, void* stream) {
  if (P < 1 || P > 65535 || gi < 1 || n_ids < 1 || Gy < 1 || Gx < 1 ||
      (reinterpret_cast<uintptr_t>(payload) & 15))
    return (int)cudaErrorInvalidValue;
  TrainArgs a;
  a.pv.ptr = payload;
  a.pv.ss = ss;
  a.pv.sr = sr;
  a.pv.sc = sc;
  a.params = (const float*)params;
  a.qscale = (const float*)qscale;
  a.zb = (const float*)zb;
  a.ids = (const int*)ids;
  a.occ = (const unsigned long long*)occ;
  a.acc = (float*)acc;
  a.counts = (unsigned long long*)counts;
  a.n_ids = n_ids;
  a.G = G;
  a.gi = gi;
  a.Gy = Gy;
  a.Gx = Gx;
  a.y0 = y0;
  a.x0 = x0;
  a.flip = flip;
  cudaStream_t s = (cudaStream_t)stream;
  VT_BD_DTYPE(bd, pay_f32, run(a, P, s))
}

// The coarse occupancy of a payload view (as for vt_march_slabs: channel
// stride 1, f32 or bf16, 16-byte aligned): occ, Gz * ceil(Gy / 8) *
// ceil(Gx / 512) uint64, per slab and row of 8 x 8 cell blocks the masks
// of the blocks with a voxel above the lowest sigma threshold of the P
// poses' params (P, 31). One memset and one launch; returns
// cudaGetLastError().
extern "C" int vt_march_occupancy(const void* payload, int pay_f32,
                                  long long ss, long long sr, long long sc,
                                  const void* params, int P,
                                  const void* qscale, int Gz, int Gy, int Gx,
                                  int bd, void* occ, void* stream) {
  if (P < 1 || Gz < 1 || Gy < 1 || Gx < 1 ||
      (reinterpret_cast<uintptr_t>(payload) & 15))
    return (int)cudaErrorInvalidValue;
  const tmarch::PayView pv{payload, ss, sr, sc};
  VT_BD_DTYPE(bd, pay_f32,
              occupancy(pv, (const float*)params, P, (const float*)qscale,
                        Gz, Gy, Gx, (unsigned long long*)occ,
                        (cudaStream_t)stream))
}

// What the card makes of the launch: out[0] resident blocks per SM, out[1]
// registers a thread, out[2] spill (local) bytes a thread, out[3] dynamic
// shared memory a block; out[4..10] the configuration it was built with
// (tmarch::CONFIG: ty, tx, nt, ps, ring, dc, rslots).
extern "C" int vt_march_slabs_info(int bd, int pay_f32, int* out) {
  VT_BD_DTYPE(bd, pay_f32, info(out))
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
