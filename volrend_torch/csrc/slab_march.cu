// Kernel M, training mode: the fused shear-warp slab march over the bake's
// own tensor, for Hopper (sm_90a).
//
// Replaces volrend_tpu/ops/pallas_slab.py:_make_kernel in its training
// option set (bf16 payload, Dp = D, sigma in plane D-1, dir_win=False; SH,
// SG, ASG and RGBA, rot, a non-full bbox and the basis window), the Pallas
// TPU kernel behind pallas_slab.march_slabs; its plain PyTorch twin is
// volrend_torch/ops/slab_march.py:march_slabs_ref. The display mode (int8
// payload, window directions) is slab_march_display.cu.
//
// What it computes, per pose and intermediate pixel (j, k) of the (gi, gi)
// slope grid, for each slab in march order: mask sigma by the threshold
// (and the bbox), shade srgb = sigma * sigmoid(sum_k value * basis_k) (SH,
// SG or ASG lobes, the direction rotated by rot, basis functions outside
// the window dropped; RGBA: srgb = sigma * value) with the view
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
//   footprint piece whose blocks are all empty. Read from the payload it
//   costs a 32-byte sector a voxel record (~0.35 ms at G = 256 SH9 f32,
//   PERF.md); on the training path it is reduced instead from the live
//   bits the pyramid bake writes beside the bake (vt_march_occupancy_live:
//   G^3 / 8 bytes).
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
// - One kernel template, march_kernel<V, PT>: the variant V
//   (tmarch::TVar<format, options, BD>) picks the format and whether the
//   run-time options are compiled in; the defaults (SH without options,
//   ShVar) take none of their code and keep the parameters they had before
//   the variants, so their registers stay as measured (a larger parameter
//   struct alone moved six of the ten). A z-segment's resume from its
//   upstream state (``flip``'s bit 1) is one of the run-time options. SG
//   and ASG take their lobe count, and so their record width D = 3 nb + 1,
//   at run time, under bounds 4, 9, 16 and 25 (record slots sized by the
//   bound; 16-byte copies where a record is a whole number of 16-byte
//   units, words elsewhere); the rotation goes into shared memory once a
//   block, and the lobes as the table each block folds once (fold_lobe,
//   slab_common.cuh, shared with the display mode), streamed one at a time
//   into the colour sums (tmarch::lobe_sums: one ex2 a lobe, no basis
//   array). The source is
//   built three times (VT_TRAIN_SET: the defaults, SH with options and
//   RGBA, SG and ASG), in parallel, to keep the build's wall time.

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

template <class V, typename PT>
__global__ void __launch_bounds__(tmarch::NT)
march_kernel(const tmarch::ArgsOf<V, TrainArgs> a) {
  using tmarch::NT;
  using tmarch::TX;
  using tmarch::TY;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_prm[NP];
  __shared__ float s_qs[V::DMAX];  // colour values + sigma
  __shared__ tmarch::MarchStatic s_st;

  const int p = blockIdx.z;
  // the tile's pixels belong to the block's first TY * TX threads, one
  // each; every thread stages and shades cells
  const int tid = threadIdx.x;
  const bool owner = tid < TY * TX;
  const int j0 = blockIdx.y * TY, k0 = blockIdx.x * TX;
  const int j = j0 + (owner ? tid / TX : 0), k = k0 + (owner ? tid % TX : 0);
  const int gi = a.gi;

  tmarch::TrainOpt opt{};  // the option variants' (their arguments' va)
  if constexpr (V::OPT) opt = tmarch::load_opt<V, NT>(a.va, a.qscale, tid);
  const int D = tmarch::rec_dim<V>(opt);
  for (int i = tid; i < NP; i += NT) s_prm[i] = a.params[(size_t)p * NP + i];
  for (int i = tid; i < D; i += NT) s_qs[i] = a.qscale[i];
  __syncthreads();
  tmarch::set_box<V>(opt, s_prm);

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
  if constexpr (V::OPT) c.flip = a.flip & 1;  // bit 1: resume (below)
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
  if constexpr (V::OPT) {
    if ((a.flip & 2) && c.inpix) {
      // a z-segment resumed from its upstream segments' state in acc
      const float* in = a.acc + (size_t)p * 4 * npx + pix;
      r = in[0];
      g = in[npx];
      b = in[2 * npx];
      T = in[3 * npx];
    }
  }
  const float Gf = c.Gf, hG = c.hG, zlo = c.zlo, zhi = c.zhi;
  const float stop_thresh = c.stop_thresh;
  const bool inpix = c.inpix;
  tmarch::march_loop<V, PT>(
      c, sm, s_qs, s_prm, opt, T, a.counts,
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

// one launch of the march of variant V (on a coarse occupancy built)
template <class V, typename PT>
struct Launch {
  using KernFn = void (*)(const tmarch::ArgsOf<V, TrainArgs>);
  static constexpr size_t SMEM = tmarch::march_smem<V, PT>();
  static int run(const TrainArgs& a, const tmarch::VarArgs& va, int P,
                 cudaStream_t s) {
    const KernFn fn = march_kernel<V, PT>;
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((a.gi + tmarch::TX - 1) / tmarch::TX,
                    (a.gi + tmarch::TY - 1) / tmarch::TY, P);
    fn<<<grid, tmarch::NT, SMEM, s>>>(tmarch::args_of<V>(a, va));
    return (int)cudaGetLastError();
  }
  static int info(int* out) {
    const KernFn fn = march_kernel<V, PT>;
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

}  // namespace

// The launch of kernel M's training mode. payload: element (0, 0, 0, 0) of a
// (Gz, D, Gy, Gx) view with channel stride 1 and slab/row/column element
// strides ss, sr, sc, f32 (pay_f32) or bf16, 16-byte aligned; params (P, 31)
// f32; qscale (D,) f32; zb (P, 4, gi, gi) f32; ids (n_ids,) int32 slab ids
// in march order; occ: Gz * ceil(Gy / 8) * ceil(Gx / 512) uint64, the
// payload's coarse occupancy (vt_march_occupancy); acc (P, 4, gi, gi) f32;
// counts: tmarch::N_COUNTS uint64 (tmarch::add_counts) or null. The payload
// may be a z-segment of the grid (Gz <= G slabs, its global z in
// params[30]); flip: bit 0 the march runs toward -z, bit 1 (the option
// variants only) resumes such a segment from the state acc holds on entry
// instead of (0, 0, 0, 1). The variant (tmarch::with_variant,
// tmarch::make_var): fmt (0 RGBA, bd = -1, D = 4; 1 SH; 2 SG, 3 ASG with bd
// lobes, 1 to 25, whose parameters ``extra`` holds on the device, their
// scales qscale[k] > 0, which fold into the lobes' exponents (the trainer's
// are ones); D = 3 bd + 1 otherwise), opt (the option variant: every
// format but SH, and SH with rot (9 floats on the host), bbox (params
// 16-19) or a basis window [basis_lo, basis_hi] that drops planes).
// Returns cudaGetLastError() after the launch.
extern "C" int vt_march_slabs(const void* payload, int pay_f32,
                              long long ss, long long sr, long long sc,
                              const void* params, const void* qscale,
                              const void* zb, const void* ids, int n_ids,
                              void* occ, void* acc, void* counts, int P,
                              int Gz, int G, int gi, int Gy, int Gx, int y0,
                              int x0, int bd, int flip, int fmt, int opt,
                              const void* extra, int rot_on, const void* rot,
                              int bbox, int basis_lo, int basis_hi,
                              void* stream) {
  if (P < 1 || P > 65535 || gi < 1 || n_ids < 1 || Gy < 1 || Gx < 1 ||
      Gz > G || (flip & ~3) || ((flip & 2) && !opt) ||
      (reinterpret_cast<uintptr_t>(payload) & 15))
    return (int)cudaErrorInvalidValue;
  tmarch::VarArgs va;
  if (!tmarch::make_var(fmt, bd, opt, extra, rot_on, rot, bbox, basis_lo,
                        basis_hi, va))
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
  return tmarch::with_variant(fmt, bd, opt, pay_f32, [&](auto v, auto e) {
    return Launch<decltype(v), typename decltype(e)::type>::run(a, va, P,
                                                                 s);
  });
}

// The coarse occupancy of a payload view (as for vt_march_slabs: channel
// stride 1, f32 or bf16, 16-byte aligned; records of D values, sigma
// last, any format): occ, Gz * ceil(Gy / 8) * ceil(Gx / 512) uint64, per
// slab and row of 8 x 8 cell blocks the masks of the blocks with a voxel
// above the lowest sigma threshold of the P poses' params (P, 31). One
// memset and one launch; returns cudaGetLastError().
extern "C" int vt_march_occupancy(const void* payload, int pay_f32,
                                  long long ss, long long sr, long long sc,
                                  const void* params, int P,
                                  const void* qscale, int Gz, int Gy, int Gx,
                                  int D, void* occ, void* stream) {
  if (P < 1 || Gz < 1 || Gy < 1 || Gx < 1 || D < 1 ||
      (reinterpret_cast<uintptr_t>(payload) & 15))
    return (int)cudaErrorInvalidValue;
  const tmarch::PayView pv{payload, ss, sr, sc};
  const float* prm = (const float*)params;
  const float* qs = (const float*)qscale;
  unsigned long long* o = (unsigned long long*)occ;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(pay_f32 ? tmarch::build_occupancy<float>(pv, D, prm, P, qs,
                                                        Gz, Gy, Gx, o, s)
                       : tmarch::build_occupancy<__nv_bfloat16>(
                             pv, D, prm, P, qs, Gz, Gy, Gx, o, s));
}

namespace {

// The coarse occupancy from a pyramid bake's live bits (bake_pyramid.cu):
// words (G, G, NWB) int32 in the bake's (z, y, x) order, bit i of word w
// the voxel x = 32 w + i. The view's axes (slab, row, column) are the
// bake's axes (perm[0], perm[1], perm[2]); ``ax`` is the view axis that is
// the bake's x, ``st`` the word strides of the view's other two axes.
//
// One warp a job, lane l the column block cb = 32 h + l of a half mask word
// h (an output mask word is two 32-bit halves, low first): each lane ORs
// the bit words its block's voxels lie in, and __ballot_sync assembles the
// halves, stored without atomics. The bits are read once (2 MiB at
// G = 256) and every half is written once (no memset):
// - columns are x: a job is (slab, row block, h); per row of the block one
//   word holds the lane's 8 columns as one byte;
// - rows are x: a job is (slab, word of 32 rows, h); per column of the
//   block one word holds 4 row blocks, one a byte: 4 halves a job;
// - slabs are x: a job is (word of 32 slabs, row block, h); the lane ORs
//   the 64 words of its block, whose bit i is slab 32 w + i: 32 halves a
//   job.
constexpr int OCC_WARPS = 8;

__global__ void __launch_bounds__(32 * OCC_WARPS)
occupancy_live_kernel(const unsigned* __restrict__ live, int G, int ax,
                      long long st_s, long long st_r, long long st_c,
                      unsigned* __restrict__ out) {
  using tmarch::OCC;
  const int lane = threadIdx.x & 31;
  const long long job = (long long)blockIdx.x * OCC_WARPS + (threadIdx.x >> 5);
  const int NWB = (G + 31) / 32, RB = (G + OCC - 1) / OCC;
  const int CB = RB, NH = 2 * tmarch::occ_words(G);
  const int h = (int)(job % NH);
  const long long rest = job / NH;
  const int cb = 32 * h + lane;
  const bool in = cb < CB;
  const int c0 = cb * OCC, c1 = min(c0 + OCC, G);
  unsigned m = 0;
  if (ax == 2) {  // columns are x: rest = slab * RB + row block
    if (rest >= (long long)G * RB) return;
    const int s = (int)(rest / RB), rb = (int)(rest % RB);
    const int r1 = min(rb * OCC + OCC, G);
    if (in)
      for (int r = rb * OCC; r < r1; ++r)
        m |= __ldg(live + s * st_s + r * st_r + cb / 4);
    const bool on = (m >> (8 * (cb & 3))) & 0xffu;
    const unsigned b = __ballot_sync(0xffffffffu, on);
    if (lane == 0) out[rest * NH + h] = b;
  } else if (ax == 1) {  // rows are x: rest = slab * NWB + row word
    if (rest >= (long long)G * NWB) return;
    const int s = (int)(rest / NWB), rw = (int)(rest % NWB);
    if (in)
      for (int c = c0; c < c1; ++c)
        m |= __ldg(live + s * st_s + c * st_c + rw);
    unsigned mine = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned b = __ballot_sync(0xffffffffu, (m >> (8 * k)) & 0xffu);
      if (lane == k) mine = b;
    }
    const int rb = 4 * rw + lane;
    if (lane < 4 && rb < RB) out[((long long)s * RB + rb) * NH + h] = mine;
  } else {  // slabs are x: rest = slab word * RB + row block
    if (rest >= (long long)NWB * RB) return;
    const int sw = (int)(rest / RB), rb = (int)(rest % RB);
    const int r1 = min(rb * OCC + OCC, G);
    if (in)
      for (int r = rb * OCC; r < r1; ++r)
        for (int c = c0; c < c1; ++c)
          m |= __ldg(live + r * st_r + c * st_c + sw);
    unsigned mine = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const unsigned b = __ballot_sync(0xffffffffu, (m >> i) & 1u);
      if (lane == i) mine = b;
    }
    const int s = 32 * sw + lane;
    if (s < G) out[((long long)s * RB + rb) * NH + h] = mine;
  }
}

}  // namespace

// The coarse occupancy of a pose group's view of a pyramid bake, from the
// bake's live bits: live, (G, G, ceil(G / 32)) int32 words (bake_pyramid.cu,
// vt_bake_pyramid); perm (int[3], host) the bake axes of the view's slab,
// row and column axes; occ as vt_march_occupancy writes it (G * ceil(G / 8)
// * ceil(G / 512) uint64), the blocks holding a live voxel. The threshold is
// the one the bits were taken at. One launch; returns cudaGetLastError().
extern "C" int vt_march_occupancy_live(const void* live, int G,
                                       const int* perm, void* occ,
                                       void* stream) {
  if (G < 1) return (int)cudaErrorInvalidValue;
  const int NWB = (G + 31) / 32, RB = (G + tmarch::OCC - 1) / tmarch::OCC;
  const int NH = 2 * tmarch::occ_words(G);
  // word strides of the bake's z and y axes; the view axis that is x
  const long long bst[2] = {(long long)G * NWB, NWB};
  long long st[3] = {0, 0, 0};
  int ax = -1, seen = 0;
  for (int a = 0; a < 3; ++a) {
    if (perm[a] < 0 || perm[a] > 2 || (seen >> perm[a]) & 1)
      return (int)cudaErrorInvalidValue;
    seen |= 1 << perm[a];
    if (perm[a] == 2) ax = a;
    else st[a] = bst[perm[a]];
  }
  const long long jobs = ax == 2   ? (long long)G * RB * NH
                         : ax == 1 ? (long long)G * NWB * NH
                                   : (long long)NWB * RB * NH;
  occupancy_live_kernel<<<(unsigned)((jobs + OCC_WARPS - 1) / OCC_WARPS),
                          32 * OCC_WARPS, 0, (cudaStream_t)stream>>>(
      (const unsigned*)live, G, ax, st[0], st[1], st[2], (unsigned*)occ);
  return (int)cudaGetLastError();
}

// What the card makes of the launch of variant (bd, fmt, opt; as for
// vt_march_slabs) on a payload of f32 (pay_f32) or bf16: out[0] resident
// blocks per SM, out[1] registers a thread, out[2] spill (local) bytes a
// thread, out[3] dynamic shared memory a block; out[4..10] the
// configuration it was built with (tmarch::CONFIG: ty, tx, nt, ps, ring,
// dc, rslots).
extern "C" int vt_march_slabs_info(int bd, int pay_f32, int fmt, int opt,
                                   int* out) {
  return tmarch::with_variant(fmt, bd, opt, pay_f32, [&](auto v, auto e) {
    return Launch<decltype(v), typename decltype(e)::type>::info(out);
  });
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
