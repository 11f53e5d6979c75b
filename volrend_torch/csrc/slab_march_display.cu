// Kernel M, display mode: the fused shear-warp slab march over the int8
// or bf16 display payload, designed for Hopper (sm_90a).
//
// Replaces volrend_tpu/ops/pallas_slab.py:_make_kernel in its display
// option set (dir_win=True: the sig2 int8 payload or the f16 bake's bf16
// one; SH, SG, ASG and RGBA; depth, rot, a non-full bbox, the basis
// window), the Pallas TPU kernel behind pallas_slab.march_slabs; its plain
// PyTorch twin is volrend_torch/ops/slab_march.py:march_slabs_ref. The
// training mode (f32/bf16 bake, per-slab directions) is slab_march.cu.
//
// What it computes, per pose and intermediate pixel (j, k) of the (gi, gi)
// slope grid, for each occupied slab in march order: dequantize the
// payload (colour codes x qscale, sigma = (hi*128 + lo) x qscale over two
// planes, Dp = 3*bd + 2), mask sigma by the threshold, shade srgb = sigma *
// sigmoid(sum_k code * basis_k * qs_k) with the view direction taken once
// per K-slab window at the window centre, warp [sigma, sigma*r, sigma*g,
// sigma*b] onto the pixel with the separable box-integration two-tap
// weights (edge cells extended to +-inf, global cell indices under the
// crop), then composite tau = sigma_w * dt_pix * frac_z front to back with
// the stop-threshold freeze. Output acc (P, 4, gi, gi) = [r, g, b, T].
//
// What bounds it on the H100: every pose shades every voxel its rays cross
// (the direction is per pose), ~9*bd + 30 fp32 operations a voxel, so a
// 51-pose group is bound by operations (~2.5 ms); the payload is 0.84 GB
// for G=256, SH16. The kernel this one replaced took 14.6x that bound:
// each code was a scalar byte load from device memory and an I2F, each
// 16x16 tile shaded ~1.27x its voxels, each slab ran one synchronous
// chain. This one takes ~10x (25.5 ms, PERF.md). Measured on the card
// (PERF.md's ablations): the conversion is not the limit (one I2F a code
// in place of the byte permute: +6 % on orbit group 0), nor the prefetch
// depth (a ring of two or three smaller stages was slower on every
// display launch measured, +8 % / +20 % on group 0), nor the grid order
// (tile-major: +9 %); what costs is the number of jobs, one (slab,
// footprint piece) each with its block barriers, and the shading work of
// each (an estimate: there is no ncu on the machine).
//
// Design:
// - One block of 256 threads per tile of intermediate pixels and pose,
//   pose-fastest (the blocks resident together read nearly the same
//   footprints of different poses, so L2 serves most of the payload), the
//   tiles in row-major order (launching the central tiles first was
//   slower on 22 of the 27 display launches measured, PERF.md). The
//   tile is 32x16 (two pixels a thread, rows ty and ty + 8), which shades
//   ~1.13 cells a pixel at gi = G, or 32x8 (one pixel a thread, twice the
//   blocks), which balances a launch of few tiles better;
//   slab_march.display_config picks it from the launch's size (measured
//   on every display launch by volrend_torch/probes/display_tiles.py).
// - Staging: per slab the tile's cell footprint (from the affine slope
//   map, extremes at the tile corners, +-1 cell of margin), all Dp planes
//   of it, goes global -> shared with 16-byte cp.async copies, rows of
//   whole 16-byte chunks; each thread walks one (plane, chunk) column down
//   the rows. The copies of the next piece are issued as soon as the
//   current one is shaded, so they overlap its tap sums and the other
//   resident block's work. One stage takes most of the shared memory, so
//   most footprints stage whole; a larger one goes in pieces (the warp is
//   linear, so pieces add). Payloads whose rows are not whole chunks (Gx
//   not a multiple of 16) are staged by the same kernel with plain byte
//   copies, in step. A first version staged with TMA (a 4-D tensor map a
//   box width, one box a footprint row) and faulted on the card with an
//   illegal instruction; a one-box load alone works
//   (volrend_torch/probes/tma_box.py), so the fault lay in that version,
//   which was not pursued: the staging is cp.async.
// - Shading from shared memory: a thread takes two neighbouring cells of
//   one 32-bit word of each plane and turns each int8 code into an exact
//   f32 without I2F: byte-permute the biased byte (w ^ 0x80808080) under
//   the exponent 0x4B00_00xx (2^23 + code + 128), then one FADD of
//   -(2^23 + 128). The basis dot products stay f32 FMAs; sigma's hi*128 +
//   lo stays exact; the sigmoids use the fast exponential and divide. The
//   shaded [sigma, sigma*r, sigma*g, sigma*b] of a cell is one float4, so
//   a pixel's tap reads 16 bytes a cell.
// - Each pixel sums its own separable overlap weights over the cells its
//   span covers (pallas_slab._overlap_mats in f32), composites after the
//   slab's last piece, and the block leaves when no pixel can still
//   accumulate; windows no pixel's z interval meets are never staged, and
//   windows whose pixels all saturated are skipped (__syncthreads_or).
// - __launch_bounds__(256, 2): two blocks (16 warps) per SM, what <= 128
//   registers a thread and ~110 KB of shared memory a block allow; the
//   copies are asynchronous and the other resident block covers them.
// - One kernel template, display_kernel<BD, ROWS, V>; the variant V
//   (Var<bf16, format, options>) picks the payload element, the format
//   and whether the run-time options are compiled in. The default, SH on
//   the int8 payload with no option, is Var<false, F_SH, false>. The bf16
//   payload (the f16 bake) holds two cells in a 32-bit word (each to f32
//   by an exact 16-bit shift), a 16-byte chunk 8 cells, and its stage is
//   sized in bytes (half the cells of an int8 stage: more footprints go in
//   pieces, which add). The option variants (32x8 tiles; SG and ASG at
//   both heights) take the rest at run time: SG and ASG (below), RGBA (no
//   basis, no sigmoid, a scale a channel), rot (9 floats on the window
//   direction), the basis window (the MACs of the dropped planes skipped)
//   and the bbox (an in-plane voxel-extent mask ANDed into the sigma
//   mask); depth is a variant of its own (below: sigma alone warped, one
//   tap channel, and the composite adds w * |z - z0| * tview).
// - The display knobs (the reference's pallas_slab._DIR_WIN and
//   _BF16_SHADE, pallas_slab.py:85-107): per-slab view directions
//   (dir_win=False) need nothing of the kernel: each voxel's basis is
//   evaluated at the window centre's distance, so a launch with one-slab
//   windows (K = 1, slab_march.march_slabs) takes each slab's own; bf16 SH
//   shading is a variant of its own, Var<bf16, F_SH, false, true> without
//   another option at both tile heights (the tile rule's) and
//   Var<bf16, F_SH, true, true> with rot, bbox or a basis window at 32x8,
//   on both payloads (degrees 0-4). A shading unit takes its two cells'
//   f32 view directions to bf16 pairs and evaluates the SH polynomials in
//   packed bf16x2 arithmetic (sh_basis2: __hmul2 / __hfma2, the constants
//   rounded to bf16), as the reference evaluates them in bf16
//   (pallas_slab.py:393-397), scales each plane by its bf16 scale (one
//   __hmul2), and sums each colour over the planes with one __hfma2 a
//   plane, the codes exact in bf16; the sigmoid stays f32. A first version
//   (an option variant, 32x8 tiles only, the basis in f32 and each scaled
//   plane rounded into a pair) ran 26 % slower than the f32 default on an
//   orbit group, mostly for its tile height (PERF.md).
// - The f16 route's SH variants (Var<true, F_SH, false> and bf16 shading
//   without options on either payload) take each job's walk once: the
//   consumer's next job is the piece the producer has just issued, where
//   the defaults walk every job twice. Thread 0's clock on the f16 orbit
//   group (probes/display_march.py, PERF.md) had the copy issue at 28 % of
//   the loop, stalled behind the burst of copies all warps make at once
//   (twice the bytes and copies a cell of the int8 payload, 1.40 pieces a
//   slab against 1.12), shading at 39 % and the walk at 10 %. Tried and
//   not kept (PERF.md): one TMA box a job waited 80 % of the loop for its
//   rows of 80 bytes across 49 planes and, its shape fixed by its tensor
//   map, took 1.82 pieces a slab: 2.8x slower; on this card every box
//   tried that starts inside a 16-byte chunk faults with an illegal
//   instruction (probes/tma_box.py --box3 --x: the first TMA version's
//   fault). The next piece's copies issued in parts between the tap sums
//   ran 2-3 % slower than in one burst. Several slabs a job (the whole
//   footprints of up to four slabs of a window staged together where they
//   fit, their walk states handed over in shared memory: 0.70 jobs a slab
//   at 32x8, 1.32 at 32x16) ran 5.5-5.8 % slower than the same loop with
//   one slab a job: each job's copies come in a larger burst, and the
//   barriers it saves were 0.4 % of the loop.
// - SG and ASG shading streams the lobes: one instantiation a format,
//   payload and tile height takes any count of 1 to 25 lobes at run time.
//   A block folds each lobe's constants once, as it loads them into shared
//   memory (fold_lobe: log2(e), the lobe count's 1/nb and the scale qs[k]
//   the int8 bake shares across rgb folded in; SG one float4 a lobe, ASG
//   three, its exponent a quadratic form in the view direction), and each
//   shading unit evaluates one lobe at a time for both of its cells (one
//   ex2 each) straight into the six colour sums. A first version held two
//   whole basis arrays of the compiled bound (4, 9, 16 or 25) a unit and
//   the lobes' 4 or 11 loop-invariant floats: ASG spilled up to 1016 bytes
//   a thread under the two-block register cap and ran ~39x its bound.
// - RGBA without a bbox is a kernel of its own (rgba_kernel, below, 32x8
//   tiles): a producer warp that walks the tile once and issues the
//   copies beside 8 consumer warps, two slots of stage, jobs of several
//   slabs, and no shade pass (the taps decode the staged codes); the bbox
//   keeps the option variant.
// - Depth mode is a variant of its own (F_DEPTH, any format): it stages
//   the sigma planes alone (int8 hi and lo, or the bf16 plane: 2 bytes a
//   cell) and keeps one float a shaded cell, so its stage holds ~11x the
//   cells of an SH16 int8 launch and every orbit footprint stages whole.
//   A one-pose launch is one wave of blocks that each walk every slab, and
//   the walk's steps, not the staged bytes, take its time (PERF.md): a
//   ring of four stage slots, three jobs' copies in flight, was no faster.

#include "slab_common.cuh"

namespace {

constexpr int DTX = 32;            // tile columns: one warp's pixels
constexpr int DWARPS = 8;
constexpr int DNT = DTX * DWARPS;  // threads per block
constexpr int MAX_COLS = 240;      // a piece's columns (its row <= 256 B)
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block can use
constexpr int MAX_LOBES = 25;      // SG/ASG lobes a launch takes
// the depth mode's shading, a variant of its own for every format: sigma
// alone (beside the basis formats F_RGBA .. F_ASG of slab_common.cuh)
constexpr int F_DEPTH = 4;

struct DispArgs {
  const int8_t* payload;
  const float* params;
  const float* qscale;
  const float* zb;
  const int* wins;
  const int* masks;
  float* acc;
  int n_win, P, G, gi, Dp, Gy, Gx, y0, x0, K, flip;
  int stage_bytes, chan_cells, async, ntx;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// this thread's copies have landed
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// one 32-bit word of codes (four neighbouring cells of one plane), each
// byte biased by 128 for code()
__device__ __forceinline__ uint32_t word(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
}

// code i of a biased word as an exact f32: 0x4B0000uu is 2^23 + uu, uu =
// code + 128, so one FADD of -(2^23 + 128) leaves the code
__device__ __forceinline__ float code(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | i)) -
         8388736.f;
}

__device__ __forceinline__ float fast_sigmoid(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

// A probe build's clock (VT_DM_CYCLES, volrend_torch/probes/display_march.py):
// thread 0's clock cycles by part of the job loop, then the whole loop's,
// the jobs (slab pieces) and slabs it walked, the windows it entered and
// the stages it waited for, one row a block in dm_cycles (blocks past
// DM_BLOCKS are not kept); vt_display_cycles reads and clears the rows.
// Other builds' clock is empty and adds no instruction.
enum DPart {
  D_PRO,       // the block's set-up: params, live windows, the first copy
  D_WALK,      // Walk::next: the next job and its footprint
  D_ISSUE,     // issuing the next job's copies
  D_WAIT,      // waiting for them
  D_SHADE,     // shading the staged cells
  D_BWIN,      // the two __syncthreads_or of a new window
  D_BSHADE,    // the barrier after shading (the stage is consumed)
  D_BEND,      // the barrier at a job's end (s_chan has been read)
  D_TAPS,      // the pixels' tap sums
  D_COMP,      // the composite after a slab's last piece
  D_NPARTS
};
// + loop, jobs (slab pieces), slabs, windows, stages (a stage's copies and
// its end barrier: one a job in display_kernel, one a run of pieces in
// rgba_kernel)
constexpr int DM_SLOTS = D_NPARTS + 5;
#ifdef VT_DM_CYCLES
constexpr int DM_BLOCKS = 1 << 16;
__device__ unsigned long long dm_cycles[DM_BLOCKS][DM_SLOTS];
struct DClock {
  long long n[DM_SLOTS], t, t0;
  __device__ DClock() {
    for (int i = 0; i < DM_SLOTS; ++i) n[i] = 0;
    t0 = t = clock64();
  }
  __device__ void lap(DPart p) {
    const long long u = clock64();
    n[p] += u - t;
    t = u;
  }
  __device__ void count(int slot) { ++n[D_NPARTS + 1 + slot]; }
  __device__ void store(int tid, int bid) {
    if (tid != 0 || bid >= DM_BLOCKS) return;
    n[D_NPARTS] = clock64() - t0;
    for (int i = 0; i < DM_SLOTS; ++i)
      dm_cycles[bid][i] = (unsigned long long)n[i];
  }
};
#else
struct DClock {
  __device__ void lap(DPart) {}
  __device__ void count(int) {}
  __device__ void store(int, int) {}
};
#endif
// DClock::count slots
constexpr int DM_JOB = 0, DM_SLAB = 1, DM_WIN = 2, DM_STAGE = 3;

struct ShadeCtx {
  float invG, cy, cx, sc, ssign, thr;
  const float* prm;
  const float* qs;
};

// bf16 shading's context: each staged plane's scale as a bf16 pair too.
struct ShadeCtxB : ShadeCtx {
  const __nv_bfloat162* qsb;
};

// The bf16 bits nearest a normal f32 v (ties to even), at compile time:
// the packed SH basis's constants.
__host__ __device__ constexpr unsigned short bf16_bits(float v) {
  const unsigned short s = v < 0.f ? 0x8000 : 0;
  float a = v < 0.f ? -v : v;
  if (a == 0.f) return s;
  int e = 0;
  while (a >= 2.f) {
    a *= 0.5f;
    ++e;
  }
  while (a < 1.f) {
    a *= 2.f;
    --e;
  }
  const float m = a * 128.f;  // [128, 256): 7 fraction bits kept
  int q = (int)m;
  const float r = m - (float)q;
  if (r > 0.5f || (r == 0.5f && (q & 1))) ++q;
  if (q == 256) {
    q = 128;
    ++e;
  }
  return (unsigned short)(s | ((e + 127) << 7) | (q - 128));
}

// a bf16 pair of two equal halves of the bits b
__device__ __forceinline__ __nv_bfloat162 bpair(unsigned short b) {
  const uint32_t u = (uint32_t)b * 0x10001u;
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

// The SH basis of degree BD at a pair of unit directions (x, y, z: bf16
// pairs), in packed bf16 arithmetic, each operation rounded to bf16 (ties
// to even), the constants rounded to bf16 first; the reference's planes
// (pallas_slab._sh_planes) with their shared products taken once.
// volrend_torch/ops/slab_march.py's _sh_basis_bf16 is its plain version,
// operation for operation.
template <int BD>
__device__ __forceinline__ void sh_basis2(__nv_bfloat162 x, __nv_bfloat162 y,
                                          __nv_bfloat162 z,
                                          __nv_bfloat162* bk) {
#define VT_K(v) \
  bpair(std::integral_constant<unsigned short, bf16_bits(v)>::value)
  bk[0] = VT_K(C0);
  if constexpr (BD >= 4) {
    bk[1] = __hmul2(VT_K(-C1), y);
    bk[2] = __hmul2(VT_K(C1), z);
    bk[3] = __hmul2(VT_K(-C1), x);
  }
  if constexpr (BD >= 9) {
    const __nv_bfloat162 xx = __hmul2(x, x), yy = __hmul2(y, y),
                         zz = __hmul2(z, z);
    const __nv_bfloat162 xy = __hmul2(x, y), yz = __hmul2(y, z),
                         xz = __hmul2(x, z);
    const __nv_bfloat162 s = __hadd2(xx, yy), d = __hsub2(xx, yy);
    bk[4] = __hmul2(VT_K(C2_0), xy);
    bk[5] = __hmul2(VT_K(C2_1), yz);
    bk[6] = __hmul2(VT_K(C2_2), __hfma2(VT_K(2.f), zz, __hneg2(s)));
    bk[7] = __hmul2(VT_K(C2_3), xz);
    bk[8] = __hmul2(VT_K(C2_4), d);
    if constexpr (BD >= 16) {
      const __nv_bfloat162 t4 = __hfma2(VT_K(4.f), zz, __hneg2(s));
      const __nv_bfloat162 u3 = __hfma2(VT_K(3.f), xx, __hneg2(yy));
      const __nv_bfloat162 v3 = __hfma2(VT_K(-3.f), yy, xx);
      bk[9] = __hmul2(__hmul2(VT_K(C3_0), y), u3);
      bk[10] = __hmul2(__hmul2(VT_K(C3_1), xy), z);
      bk[11] = __hmul2(__hmul2(VT_K(C3_2), y), t4);
      bk[12] = __hmul2(__hmul2(VT_K(C3_3), z),
                       __hfma2(VT_K(-3.f), s, __hadd2(zz, zz)));
      bk[13] = __hmul2(__hmul2(VT_K(C3_4), x), t4);
      bk[14] = __hmul2(__hmul2(VT_K(C3_5), z), d);
      bk[15] = __hmul2(__hmul2(VT_K(C3_6), x), v3);
      if constexpr (BD >= 25) {
        const __nv_bfloat162 z71 = __hfma2(VT_K(7.f), zz, VT_K(-1.f));
        const __nv_bfloat162 z73 = __hfma2(VT_K(7.f), zz, VT_K(-3.f));
        bk[16] = __hmul2(__hmul2(VT_K(C4_0), xy), d);
        bk[17] = __hmul2(__hmul2(VT_K(C4_1), yz), u3);
        bk[18] = __hmul2(__hmul2(VT_K(C4_2), xy), z71);
        bk[19] = __hmul2(__hmul2(VT_K(C4_3), yz), z73);
        bk[20] = __hmul2(VT_K(C4_4),
                         __hfma2(zz, __hfma2(VT_K(35.f), zz, VT_K(-30.f)),
                                 VT_K(3.f)));
        bk[21] = __hmul2(__hmul2(VT_K(C4_5), xz), z73);
        bk[22] = __hmul2(__hmul2(VT_K(C4_6), d), z71);
        bk[23] = __hmul2(__hmul2(VT_K(C4_7), xz), v3);
        bk[24] = __hmul2(VT_K(C4_8),
                         __hfma2(xx, v3, __hneg2(__hmul2(yy, u3))));
      }
    }
  }
#undef VT_K
}

// What a block's walk shares: its windows, the slab geometry and its
// tile's corner rays.
struct WalkGeo {
  const int* w;
  const int* m;
  const int* live;
  int n_win, K, flip, G, Dp, stage_bytes, chan_cells, ylo, yhi, xlo, xhi;
  float zbase, cz, cyG, cxG, hG, Gf, ujGa, ujGb, vkGa, vkGb;
};

// A variant: the payload's element, the basis format (or F_DEPTH),
// whether the run-time options (rot, bbox, basis window, lobe count) are
// compiled in, and whether each pixel resumes from the state ``acc``
// holds (RS: a z-segment after upstream ones; only in the resume build).
template <bool BF, int FM, bool O, bool BS = false, bool RS = false>
struct Var {
  static constexpr bool BF16 = BF;         // bf16 (Dp = D), else int8 (D + 1)
  static constexpr int FMT = FM;
  static constexpr bool OPT = O;
  static constexpr bool BSH = BS;          // SH shading in bf16 pairs
  static constexpr bool RESUME = RS;       // start from acc, not (0, 1)
  static constexpr int ESZ = BF ? 2 : 1;   // bytes a cell of one plane
  static constexpr int CH = 16 / ESZ;      // cells a 16-byte chunk
  static constexpr int SIGP = BF ? 1 : 2;  // sigma planes
  static constexpr bool DEPTH = FM == F_DEPTH;  // stages sigma's planes only
  static constexpr bool LOBES = FM == F_SG || FM == F_ASG;
  // float4 a lobe of the folded lobe table (fold_lobe)
  static constexpr int LW = FM == F_ASG ? 3 : 1;
  // the SH variants without options but the int8 default (the f16
  // route's and bf16 shading's) take each job's walk once
  static constexpr bool WALK1 = FM == F_SH && !O && (BF || BS);
};

// a launch's arguments: the payload, geometry and stage, and the run-time
// options (read by the option variants only; ``depth`` picks the depth
// variant on the host and is read by no kernel: the struct keeps its
// layout, which the defaults' parameter space follows)
struct LaunchArgs {
  DispArgs a;
  const float* extra;
  int nb, depth, rot_on, bbox, blo, bhi;
  float rot[9];
};

// The two neighbouring cells of one plane a shading unit takes: int8 codes
// i and i + 1 of the (biased) word at p, or the bf16 pair of the word at p
// (each an exact f32 by a 16-bit shift).
template <bool BF>
__device__ __forceinline__ float2 cell_pair(const uint8_t* p, int i) {
  if constexpr (BF) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  } else {
    const uint32_t w = word(p);
    return make_float2(code(w, i), code(w, i + 1));
  }
}

// the same pair as a bf16 pair (exact: an int8 code has 8 significant
// bits; a bf16 payload word holds the pair as it is)
template <bool BF>
__device__ __forceinline__ __nv_bfloat162 cell_pair16(const uint8_t* p,
                                                      int i) {
  if constexpr (BF) {
    return *reinterpret_cast<const __nv_bfloat162*>(p);
  } else {
    const float2 c = cell_pair<false>(p, i);
    return __floats2bfloat162_rn(c.x, c.y);
  }
}

// The option variants' run-time state: the rotation (9 floats in shared
// memory, or null), the folded lobe table (shared memory, fold_lobe), the
// lobe count nb and the lobes [klo, khi] the basis window keeps, the basis
// window [blo, bhi], and the in-plane box of params 16-19 with the half
// cell h.
struct OptCtx {
  const float* rot;
  const float4* lobes;
  int nb, blo, bhi, bbox, klo, khi;
  float lo1, hi1, lo2, hi2, h;
};

// The voxel's unit view direction (slab_common.cuh view_dir, at camera
// distance c.sc of the window centre), rotated by o.rot.
template <class V>
__device__ __forceinline__ void voxel_dir(const ShadeCtx& c, const OptCtx& o,
                                          float ycm, float xcm, float& x,
                                          float& y, float& z) {
  view_dir(c.prm, ycm, xcm, c.sc, c.ssign, x, y, z);
  if constexpr (V::OPT) {
    if (o.rot) rotate(o.rot, x, y, z);
  }
}

// The SH basis of degree BD at the voxel's view direction.
template <int BD, class V>
__device__ __forceinline__ void voxel_basis(const ShadeCtx& c,
                                            const OptCtx& o, float ycm,
                                            float xcm, float* bk) {
  float x, y, z;
  voxel_dir<V>(c, o, ycm, xcm, x, y, z);
  sh_basis<BD>(x, y, z, bk);
}

// Two neighbouring cells of the stage at ``wp`` (int8: the word that
// holds them, cells i and i + 1, i = 0 or 2; bf16: their word), planes
// ``plane`` bytes apart, D data planes (int8: sigma's hi plane D - 1 and
// lo plane D; bf16: sigma in plane D - 1), into out[0..1] as [sigma,
// sigma*r, sigma*g, sigma*b] (the depth variant: sigma, its stage the
// sigma planes alone, D = 1); zero under the sigma threshold. ``gy``/
// ``gx``: the first cell's global indices.
template <int BD, class V, class Cell, class Ctx>
__device__ __forceinline__ void shade_pair(const uint8_t* wp, int plane,
                                           int i, const Ctx& c,
                                           const OptCtx& o, int D, int gy,
                                           int gx, Cell* out) {
  const float qsig = c.qs[D - 1];
  float sa, sb;
  if constexpr (V::BF16) {
    const float2 s = cell_pair<true>(wp + (D - 1) * plane, i);
    sa = s.x * qsig;
    sb = s.y * qsig;
  } else {
    const float2 h = cell_pair<false>(wp + (D - 1) * plane, i);
    const float2 l = cell_pair<false>(wp + D * plane, i);
    sa = (h.x * 128.f + l.x) * qsig;
    sb = (h.y * 128.f + l.y) * qsig;
  }
  bool oka = sa > c.thr, okb = sb > c.thr;
  if constexpr (V::OPT) {
    if (o.bbox) {
      // the voxel's extent meets the in-plane box (pallas_slab._shade_pre)
      const float yc = ((float)gy + 0.5f) * c.invG;
      const float xa = ((float)gx + 0.5f) * c.invG;
      const float xb = ((float)(gx + 1) + 0.5f) * c.invG;
      const bool yin = (yc + o.h > o.lo1) && (yc - o.h < o.hi1);
      oka = oka && yin && (xa + o.h > o.lo2) && (xa - o.h < o.hi2);
      okb = okb && yin && (xb + o.h > o.lo2) && (xb - o.h < o.hi2);
    }
  }
  if constexpr (V::DEPTH) {
    out[0] = oka ? sa : 0.f;
    out[1] = okb ? sb : 0.f;
  } else {
    float4 oa = make_float4(0.f, 0.f, 0.f, 0.f), ob = oa;
    if (oka || okb) {
      if constexpr (V::FMT == F_RGBA) {
        // raw colours: no basis, no sigmoid, a scale a channel
        const float2 c0 = cell_pair<V::BF16>(wp, i);
        const float2 c1 = cell_pair<V::BF16>(wp + plane, i);
        const float2 c2 = cell_pair<V::BF16>(wp + 2 * plane, i);
        const float q0 = c.qs[0], q1 = c.qs[1], q2 = c.qs[2];
        if (oka)
          oa = make_float4(sa, sa * (c0.x * q0), sa * (c1.x * q1),
                           sa * (c2.x * q2));
        if (okb)
          ob = make_float4(sb, sb * (c0.y * q0), sb * (c1.y * q1),
                           sb * (c2.y * q2));
      } else if constexpr (V::LOBES) {
        // the lobes streamed: one at a time, for both cells, straight into
        // the six colour sums; the colour planes of lobe k are k, nb + k
        // and 2 nb + k
        const float ycm = ((float)gy + 0.5f) * c.invG - c.cy;
        float x, y, z;
        voxel_dir<V>(c, o, ycm, ((float)gx + 0.5f) * c.invG - c.cx, x, y, z);
        const LobeDir da = lobe_dir<V::FMT>(x, y, z);
        voxel_dir<V>(c, o, ycm, ((float)(gx + 1) + 0.5f) * c.invG - c.cx, x,
                     y, z);
        const LobeDir db = lobe_dir<V::FMT>(x, y, z);
        const int cs = o.nb * plane;
        const uint8_t* p = wp + o.klo * plane;
        float ra0 = 0.f, ra1 = 0.f, ra2 = 0.f, rb0 = 0.f, rb1 = 0.f, rb2 = 0.f;
#pragma unroll 2
        for (int k = o.klo; k <= o.khi; ++k, p += plane) {
          const float4* L = o.lobes + V::LW * k;
          const float qa = lobe_at<V::FMT>(L, da), qb = lobe_at<V::FMT>(L, db);
          const float2 c0 = cell_pair<V::BF16>(p, i);
          const float2 c1 = cell_pair<V::BF16>(p + cs, i);
          const float2 c2 = cell_pair<V::BF16>(p + 2 * cs, i);
          ra0 += c0.x * qa;
          ra1 += c1.x * qa;
          ra2 += c2.x * qa;
          rb0 += c0.y * qb;
          rb1 += c1.y * qb;
          rb2 += c2.y * qb;
        }
        if (oka)
          oa = make_float4(sa, sa * fast_sigmoid(ra0), sa * fast_sigmoid(ra1),
                           sa * fast_sigmoid(ra2));
        if (okb)
          ob = make_float4(sb, sb * fast_sigmoid(rb0), sb * fast_sigmoid(rb1),
                           sb * fast_sigmoid(rb2));
      } else if constexpr (V::BSH) {
        // bf16 SH shading: the pair's directions as bf16 pairs, the basis
        // in packed bf16 (sh_basis2), each plane times its bf16 scale one
        // __hmul2, then one fused bf16 multiply-add a colour and plane
        const float ycm = ((float)gy + 0.5f) * c.invG - c.cy;
        float xa, ya, za, xb, yb, zb;
        voxel_dir<V>(c, o, ycm, ((float)gx + 0.5f) * c.invG - c.cx, xa, ya,
                     za);
        voxel_dir<V>(c, o, ycm, ((float)(gx + 1) + 0.5f) * c.invG - c.cx, xb,
                     yb, zb);
        __nv_bfloat162 bk[BD];
        sh_basis2<BD>(__floats2bfloat162_rn(xa, xb),
                      __floats2bfloat162_rn(ya, yb),
                      __floats2bfloat162_rn(za, zb), bk);
        __nv_bfloat162 r0 = bpair(0), r1 = r0, r2 = r0;
#pragma unroll
        for (int kk = 0; kk < BD; ++kk) {
          if constexpr (V::OPT) {
            // the basis window: skip the plane's multiply-adds
            if (kk < o.blo || kk > o.bhi) continue;
          }
          const __nv_bfloat162 q = __hmul2(bk[kk], c.qsb[kk]);
          r0 = __hfma2(cell_pair16<V::BF16>(wp + kk * plane, i), q, r0);
          r1 = __hfma2(cell_pair16<V::BF16>(wp + (BD + kk) * plane, i), q,
                       r1);
          r2 = __hfma2(cell_pair16<V::BF16>(wp + (2 * BD + kk) * plane, i),
                       q, r2);
        }
        if (oka)
          oa = make_float4(sa, sa * fast_sigmoid(__low2float(r0)),
                           sa * fast_sigmoid(__low2float(r1)),
                           sa * fast_sigmoid(__low2float(r2)));
        if (okb)
          ob = make_float4(sb, sb * fast_sigmoid(__high2float(r0)),
                           sb * fast_sigmoid(__high2float(r1)),
                           sb * fast_sigmoid(__high2float(r2)));
      } else {
        const int nb = BD;
        const float ycm = ((float)gy + 0.5f) * c.invG - c.cy;
        float bka[BD], bkb[BD];
        voxel_basis<BD, V>(c, o, ycm, ((float)gx + 0.5f) * c.invG - c.cx,
                           bka);
        voxel_basis<BD, V>(c, o, ycm,
                           ((float)(gx + 1) + 0.5f) * c.invG - c.cx, bkb);
        float ra0 = 0.f, ra1 = 0.f, ra2 = 0.f, rb0 = 0.f, rb1 = 0.f,
              rb2 = 0.f;
#pragma unroll
        for (int kk = 0; kk < BD; ++kk) {
          if constexpr (V::OPT) {
            // the basis window and the lobe count: skip the plane's MACs
            if (kk < o.blo || kk > o.bhi || kk >= nb) continue;
          }
          const float q = c.qs[kk];
          const float qa = bka[kk] * q, qb = bkb[kk] * q;
          const float2 c0 = cell_pair<V::BF16>(wp + kk * plane, i);
          const float2 c1 = cell_pair<V::BF16>(wp + (nb + kk) * plane, i);
          const float2 c2 =
              cell_pair<V::BF16>(wp + (2 * nb + kk) * plane, i);
          ra0 += c0.x * qa;
          ra1 += c1.x * qa;
          ra2 += c2.x * qa;
          rb0 += c0.y * qb;
          rb1 += c1.y * qb;
          rb2 += c2.y * qb;
        }
        if (oka)
          oa = make_float4(sa, sa * fast_sigmoid(ra0), sa * fast_sigmoid(ra1),
                           sa * fast_sigmoid(ra2));
        if (okb)
          ob = make_float4(sb, sb * fast_sigmoid(rb0), sb * fast_sigmoid(rb1),
                           sb * fast_sigmoid(rb2));
      }
    }
    out[0] = oa;
    out[1] = ob;
  }
}

// The block's walk over its staged jobs, one per (slab, footprint piece),
// in march order: the windows some pixel's z interval meets (live[wi]),
// their occupied slabs, the pieces of each slab's non-empty tile
// footprint: columns of up to MAX_COLS cells, staged from the 16-byte
// chunk of the payload row that holds the first (cs, payload-relative;
// the piece starts xoff cells into it) over BX cells (whole chunks of CH
// cells of ESZ bytes), and rows as many as the stage (in bytes) and the
// shaded-cell buffer hold (RP). The producer walks it one job ahead of the
// consumer.
template <int CH, int ESZ>
struct Walk {
  int wi, t, sid, py, px;
  float z;
  Footprint f;

  __device__ int cols() const { return min(MAX_COLS, f.x_hi - px + 1); }
  __device__ int cs(const WalkGeo& g) const {
    return (px - g.xlo) & ~(CH - 1);
  }
  __device__ int xoff(const WalkGeo& g) const {
    return (px - g.xlo) & (CH - 1);
  }
  __device__ int BX(const WalkGeo& g) const {
    return (xoff(g) + cols() + CH - 1) & ~(CH - 1);
  }
  __device__ int RP(const WalkGeo& g) const {
    const int bx = BX(g);
    return min(g.stage_bytes / (g.Dp * bx * ESZ), g.chan_cells / bx);
  }
  __device__ int rows(const WalkGeo& g) const {
    return min(RP(g), f.y_hi - py + 1);
  }
  __device__ bool first_piece() const { return py == f.y_lo && px == f.x_lo; }
  __device__ bool last_piece(const WalkGeo& g) const {
    return px + MAX_COLS > f.x_hi && py + RP(g) > f.y_hi;
  }

  __device__ bool from(const WalkGeo& g, int wi0, int t0) {
    for (wi = wi0, t = t0; wi < g.n_win; ++wi, t = 0) {
      if (!g.live[wi]) continue;
      for (; t < g.K; ++t) {
        const int dzi = g.flip ? (g.K - 1 - t) : t;
        if (!((g.m[wi] >> dzi) & 1)) continue;
        sid = g.w[wi] * g.K + dzi;
        z = ((float)sid + 0.5f) / g.Gf + g.zbase;
        f = tile_footprint(g.cyG, g.cxG, z - g.hG - g.cz, z + g.hG - g.cz,
                           g.ujGa, g.ujGb, g.vkGa, g.vkGb, g.G, g.ylo, g.yhi,
                           g.xlo, g.xhi);
        if (f.y_lo > f.y_hi || f.x_lo > f.x_hi) continue;
        py = f.y_lo;
        px = f.x_lo;
        return true;
      }
    }
    return false;
  }

  __device__ bool next(const WalkGeo& g) {
    py += RP(g);
    if (py <= f.y_hi) return true;
    py = f.y_lo;
    px += MAX_COLS;
    if (px <= f.x_hi) return true;
    return from(g, wi, t + 1);
  }
};

// every thread: its share of the walk's current piece into ``st`` as
// 16-byte cp.async copies, stage row ly holding the DP planes of BX cells
// (ESZ bytes each) of payload row py + ly. A thread takes one (plane,
// chunk) column of the piece and walks it down the rows, so each copy
// costs two adds; the caller commits the group. SIG: the stage holds the
// last DP of a slab's SL planes (the depth variant's sigma planes). The
// defaults' addresses keep their expressions, and with them their machine
// code (volrend_torch/probes/display_sass.py: a common slab offset for both
// cases moved the scheduling of every default).
template <int ESZ, bool SIG = false, class W>
__device__ __forceinline__ void copy_piece(const int8_t* payload,
                                           const W& pw, const WalkGeo& g,
                                           uint8_t* st, int tid, int Gy,
                                           int Gx, int y0, const int DP,
                                           const int SL = 0) {
  const int bx = pw.BX(g);
  const int rows = pw.rows(g);
  const size_t plane = (size_t)Gy * Gx;
  const int nch = (bx * ESZ) >> 4;
  const uint8_t* base =
      reinterpret_cast<const uint8_t*>(payload) +
      ((size_t)pw.sid * DP * plane + (size_t)(pw.py - y0) * Gx + pw.cs(g)) *
          ESZ;
  if constexpr (SIG)
    base += ((size_t)pw.sid * (SL - DP) + (SL - DP)) * plane * ESZ;
  const int rstride = DP * bx * ESZ;
  for (int u = tid; u < DP * nch; u += DNT) {
    const int d = u / nch, ch = u - d * nch;
    const uint8_t* src = base + d * plane * ESZ + 16 * ch;
    uint8_t* dst = st + d * bx * ESZ + 16 * ch;
    for (int ly = 0; ly < rows; ++ly) {
      cp_async16(dst, src);
      src += Gx * ESZ;
      dst += rstride;
    }
  }
}

// bf16 shading: each staged plane's scale as a bf16 pair
template <int N>
__device__ __forceinline__ __nv_bfloat162* qsb_smem() {
  __shared__ __nv_bfloat162 s[N];
  return s;
}

// The lobe table's shared memory: LW float4 a lobe, MAX_LOBES of them.
template <int LW>
__device__ __forceinline__ float4* lobe_smem() {
  __shared__ float4 s[LW * MAX_LOBES];
  return s;
}

// A block: one tile of ROWS x 8 rows and 32 columns of one pose; a
// thread owns column k of rows j0 + warp + 8 * rr. V: the payload
// element, format and options; BD: the SH basis dimension, or 1 for the
// other formats and depth.
template <int BD, int ROWS, class V>
__global__ void __launch_bounds__(DNT, 2)
    display_kernel(const LaunchArgs args) {
  const DispArgs& a = args.a;
  // planes staged: compile-time for SH, RGBA and depth (sigma's alone),
  // the lobe count's for SG/ASG
  constexpr int DPC = V::FMT == F_SH     ? 3 * BD + V::SIGP
                      : V::FMT == F_RGBA ? 3 + V::SIGP
                      : V::DEPTH         ? V::SIGP
                                         : 0;
  constexpr int DPMAX = DPC ? DPC : 3 * MAX_LOBES + V::SIGP;
  const int DP = DPC ? DPC : a.Dp;
  constexpr int TY = DWARPS * ROWS;
  using WalkV = Walk<V::CH, V::ESZ>;
  // a shaded cell: [sigma, sigma*r, sigma*g, sigma*b], or sigma alone
  using Cell = std::conditional_t<V::DEPTH, float, float4>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float s_prm[NP];
  __shared__ float s_qs[DPMAX];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int bid = (int)blockIdx.x;
  DClock clk;  // a probe build's (VT_DM_CYCLES); empty otherwise
  const int p = bid % a.P, tile = bid / a.P;  // pose fastest
  const int j0 = (tile / a.ntx) * TY, k0 = (tile % a.ntx) * DTX;
  const int G = a.G, gi = a.gi;
  Cell* s_chan = reinterpret_cast<Cell*>(smem + a.stage_bytes);
  int* s_w = reinterpret_cast<int*>(s_chan + a.chan_cells);
  int* s_m = s_w + a.n_win;
  int* s_live = s_m + a.n_win;

  if (tid < NP) s_prm[tid] = a.params[(size_t)p * NP + tid];
  if constexpr (V::DEPTH) {
    // the staged planes' scales: sigma's, the last SIGP of the payload's
    for (int i = tid; i < DP; i += DNT) s_qs[i] = a.qscale[a.Dp - DP + i];
  } else {
    for (int i = tid; i < DP; i += DNT) s_qs[i] = a.qscale[i];
  }
  for (int i = tid; i < a.n_win; i += DNT) {
    s_w[i] = a.wins[i];
    s_m[i] = a.masks[i];
    s_live[i] = 0;
  }
  OptCtx o{};  // read by the option variants only
  if constexpr (V::OPT && !V::DEPTH) {
    float* s_opt = opt_smem<9>();
#pragma unroll
    for (int r = 0; r < 9; ++r)
      if (tid == r) s_opt[r] = args.rot[r];
    o.rot = args.rot_on ? s_opt : nullptr;
    o.nb = args.nb;
    o.blo = args.blo;
    o.bhi = args.bhi;
  }
  if constexpr (V::LOBES) {
    float4* s_lobe = lobe_smem<V::LW>();
    for (int i = tid; i < args.nb; i += DNT)
      fold_lobe<V::FMT>(args.extra, a.qscale[i], i, args.nb, s_lobe);
    o.lobes = s_lobe;
    o.klo = max(args.blo, 0);
    o.khi = min(args.bhi, args.nb - 1);
  }
  if constexpr (V::OPT) o.bbox = args.bbox;
  const __nv_bfloat162* qsb = nullptr;  // bf16 shading's scales
  if constexpr (V::BSH) {
    __nv_bfloat162* s_qsb = qsb_smem<DPMAX>();
    for (int i = tid; i < DP; i += DNT)
      s_qsb[i] = __float2bfloat162_rn(a.qscale[i]);
    qsb = s_qsb;
  }
  __syncthreads();

  const float Gf = (float)G;
  const float cz = s_prm[0], cy = s_prm[1], cx = s_prm[2];
  const float u0 = s_prm[3], du = s_prm[4], v0 = s_prm[5], dv = s_prm[6];
  const float sigma_thresh = s_prm[14], stop_thresh = s_prm[15];
  const float zbase = s_prm[30];
  const float cyG = cy * Gf, cxG = cx * Gf;
  const float hG = 0.5f / Gf;
  const int K = a.K;
  constexpr bool depth = V::DEPTH;  // the sigma channel alone is warped
  if constexpr (V::OPT) {
    o.lo1 = s_prm[16];
    o.hi1 = s_prm[17];
    o.lo2 = s_prm[18];
    o.hi2 = s_prm[19];
    o.h = hG;
  }

  // this thread's pixels: column k, rows j0 + warp + 8 * rr
  const size_t npx = (size_t)gi * gi;
  const int k = k0 + lane;
  bool inpix[ROWS];
  float zlo[ROWS], zhi[ROWS], dtp[ROWS], ujG[ROWS];
  float r[ROWS], g[ROWS], b[ROWS], T[ROWS];
  float tvb[ROWS];  // depth mode's tview base (zb plane 3)
  float4 w4[ROWS];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int j = j0 + warp + DWARPS * rr;
    inpix[rr] = (j < gi) && (k < gi);
    zlo[rr] = 1.f;  // an empty interval off-grid
    zhi[rr] = 0.f;
    dtp[rr] = 0.f;
    tvb[rr] = 0.f;
    if (inpix[rr]) {
      const float* zbp = a.zb + (size_t)p * 4 * npx + (size_t)j * gi + k;
      zlo[rr] = zbp[0];
      zhi[rr] = zbp[npx];
      dtp[rr] = zbp[2 * npx];
      if constexpr (depth) tvb[rr] = zbp[3 * npx];
    }
    ujG[rr] = (u0 + du * (float)j) * Gf;
    r[rr] = g[rr] = b[rr] = 0.f;
    T[rr] = 1.f;
    if constexpr (V::RESUME) {
      if (inpix[rr]) {
        const float* in = a.acc + (size_t)p * 4 * npx + (size_t)j * gi + k;
        r[rr] = in[0];
        g[rr] = in[npx];
        b[rr] = in[2 * npx];
        T[rr] = in[3 * npx];
      }
    }
    w4[rr] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float vkG = (v0 + dv * (float)k) * Gf;

  // the windows some pixel's z interval meets: only these are staged
  for (int wi = 0; wi < a.n_win; ++wi) {
    const int w = s_w[wi];
    const float zw0 = (float)(w * K) / Gf + zbase;
    const float zw1 = ((float)(w * K) + (float)K) / Gf + zbase;
    bool any = false;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr)
      any |= inpix[rr] && (zlo[rr] <= zhi[rr]) && (zlo[rr] <= zw1) &&
             (zhi[rr] >= zw0);
    if (__ballot_sync(0xffffffffu, any) && lane == 0) s_live[wi] = 1;
  }
  __syncthreads();

  const int jl = min(j0 + TY, gi) - 1, kl = min(k0 + DTX, gi) - 1;
  WalkGeo wg;
  wg.w = s_w;
  wg.m = s_m;
  wg.live = s_live;
  wg.n_win = a.n_win;
  wg.K = K;
  wg.flip = a.flip;
  wg.G = G;
  wg.Dp = DP;
  wg.stage_bytes = a.stage_bytes;
  wg.chan_cells = a.chan_cells;
  wg.ylo = a.y0;
  wg.yhi = a.y0 + a.Gy - 1;
  wg.xlo = a.x0;
  wg.xhi = a.x0 + a.Gx - 1;
  wg.zbase = zbase;
  wg.cz = cz;
  wg.cyG = cyG;
  wg.cxG = cxG;
  wg.hG = hG;
  wg.Gf = Gf;
  wg.ujGa = (u0 + du * (float)j0) * Gf;
  wg.ujGb = (u0 + du * (float)jl) * Gf;
  wg.vkGa = (v0 + dv * (float)k0) * Gf;
  wg.vkGb = (v0 + dv * (float)kl) * Gf;
  WalkV cw;
  bool has = cw.from(wg, 0, 0);

  // the producer: every thread copies its share, one job ahead
  WalkV pw = cw;
  bool p_has = has;
  uint8_t* const st = smem;
  if (a.async) {
    if (p_has) {
      if constexpr (V::DEPTH)
        copy_piece<V::ESZ, true>(a.payload, pw, wg, st, tid, a.Gy, a.Gx,
                                 a.y0, DP, a.Dp);
      else
        copy_piece<V::ESZ>(a.payload, pw, wg, st, tid, a.Gy, a.Gx, a.y0,
                           DP);
      p_has = pw.next(wg);
    }
    cp_async_commit();
    cp_async_wait();
    __syncthreads();
  }
  clk.lap(D_PRO);

  std::conditional_t<V::BSH, ShadeCtxB, ShadeCtx> sh;
  sh.invG = 1.f / Gf;
  sh.cy = cy;
  sh.cx = cx;
  sh.thr = sigma_thresh;
  sh.prm = s_prm;
  sh.qs = s_qs;
  if constexpr (V::BSH) sh.qsb = qsb;
  sh.sc = 0.f;
  sh.ssign = 0.f;

  int cur_wi = -1;
  bool work = false;
  WalkV nxt = cw;  // WALK1: the next job, as the producer walked it
  while (has) {
    if (cw.wi != cur_wi) {
      // a new window: leave when no pixel can still accumulate; skip the
      // window's shading when no live pixel meets it
      cur_wi = cw.wi;
      const int w = s_w[cw.wi];
      const float zw0 = (float)(w * K) / Gf + zbase;
      const float zw1 = ((float)(w * K) + (float)K) / Gf + zbase;
      bool alive_any = false, live_any = false;
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const bool passed = a.flip ? (zw1 < zlo[rr]) : (zw0 > zhi[rr]);
        const bool alive = inpix[rr] && (T[rr] >= stop_thresh) &&
                           (zlo[rr] <= zhi[rr]) && !passed;
        alive_any |= alive;
        live_any |= alive && (zlo[rr] <= zw1) && (zhi[rr] >= zw0);
      }
      if (!__syncthreads_or(alive_any)) break;
      work = __syncthreads_or(live_any);
      // view directions once per window, at the window centre
      sh.sc = ((float)(w * K) + 0.5f * (float)K) / Gf + zbase - cz;
      sh.ssign = sign_of(sh.sc);
      clk.lap(D_BWIN);
      clk.count(DM_WIN);
    }
    const int FY = cw.rows(wg), FX = cw.cols(), BX = cw.BX(wg);
    // the piece's cells are row cells [xoff, xoff + FX) of the stage, from
    // payload column cs (global column x0 + cs + cell)
    const int xoff = cw.xoff(wg), gx0 = a.x0 + cw.cs(wg);
    if (!a.async) {
      // synchronous staging: the piece's rows, lanes along x (the depth
      // variant: the slab's last DP planes, an offset of its own)
      const int cs = cw.cs(wg);
      if constexpr (V::BF16) {
        const uint16_t* src =
            reinterpret_cast<const uint16_t*>(a.payload) +
            (size_t)cw.sid * DP * a.Gy * a.Gx +
            (V::DEPTH
                 ? ((size_t)cw.sid * (a.Dp - DP) + (a.Dp - DP)) * a.Gy * a.Gx
                 : 0);
        uint16_t* st16 = reinterpret_cast<uint16_t*>(st);
        for (int row = warp; row < FY * DP; row += DWARPS) {
          const int ly = row / DP, d = row - ly * DP;
          const int gy = cw.py - a.y0 + ly;
          for (int lx = lane; lx < BX; lx += 32) {
            const int gx = cs + lx;
            st16[row * BX + lx] =
                gx < a.Gx ? src[((size_t)d * a.Gy + gy) * a.Gx + gx]
                          : (uint16_t)0;
          }
        }
      } else {
        const int8_t* src =
            a.payload + (size_t)cw.sid * DP * a.Gy * a.Gx +
            (V::DEPTH
                 ? ((size_t)cw.sid * (a.Dp - DP) + (a.Dp - DP)) * a.Gy * a.Gx
                 : 0);
        for (int row = warp; row < FY * DP; row += DWARPS) {
          const int ly = row / DP, d = row - ly * DP;
          const int gy = cw.py - a.y0 + ly;
          for (int lx = lane; lx < BX; lx += 32) {
            const int gx = cs + lx;
            st[row * BX + lx] =
                gx < a.Gx ? (uint8_t)src[((size_t)d * a.Gy + gy) * a.Gx + gx]
                          : 0;
          }
        }
      }
      __syncthreads();
      clk.lap(D_ISSUE);
    }

    if (work) {
      // two cells a thread: pairs p_lo .. of each row
      const int p_lo = xoff >> 1;
      const int pcols = ((xoff + FX - 1) >> 1) - p_lo + 1;
      const int units = FY * pcols;
      for (int u = tid; u < units; u += DNT) {
        const int ly = u / pcols, x = 2 * (p_lo + u - ly * pcols);
        if constexpr (V::BF16) {
          shade_pair<BD, V>(st + 2 * (ly * DP * BX + x), 2 * BX, 0, sh, o,
                            DP, cw.py + ly, gx0 + x, s_chan + ly * BX + x);
        } else {
          shade_pair<BD, V>(st + ly * DP * BX + (x & ~3), BX, x & 3, sh, o,
                            DP - 1, cw.py + ly, gx0 + x,
                            s_chan + ly * BX + x);
        }
      }
    }
    clk.lap(D_SHADE);
    __syncthreads();  // the stage is consumed, s_chan is complete
    clk.lap(D_BSHADE);
    bool issued = false;  // WALK1: the producer staged the next job
    if (a.async) {
      if (p_has) {
        if constexpr (V::DEPTH)
          copy_piece<V::ESZ, true>(a.payload, pw, wg, st, tid, a.Gy, a.Gx,
                                   a.y0, DP, a.Dp);
        else
          copy_piece<V::ESZ>(a.payload, pw, wg, st, tid, a.Gy, a.Gx, a.y0,
                             DP);
        clk.lap(D_ISSUE);
        if constexpr (V::WALK1) {
          // the producer's piece is the consumer's next job
          nxt = pw;
          issued = true;
        }
        p_has = pw.next(wg);
        clk.lap(D_WALK);
      }
      cp_async_commit();
      clk.lap(D_ISSUE);
    }
    if (work) {
      const float z = cw.z;
      const float s0 = z - hG - cz, s1 = z + hG - cz;
      const bool first = cw.first_piece(), last = cw.last_piece(wg);
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        if (!inpix[rr]) continue;
        if (first) w4[rr] = make_float4(0.f, 0.f, 0.f, 0.f);
        const PixelSpan sp = pixel_span(cyG, cxG, s0, s1, ujG[rr], vkG, G,
                                        cw.f);
        const int ya = max(sp.ry_lo, cw.py);
        const int yb = min(sp.ry_hi, cw.py + FY - 1);
        const int xa = max(sp.rx_lo, cw.px);
        const int xb = min(sp.rx_hi, cw.px + FX - 1);
        float4 acc = w4[rr];
        if constexpr (depth) {
          for (int cyy = ya; cyy <= yb; ++cyy) {
            const float wr = overlap(cyy, G, sp.pmin, sp.pmax, sp.inv_r);
            const float* row = s_chan + (cyy - cw.py) * BX;
            for (int cxx = xa; cxx <= xb; ++cxx)
              acc.x += wr * overlap(cxx, G, sp.qmin, sp.qmax, sp.inv_c) *
                       row[cxx - gx0];
          }
        } else {
          for (int cyy = ya; cyy <= yb; ++cyy) {
            const float wr = overlap(cyy, G, sp.pmin, sp.pmax, sp.inv_r);
            const float4* row = s_chan + (cyy - cw.py) * BX;
            for (int cxx = xa; cxx <= xb; ++cxx) {
              const float wgt =
                  wr * overlap(cxx, G, sp.qmin, sp.qmax, sp.inv_c);
              const float4 v = row[cxx - gx0];
              acc.x += wgt * v.x;
              acc.y += wgt * v.y;
              acc.z += wgt * v.z;
              acc.w += wgt * v.w;
            }
          }
        }
        w4[rr] = acc;
        clk.lap(D_TAPS);
        if (last) {
          // boundary slabs contribute by their overlap with [zlo, zhi]
          const float frac = fminf(
              fmaxf((fminf(z + hG, zhi[rr]) - fmaxf(z - hG, zlo[rr])) * Gf,
                    0.f),
              1.f);
          const float tau = acc.x * dtp[rr] * frac;
          const float att = __expf(-tau);
          if constexpr (depth) {
            // depth: w * |z - z0| * tview (pallas_slab.py's depth mode)
            if (T[rr] >= stop_thresh && tau > 0.f) {
              r[rr] += (T[rr] * (1.f - att)) * fabsf(z - s_prm[29]) *
                       tvb[rr];
              T[rr] = T[rr] * att;
            }
          } else {
            const float sig_inv = 1.f / fmaxf(acc.x, 1e-12f);
            if (T[rr] >= stop_thresh && tau > 0.f) {
              const float wn = (T[rr] * (1.f - att)) * sig_inv;
              r[rr] += wn * acc.y;
              g[rr] += wn * acc.z;
              b[rr] += wn * acc.w;
              T[rr] = T[rr] * att;
            }
          }
        }
        clk.lap(D_COMP);
      }
    }
    clk.count(DM_JOB);
    clk.count(DM_STAGE);
    if (cw.first_piece()) clk.count(DM_SLAB);
    if constexpr (V::WALK1) {
      if (a.async) {
        cw = nxt;
        has = issued;
      } else {
        has = cw.next(wg);
      }
    } else {
      has = cw.next(wg);
    }
    clk.lap(D_WALK);
    if (a.async) cp_async_wait();  // the next job's copies
    clk.lap(D_WAIT);
    __syncthreads();  // ... are in for all threads; s_chan has been read
    clk.lap(D_BEND);
  }
  // a block that leaves early waits for the copies it still has in flight
  if (a.async) asm volatile("cp.async.wait_all;" ::: "memory");

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    if (!inpix[rr]) continue;
    const int j = j0 + warp + DWARPS * rr;
    float* out = a.acc + (size_t)p * 4 * npx + (size_t)j * gi + k;
    out[0] = r[rr];
    out[npx] = g[rr];
    out[2 * npx] = b[rr];
    out[3 * npx] = T[rr];
  }
  clk.store(tid, bid);
}

// ---------------------------------------------------------------------------
// RGBA without options: a kernel of its own for RGBA's chain
// ---------------------------------------------------------------------------
//
// RGBA shades a cell with a sigma decode and three multiplies, so what
// bounds display_kernel's RGBA variant is the chain each job walks (the
// walk, taken by every thread twice, the copies issued by the 15 threads
// of one warp that a 5-plane piece needs, the shade pass and three
// barriers), not bytes or arithmetic (PERF.md: thread 0's loop a job
// 26 % walk, 21 % copy issue, 23 % shading, 19 % taps). This kernel takes
// RGBA launches without a bbox (rot and the basis window do nothing to
// RGBA), on 32x8 tiles:
// - warp-specialized: 8 consumer warps own the tile's pixels and take the
//   taps and composites; a ninth, the producer, walks the tile's pieces
//   (once), issues their copies and describes each piece in shared memory
//   for the consumers, a job ahead of them;
// - the stage is two slots; a job is a run of consecutive pieces (slab
//   footprint pieces, in march order) whose cells fit one slot, up to
//   RG_NJ of them, so one block barrier serves several slabs;
// - no shade pass and no shaded-cell buffer: the taps decode the staged
//   codes of each cell they reach (sigma's two planes or its bf16 plane;
//   under the sigma threshold nothing more, else the three colour codes
//   and their scales), with the arithmetic of shade_pair, so a launch's
//   output is bit-equal to the option variant's where its footprints
//   stage in the same pieces;
// - the window checks are the consumers' alone (a named barrier's OR over
//   their 256 threads); the block's one barrier a job hands the slots
//   over, and a consumer's "no pixel alive" reaches the producer there;
// - MINB blocks an SM: 2, or 3 for a launch of more blocks than two an
//   SM hold at once, in 72 KB of shared memory each
//   (slab_march.display_config). 32x16 tiles (two pixels a thread) were
//   built and measured: at three blocks an SM they spilled (124 bytes a
//   thread), at two they ran 5-7 % slower than 32x8 at three on every
//   whole orbit group and slower on 4 poses and one
//   (probes/display_tiles, PERF.md), so RGBA takes 32x8 alone.

#ifndef VT_RG_NJ
#define VT_RG_NJ 4
#endif
constexpr int RG_NJ = VT_RG_NJ;           // pieces a job at most
constexpr int RG_NT = DNT + 32;           // consumers and the producer warp
constexpr int RG_SMEM3 = 72 * 1024;      // a block's budget at three an SM

// The RGBA kernel's walk: display_kernel's (Walk), with the rows a piece
// takes read from a table of the slot's rows for each count of 16-byte
// chunks a row (``rp``, the same quotient) in place of Walk::RP's two
// integer divisions, which it takes several times a piece.
template <int CH, int ESZ>
struct RgWalk : Walk<CH, ESZ> {
  const int* rp;
  __device__ int RP(const WalkGeo& g) const { return rp[this->BX(g) / CH]; }
  __device__ int rows(const WalkGeo& g) const {
    return min(RP(g), this->f.y_hi - this->py + 1);
  }
  __device__ bool last_piece(const WalkGeo& g) const {
    return this->px + MAX_COLS > this->f.x_hi &&
           this->py + RP(g) > this->f.y_hi;
  }
  __device__ bool next(const WalkGeo& g) {
    this->py += RP(g);
    if (this->py <= this->f.y_hi) return true;
    this->py = this->f.y_lo;
    this->px += MAX_COLS;
    if (this->px <= this->f.x_hi) return true;
    return this->from(g, this->wi, this->t + 1);
  }
};

// A staged piece as the consumers read it: its window, slab, first row
// and column, its slab's footprint, its rows and columns, the stage row's
// cells (BX) and the global column of its first cell, its offset in the
// slot, and whether it is its slab's first and last piece.
struct RgPiece {
  int wi, sid, py, px;
  int y_lo, y_hi, x_lo, x_hi;
  int FY, FX, BX, gx0;
  int off, first, last, pad;
};

// the producer warp's share of piece ``pw`` into ``st`` (rows of DP
// planes of BX cells) as 16-byte cp.async copies: a lane takes (plane,
// chunk) columns (the column's plane by a float reciprocal, exact for
// columns below 2^10) down the piece's rows; the caller commits the group
template <int ESZ, int DP, class W>
__device__ __forceinline__ void rg_copy_async(const int8_t* payload,
                                              const W& pw, const WalkGeo& g,
                                              uint8_t* st, int lane, int Gy,
                                              int Gx, int y0) {
  const int bx = pw.BX(g), rows = pw.rows(g);
  const size_t plane = (size_t)Gy * Gx;
  const int nch = (bx * ESZ) >> 4, cols = DP * nch;
  const float inv = __frcp_rn((float)nch);
  const int rstride = DP * bx * ESZ;
  const uint8_t* base =
      reinterpret_cast<const uint8_t*>(payload) +
      ((size_t)pw.sid * DP * plane + (size_t)(pw.py - y0) * Gx + pw.cs(g)) *
          ESZ;
  for (int cu = lane; cu < cols; cu += 32) {
    const int d = (int)(((float)cu + 0.5f) * inv), ch = cu - d * nch;
    const uint8_t* src = base + (size_t)d * plane * ESZ + 16 * ch;
    uint8_t* dst = st + d * bx * ESZ + 16 * ch;
    for (int ly = 0; ly < rows; ++ly) {
      cp_async16(dst, src);
      src += (size_t)Gx * ESZ;
      dst += rstride;
    }
  }
}

// the same piece by element copies (rows that are not whole 16-byte
// chunks); cells past the payload's row are zero
template <int ESZ, int DP, class W>
__device__ __forceinline__ void rg_copy_sync(const int8_t* payload,
                                             const W& pw, const WalkGeo& g,
                                             uint8_t* st, int lane, int Gy,
                                             int Gx, int y0) {
  using E = std::conditional_t<ESZ == 2, uint16_t, uint8_t>;
  const int bx = pw.BX(g), rows = pw.rows(g), cs = pw.cs(g);
  const E* src = reinterpret_cast<const E*>(payload) +
                 (size_t)pw.sid * DP * Gy * Gx;
  E* dst = reinterpret_cast<E*>(st);
  for (int u = lane; u < rows * DP * bx; u += 32) {
    const int row = u / bx, lx = u - row * bx;
    const int ly = row / DP, d = row - ly * DP;
    const int gx = cs + lx;
    dst[u] = gx < Gx ? src[((size_t)d * Gy + pw.py - y0 + ly) * Gx + gx]
                     : (E)0;
  }
}

// One staged cell's tap (stage row ``row``, cell lx of its BX, planes BX
// cells apart) added to ``acc`` with weight ``wgt``: its sigma decoded,
// and under the threshold nothing added (the shade pass's zero cell adds
// +0, which leaves every sum as it is); else its colours decoded with
// shade_pair's RGBA arithmetic, [sigma, sigma*r, sigma*g, sigma*b].
template <bool BF>
__device__ __forceinline__ void rg_tap(const uint8_t* row, int lx, int BX,
                                       float q0, float q1, float q2,
                                       float qsig, float thr, float wgt,
                                       float4& acc) {
  float s, c0, c1, c2;
  if constexpr (BF) {
    // each bf16 cell to f32 by an exact 16-bit shift
    const uint16_t* p = reinterpret_cast<const uint16_t*>(row) + lx;
    s = __uint_as_float((uint32_t)p[3 * BX] << 16) * qsig;
    if (!(s > thr)) return;
    c0 = __uint_as_float((uint32_t)p[0] << 16);
    c1 = __uint_as_float((uint32_t)p[BX] << 16);
    c2 = __uint_as_float((uint32_t)p[2 * BX] << 16);
  } else {
    const uint8_t* p = row + (lx & ~3);
    const int i = lx & 3;
    s = (code(word(p + 3 * BX), i) * 128.f + code(word(p + 4 * BX), i)) *
        qsig;
    if (!(s > thr)) return;
    c0 = code(word(p), i);
    c1 = code(word(p + BX), i);
    c2 = code(word(p + 2 * BX), i);
  }
  acc.x += wgt * s;
  acc.y += wgt * (s * (c0 * q0));
  acc.z += wgt * (s * (c1 * q1));
  acc.w += wgt * (s * (c2 * q2));
}

// the OR of ``p`` over the 256 consumer threads (named barrier 1; the
// producer warp takes no part)
__device__ __forceinline__ bool consumers_or(bool p) {
  int r;
  asm volatile(
      "{\n\t.reg .pred q, o;\n\t"
      "setp.ne.b32 q, %1, 0;\n\t"
      "bar.red.or.pred o, 1, 256, q;\n\t"
      "selp.b32 %0, 1, 0, o;\n\t}"
      : "=r"(r)
      : "r"((int)p)
      : "memory");
  return r != 0;
}

// The producer warp: the pieces of one job from the walk ``pw`` (while it
// ``has`` one) into the slot ``st``, as many as fit its ``slot_bytes`` up
// to RG_NJ, the lanes copying and lane 0 describing each piece in
// ``job``; commits the copies and returns the job's pieces.
template <int ESZ, int DP, class W>
__device__ __forceinline__ int rg_stage(const DispArgs& a, W& pw, bool& has,
                                        const WalkGeo& g, uint8_t* st,
                                        int slot_bytes, RgPiece* job,
                                        int lane, DClock& clk) {
  int n = 0, used = 0;
  while (has && n < RG_NJ) {
    const int bx = pw.BX(g), rows = pw.rows(g);
    const int bytes = rows * DP * bx * ESZ;  // whole 16-byte rows
    if (used + bytes > slot_bytes) break;
    if (a.async)
      rg_copy_async<ESZ, DP>(a.payload, pw, g, st + used, lane, a.Gy, a.Gx,
                             a.y0);
    else
      rg_copy_sync<ESZ, DP>(a.payload, pw, g, st + used, lane, a.Gy, a.Gx,
                            a.y0);
    clk.lap(D_ISSUE);
    if (lane == 0) {
      RgPiece& d = job[n];
      d.wi = pw.wi;
      d.sid = pw.sid;
      d.py = pw.py;
      d.px = pw.px;
      d.y_lo = pw.f.y_lo;
      d.y_hi = pw.f.y_hi;
      d.x_lo = pw.f.x_lo;
      d.x_hi = pw.f.x_hi;
      d.FY = rows;
      d.FX = pw.cols();
      d.BX = bx;
      d.gx0 = a.x0 + pw.cs(g);
      d.off = used;
      d.first = pw.first_piece();
      d.last = pw.last_piece(g);
    }
    used += bytes;
    ++n;
    has = pw.next(g);
    clk.lap(D_WALK);
  }
  if (a.async) cp_async_commit();
  return n;
}

// A block: one 32x8 tile of one pose, as display_kernel's at one pixel
// row a thread, its pixels the consumers' (thread ``tid`` < 256 owns
// column k0 + lane of row j0 + warp), and the producer warp; BF: the
// bf16 payload (4 planes), else int8 (5); MINB: blocks an SM.
template <bool BF, int MINB>
__global__ void __launch_bounds__(RG_NT, MINB)
    rgba_kernel(const LaunchArgs args) {
  const DispArgs& a = args.a;
  constexpr int ESZ = BF ? 2 : 1, CH = 16 / ESZ;
  constexpr int DP = BF ? 4 : 5;
  using WalkV = RgWalk<CH, ESZ>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float s_prm[NP];
  __shared__ RgPiece s_job[2][RG_NJ];
  __shared__ int s_nj[2];    // each slot's job: its pieces
  // the job of each slot is not to be taken: no consumer pixel can still
  // accumulate (set while the other slot's job is taken, read after the
  // block barrier that ends it)
  __shared__ int s_stop[2];
  __shared__ int s_rp[256 / CH + 1];  // a slot's rows by chunks a row

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int bid = (int)blockIdx.x;
  DClock clk;  // a probe build's (VT_DM_CYCLES); empty otherwise
  const int p = bid % a.P, tile = bid / a.P;  // pose fastest
  const int j0 = (tile / a.ntx) * DWARPS, k0 = (tile % a.ntx) * DTX;
  const int G = a.G, gi = a.gi;
  // two slots of half the stage each, then three ints a window
  const int slot_bytes = (a.stage_bytes >> 1) & ~15;
  int* s_w = reinterpret_cast<int*>(smem + a.stage_bytes);
  int* s_m = s_w + a.n_win;
  int* s_live = s_m + a.n_win;

  if (tid < NP) s_prm[tid] = a.params[(size_t)p * NP + tid];
  for (int i = tid; i < a.n_win; i += RG_NT) {
    s_w[i] = a.wins[i];
    s_m[i] = a.masks[i];
    s_live[i] = 0;
  }
  // Walk::RP's quotient, stage bytes over a row's (BX cells of DP planes)
  if (tid <= 256 / CH) s_rp[tid] = tid ? slot_bytes / (DP * 16 * tid) : 0;
  if (tid < 2) s_stop[tid] = 0;
  __syncthreads();

  const float Gf = (float)G;
  const float cz = s_prm[0], cy = s_prm[1], cx = s_prm[2];
  const float u0 = s_prm[3], du = s_prm[4], v0 = s_prm[5], dv = s_prm[6];
  const float zbase = s_prm[30];
  const float cyG = cy * Gf, cxG = cx * Gf;
  const float hG = 0.5f / Gf;
  const int K = a.K;

  if (warp == DWARPS) {
    // the producer: the tile's walk, a job ahead of the consumers, once
    // the consumers have marked the windows some pixel's z interval meets
    __syncthreads();
    const int jl = min(j0 + DWARPS, gi) - 1, kl = min(k0 + DTX, gi) - 1;
    WalkGeo wg;
    wg.w = s_w;
    wg.m = s_m;
    wg.live = s_live;
    wg.n_win = a.n_win;
    wg.K = K;
    wg.flip = a.flip;
    wg.G = G;
    wg.Dp = DP;
    wg.stage_bytes = slot_bytes;  // a piece fits one slot
    wg.chan_cells = 1 << 30;      // no shaded-cell buffer
    wg.ylo = a.y0;
    wg.yhi = a.y0 + a.Gy - 1;
    wg.xlo = a.x0;
    wg.xhi = a.x0 + a.Gx - 1;
    wg.zbase = zbase;
    wg.cz = cz;
    wg.cyG = cyG;
    wg.cxG = cxG;
    wg.hG = hG;
    wg.Gf = Gf;
    wg.ujGa = (u0 + du * (float)j0) * Gf;
    wg.ujGb = (u0 + du * (float)jl) * Gf;
    wg.vkGa = (v0 + dv * (float)k0) * Gf;
    wg.vkGb = (v0 + dv * (float)kl) * Gf;
    WalkV pw;
    pw.rp = s_rp;
    bool has = pw.from(wg, 0, 0);
    int slot = 0;
    int n = rg_stage<ESZ, DP>(a, pw, has, wg, smem, slot_bytes, s_job[0],
                              lane, clk);
    if (lane == 0) s_nj[0] = n;
    if (a.async) cp_async_wait();
    __syncthreads();  // job 0 is in
    while (s_nj[slot] > 0 && !s_stop[slot]) {
      // the next job, staged while the consumers take this one
      n = has ? rg_stage<ESZ, DP>(a, pw, has, wg,
                                  smem + (slot ^ 1) * slot_bytes,
                                  slot_bytes, s_job[slot ^ 1], lane, clk)
              : 0;
      if (lane == 0) s_nj[slot ^ 1] = n;
      if (a.async) cp_async_wait();  // its copies
      __syncthreads();  // ... are in; this slot has been read
      slot ^= 1;
    }
    return;  // the clock rows are the consumers' (thread 0's)
  }

  const float sigma_thresh = s_prm[14], stop_thresh = s_prm[15];
  const float q0 = a.qscale[0], q1 = a.qscale[1], q2 = a.qscale[2];
  const float qsig = a.qscale[3];

  // this thread's pixel: column k of row j
  const size_t npx = (size_t)gi * gi;
  const int j = j0 + warp, k = k0 + lane;
  const bool inpix = (j < gi) && (k < gi);
  float zlo = 1.f, zhi = 0.f, dtp = 0.f;  // an empty interval off-grid
  if (inpix) {
    const float* zbp = a.zb + (size_t)p * 4 * npx + (size_t)j * gi + k;
    zlo = zbp[0];
    zhi = zbp[npx];
    dtp = zbp[2 * npx];
  }
  const float ujG = (u0 + du * (float)j) * Gf;
  const float vkG = (v0 + dv * (float)k) * Gf;
  float r = 0.f, g = 0.f, b = 0.f, T = 1.f;
  float4 w4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // the windows some pixel's z interval meets: only these are staged
  for (int wi = 0; wi < a.n_win; ++wi) {
    const int w = s_w[wi];
    const float zw0 = (float)(w * K) / Gf + zbase;
    const float zw1 = ((float)(w * K) + (float)K) / Gf + zbase;
    const bool any =
        inpix && (zlo <= zhi) && (zlo <= zw1) && (zhi >= zw0);
    if (__ballot_sync(0xffffffffu, any) && lane == 0) s_live[wi] = 1;
  }
  __syncthreads();  // the live windows, for the producer's walk
  __syncthreads();  // job 0 is in
  clk.lap(D_PRO);

  int slot = 0, cur_wi = -1;
  bool work = false;
  while (s_nj[slot] > 0 && !s_stop[slot]) {
    const int nj = s_nj[slot];
    const uint8_t* st = smem + slot * slot_bytes;
    bool check = true;  // the job's first window checks for a live pixel
    for (int jj = 0; jj < nj; ++jj) {
      const RgPiece& pc = s_job[slot][jj];
      if (pc.wi != cur_wi) {
        // a new window: skip its taps when no live pixel meets it; at the
        // job's first, leave when no pixel can still accumulate (a pixel
        // that cannot at a window cannot at a later one, so until the
        // next job's check the windows find no live pixel, as
        // display_kernel's would, whose check is every window's)
        cur_wi = pc.wi;
        const int w = s_w[pc.wi];
        const float zw0 = (float)(w * K) / Gf + zbase;
        const float zw1 = ((float)(w * K) + (float)K) / Gf + zbase;
        const bool passed = a.flip ? (zw1 < zlo) : (zw0 > zhi);
        const bool alive =
            inpix && (T >= stop_thresh) && (zlo <= zhi) && !passed;
        if (check && !consumers_or(alive)) {
          if (tid == 0) s_stop[slot ^ 1] = 1;
          break;
        }
        check = false;
        work = consumers_or(alive && (zlo <= zw1) && (zhi >= zw0));
        clk.lap(D_BWIN);
        clk.count(DM_WIN);
      }
      clk.count(DM_JOB);
      if (pc.first) clk.count(DM_SLAB);
      if (!work || !inpix) continue;
      const float z = ((float)pc.sid + 0.5f) / Gf + zbase;
      const float s0 = z - hG - cz, s1 = z + hG - cz;
      Footprint f;
      f.y_lo = pc.y_lo;
      f.y_hi = pc.y_hi;
      f.x_lo = pc.x_lo;
      f.x_hi = pc.x_hi;
      const int BX = pc.BX, gx0 = pc.gx0, py = pc.py;
      if (pc.first) w4 = make_float4(0.f, 0.f, 0.f, 0.f);
      const PixelSpan sp = pixel_span(cyG, cxG, s0, s1, ujG, vkG, G, f);
      const int ya = max(sp.ry_lo, py), yb = min(sp.ry_hi, py + pc.FY - 1);
      const int xa = max(sp.rx_lo, pc.px);
      const int xb = min(sp.rx_hi, pc.px + pc.FX - 1);
      const uint8_t* pst = st + pc.off;
      float4 acc = w4;
      for (int cyy = ya; cyy <= yb; ++cyy) {
        const float wr = overlap(cyy, G, sp.pmin, sp.pmax, sp.inv_r);
        const uint8_t* row = pst + (cyy - py) * DP * BX * ESZ;
        for (int cxx = xa; cxx <= xb; ++cxx) {
          const float wgt = wr * overlap(cxx, G, sp.qmin, sp.qmax, sp.inv_c);
          rg_tap<BF>(row, cxx - gx0, BX, q0, q1, q2, qsig, sigma_thresh, wgt,
                     acc);
        }
      }
      w4 = acc;
      clk.lap(D_TAPS);
      if (pc.last) {
        // boundary slabs contribute by their overlap with [zlo, zhi]
        const float frac = fminf(
            fmaxf((fminf(z + hG, zhi) - fmaxf(z - hG, zlo)) * Gf, 0.f), 1.f);
        const float tau = acc.x * dtp * frac;
        const float att = __expf(-tau);
        const float sig_inv = 1.f / fmaxf(acc.x, 1e-12f);
        if (T >= stop_thresh && tau > 0.f) {
          const float wn = (T * (1.f - att)) * sig_inv;
          r += wn * acc.y;
          g += wn * acc.z;
          b += wn * acc.w;
          T = T * att;
        }
      }
      clk.lap(D_COMP);
    }
    clk.lap(D_WAIT);
    __syncthreads();  // the next job is in; this slot has been read
    clk.lap(D_BEND);  // the consumers' wait for the producer
    clk.count(DM_STAGE);
    slot ^= 1;
  }

  if (inpix) {
    float* out = a.acc + (size_t)p * 4 * npx + (size_t)j * gi + k;
    out[0] = r;
    out[npx] = g;
    out[2 * npx] = b;
    out[3 * npx] = T;
  }
  clk.store(tid, bid);
}

using KernFn = void (*)(const LaunchArgs);

// The instantiations: SH (degrees 0-4) without options, and with bf16
// shading and no other option, on both payloads at both tile heights; SH
// with options, SH with bf16 shading and options, RGBA (with options,
// and its kernel of its own, rgba_kernel, at two and three blocks an SM)
// and depth, on both payloads, at 32x8; SG and ASG (1 to 25 lobes at run
// time) on both payloads at both tile heights.
template <int BD, class V>
KernFn pick_rows(int rows) {
  if (rows == 1) return display_kernel<BD, 1, V>;
  if constexpr (!V::OPT) {
    if (rows == 2) return display_kernel<BD, 2, V>;
  }
  return nullptr;
}

template <class V>
KernFn pick_sh(int bd, int rows) {
  switch (bd) {
    case 1: return pick_rows<1, V>(rows);
    case 4: return pick_rows<4, V>(rows);
    case 9: return pick_rows<9, V>(rows);
    case 16: return pick_rows<16, V>(rows);
    case 25: return pick_rows<25, V>(rows);
    default: return nullptr;
  }
}

// The source is built twice (volrend_torch/kernels): VT_DISPLAY_SET 0
// holds every variant above; 1, the resume build
// (slab_march_display_resume), holds the option variants (opt 1, 3 and 5;
// 32x8 tiles) with RS, which a z-segment's launch with an upstream state
// takes (SH without options as the option variant at its defaults), so
// the defaults' code stays as it is.
#ifndef VT_DISPLAY_SET
#define VT_DISPLAY_SET 0
#endif
constexpr bool RS_SET = VT_DISPLAY_SET == 1;

template <class V>
KernFn pick_lobes(int nb, int rows) {
  if (nb < 1 || nb > MAX_LOBES) return nullptr;
  if (rows == 1) return display_kernel<1, 1, V>;
  if constexpr (!RS_SET) {
    if (rows == 2) return display_kernel<1, 2, V>;
  }
  return nullptr;
}

// opt: 0 the defaults (SH; RGBA: rgba_kernel at two blocks an SM, 4 at
// three), 1 the option variants, 2 SH's bf16 shading without another
// option, 3 with options, 5 the depth variant (any format)
template <bool BF>
KernFn pick_payload(int bd, int rows, int fmt, int opt) {
  if (opt == 2) {
    if constexpr (RS_SET) return nullptr;
    else
      return fmt == F_SH ? pick_sh<Var<BF, F_SH, false, true>>(bd, rows)
                         : nullptr;
  }
  if (opt == 5)
    return rows == 1 ? display_kernel<1, 1, Var<BF, F_DEPTH, true, false,
                                                 RS_SET>>
                     : nullptr;
  if (opt == 3)
    return fmt == F_SH
               ? pick_sh<Var<BF, F_SH, true, true, RS_SET>>(bd, rows)
               : nullptr;
  if ((opt == 0 || opt == 4) && fmt == F_RGBA) {
    // RGBA without a bbox: rgba_kernel (32x8 tiles), two blocks an SM
    // (opt 0) or three (opt 4)
    if constexpr (RS_SET) return nullptr;
    if (rows != 1) return nullptr;
    return opt ? rgba_kernel<BF, 3> : rgba_kernel<BF, 2>;
  }
  if (opt != 0 && opt != 1) return nullptr;
  if (fmt == F_SH) {
    if (opt) return pick_sh<Var<BF, F_SH, true, false, RS_SET>>(bd, rows);
    if constexpr (RS_SET) return nullptr;
    else return pick_sh<Var<BF, F_SH, false>>(bd, rows);
  }
  if (!opt) return nullptr;
  switch (fmt) {
    case F_SG:
      return pick_lobes<Var<BF, F_SG, true, false, RS_SET>>(bd, rows);
    case F_ASG:
      return pick_lobes<Var<BF, F_ASG, true, false, RS_SET>>(bd, rows);
    case F_RGBA:
      return rows == 1
                 ? display_kernel<1, 1, Var<BF, F_RGBA, true, false, RS_SET>>
                 : nullptr;
    default: return nullptr;
  }
}

// the kernel of (bd, rows, fmt, bf16, opt); null when none is built
const void* pick_any(int bd, int rows, int fmt, int bf16, int opt) {
  return bf16 ? (const void*)pick_payload<true>(bd, rows, fmt, opt)
              : (const void*)pick_payload<false>(bd, rows, fmt, opt);
}

// Let ``fn`` take ``smem`` bytes of dynamic shared memory; the attribute is
// set again only when a kernel's size changes (one host call saved a
// launch, which counts for one-pose launches).
cudaError_t allow_smem(const void* fn, int smem) {
  static const void* fns[128];
  static int sizes[128];
  static int n = 0;
  int i = 0;
  while (i < n && fns[i] != fn) ++i;
  if (i < n && sizes[i] == smem) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && i < 128) {
    fns[i] = fn;
    sizes[i] = smem;
    if (i == n) ++n;
  }
  return e;
}

// The dynamic shared memory of a launch (slab_march.display_config): the
// stage, the shaded cells (a float4 each, the depth variant's a float;
// none for rgba_kernel, ``raw``), three ints a window.
int display_smem(int stage_bytes, int chan_cells, int n_win, bool depth,
                 bool raw) {
  return stage_bytes + (raw ? 0 : (depth ? 4 : 16) * chan_cells) +
         12 * n_win;
}

}  // namespace

// wins_masks: (2, n_win) int32 on the device — window ids then occupancy bit
// masks, in march order. acc: the (P, 4, gi, gi) [r, g, b, T] output; in the
// resume build it holds on entry the state each pixel starts from (a
// z-segment's upstream segments'; the payload a z-segment of the grid whose
// global z is params[30]), and only opt 1, 3 and 5 are built there. rows:
// pixel rows a thread (1: 32x8 tiles, 2: 32x16). stage_bytes: the stage's
// size (a multiple of 16, at least one 256-cell row of the staged planes: Dp,
// or the depth variant's sigma planes); chan_cells: the shaded-cell buffer's
// cells (>= 256). A payload whose rows are whole 16-byte chunks of a 16-byte
// aligned base is staged with cp.async, any other with element copies. The
// variant: fmt (0 RGBA, bd = -1; 1 SH; 2 SG, 3 ASG with bd lobes, 1 to 25,
// whose parameters ``extra`` holds on the device), bf16 (the f16 bake's
// payload, Dp = D; else int8, Dp = D + 1) and opt (0: SH's defaults, or
// RGBA without a bbox through rgba_kernel at two blocks an SM, whose stage
// is two slots and which takes no shaded-cell buffer (chan_cells is not
// read), 4 the same at three blocks an SM (in at most RG_SMEM3); 1: the
// option variant, which SG, ASG and RGBA with a bbox need, and SH with
// rot (9 floats on the host), bbox (params 16-19), a basis window
// [basis_lo, basis_hi] that drops planes; 2: SH's bf16-shading variant
// without options, 3: with the same options; 5, with
// ``depth`` set and only then: the depth variant of any format, which takes
// the bbox). Returns cudaGetLastError() after the launch.
extern "C" int vt_march_display(const void* payload, const void* params,
                                const void* qscale, const void* zb,
                                const void* wins_masks, int n_win, void* acc,
                                int P, int G, int gi, int Dp, int Gy, int Gx,
                                int y0, int x0, int bd, int K, int flip,
                                int rows, int stage_bytes, int chan_cells,
                                int fmt, int bf16, int opt, const void* extra,
                                int depth, int rot_on, const void* rot,
                                int bbox, int basis_lo, int basis_hi,
                                void* stream) {
  const int esz = bf16 ? 2 : 1, sigp = bf16 ? 1 : 2;
  const int D = fmt == F_RGBA ? 4 : 3 * bd + 1;
  const bool cuts = fmt == F_SH && (basis_lo > 0 || basis_hi < bd - 1);
  const bool dvar = opt == 5;  // the depth variant stages sigma alone
  // RGBA without a bbox (rot and the basis window do nothing to RGBA):
  // rgba_kernel, two slots of stage and no shaded-cell buffer
  const bool raw = (opt == 0 || opt == 4) && fmt == F_RGBA;
  if ((fmt == F_RGBA) != (bd < 0) || Dp != D - 1 + sigp || P < 1 ||
      gi < 1 || K < 1 || n_win < 1 || Dp > 256 || stage_bytes % 16 ||
      stage_bytes < (raw ? 2 : 1) * (dvar ? sigp : Dp) * 256 * esz ||
      (!raw && chan_cells < 256) || dvar != (depth != 0) ||
      (raw && bbox) ||
      ((opt == 0 || opt == 2) && !raw &&
       (fmt != F_SH || rot_on || bbox || cuts)) ||
      (rot_on && !rot) || (fmt >= F_SG && (!extra || bd > MAX_LOBES)))
    return (int)cudaErrorInvalidValue;
  // cp.async moves whole 16-byte chunks of 16-byte aligned rows
  const bool async = (Gx * esz) % 16 == 0 && (uintptr_t)payload % 16 == 0;
  const void* fn = pick_any(bd, rows, fmt, bf16, opt);
  if (!fn) return (int)cudaErrorInvalidValue;
  const int ntx = (gi + DTX - 1) / DTX;
  const int nty = (gi + DWARPS * rows - 1) / (DWARPS * rows);
  const long long blocks = (long long)P * ntx * nty;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = display_smem(stage_bytes, chan_cells, n_win, dvar, raw);
  if (smem > (opt == 4 ? RG_SMEM3 : SMEM_MAX))
    return (int)cudaErrorInvalidValue;
  const int* wins = (const int*)wins_masks;
  LaunchArgs v;
  DispArgs& a = v.a;
  a.payload = (const int8_t*)payload;
  a.params = (const float*)params;
  a.qscale = (const float*)qscale;
  a.zb = (const float*)zb;
  a.wins = wins;
  a.masks = wins + n_win;
  a.acc = (float*)acc;
  a.n_win = n_win;
  a.P = P;
  a.G = G;
  a.gi = gi;
  a.Dp = Dp;
  a.Gy = Gy;
  a.Gx = Gx;
  a.y0 = y0;
  a.x0 = x0;
  a.K = K;
  a.flip = flip;
  a.stage_bytes = stage_bytes;
  a.chan_cells = chan_cells;
  a.async = async ? 1 : 0;
  a.ntx = ntx;
  v.extra = (const float*)extra;
  v.nb = fmt == F_RGBA ? 1 : bd;
  v.depth = depth;
  v.rot_on = rot_on;
  v.bbox = bbox;
  v.blo = basis_lo;
  v.bhi = basis_hi;
  for (int i = 0; i < 9; ++i)
    v.rot[i] = rot_on ? ((const float*)rot)[i] : (i % 4 == 0 ? 1.f : 0.f);
  const cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  ((KernFn)fn)<<<(unsigned)blocks, raw ? RG_NT : DNT, smem,
                 (cudaStream_t)stream>>>(v);
  return (int)cudaGetLastError();
}

// What the card makes of the variant (bd, rows, fmt, bf16, opt as for
// vt_march_display; opt 5 the depth variant) at ``smem`` bytes of dynamic
// shared memory: out[0] resident blocks per SM, out[1] registers a thread,
// out[2] local (spill) bytes a thread, out[3] static shared bytes.
extern "C" int vt_march_display_info(int bd, int rows, int fmt, int bf16,
                                     int opt, int smem, int* out) {
  const void* fn = pick_any(bd, rows, fmt, bf16, opt);
  if (!fn || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  const bool raw = (opt == 0 || opt == 4) && fmt == F_RGBA;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn,
                                                    raw ? RG_NT : DNT, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes at;
  e = cudaFuncGetAttributes(&at, fn);
  if (e != cudaSuccess) return (int)e;
  out[1] = at.numRegs;
  out[2] = (int)at.localSizeBytes;
  out[3] = (int)at.sharedSizeBytes;
  return 0;
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#ifdef VT_DM_CYCLES
// A probe build's clock (DClock): copy the rows of blocks [0, n) to
// ``out`` (host, n x DM_SLOTS counters: the parts, the loop's cycles,
// jobs, slabs, windows, stages) and clear them. Returns a CUDA error code.
extern "C" int vt_display_cycles(unsigned long long* out, int n) {
  if (n < 0 || n > DM_BLOCKS) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)n * DM_SLOTS * sizeof(unsigned long long);
  cudaError_t e = cudaMemcpyFromSymbol(out, dm_cycles, bytes);
  if (e != cudaSuccess) return (int)e;
  void* dst = nullptr;
  e = cudaGetSymbolAddress(&dst, dm_cycles);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemset(dst, 0, bytes);
}
#endif
