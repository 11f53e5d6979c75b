// Kernel M-bwd: the payload cotangent of the training-mode slab march, for
// Hopper (sm_90a).
//
// Replaces volrend_tpu/ops/pallas_slab.py:_make_bwd_kernel, the Pallas TPU
// kernel behind pallas_slab.march_slabs_bwd (its plain PyTorch twin is
// volrend_torch/ops/slab_march.py:march_slabs_bwd_ref).
//
// What it computes, for one pose: the gradient of the march's output
// acc (4, gi, gi) = [r, g, b, T] with respect to the payload, given the
// upstream cotangent gacc = [g_r, g_g, g_b, g_T]. It re-marches the slabs
// in forward order carrying per pixel (T, A) from an initial state (1, 0
// for the whole grid) and applies the suffix-reconstruction algebra of
// ops/grad.py:
//   ctot = sum_c gacc_c * acc_c,    gT = gacc_3 * acc_3 (precomputed aux)
//   A   += w * G_pix,               G_pix = sum_c gacc_c * rgb_w_c
//   g_tau    = m * (T * att * G_pix - (ctot - A) - gT)
//   g_srgb_w = gacc_c * w / sig_w
//   g_sig_w  = g_tau * dt - [sig_w >= 1e-12] sum_c gacc_c w srgb_w_c / sig_w^2
// then the transposed box-overlap warp onto the slab's voxels and the shade
// adjoint (sigmoid' times the basis: SH, or SG/ASG lobes, rotated by rot,
// zero outside the basis window; RGBA's raw colours get g_srgb * sigma;
// sigma masked by the threshold and the bbox), in the variants of kernel
// M's training mode (slab_march.cu: march_kernel<V, PT>, built as three
// libraries from one source).
//
// Its input is what kernel M's training mode marched: the bake's tensor
// seen as the (Gz, D, G, G) view of the pose group's permutation (f32 or
// bf16, rounded to bf16 as it is read); its output, the cotangent, is
// written through the same strides, f32 or bf16, so that autograd's
// permute backward hands the bake a gradient in its own contiguous layout
// (each voxel's D values one record).
//
// What bounds it on the H100: the bytes. The function writes the whole
// cotangent once (256^3 x 28 x 4 B = 1.88 GB at SH9 in f32, ~0.56 ms at
// 3.35 TB/s) and reads what the forward reads; its operations (the forward
// recompute, ~110 fp32 operations per shaded voxel and ~60 per pixel and
// slab, and the adjoint, about as many again) are fewer. The kernel this
// one replaced took 1.958 ms on the training bench (PERF.md; pass 1 0.990
// and pass 2 0.800 ms in a profiled step): pass 1 walked every slab a tile
// meets through one synchronous chain each.
//
// Design:
// - Pass 1 (bwd_march_kernel; the option variants' bwd_march_opt) runs
//   kernel M's slab loop (tmarch::march_loop in slab_common.cuh: the
//   tile's slab range, the pieces the forward's coarse occupancy marks,
//   the staged sigma ring, the empty-piece skip, the colour records queued
//   ahead, the same shading and tap sums), so T
//   follows the forward's trajectory float for float. The skip is exact
//   here too: a slab with no cell above the threshold gives w = 0 and
//   g_tau = 0, leaves A and T as they are, and has zero cotangents. After
//   each slab it computes the pixel's four pixel-space cotangents
//   [g_sig_w, g_srgb_w x 3] and transposes the warp onto the slab's
//   footprint, a piece at a time: each pixel adds its four cotangents,
//   times its overlap weights, onto its span's cells of the piece with
//   shared-memory atomics. The block then adds the piece's nonzero cells
//   into gbuf, (G^3, 4) f32 in the payload's voxel order, with global
//   atomics: neighbouring tiles' footprints overlap by a few cells, so a
//   cell collects several tiles' sums, in an order that varies from run to
//   run; the result agrees with the plain version to f32 rounding (the
//   tolerance is stated in chip_smoke.py and tests/test_torch_cuda.py).
// - Pass 2 (bwd_shade_kernel; the option variants' bwd_shade_opt) walks
//   the voxels in the payload's memory order, 128 a block: it reads the
//   four voxel cotangents as one float4, recomputes sigma and rgb at the
//   slab's view direction for the voxels with a nonzero one and sigma
//   above the threshold (the record read as float4 where it is f32 and
//   16-byte aligned), turns them into the D record values (zeros
//   elsewhere), and writes the block's records as one contiguous run with
//   16-byte stores: ~0.75 ms against the 0.56 ms write.
// - SG and ASG (the lobe count at run time): both passes shade from a lobe
//   table each block folds once (fold_lobe in slab_common.cuh, shared with
//   the display mode: log2(e) and 1/nb folded in, SG one float4 a lobe,
//   ASG three) and stream the lobes one at a time into the colour sums
//   (tmarch::lobe_sums), no basis array live. Pass 2 reads a voxel's
//   record whole (float4 loads where it is f32 and 16-byte aligned,
//   aligned words for bf16) into the voxel's own output row, stashes each
//   lobe's value over its plane-0 value as the sums take it, and writes
//   the record's cotangent from the stash, planes 2 and 1 first and plane
//   0 last, over its own stash; its zero rows are 16-byte stores where the
//   record is a whole number of float4. Evaluated as the reference writes it
//   (each lobe's raw parameters re-read from shared memory for every
//   cell, the record one scalar at a time, a basis array live across the
//   sums), SG9 took 0.44 ms a launch more than SH9 on the training bench:
//   pass 2 0.31 of it, most of that its zero rows' scalar stores (four-way
//   bank conflicts at D = 28), and pass 1 spilled 136 bytes a thread (ASG
//   256; PERF.md).
// - The option variants (SH with rot, a basis window or a bbox; RGBA; SG;
//   ASG) have pass kernels of their own that declare the blocks an SM they
//   run (bwd_march_opt, bwd_shade_opt), so the compiler keeps their
//   registers without spills; their options are loaded with constant
//   indices (a run-time index copied the kernel's option arguments to
//   local memory in every block of pass 2). SH with options reads a record
//   whole in both passes (load_record: float4 for f32) and applies the
//   basis window as a mask on the basis. With the arguments copied, the
//   records read a value at a time and the compiler's own register
//   budget, SH9's option variants took 1.50-1.52 ms against SH9's 1.20
//   (pass 2 1.00 against 0.76); passing over footprint pieces whose coarse
//   occupancy is empty in pass 1's flush (their cotangent is zero) ran
//   slower, SH9-rot 1.2405 ms with it and 1.2123 without (PERF.md).
// - RGBA with an f32 cotangent has no pass 2: its record cotangent is
//   linear in the voxel's four sums, with coefficients from its own record
//   (g_c sigma qs[c]; (g_sigma + sum_c g_c rgb_c) qs[3]), so pass 1 maps
//   each flushed cell's sums through the record and adds them into the
//   zeroed cotangent with one 16-byte atomic (direct_flush): the 256 MiB
//   sum buffer, its fill and pass 2's reads and writes go (0.85 ms at G =
//   256 before, pass 2 0.40 of it). A bf16 cotangent keeps the sum buffer
//   and pass 2, so that it is the f32 sum rounded once.

#include "slab_common.cuh"

namespace {

constexpr int NT2 = 128;  // pass 2: voxels a block


struct BwdArgs {
  tmarch::PayView pv;
  const float* params;
  const float* qscale;
  const float* zb;
  const float* gacc;
  const float* aux;
  const int* ids;
  const unsigned long long* occ;
  float* gbuf;
  unsigned long long* counts;
  long long vs, vr, vc;  // voxel strides (element strides / D)
  int n_ids, G, gi, flip;
};

// RGBA's cotangent of voxel (sid, gy, gx), written by pass 1 (DIRECT): the
// record's cotangent is linear in the cell's four sums ``v`` = [g_sigma_w,
// g_srgb_w x 3] with coefficients from the voxel's own record, so each
// tile's sums are mapped as pass 2 maps their total, [v_c sigma qs[c]] and
// (v_sigma + sum_c v_c rgb_c) qs[3] (rgb_c = rec[c] qs[c]: raw colours), and
// added into the cotangent's record ``cell`` (f32, 16-byte aligned: the
// payload's strides) with one 16-byte atomic; a voxel under the threshold
// or outside the bbox gets none (its cotangent stays zero).
template <class V, typename PT>
__device__ __forceinline__ void direct_flush(
    const tmarch::ArgsOf<V, BwdArgs>& a, const tmarch::TrainOpt& opt,
    const float* qs, float sigma_thresh, float Gf, int sid, int gy, int gx,
    float4 v, float* cell) {
  static_assert(V::FMT == F_RGBA, "only RGBA's cotangent is linear");
  float r[4];
  tmarch::load_record<4, PT>(
      reinterpret_cast<const PT*>(a.pv.ptr) + (long long)sid * a.pv.ss +
          (long long)gy * a.pv.sr + (long long)gx * a.pv.sc,
      r);
  const float sigma = r[3] * qs[3];
  if (!(sigma > sigma_thresh) || !tmarch::in_box<V>(opt, Gf, gy, gx)) return;
  const float c0 = r[0] * qs[0], c1 = r[1] * qs[1], c2 = r[2] * qs[2];
  const float gsig = v.x + v.y * c0 + v.z * c1 + v.w * c2;
  atomicAdd(reinterpret_cast<float4*>(cell),
            make_float4(v.y * sigma * qs[0], v.z * sigma * qs[1],
                        v.w * sigma * qs[2], gsig * qs[3]));
}

// Pass 1 of variant V (bwd_march_kernel, bwd_march_opt). DIRECT (RGBA
// with an f32 cotangent, in gbuf, which is then the cotangent itself): the
// flush maps each cell's sums through the cell's record into the voxel's
// cotangent (direct_flush), and no pass 2 follows.
template <class V, typename PT, bool DIRECT = false>
__device__ __forceinline__ void bwd_march(
    const tmarch::ArgsOf<V, BwdArgs>& a) {
  using tmarch::NT;
  using tmarch::PS;
  using tmarch::TX;
  using tmarch::TY;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_prm[NP];
  __shared__ float s_qs[V::DMAX];
  __shared__ tmarch::MarchStatic s_st;

  // the tile's pixels belong to the block's first TY * TX threads, one
  // each; every thread stages and shades cells
  const int tid = threadIdx.x;
  const bool owner = tid < TY * TX;
  const int j0 = blockIdx.y * TY, k0 = blockIdx.x * TX;
  const int j = j0 + (owner ? tid / TX : 0), k = k0 + (owner ? tid % TX : 0);
  const int gi = a.gi, G = a.G;

  tmarch::TrainOpt opt{};  // the option variants' (their arguments' va)
  if constexpr (V::OPT) opt = tmarch::load_opt<V, NT>(a.va, a.qscale, tid);
  const int D = tmarch::rec_dim<V>(opt);
  for (int i = tid; i < NP; i += NT) s_prm[i] = a.params[i];
  for (int i = tid; i < D; i += NT) s_qs[i] = a.qscale[i];
  __syncthreads();
  tmarch::set_box<V>(opt, s_prm);

  tmarch::MarchCtx c;
  c.pv = a.pv;
  c.ids = a.ids;
  c.occ = a.occ;
  c.occ_rows = (G + tmarch::OCC - 1) / tmarch::OCC;
  c.occ_words = tmarch::occ_words(G);
  c.n_ids = a.n_ids;
  c.G = G;
  c.y0 = 0;
  c.x0 = 0;
  c.yend = G - 1;
  c.xend = G - 1;
  c.flip = a.flip;
  c.Gf = (float)G;
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
  // per pixel: z interval, slab thickness, upstream cotangent, the aux
  // planes [ctot, T_end * g_T] and the incoming (T, A) state
  float dtp = 0.f;
  float ga0 = 0.f, ga1 = 0.f, ga2 = 0.f, ctot = 0.f, gT = 0.f;
  float T = 1.f, A = 0.f;
  c.zlo = 1.f;
  c.zhi = 0.f;
  if (c.inpix) {
    c.zlo = a.zb[pix];
    c.zhi = a.zb[npx + pix];
    dtp = a.zb[2 * npx + pix];
    ga0 = a.gacc[pix];
    ga1 = a.gacc[npx + pix];
    ga2 = a.gacc[2 * npx + pix];
    ctot = a.aux[pix];
    gT = a.aux[npx + pix];
    T = a.aux[2 * npx + pix];
    A = a.aux[3 * npx + pix];
  }

  const tmarch::MarchSmem sm = tmarch::carve(smem, s_st);

  const float Gf = c.Gf, hG = c.hG, zlo = c.zlo, zhi = c.zhi;
  const float stop_thresh = c.stop_thresh;
  const bool inpix = c.inpix;
  tmarch::march_loop<V, PT>(
      c, sm, s_qs, s_prm, opt, T, a.counts,
      [&](const tmarch::Job& jb, const PixelSpan& sp, float4 w4) {
        const float sw = w4.x, rw = w4.y, gw = w4.z, bw = w4.w;
        const float z = jb.z;
        // ---- pixel-space cotangents (suffix algebra) ---------------------
        float gs0 = 0.f, gs1 = 0.f, gs2 = 0.f, gs3 = 0.f;
        if (inpix) {
          const float frac = fminf(
              fmaxf((fminf(z + hG, zhi) - fmaxf(z - hG, zlo)) * Gf, 0.f),
              1.f);
          const float dt = dtp * frac;
          const float tau = sw * dt;
          const float att = expf(-tau);
          const float sig_inv = 1.f / fmaxf(sw, 1e-12f);
          const bool m = (T >= stop_thresh) && (tau > 0.f);
          const float w = m ? T * (1.f - att) : 0.f;
          const float G_pix = ga0 * (rw * sig_inv) + ga1 * (gw * sig_inv) +
                              ga2 * (bw * sig_inv);
          A = A + w * G_pix;
          const float g_tau = m ? (T * att * G_pix - (ctot - A) - gT) : 0.f;
          const float sum_term = ga0 * w * rw + ga1 * w * gw + ga2 * w * bw;
          gs0 = g_tau * dt -
                ((sw >= 1e-12f) ? sum_term * sig_inv * sig_inv : 0.f);
          gs1 = ga0 * w * sig_inv;
          gs2 = ga1 * w * sig_inv;
          gs3 = ga2 * w * sig_inv;
          if (m) T = T * att;
        }
        const bool has_g =
            inpix && (gs0 != 0.f || gs1 != 0.f || gs2 != 0.f || gs3 != 0.f);
        if (!__syncthreads_or(has_g)) return;

        // ---- adjoint warp onto the footprint, then into gbuf -------------
        const Footprint& f = jb.f;
        const long long vbase = (long long)jb.sid * a.vs;
        for (int py0 = f.y_lo; py0 <= f.y_hi; py0 += PS) {
          const int FY = min(PS, f.y_hi - py0 + 1);
          for (int px0 = f.x_lo; px0 <= f.x_hi; px0 += PS) {
            const int FX = min(PS, f.x_hi - px0 + 1);
            __syncthreads();  // the previous piece has been read
            for (int i = tid; i < FY * FX; i += NT)
              sm.chan[i] = make_float4(0.f, 0.f, 0.f, 0.f);
            __syncthreads();
            if (has_g) {
              const int ya = max(sp.ry_lo, py0);
              const int yb = min(sp.ry_hi, py0 + FY - 1);
              const int xa = max(sp.rx_lo, px0);
              const int xb = min(sp.rx_hi, px0 + FX - 1);
              for (int cyy = ya; cyy <= yb; ++cyy) {
                const float wr = overlap(cyy, G, sp.pmin, sp.pmax, sp.inv_r);
                float4* row = sm.chan + (cyy - py0) * FX - px0;
                for (int cxx = xa; cxx <= xb; ++cxx) {
                  const float wgt =
                      wr * overlap(cxx, G, sp.qmin, sp.qmax, sp.inv_c);
                  if (wgt == 0.f) continue;
                  atomicAdd(&row[cxx].x, wgt * gs0);
                  atomicAdd(&row[cxx].y, wgt * gs1);
                  atomicAdd(&row[cxx].z, wgt * gs2);
                  atomicAdd(&row[cxx].w, wgt * gs3);
                }
              }
            }
            __syncthreads();
            for (int i = tid; i < FY * FX; i += NT) {
              const int ly = i / FX, lx = i - ly * FX;
              const int gy = py0 + ly, gx = px0 + lx;
              const float4 v = sm.chan[i];
              if (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f)
                continue;
              float* cell =
                  a.gbuf + 4 * (vbase + (long long)gy * a.vr +
                                (long long)gx * a.vc);
              if constexpr (DIRECT) {
                direct_flush<V, PT>(a, opt, s_qs, c.sigma_thresh, Gf, jb.sid,
                                    gy, gx, v, cell);
                continue;
              }
              if (v.x != 0.f) atomicAdd(cell, v.x);
              if (v.y != 0.f) atomicAdd(cell + 1, v.y);
              if (v.z != 0.f) atomicAdd(cell + 2, v.z);
              if (v.w != 0.f) atomicAdd(cell + 3, v.w);
            }
          }
        }
      });
}

// Pass 1's kernels. The SH defaults declare the block's threads alone,
// and the compiler sets their register budget (their registers are
// pinned). The option variants (SH with options, RGBA, SG, ASG) also
// declare the blocks an SM their shared memory allows
// (tmarch::smem_blocks), at most four: left to its own budget the
// compiler cut them to 96 registers and spilled (SG/ASG 104-224 bytes a
// thread); with one block declared it took more registers than the bf16
// payload's four blocks an SM leave; and five blocks (bound 4 on bf16, and
// RGBA: 96 registers) spilled and ran slower than four (PERF.md).
template <class V, typename PT>
constexpr int pass1_blocks() {
  return tmarch::smem_blocks<V, PT>() < 4 ? tmarch::smem_blocks<V, PT>() : 4;
}

template <class V, typename PT>
__global__ void __launch_bounds__(tmarch::NT)
bwd_march_kernel(const tmarch::ArgsOf<V, BwdArgs> a) {
  bwd_march<V, PT>(a);
}

template <class V, typename PT, bool DIRECT>
__global__ void __launch_bounds__(tmarch::NT, pass1_blocks<V, PT>())
bwd_march_opt(const tmarch::ArgsOf<V, BwdArgs> a) {
  bwd_march<V, PT, DIRECT>(a);
}

// An SG or ASG voxel's record cotangent in its own row ``o`` (D floats):
// the record read whole into the row (record_row), the lobes streamed into
// the colour sums (lobe_sums over the row, scaled a plane each by qs[k]),
// each lobe's value stashed over its plane-0 value (zero outside the basis
// window); then sigma's slot, and from the stash o[c nb + k] = graw[c]
// b_k qs[c nb + k], planes 2 and 1 first and plane 0 last, over its own
// stash. No basis array is kept.
template <class V, typename PT>
__device__ __forceinline__ void lobe_adjoint(const PT* rec,
                                             const tmarch::TrainOpt& opt,
                                             const float* qs,
                                             const float* prm, float ycm,
                                             float xcm, float sd, float4 g,
                                             float sigma, int D, float* o) {
  tmarch::record_row<PT>(rec, D, o);
  const int nb = opt.nb;
  for (int k = 0; k < opt.klo; ++k) o[k] = 0.f;
  for (int k = opt.khi + 1; k < nb; ++k) o[k] = 0.f;
  const float3 r = tmarch::lobe_sums<V, true>(o, opt, prm, ycm, xcm, sd,
                                              sign_of(sd), qs, o);
  const float c0 = sigmoid(r.x), c1 = sigmoid(r.y), c2 = sigmoid(r.z);
  o[D - 1] = (g.x + g.y * c0 + g.z * c1 + g.w * c2) * qs[D - 1];
  const float gr0 = g.y * sigma * c0 * (1.f - c0);
  const float gr1 = g.z * sigma * c1 * (1.f - c1);
  const float gr2 = g.w * sigma * c2 * (1.f - c2);
  for (int k = 0; k < nb; ++k) {
    const float b = o[k];
    o[2 * nb + k] = gr2 * b * qs[2 * nb + k];
    o[nb + k] = gr1 * b * qs[nb + k];
    o[k] = gr0 * b * qs[k];
  }
}

// An SH-with-options or RGBA voxel's record cotangent in its own row ``o``
// (V::DMAX floats), false where the voxel is masked out of the forward
// (under the sigma threshold or outside the bbox: its cotangent is zero
// whatever reached it). The record is read whole (load_record: float4
// loads for f32) and shaded as the march shades it (voxel_rgb_opt).
template <class V, typename PT>
__device__ __forceinline__ bool opt_adjoint(const PT* rec,
                                            const tmarch::TrainOpt& opt,
                                            const float* qs, const float* prm,
                                            int G, long long v, long long vs,
                                            long long vr, long long vc,
                                            float4 g, float* o) {
  constexpr int D = V::DMAX, BD = V::BD;
  float vals[D];
  tmarch::load_record<D, PT>(rec, vals);
  const float sigma = vals[D - 1] * qs[D - 1];
  if (!(sigma > prm[14])) return false;
  const float Gf = (float)G;
  const int sid = (int)((v / vs) % G);
  const int gy = (int)((v / vr) % G), gx = (int)((v / vc) % G);
  if (!tmarch::in_box<V>(opt, Gf, gy, gx)) return false;
  const float z = ((float)sid + 0.5f) / Gf + prm[30];
  const float sd = z - prm[0];
  const float ycm = ((float)gy + 0.5f) * (1.f / Gf) - prm[1];
  const float xcm = ((float)gx + 0.5f) * (1.f / Gf) - prm[2];
  float bk[BD], rgb[3];
  tmarch::voxel_rgb_opt<V>(vals, opt, qs, prm, ycm, xcm, sd, sign_of(sd), bk,
                           rgb);
  o[D - 1] = (g.x + g.y * rgb[0] + g.z * rgb[1] + g.w * rgb[2]) * qs[D - 1];
  if constexpr (V::FMT == F_RGBA) {
    // raw colours: their cotangent is g_srgb * sigma (no sigmoid')
    o[0] = g.y * sigma * qs[0];
    o[1] = g.z * sigma * qs[1];
    o[2] = g.w * sigma * qs[2];
  } else {
    // sigmoid' x the basis; planes outside the window (bk = 0) get zero
    const float graw[3] = {g.y * sigma * rgb[0] * (1.f - rgb[0]),
                           g.z * sigma * rgb[1] * (1.f - rgb[1]),
                           g.w * sigma * rgb[2] * (1.f - rgb[2])};
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
      for (int kk = 0; kk < BD; ++kk)
        o[ch * BD + kk] = graw[ch] * bk[kk] * qs[ch * BD + kk];
    }
  }
  return true;
}

// the shade adjoint, one thread per voxel in the payload's memory order;
// the block's records go out as one contiguous run
template <class V, typename PT>
__device__ __forceinline__ void bwd_shade(
    const PT* __restrict__ payload, const float* __restrict__ params,
    const float* __restrict__ qscale, const float4* __restrict__ gbuf,
    void* __restrict__ out, int out_bf16, int G, long long vs, long long vr,
    long long vc, long long n_vox, const tmarch::VarArgs& va) {
  constexpr int BD = V::BD, DMAX = V::DMAX;
  __shared__ float s_prm[NP];
  __shared__ float s_qs[DMAX];
  __shared__ __align__(16) float s_out[NT2 * DMAX];
  const int tid = threadIdx.x;
  // SG/ASG: the lobes folded without the scales, which the shade adjoint
  // takes a plane each (each block folds them: copying a table folded once
  // a launch ran no faster, PERF.md)
  tmarch::TrainOpt opt = tmarch::load_opt<V, NT2>(va, nullptr, tid);
  const int D = tmarch::rec_dim<V>(opt);
  for (int i = tid; i < NP; i += NT2) s_prm[i] = params[i];
  for (int i = tid; i < D; i += NT2) s_qs[i] = qscale[i];
  __syncthreads();
  tmarch::set_box<V>(opt, s_prm);

  const long long v0 = (long long)blockIdx.x * NT2;
  const long long v = v0 + tid;
  float* o = s_out + tid * D;
  bool done = false;
  if (v < n_vox) {
    const float4 g = gbuf[v];
    if constexpr (V::OPT && !V::RTD) {
      if (g.x != 0.f || g.y != 0.f || g.z != 0.f || g.w != 0.f)
        done = opt_adjoint<V, PT>(payload + v * D, opt, s_qs, s_prm, G, v,
                                  vs, vr, vc, g, o);
    } else if (g.x != 0.f || g.y != 0.f || g.z != 0.f || g.w != 0.f) {
      const PT* rec = payload + v * D;
      const float sigma = tmarch::pay_val(rec[D - 1]) * s_qs[D - 1];
      // a voxel under the sigma threshold (or outside the bbox) is masked
      // out of the forward: its cotangent is zero whatever reached it
      if (sigma > s_prm[14]) {
        const float Gf = (float)G;
        const int sid = (int)((v / vs) % G);
        const int gy = (int)((v / vr) % G), gx = (int)((v / vc) % G);
        if (tmarch::in_box<V>(opt, Gf, gy, gx)) {
          const float z = ((float)sid + 0.5f) / Gf + s_prm[30];
          const float sd = z - s_prm[0];
          const float ycm = ((float)gy + 0.5f) * (1.f / Gf) - s_prm[1];
          const float xcm = ((float)gx + 0.5f) * (1.f / Gf) - s_prm[2];
          if constexpr (V::RTD) {
            lobe_adjoint<V, PT>(rec, opt, s_qs, s_prm, ycm, xcm, sd, g,
                                sigma, D, o);
            done = true;
          } else {
            // the SH defaults
            float bk[BD], rgb[3];
            float vals[DMAX];
            tmarch::load_record<DMAX, PT>(rec, vals);
            tmarch::voxel_rgb<BD>(vals, s_qs, s_prm, ycm, xcm, sd,
                                  sign_of(sd), bk, rgb);
            const float gsig =
                g.x + g.y * rgb[0] + g.z * rgb[1] + g.w * rgb[2];
            o[D - 1] = gsig * s_qs[D - 1];
            // sigmoid' x the basis
            const float graw[3] = {g.y * sigma * rgb[0] * (1.f - rgb[0]),
                                   g.z * sigma * rgb[1] * (1.f - rgb[1]),
                                   g.w * sigma * rgb[2] * (1.f - rgb[2])};
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
              for (int kk = 0; kk < BD; ++kk)
                o[ch * BD + kk] = graw[ch] * bk[kk] * s_qs[ch * BD + kk];
            }
            done = true;
          }
        }
      }
    }
  }
  if constexpr (V::RTD) {
    // 16-byte stores where the rows are (a conflict-free phase a quad)
    if (!done) {
      if ((D & 3) == 0) {
        for (int q = 0; q < (D >> 2); ++q)
          reinterpret_cast<float4*>(o)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (int ch = 0; ch < D; ++ch) o[ch] = 0.f;
      }
    }
  } else if (!done) {
#pragma unroll
    for (int ch = 0; ch < DMAX; ++ch)
      if (ch < D) o[ch] = 0.f;
  }
  __syncthreads();
  const long long nv = min((long long)NT2, n_vox - v0);
  const int n = (int)(nv * D);
  const long long base = v0 * D;
  if (out_bf16) {
    __nv_bfloat16* ob = (__nv_bfloat16*)out + base;
    if (nv == NT2) {  // 16-byte stores: NT2 * D is a multiple of 8
      for (int i = tid * 8; i < n; i += NT2 * 8) {
        __align__(16) __nv_bfloat16 h[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) h[q] = __float2bfloat16(s_out[i + q]);
        *reinterpret_cast<uint4*>(ob + i) = *reinterpret_cast<uint4*>(h);
      }
    } else {
      for (int i = tid; i < n; i += NT2) ob[i] = __float2bfloat16(s_out[i]);
    }
  } else {
    float* of = (float*)out + base;
    if (nv == NT2) {  // NT2 * D is a multiple of 4
      for (int i = tid * 4; i < n; i += NT2 * 4)
        *reinterpret_cast<float4*>(of + i) =
            *reinterpret_cast<const float4*>(s_out + i);
    } else {
      for (int i = tid; i < n; i += NT2) of[i] = s_out[i];
    }
  }
}

// Pass 2's kernels: the SH defaults with the block's threads alone (their
// registers are pinned); the option variants also with the blocks an SM
// that each held before its redesign: SG 12, 12, 8, 5 and ASG 12, 10, 7,
// 4 at bounds 4, 9, 16, 25 (left to its own budget the compiler took 73
// registers, 6 blocks, 0.10 ms slower on the lean payload's SG9, PERF.md);
// SH with options the blocks the compiler's own budget gives it without
// spills (12, 10, 8, 6, 4 at SH1, 4, 9, 16, 25; at the SH defaults' 16 or
// 12, 10, 8, 5 it spilled 48-112 bytes), RGBA 12.
template <class V>
constexpr int pass2_blocks() {
  constexpr int i = V::BD <= 4 ? 0 : V::BD <= 9 ? 1 : V::BD <= 16 ? 2 : 3;
  constexpr int sg[4] = {12, 12, 8, 5}, asg[4] = {12, 10, 7, 4},
                sh[4] = {V::BD == 1 ? 12 : 10, 8, 6, 4};
  return V::FMT == F_ASG   ? asg[i]
         : V::FMT == F_SG  ? sg[i]
         : V::FMT == F_SH  ? sh[i]
                           : 12;
}

#define VT_SHADE_ARGS                                                     \
  const PT *__restrict__ payload, const float *__restrict__ params,       \
      const float *__restrict__ qscale, const float4 *__restrict__ gbuf,  \
      void *__restrict__ out, int out_bf16, int G, long long vs,          \
      long long vr, long long vc, long long n_vox, const tmarch::VarArgs va
template <class V, typename PT>
__global__ void __launch_bounds__(NT2) bwd_shade_kernel(VT_SHADE_ARGS) {
  bwd_shade<V, PT>(payload, params, qscale, gbuf, out, out_bf16, G, vs, vr,
                   vc, n_vox, va);
}

template <class V, typename PT>
__global__ void __launch_bounds__(NT2, pass2_blocks<V>())
    bwd_shade_opt(VT_SHADE_ARGS) {
  bwd_shade<V, PT>(payload, params, qscale, gbuf, out, out_bf16, G, vs, vr,
                   vc, n_vox, va);
}
#undef VT_SHADE_ARGS

// the two passes' kernels of variant V on a payload of PT
template <class V, typename PT>
struct Fns {
  using Var = V;
  using Elem = PT;
  using MarchFn = void (*)(const tmarch::ArgsOf<V, BwdArgs>);
  static constexpr size_t SMEM = tmarch::march_smem<V, PT>();
  // pass 1; ``direct``: RGBA's, writing an f32 cotangent itself
  static MarchFn march(bool direct) {
    if constexpr (V::FMT == F_RGBA) {
      if (direct) return bwd_march_opt<V, PT, true>;
    }
    if constexpr (V::OPT)
      return bwd_march_opt<V, PT, false>;
    else
      return bwd_march_kernel<V, PT>;
  }
  using ShadeFn = void (*)(const PT*, const float*, const float*,
                          const float4*, void*, int, int, long long,
                          long long, long long, long long,
                          const tmarch::VarArgs);
  static ShadeFn shade_kernel() {
    if constexpr (V::OPT)
      return bwd_shade_opt<V, PT>;
    else
      return bwd_shade_kernel<V, PT>;
  }
  static const void* shade_fn() { return (const void*)shade_kernel(); }
  static cudaError_t shade(const void* payload, const BwdArgs& a,
                           const tmarch::VarArgs& va, void* out,
                           int out_bf16, cudaStream_t s) {
    // the payload's voxels: a z-segment's (slab axis outermost) are its
    // Gz slabs' first, so the shade pass's slab index stays below G
    const long long n_vox = (long long)a.n_ids * a.G * a.G;
    const unsigned blocks = (unsigned)((n_vox + NT2 - 1) / NT2);
    shade_kernel()<<<blocks, NT2, 0, s>>>(
        (const PT*)payload, a.params, a.qscale, (const float4*)a.gbuf, out,
        out_bf16, a.G, a.vs, a.vr, a.vc, n_vox, va);
    return cudaGetLastError();
  }
};

// Both passes; RGBA with an f32 cotangent handed as gbuf itself (zeroed)
// takes pass 1 alone, which writes the cotangent (DIRECT).
template <typename F>
int launch(const BwdArgs& a, const tmarch::VarArgs& va, const void* payload,
           void* out, int out_bf16, cudaStream_t s) {
  const bool direct = (void*)a.gbuf == out;
  if (direct && (F::Var::FMT != F_RGBA || out_bf16))
    return (int)cudaErrorInvalidValue;
  const typename F::MarchFn fn = F::march(direct);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.gi + tmarch::TX - 1) / tmarch::TX,
                  (a.gi + tmarch::TY - 1) / tmarch::TY);
  fn<<<grid, tmarch::NT, F::SMEM, s>>>(
      tmarch::args_of<typename F::Var>(a, va));
  e = cudaGetLastError();
  if (e != cudaSuccess || direct) return (int)e;
  return (int)F::shade(payload, a, va, out, out_bf16, s);
}

// pass 1 as the trainers launch it: RGBA's on an f32 payload writes its
// f32 cotangent itself (DIRECT); the lean trainer's bf16 one takes gbuf
template <typename F>
int info(int* out) {
  using PT = typename F::Elem;
  const typename F::MarchFn fn =
      F::march(F::Var::FMT == F_RGBA && sizeof(PT) == 4);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F::SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn,
                                                    tmarch::NT, F::SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes at;
  e = cudaFuncGetAttributes(&at, fn);
  if (e != cudaSuccess) return (int)e;
  out[1] = at.numRegs;
  out[2] = (int)at.localSizeBytes;
  out[3] = (int)F::SMEM;
  const void* sfn = F::shade_fn();
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], sfn, NT2, 0);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncGetAttributes(&at, sfn);
  if (e != cudaSuccess) return (int)e;
  out[5] = at.numRegs;
  out[6] = (int)at.localSizeBytes;
  return 0;
}

}  // namespace

// payload: element (0, 0, 0, 0) of the (Gz, D, G, G) view the forward
// marched, f32 (pay_f32) or bf16, 16-byte aligned, channel stride 1 and
// slab/row/column element strides ss, sr, sc a permutation of (G*G*D,
// G*D, D) (the bake's layout), or a z-segment of Gz < G slabs (its global
// z in params[30], its incoming state in aux) with ss = G*G*D, the slab
// axis outermost; params (31,) f32; qscale (D,) f32; zb (4, gi, gi) f32
// (_zb_planes); gacc (4, gi, gi) f32; aux (4, gi, gi) f32 = [ctot, T_end *
// g_T, T_in, A_in]; ids (Gz,) int32, every slab in forward order; occ: Gz
// * ceil(G / 8) * ceil(G / 512) uint64, the payload's coarse occupancy
// (vt_march_occupancy in slab_march.cu); gbuf (Gz G^2, 4) f32 in the
// payload's voxel order, zeroed by the caller; out: the cotangent, the
// payload's strides, f32 or bf16 (out_bf16); for RGBA with an f32
// cotangent gbuf may be ``out`` itself (zeroed: pass 1 then writes the
// cotangent and pass 2 does not run; the layouts agree at D = 4, so a
// build that runs pass 2 computes it in place); counts: tmarch::N_COUNTS
// uint64 (pass 1's, tmarch::add_counts) or null; the variant (bd, fmt,
// opt, extra, rot_on, rot, bbox, basis_lo, basis_hi) as for
// vt_march_slabs. Returns cudaGetLastError() after the launches.
extern "C" int vt_march_slabs_bwd(const void* payload, int pay_f32,
                                  long long ss, long long sr, long long sc,
                                  const void* params, const void* qscale,
                                  const void* zb, const void* gacc,
                                  const void* aux, const void* ids,
                                  void* occ, void* gbuf, void* out,
                                  int out_bf16, void* counts, int Gz, int G,
                                  int gi, int bd, int flip, int fmt, int opt,
                                  const void* extra, int rot_on,
                                  const void* rot, int bbox, int basis_lo,
                                  int basis_hi, void* stream) {
  tmarch::VarArgs va;
  if (!tmarch::make_var(fmt, bd, opt, extra, rot_on, rot, bbox, basis_lo,
                        basis_hi, va))
    return (int)cudaErrorInvalidValue;
  const int D = fmt == F_RGBA ? 4 : 3 * bd + 1;
  if (Gz < 1 || Gz > G || gi < 1 ||
      (Gz < G && ss != (long long)G * G * D) ||
      (reinterpret_cast<uintptr_t>(payload) & 15) || ss % D || sr % D ||
      sc % D)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.pv.ptr = payload;
  a.pv.ss = ss;
  a.pv.sr = sr;
  a.pv.sc = sc;
  a.params = (const float*)params;
  a.qscale = (const float*)qscale;
  a.zb = (const float*)zb;
  a.gacc = (const float*)gacc;
  a.aux = (const float*)aux;
  a.ids = (const int*)ids;
  a.occ = (const unsigned long long*)occ;
  a.gbuf = (float*)gbuf;
  a.counts = (unsigned long long*)counts;
  a.vs = ss / D;
  a.vr = sr / D;
  a.vc = sc / D;
  a.n_ids = Gz;
  a.G = G;
  a.gi = gi;
  a.flip = flip;
  cudaStream_t s = (cudaStream_t)stream;
  return tmarch::with_variant(fmt, bd, opt, pay_f32, [&](auto v, auto e) {
    return launch<Fns<decltype(v), typename decltype(e)::type>>(
        a, va, payload, out, out_bf16, s);
  });
}

// What the card makes of the launches of variant (bd, fmt, opt; as for
// vt_march_slabs_bwd) on a payload of f32 (pay_f32) or bf16: out[0..3]
// pass 1's resident blocks per SM, registers a thread, spill bytes a
// thread and dynamic shared memory a block (RGBA on f32: the pass that
// writes the f32 cotangent itself); out[4..6] pass 2's blocks per SM,
// registers, spill bytes.
extern "C" int vt_march_slabs_bwd_info(int bd, int pay_f32, int fmt,
                                       int opt, int* out) {
  return tmarch::with_variant(fmt, bd, opt, pay_f32, [&](auto v, auto e) {
    return info<Fns<decltype(v), typename decltype(e)::type>>(out);
  });
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
