// Device helpers of the slab marches. The SH basis, the box-integration
// overlap weight, the tile footprint and the pixel spans serve all three:
// kernel M's display mode (slab_march_display.cu), its training mode
// (slab_march.cu) and the backward (slab_march_bwd.cu). The training
// march's slab loop (namespace tmarch: the payload in the bake's own layout,
// the staged sigma ring, the empty-footprint skip, the colour records
// staged for the cells above the threshold, the per-voxel shading and each
// pixel's tap sums) is shared by the training mode and the backward only:
// both run this one march_loop, so the backward's forward recompute does
// the same float operations as the training march, stop-threshold freezes
// included. The display mode stages and shades its int8 payload with its
// own code.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NP = 31;                // params per pose (see _pack_params)

// SH normalization constants (lumisphere.hpp:38-80)
constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
constexpr float C2_0 = 1.0925484305920792f, C2_1 = -1.0925484305920792f,
                C2_2 = 0.31539156525252005f, C2_3 = -1.0925484305920792f,
                C2_4 = 0.5462742152960396f;
constexpr float C3_0 = -0.5900435899266435f, C3_1 = 2.890611442640554f,
                C3_2 = -0.4570457994644658f, C3_3 = 0.3731763325901154f,
                C3_4 = -0.4570457994644658f, C3_5 = 1.445305721320277f,
                C3_6 = -0.5900435899266435f;
constexpr float C4_0 = 2.5033429417967046f, C4_1 = -1.7701307697799304f,
                C4_2 = 0.9461746957575601f, C4_3 = -0.6690465435572892f,
                C4_4 = 0.10578554691520431f, C4_5 = -0.6690465435572892f,
                C4_6 = 0.47308734787878004f, C4_7 = -1.7701307697799304f,
                C4_8 = 0.6258357354491761f;

// real SH basis at unit direction (x, y, z), in the reference's order
template <int BD>
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* bk) {
  bk[0] = C0;
  if constexpr (BD >= 4) {
    bk[1] = -C1 * y;
    bk[2] = C1 * z;
    bk[3] = -C1 * x;
  }
  if constexpr (BD >= 9) {
    const float xx = x * x, yy = y * y, zz = z * z;
    bk[4] = C2_0 * x * y;
    bk[5] = C2_1 * y * z;
    bk[6] = C2_2 * (2.f * zz - xx - yy);
    bk[7] = C2_3 * x * z;
    bk[8] = C2_4 * (xx - yy);
    if constexpr (BD >= 16) {
      bk[9] = C3_0 * y * (3.f * xx - yy);
      bk[10] = C3_1 * x * y * z;
      bk[11] = C3_2 * y * (4.f * zz - xx - yy);
      bk[12] = C3_3 * z * (2.f * zz - 3.f * xx - 3.f * yy);
      bk[13] = C3_4 * x * (4.f * zz - xx - yy);
      bk[14] = C3_5 * z * (xx - yy);
      bk[15] = C3_6 * x * (xx - 3.f * yy);
    }
    if constexpr (BD >= 25) {
      bk[16] = C4_0 * x * y * (xx - yy);
      bk[17] = C4_1 * y * z * (3.f * xx - yy);
      bk[18] = C4_2 * x * y * (7.f * zz - 1.f);
      bk[19] = C4_3 * y * z * (7.f * zz - 3.f);
      bk[20] = C4_4 * (zz * (35.f * zz - 30.f) + 3.f);
      bk[21] = C4_5 * x * z * (7.f * zz - 3.f);
      bk[22] = C4_6 * (xx - yy) * (7.f * zz - 1.f);
      bk[23] = C4_7 * x * z * (xx - 3.f * yy);
      bk[24] = C4_8 * (xx * (xx - 3.f * yy) - yy * (3.f * xx - yy));
    }
  }
}

// basis formats (volrend_torch/models/data_format.py BasisType)
constexpr int F_RGBA = 0, F_SH = 1, F_SG = 2, F_ASG = 3;

// The unit view direction of a voxel: the direction is affine in the
// voxel's slope coordinates, s * dir = dirM[:,0] * s + dirM[:,1] * ycm +
// dirM[:,2] * xcm (params 20:29), for the camera distance ``s`` of its slab
// (or window centre); ``ssign`` = sign(s).
__device__ __forceinline__ void view_dir(const float* prm, float ycm,
                                         float xcm, float s, float ssign,
                                         float& x, float& y, float& z) {
  const float dw0 = (prm[21] * ycm + prm[22] * xcm) + prm[20] * s;
  const float dw1 = (prm[24] * ycm + prm[25] * xcm) + prm[23] * s;
  const float dw2 = (prm[27] * ycm + prm[28] * xcm) + prm[26] * s;
  const float rn = rsqrtf(dw0 * dw0 + dw1 * dw1 + dw2 * dw2) * ssign;
  x = dw0 * rn;
  y = dw1 * rn;
  z = dw2 * rn;
}

// the viewer's view-direction rotation, d = R d (volrend.cu:57-71)
__device__ __forceinline__ void rotate(const float* R, float& x, float& y,
                                       float& z) {
  const float rx = R[0] * x + R[1] * y + R[2] * z;
  const float ry = R[3] * x + R[4] * y + R[5] * z;
  const float rz = R[6] * x + R[7] * y + R[8] * z;
  x = rx;
  y = ry;
  z = rz;
}

// 2^x, one MUFU.EX2 (subnormal results flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The SG and ASG lobes, folded once a block and streamed: kernel M's
// display mode (slab_march_display.cu) and the training pair (tmarch:
// march_loop's shading and M-bwd's shade pass) share this one fold.
//
// Lobe k of ``nb`` (its raw parameters ``ext``: 4 floats a lobe for SG, 11
// for ASG) folded into out[LW * k ..] (LW float4: 1 for SG, 3 for ASG),
// for one ex2 a lobe and cell; lobe k's value times the scale ``q`` (the
// bakes' scales are > 0; the training bake's are ones) at the unit view
// direction d:
// - SG, exp(lambda (mu . d - 1)) / nb (lumisphere.hpp:30-36) x q:
//   (A, B) with A = log2(e) lambda mu, B = log2(q / nb) - log2(e)
//   lambda; the value ex2(A . d + B).
// - ASG, S exp(-a (mu_x . d)^2 - b (mu_y . d)^2) / nb (lumisphere.hpp:
//   14-28) x q, S = mu_z . d: the exponent times log2(e) is the
//   quadratic form -log2(e) d^T M d, M = a mu_x mu_x^T + b mu_y mu_y^T,
//   with z^2 = 1 - x^2 - y^2 folded into its constant: (c, qxx, qyy,
//   qxy), (qxz, qyz, S'x, S'y), (S'z, 0, 0, 0), S' = mu_z q / nb; the
//   value (S' . d) ex2(c + qxx x^2 + qyy y^2 + qxy xy + qxz xz + qyz yz).
//   Five multiply-adds for the exponent whatever the signs of a and b.
// volrend_torch/ops/slab_march.py's plain versions evaluate the lobes as
// the reference writes them; tests/test_torch_display_lobes.py and
// tests/test_torch_train_lobes.py hold this fold, mirrored in PyTorch,
// against the reference's basis.
template <int FM>
__device__ __forceinline__ void fold_lobe(const float* ext, float q, int k,
                                          int nb, float4* out) {
  constexpr float L2E = 1.4426950408889634f;
  if constexpr (FM == F_SG) {
    const float* e = ext + 4 * k;
    const float l = e[0] * L2E;
    out[k] = make_float4(l * e[1], l * e[2], l * e[3],
                         (log2f(q) - log2f((float)nb)) - l);
  } else {
    const float* e = ext + 11 * k;
    const float a = e[0], b = e[1];
    const float *mx = e + 2, *my = e + 5, *mz = e + 8;
    float m[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        m[i][j] = a * (mx[i] * mx[j]) + b * (my[i] * my[j]);
    const float s = -L2E, s2 = -2.f * L2E, qn = q / (float)nb;
    out[3 * k] = make_float4(s * m[2][2], s * (m[0][0] - m[2][2]),
                             s * (m[1][1] - m[2][2]), s2 * m[0][1]);
    out[3 * k + 1] = make_float4(s2 * m[0][2], s2 * m[1][2], mz[0] * qn,
                                 mz[1] * qn);
    out[3 * k + 2] = make_float4(mz[2] * qn, 0.f, 0.f, 0.f);
  }
}

// A unit direction's terms the lobes read: SG x, y, z; ASG also x^2, y^2,
// xy, xz, yz (the quadratic form's).
struct LobeDir {
  float x, y, z, xx, yy, xy, xz, yz;
};

template <int FM>
__device__ __forceinline__ LobeDir lobe_dir(float x, float y, float z) {
  LobeDir d{};
  d.x = x;
  d.y = y;
  d.z = z;
  if constexpr (FM == F_ASG) {
    d.xx = x * x;
    d.yy = y * y;
    d.xy = x * y;
    d.xz = x * z;
    d.yz = y * z;
  }
  return d;
}

// lobe L's value times its scale at direction d (fold_lobe)
template <int FM>
__device__ __forceinline__ float lobe_at(const float4* L, const LobeDir& d) {
  if constexpr (FM == F_SG) {
    const float4 a = L[0];
    return ex2(fmaf(a.x, d.x, fmaf(a.y, d.y, fmaf(a.z, d.z, a.w))));
  } else {
    const float4 a = L[0], b = L[1], c = L[2];
    const float e = fmaf(b.y, d.yz, fmaf(b.x, d.xz, fmaf(a.w, d.xy, fmaf(
        a.z, d.yy, fmaf(a.y, d.xx, a.x)))));
    return fmaf(c.x, d.z, fmaf(b.w, d.y, b.z * d.x)) * ex2(e);
  }
}

// The option variants' shared memory: the rotation's 9 floats, then N - 9
// floats of lobe parameters (one array a kernel that calls it).
template <int N>
__device__ __forceinline__ float* opt_smem() {
  __shared__ float s[N];
  return s;
}

// floor(v) clamped to [lo, hi], safe for any float (incl. huge values)
__device__ __forceinline__ int cell_floor(float v, int lo, int hi) {
  return (int)fminf(fmaxf(floorf(v), (float)lo), (float)hi);
}

// overlap of the span [pmin, pmax] with GLOBAL cell c, divided by the span
// length (edge cells extend to +-inf: out-of-grid span mass clamps to
// them, as the octree query clamps positions into the unit cube)
__device__ __forceinline__ float overlap(int c, int G, float pmin,
                                         float pmax, float inv) {
  const float hi = (c >= G - 1) ? 1e9f : (float)(c + 1);
  const float lo = (c <= 0) ? -1e9f : (float)c;
  return fminf(fmaxf((fminf(hi, pmax) - fmaxf(lo, pmin)) * inv, 0.f), 1.f);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float sign_of(float s) {
  return (s > 0.f) ? 1.f : ((s < 0.f) ? -1.f : 0.f);
}

// A tile's cell footprint at one slab, in global cells (+-1 cell of
// rounding margin), clipped to [lo, hi] on each axis. The slope map is
// affine in the pixel index, so the span extremes are at the tile's first
// and last rows/columns (ray slopes x G: ujGa/ujGb, vkGa/vkGb).
struct Footprint {
  int y_lo, y_hi, x_lo, x_hi;
};

__device__ __forceinline__ Footprint tile_footprint(
    float cyG, float cxG, float s0, float s1, float ujGa, float ujGb,
    float vkGa, float vkGb, int G, int ylo, int yhi, int xlo, int xhi) {
  const float ya0 = cyG + s0 * ujGa, ya1 = cyG + s1 * ujGa;
  const float yb0 = cyG + s0 * ujGb, yb1 = cyG + s1 * ujGb;
  const float xa0 = cxG + s0 * vkGa, xa1 = cxG + s1 * vkGa;
  const float xb0 = cxG + s0 * vkGb, xb1 = cxG + s1 * vkGb;
  Footprint f;
  f.y_lo = max(cell_floor(fminf(fminf(ya0, ya1), fminf(yb0, yb1)), 0, G - 1)
               - 1, ylo);
  f.y_hi = min(cell_floor(fmaxf(fmaxf(ya0, ya1), fmaxf(yb0, yb1)), 0, G - 1)
               + 1, yhi);
  f.x_lo = max(cell_floor(fminf(fminf(xa0, xa1), fminf(xb0, xb1)), 0, G - 1)
               - 1, xlo);
  f.x_hi = min(cell_floor(fmaxf(fmaxf(xa0, xa1), fmaxf(xb0, xb1)), 0, G - 1)
               + 1, xhi);
  return f;
}

// One pixel's spans through a slab along rows (p) and columns (q), in
// global cells (ujG/vkG: its ray slopes x G), with the cells they cover
// inside the tile's footprint.
struct PixelSpan {
  float pmin, pmax, inv_r, qmin, qmax, inv_c;
  int ry_lo, ry_hi, rx_lo, rx_hi;
};

__device__ __forceinline__ PixelSpan pixel_span(float cyG, float cxG,
                                                float s0, float s1, float ujG,
                                                float vkG, int G,
                                                const Footprint& f) {
  PixelSpan sp;
  const float p0 = cyG + s0 * ujG, p1 = cyG + s1 * ujG;
  sp.pmin = fminf(p0, p1);
  sp.pmax = fmaxf(p0, p1);
  sp.inv_r = 1.f / fmaxf(sp.pmax - sp.pmin, 1e-9f);
  const float q0 = cxG + s0 * vkG, q1 = cxG + s1 * vkG;
  sp.qmin = fminf(q0, q1);
  sp.qmax = fmaxf(q0, q1);
  sp.inv_c = 1.f / fmaxf(sp.qmax - sp.qmin, 1e-9f);
  sp.ry_lo = max(cell_floor(sp.pmin, 0, G - 1), f.y_lo);
  sp.ry_hi = min(cell_floor(sp.pmax, 0, G - 1), f.y_hi);
  sp.rx_lo = max(cell_floor(sp.qmin, 0, G - 1), f.x_lo);
  sp.rx_hi = min(cell_floor(sp.qmax, 0, G - 1), f.x_hi);
  return sp;
}


// ---------------------------------------------------------------------------
// The training march (kernel M's training mode and the backward's pass 1)
// ---------------------------------------------------------------------------

namespace tmarch {

// The launch configuration, fixed at compile time: tiles of TY x TX
// pixels; NT threads a block, a pixel each for the first TY * TX, all of
// them staging and shading cells; footprint pieces of PS x PS cells; the
// sigma of RING jobs staged ahead; the colour records of the job DC ahead
// queued into RSLOTS slots a thread. The fastest of the configurations
// probes/train_march.py times on the training bench (PERF.md); the probe
// builds the others by defining VT_TM_* macros (each one it defines
// replaces its default), as volrend_torch/kernels does for a library of
// its own.
#ifndef VT_TM_TY
#define VT_TM_TY 4
#endif
#ifndef VT_TM_TX
#define VT_TM_TX 8
#endif
#ifndef VT_TM_NT
#define VT_TM_NT 128
#endif
#ifndef VT_TM_PS
#define VT_TM_PS 24
#endif
#ifndef VT_TM_RING
#define VT_TM_RING 4
#endif
#ifndef VT_TM_DC
#define VT_TM_DC 2
#endif
#ifndef VT_TM_RSLOTS
#define VT_TM_RSLOTS 1
#endif
constexpr int TY = VT_TM_TY, TX = VT_TM_TX, NT = VT_TM_NT, PS = VT_TM_PS,
              RING = VT_TM_RING, DC = VT_TM_DC, RSLOTS = VT_TM_RSLOTS;
constexpr int CONFIG[7] = {TY, TX, NT, PS, RING, DC, RSLOTS};
static_assert(TY >= 1 && TX >= 1 && NT >= TY * TX && NT % 32 == 0 &&
                  NT <= 1024 && PS >= 4 && RING >= 1 &&
                  DC >= 0 && DC < RING && RSLOTS >= 1,
              "a launch configuration the march cannot take");

// The payload as the bake holds it: a (Gz, D, Gy, Gx) view of the
// (G, G, G, D) bake with channel stride 1, so that each voxel's D values are
// one contiguous record; f32 (the default trainer's bake) or bf16 (the lean
// trainer's). Strides in elements; ``ptr`` is element (0, 0, 0, 0) and
// 16-byte aligned.
struct PayView {
  const void* ptr;
  long long ss, sr, sc;  // slab, row and column strides
};

// a payload value as the march takes it: bf16 as it is, f32 rounded to
// bf16 (to nearest even, as a PyTorch copy to bf16 rounds), so that both
// dtypes march the values of the bake's bf16 copy
__device__ __forceinline__ float pay_val(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float pay_val(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t sptr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(sptr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(sptr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N of this thread's most recent copy groups may be in
// flight
template <int N>
__device__ __forceinline__ void wait_n() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// The aligned 32-bit word that holds payload element ``e`` (a sigma value):
// the element itself in f32; in bf16 the word of the element pair, ``e``'s
// half chosen by sigma_of. An aligned word holding a byte of the tensor
// lies inside its (aligned) allocation.
template <typename PT>
__device__ __forceinline__ const void* word_of(const void* base,
                                               long long e) {
  if constexpr (sizeof(PT) == 4)
    return (const char*)base + e * 4;
  else
    return (const char*)base + (e & ~1LL) * 2;
}
template <typename PT>
__device__ __forceinline__ float sigma_of(uint32_t w, long long e) {
  if constexpr (sizeof(PT) == 4) {
    return pay_val(__uint_as_float(w));
  } else {
    const unsigned short h =
        (unsigned short)((e & 1) ? (w >> 16) : (w & 0xffffu));
    return __bfloat162float(__ushort_as_bfloat16(h));
  }
}

// A training variant: its basis format FM; whether the run-time options
// (rot, the basis window, the bbox and, for SG/ASG, the lobe count and
// their parameters) are compiled in (O); and B, the SH basis functions or
// the lobe count's bound (1 for RGBA). A record holds at most DMAX values:
// 3 B + 1, or 4 for RGBA; SG and ASG take theirs, 3 nb + 1 for nb <= B
// lobes, at run time (RTD). The default variants, SH without options
// (ShVar), are what the training bench marches. SG and ASG shade from the
// lobe table each block folds (fold_lobe: LW float4 a lobe).
template <int FM, bool O, int B>
struct TVar {
  static constexpr int FMT = FM, BD = B;
  static constexpr bool OPT = O;
  static constexpr bool RTD = FM == F_SG || FM == F_ASG;
  static constexpr int DMAX = FM == F_RGBA ? 4 : 3 * B + 1;
  static constexpr int LW = FM == F_ASG ? 3 : 1;
};
template <int BD>
using ShVar = TVar<F_SH, false, BD>;

// The launch's options, as the host passes them: the lobes (SG/ASG: nb x 4
// or 11 floats on the device), the lobe count, the rotation (rot_on, 9
// floats), the bbox mask (params 16-19) and the basis window [blo, bhi].
struct VarArgs {
  const float* extra;
  int nb, rot_on, bbox, blo, bhi;
  float rot[9];
};

// A kernel's arguments ``A`` with the launch's options (VarArgs ``va``) for
// an option variant; the default variants take ``A`` alone (their
// parameters, and so their registers, stay those of the SH-only kernels).
template <class A>
struct WithVar : A {
  VarArgs va;
};
template <class V, class A>
using ArgsOf = typename std::conditional<V::OPT, WithVar<A>, A>::type;

// An option variant's run-time state in the kernel: the rotation (shared
// memory, or null), the lobe count nb, the record width D, the basis
// window, the bbox (its in-plane box from params 16-19), and for SG and
// ASG the folded lobe table (shared memory, fold_lobe) and the lobes
// [klo, khi] the window keeps.
struct TrainOpt {
  const float* rot;
  int nb, D, blo, bhi, bbox;
  float lo1, hi1, lo2, hi2;
  const float4* lobes;
  int klo, khi;
};

// the record width of variant V: a constant, or the lobe count's (RTD)
template <class V>
__device__ __forceinline__ int rec_dim(const TrainOpt& o) {
  if constexpr (V::RTD)
    return o.D;
  else
    return V::DMAX;
}

// The folded lobe table's shared memory: LW float4 a lobe, N lobes.
template <int LW, int N>
__device__ __forceinline__ float4* lobe_table() {
  __shared__ float4 s[LW * N];
  return s;
}

// Load an option variant's options into shared memory (the block's NTH
// threads; the caller synchronizes before use) and return its state; the
// bbox's box is set from the pose's params by set_box. SG and ASG fold
// their lobes once here (fold_lobe), each times its scale qs[k] (the
// payload's scales, on the device; null: ones). Empty for the default
// variants.
template <class V, int NTH>
__device__ __forceinline__ TrainOpt load_opt(const VarArgs& va,
                                             const float* qs, int tid) {
  TrainOpt o{};
  if constexpr (V::OPT) {
    float* s = opt_smem<9>();
    // the rotation with constant indices (a run-time index into the
    // kernel's parameters would copy them to local memory)
#pragma unroll
    for (int r = 0; r < 9; ++r)
      if (tid == r) s[r] = va.rot[r];
    if constexpr (V::RTD) {
      float4* t = lobe_table<V::LW, V::BD>();
      for (int k = tid; k < va.nb; k += NTH)
        fold_lobe<V::FMT>(va.extra, qs ? qs[k] : 1.f, k, va.nb, t);
      o.lobes = t;
      o.klo = max(va.blo, 0);
      o.khi = min(va.bhi, va.nb - 1);
    }
    o.rot = va.rot_on ? s : nullptr;
    o.nb = va.nb;
    o.D = V::RTD ? 3 * va.nb + 1 : V::DMAX;
    o.blo = va.blo;
    o.bhi = va.bhi;
    o.bbox = va.bbox;
  }
  return o;
}

// a kernel's arguments of variant V: ``a`` with the options ``va`` where
// V takes them
template <class V, class A>
ArgsOf<V, A> args_of(const A& a, const VarArgs& va) {
  ArgsOf<V, A> k;
  static_cast<A&>(k) = a;
  if constexpr (V::OPT) k.va = va;
  return k;
}

template <class V>
__device__ __forceinline__ void set_box(TrainOpt& o, const float* prm) {
  if constexpr (V::OPT) {
    o.lo1 = prm[16];
    o.hi1 = prm[17];
    o.lo2 = prm[18];
    o.hi2 = prm[19];
  }
}

// Does the voxel at global cell (gy, gx) lie in the option variant's bbox
// (its extent meets the in-plane box, pallas_slab._shade_pre)? Always for
// the default variants and a full bbox.
template <class V>
__device__ __forceinline__ bool in_box(const TrainOpt& o, float Gf, int gy,
                                       int gx) {
  if constexpr (V::OPT) {
    if (o.bbox) {
      const float h = 0.5f / Gf;
      const float yc = ((float)gy + 0.5f) * (1.f / Gf);
      const float xc = ((float)gx + 0.5f) * (1.f / Gf);
      return (yc + h > o.lo1) && (yc - h < o.hi1) && (xc + h > o.lo2) &&
             (xc - h < o.hi2);
    }
  }
  return true;
}

// bytes of one thread's record slot: the record and the word-alignment
// slack of its 4-byte copies. The threads' slots lie side by side, so the
// slot is an odd number of 16-byte units where the record takes 16-byte
// copies and is read as float4 (the 8 threads of a phase hit 8 distinct
// bank quads), else an odd number of words (read as words: 32 distinct
// banks). A variant with its record width at run time sizes the slot by
// its bound DMAX, which holds every narrower record either way.
template <int D, typename PT>
__host__ __device__ constexpr int rec_slot() {
  constexpr int RB = D * (int)sizeof(PT);
  if constexpr (RB % 16 == 0) {
    constexpr int u = (RB + 8 + 15) / 16;
    return 16 * (u | 1);
  } else {
    constexpr int w = (RB + 8 + 3) / 4;
    return 4 * (w | 1);
  }
}

// a record's D values as the march takes them (load_record's order), read
// as float4 where the record is f32 and a whole number of them (its slot
// and the bake's records are then 16-byte aligned), else one by one
template <int D, typename PT>
__device__ __forceinline__ void load_record(const PT* rec, float* v) {
  if constexpr (sizeof(PT) == 4 && (D * 4) % 16 == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(rec);
#pragma unroll
    for (int q = 0; q < D / 4; ++q) {
      const float4 t = r4[q];
      v[4 * q] = pay_val(t.x);
      v[4 * q + 1] = pay_val(t.y);
      v[4 * q + 2] = pay_val(t.z);
      v[4 * q + 3] = pay_val(t.w);
    }
  } else {
#pragma unroll
    for (int q = 0; q < D; ++q) v[q] = pay_val(rec[q]);
  }
}

// Does variant V copy the record at address ``a`` (``D`` values) in
// 16-byte units? Where the record is 16-byte aligned and a whole number of
// them (a constant width: f32 with D % 4 == 0; a run-time width: also a
// slot of whole 16-byte units).
template <class V, typename PT>
__device__ __forceinline__ bool whole16(uintptr_t a, int D) {
  if constexpr (!V::RTD) {
    if constexpr ((V::DMAX * (int)sizeof(PT)) % 16 == 0)
      return (a & 15) == 0;
    else
      return false;
  } else if constexpr (rec_slot<V::DMAX, PT>() % 16 == 0) {
    return ((D * (int)sizeof(PT)) & 15) == 0 && (a & 15) == 0;
  } else {
    return false;
  }
}

// Queue the copy of the voxel record at ``rec`` (D values) into ``slot``
// (this thread's) and return where the record will lie there: 16-byte
// copies where whole16 allows, else the aligned 4-byte words that cover
// it. The caller commits and waits.
template <class V, typename PT>
__device__ __forceinline__ const PT* stage_record(char* slot, const PT* rec,
                                                  int D) {
  const int RB = D * (int)sizeof(PT);
  const uintptr_t a = reinterpret_cast<uintptr_t>(rec);
  if (whole16<V, PT>(a, D)) {
#pragma unroll
    for (int i = 0; i < V::DMAX * (int)sizeof(PT) / 16; ++i)
      if (16 * i < RB) cp16(slot + 16 * i, (const char*)rec + 16 * i);
    return reinterpret_cast<const PT*>(slot);
  }
  const uintptr_t w0 = a & ~(uintptr_t)3;
  const int off = (int)(a - w0);
  const int nw = (off + RB + 3) >> 2;
  for (int i = 0; i < nw; ++i)
    cp4(slot + 4 * i, (const char*)w0 + 4 * i);
  return reinterpret_cast<const PT*>(slot + off);
}

// where stage_record put the record at ``rec`` in ``slot``
template <class V, typename PT>
__device__ __forceinline__ const PT* staged(const char* slot, const PT* rec,
                                            int D) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(rec);
  if (whole16<V, PT>(a, D)) return reinterpret_cast<const PT*>(slot);
  return reinterpret_cast<const PT*>(slot + (a & 3));
}

// the SH basis at the voxel's view direction (view_dir, at the camera
// distance ``s`` of the slab) and the voxel's rgb, from its record's values
// (load_record: colour values c * BD + k, sigma last). The basis is scaled
// once per k by qs[k] (the bake shares each basis function's scale across
// rgb).
template <int BD>
__device__ __forceinline__ void voxel_rgb(const float* rec, const float* qs,
                                          const float* prm, float ycm,
                                          float xcm, float s, float ssign,
                                          float* bk, float* rgb) {
  float x, y, z;
  view_dir(prm, ycm, xcm, s, ssign, x, y, z);
  sh_basis<BD>(x, y, z, bk);
  float raw0 = 0.f, raw1 = 0.f, raw2 = 0.f;
#pragma unroll
  for (int kk = 0; kk < BD; ++kk) {
    const float bq = bk[kk] * qs[kk];
    raw0 += rec[kk] * bq;
    raw1 += rec[BD + kk] * bq;
    raw2 += rec[2 * BD + kk] * bq;
  }
  rgb[0] = sigmoid(raw0);
  rgb[1] = sigmoid(raw1);
  rgb[2] = sigmoid(raw2);
}

// An SH or RGBA option variant's rgb of a voxel, from its record's values
// ``rec`` (load_record's: the record read whole, staged or from the
// payload), as the reference's kernel shades it (pallas_slab.py:391-471):
// SH takes sigmoid(sum_k rec[c BD + k] bk[k] qs[k]), bk the basis at the
// view direction rotated by o.rot, zero outside the window [blo, bhi] (a
// mask on the basis, k ascending; bk is returned so); RGBA takes rec[c]
// qs[c] (no basis, no sigmoid). SG and ASG take lobe_sums.
template <class V>
__device__ __forceinline__ void voxel_rgb_opt(const float* rec,
                                              const TrainOpt& o,
                                              const float* qs,
                                              const float* prm, float ycm,
                                              float xcm, float s,
                                              float ssign, float* bk,
                                              float* rgb) {
  if constexpr (V::FMT == F_RGBA) {
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = rec[c] * qs[c];
  } else {
    static_assert(V::FMT == F_SH, "SG and ASG shade by lobe_sums");
    constexpr int BD = V::BD;
    float x, y, z;
    view_dir(prm, ycm, xcm, s, ssign, x, y, z);
    if (o.rot) rotate(o.rot, x, y, z);
    sh_basis<BD>(x, y, z, bk);
    float raw0 = 0.f, raw1 = 0.f, raw2 = 0.f;
#pragma unroll
    for (int k = 0; k < BD; ++k) {
      bk[k] = (k >= o.blo && k <= o.bhi) ? bk[k] : 0.f;
      const float bq = bk[k] * qs[k];
      raw0 += rec[k] * bq;
      raw1 += rec[BD + k] * bq;
      raw2 += rec[2 * BD + k] * bq;
    }
    rgb[0] = sigmoid(raw0);
    rgb[1] = sigmoid(raw1);
    rgb[2] = sigmoid(raw2);
  }
}

// An SG or ASG variant's raw colour sums of a voxel (before the sigmoid), its
// lobes streamed: the view direction (view_dir, rotated by o.rot) taken once,
// then each lobe k the basis window keeps, [klo, khi], evaluated once from the
// block's folded table (lobe_at: one ex2, its scale folded in) straight into
// the three sums over the record's colour values k, nb + k and 2 nb + k, a
// lobe an iteration of a run-time loop (unrolled over the bound, or with the
// record read whole as float4 where it is, it ran no faster on the training
// bench: PERF.md). ``rec``: the record staged or in the payload, read as
// pay_val reads it; with ROW, the values as the march takes them
// (record_row's). No basis array is kept. ``qs`` (or null: the scales are in
// the table) scales lobe k's value by qs[k]; ``stash`` (or null) receives each
// kept lobe's value, before that scale, at stash[k], after its record values
// are read (it may be the row itself).
template <class V, bool ROW = false, typename T>
__device__ __forceinline__ float3 lobe_sums(const T* rec, const TrainOpt& o,
                                            const float* prm, float ycm,
                                            float xcm, float s, float ssign,
                                            const float* qs, float* stash) {
  float x, y, z;
  view_dir(prm, ycm, xcm, s, ssign, x, y, z);
  if (o.rot) rotate(o.rot, x, y, z);
  const LobeDir d = lobe_dir<V::FMT>(x, y, z);
  const int nb = o.nb;
  float raw0 = 0.f, raw1 = 0.f, raw2 = 0.f;
  const T* p = rec + o.klo;
  const float4* L = o.lobes + V::LW * o.klo;
#pragma unroll 1
  for (int k = o.klo; k <= o.khi; ++k, ++p, L += V::LW) {
    float v0, v1, v2;
    if constexpr (ROW) {
      v0 = p[0];
      v1 = p[nb];
      v2 = p[2 * nb];
    } else {
      v0 = pay_val(p[0]);
      v1 = pay_val(p[nb]);
      v2 = pay_val(p[2 * nb]);
    }
    const float b = lobe_at<V::FMT>(L, d);
    if (stash) stash[k] = b;
    const float bq = qs ? b * qs[k] : b;
    raw0 = fmaf(v0, bq, raw0);
    raw1 = fmaf(v1, bq, raw1);
    raw2 = fmaf(v2, bq, raw2);
  }
  return make_float3(raw0, raw1, raw2);
}

// A voxel's D record values at ``rec`` (the payload) into ``row`` (f32,
// 16-byte aligned where D % 4 == 0) as the march takes them (pay_val),
// read whole: float4 loads where the record is f32 and 16-byte aligned,
// aligned 32-bit words (two bf16 values each) for bf16, else one value at
// a time. An aligned word holding a byte of the tensor lies inside its
// (aligned) allocation.
template <typename PT>
__device__ __forceinline__ void record_row(const PT* rec, int D, float* row) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(rec);
  if constexpr (sizeof(PT) == 4) {
    if ((D & 3) == 0 && (a & 15) == 0) {
      const float4* r4 = reinterpret_cast<const float4*>(rec);
      float4* o4 = reinterpret_cast<float4*>(row);
      for (int q = 0; q < (D >> 2); ++q) {
        const float4 t = __ldg(r4 + q);
        o4[q] = make_float4(pay_val(t.x), pay_val(t.y), pay_val(t.z),
                            pay_val(t.w));
      }
    } else {
      for (int q = 0; q < D; ++q) row[q] = pay_val(__ldg(rec + q));
    }
  } else {
    const int off = (int)(a & 3) >> 1;  // the record's first half-word
    const uint32_t* w =
        reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
    for (int i = 0; 2 * i < off + D; ++i) {
      const uint32_t u = __ldg(w + i);
      const int e = 2 * i - off;
      if (e >= 0) row[e] = __uint_as_float(u << 16);
      if (e + 1 < D) row[e + 1] = __uint_as_float(u & 0xffff0000u);
    }
  }
}

// The coarse occupancy of a payload: per slab and per row of OCC x OCC
// cell blocks (in the view's rows and columns, from the crop's origin),
// ceil(ceil(Gx / OCC) / 64) 64-bit masks of the blocks holding a voxel
// above the sigma threshold (bit b of word w: column block 64 w + b).
// Built once per launch by occupancy_kernel; march_loop reads it to pass
// over footprint pieces with no such voxel without touching the payload.
constexpr int OCC = 8;

__host__ __device__ __forceinline__ int occ_words(int Gx) {
  return ((Gx + OCC - 1) / OCC + 63) / 64;
}

// One thread per voxel of the (Gz, Gy, Gx) view, the voxels taken in the
// order of the view's strides (the payload's memory order for a permuted
// bake, so that a warp's sigma reads fall in a few kilobytes): a voxel
// above the threshold (its value as the march reads it: bf16, times
// qs[D-1]; sigma is the last of a record's D values) sets its block's
// bit. The threshold is the lowest of the P
// poses' (params[14]). ``ax`` lists the view's axes (0 slab, 1 row, 2
// column) from the smallest stride to the largest.
struct AxisOrder {
  int ax[3];
};

template <typename PT>
__global__ void __launch_bounds__(256)
occupancy_kernel(PayView pv, int D, const float* __restrict__ params, int P,
                 const float* __restrict__ qscale, int Gz, int Gy, int Gx,
                 AxisOrder order, unsigned long long* __restrict__ occ) {
  const int dims[3] = {Gz, Gy, Gx};
  const long long n = (long long)Gz * Gy * Gx;
  long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  int at[3];
  const int n0 = dims[order.ax[0]], n1 = dims[order.ax[1]];
  at[order.ax[0]] = (int)(v % n0);
  v /= n0;
  at[order.ax[1]] = (int)(v % n1);
  at[order.ax[2]] = (int)(v / n1);
  const int sz = at[0], ry = at[1], cx = at[2];
  const PT* p = reinterpret_cast<const PT*>(pv.ptr) + sz * pv.ss +
                ry * pv.sr + cx * pv.sc + (D - 1);
  float thr = params[14];
  for (int q = 1; q < P; ++q) thr = fminf(thr, params[q * NP + 14]);
  if (pay_val(*p) * qscale[D - 1] > thr) {
    const int cb = cx / OCC;
    unsigned long long* w =
        occ + ((long long)sz * ((Gy + OCC - 1) / OCC) + ry / OCC) *
                  occ_words(Gx) +
        (cb >> 6);
    const unsigned long long bit = 1ull << (cb & 63);
    if (!(*reinterpret_cast<volatile unsigned long long*>(w) & bit))
      atomicOr(w, bit);
  }
}

// Build the coarse occupancy of the view (records of D values) into
// ``occ`` (Gz * ceil(Gy/OCC) * occ_words(Gx) 64-bit masks) on ``stream``:
// clear it, then one occupancy_kernel launch.
template <typename PT>
cudaError_t build_occupancy(PayView pv, int D, const float* params, int P,
                            const float* qscale, int Gz, int Gy, int Gx,
                            unsigned long long* occ, cudaStream_t stream) {
  const size_t masks =
      (size_t)Gz * ((Gy + OCC - 1) / OCC) * (size_t)occ_words(Gx);
  cudaError_t e = cudaMemsetAsync(occ, 0, masks * 8, stream);
  if (e != cudaSuccess) return e;
  const long long n = (long long)Gz * Gy * Gx;
  const long long st[3] = {pv.ss, pv.sr, pv.sc};
  AxisOrder order{{0, 1, 2}};
  for (int i = 0; i < 3; ++i)  // sort the axes by stride
    for (int j = i + 1; j < 3; ++j)
      if (st[order.ax[j]] < st[order.ax[i]]) {
        const int t = order.ax[i];
        order.ax[i] = order.ax[j];
        order.ax[j] = t;
      }
  occupancy_kernel<PT><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      pv, D, params, P, qscale, Gz, Gy, Gx, order, occ);
  return cudaGetLastError();
}

// What march_loop takes of the launch, the pose, the tile and the thread.
struct MarchCtx {
  PayView pv;
  const int* ids;  // slab ids in march order (device)
  const unsigned long long* occ;  // the coarse occupancy (build_occupancy)
  int n_ids;
  int G, y0, x0, yend, xend;  // crop: global cells [y0, yend] x [x0, xend]
  int occ_rows, occ_words;    // ceil(Gy / OCC) rows of occ_words masks
  int flip;                   // the march runs toward -z
  float Gf, hG, cz, cy, cx, cyG, cxG, zbase, sigma_thresh, stop_thresh;
  // ray slopes x G: the tile's first/last row and column, the pixel's
  float ujGa, ujGb, vkGa, vkGb, ujG, vkG;
  int tid;
  bool inpix;
  float zlo, zhi;  // the pixel's live z interval
};

// staged jobs a round of the list holds (a slab with more pieces to stage
// is split across rounds)
constexpr int LIST_CAP = 512;

// The block's shared memory for march_loop. Dynamic (march_smem bytes):
// ``chan`` (PS*PS float4) holds the current piece shaded as [sigma,
// sigma*r, sigma*g, sigma*b]; ``ring`` (RING*PS*PS words) the staged sigma
// of the next jobs; ``rec`` the colour record slots, DC + 1 sets of RSLOTS
// a thread. Static (MarchStatic, the kernel's): ``zr`` and ``rng`` the
// tile's slab range; ``list`` the round's staged jobs (job_entry);
// ``wsum`` the list build's scan and counts.
struct MarchSmem {
  float4* chan;
  uint32_t* ring;
  char* rec;
  float* zr;
  int* rng;
  int4* list;
  int* wsum;
};

struct MarchStatic {
  float zr[2 * NT / 32];
  int rng[2];
  int4 list[LIST_CAP];
  int wsum[NT / 32 + 4];
};

// bytes of the sigma ring, rounded up to 16 (the record slots follow it)
constexpr size_t RING_BYTES = ((size_t)RING * PS * PS * 4 + 15) / 16 * 16;

// the dynamic shared memory of a block of variant V: chan, ring, rec
template <class V, typename PT>
constexpr size_t march_smem() {
  return (size_t)PS * PS * 16 + RING_BYTES +
         (size_t)(DC + 1) * RSLOTS * NT * rec_slot<V::DMAX, PT>();
}

// The blocks an SM's shared memory (228 KB) holds of a march kernel of
// variant V: its dynamic bytes, MarchStatic, ~2 KB of the kernels' other
// static arrays and the 1 KB the card reserves a block. The SG/ASG
// variants' pass 1 declares it (at most four) as its minimum blocks an SM
// (slab_march_bwd.cu), so that the compiler's register budget is the one
// the launch can use.
template <class V, typename PT>
constexpr int smem_blocks() {
  return (int)(233472 / (march_smem<V, PT>() + sizeof(MarchStatic) + 3072));
}

// march_loop's shared memory: the block's dynamic bytes and its MarchStatic
__device__ __forceinline__ MarchSmem carve(unsigned char* dyn,
                                           MarchStatic& st) {
  MarchSmem sm;
  sm.chan = reinterpret_cast<float4*>(dyn);
  sm.ring = reinterpret_cast<uint32_t*>(dyn + (size_t)PS * PS * 16);
  sm.rec = reinterpret_cast<char*>(dyn + (size_t)PS * PS * 16 + RING_BYTES);
  sm.zr = st.zr;
  sm.rng = st.rng;
  sm.list = st.list;
  sm.wsum = st.wsum;
  return sm;
}

// Counts of a launch, summed over its blocks when ``counts`` is given:
// [0] slabs met (a non-empty footprint in the tile's slab range), [1]
// slabs shaded (a cell above the threshold; composited), [2] footprint
// pieces met, [3] pieces staged (their coarse occupancy set), [4] pieces
// shaded.
constexpr int N_COUNTS = 5;

__device__ __forceinline__ void add_counts(unsigned long long* counts,
                                           int tid, const long long* n) {
  if (counts != nullptr && tid == 0) {
#pragma unroll
    for (int i = 0; i < N_COUNTS; ++i)
      if (n[i]) atomicAdd(counts + i, (unsigned long long)n[i]);
  }
}

// A probe build's clock (VT_TM_CYCLES, probes/train_march.py): thread 0's
// clock cycles by part of march_loop, summed over the blocks into
// cycles[0..5], then [6] the whole loop's cycles summed and [7] their
// largest over the blocks (the launch's critical path); each block's loop
// cycles into block_cycles and its jobs run and shaded into block_jobs
// (low and high 32 bits; the first MAX_BLOCKS blocks, by linear block
// index x + gridDim.x (y + gridDim.y z)); the library's vt_train_cycles
// and vt_train_blocks read and clear them. Other builds' clock is empty.
enum Part { QUEUE, DECIDE, SHADE, TAPS, COMPOSITE, LIST, N_PARTS };
#ifdef VT_TM_CYCLES
constexpr int MAX_BLOCKS = 1 << 16;
__device__ unsigned long long cycles[N_PARTS + 2];
__device__ unsigned long long block_cycles[MAX_BLOCKS];
__device__ unsigned long long block_jobs[MAX_BLOCKS];
struct Clock {
  long long n[N_PARTS], t, t0;
  unsigned jobs = 0, shaded = 0;
  __device__ Clock() {
    for (int i = 0; i < N_PARTS; ++i) n[i] = 0;
    t0 = t = clock64();
  }
  __device__ void job() { ++jobs; }
  __device__ void shade() { ++shaded; }
  __device__ void start() { t = clock64(); }
  __device__ void lap(Part p) {
    const long long u = clock64();
    n[p] += u - t;
    t = u;
  }
  __device__ void add(int tid) {
    if (tid != 0) return;
    const unsigned long long loop = clock64() - t0;
    for (int i = 0; i < N_PARTS; ++i)
      atomicAdd(cycles + i, (unsigned long long)n[i]);
    atomicAdd(cycles + N_PARTS, loop);
    atomicMax(cycles + N_PARTS + 1, loop);
    const long long b =
        blockIdx.x +
        (long long)gridDim.x * (blockIdx.y + (long long)gridDim.y * blockIdx.z);
    if (b < MAX_BLOCKS) {
      block_cycles[b] = loop;
      block_jobs[b] = jobs | ((unsigned long long)shaded << 32);
    }
  }
};
#else
struct Clock {
  __device__ void start() {}
  __device__ void lap(Part) {}
  __device__ void job() {}
  __device__ void shade() {}
  __device__ void add(int) {}
};
#endif

// One job: one piece (at most PS x PS cells) of one slab's tile footprint.
struct Job {
  int i;    // index into ids
  int sid;  // the slab
  float z;  // its centre
  Footprint f;     // the tile's footprint on the slab (slab_of only)
  int py, px;      // the piece's first cell
  int FY, FX;      // its rows and columns
};

// slab ids[i]'s centre and the tile's footprint on it, clipped to the crop
__device__ __forceinline__ void slab_of(Job& j, const MarchCtx& c, int i) {
  j.i = i;
  j.sid = __ldg(c.ids + i);
  j.z = ((float)j.sid + 0.5f) / c.Gf + c.zbase;
  j.f = tile_footprint(c.cyG, c.cxG, j.z - c.hG - c.cz, j.z + c.hG - c.cz,
                       c.ujGa, c.ujGb, c.vkGa, c.vkGb, c.G, c.y0, c.yend,
                       c.x0, c.xend);
}

// footprint pieces along the rows and the columns (0 when it is empty)
__device__ __forceinline__ int pieces_y(const Job& j) {
  return j.f.y_lo <= j.f.y_hi && j.f.x_lo <= j.f.x_hi
             ? (j.f.y_hi - j.f.y_lo) / PS + 1
             : 0;
}
__device__ __forceinline__ int pieces_x(const Job& j) {
  return (j.f.x_hi - j.f.x_lo) / PS + 1;
}

// does piece (py, px) of slab j hold a coarse block with a voxel above the
// threshold? (a piece spans at most two mask words)
__device__ __forceinline__ bool coarse_live(const Job& j, const MarchCtx& c,
                                            int py, int px) {
  const int FY = min(PS, j.f.y_hi - py + 1);
  const int FX = min(PS, j.f.x_hi - px + 1);
  const int r0 = (py - c.y0) / OCC, r1 = (py + FY - 1 - c.y0) / OCC;
  const int b0 = (px - c.x0) / OCC, b1 = (px + FX - 1 - c.x0) / OCC;
  const unsigned long long* slab =
      c.occ + (long long)j.sid * c.occ_rows * c.occ_words;
  bool live = false;
  for (int w = b0 >> 6; w <= (b1 >> 6); ++w) {
    const int lo = max(b0 - 64 * w, 0), hi = min(b1 - 64 * w, 63);
    const unsigned long long bits = (~0ull >> (63 - hi)) & (~0ull << lo);
    for (int r = r0; r <= r1; ++r)
      live |= (__ldg(slab + r * c.occ_words + w) & bits) != 0;
  }
  return live;
}

// a staged job as the list holds it: the slab's index into ids, the
// piece's first cell, its rows and columns, the slab
__device__ __forceinline__ int4 job_entry(const Job& j, int py, int px) {
  const int FY = min(PS, j.f.y_hi - py + 1);
  const int FX = min(PS, j.f.x_hi - px + 1);
  return make_int4(j.i, (py << 16) | px, (FY << 16) | FX, j.sid);
}

__device__ __forceinline__ void job_at(Job& j, const MarchCtx& c,
                                       int4 e) {
  j.i = e.x;
  j.sid = e.w;
  j.z = ((float)j.sid + 0.5f) / c.Gf + c.zbase;
  j.py = e.y >> 16;
  j.px = e.y & 0xffff;
  j.FY = e.z >> 16;
  j.FX = e.z & 0xffff;
}

// Build one round of the block's staged-job list: thread t takes slab
// index i_begin + t (below i1), counts its footprint's pieces whose coarse
// occupancy is set (the first slab's from piece p_begin on), and the block
// writes them in march order, as many whole slabs as LIST_CAP holds; a
// first slab with more such pieces than that gives its first LIST_CAP and
// is resumed by the next round. Returns the entries; (i_next, p_next) is
// where the next round starts. Every thread calls it (it synchronizes).
// ``met`` (thread 0's counts, or null) adds the slabs with a non-empty
// footprint, their pieces and the staged ones.
__device__ __forceinline__ int build_list(const MarchCtx& c,
                                          const MarchSmem& sm,
                                          int i_begin, int p_begin,
                                          int i1, int& i_next, int& p_next,
                                          long long* met) {
  const int lane = c.tid & 31, warp = c.tid >> 5;
  const int i = i_begin + c.tid;
  const int p0 = c.tid == 0 ? p_begin : 0;
  Job j;
  int cnt = 0, npy = 0, npx = 0;
  if (i < i1) {
    slab_of(j, c, i);
    npy = pieces_y(j);
    npx = npy ? pieces_x(j) : 0;
    for (int p = p0; p < npy * npx; ++p)
      cnt += coarse_live(j, c, j.f.y_lo + (p / npx) * PS,
                         j.f.x_lo + (p % npx) * PS);
  }
  // block-wide inclusive scan of cnt (warp scans, then the warp totals)
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) sm.wsum[warp] = incl;
  if (c.tid < 4) sm.wsum[NT / 32 + c.tid] = 0;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += sm.wsum[w];
  // a first slab whose pieces overflow the list is taken in part
  const bool split = c.tid == 0 && i < i1 && cnt > LIST_CAP;
  const bool take = i < i1 && (incl <= LIST_CAP || split);
  if (take) {
    int at = incl - cnt, p = p0;
    for (; p < npy * npx && at < LIST_CAP; ++p) {
      const int py = j.f.y_lo + (p / npx) * PS;
      const int px = j.f.x_lo + (p % npx) * PS;
      if (coarse_live(j, c, py, px)) sm.list[at++] = job_entry(j, py, px);
    }
    if (split) sm.wsum[NT / 32 + 3] = p;
    if (met != nullptr && p0 == 0) {
      if (npy) atomicAdd(sm.wsum + NT / 32, 1);
      atomicAdd(sm.wsum + NT / 32 + 1, npy * npx);
    }
    atomicMax(sm.wsum + NT / 32 + 2, at);
  }
  const int n_take = __syncthreads_count(take);  // a prefix of the threads
  const int n = sm.wsum[NT / 32 + 2];
  if (met != nullptr) {
    met[0] += sm.wsum[NT / 32];
    met[2] += sm.wsum[NT / 32 + 1];
    met[3] += n;
  }
  p_next = sm.wsum[NT / 32 + 3];  // > 0 only where the first slab split
  i_next = i_begin + n_take - (p_next > 0);
  __syncthreads();  // wsum is read before the next round writes it
  return n;
}

// the payload element of the record of piece cell i (FX columns)
__device__ __forceinline__ long long cell_elem(const Job& j,
                                               const MarchCtx& c, int i,
                                               int FX) {
  const int ly = i / FX, lx = i - ly * FX;
  return (long long)j.sid * c.pv.ss +
         (long long)(j.py + ly - c.y0) * c.pv.sr +
         (long long)(j.px + lx - c.x0) * c.pv.sc;
}

// queue the sigma words of job j (if ``has``) into ``slot`` and commit a
// copy group (empty when there is no job, so that every job has one). Cell
// i is copied, checked and shaded by thread i % NT only, so the ring needs
// no barrier. Records hold D values, sigma last.
template <typename PT>
__device__ __forceinline__ void issue(const Job& j, bool has,
                                      const MarchCtx& c, uint32_t* slot,
                                      int D) {
  if (has) {
    for (int i = c.tid; i < j.FY * j.FX; i += NT)
      cp4(slot + i, word_of<PT>(c.pv.ptr, cell_elem(j, c, i, j.FX) + D - 1));
  }
  commit();
}

// this thread's record slot k of colour set ``set``: slots are laid out
// [set][k][thread], rec_slot bytes each
template <int D, typename PT>
__device__ __forceinline__ char* rec_slot_of(const MarchCtx& c,
                                             const MarchSmem& sm, int set,
                                             int k) {
  return sm.rec +
         ((size_t)(set * RSLOTS + k) * NT + c.tid) * rec_slot<D, PT>();
}

// is piece cell i of job j (FX columns), of sigma ``sig``, shaded: sigma
// above the threshold and, for an option variant, the voxel in the bbox?
template <class V>
__device__ __forceinline__ bool cell_live(float sig, const MarchCtx& c,
                                          const TrainOpt& o, const Job& j,
                                          int i, int FX) {
  if (!(sig > c.sigma_thresh)) return false;
  if constexpr (V::OPT) {
    const int ly = i / FX;
    return in_box<V>(o, c.Gf, j.py + ly, j.px + i - ly * FX);
  }
  return true;
}

// queue the colour records of job j's shaded cells (cell_live: this
// thread's cells, whose sigma words have landed in ``ring_slot``) into its
// slots of colour set ``set``, at most RSLOTS of them (the shading stages
// any further one itself), and commit a copy group (empty without a job)
template <class V, typename PT>
__device__ __forceinline__ void issue_colour(const Job& j, bool has,
                                             const MarchCtx& c,
                                             const MarchSmem& sm,
                                             const TrainOpt& o,
                                             const uint32_t* ring_slot,
                                             int set, float qsig, int D) {
  if (has) {
    int k = 0;
    for (int i = c.tid; i < j.FY * j.FX && k < RSLOTS; i += NT) {
      const long long e = cell_elem(j, c, i, j.FX);
      if (cell_live<V>(sigma_of<PT>(ring_slot[i], e + D - 1) * qsig, c, o,
                       j, i, j.FX))
        stage_record<V, PT>(rec_slot_of<V::DMAX, PT>(c, sm, set, k++),
                            reinterpret_cast<const PT*>(c.pv.ptr) + e, D);
    }
  }
  commit();
}

// The training march's slab loop, shared by kernel M's training mode and
// the backward's forward recompute (every thread of the block calls it).
//
// - The tile's slab range: the slabs of ``ids`` that the union of its
//   pixels' z intervals meets (a slab outside it has frac_z = 0 for every
//   pixel: skipping it is exact).
// - Jobs, one a footprint piece (at most PS x PS cells) of a slab, in march
//   order; a piece whose coarse occupancy is empty is passed over without
//   reading the payload (exact: its cells would shade to zero). The block
//   lists the other pieces together (build_list: a thread a slab, a scan),
//   in rounds of up to LIST_CAP, so no thread walks the empty ones.
// - The listed jobs go through a ring of RING stages: the sigma words of
//   the next RING - 1 jobs are in flight (cp.async) while the current one
//   is decided and shaded, and the colour records of the cells above the
//   threshold of the job DC ahead are queued into the threads' record
//   slots as soon as its sigma has landed (DC = 0: the current job's,
//   staged as it is shaded).
// - A job whose staged sigma has no cell above the threshold is skipped
//   after one barrier (__syncthreads_or): it would shade to zero, so the
//   tap sums and the composite would not change (exact).
// - Otherwise the block checks once per slab that a pixel can still
//   accumulate (else it leaves the loop: exact, as in the reference's
//   _window_live gate), each thread shades its cells above the threshold
//   from their staged records into ``chan``, and each pixel sums its
//   separable overlap weights over its span's cells of the piece.
// - When the march moves past a slab with a cell above the threshold,
//   ``on_slab(job, span, (sw, rw, gw, bw))`` composites it (every thread
//   calls it; it may synchronize).
// ``T`` is the pixel's transmittance, which on_slab updates. V is the
// variant (TVar): an option variant's cells are shaded only inside its
// bbox (cell_live), by voxel_rgb_opt (SG and ASG: lobe_sums) with the
// state ``opt``.
template <class V, typename PT, typename OnSlab>
__device__ __forceinline__ void march_loop(const MarchCtx& c,
                                           const MarchSmem& sm,
                                           const float* s_qs,
                                           const float* s_prm,
                                           const TrainOpt& opt,
                                           const float& T,
                                           unsigned long long* counts,
                                           OnSlab&& on_slab) {
  constexpr int BD = V::BD;
  const int D = rec_dim<V>(opt);
  constexpr int CELLS = PS * PS;
  const int warp = c.tid >> 5, lane = c.tid & 31;
  Clock clk;
  // ---- the tile's slab range ---------------------------------------------
  const bool valid = c.inpix && (c.zlo <= c.zhi);
  float za = valid ? c.zlo : 3.4e38f, zb = valid ? c.zhi : -3.4e38f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    za = fminf(za, __shfl_xor_sync(0xffffffffu, za, o));
    zb = fmaxf(zb, __shfl_xor_sync(0xffffffffu, zb, o));
  }
  if (lane == 0) {
    sm.zr[warp] = za;
    sm.zr[NT / 32 + warp] = zb;
  }
  if (c.tid == 0) {
    sm.rng[0] = c.n_ids;
    sm.rng[1] = 0;
  }
  __syncthreads();
  float zmin = 3.4e38f, zmax = -3.4e38f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    zmin = fminf(zmin, sm.zr[w]);
    zmax = fmaxf(zmax, sm.zr[NT / 32 + w]);
  }
  for (int i = c.tid; i < c.n_ids; i += NT) {
    const float z = ((float)__ldg(c.ids + i) + 0.5f) / c.Gf + c.zbase;
    if (zmin <= z + c.hG && zmax >= z - c.hG) {
      atomicMin(sm.rng, i);
      atomicMax(sm.rng + 1, i + 1);
    }
  }
  __syncthreads();
  const int i0 = sm.rng[0], i1 = sm.rng[1];
  long long n_cnt[N_COUNTS] = {};
  long long* met = counts != nullptr ? n_cnt : nullptr;
  if (i0 >= i1) {
    clk.add(c.tid);
    add_counts(counts, c.tid, n_cnt);
    return;
  }

  // ---- the staged jobs, in rounds of the list, through the ring ----------
  // Each iteration n commits two copy groups: the sigma of job n + RING - 1
  // (S), then the colour records of job n + DC (C); so before the colour of
  // job n + DC is queued, all but the newest 2 (RING - 1 - DC) groups hold
  // S(n + DC), and before job n is shaded all but the newest 2 DC hold C(n).
  const float qsig = s_qs[D - 1];
  float sw = 0.f, rw = 0.f, gw = 0.f, bw = 0.f;
  bool slab_any = false;  // the slab held a cell above the threshold
  Job slab;               // the slab being summed
  slab.i = -1;
  PixelSpan sp;
  bool left = false;      // no pixel of the tile can still accumulate
  for (int i_cur = i0, p_cur = 0; i_cur < i1 && !left;) {
    clk.start();
    const int nj = build_list(c, sm, i_cur, p_cur, i1, i_cur, p_cur, met);
    Job pj, qj, cons;
#pragma unroll
    for (int r = 0; r < RING - 1; ++r) {
      if (r < nj) job_at(pj, c, sm.list[r]);
      issue<PT>(pj, r < nj, c, sm.ring + r * CELLS, D);
    }
    wait_n<0>();
#pragma unroll
    for (int d = 0; d < DC; ++d) {
      if (d < nj) job_at(qj, c, sm.list[d]);
      issue_colour<V, PT>(qj, d < nj, c, sm, opt,
                          sm.ring + (d % RING) * CELLS, d % (DC + 1), qsig,
                          D);
    }
    clk.lap(LIST);
    for (int n = 0; n < nj; ++n) {
      clk.job();
      job_at(cons, c, sm.list[n]);
      if (cons.i != slab.i) {  // the march has moved past the slab
        if (slab_any) {
          clk.start();
          on_slab(slab, sp, make_float4(sw, rw, gw, bw));
          clk.lap(COMPOSITE);
        }
        sw = rw = gw = bw = 0.f;
        slab_any = false;
        slab_of(slab, c, cons.i);
        sp = pixel_span(c.cyG, c.cxG, slab.z - c.hG - c.cz,
                        slab.z + c.hG - c.cz, c.ujG, c.vkG, c.G, slab.f);
      }
      clk.start();
      const int m = n + RING - 1, m2 = n + DC;
      if (m < nj) job_at(pj, c, sm.list[m]);
      issue<PT>(pj, m < nj, c, sm.ring + (m % RING) * CELLS, D);
      wait_n<2 * (RING - 1 - DC)>();  // S(n + DC) has landed
      if (m2 < nj) job_at(qj, c, sm.list[m2]);
      issue_colour<V, PT>(qj, m2 < nj, c, sm, opt,
                          sm.ring + (m2 % RING) * CELLS, m2 % (DC + 1), qsig,
                          D);
      clk.lap(QUEUE);
      const uint32_t* slot = sm.ring + (n % RING) * CELLS;
      const int FY = cons.FY, FX = cons.FX;
      bool above = false;
      for (int i = c.tid; i < FY * FX; i += NT)
        above |= cell_live<V>(
            sigma_of<PT>(slot[i], cell_elem(cons, c, i, FX) + D - 1) * qsig,
            c, opt, cons, i, FX);
      const bool any = __syncthreads_or(above);
      clk.lap(DECIDE);
      if (!any) continue;
      if (!slab_any) {
        // once per slab: can a pixel of the tile still accumulate?
        const bool passed = c.flip ? (cons.z + c.hG < c.zlo)
                                   : (cons.z - c.hG > c.zhi);
        const bool alive = c.inpix && (T >= c.stop_thresh) &&
                           (c.zlo <= c.zhi) && !passed;
        if (!__syncthreads_or(alive)) {
          left = true;
          break;
        }
        slab_any = true;
        ++n_cnt[1];
      }
      ++n_cnt[4];
      clk.shade();
      wait_n<2 * DC>();  // C(n) has landed
      // view directions per slab, at the slab's distance
      const float sd = cons.z - c.cz;
      const float sdsign = sign_of(sd);
      const int set = n % (DC + 1);
      int k = 0;  // this thread's cells above the threshold so far
      for (int i = c.tid; i < FY * FX; i += NT) {
        const long long e = cell_elem(cons, c, i, FX);
        const float sig = sigma_of<PT>(slot[i], e + D - 1) * qsig;
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
        if (cell_live<V>(sig, c, opt, cons, i, FX)) {
          const PT* src = reinterpret_cast<const PT*>(c.pv.ptr) + e;
          const PT* rec;
          if (k < RSLOTS) {
            rec = staged<V, PT>(rec_slot_of<V::DMAX, PT>(c, sm, set, k), src,
                                D);
          } else {  // more cells than slots: stage this one now
            rec = stage_record<V, PT>(
                rec_slot_of<V::DMAX, PT>(c, sm, set, RSLOTS - 1), src, D);
            commit();
            wait_n<0>();
          }
          ++k;
          const int ly = i / FX, lx = i - ly * FX;
          const float ycm =
              ((float)(cons.py + ly) + 0.5f) * (1.f / c.Gf) - c.cy;
          const float xcm =
              ((float)(cons.px + lx) + 0.5f) * (1.f / c.Gf) - c.cx;
          float bk[BD], rgb[3];
          if constexpr (V::RTD) {
            const float3 r = lobe_sums<V>(rec, opt, s_prm, ycm, xcm, sd,
                                          sdsign, nullptr, nullptr);
            rgb[0] = sigmoid(r.x);
            rgb[1] = sigmoid(r.y);
            rgb[2] = sigmoid(r.z);
          } else {
            float vals[V::DMAX];
            load_record<V::DMAX, PT>(rec, vals);
            if constexpr (V::OPT)
              voxel_rgb_opt<V>(vals, opt, s_qs, s_prm, ycm, xcm, sd, sdsign,
                               bk, rgb);
            else
              voxel_rgb<BD>(vals, s_qs, s_prm, ycm, xcm, sd, sdsign, bk, rgb);
          }
          o = make_float4(sig, sig * rgb[0], sig * rgb[1], sig * rgb[2]);
        }
        sm.chan[i] = o;
      }
      clk.lap(SHADE);
      __syncthreads();
      if (c.inpix) {
        const int ya = max(sp.ry_lo, cons.py);
        const int yb = min(sp.ry_hi, cons.py + FY - 1);
        const int xa = max(sp.rx_lo, cons.px);
        const int xb = min(sp.rx_hi, cons.px + FX - 1);
        for (int cyy = ya; cyy <= yb; ++cyy) {
          const float wr = overlap(cyy, c.G, sp.pmin, sp.pmax, sp.inv_r);
          const float4* row = sm.chan + (cyy - cons.py) * FX - cons.px;
          for (int cxx = xa; cxx <= xb; ++cxx) {
            const float wgt =
                wr * overlap(cxx, c.G, sp.qmin, sp.qmax, sp.inv_c);
            const float4 v = row[cxx];
            sw += wgt * v.x;
            rw += wgt * v.y;
            gw += wgt * v.z;
            bw += wgt * v.w;
          }
        }
      }
      clk.lap(TAPS);
    }
    wait_n<0>();  // the round's copies have landed before the list changes
  }
  if (slab_any) {  // the last slab marched (not set when the loop left)
    clk.start();
    on_slab(slab, sp, make_float4(sw, rw, gw, bw));
    clk.lap(COMPOSITE);
  }
  clk.add(c.tid);
  add_counts(counts, c.tid, n_cnt);
}

// ---- the launch's variant (host) -------------------------------------------

// The options of a launch as VarArgs: fmt (F_*), bd (SH's basis functions;
// SG/ASG's lobes, 1 to 25; -1 for RGBA), opt (the option variant, which
// every format but SH takes, and SH with rot, a bbox or a basis window
// [blo, bhi] that drops planes), ``extra`` (SG/ASG: the lobes on the
// device), rot (9 floats on the host, when rot_on). False where they do
// not hold together.
inline bool make_var(int fmt, int bd, int opt, const void* extra,
                     int rot_on, const void* rot, int bbox, int blo, int bhi,
                     VarArgs& va) {
  const bool cuts = fmt == F_SH && (blo > 0 || bhi < bd - 1);
  if (fmt < F_RGBA || fmt > F_ASG || (fmt == F_RGBA) != (bd < 0) ||
      (!opt && (fmt != F_SH || rot_on || bbox || cuts)) ||
      (rot_on && !rot) || (fmt >= F_SG && (!extra || bd < 1 || bd > 25)))
    return false;
  va.extra = (const float*)extra;
  va.nb = fmt == F_RGBA ? 1 : bd;
  va.rot_on = rot_on;
  va.bbox = bbox;
  va.blo = blo;
  va.bhi = bhi;
  for (int i = 0; i < 9; ++i)
    va.rot[i] = rot_on ? ((const float*)rot)[i] : (i % 4 == 0 ? 1.f : 0.f);
  return true;
}

template <typename T>
struct Elem {
  using type = T;
};

template <class V, class F>
int with_payload(int f32, F& f) {
  return f32 ? f(V{}, Elem<float>{}) : f(V{}, Elem<__nv_bfloat16>{});
}

template <int FM, class F>
int with_lobes(int nb, int f32, F& f) {
  if (nb >= 1 && nb <= 4) return with_payload<TVar<FM, true, 4>>(f32, f);
  if (nb > 4 && nb <= 9) return with_payload<TVar<FM, true, 9>>(f32, f);
  if (nb > 9 && nb <= 16) return with_payload<TVar<FM, true, 16>>(f32, f);
  if (nb > 16 && nb <= 25) return with_payload<TVar<FM, true, 25>>(f32, f);
  return (int)cudaErrorInvalidValue;
}

// The library that holds the variant (fmt, opt): each training source is
// built three times, in parallel (volrend_torch/kernels), its
// instantiations split by VT_TRAIN_SET: 0 the defaults (SH without
// options), 1 SH with options and RGBA, 2 SG and ASG.
#ifndef VT_TRAIN_SET
#define VT_TRAIN_SET 0
#endif
inline int train_set(int fmt, int opt) {
  return fmt >= F_SG ? 2 : (opt ? 1 : 0);
}

// Call f(V{}, Elem<PT>{}) with the instantiation of (fmt, bd, opt) and the
// payload's element (f32, else bf16): SH of degree 0-4 without options
// (the defaults, ShVar) and with them; SG and ASG with lobe counts up to 4,
// 9, 16 and 25 (the count at run time); RGBA. Returns f's result, or
// cudaErrorInvalidValue for a variant this library does not hold.
template <class F>
int with_variant(int fmt, int bd, int opt, int f32, F&& f) {
  if (train_set(fmt, opt) != VT_TRAIN_SET || (!opt && fmt != F_SH))
    return (int)cudaErrorInvalidValue;
  if constexpr (VT_TRAIN_SET == 2) {
    if (fmt == F_SG) return with_lobes<F_SG>(bd, f32, f);
    if (fmt == F_ASG) return with_lobes<F_ASG>(bd, f32, f);
  } else {
    if constexpr (VT_TRAIN_SET == 1) {
      if (fmt == F_RGBA && bd < 0)
        return with_payload<TVar<F_RGBA, true, 1>>(f32, f);
    }
    if (fmt == F_SH) {
#define VT_SH(B) \
  case B:        \
    return with_payload<TVar<F_SH, VT_TRAIN_SET == 1, B>>(f32, f);
      switch (bd) {
        VT_SH(1)
        VT_SH(4)
        VT_SH(9)
        VT_SH(16)
        VT_SH(25)
        default: break;
      }
#undef VT_SH
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace tmarch

}  // namespace

#ifdef VT_TM_CYCLES
// A probe build's clock (tmarch::Clock): copy its N_PARTS + 2 counters to
// ``out`` (host) and clear them. Returns a CUDA error code.
extern "C" int vt_train_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, tmarch::cycles,
                                       sizeof(tmarch::cycles));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[tmarch::N_PARTS + 2] = {};
  return (int)cudaMemcpyToSymbol(tmarch::cycles, zero, sizeof(zero));
}

// The loop cycles (block_cycles) and the jobs (block_jobs) of the last
// launch's first ``n`` blocks (n <= tmarch::MAX_BLOCKS) into ``cycles``
// and ``jobs`` (host), then clear them.
extern "C" int vt_train_blocks(unsigned long long* cycles,
                               unsigned long long* jobs, int n) {
  if (n < 0 || n > tmarch::MAX_BLOCKS) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)n * sizeof(unsigned long long);
  cudaError_t e = cudaMemcpyFromSymbol(cycles, tmarch::block_cycles, bytes);
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(jobs, tmarch::block_jobs, bytes);
  void* dev = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&dev, tmarch::block_cycles);
  if (e == cudaSuccess) e = cudaMemset(dev, 0, bytes);
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&dev, tmarch::block_jobs);
  if (e == cudaSuccess) e = cudaMemset(dev, 0, bytes);
  return (int)e;
}
#endif
