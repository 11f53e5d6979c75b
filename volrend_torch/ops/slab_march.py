"""The fused slab march and its backward (the counterpart of
``volrend_tpu/ops/pallas_slab.py``).

Per (perm, flip) pose group the payload is channel-planar and slab-major,
(Gz, Dp, Gy, Gx). ``march_slabs`` walks the occupied slabs front to back
and, per slab and per intermediate pixel of the (gi, gi) slope grid:

- dequantizes and shades every voxel the pixel's ray can cross:
  sigma masked by the sigma threshold, and srgb = sigma * sigmoid(sum_k
  code * basis_k * qs_k);
- warps [sigma, sigma*r, sigma*g, sigma*b] onto the pixel with the
  separable box-integration two-tap weights (``_overlap_mats`` — each weight
  is the exact overlap of the ray's within-slab span with a cell; edge cells
  extend to +-inf, cell indices stay global under the in-plane crop);
- composites tau = sigma_w * dt_pix * frac_z front to back with the
  stop-threshold freeze.

Two option sets are taken:

- the display path's: an int8 payload (colour codes, then the 14-bit
  sigma's hi and lo planes, Dp = D + 1; ``sig2=True``) or the f16 bake's
  bf16 payload (sigma in the last plane, Dp = D), with the view direction
  taken once per K-slab window at the window centre (``dir_win=True``, the
  default of the ``_DIR_WIN`` knob) or per slab (``dir_win=False``), and
  SH shading in f32 or, with ``shade_bf16`` (the ``_BF16_SHADE`` knob), in
  bf16; every format (SH, SG and ASG with their lobes in ``extra``, RGBA)
  and option (depth mode, ``rot``, a non-full bbox, any basis window);
- the training path's: the bake's own f32 or bf16 tensor, seen as the
  (Gz, D, Gy, Gx) view of the pose group's permutation (channel stride 1:
  each voxel's D values are one record; ``_record_strides``), with
  sigma last and the view direction per slab (``dir_win=False``), all slabs
  or a culled list (``train=True``); every format and option of the display
  path but depth mode, which the reference's training path never marches,
  and bf16 shading, which it never takes. Both versions
  round f32 to bf16 as they read it, so both dtypes march the values of
  the bake's bf16 copy. ``march_slabs_bwd`` is its payload cotangent,
  written through the same strides.

On CUDA tensors ``march_slabs`` launches kernel M, one launch per pose
batch: its display mode (``csrc/slab_march_display.cu``, which stages each
tile's footprint with cp.async; ``display_config`` picks its tile height
and sizes its stage; ``display_variant`` names the instantiation a
launch takes) or its training mode (``csrc/slab_march.cu``, which
stages sigma ahead, skips footprints with no voxel above the threshold and
stages colour only above it; its tile, pieces and ring are fixed when it
is built, ``csrc/slab_common.cuh``; ``train_variant`` names the
instantiation a launch takes); ``march_slabs_bwd`` launches the backward
kernel (``csrc/slab_march_bwd.cu``). Both modes march a z-segment of the
grid too (``z_base``, the segment's global z, and ``acc_init``, the
upstream segments' accumulator, which takes the kernels' resume
variants), and the backward a slab-major segment from its incoming (T, A)
(``state_init``): the parallel layer's z-sharded paths
(``volrend_torch/parallel/dist.py``, ``slab_grad._MarchKernel`` with a
mesh). On CPU tensors they run
``march_slabs_ref`` and ``march_slabs_bwd_ref``, the same functions in plain
PyTorch (dense overlap matrices, as the reference builds them). Kernel and
plain version differ only in summation order. Unlike the reference kernels,
neither rounds the warp weights or the stacked channels to bf16.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from volrend_torch import kernels
from volrend_torch.models.data_format import BasisType
from volrend_torch.ops import basis as basis_mod
from volrend_torch.utils.device import to_device

__all__ = ["march_slabs", "march_slabs_ref", "march_slabs_bwd",
           "march_slabs_bwd_ref", "march_bwd_inputs", "march_occupancy",
           "MarchMode", "train_variant", "train_lib",
           "march_occupancy_ref", "march_occupancy_live_ref", "LiveBits",
           "display_config", "march_slab_ids"]

_F32 = torch.float32
#: the training mode's payload dtypes: the default trainer's f32 bake and
#: the lean trainer's bf16 one
_TRAIN_DTYPES = (torch.float32, torch.bfloat16)

#: display-path slabs per window (the view direction is shared by the
#: window's slabs; K-aligned occupancy masks)
_K_STEP = 4

#: the display march's knobs, read at call time by
#: slab_render._march_finalize, as the reference reads pallas_slab's
#: (volrend_tpu/ops/pallas_slab.py:85-107): bf16 SH shading (the basis
#: planes and the payload multiply-adds in bf16 pairs; off), and the view
#: direction shared by a K-slab window (at its centre; on) or taken per
#: slab (off)
_BF16_SHADE = False
_DIR_WIN = True

# params vector layout (f32): see _pack_params (+1 slot appended by
# march_slabs: [30] = z_base, the global z of the payload's first slab)
_NP = 31

#: the display kernel's rotation when rot_dirs is off
_IDENTITY = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)

#: dynamic shared memory a display block may take (two blocks an SM)
_DISPLAY_SMEM = 110 * 1024
#: RGBA's kernel of its own (``MarchMode.rgba_raw``): the dynamic shared
#: memory a block takes at two and at three blocks an SM (csrc/
#: slab_march_display.cu RG_SMEM3)
_RGBA_SMEM = {2: _DISPLAY_SMEM, 3: 72 * 1024}
_DTX, _DWARPS = 32, 8       # a display tile's columns; warps a block


def _col(v, P: int, device) -> torch.Tensor:
    """Scalar / (P,) value -> (P,) f32 tensor on ``device``."""
    t = to_device(v, _F32, device)
    return t.expand(P) if t.dim() == 0 else t.reshape(P)


def _pack_params(cz, cy, cx, u0, du, v0, dv, sgn, spp, inv_scale,
                 sigma_thresh, stop_thresh, lo1, hi1, lo2, hi2,
                 dirM, z0_depth) -> torch.Tensor:
    """Per-pose scalar params, (P, 30) f32 (the reference's 30-slot layout
    with a leading pose dimension). Per-pose values are (P,) tensors,
    shared ones scalars. params[20:29] = dirM row-major: the affine map
    from a voxel's slope-grid coordinates to its (unnormalized) world view
    direction, dir[a] = dirM[a,0] + dirM[a,1]*u + dirM[a,2]*v.
    params[29] = the depth-mode t origin along the slab axis."""
    P = cz.shape[0]
    dev = cz.device
    cols = [cz, cy, cx, u0, du, v0, dv, sgn, spp[0], spp[1], spp[2],
            inv_scale[0], inv_scale[1], inv_scale[2],
            sigma_thresh, stop_thresh, lo1, hi1, lo2, hi2]
    head = torch.stack([_col(c, P, dev) for c in cols], -1)
    dirM = torch.as_tensor(dirM, dtype=_F32, device=dev).reshape(P, 9)
    return torch.cat([head, dirM, _col(z0_depth, P, dev)[:, None]], -1)


def _zb_planes(params: torch.Tensor, zbounds: torch.Tensor, G: int,
               gi: int) -> torch.Tensor:
    """Extend the (P, 2, gi, gi) zbounds with the two per-frame-constant
    composite planes: plane 2 = dt_pix (per-pixel slab thickness along the
    ray, world units), plane 3 = the depth-mode tview base."""
    u0, du, v0, dv = (params[:, i, None, None] for i in (3, 4, 5, 6))
    spp0, spp1, spp2 = (params[:, i, None, None] for i in (8, 9, 10))
    io = torch.arange(gi, dtype=_F32, device=params.device)
    up_r = u0 + du * io[None, :, None]
    vp_r = v0 + dv * io[None, None, :]
    up = up_r * spp1
    vp = vp_r * spp2
    dt_pix = (1.0 / G) * torch.sqrt(up * up + vp * vp + spp0 * spp0)
    tview = torch.sqrt(1.0 + up_r * up_r + vp_r * vp_r)
    return torch.cat([zbounds, dt_pix[:, None], tview[:, None]], 1)


def _march_k(Gz: int, k_per_step: int) -> int:
    """Slabs per window: k_per_step, shrunk to divide the slab count."""
    K = max(1, min(k_per_step, Gz))
    while Gz % K:
        K -= 1
    return K


def _window_masks(slab_ids: Sequence[int], K: int
                  ) -> Tuple[List[int], List[int]]:
    """Group march-ordered slab ids into K-aligned windows (in first-visit
    order) with occupancy bit masks (bit dz set = slab w*K+dz occupied)."""
    win_order, win_mask = [], {}
    for sid in slab_ids:
        w = sid // K
        if w not in win_mask:
            win_mask[w] = 0
            win_order.append(w)
        win_mask[w] |= 1 << (sid % K)
    return win_order, [win_mask[w] for w in win_order]


#: the SG/ASG lobe counts the march takes (kernel M's display mode reads
#: the count at run time; its training mode and M-bwd are compiled for
#: counts up to 4, 9, 16 and 25)
DISPLAY_LOBES = range(1, 26)


def _check_format(fmt, bd: int, D: int, extra) -> None:
    """The basis formats of the march (the reference's ``_pallas_ok``):
    SH of degree 0-4, SG and ASG with their lobes in ``extra`` (bd x 4 and
    bd x 11 floats), RGBA with D = 4."""
    bt = BasisType(fmt)
    if bt in (BasisType.SG, BasisType.ASG):
        if bd not in DISPLAY_LOBES:
            raise ValueError(
                f"{bt.name}{bd}: the march takes {DISPLAY_LOBES.start}.."
                f"{DISPLAY_LOBES.stop - 1} lobes")
        n = bd * (4 if bt == BasisType.SG else 11)
        ok = (D == 3 * bd + 1 and extra is not None
              and int(torch.as_tensor(extra).numel()) == n)
    elif bt == BasisType.SH:
        ok = bd in basis_mod.SH_SUPPORTED_DIMS and D == 3 * bd + 1
    else:
        ok = bd < 0 and D == 4
    if not ok:
        raise ValueError(f"format {bt.name}{bd} with data_dim {D} (and "
                         f"extra of its lobes) is not a march format")


#: why a training payload refuses depth mode
_TRAIN_DEPTH = ("depth mode on the training payload: the reference's "
                "training path never marches depth (render_frame_train "
                "sets render_depth=False, volrend_tpu/ops/slab_grad.py:609)")


def _check_options(gplanar, G, D, bd, sig2, fmt, extra, depth, rot,
                   basis_lo, basis_hi, bbox_full, shade_bf16, dir_win,
                   train) -> bool:
    """The display mode's option set (an int8 payload or the f16 bake's
    bf16 one, window or per-slab directions, f32 or bf16 SH shading: every
    format and option) or the training mode's (``train``: f32 or bf16,
    per-slab directions, f32 shading: every format and option but depth,
    which raises ValueError); an f32 payload is the training mode's.
    Anything else is a later item. Returns True for the display mode."""
    dt = gplanar.dtype
    if gplanar.dim() != 4 or dt not in (torch.int8,) + _TRAIN_DTYPES:
        raise ValueError(f"payload must be (Gz, Dp, Gy, Gx) int8, f32 or "
                         f"bf16, got {tuple(gplanar.shape)} {dt}")
    if train and dt == torch.int8:
        raise ValueError("the training mode takes the bake's f32 or bf16 "
                         "tensor, not the int8 display payload")
    display = not train and dt != torch.float32
    if depth and not display:
        raise ValueError(_TRAIN_DEPTH)
    if dir_win and not display:
        raise ValueError("window shading directions are the display mode's "
                         "(an int8 or bf16 payload), not the training "
                         "mode's")
    if shade_bf16 and not display:
        raise ValueError("bf16 shading is the display mode's: the "
                         "reference's training path shades in f32")
    _check_format(fmt, bd, D, extra)
    if sig2 != (dt == torch.int8):
        raise ValueError("an int8 payload carries the 14-bit sigma split "
                         "(sig2=True); a bf16 or f32 payload holds sigma in "
                         "one plane (sig2=False)")
    Dp = D + 1 if dt == torch.int8 else D
    if gplanar.shape[1] != Dp:
        raise ValueError(f"{dt} payload has {gplanar.shape[1]} planes; "
                         f"expected {Dp}")
    if not 1 <= gplanar.shape[0] <= G:
        raise ValueError(f"payload must hold at most G = {G} slabs (a "
                         f"z-segment of the grid), got {gplanar.shape[0]}")
    return display


class MarchMode(NamedTuple):
    """The format and options of a march: the basis ``fmt`` and its
    lobes ``extra`` (SG/ASG), ``depth`` (march depth instead of colour; the
    display path only), ``rot`` (9 floats, the view-direction rotation, or
    None), ``bbox_full`` (else the in-plane voxel-extent mask of params
    16-19), the basis window [basis_lo, basis_hi], and the display mode's
    knobs: ``dir_slab`` (the view direction per slab, not per window: the
    kernel takes it as one-slab windows, K = 1, in any variant) and
    ``bf16_shade`` (SH shading in bf16, a variant of its own)."""
    fmt: int = int(BasisType.SH)
    extra: Optional[torch.Tensor] = None
    depth: bool = False
    rot: Optional[Tuple[float, ...]] = None
    bbox_full: bool = True
    basis_lo: int = 0
    basis_hi: int = 24
    dir_slab: bool = False
    bf16_shade: bool = False

    def options(self, bd: int) -> bool:
        """Does this mode take the kernels' option variant (every format
        but SH, and SH with any option that changes the march)? bf16
        shading alone does not: it has a variant of its own without
        options."""
        return (self.fmt != int(BasisType.SH) or self.depth
                or self.rot is not None or not self.bbox_full
                or self.basis_lo > 0 or self.basis_hi < bd - 1)

    def tall_tiles(self, bd: int) -> bool:
        """May the display mode's tile rule give this mode 32x16 tiles
        (``display_config``)? SH without options, with or without bf16
        shading, and SG or ASG without another option: their variants are
        built at both tile heights (RGBA's kernel of its own takes 32x8
        alone: ``rgba_raw``)."""
        lobes = self.fmt in (int(BasisType.SG), int(BasisType.ASG))
        return not (self._replace(fmt=int(BasisType.SH)) if lobes
                    else self).options(bd)

    def rgba_raw(self) -> bool:
        """Does a display launch of this mode take kernel M's RGBA kernel
        of its own (``rgba_kernel``: a producer warp, its taps decoding
        the staged codes, no shade pass; 32x8 tiles)? RGBA without a bbox
        and not in depth mode (rot and the basis window do nothing to
        RGBA); a launch that resumes from an upstream state takes the
        option variant of the resume build instead."""
        return (self.fmt == int(BasisType.RGBA) and not self.depth
                and self.bbox_full)


def display_variant(mode: MarchMode, bd: int, bf16: bool,
                    resume: bool = False) -> str:
    """The name of the display kernel variant a launch takes (the key of
    ``march_slabs.variants``): format, payload, ``opt`` for an SH option
    set or RGBA with a bbox (RGBA without one: ``rgba_kernel``), or
    ``bf16shade`` for bf16 shading (with or without options: two
    variants, vt_march_display's opt 2 and 3), ``depth`` for depth mode,
    ``dirslab`` for per-slab directions, ``resume`` for a launch from an upstream state (``acc_init``: the
    option variants of the resume build); ``SH-int8`` is the default."""
    name = BasisType(mode.fmt).name + ("-bf16" if bf16 else "-int8")
    if mode.bf16_shade:
        name += "-bf16shade"
    elif mode.fmt == int(BasisType.SH) and (mode.options(bd) or resume):
        name += "-opt"
    elif (mode.fmt == int(BasisType.RGBA) and not mode.depth
          and not mode.bbox_full):
        name += "-opt"
    if mode.depth:
        name += "-depth"
    if mode.dir_slab:
        name += "-dirslab"
    if resume:
        name += "-resume"
    return name


def train_variant(mode: MarchMode, bd: int, f32: bool,
                  resume: bool = False) -> str:
    """The name of the training kernels' variant a launch takes (the key of
    ``march_slabs.train_variants`` and ``march_slabs_bwd.variants``):
    format, payload, ``opt`` for an SH option set, ``resume`` for a launch
    from an upstream state (``acc_init``: an option variant); ``SH-f32``
    is the default trainer's."""
    name = BasisType(mode.fmt).name + ("-f32" if f32 else "-bf16")
    if mode.fmt == int(BasisType.SH) and (mode.options(bd) or resume):
        name += "-opt"
    if resume:
        name += "-resume"
    return name


def train_lib(kind: str, fmt: int, opt: bool):
    """The library of a training kernel (``kind``: "slab_march" for kernel
    M's training mode, "slab_march_bwd" for M-bwd) that holds the variant
    of format ``fmt`` with or without options (``MarchMode.options``): the
    defaults, "_opt" (SH with options, RGBA) or "_lobes" (SG, ASG); each
    is one build of the kernel's source (volrend_torch/kernels)."""
    if fmt in (int(BasisType.SG), int(BasisType.ASG)):
        return kernels.lib(kind + "_lobes")
    return kernels.lib(kind + ("_opt" if opt else ""))


def march_slabs(gplanar, params, qscale, zbounds, G: int,
                gi: int, D: int, bd: int,
                perm: Tuple[int, int, int],
                slab_ids: Optional[Tuple[int, ...]] = None,
                basis_lo: int = 0, basis_hi: int = 24, sig2: bool = False,
                extra=None, fmt: int = 1, depth: bool = False,
                rot: Optional[Tuple[float, ...]] = None,
                flip: bool = False, k_per_step: int = 4,
                bbox_full: bool = False, shade_bf16: bool = False,
                dir_win: bool = False, z_base=None, acc_init=None,
                crop: Optional[Tuple[int, int, int, int]] = None,
                occupancy: Optional[torch.Tensor] = None,
                train: bool = False):
    """Run the fused march for a batch of poses sharing one payload;
    returns acc (P, 4, gi, gi): [r, g, b, T].

    gplanar: (G, Dp, Gy, Gx) permuted payload: contiguous channel-planar
        int8 codes with Dp = D+1 (colour codes + 14-bit sigma over the last
        two planes; sig2=True: the display path) or the f16 bake's
        contiguous bf16 planes (Dp = D, sig2=False: the display path), or,
        with ``train``, the bake's f32 or bf16 tensor seen through its
        permutation, Dp = D (sigma last; sig2=False, dir_win=False: the
        training path; on the card its channel stride must be 1,
        ``_record_strides``).
    params: (P, 30) f32 (see _pack_params). qscale: (Dp,) f32, each basis
        function's scale shared across rgb (the int8 bake's; ones for
        training).
    zbounds: (P, 2, gi, gi) f32 per-pixel live z interval.
    slab_ids: slab z-indices in march order, pre-culled of empty slabs;
        None means all G slabs in ascending order.
    flip: True when the march runs toward -z (descending slab ids).
    z_base: the global z (in units of the grid's extent, slab i of the
        payload at (i + 0.5) / G + z_base) of the payload's first slab: the
        payload may be a z-segment of the grid, Gz <= G slabs, whose
        ``slab_ids`` are local; None = 0 (the whole grid).
    acc_init: optional (P, 4, gi, gi) or (4, gi, gi) initial [r, g, b, T]
        accumulator: every pixel resumes from it instead of (0, 0, 0, 1)
        (a segment after an upstream one; the stop threshold sees the
        incoming T). With no slab to march it is returned as it is. On the
        card such a launch takes the kernels' resume variants (the option
        variants at their defaults: ``display_variant``/``train_variant``
        name them "-resume"), so the defaults' code does not carry it.
    crop: optional (y0, Gy, x0, Gx) in-plane occupancy crop of the payload
        (slab_render.inplane_crop); None = uncropped.
    occupancy: the training mode's coarse occupancy of this payload
        (``march_occupancy``, at these poses' sigma threshold), to share one
        between calls; None builds it (on the card; the plain version
        needs none).
    train: the training mode (per-slab directions, f32 shading, no depth),
        which an f32 payload always takes; else the display mode, where
        ``dir_win`` shares the view direction across a K-slab window (else
        per slab) and ``shade_bf16`` shades SH in bf16 (other formats and
        depth mode shade as without it, as in the reference).
    Both paths take every format (``fmt``, ``extra``) and option (``rot``,
    a non-full bbox, any basis window); ``depth`` is the display path's
    only. The remaining arguments mirror the reference's signature (see
    _check_options).
    """
    display = _check_options(gplanar, G, D, bd, sig2, fmt, extra, depth,
                             rot, basis_lo, basis_hi, bbox_full, shade_bf16,
                             dir_win, train)
    mode = MarchMode(int(fmt), extra, bool(depth), rot, bool(bbox_full),
                     int(basis_lo), int(basis_hi),
                     dir_slab=display and not dir_win,
                     bf16_shade=bool(display and shade_bf16 and not depth
                                     and int(fmt) == int(BasisType.SH)))
    # the display kernel evaluates each voxel's basis at its window
    # centre's distance: one-slab windows give each slab its own
    m = march_inputs(gplanar, params, zbounds, G, gi, slab_ids,
                     1 if mode.dir_slab else k_per_step, crop, z_base)
    dev = gplanar.device
    P = m["params"].shape[0]
    segment = (z_base is not None or acc_init is not None
               or gplanar.shape[0] < G)
    if acc_init is not None:
        acc_init = _acc_init(acc_init, P, gi, dev)
    if not m["wins"]:
        if acc_init is not None:
            return acc_init
        acc = torch.zeros((P, 4, gi, gi), dtype=_F32, device=dev)
        acc[:, 3] = 1.0
        return acc
    if dev.type == "cuda":
        if not display:
            return _march_train_cuda(gplanar, qscale, D=D, bd=bd, flip=flip,
                                     occ=occupancy, mode=mode,
                                     acc_init=acc_init, segment=segment,
                                     **m)
        return _march_display_cuda(gplanar, qscale, D=D, bd=bd, flip=flip,
                                   mode=mode, acc_init=acc_init,
                                   segment=segment, **m)
    if dev.type == "cpu":
        return march_slabs_ref(gplanar, qscale, D=D, bd=bd, flip=flip,
                               dir_win=display, acc_init=acc_init,
                               **mode._asdict(), **m)
    raise RuntimeError(f"march_slabs: no kernel for device {dev}")


march_slabs.launches = 0
march_slabs.poses = 0
#: launches that marched a z-segment (a payload of fewer than G slabs, or a
#: z_base or acc_init given), a subset of ``launches``: display mode's and
#: training mode's
march_slabs.segments = 0
march_slabs.train_segments = 0
#: display launches by kernel variant (display_variant)
march_slabs.variants = {}
#: training launches by kernel variant (train_variant)
march_slabs.train_variants = {}
#: the last display launch's configuration (display_config) and variant
#: (display_variant's name; its fmt, bf16 and opt as the kernel takes them)
march_slabs.display = None


def _acc_init(acc_init, P: int, gi: int, dev) -> torch.Tensor:
    """A march's initial accumulator as a fresh contiguous (P, 4, gi, gi)
    f32 tensor on ``dev`` (the kernels write their output over it)."""
    a = torch.as_tensor(acc_init, dtype=_F32)
    if a.dim() == 3:
        a = a[None]
    if tuple(a.shape[1:]) != (4, gi, gi) or a.shape[0] not in (1, P):
        raise ValueError(f"acc_init must be (4, {gi}, {gi}) or ({P}, 4, "
                         f"{gi}, {gi}), got {tuple(a.shape)}")
    if a.device != dev:
        raise ValueError(f"acc_init must lie on {dev}, got {a.device}")
    return a.expand(P, 4, gi, gi).clone(memory_format=torch.contiguous_format)


def march_inputs(gplanar, params, zbounds, G: int, gi: int,
                 slab_ids: Optional[Sequence[int]] = None,
                 k_per_step: int = _K_STEP,
                 crop: Optional[Tuple[int, int, int, int]] = None,
                 z_base=None) -> dict:
    """The march's prepared inputs, shared by kernel M and its plain
    version: params (P, 31) (z_base appended: 0 when None), zb (P, 4, gi, gi)
    (_zb_planes), the K-aligned windows and occupancy masks in march
    order, and the statics G, gi, K, y0, x0."""
    Gz, _, Gy, Gx = gplanar.shape
    y0, x0 = (crop[0], crop[2]) if crop is not None else (0, 0)
    if crop is not None and (crop[1], crop[3]) != (Gy, Gx):
        raise ValueError(f"payload in-plane shape {(Gy, Gx)} != crop {crop}")
    if slab_ids is None:
        slab_ids = tuple(range(Gz))
    K = _march_k(Gz, k_per_step)
    params = torch.as_tensor(params, dtype=_F32)
    if params.dim() != 2 or params.shape[1] < 30:
        raise ValueError("params must be (P, 30) (see _pack_params)")
    P = params.shape[0]
    zcol = torch.zeros((P, 1), dtype=_F32, device=params.device)
    if z_base is not None:
        zcol += to_device(z_base, _F32, params.device).reshape(-1, 1)
    params = torch.cat([params[:, :30], zcol], 1).contiguous()
    zb = _zb_planes(params, zbounds, G, gi).contiguous()
    wins, masks = _window_masks(slab_ids, K)
    return dict(params=params, zb=zb, wins=wins, masks=masks, G=G, gi=gi,
                K=K, y0=y0, x0=x0)


def _check_launch(gplanar, qscale, params, zb, G, gi):
    """The march launch's inputs: tensors of the kernel's dtypes and shapes
    on the payload's device, contiguous (the payload too in the display
    mode; in the training mode a view with channel stride 1,
    ``_record_strides``)."""
    dev = gplanar.device
    Gz, Dp, Gy, Gx = gplanar.shape
    P = params.shape[0]
    for name, t, dt, shape in (
            ("payload", gplanar, gplanar.dtype, (Gz, Dp, Gy, Gx)),
            ("params", params, _F32, (P, _NP)),
            ("qscale", qscale, _F32, (Dp,)),
            ("zbounds", zb, _F32, (P, 4, gi, gi))):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not (t.is_contiguous() or t is gplanar)):
            raise ValueError(f"march_slabs: {name} must be a contiguous "
                             f"{dt} tensor of shape {shape} on {dev}")
    if gplanar.dtype == torch.int8 and not gplanar.is_contiguous():
        raise ValueError("march_slabs: the int8 payload must be contiguous")


def _record_strides(gplanar, bake: bool = False) -> Tuple[int, int, int]:
    """(slab, row, column) element strides of a training payload, as the
    wrappers hand them to the kernels: a view with channel stride 1 (each
    voxel's D values one record; the bake's contiguous (G, G, G, D) tensor
    seen through ``permute(perm[0], 3, perm[1], perm[2])`` is one) and a
    16-byte aligned first element; with ``bake``, also a permutation of a
    contiguous (G, G, G, D) tensor, or a z-segment of one (Gz < G slabs)
    with its slab axis outermost, as ``slab_grad.zsegment`` makes it (the
    backward walks the voxels in memory order and takes a voxel's slab
    from its offset)."""
    Gz, D, Gy, Gx = gplanar.shape
    ss, sc, sr, sx = gplanar.stride()
    if sc != 1 or min(ss, sr, sx) < 1 or gplanar.data_ptr() % 16:
        raise ValueError(
            f"the training payload must be a view with channel stride 1 "
            f"(each voxel's values one record) and a 16-byte aligned first "
            f"element, got strides {gplanar.stride()}")
    if bake:
        # a permutation of a contiguous tensor: sorted by stride, each
        # axis's stride is the product of the extents inside it
        ok = Gy == Gx and (Gz == Gy or (Gz < Gy and ss == D * Gy * Gx))
        inner = D
        for st, n in sorted(((ss, Gz), (sr, Gy), (sx, Gx))):
            ok = ok and st == inner
            inner *= n
        if not ok:
            raise ValueError(
                f"the backward's payload must be a permuted contiguous "
                f"(G, G, G, D) bake or a slab-major z-segment of one, got "
                f"shape "
                f"{tuple(gplanar.shape)} strides {gplanar.stride()}")
    return ss, sr, sx


def march_slab_ids(wins: Sequence[int], masks: Sequence[int], K: int,
                   flip: bool) -> List[int]:
    """The slab ids of K-aligned windows and their occupancy masks, in
    march order (the training kernel's slab list)."""
    order = range(K - 1, -1, -1) if flip else range(K)
    return [w * K + d for w, m in zip(wins, masks) for d in order
            if (m >> d) & 1]


def _march_train_cuda(gplanar, qscale, params, zb, wins, masks, G, gi, D,
                      bd, K, flip, y0, x0, counts=None, occ=None,
                      mode: MarchMode = MarchMode(), acc_init=None,
                      segment: bool = False):
    """Launch kernel M's training mode (the bake's f32 or bf16 view, per-slab
    view directions; the format and options of ``mode``) over the whole
    pose batch (one launch). ``occ``: the payload's coarse occupancy
    (``march_occupancy``; None builds it); ``counts``: an int64
    (N_COUNTS,) tensor on the card to add the launch's counts to (slabs met
    and shaded, footprint pieces met, staged and shaded;
    ``tmarch::add_counts`` in csrc/slab_common.cuh); ``acc_init``: the
    initial accumulator (``_acc_init``'s), which the launch overwrites
    (the option variant resumes from it: ``flip``'s bit 1);
    ``segment``: the launch marches a z-segment (counted in
    ``march_slabs.train_segments``)."""
    _check_launch(gplanar, qscale, params, zb, G, gi)
    ss, sr, sx = _record_strides(gplanar)
    dev = gplanar.device
    Gz, Dp, Gy, Gx = gplanar.shape
    P = params.shape[0]
    ids = to_device(np.asarray(march_slab_ids(wins, masks, K, flip),
                               np.int32), torch.int32, dev)
    if occ is None:
        occ = march_occupancy(gplanar, params, qscale)
    _check_occupancy(occ, Gz, Gy, Gx, dev)
    acc = (torch.empty((P, 4, gi, gi), dtype=_F32, device=dev)
           if acc_init is None else acc_init)
    f32 = gplanar.dtype == _F32
    resume = acc_init is not None
    va = _variant_args(mode, bd, dev, resume)
    lib = train_lib("slab_march", mode.fmt, mode.options(bd) or resume)
    kernels.check(lib.vt_march_slabs(
        gplanar.data_ptr(), int(f32), ss, sr, sx,
        params.data_ptr(), qscale.data_ptr(), zb.data_ptr(), ids.data_ptr(),
        ids.numel(), occ.data_ptr(), acc.data_ptr(),
        _counts_ptr(counts, dev), P, Gz, G, gi, Gy, Gx, y0, x0, bd,
        int(bool(flip)) | (2 if resume else 0), *va[1:],
        torch.cuda.current_stream(dev).cuda_stream),
        "slab_march")
    _count_launch(P, segment, True)
    name = train_variant(mode, bd, f32, resume)
    march_slabs.train_variants[name] = (
        march_slabs.train_variants.get(name, 0) + 1)
    return acc


def _count_launch(P: int, segment: bool, train: bool) -> None:
    march_slabs.launches += 1
    march_slabs.poses += P
    if segment and train:
        march_slabs.train_segments += 1
    elif segment:
        march_slabs.segments += 1


def _variant_args(mode: MarchMode, bd: int, dev,
                  resume: bool = False) -> tuple:
    """A launch's variant arguments as the kernels' entries take them:
    (the lobes' device tensor, kept alive for the call, or None; then fmt,
    opt (1 the option variant, which a launch that ``resume``s takes, 2
    bf16 shading without options, 3 with options, 5 the display mode's
    depth variant), the lobes' pointer, rot_on, rot (host
    float[9]), bbox, basis_lo, basis_hi)."""
    extra, extra_ptr = None, 0
    if mode.fmt in (int(BasisType.SG), int(BasisType.ASG)):
        extra = to_device(mode.extra, _F32, dev).contiguous()
        extra_ptr = extra.data_ptr()
    rot = (ctypes.c_float * 9)(*(mode.rot or _IDENTITY))
    opt = (int(mode.options(bd) or resume) | (2 if mode.bf16_shade else 0)
           | (4 if mode.depth else 0))
    return (extra, mode.fmt, opt, extra_ptr,
            int(mode.rot is not None), rot, int(not mode.bbox_full),
            mode.basis_lo, mode.basis_hi)


#: entries of the training kernels' counts (tmarch::N_COUNTS)
N_COUNTS = 5
#: cells a side of the coarse occupancy's blocks (tmarch::OCC)
_OCC = 8


def _occ_shape(Gz: int, Gy: int, Gx: int) -> Tuple[int, int, int]:
    """The coarse occupancy's shape: per slab and row of blocks, the
    64-bit masks that cover the column blocks."""
    return Gz, -(-Gy // _OCC), -(-Gx // (64 * _OCC))


class LiveBits(NamedTuple):
    """A pyramid bake's live bits (``slab_grad.bake_from_pyramid`` with
    ``live_thresh``): ``bits``, int32 words (G, G, ceil(G / 32)) in the
    bake's (z, y, x) order, bit i of word w set when voxel x = 32 w + i has
    its sigma, rounded to bf16, above ``thresh`` (an f32 value); padding
    bits 0."""
    bits: torch.Tensor
    thresh: float


def march_occupancy(gplanar, params, qscale, live: Optional[LiveBits] = None,
                    perm: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The training kernels' coarse occupancy of a payload: per slab and
    row of 8 x 8 cell blocks (the view's rows and columns), int64 masks
    whose bit b of word w is set when column block 64 w + b holds a voxel
    above the sigma threshold (the lowest of the poses' params[:, 14];
    values read as the kernels read them, bf16, times qscale[D-1]).
    gplanar: the training payload (Gz, D, Gy, Gx); params (P, >=15) or
    (>=15,); returns (Gz, ceil(Gy / 8), ceil(Gx / 512)) int64. Kernel
    M's training mode and the backward pass over the footprint pieces it
    marks empty; one map serves both (``_MarchKernel`` builds it once a
    step).

    Two modes, one result:
    - full read (``live`` None): every voxel's sigma read from the payload;
      on CUDA tensors ``vt_march_occupancy``, on CPU tensors
      ``march_occupancy_ref``;
    - bits (``live`` and ``perm``): ``gplanar`` is a pyramid bake seen
      through ``permute(perm[0], 3, perm[1], perm[2])``, and the masks are
      reduced from the bake's live bits (qscale of ones, as the training
      path's); on CUDA tensors ``vt_march_occupancy_live``, on CPU tensors
      ``march_occupancy_live_ref``. The bits must have been taken at the
      lowest of ``params[:, 14]`` (else ValueError); ``params`` is read on
      the host for that check (a CUDA tensor is copied back, which waits
      for the device)."""
    Gz, D, Gy, Gx = gplanar.shape
    dev = gplanar.device
    if live is not None:
        return _occupancy_live(gplanar, params, live, perm)
    params = torch.as_tensor(params, dtype=_F32, device=dev)
    params = params.reshape(-1, params.shape[-1])
    if dev.type == "cpu":
        return march_occupancy_ref(gplanar, params, qscale)
    if dev.type != "cuda":
        raise RuntimeError(f"march_occupancy: no kernel for device {dev}")
    if gplanar.dtype not in _TRAIN_DTYPES:
        raise ValueError(f"march_occupancy takes a training payload, got "
                         f"{gplanar.dtype}")
    ss, sr, sx = _record_strides(gplanar)
    P = params.shape[0]
    prm = torch.zeros((P, _NP), dtype=_F32, device=dev)
    prm[:, :min(params.shape[1], _NP)] = params[:, :_NP]
    qscale = qscale.to(device=dev, dtype=_F32).contiguous()
    occ = torch.empty(_occ_shape(Gz, Gy, Gx), dtype=torch.int64, device=dev)
    kernels.check(kernels.lib("slab_march").vt_march_occupancy(
        gplanar.data_ptr(), int(gplanar.dtype == _F32), ss, sr, sx,
        prm.data_ptr(), P, qscale.data_ptr(), Gz, Gy, Gx, D,
        occ.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
        "slab_march")
    march_occupancy.launches += 1
    return occ


#: launches of the full-read mode and of the bits mode
march_occupancy.launches = 0
march_occupancy.launches_live = 0


def _occupancy_live(gplanar, params, live: LiveBits, perm) -> torch.Tensor:
    """march_occupancy's bits mode: check the view, the bits and their
    threshold, then launch or run the plain version."""
    Gz, D, Gy, Gx = gplanar.shape
    dev = gplanar.device
    if perm is None or sorted(perm) != [0, 1, 2]:
        raise ValueError(f"the bits mode takes the view's permutation of "
                         f"the bake's axes, got perm={perm}")
    G = Gz
    bits = live.bits
    shape = (G, G, -(-G // 32))
    if (bits.dtype != torch.int32 or tuple(bits.shape) != shape
            or bits.device != dev or not bits.is_contiguous()):
        raise ValueError(f"live bits must be a contiguous int32 tensor of "
                         f"shape {shape} on {dev}, got {bits.dtype} "
                         f"{tuple(bits.shape)} on {bits.device}")
    st = (G * G * D, G * D, D)
    if ((Gy, Gx) != (G, G) or gplanar.stride()
            != (st[perm[0]], 1, st[perm[1]], st[perm[2]])):
        raise ValueError(f"the bits mode takes a contiguous (G, G, G, D) "
                         f"bake seen through perm {tuple(perm)}, got shape "
                         f"{tuple(gplanar.shape)} strides {gplanar.stride()}")
    prm = torch.as_tensor(params, dtype=_F32)
    thr = float(prm.reshape(-1, prm.shape[-1])[:, 14].min())
    if thr != live.thresh:
        raise ValueError(f"the live bits were taken at sigma threshold "
                         f"{live.thresh}, the poses' lowest is {thr}")
    if dev.type == "cpu":
        return march_occupancy_live_ref(live, perm)
    if dev.type != "cuda":
        raise RuntimeError(f"march_occupancy: no kernel for device {dev}")
    occ = torch.empty(_occ_shape(G, G, G), dtype=torch.int64, device=dev)
    cperm = (ctypes.c_int * 3)(*perm)
    kernels.check(kernels.lib("slab_march").vt_march_occupancy_live(
        bits.data_ptr(), G, cperm, occ.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "slab_march")
    march_occupancy.launches_live += 1
    return occ


def march_occupancy_ref(gplanar, params, qscale) -> torch.Tensor:
    """Plain PyTorch version of ``march_occupancy`` (params (P, >=15))."""
    D = gplanar.shape[1]
    thr = params[:, 14].min()
    return _occ_of(_slab_values(gplanar[:, D - 1]) * qscale[D - 1].to(_F32)
                   > thr)


def march_occupancy_live_ref(live: LiveBits, perm) -> torch.Tensor:
    """Plain PyTorch version of ``march_occupancy``'s bits mode: the bits
    unpacked to the bake's (G, G, G) voxels, permuted to the view's axes
    (perm[0], perm[1], perm[2]) and reduced by blocks."""
    bits = live.bits
    G = bits.shape[0]
    on = ((bits[..., None] >> torch.arange(32, dtype=torch.int32,
                                           device=bits.device)) & 1).bool()
    on = on.reshape(G, G, -1)[..., :G]
    return _occ_of(on.permute(*perm))


def _occ_of(live) -> torch.Tensor:
    """(Gz, Gy, Gx) bool live voxels -> the coarse occupancy's masks."""
    Gz, Gy, Gx = live.shape
    _, RB, NW = _occ_shape(Gz, Gy, Gx)
    pad = torch.zeros((Gz, RB * _OCC, NW * 64 * _OCC), dtype=torch.bool,
                      device=live.device)
    pad[:, :Gy, :Gx] = live
    blocks = pad.reshape(Gz, RB, _OCC, NW, 64, _OCC).any(5).any(2)
    bits = torch.arange(64, device=live.device)
    return torch.sum(blocks.long() << bits, -1)               # (Gz, RB, NW)


def _check_occupancy(occ, Gz: int, Gy: int, Gx: int, dev) -> None:
    shape = _occ_shape(Gz, Gy, Gx)
    if (occ.device != dev or occ.dtype != torch.int64
            or tuple(occ.shape) != shape or not occ.is_contiguous()):
        raise ValueError(f"occupancy must be a contiguous int64 tensor of "
                         f"shape {shape} on {dev} (march_occupancy)")


def _counts_ptr(counts, dev) -> int:
    if counts is None:
        return 0
    if (counts.device != dev or counts.dtype != torch.int64
            or tuple(counts.shape) != (N_COUNTS,)
            or not counts.is_contiguous()):
        raise ValueError(f"counts must be a contiguous int64 ({N_COUNTS},) "
                         f"tensor on {dev}")
    return counts.data_ptr()


def _march_display_cuda(gplanar, qscale, params, zb, wins, masks, G, gi, D,
                        bd, K, flip, y0, x0,
                        mode: MarchMode = MarchMode(), acc_init=None,
                        segment: bool = False):
    """Launch kernel M's display mode (an int8 or bf16 payload, the format,
    options and knobs of ``mode``) over the whole pose batch (one launch;
    ``acc_init`` and ``segment`` as for _march_train_cuda)."""
    _check_launch(gplanar, qscale, params, zb, G, gi)
    cfg = display_config(params.shape[0], gi, len(wins), gplanar.shape[1],
                         _sm_count(gplanar.device.index),
                         esz=gplanar.element_size(),
                         opt=not mode.tall_tiles(bd) or acc_init is not None,
                         depth=mode.depth,
                         raw=mode.rgba_raw() and acc_init is None)
    return _display_launch(gplanar, qscale, params, zb, wins, masks, G, gi,
                           bd, K, flip, y0, x0, cfg, mode, acc_init, segment)


def _display_launch(gplanar, qscale, params, zb, wins, masks, G, gi, bd, K,
                    flip, y0, x0, cfg, mode: MarchMode = MarchMode(),
                    acc_init=None, segment: bool = False):
    """One display launch of checked inputs with the configuration ``cfg``
    (display_config's), the format and options of ``mode`` and the initial
    accumulator ``acc_init`` (``_acc_init``'s, overwritten; None starts
    from (0, 0, 0, 1); else the option variant of the resume build,
    ``slab_march_display_resume``, starts from it); ``segment`` as for
    _march_train_cuda."""
    dev = gplanar.device
    _, Dp, Gy, Gx = gplanar.shape
    P = params.shape[0]
    bf16 = gplanar.dtype == torch.bfloat16
    resume = acc_init is not None
    # the SG/ASG lobes are kept alive until the launch is queued
    extra, fmt, opt, extra_ptr, rot_on, rot, bbox, blo, bhi = _variant_args(
        mode, bd, dev, resume)
    if mode.rgba_raw() and not resume:
        # rgba_kernel at two blocks an SM (opt 0) or three (opt 4)
        opt = 4 if cfg.get("blocks") == 3 else 0
    wm = to_device(np.asarray([wins, masks], np.int32), torch.int32, dev)
    acc = (torch.empty((P, 4, gi, gi), dtype=_F32, device=dev)
           if acc_init is None else acc_init)
    lib = kernels.lib("slab_march_display_resume" if resume
                      else "slab_march_display")
    kernels.check(lib.vt_march_display(
        gplanar.data_ptr(), params.data_ptr(), qscale.data_ptr(),
        zb.data_ptr(), wm.data_ptr(), len(wins), acc.data_ptr(),
        P, G, gi, Dp, Gy, Gx, y0, x0, bd, K, int(bool(flip)),
        cfg["rows"], cfg["stage_bytes"], cfg["chan_cells"], fmt, int(bf16),
        opt, extra_ptr, int(mode.depth), rot_on, rot, bbox, blo, bhi,
        torch.cuda.current_stream(dev).cuda_stream), "slab_march_display")
    _count_launch(P, segment, False)
    name = display_variant(mode, bd, bf16, resume)
    march_slabs.variants[name] = march_slabs.variants.get(name, 0) + 1
    march_slabs.display = dict(cfg, variant=name, fmt=mode.fmt,
                               bf16=int(bf16), opt=opt)
    return acc


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    """The card's SM count (cached: the launch path is host-bound for one
    pose)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def display_config(P: int, gi: int, n_win: int, Dp: int, n_sm: int,
                   smem: Optional[int] = None, esz: int = 1,
                   opt: bool = False, depth: bool = False,
                   raw: bool = False) -> dict:
    """A display launch's configuration: ``rows`` of 8 pixel rows a thread
    and the block's ``smem`` split into the stage (``stage_bytes``, a
    multiple of 128, at least one 256-cell row) and the shaded-cell buffer
    (``chan_cells``, one a cell of stage) after three ints a window. A
    cell of stage holds Dp values of ``esz`` bytes (1 for int8, 2 for
    bf16), a shaded cell a float4; in ``depth`` mode (the depth variant)
    a cell of stage holds sigma's planes alone (2 bytes: int8 hi and lo,
    or one bf16) and a shaded cell one float.

    The tile height, from the P poses at gi and the card's ``n_sm`` SMs
    (measured on the display launches by ``probes.display_tiles``,
    PERF.md): 32x16 tiles (rows=2) shade fewer halo cells a pixel, 32x8
    tiles (rows=1) make twice the blocks, so a launch of few tiles, whose
    costs differ, ends sooner after its costliest ones. 32x16 when the
    launch holds at least six of them an SM (three waves of two blocks),
    32x8 below that (SG16 and ASG16 groups too, measured). ``opt``: the
    launch's variant is built with 32x8 tiles only (every mode that
    ``MarchMode.tall_tiles`` refuses: SH with an option, RGBA, depth, SG
    and ASG with another option, a resumed z-segment). ``smem``: the
    block's budget (None: ``_DISPLAY_SMEM``). ``raw``: RGBA's kernel of
    its own (``MarchMode.rgba_raw``), whose taps read the stage itself:
    the whole block but the windows' ints is stage (two slots of half of
    it; ``chan_cells`` 0) on 32x8 tiles, and ``blocks`` an SM: three (in
    ``_RGBA_SMEM[3]``) when the launch holds more blocks than two an SM
    take at once, else two. Measured on an H100 (probes/display_march
    --alt, PERF.md): past one wave two blocks ran 4-17 % slower than
    three, within one wave three ran 5 % slower than two (a smaller
    stage); 32x8 at three blocks ran 5-7 % faster than 32x16 at two on
    every whole orbit group (probes/display_tiles)."""
    tiles = P * -(-gi // _DTX) * -(-gi // (2 * _DWARPS))
    if raw:
        launch = P * -(-gi // _DTX) * -(-gi // _DWARPS)
        blocks = 3 if launch > 2 * n_sm else 2
        avail = (_RGBA_SMEM[blocks] if smem is None else smem) - 12 * n_win
        stage_bytes = max(avail // 128 * 128, 2 * Dp * esz * 256)
        return dict(rows=1, stage_bytes=stage_bytes, chan_cells=0,
                    smem=stage_bytes + 12 * n_win, blocks=blocks)
    rows = 2 if tiles >= 6 * n_sm and not opt else 1
    avail = (_DISPLAY_SMEM if smem is None else smem) - 12 * n_win
    cell = 2 if depth else Dp * esz
    shaded = 4 if depth else 16
    stage_bytes = max(avail * cell // (cell + shaded) // 128 * 128,
                      cell * 256)
    chan_cells = max(256, (avail - stage_bytes) // shaded)
    return dict(rows=rows, stage_bytes=stage_bytes, chan_cells=chan_cells,
                smem=stage_bytes + shaded * chan_cells + 12 * n_win)


def _overlap_mat(c0G, slope_G, s0, s1, cell, G: int):
    """(gi, n) box-integration weights of one slab along one axis: row i
    holds the overlap of ray i's within-slab span with each cell (edge
    cells extended to +-inf), divided by the span length.

    c0G: camera coordinate * G; slope_G: (gi,) ray slope * G; cell: (n,)
    GLOBAL f32 cell indices."""
    big = 1e9
    hi = torch.where(cell >= G - 1.0, big, cell + 1.0)
    lo = torch.where(cell <= 0.0, -big, cell)
    p0 = c0G + s0 * slope_G
    p1 = c0G + s1 * slope_G
    pmin = torch.minimum(p0, p1)[:, None]
    pmax = torch.maximum(p0, p1)[:, None]
    inv = 1.0 / torch.clamp(pmax - pmin, min=1e-9)
    return torch.clamp((torch.minimum(hi[None], pmax)
                        - torch.maximum(lo[None], pmin)) * inv, 0.0, 1.0)


def _dirs(dirp, prm, s) -> torch.Tensor:
    """(Gy, Gx, 3) unit view directions of the voxels through the slab
    plane at camera distance ``s``: s * dir = dirM[:,0] * s + dirp, the
    scale-invariant affine map of params 20:29 (sign(s) folded in)."""
    dw = torch.stack([dirp[a] + prm[20 + 3 * a] * s for a in range(3)], -1)
    return dw * (torch.rsqrt(torch.sum(dw * dw, -1, keepdim=True))
                 * torch.sign(torch.as_tensor(s)))


def _slab_values(slab) -> torch.Tensor:
    """One slab of the payload as f32: int8 codes as they are, a training
    payload's values rounded to bf16 first (as the kernels read them)."""
    if slab.dtype != torch.int8:
        slab = slab.to(torch.bfloat16)
    return slab.to(_F32)


def _slab_sigma(slab, qs, D: int, sig2: bool) -> torch.Tensor:
    """Dequantized sigma plane of one (Dp, Gy, Gx) f32 slab."""
    if sig2:
        return (slab[D - 1] * 128.0 + slab[D]) * qs[D - 1]
    return slab[D - 1] * qs[D - 1]


def _basis_planes(dirs, bd: int, mode: MarchMode, qs,
                  bf16: bool = False) -> torch.Tensor:
    """(Gy, Gx, bd) basis of ``mode``'s format at unit ``dirs`` (rotated by
    ``mode.rot`` first), zero outside the basis window, times each basis
    function's scale qs[k] (shared by rgb). ``bf16`` (SH): as kernel M's
    bf16 shading computes it, the directions rounded to bf16, the basis
    in bf16 (``_sh_basis_bf16``) times the scale rounded to bf16, each
    product rounded to bf16 (bf16 values, returned as f32)."""
    if mode.rot is not None:
        R = torch.as_tensor(mode.rot, dtype=_F32, device=dirs.device)
        dirs = dirs @ R.reshape(3, 3).T
    k = torch.arange(bd, device=dirs.device)
    win = (k >= mode.basis_lo) & (k <= mode.basis_hi)
    if bf16:
        bk = _sh_basis_bf16(dirs.to(torch.bfloat16), bd)
        bkq = (bk * qs[:bd].to(torch.bfloat16)).to(_F32)
        return torch.where(win, bkq, 0.0)
    bk = basis_mod.eval_basis(BasisType(mode.fmt), bd, dirs, mode.extra)
    return torch.where(win, bk * qs[:bd], 0.0)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f64 values to the nearest bf16 (ties to even) in one rounding: the
    significand keeps 8 of its 53 bits (a round through f32 would round
    twice)."""
    bits = x.to(torch.float64).view(torch.int64)
    lsb = (bits >> 45) & 1
    bits = (bits + ((1 << 44) - 1) + lsb) & ~((1 << 45) - 1)
    return bits.view(torch.float64).to(_F32).to(torch.bfloat16)


def _fma_bf16(a, b, c) -> torch.Tensor:
    """a * b + c of bf16 tensors (or numbers, rounded to bf16 first) fused
    and rounded once to bf16, as __hfma2 computes it (exact in f64 at
    these magnitudes)."""
    dev = next(v.device for v in (a, b, c) if isinstance(v, torch.Tensor))

    def f64(v):
        return (v.to(torch.float64) if isinstance(v, torch.Tensor)
                else torch.tensor(float(torch.tensor(v, dtype=_F32)
                                        .to(torch.bfloat16)),
                                  dtype=torch.float64, device=dev))
    return _round_bf16(f64(a) * f64(b) + f64(c))


def _sh_basis_bf16(dirs, bd: int) -> torch.Tensor:
    """(..., bd) bf16 SH basis at the bf16 unit directions ``dirs`` (...,
    3), operation for operation as kernel M's bf16 shading evaluates it
    (csrc/slab_march_display.cu sh_basis2): each multiply and add rounded
    to bf16 (ties to even), each fused multiply-add rounded once, the
    constants rounded to bf16 first."""
    bf = torch.bfloat16

    def K(v):
        return torch.tensor(v, dtype=_F32, device=dirs.device).to(bf)

    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    C2, C3, C4 = basis_mod._C2, basis_mod._C3, basis_mod._C4
    out = [K(basis_mod._C0).expand(x.shape)]
    if bd >= 4:
        out += [K(-basis_mod._C1) * y, K(basis_mod._C1) * z,
                K(-basis_mod._C1) * x]
    if bd >= 9:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        s, d = xx + yy, xx - yy
        out += [K(C2[0]) * xy, K(C2[1]) * yz,
                K(C2[2]) * _fma_bf16(2.0, zz, -s), K(C2[3]) * xz,
                K(C2[4]) * d]
    if bd >= 16:
        t4 = _fma_bf16(4.0, zz, -s)
        u3 = _fma_bf16(3.0, xx, -yy)
        v3 = _fma_bf16(-3.0, yy, xx)
        out += [(K(C3[0]) * y) * u3, (K(C3[1]) * xy) * z,
                (K(C3[2]) * y) * t4,
                (K(C3[3]) * z) * _fma_bf16(-3.0, s, zz + zz),
                (K(C3[4]) * x) * t4, (K(C3[5]) * z) * d,
                (K(C3[6]) * x) * v3]
    if bd >= 25:
        z71 = _fma_bf16(7.0, zz, -1.0)
        z73 = _fma_bf16(7.0, zz, -3.0)
        out += [(K(C4[0]) * xy) * d, (K(C4[1]) * yz) * u3,
                (K(C4[2]) * xy) * z71, (K(C4[3]) * yz) * z73,
                K(C4[4]) * _fma_bf16(zz, _fma_bf16(35.0, zz, -30.0), 3.0),
                (K(C4[5]) * xz) * z73, (K(C4[6]) * d) * z71,
                (K(C4[7]) * xz) * v3,
                K(C4[8]) * _fma_bf16(xx, v3, -(yy * u3))]
    return torch.stack(out, -1)


def _bf16_macs(codes, bkq) -> torch.Tensor:
    """(3, Gy, Gx) f32 raw colours of kernel M's bf16 shading: (3, bd, Gy,
    Gx) exact codes times the (Gy, Gx, bd) basis planes rounded to bf16,
    summed over k in order with each multiply-add fused and rounded once to
    bf16 (the kernel's __hfma2; here exact in f64, then _round_bf16)."""
    q = bkq.to(torch.bfloat16).to(torch.float64).permute(2, 0, 1)
    c = codes.to(torch.float64)
    raw = torch.zeros(codes.shape[0:1] + codes.shape[2:],
                      dtype=torch.float64, device=codes.device)
    for k in range(codes.shape[1]):
        raw = _round_bf16(c[:, k] * q[k] + raw).to(torch.float64)
    return raw.to(_F32)


def march_slabs_ref(gplanar, qscale, params, zb, wins: Sequence[int],
                    masks: Sequence[int], G: int, gi: int, D: int, bd: int,
                    K: int, flip: bool, y0: int = 0, x0: int = 0,
                    dir_win: Optional[bool] = None,
                    fmt: int = int(BasisType.SH), extra=None,
                    depth: bool = False,
                    rot: Optional[Tuple[float, ...]] = None,
                    bbox_full: bool = True, basis_lo: int = 0,
                    basis_hi: int = 24, dir_slab: bool = False,
                    bf16_shade: bool = False, acc_init=None):
    """Plain PyTorch version of kernel M: the same function, with the warp
    as dense (gi, Gy) @ (Gy, Gx) @ (Gx, gi) overlap-matrix products as the
    reference builds them (in f32). Inputs as ``march_inputs`` prepares
    them (params (P, 31), zb (P, 4, gi, gi)); returns acc (P, 4, gi, gi).

    ``dir_win`` takes the view direction once per window (the display
    mode's default), else (or with ``dir_slab``, the display mode's
    per-slab knob) per slab, as the training mode does; a training
    payload's f32 values are rounded to bf16 as they are read, as the
    kernel reads them. ``dir_win`` None means True for int8 and False
    otherwise. ``bf16_shade``: SH shading rounded where kernel M's bf16
    shading variants round: the directions to bf16, the SH polynomials in
    bf16 (``_sh_basis_bf16``), each plane times its bf16 scale rounded to
    bf16, then each payload multiply-add fused and rounded to bf16 (in f64,
    then to bf16 in one rounding), the sigmoid in f32. The options, as the
    reference's kernel body computes them (pallas_slab.py:391-537):
    - ``fmt``/``extra``: SH, SG and ASG shade srgb = sigma * sigmoid(sum_k
      code_k * basis_k * qs[k]); RGBA srgb = sigma * code_c * qs[c];
    - ``rot``: 9 floats applied to the unit view direction;
    - the basis window [basis_lo, basis_hi] drops the other basis planes;
    - a non-full bbox masks sigma by the voxel extent's overlap with the
      in-plane box of params 16-19;
    - ``depth``: only sigma is warped, and acc[0] += w * |z - params[29]|
      * zb[3] (acc[1:3] stay 0).
    A z-segment: slab i of the payload lies at z = (i + 0.5) / G +
    params[30]; ``acc_init`` (P, 4, gi, gi) is the accumulator each pose
    starts from (None: rgb 0, T 1)."""
    dev = gplanar.device
    Gz, Dp, Gy, Gx = gplanar.shape
    P = params.shape[0]
    sig2 = gplanar.dtype == torch.int8
    if dir_win is None:
        dir_win = sig2
    dir_win = dir_win and not dir_slab
    mode = MarchMode(int(fmt), extra, depth, rot, bbox_full, basis_lo,
                     basis_hi)
    rgba = BasisType(fmt) == BasisType.RGBA
    qs = qscale.to(_F32)
    ycell = torch.arange(Gy, dtype=_F32, device=dev) + y0
    xcell = torch.arange(Gx, dtype=_F32, device=dev) + x0
    yc = (ycell + 0.5) * (1.0 / G)
    xc = (xcell + 0.5) * (1.0 / G)
    ray = torch.arange(gi, dtype=_F32, device=dev)
    hG = 0.5 / G
    out = []
    for p in range(P):
        prm = params[p]
        cz, cy, cx = prm[0], prm[1], prm[2]
        u0, du, v0, dv = prm[3], prm[4], prm[5], prm[6]
        sigma_thresh, stop_thresh, zbase = prm[14], prm[15], prm[30]
        ujG = (u0 + du * ray) * G
        vkG = (v0 + dv * ray) * G
        ycm = (yc - cy)[:, None]
        xcm = (xc - cx)[None, :]
        dirp = [prm[21 + 3 * a] * ycm + prm[22 + 3 * a] * xcm
                for a in range(3)]
        okb = None
        if not bbox_full:
            okb = (((yc + hG > prm[16]) & (yc - hG < prm[17]))[:, None]
                   & ((xc + hG > prm[18]) & (xc - hG < prm[19]))[None, :])
        zlo, zhi, dtp = zb[p, 0], zb[p, 1], zb[p, 2]
        if acc_init is None:
            rgb = torch.zeros((3, gi, gi), dtype=_F32, device=dev)
            T = torch.ones((gi, gi), dtype=_F32, device=dev)
        else:
            rgb, T = acc_init[p, :3].clone(), acc_init[p, 3].clone()
        shade = not depth and not rgba
        for w, m in zip(wins, masks):
            if dir_win and shade:
                # view directions once per window, at the window centre
                sc = ((w * K) + 0.5 * K) / G + zbase - cz
                bkq = _basis_planes(_dirs(dirp, prm, sc), bd, mode, qs,
                                    bf16_shade)
            order = range(K - 1, -1, -1) if flip else range(K)
            for dzi in order:
                if not (m >> dzi) & 1:
                    continue
                sid = w * K + dzi
                z = (sid + 0.5) / G + zbase
                s0 = z - hG - cz
                s1 = z + hG - cz
                if not dir_win and shade:
                    bkq = _basis_planes(_dirs(dirp, prm, z - cz), bd, mode,
                                        qs, bf16_shade)
                slab = _slab_values(gplanar[sid])              # (Dp,Gy,Gx)
                sigma = _slab_sigma(slab, qs, D, sig2)
                ok = sigma > sigma_thresh
                if okb is not None:
                    ok = ok & okb
                sigma = torch.where(ok, sigma, 0.0)
                if depth:
                    chans = sigma[None]
                elif rgba:
                    chans = torch.cat([sigma[None],
                                       sigma[None] * slab[:3]
                                       * qs[:3, None, None]])
                elif bf16_shade:
                    codes = slab[:3 * bd].reshape(3, bd, Gy, Gx)
                    raw = _bf16_macs(codes, bkq)
                    chans = torch.cat([sigma[None],
                                       sigma[None] * torch.sigmoid(raw)])
                else:
                    codes = slab[:3 * bd].reshape(3, bd, Gy, Gx)
                    raw = torch.sum(codes * bkq.permute(2, 0, 1)[None], 1)
                    chans = torch.cat([sigma[None],
                                       sigma[None] * torch.sigmoid(raw)])
                m_r = _overlap_mat(cy * G, ujG, s0, s1, ycell, G)
                m_c = _overlap_mat(cx * G, vkG, s0, s1, xcell, G)
                warped = m_r @ chans @ m_c.T                    # (C,gi,gi)
                sig_w = warped[0]
                frac = torch.clamp((torch.clamp(zhi, max=z + hG)
                                    - torch.clamp(zlo, min=z - hG)) * G,
                                   0.0, 1.0)
                tau = sig_w * dtp * frac
                att = torch.exp(-tau)
                live = (T >= stop_thresh) & (tau > 0.0)
                wgt = torch.where(live, T * (1.0 - att), 0.0)
                if depth:
                    rgb[0] = rgb[0] + wgt * torch.abs(z - prm[29]) * zb[p, 3]
                else:
                    sig_inv = 1.0 / torch.clamp(sig_w, min=1e-12)
                    rgb = rgb + (wgt * sig_inv)[None] * warped[1:]
                T = torch.where(live, T * att, T)
        out.append(torch.cat([rgb, T[None]]))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# Backward march (training path)
# ---------------------------------------------------------------------------

def march_slabs_bwd(gplanar, params, qscale, zbounds, gacc4, acc4,
                    G: int, gi: int, D: int, bd: int,
                    perm: Tuple[int, int, int],
                    basis_lo: int = 0, basis_hi: int = 24,
                    extra=None, fmt: int = 1,
                    rot: Optional[Tuple[float, ...]] = None,
                    flip: bool = False,
                    k_per_step: Optional[int] = None,
                    bbox_full: bool = False,
                    z_base=None, state_init=None, out_dtype=_F32,
                    occupancy: Optional[torch.Tensor] = None):
    """Payload cotangent of the training-mode ``march_slabs`` for one pose.

    gplanar: (Gz, D, G, G) f32 or bf16 payload — the array the forward
        marched (on the card, the bake's view, or a z-segment of it:
        ``_record_strides``).
        params: (30,) f32 (see _pack_params); qscale:
        (D,) f32; zbounds: (2, gi, gi) f32 per-pixel live z interval.
    gacc4: (4, gi, gi) upstream cotangent [g_r, g_g, g_b, g_T].
    acc4: (4, gi, gi) the forward output [r, g, b, T].
    state_init: optional (2, gi, gi) incoming (T, A) suffix state; None =
        (1, 0), the whole-grid march.
    z_base: the global z of the payload's first slab (as for
        ``march_slabs``: the payload may be a z-segment of Gz <= G slabs;
        with ``state_init`` the segment's incoming state); None = 0.
    occupancy: the payload's coarse occupancy (``march_occupancy``; the
        forward's, shared); None builds it (on the card).
    Returns (Gz, D, G, G) in ``out_dtype`` (f32, or bf16 for the lean
    trainer) with the payload's strides, so that the bake's permutation
    back gives its own layout. Marches every slab in forward order (a slab
    culled from the forward has no voxel above the sigma threshold, so its
    cotangent is zero). Every format (``fmt``, ``extra``) and option
    (``rot``, a non-full bbox, any basis window, whose dropped planes get
    zero cotangent) of the forward's training mode; ``perm`` and
    ``k_per_step`` mirror the reference's signature and are not needed
    here.
    """
    _check_format(fmt, bd, D, extra)
    if (gplanar.dtype not in _TRAIN_DTYPES or gplanar.dim() != 4
            or tuple(gplanar.shape[1:]) != (D, G, G)
            or not 1 <= gplanar.shape[0] <= G):
        raise ValueError(f"payload must be (Gz, {D}, {G}, {G}) f32 or bf16, "
                         f"got {tuple(gplanar.shape)} {gplanar.dtype}")
    if out_dtype not in (_F32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    dev = gplanar.device
    prm, zb, gacc4, aux = march_bwd_inputs(params, zbounds, gacc4, acc4, G,
                                           gi, state_init, z_base)
    qscale = qscale.to(_F32).contiguous()
    mode = MarchMode(int(fmt), extra, False, rot, bool(bbox_full),
                     int(basis_lo), int(basis_hi))
    if dev.type == "cuda":
        return _march_bwd_cuda(gplanar, prm, qscale, zb, gacc4, aux, G, gi,
                               D, bd, flip, out_dtype, occ=occupancy,
                               mode=mode, segment=(z_base is not None
                                                   or state_init is not None
                                                   or gplanar.shape[0] < G))
    if dev.type == "cpu":
        g = march_slabs_bwd_ref(gplanar, qscale, prm, zb, gacc4, aux, G, gi,
                                D, bd, flip, out_dtype, mode=mode)
        if g.stride() == gplanar.stride():
            return g
        return torch.empty_strided(gplanar.shape, gplanar.stride(),
                                   dtype=out_dtype).copy_(g)
    raise RuntimeError(f"march_slabs_bwd: no kernel for device {dev}")


march_slabs_bwd.launches = 0
#: launches on a z-segment (z_base or state_init given, or fewer than G
#: slabs), a subset of ``launches``
march_slabs_bwd.segments = 0
#: launches by kernel variant (train_variant)
march_slabs_bwd.variants = {}


def march_bwd_inputs(params, zbounds, gacc4, acc4, G: int, gi: int,
                     state_init=None, z_base=None):
    """The backward's prepared inputs, shared by its kernel and its plain
    version: params (31,) (z_base appended, 0 when None), zb (4, gi, gi)
    (_zb_planes),
    gacc4 (4, gi, gi) f32, and aux (4, gi, gi) = [ctot, T_end * g_T, T_in,
    A_in] with ctot = sum_c gacc_c * acc_c and (T_in, A_in) = state_init or
    (1, 0)."""
    dev = gacc4.device
    zcol = torch.zeros(1, dtype=_F32, device=dev)
    if z_base is not None:
        zcol += to_device(z_base, _F32, dev).reshape(1)
    prm = torch.cat([torch.as_tensor(params, dtype=_F32).reshape(-1)[:30],
                     zcol]).contiguous()
    zb = _zb_planes(prm[None], zbounds.to(_F32).reshape(1, 2, gi, gi), G,
                    gi)[0].contiguous()
    gacc4 = gacc4.to(_F32).contiguous()
    acc4 = acc4.to(_F32)
    if state_init is None:
        state_init = torch.stack([torch.ones((gi, gi), dtype=_F32, device=dev),
                                  torch.zeros((gi, gi), dtype=_F32,
                                              device=dev)])
    aux = torch.cat([torch.sum(gacc4[:3] * acc4[:3], 0)[None],
                     (gacc4[3] * acc4[3])[None],
                     state_init.to(_F32).reshape(2, gi, gi)]).contiguous()
    return prm, zb, gacc4, aux


def _march_bwd_cuda(gplanar, params, qscale, zb, gacc4, aux, G, gi, D, bd,
                    flip, out_dtype, counts=None, occ=None,
                    mode: MarchMode = MarchMode(), segment: bool = False):
    """Launch the backward kernel (its two passes: re-march + adjoint warp,
    then the per-voxel shade adjoint) for one pose; the cotangent takes the
    payload's strides. RGBA with an f32 cotangent takes pass 1 alone: it
    adds each voxel's cotangent into the zeroed output itself, which then
    stands in for the (Gz G^2, 4) sum buffer. ``counts``, ``occ`` and
    ``mode`` as for _march_train_cuda (``counts``: pass 1's); ``segment``:
    the launch counts as a z-segment's (``march_slabs_bwd.segments``)."""
    dev = gplanar.device
    Gz = gplanar.shape[0]
    for name, t, shape in (("params", params, (_NP,)), ("qscale", qscale, (D,)),
                           ("zbounds", zb, (4, gi, gi)),
                           ("gacc4", gacc4, (4, gi, gi)),
                           ("aux", aux, (4, gi, gi))):
        if (t.device != dev or t.dtype != _F32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"march_slabs_bwd: {name} must be a contiguous "
                             f"float32 tensor of shape {shape} on {dev}")
    ss, sr, sx = _record_strides(gplanar, bake=True)
    ids = torch.arange(Gz, dtype=torch.int32, device=dev)
    if flip:
        ids = ids.flip(0)
    if occ is None:
        occ = march_occupancy(gplanar, params, qscale)
    _check_occupancy(occ, Gz, G, G, dev)
    out = torch.empty_strided(gplanar.shape, gplanar.stride(),
                              dtype=out_dtype, device=dev)
    if mode.fmt == int(BasisType.RGBA) and out_dtype == _F32:
        gbuf = out.zero_()
    else:
        gbuf = torch.zeros((Gz * G * G, 4), dtype=_F32, device=dev)
    f32 = gplanar.dtype == _F32
    va = _variant_args(mode, bd, dev)
    lib = train_lib("slab_march_bwd", mode.fmt, mode.options(bd))
    kernels.check(lib.vt_march_slabs_bwd(
        gplanar.data_ptr(), int(f32), ss, sr, sx,
        params.data_ptr(), qscale.data_ptr(), zb.data_ptr(),
        gacc4.data_ptr(), aux.data_ptr(), ids.data_ptr(), occ.data_ptr(),
        gbuf.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.bfloat16),
        _counts_ptr(counts, dev), Gz, G, gi, bd, int(bool(flip)), *va[1:],
        torch.cuda.current_stream(dev).cuda_stream),
        "slab_march_bwd")
    march_slabs_bwd.launches += 1
    march_slabs_bwd.segments += int(segment)
    name = train_variant(mode, bd, f32)
    march_slabs_bwd.variants[name] = march_slabs_bwd.variants.get(name,
                                                                  0) + 1
    return out


def march_slabs_bwd_ref(gplanar, qscale, params, zb, gacc4, aux, G: int,
                        gi: int, D: int, bd: int, flip: bool,
                        out_dtype=_F32, mode: MarchMode = MarchMode()):
    """Plain PyTorch version of the backward kernel: the reference's
    algebra (pallas_slab._make_bwd_kernel, :1005-1142) with the forward
    recompute and the transposed warp as dense overlap-matrix products, in
    f32 (the payload rounded to bf16 as it is read). Inputs as
    ``march_bwd_inputs`` prepares them: params (31,), zb (4, gi, gi) from
    _zb_planes, aux (4, gi, gi) = [ctot, T_end * g_T, T_in, A_in]; ``mode``
    the format and options (as march_slabs_ref takes them: SH, SG and ASG
    shade through sigmoid(sum_k code_k * basis_k), the basis rotated by
    ``rot`` and zero outside the window, and get sigmoid' x basis; RGBA's
    colours are raw and get g_srgb * sigma; sigma is masked by the
    threshold and a non-full bbox). Returns a contiguous (Gz, D, G, G)
    cotangent."""
    dev = gplanar.device
    Gz = gplanar.shape[0]
    qs = qscale.to(_F32)
    prm = params
    rgba = BasisType(mode.fmt) == BasisType.RGBA
    cz, cy, cx = prm[0], prm[1], prm[2]
    u0, du, v0, dv = prm[3], prm[4], prm[5], prm[6]
    sigma_thresh, stop_thresh, zbase = prm[14], prm[15], prm[30]
    cell = torch.arange(G, dtype=_F32, device=dev)
    vc = (cell + 0.5) * (1.0 / G)
    ray = torch.arange(gi, dtype=_F32, device=dev)
    ujG = (u0 + du * ray) * G
    vkG = (v0 + dv * ray) * G
    dirp = [prm[21 + 3 * a] * (vc - cy)[:, None]
            + prm[22 + 3 * a] * (vc - cx)[None, :] for a in range(3)]
    hG = 0.5 / G
    okb = None
    if not mode.bbox_full:
        okb = (((vc + hG > prm[16]) & (vc - hG < prm[17]))[:, None]
               & ((vc + hG > prm[18]) & (vc - hG < prm[19]))[None, :])
    zlo, zhi, dtp = zb[0], zb[1], zb[2]
    g_acc = gacc4[:3]
    ctot, gT = aux[0], aux[1]
    T, A = aux[2].clone(), aux[3].clone()
    ones = torch.ones_like(qs)
    out = torch.zeros((Gz, D, G, G), dtype=out_dtype, device=dev)
    for sid in (range(Gz - 1, -1, -1) if flip else range(Gz)):
        z = (sid + 0.5) / G + zbase
        s0, s1 = z - hG - cz, z + hG - cz
        slab = _slab_values(gplanar[sid])                         # (D,G,G)
        sigma = _slab_sigma(slab, qs, D, False)
        ok = sigma > sigma_thresh
        if okb is not None:
            ok = ok & okb
        sigma = torch.where(ok, sigma, 0.0)
        if rgba:
            rgb = slab[:3] * qs[:3, None, None]
        else:
            # the basis (rotated, zero outside the window), unscaled
            bk = _basis_planes(_dirs(dirp, prm, z - cz), bd, mode, ones
                               ).permute(2, 0, 1)                 # (bd,G,G)
            raw = torch.sum(slab[:3 * bd].reshape(3, bd, G, G)
                            * (bk * qs[:bd, None, None])[None], 1)
            rgb = torch.sigmoid(raw)
        chans = torch.cat([sigma[None], sigma[None] * rgb])
        m_r = _overlap_mat(cy * G, ujG, s0, s1, cell, G)
        m_c = _overlap_mat(cx * G, vkG, s0, s1, cell, G)
        warped = m_r @ chans @ m_c.T                               # (4,gi,gi)
        sig_w, srgb_w = warped[0], warped[1:]
        frac = torch.clamp((torch.clamp(zhi, max=z + hG)
                            - torch.clamp(zlo, min=z - hG)) * G, 0.0, 1.0)
        dt = dtp * frac
        tau = sig_w * dt
        att = torch.exp(-tau)
        sig_inv = 1.0 / torch.clamp(sig_w, min=1e-12)
        m = (T >= stop_thresh) & (tau > 0.0)
        w = torch.where(m, T * (1.0 - att), 0.0)
        G_pix = torch.sum(g_acc * srgb_w * sig_inv, 0)
        A = A + w * G_pix
        g_tau = torch.where(m, T * att * G_pix - (ctot - A) - gT, 0.0)
        sum_term = torch.sum(g_acc * w * srgb_w, 0)
        g_sig_w = g_tau * dt - torch.where(sig_w >= 1e-12,
                                           sum_term * sig_inv * sig_inv, 0.0)
        T = torch.where(m, T * att, T)
        gch = torch.cat([g_sig_w[None], g_acc * (w * sig_inv)[None]])
        g_vox = m_r.T @ gch @ m_c                                  # (4,G,G)
        g_sigma = torch.where(ok, g_vox[0] + torch.sum(g_vox[1:] * rgb, 0),
                              0.0)
        out[sid, D - 1] = (g_sigma * qs[D - 1]).to(out_dtype)
        if rgba:
            out[sid, :3] = (g_vox[1:] * sigma * qs[:3, None, None]
                            ).to(out_dtype)
        else:
            g_raw = g_vox[1:] * sigma * rgb * (1.0 - rgb)          # (3,G,G)
            qcol = qs[:3 * bd].reshape(3, bd, 1, 1)
            out[sid, :3 * bd] = (g_raw[:, None] * bk[None] * qcol
                                 ).reshape(3 * bd, G, G).to(out_dtype)
    return out
