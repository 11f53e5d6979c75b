"""Dense-grid baking: octree -> regular voxel grid for the slab renderer.

The slab renderer streams the scene as contiguous z-slabs instead of chasing
the octree's pointers per sample: the bake samples the octree once per
scene at G^3 voxel centers with the exact batched query of
``ops/render_exact.py``. When G equals the tree's finest resolution the grid
holds *exactly* the leaf values (piecewise-constant equivalence — splitting
a leaf chord into same-valued subsegments leaves front-to-back compositing
algebraically unchanged).

Two bakes feed the display path: ``int8`` (per-basis-shared signed int8
colour codes plus a 14-bit fixed-point sigma split over two int8 planes,
dequantized inside the march kernel) and ``f16`` (the leaf values, marched
as a bf16 payload).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from volrend_torch.models.data_format import BasisType
from volrend_torch.models.n3tree import N3Tree
from volrend_torch.ops import render_exact
from volrend_torch.utils.device import DeviceLike

__all__ = ["DenseGrid", "bake_dense", "full_resolution"]


@dataclasses.dataclass
class DenseGrid:
    """Dense voxel payload grid (a dataclass of tensors).

    data  : float16 [G, G, G, D]  leaf payloads at voxel centers
            (z-major: axis 0 is the slab axis before per-frame permutation);
            int8 [G, G, G, D+1] when ``quantized`` (per-channel linear
            colour codes, then sigma hi and lo planes)
    offset/scale : world->tree transform (same as TreeArrays)
    extra : SG/ASG lobe params ((0,0) when unused)
    qscale: float32 [D] (or [D+1] when quantized) per-channel dequant
            scales (ones when not quantized)
    """
    data: torch.Tensor
    offset: torch.Tensor
    scale: torch.Tensor
    extra: torch.Tensor
    qscale: Optional[torch.Tensor] = None
    #: (G, G, G) bfloat16 density plane kept at full precision
    sigma_grid: Optional[torch.Tensor] = None
    G: int = 1
    data_dim: int = 4
    basis_dim: int = -1
    fmt: BasisType = BasisType.RGBA
    quantized: bool = False
    #: per-axis slab occupancy: occ_max[a][i] = max sigma over slab i along
    #: tree axis a (3 tuples of G floats, on the host so the renderer can
    #: cull empty slabs before launching). None = unknown (no culling).
    occ_max: Optional[Tuple[Tuple[float, ...], ...]] = None
    #: (width, height, focal) of the LLFF/NDC warp when the tree lives in
    #: NDC coordinates; None for world-space trees
    ndc: Optional[Tuple[float, float, float]] = None

    @property
    def device(self) -> torch.device:
        return self.data.device

    def slab_ids(self, axis: int, reverse: bool,
                 sigma_thresh: float) -> Tuple[int, ...]:
        """March-ordered z-indices of the non-empty slabs along ``axis``."""
        order = range(self.G - 1, -1, -1) if reverse else range(self.G)
        if self.occ_max is None:
            return tuple(order)
        occ = self.occ_max[axis]
        return tuple(i for i in order if occ[i] > sigma_thresh)


def full_resolution(tree) -> int:
    """Finest voxel resolution of the tree (N ** (max_depth + 1))."""
    return int(tree.N ** (tree.max_depth + 1))


def _occupancy(sigma_grid: torch.Tensor):
    """Per-axis slab maxima of the bf16 sigma plane, as host tuples."""
    s = sigma_grid.to(torch.float32)
    occ = torch.stack([torch.amax(s, (1, 2)), torch.amax(s, (0, 2)),
                       torch.amax(s, (0, 1))]).cpu().numpy()
    return tuple(tuple(float(v) for v in row) for row in occ)


def _recip(c: float, device) -> torch.Tensor:
    """The float32 reciprocal of ``c`` as a 0-d tensor."""
    return torch.tensor(1.0 / c, dtype=torch.float32, device=device)


def _quantize_int8(data: torch.Tensor, basis_dim: int):
    """(G,G,G,D) payload -> ((G,G,G,D+1) int8 codes, (D+1,) f32 qscale).

    Colours: signed int8 per channel, each basis function's scale shared
    across rgb (the march scales the basis plane once per k). Sigma: 14-bit
    fixed point split over two int8 planes (hi*128 + lo) — transmittance
    needs more than 8 bits."""
    D = data.shape[-1]
    G = data.shape[0]
    # slab by slab throughout: keeps the f32 temporaries at one slab's size
    absmax = torch.amax(torch.stack([
        torch.amax(torch.abs(data[z, ..., :-1]).reshape(-1, D - 1), 0)
        for z in range(G)]), 0).to(torch.float32)
    if basis_dim > 0 and D == 3 * basis_dim + 1:
        am = absmax.reshape(3, basis_dim)
        absmax = torch.amax(am, 0, keepdim=True).expand(3, basis_dim
                                                        ).reshape(-1)
    # scales are x * f32(1/127) and x * f32(1/16383), not x / 127: the JAX
    # bake's compiler folds the division by a constant into a multiply by
    # its float32 reciprocal, and the codes must come out bit-equal
    qs_c = torch.clamp(absmax, min=1e-12) * _recip(127.0, data.device)
    out = torch.empty(data.shape[:-1] + (D + 1,), dtype=torch.int8,
                      device=data.device)
    sig_max = torch.amax(torch.clamp(data[..., -1].to(torch.float32),
                                     min=0.0))
    qs_s = torch.clamp(sig_max, min=1e-12) * _recip(16383.0, data.device)
    for z in range(G):
        df = data[z].to(torch.float32)
        out[z, ..., :D - 1] = torch.clamp(torch.round(df[..., :-1] / qs_c),
                                          -127, 127).to(torch.int8)
        sig = torch.clamp(df[..., -1], min=0.0)
        s16 = torch.clamp(torch.round(sig / qs_s), 0, 16383).to(torch.int32)
        out[z, ..., D - 1] = torch.div(s16, 128, rounding_mode="floor"
                                       ).to(torch.int8)
        out[z, ..., D] = torch.remainder(s16, 128).to(torch.int8)
    return out, torch.cat([qs_c, qs_s[None], qs_s[None]])


def _supersample_edge_band(dev, data: torch.Tensor, G: int, meta,
                           n_sub: int, thresh: float,
                           chunk: int = 2 ** 21) -> torch.Tensor:
    """Re-bake the occupancy-boundary voxels (sigma crosses ``thresh``
    across a face neighbour) as the mean of n_sub^3 sub-centre octree
    samples: area-weighted silhouettes. Interior and empty voxels keep
    their point sample. ``data`` (G, G, G, D) is updated in place and
    returned."""
    occ = data[..., -1].to(torch.float32) > thresh
    band = torch.zeros_like(occ)
    for ax in range(3):
        a = occ.transpose(0, ax)
        b = band.transpose(0, ax)
        edge = a[1:] != a[:-1]
        b[1:] |= edge
        b[:-1] |= edge
    ids = torch.nonzero(band.reshape(-1))[:, 0].to(torch.int32)
    if ids.numel() == 0:
        return data
    D = data.shape[-1]
    offs = (torch.arange(n_sub, dtype=torch.float32, device=data.device)
            + 0.5) / n_sub
    sub = torch.stack(torch.meshgrid(offs, offs, offs, indexing="ij"),
                      -1).reshape(-1, 3)                          # (n^3, 3)
    flat = data.view(-1, D)
    step = max(1, chunk // n_sub ** 3)
    for c0 in range(0, ids.numel(), step):
        vox = ids[c0:c0 + step]
        z = torch.div(vox, G * G, rounding_mode="floor")
        y = torch.remainder(torch.div(vox, G, rounding_mode="floor"), G)
        x = torch.remainder(vox, G)
        base = torch.stack([z, y, x], -1).to(torch.float32)
        pos = ((base[:, None, :] + sub[None]) / G).reshape(-1, 3)
        leaf_idx, _, _ = render_exact._query(dev.child, dev.lut, pos, meta)
        rows = render_exact._fetch_rows(dev.data, leaf_idx)[:, :D]
        flat[vox.long()] = torch.mean(
            rows.to(torch.float32).reshape(vox.numel(), -1, D), 1
        ).to(data.dtype)
    return data


def bake_dense(tree, G: Optional[int] = None,
               chunk: int = 2 ** 21, dtype: str = "f16",
               edge_supersample: int = 0,
               edge_thresh: float = 1e-2,
               device: DeviceLike = None) -> DenseGrid:
    """Sample the octree at G^3 voxel centers into a DenseGrid.

    tree: N3Tree (host; uploaded to ``device``, default CUDA) or TreeArrays
        (the bake runs on the tensors' device).
    G: grid resolution; default = the tree's full resolution (exact bake).
    dtype: "f16" (exact leaf values) or "int8" (per-channel linear
        quantization, dequantized on the fly inside the march kernel).
    edge_supersample: when n >= 2, the voxels of the occupancy boundary
        band (sigma crosses ``edge_thresh`` across a face neighbour) are
        re-baked as the mean of n^3 sub-centre samples (an anti-aliased
        silhouette); a no-op at the tree's full resolution, where every
        sub-sample lands in the voxel's own leaf. 0/1 = off.
    """
    if dtype not in ("f16", "int8"):
        raise ValueError(f"unsupported grid dtype {dtype!r}")
    if isinstance(tree, N3Tree):
        dev = tree.to_device(lut_depth=None, device=device)
    else:
        dev = tree
    if G is None:
        G = full_resolution(dev)

    meta = render_exact.tree_meta(dev)
    D = dev.data_dim
    n = G * G * G
    chunk = min(chunk, n)
    while n % chunk:
        chunk //= 2
    device_ = dev.data.device
    data = torch.empty((n, D), dtype=torch.float16, device=device_)
    for c0 in range(0, n, chunk):
        ids = torch.arange(c0, c0 + chunk, dtype=torch.int32, device=device_)
        z = torch.div(ids, G * G, rounding_mode="floor")
        y = torch.remainder(torch.div(ids, G, rounding_mode="floor"), G)
        x = torch.remainder(ids, G)
        pos = (torch.stack([z, y, x], -1).to(torch.float32) + 0.5) / G
        leaf_idx, _, _ = render_exact._query(dev.child, dev.lut, pos, meta)
        data[c0:c0 + chunk] = render_exact._fetch_rows(
            dev.data, leaf_idx)[:, :D]
    data = data.reshape(G, G, G, D)
    if edge_supersample >= 2:
        data = _supersample_edge_band(dev, data, G, meta,
                                      int(edge_supersample),
                                      float(edge_thresh))
    sigma_grid = data[..., -1].to(torch.bfloat16)
    occ_max = _occupancy(sigma_grid)
    qscale = torch.ones((D,), dtype=torch.float32, device=device_)
    quantized = False
    if dtype == "int8":
        data, qscale = _quantize_int8(data, dev.basis_dim)
        quantized = True

    return DenseGrid(
        data=data,
        sigma_grid=sigma_grid,
        offset=dev.offset,
        scale=dev.scale,
        extra=dev.extra,
        qscale=qscale,
        G=G,
        data_dim=D,
        basis_dim=dev.basis_dim,
        fmt=dev.fmt,
        quantized=quantized,
        occ_max=occ_max,
        ndc=dev.ndc,
    )
