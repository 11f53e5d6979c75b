"""N3Tree: the PlenOctree container and its device-resident form.

Host side (`N3Tree`, NumPy): loads/saves the svox npz format with the same
field semantics as the reference loader (``src/n3tree.cpp:111-362``):

- ``data_dim`` (int), ``data_format`` (str like 'SH16'; legacy auto-infer),
- ``invradius3``/``invradius`` + ``offset`` (world->tree transform),
- ``child`` int32 [capacity, N, N, N] of *relative* node skips (0 = leaf),
- ``data`` float16 [capacity, N, N, N, data_dim] leaf payloads
  (3 x basis_dim color coeffs channel-major + 1 sigma),
- quantized trees: ``quant_colors`` codebook [n_q, 65536, 3] f16,
  ``quant_map`` uint16, ``sigma`` f16, optional ``data_retained``
  (decode semantics of ``src/n3tree.cpp:279-340``),
- ``extra_data`` (SG/ASG lobe parameters),
- sibling ``*_poses_bounds.npy`` enables NDC/LLFF mode
  (``src/n3tree.cpp:21-52,131-148``).

Device side (`TreeArrays`, a dataclass of torch tensors): arrays flattened
for batched gathers, plus an optional **dense leaf-pointer LUT** — one gather
instead of the reference's serial pointer-chasing descent
(``n3tree_query.hpp:13-48``).
The LUT maps a voxel at resolution N^lut_depth directly to its packed
(leaf index, depth) so a query is one gather; cells still interior at
lut_depth store a negative node pointer and finish with a short descent.
"""

from __future__ import annotations

import dataclasses
import io as _io
import os
from typing import Optional, Tuple

import numpy as np

import torch

from volrend_torch.models.data_format import BasisType, DataFormat
from volrend_torch.utils.device import DeviceLike, resolve

__all__ = ["N3Tree", "TreeArrays", "NdcConfig", "unpack_llff_poses_bounds"]


# ---------------------------------------------------------------------------
# NDC / LLFF sidecar
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NdcConfig:
    width: float
    height: float
    focal: float
    # mean-pose hints used by the GUI camera init (main.cpp:741-762)
    avg_up: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    avg_back: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    avg_cen: Tuple[float, float, float] = (0.0, 0.0, 0.0)


def unpack_llff_poses_bounds(arr: np.ndarray) -> NdcConfig:
    """Extract NDC params + mean pose from a poses_bounds.npy array.

    Mirrors ``src/n3tree.cpp:21-52``: arr is (n_cams, 17) rows of a flattened
    3x5 [rot|t|hwf] block followed by two depth bounds.
    """
    flat = np.asarray(arr, dtype=np.float64).reshape(-1, 17)
    height = float(flat[0, 4])
    width = float(flat[0, 9])
    focal = float(flat[0, 14])
    blocks = flat[:, :15].reshape(-1, 3, 5)
    right = blocks[:, :, 1].sum(axis=0)
    up = -blocks[:, :, 0].sum(axis=0)
    backward = blocks[:, :, 2].sum(axis=0)
    cen = blocks[:, :, 3].sum(axis=0)
    bd_min = float(flat[:, 15:17].min())
    total_cams = flat.shape[0]
    cen = cen / (total_cams * bd_min * 0.75)
    backward = backward / np.linalg.norm(backward)
    right = np.cross(up, backward)
    right /= np.linalg.norm(right)
    up = np.cross(backward, right)
    up /= np.linalg.norm(up)
    return NdcConfig(width, height, focal,
                     tuple(up), tuple(backward), tuple(cen))


# ---------------------------------------------------------------------------
# Device-side pytree
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TreeArrays:
    """Flattened, device-resident octree (a dataclass of tensors).

    child : int32 [K]           relative node skips, K = capacity * N^3
    data  : float16 [K, D]      leaf payloads
    offset: float32 [3]         world->tree: t = offset + scale * x_world
    scale : float32 [3]
    extra : float32 [B, E]      SG/ASG lobe params ((0,0) when unused)
    lut   : int32 [R, R, R]     packed (sub_ptr << 4 | depth) leaf LUT, or
                                -(node_ptr + 1) for cells still interior at
                                lut_depth; R = N ** lut_depth. (1,1,1) dummy
                                when lut_depth == 0.
    """
    child: object
    data: object
    offset: object
    scale: object
    extra: object
    lut: object
    N: int = 2
    data_dim: int = 4
    basis_dim: int = -1
    fmt: BasisType = BasisType.RGBA
    max_depth: int = 1
    lut_depth: int = 0
    ndc: Optional[Tuple[float, float, float]] = None  # (width, height, focal)

    @property
    def n_cells(self) -> int:
        return self.child.shape[0]


# ---------------------------------------------------------------------------
# Host-side container
# ---------------------------------------------------------------------------

class N3Tree:
    """Host (NumPy) PlenOctree with reference-compatible npz IO."""

    def __init__(self, path: Optional[str] = None):
        self.data_dim: int = 0
        self.data_format = DataFormat()
        self.N: int = 2
        self.capacity: int = 0
        # [capacity, N, N, N]
        self.child: Optional[np.ndarray] = None
        # [capacity, N, N, N, data_dim] float16
        self.data: Optional[np.ndarray] = None
        self.extra: Optional[np.ndarray] = None
        self.scale = np.ones(3, np.float32)
        self.offset = np.zeros(3, np.float32)
        self.use_ndc = False
        self.ndc: Optional[NdcConfig] = None
        self.npz_path = ""
        self._max_depth: Optional[int] = None
        if path is not None:
            self.open(path)

    # -- properties ---------------------------------------------------------

    @property
    def N3(self) -> int:
        return self.N ** 3

    @property
    def n_cells(self) -> int:
        return self.capacity * self.N3

    @property
    def max_depth(self) -> int:
        """Depth of the deepest node (root = 0); computed lazily by level BFS."""
        if self._max_depth is None:
            self._max_depth = int(self.node_depths().max())
        return self._max_depth

    def node_depths(self) -> np.ndarray:
        """Per-node depth via vectorized level-order traversal."""
        depths = np.zeros(self.capacity, np.int32)
        cflat = self.child.reshape(self.capacity, -1)
        frontier = np.array([0], np.int64)
        d = 0
        while frontier.size:
            skips = cflat[frontier]
            nz = skips != 0
            children = (frontier[:, None] + skips)[nz].ravel()
            d += 1
            if children.size == 0 or d > 40:
                break
            depths[children] = d
            frontier = children
        return depths

    # -- IO -----------------------------------------------------------------

    def open(self, path: str) -> "N3Tree":
        assert path.endswith(".npz"), "expected .npz octree file"
        self.npz_path = path
        from volrend_torch.io import native_npz
        self.load_npz(native_npz.load_npz(path))
        pb_path = path[:-4] + "_poses_bounds.npy"
        if os.path.isfile(pb_path):
            self.use_ndc = True
            self.ndc = unpack_llff_poses_bounds(np.load(pb_path))
        return self

    def open_mem(self, buf: bytes) -> "N3Tree":
        with np.load(_io.BytesIO(buf), allow_pickle=False) as npz:
            self.load_npz(dict(npz.items()))
        return self

    def load_npz(self, npz: dict) -> None:
        self.data_dim = int(np.asarray(npz["data_dim"]).ravel()[0])
        if "data_format" in npz:
            fmt_str = str(np.asarray(npz["data_format"]).ravel()[0])
            self.data_format = DataFormat.parse(fmt_str)
        else:
            # Legacy auto-infer (src/n3tree.cpp:240-254)
            if self.data_dim == 4:
                self.data_format = DataFormat(BasisType.RGBA, -1)
            else:
                self.data_format = DataFormat(
                    BasisType.SH, (self.data_dim - 1) // 3)

        if "invradius3" in npz:
            self.scale = np.asarray(npz["invradius3"], np.float32).reshape(3)
        else:
            self.scale = np.full(
                3, float(np.asarray(npz["invradius"]).ravel()[0]), np.float32)
        self.offset = np.asarray(npz["offset"], np.float32).reshape(3)

        self.child = np.ascontiguousarray(npz["child"], np.int32)
        self.N = int(self.child.shape[1])

        if "quant_colors" in npz:
            self._decode_quantized(npz)
        else:
            data = npz["data"]
            if data.dtype != np.float16:
                raise ValueError("data must be stored in half precision")
            self.capacity = int(data.shape[0])
            self.data = np.ascontiguousarray(data)

        if "extra_data" in npz and np.asarray(npz["extra_data"]).size:
            self.extra = np.asarray(npz["extra_data"], np.float32)
        else:
            self.extra = None
        self._max_depth = None

    def _decode_quantized(self, npz: dict) -> None:
        """Decode codebook-quantized colors (src/n3tree.cpp:279-340)."""
        quant_colors = npz["quant_colors"]   # (n_q, 65536, 3) f16
        if quant_colors.dtype != np.float16:
            raise ValueError("codebook must be stored in half precision")
        quant_map = npz["quant_map"]         # (n_q, capacity, N, N, N) u16
        n_q = int(quant_map.shape[0])
        if quant_colors.shape[0] != n_q:
            raise ValueError("codebook and map basis numbers do not match")
        self.capacity = int(quant_map.shape[1])
        retained = npz.get("data_retained")
        n_retain = int(retained.shape[0]) if retained is not None else 0
        n_basis = n_q + n_retain
        N = self.N
        n_child = self.capacity * N ** 3
        D = self.data_dim

        data = np.zeros((n_child, D), np.float16)
        map_flat = quant_map.reshape(n_q, n_child)
        for j in range(n_q):
            vals = quant_colors[j][map_flat[j].astype(np.int64)]  # (n_child,3)
            for c in range(3):
                data[:, c * n_basis + n_retain + j] = vals[:, c]
        if n_retain:
            ret = np.asarray(retained, np.float16).reshape(n_retain, n_child, 3)
            for j in range(n_retain):
                for c in range(3):
                    data[:, c * n_basis + j] = ret[j, :, c]
        data[:, D - 1] = np.asarray(npz["sigma"], np.float16).reshape(n_child)
        self.data = data.reshape(self.capacity, N, N, N, D)

    def save_npz(self, path: str, compressed: bool = True) -> None:
        """Write a dense npz the reference loader can open."""
        save = np.savez_compressed if compressed else np.savez
        save(
            path,
            data_dim=np.int64(self.data_dim),
            data_format=np.str_(self.data_format.to_string()),
            invradius3=self.scale.astype(np.float32),
            offset=self.offset.astype(np.float32),
            child=self.child.astype(np.int32),
            data=self.data.astype(np.float16),
            **({"extra_data": self.extra} if self.extra is not None else {}),
        )

    # -- index helpers (src/n3tree.cpp:449-462) ------------------------------

    def pack_index(self, nd: int, i: int, j: int, k: int) -> int:
        N = self.N
        return nd * self.N3 + i * N * N + j * N + k

    def unpack_index(self, packed: int) -> Tuple[int, int, int, int]:
        N = self.N
        k = packed % N
        packed //= N
        j = packed % N
        packed //= N
        i = packed % N
        packed //= N
        return packed, i, j, k

    # -- wireframe (src/n3tree.cpp:364-434) ----------------------------------

    def gen_wireframe(self, max_depth: int = 4) -> np.ndarray:
        """Cube wireframe vertices for visible voxels, 9 floats per vertex
        (pos3 + rgb3 + normal3, normal=(0,0,1)), in world coordinates."""
        verts = []

        def push_bb(bb):
            for i in range(2):
                for j in range(2):
                    for pair in (((0, i, j), (1, i, j)),
                                 ((i, 0, j), (i, 1, j)),
                                 ((i, j, 0), (i, j, 1))):
                        for (a, b, c) in pair:
                            verts.append([bb[a * 3], bb[b * 3 + 1],
                                          bb[c * 3 + 2], 0, 0, 0, 0, 0, 1])

        N = self.N
        cflat = self.child.reshape(self.capacity, -1)

        def rec(nodeid, xi, yi, zi, depth, gridsz):
            cnt = 0
            for i in range(xi * N, (xi + 1) * N):
                for j in range(yi * N, (yi + 1) * N):
                    for k in range(zi * N, (zi + 1) * N):
                        skip = cflat[nodeid, cnt]
                        if skip == 0 or depth >= max_depth:
                            bb = [
                                (i / gridsz - self.offset[0]) / self.scale[0],
                                (j / gridsz - self.offset[1]) / self.scale[1],
                                (k / gridsz - self.offset[2]) / self.scale[2],
                                ((i + 1) / gridsz - self.offset[0]) / self.scale[0],
                                ((j + 1) / gridsz - self.offset[1]) / self.scale[1],
                                ((k + 1) / gridsz - self.offset[2]) / self.scale[2],
                            ]
                            push_bb(bb)
                        else:
                            rec(nodeid + skip, i, j, k, depth + 1, gridsz * N)
                        cnt += 1

        rec(0, 0, 0, 0, 0, N)
        return np.asarray(verts, np.float32)

    # -- LUT + device upload --------------------------------------------------

    def build_lut(self, lut_depth: Optional[int] = None) -> Tuple[np.ndarray, int]:
        """Dense leaf-pointer LUT at resolution N**lut_depth.

        Entry >= 0: packed (sub_ptr << 4) | depth for the leaf covering the
        voxel (depth = reference cube_sz exponent, i.e. cube_sz = N**depth).
        Entry < 0: -(node_ptr + 1), an interior node at lut_depth to resume
        descent from. Default lut_depth = max_depth (fully exact, 1 gather).
        """
        N = self.N
        if lut_depth is None:
            lut_depth = self.max_depth + 1
        lut_depth = max(1, lut_depth)
        R = N ** lut_depth
        lut = np.zeros((R, R, R), np.int32)
        cflat = self.child.reshape(self.capacity, -1)

        # level-order: frontier of (node_id, i, j, k) at node-depth d
        node_ids = np.array([0], np.int64)
        coords = np.zeros((1, 3), np.int64)
        for d in range(lut_depth):
            n = node_ids.shape[0]
            if n == 0:
                break
            # expand each node into its N^3 cells
            cell = np.arange(self.N3)
            ci = cell // (N * N)
            cj = (cell // N) % N
            ck = cell % N
            cell_coords = (coords[:, None, :] * N
                           + np.stack([ci, cj, ck], -1)[None])  # (n, N3, 3)
            skips = cflat[node_ids]                              # (n, N3)
            sub_ptr = node_ids[:, None] * self.N3 + cell         # (n, N3)
            is_leaf = skips == 0

            res = N ** (d + 1)       # resolution of this cell level
            s = R // res             # LUT voxels per cell side
            lv = lut.reshape(res, s, res, s, res, s)

            # leaves: fill their LUT block with packed (sub_ptr, depth=d+1)
            leaf_coords = cell_coords[is_leaf]
            leaf_entry = ((sub_ptr[is_leaf] << 4) | (d + 1)).astype(np.int32)
            if leaf_coords.size:
                lv[leaf_coords[:, 0], :, leaf_coords[:, 1], :,
                   leaf_coords[:, 2], :] = leaf_entry[:, None, None, None]

            child_nodes = (node_ids[:, None] + skips)[~is_leaf].ravel()
            child_coords = cell_coords[~is_leaf]
            if d == lut_depth - 1:
                # cells still interior at the last LUT level: store resume ptr
                if child_nodes.size:
                    lv[child_coords[:, 0], :, child_coords[:, 1], :,
                       child_coords[:, 2], :] = (
                        -(child_nodes.astype(np.int32) + 1)
                    )[:, None, None, None]
                break
            node_ids = child_nodes
            coords = child_coords
        return lut, lut_depth

    def to_device(self, lut_depth: Optional[int] = 0,
                  device: DeviceLike = None) -> TreeArrays:
        """Upload as flattened tensors on ``device`` (default CUDA).

        lut_depth: 0 disables the LUT (pure descent queries); None = exact
        full-depth LUT; k>0 = truncated LUT + residual descent.
        """
        dev = resolve(device)
        if lut_depth == 0:
            lut = np.zeros((1, 1, 1), np.int32)
            lut_d = 0
        else:
            lut, lut_d = self.build_lut(lut_depth)
        extra = self.extra
        if extra is None:
            extra = np.zeros((0, 0), np.float32)
        ndc = None
        if self.use_ndc and self.ndc is not None:
            ndc = (self.ndc.width, self.ndc.height, self.ndc.focal)
        host_data = (self.data.reshape(-1, self.data_dim)
                     if self.data is not None
                     else np.zeros((0, self.data_dim), np.float16))
        # pad leaf rows to a multiple of 64 (128 B in f16): full cache-line
        # rows for the leaf gather; data_dim stays the logical width,
        # consumers index explicitly
        pad = (-host_data.shape[1]) % 64
        if pad and host_data.shape[0]:
            host_data = np.pad(host_data, ((0, 0), (0, pad)))
        return TreeArrays(
            child=torch.as_tensor(
                np.ascontiguousarray(self.child.reshape(-1), np.int32)
            ).to(dev),
            data=torch.as_tensor(
                np.ascontiguousarray(host_data, np.float16)).to(dev),
            offset=torch.as_tensor(self.offset, dtype=torch.float32).to(dev),
            scale=torch.as_tensor(self.scale, dtype=torch.float32).to(dev),
            extra=torch.as_tensor(
                np.asarray(extra, np.float32)).to(dev),
            lut=torch.as_tensor(np.ascontiguousarray(lut)).to(dev),
            N=self.N,
            data_dim=self.data_dim,
            basis_dim=self.data_format.basis_dim,
            fmt=self.data_format.format,
            max_depth=self.max_depth,
            lut_depth=lut_d,
            ndc=ndc,
        )
