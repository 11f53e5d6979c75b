"""SH-lobe mesh generator (``sample_obj/sh/gen_sh.cpp`` parity; the
counterpart of ``volrend_tpu/utils/sh_mesh.py``).

Generates colored OBJ meshes visualizing real spherical-harmonic lobes:
vertex radius = |Y_k(d)|, red for positive lobes / blue for negative, on a
UV-sphere triangulation. Uses the renderer's own SH table (ops/basis.py,
evaluated in float64 on the host) so the lobes match what the renderer
evaluates.
"""

from __future__ import annotations

import numpy as np
import torch

from volrend_torch.models.mesh import Mesh
from volrend_torch.ops import basis as basis_mod

__all__ = ["sh_lobe_mesh", "save_obj"]


def sh_lobe_mesh(k: int, rings: int = 64, sectors: int = 128,
                 scale: float = 1.0) -> Mesh:
    """Mesh of SH basis function k (0..24)."""
    bd = next(b for b in basis_mod.SH_SUPPORTED_DIMS if b > k)
    m = Mesh.Sphere(rings, sectors, (1.0, 1.0, 1.0))
    dirs = m.vert[:, :3].astype(np.float64)
    vals = basis_mod.eval_sh_basis(torch.from_numpy(dirs), bd)[:, k].numpy()
    m.vert[:, :3] = (dirs * np.abs(vals)[:, None] * scale).astype(np.float32)
    pos = vals >= 0
    m.vert[:, 3:6] = np.where(pos[:, None],
                              np.array([[0.9, 0.2, 0.2]], np.float32),
                              np.array([[0.2, 0.3, 0.9]], np.float32))
    # normals point along the (signed) radial direction
    m.vert[:, 6:9] = dirs.astype(np.float32)
    m.name = f"SH_{k}"
    return m


def save_obj(mesh: Mesh, path: str) -> None:
    """Write a triangle mesh as OBJ with per-vertex colors (the format
    load_basic_obj / the reference's tinyobj read back)."""
    with open(path, "w") as f:
        for v in mesh.vert:
            f.write(f"v {v[0]:.6g} {v[1]:.6g} {v[2]:.6g} "
                    f"{v[3]:.4g} {v[4]:.4g} {v[5]:.4g}\n")
        for v in mesh.vert:
            f.write(f"vn {v[6]:.4g} {v[7]:.4g} {v[8]:.4g}\n")
        faces = (mesh.faces.reshape(-1, 3) + 1 if mesh.faces.size
                 else np.arange(mesh.n_verts).reshape(-1, 3) + 1)
        for a, b, c in faces:
            f.write(f"f {a} {b} {c}\n")
