"""Basis evaluation on tensors: spherical harmonics and the SG/ASG lobes.

Vectorized re-derivation of the reference per-ray basis precompute
(``include/volrend/internal/lumisphere.hpp:9-87``) with identical hardcoded
SH coefficients.
"""

from __future__ import annotations

import torch

from volrend_torch.models.data_format import BasisType

# SH normalization constants, identical to lumisphere.hpp:38-80
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)
_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)

SH_SUPPORTED_DIMS = (1, 4, 9, 16, 25)


def eval_sh_basis(dirs: torch.Tensor, basis_dim: int) -> torch.Tensor:
    """Real SH basis values at unit directions.

    dirs: (..., 3); returns (..., basis_dim). basis_dim in {1,4,9,16,25}.
    """
    if basis_dim not in SH_SUPPORTED_DIMS:
        raise ValueError(f"unsupported SH basis_dim {basis_dim}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [_C0 * torch.ones_like(x)]
    if basis_dim >= 4:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if basis_dim >= 9:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [_C2[0] * xy, _C2[1] * yz, _C2[2] * (2.0 * zz - xx - yy),
                _C2[3] * xz, _C2[4] * (xx - yy)]
    if basis_dim >= 16:
        out += [_C3[0] * y * (3 * xx - yy),
                _C3[1] * xy * z,
                _C3[2] * y * (4 * zz - xx - yy),
                _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                _C3[4] * x * (4 * zz - xx - yy),
                _C3[5] * z * (xx - yy),
                _C3[6] * x * (xx - 3 * yy)]
    if basis_dim >= 25:
        out += [_C4[0] * xy * (xx - yy),
                _C4[1] * yz * (3 * xx - yy),
                _C4[2] * xy * (7 * zz - 1.0),
                _C4[3] * yz * (7 * zz - 3.0),
                _C4[4] * (zz * (35 * zz - 30) + 3),
                _C4[5] * xz * (7 * zz - 3),
                _C4[6] * (xx - yy) * (7 * zz - 1.0),
                _C4[7] * xz * (xx - 3 * yy),
                _C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))]
    return torch.stack(out, dim=-1)


def eval_sg_basis(dirs: torch.Tensor, extra) -> torch.Tensor:
    """Spherical gaussians: extra is (basis_dim, 4) = [lambda, mu_x, mu_y,
    mu_z]; out_i = exp(lambda_i * (mu_i . d - 1)) / basis_dim
    (lumisphere.hpp:30-36)."""
    extra = torch.as_tensor(extra, dtype=dirs.dtype, device=dirs.device)
    dot = torch.einsum("...d,bd->...b", dirs, extra[:, 1:4])
    return torch.exp(extra[:, 0] * (dot - 1.0)) / extra.shape[0]


def eval_asg_basis(dirs: torch.Tensor, extra) -> torch.Tensor:
    """Anisotropic SG: extra is (basis_dim, 11) = [a, b, mu_x(3), mu_y(3),
    mu_z(3)] (lumisphere.hpp:14-28); out_i = (d . mu_z) * exp(-a (d.mu_x)^2
    - b (d.mu_y)^2) / basis_dim."""
    extra = torch.as_tensor(extra, dtype=dirs.dtype, device=dirs.device)
    dx = torch.einsum("...d,bd->...b", dirs, extra[:, 2:5])
    dy = torch.einsum("...d,bd->...b", dirs, extra[:, 5:8])
    s = torch.einsum("...d,bd->...b", dirs, extra[:, 8:11])
    return (s * torch.exp(-extra[:, 0] * dx * dx - extra[:, 1] * dy * dy)
            / extra.shape[0])


def eval_basis(fmt: BasisType, basis_dim: int, dirs: torch.Tensor,
               extra=None):
    """Dispatch on data format; RGBA returns None (no basis)."""
    if fmt == BasisType.SH:
        return eval_sh_basis(dirs, basis_dim)
    if fmt == BasisType.SG:
        return eval_sg_basis(dirs, extra)
    if fmt == BasisType.ASG:
        return eval_asg_basis(dirs, extra)
    return None


def apply_basis_window(basis_vals: torch.Tensor, basis_minmax) -> torch.Tensor:
    """Zero out basis indices outside [min, max] (rt_core.cuh:98-102)."""
    lo, hi = basis_minmax
    idx = torch.arange(basis_vals.shape[-1], device=basis_vals.device)
    mask = (idx >= lo) & (idx <= hi)
    return torch.where(mask, basis_vals, torch.zeros_like(basis_vals))
