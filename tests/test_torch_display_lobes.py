"""Kernel M's display mode shades SG and ASG lobes from a table each block
folds once (csrc/slab_march_display.cu ``fold_lobe``, evaluated by
``lobe_at``): log2(e), the lobe count's 1/nb and the scale qs[k] the int8
bake shares across rgb folded in, SG as one float4 a lobe and ASG's
exponent as a quadratic form in the view direction. Here the fold and the
evaluation are mirrored in plain PyTorch, operation for operation, and
held against the reference's lobes: ``_mk_basis``
(volrend_tpu/ops/pallas_slab.py:397-416) evaluates exp(lambda (mu . d -
1)) / nb and S exp(-a dotx^2 - b doty^2) / nb, the formulas of
``volrend_tpu.ops.basis.eval_sg_basis`` and ``eval_asg_basis``, which
give the reference's values here (in float64 on the same float32 inputs).
The kernel itself is held to the plain march on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from volrend_tpu.ops import basis as ref_basis

torch.set_num_threads(1)

L2E = 1.4426950408889634   # log2(e), as the kernel's float constant

#: the fold's tolerance against the reference's lobes: rtol 1e-5 (the
#: folded exponent's f32 rounding, ~1e-6 of a lobe at these lambdas and
#: bandwidths, and ex2 against exp), plus an atol of 1e-6 of the lobe's
#: scale qs[k] / nb for ASG values near S = 0, where the f32 dot product
#: S . d loses its relative precision in the reference as in the kernel
RTOL, ATOL = 1e-5, 1e-6


def fold_lobes(fmt: str, extra: torch.Tensor, qs: torch.Tensor):
    """The kernel's fold_lobe for every lobe of ``extra`` (nb x 4 SG or nb
    x 11 ASG, f32) with the scales ``qs`` (f32, qs[k] for lobe k): an (nb,
    4) SG table (A, B) or an (nb, 3, 4) ASG table, f32 throughout."""
    f32 = torch.float32
    nb = extra.shape[0]
    l2e = torch.tensor(L2E, dtype=f32)
    q = qs[:nb]
    if fmt == "SG":
        lam = extra[:, 0] * l2e
        b = (torch.log2(q) - torch.log2(torch.tensor(float(nb), dtype=f32))
             ) - lam
        return torch.cat([lam[:, None] * extra[:, 1:4], b[:, None]], 1)
    a, b = extra[:, 0], extra[:, 1]
    mx, my, mz = extra[:, 2:5], extra[:, 5:8], extra[:, 8:11]
    m = (a[:, None, None] * (mx[:, :, None] * mx[:, None, :])
         + b[:, None, None] * (my[:, :, None] * my[:, None, :]))
    s, s2 = -l2e, -2.0 * l2e
    sq = q / torch.tensor(float(nb), dtype=f32)
    zero = torch.zeros(nb, dtype=f32)
    return torch.stack([
        torch.stack([s * m[:, 2, 2], s * (m[:, 0, 0] - m[:, 2, 2]),
                     s * (m[:, 1, 1] - m[:, 2, 2]), s2 * m[:, 0, 1]], 1),
        torch.stack([s2 * m[:, 0, 2], s2 * m[:, 1, 2], mz[:, 0] * sq,
                     mz[:, 1] * sq], 1),
        torch.stack([mz[:, 2] * sq, zero, zero, zero], 1)], 1)


def lobe_values(fmt: str, table: torch.Tensor, dirs: torch.Tensor):
    """The kernel's lobe_at: each lobe's value times its scale at the unit
    directions ``dirs`` (N, 3), (N, nb), in the kernel's order of
    operations (its multiply-adds as a product and a sum)."""
    x, y, z = (dirs[:, i, None] for i in range(3))
    if fmt == "SG":
        t = table
        return torch.exp2(t[:, 0] * x + (t[:, 1] * y + (t[:, 2] * z
                                                        + t[:, 3])))
    r0, r1, r2 = table[:, 0], table[:, 1], table[:, 2]
    e = (r1[:, 1] * (y * z) + (r1[:, 0] * (x * z) + (r0[:, 3] * (x * y) + (
        r0[:, 2] * (y * y) + (r0[:, 1] * (x * x) + r0[:, 0])))))
    s = r2[:, 0] * z + (r1[:, 3] * y + r1[:, 2] * x)
    return s * torch.exp2(e)


def _lobes(fmt: str, nb: int, seed: int) -> np.ndarray:
    """SG (nb, 4) or ASG (nb, 11) lobes as the reference's tests draw them
    (tests/_torch_scenes.lobes), ASG with a negative bandwidth on lobe 0:
    the quadratic form holds whatever the signs."""
    rng = np.random.default_rng(seed)
    if fmt == "SG":
        mu = rng.normal(size=(nb, 3))
        mu /= np.linalg.norm(mu, axis=-1, keepdims=True)
        return np.concatenate([rng.uniform(1.0, 6.0, (nb, 1)), mu],
                              -1).astype(np.float32)
    extra = np.zeros((nb, 11), np.float32)
    for i in range(nb):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        extra[i, :2] = rng.uniform(0.5, 4.0, 2)
        extra[i, 2:] = q.T.reshape(-1)
    extra[0, 0] = -0.75
    return extra


def _dirs(n: int, seed: int) -> np.ndarray:
    """Unit view directions in f32, normalised as the kernel's (rsqrt)."""
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return (d / np.sqrt((d * d).sum(-1, keepdims=True))).astype(np.float32)


@pytest.mark.parametrize("nb", [1, 9, 25])
@pytest.mark.parametrize("fmt", ["SG", "ASG"])
def test_folded_lobes_match_the_reference(fmt, nb):
    """The folded table, evaluated as the kernel evaluates it, gives the
    reference's lobes times their scales at 4096 directions (and at each
    lobe's own axis, where SG peaks and ASG's exponent is 0)."""
    extra = _lobes(fmt, nb, seed=nb)
    rng = np.random.default_rng(100 + nb)
    qs = rng.uniform(0.002, 0.05, 3 * nb + 2).astype(np.float32)
    axes = extra[:, 1:4] if fmt == "SG" else extra[:, 8:11]
    dirs = np.concatenate([_dirs(4096, seed=nb), axes.astype(np.float32)])
    ev = ref_basis.eval_sg_basis if fmt == "SG" else ref_basis.eval_asg_basis
    want = ev(dirs.astype(np.float64), extra.astype(np.float64)) * qs[:nb]
    table = fold_lobes(fmt, torch.as_tensor(extra), torch.as_tensor(qs))
    got = lobe_values(fmt, table, torch.as_tensor(dirs))
    assert got.dtype == torch.float32 and got.shape == (len(dirs), nb)
    want = torch.as_tensor(want)
    # SG's values are positive exponentials: rtol alone
    atol = 0.0 if fmt == "SG" else ATOL * torch.as_tensor(qs[:nb] / nb,
                                                          dtype=torch.float64)
    err = (got.double() - want).abs()
    bound = RTOL * want.abs() + atol
    assert bool((err <= bound).all()), float((err / bound).max())


def test_folded_lobe_table_layout():
    """SG folds to one float4 a lobe and ASG to three (the kernel's 16-byte
    broadcast loads), ASG's padding zero; a zero scale gives a zero lobe
    (log2(0) = -inf folds into SG's exponent)."""
    for fmt, width in (("SG", (4,)), ("ASG", (3, 4))):
        extra = torch.as_tensor(_lobes(fmt, 5, seed=1))
        qs = torch.full((17,), 0.01)
        table = fold_lobes(fmt, extra, qs)
        assert table.shape == (5,) + width and table.dtype == torch.float32
        if fmt == "ASG":
            assert bool((table[:, 2, 1:] == 0).all())
        qs[2] = 0.0
        vals = lobe_values(fmt, fold_lobes(fmt, extra, qs),
                           torch.as_tensor(_dirs(64, seed=2)))
        assert bool((vals[:, 2] == 0).all())
        assert bool(torch.isfinite(vals).all())
