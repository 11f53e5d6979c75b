"""The port's SG, ASG and RGBA trees and the f16 bake's route against the
reference: the SG/ASG bases, the int8 bakes of each format (bit for bit),
``edge_supersample``, the f16 route's bf16 payload (bit for bit), kernel
M's plain version against the reference's Pallas kernel in interpret mode
on int8 and bf16 payloads of every format, and ``render_image`` on each
format against the reference's.

Tolerances (as tests/test_torch_march.py and tests/test_torch_frames.py):
rgb PSNR >= 45 dB, T and alpha within 2e-2; the reference rounds its warp
weights and stacked channels to bf16 for its matmuls, the port keeps them
in f32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from volrend_tpu.models import data_format as j_fmt
from volrend_tpu.ops import basis as j_basis
from volrend_tpu.ops import dense_grid as j_dense
from volrend_tpu.ops import slab_render as j_slab
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch.models import data_format as t_fmt
from volrend_torch.ops import basis as t_basis
from volrend_torch.ops import dense_grid as t_dense
from volrend_torch.ops import render_exact, slab_render
from volrend_torch.utils.options import RenderOptions

from _torch_scenes import (CPU, format_scene, format_trees, interpret, lobes,
                           make_cam, march_pair, np32, psnr, trees)

torch.set_num_threads(1)

GATE_DB = 45.0
T_ATOL = 2e-2


@pytest.mark.parametrize("fmt", ["SG", "ASG"])
@pytest.mark.parametrize("bd", [1, 4, 16])
def test_lobe_basis_matches_reference(fmt, bd):
    rng = np.random.default_rng(bd)
    d = rng.normal(size=(64, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    extra = lobes(fmt, bd, 3)
    bt = t_fmt.BasisType[fmt]
    got = t_basis.eval_basis(bt, bd, torch.as_tensor(d, dtype=torch.float32),
                             torch.as_tensor(extra)).numpy()
    want = np.asarray(j_basis.eval_basis(
        j_fmt.BasisType[fmt], bd, jnp.asarray(d, jnp.float32),
        jnp.asarray(extra), xp=jnp))
    assert got.shape == (64, bd)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("fmt", ["SG", "ASG", "RGBA"])
def test_int8_bake_bit_equal(fmt):
    """SG and ASG share each basis function's scale across rgb; RGBA scales
    each channel alone."""
    _, g, _, jg = format_scene(fmt, 4, "int8")
    np.testing.assert_array_equal(g.data.numpy(), np.asarray(jg.data))
    np.testing.assert_array_equal(g.qscale.numpy(), np.asarray(jg.qscale))
    np.testing.assert_array_equal(np32(g.extra), np32(jg.extra))
    assert g.occ_max == jg.occ_max
    assert (int(g.fmt), g.basis_dim, g.data_dim) == (
        int(jg.fmt), jg.basis_dim, jg.data_dim)
    qs = g.qscale.numpy()
    if fmt == "RGBA":
        # colours, then sigma's hi and lo planes
        assert g.data.shape[-1] == 5 and qs.shape == (5,)
    else:
        q = qs[:12].reshape(3, 4)
        np.testing.assert_array_equal(q[0], q[1])
        np.testing.assert_array_equal(q[0], q[2])


@pytest.mark.parametrize("n_sub", [2, 3])
def test_edge_supersample_matches_reference(n_sub):
    """Baked coarser than the tree (G = 8 of its 16), the boundary band's
    voxels are the mean of n^3 sub-centre samples, as the reference's; the
    means are f32 sums in another order, rounded to f16 (one f16 step
    apart at most). Interior and empty voxels keep their point sample."""
    tt, jt = trees("dense", 4)
    tdev = tt.to_device(lut_depth=None, device=CPU)
    jdev = jt.to_device(lut_depth=None)
    got = t_dense.bake_dense(tdev, G=8, dtype="f16",
                             edge_supersample=n_sub)
    want = j_dense.bake_dense(jdev, G=8, dtype="f16",
                              edge_supersample=n_sub)
    plain = t_dense.bake_dense(tdev, G=8, dtype="f16")
    a = got.data.numpy().astype(np.float32)
    b = np.asarray(want.data).astype(np.float32)
    np.testing.assert_allclose(a, b, rtol=2 ** -10, atol=1e-6)
    changed = np.any(a != plain.data.numpy().astype(np.float32), -1)
    assert 0 < changed.sum() < changed.size
    # the occupancy is taken after the re-bake
    np.testing.assert_allclose(np.asarray(got.occ_max),
                               np.asarray(want.occ_max), rtol=2 ** -7)


@pytest.mark.parametrize("fmt", ["SH", "SG", "RGBA"])
def test_f16_route_payload_bit_equal(fmt, monkeypatch):
    """The f16 bake's payload: permuted, cropped, cast to bf16 (Dp = D,
    sigma last), bit for bit the reference's planar payload."""
    _, g, _, jg = format_scene(fmt, 4, "f16")
    for mod in (j_slab, slab_render):
        monkeypatch.setattr(mod, "_CROP_MULT_Y", 4)
        monkeypatch.setattr(mod, "_CROP_MULT_X", 4)
    for perm in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        crop = slab_render.inplane_crop(g, perm, 1e-2)
        assert crop == j_slab.inplane_crop(jg, perm, 1e-2)
        got = slab_render.prepare_payload(g, perm, RenderOptions())
        want = np.asarray(j_slab._permuted_grid(jg, perm, True,
                                                crop=crop)[0])
        assert got.dtype == torch.bfloat16 and got.shape[1] == g.data_dim
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))


def _assert_march(got, want):
    assert np.all(np.isfinite(got))
    p = psnr(got[:3], want[:3])
    assert p >= GATE_DB, f"rgb PSNR {p:.2f} dB"
    np.testing.assert_allclose(got[3], want[3], atol=T_ATOL)
    assert float(want[3].min()) < 0.5


@pytest.mark.parametrize("fmt", ["SH", "SG", "ASG", "RGBA"])
@pytest.mark.parametrize("dtype", ["int8", "f16"])
def test_march_formats_match_interpret(monkeypatch, fmt, dtype):
    """Kernel M's plain version against the reference's kernel in
    interpret mode on the int8 payload and the f16 bake's bf16 one: SH4,
    SG4, ASG4 (their lobes from ``extra``) and RGBA."""
    _, g, _, jg = format_scene(fmt, 4, dtype)
    cam = make_cam((1.0, 0.25, 0.35), width=48, height=48)
    with interpret(monkeypatch):
        got, want = march_pair(g, jg, cam, JOpt(max_steps=512))
    _assert_march(got, want)


@pytest.mark.parametrize("fmt", ["SH", "SG", "ASG", "RGBA"])
def test_render_image_formats_match_reference(monkeypatch, fmt):
    """``render_image`` on each format's f16 bake (the apps' route) against
    the reference's in interpret mode (45 dB, alpha within 2e-2), and
    against the port's exact renderer (30 dB, the reference's own
    slab-vs-exact floor for these trees, test_slab_render.py:359)."""
    tdev, g, _, jg = format_scene(fmt, 4, "f16")
    # gi > min(W, H): both packages warp with the reference quad-gather
    # warp (the superquad warps are held in tests/test_torch_warp*.py)
    cam = make_cam((1.0, 0.25, 0.3), width=40, height=40, fx=50.0)
    with interpret(monkeypatch):
        want = np.asarray(j_slab.render_image(jg, cam, JOpt(max_steps=512),
                                              gi=48))
        got = slab_render.render_image(g, cam, RenderOptions(max_steps=512),
                                       gi=48)
    p = psnr(got[..., :3], want[..., :3])
    assert p >= GATE_DB, f"{fmt}: rgb PSNR {p:.2f} dB"
    np.testing.assert_allclose(got[..., 3], want[..., 3], atol=T_ATOL)
    exact = render_exact.render_image(tdev, cam,
                                      RenderOptions(max_steps=512)).numpy()
    assert psnr(got[..., :3], exact[..., :3]) > 30.0
    assert float(want[..., 3].max()) > 0.5


def test_lobe_count_outside_the_set_raises():
    """SG/ASG lobe counts past the compiled set (1..25) raise ValueError
    naming it; the reference's kernel takes them (ROADMAP §3)."""
    _, g, _, _ = format_scene("SG", 4, "int8")
    import dataclasses
    big = dataclasses.replace(g, basis_dim=26, data_dim=79,
                              extra=torch.zeros((26, 4)))
    with pytest.raises(ValueError, match="1..25"):
        slab_render.prepare_payload(big, (0, 1, 2), RenderOptions())
    assert format_trees("SG", 4)[0].extra.shape == (4, 4)
