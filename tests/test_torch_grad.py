"""The port's T2 training march and its fused backward
(``volrend_torch/ops/grad.py``, ``render_exact.render_rays(differentiable=
True)``) against the reference's (``volrend_tpu/ops/grad.py``,
``render_jax.render_rays``) on the CPU, on tests/test_grad.py's scene (8x8
rays, depth 3, 150 fixed steps).

Tolerances: forwards 1e-5 absolute (f32 in another summation order); the
losses rtol 1e-5; the port's gradients against the reference's within
GRAD_ATOL x max|g| (the scatter-add runs in another order: ``index_add_``
against ``.at[].add``); the fused gradient against autograd through the
fixed-length loop with tests/test_grad.py's atol 3e-3 x max|g|, rtol
2e-3."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from volrend_tpu.models import synthetic as j_synth
from volrend_tpu.ops import grad as j_grad
from volrend_tpu.ops import render_jax
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch.models import synthetic as t_synth
from volrend_torch.ops import grad, render_exact
from volrend_torch.ops.camera import Camera
from volrend_torch.utils.options import RenderOptions

from _torch_scenes import format_trees, ndc_cam, ndc_scene

torch.set_num_threads(1)

SIZE = 8
N_STEPS = 150
GRAD_ATOL = 1e-5          # times max|g|: port against reference
KW = dict(max_depth=3, basis_dim=4, seed=0, sigma_scale=60.0)


def _opts(**kw):
    base = dict(background_brightness=0.3, renormalize=False)
    base.update(kw)
    return RenderOptions(**base), JOpt(**base)


@pytest.fixture(scope="module")
def setup():
    """tests/test_grad.py's scene in both packages (descent queries), its
    8x8 rays and seeded target."""
    jdev = j_synth.make_test_tree(**KW).to_device(lut_depth=0)
    tdev = t_synth.make_test_tree(**KW).to_device(lut_depth=0, device="cpu")
    cam = Camera.from_vectors(width=SIZE, height=SIZE, fx=SIZE * 1.2)
    o, d = cam.pixel_rays()
    rng = np.random.default_rng(0)
    target = rng.uniform(0, 1, (SIZE * SIZE, 4)).astype(np.float32)
    return jdev, tdev, np.ascontiguousarray(o), d, target


def _scan_loss_torch(tdev, data, o, d, opt, target):
    t = dataclasses.replace(tdev, data=data)
    out = render_exact.render_rays(t, o, d, opt, differentiable=True,
                                   n_steps=N_STEPS)
    diff = out[:, :3] - target[:, :3]
    return torch.mean(diff * diff)


def _autograd(tdev, o, d, opt, target):
    dat = tdev.data.float().requires_grad_(True)
    loss = _scan_loss_torch(tdev, dat, torch.tensor(o), torch.tensor(d),
                            opt, torch.tensor(target))
    loss.backward()
    return float(loss.detach()), dat.grad.numpy()


def _fused(tdev, o, d, opt, target):
    loss, g = grad.l2_loss_and_grad(tdev, torch.tensor(o), torch.tensor(d),
                                    torch.tensor(target), opt,
                                    data=tdev.data.float())
    return float(loss), g.numpy()


def _reference(jdev, o, d, jopt, target):
    loss, g = j_grad.l2_loss_and_grad(
        jdev, jnp.asarray(o), jnp.asarray(d), jnp.asarray(target), jopt,
        data=jnp.asarray(jdev.data, jnp.float32))
    return float(loss), np.asarray(g)


def _assert_grads_close(mine, ref, atol_rel=GRAD_ATOL, rtol=0.0):
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(mine, ref, atol=atol_rel * scale, rtol=rtol)


def test_forwards_match_reference(setup):
    """The fused forward (the while-march with training semantics) and the
    fixed-length differentiable loop, against the reference's, both to
    1e-5."""
    jdev, tdev, o, d, _ = setup
    opt, jopt = _opts()
    data32 = tdev.data.float()
    jt = dataclasses.replace(jdev, data=jnp.asarray(jdev.data, jnp.float32))
    a = grad.render_rays_train(tdev, torch.tensor(o), torch.tensor(d), opt,
                               data=data32)
    b = j_grad.render_rays_train(jt, jnp.asarray(o), jnp.asarray(d), jopt)
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5)
    tt = dataclasses.replace(tdev, data=data32)
    c = render_exact.render_rays(tt, torch.tensor(o), torch.tensor(d), opt,
                                 differentiable=True, n_steps=N_STEPS)
    e = render_jax.render_rays(jt, jnp.asarray(o), jnp.asarray(d), jopt,
                               differentiable=True, n_steps=N_STEPS)
    np.testing.assert_allclose(c.numpy(), np.asarray(e), atol=1e-5)
    np.testing.assert_allclose(a.detach().numpy(), c.numpy(), atol=1e-5)


def test_loss_and_grad_match_reference(setup):
    """l2_loss_and_grad against the reference's: the loss to rtol 1e-5, the
    gradient to GRAD_ATOL x max|g|; padding columns get zero gradient."""
    jdev, tdev, o, d, target = setup
    opt, jopt = _opts()
    loss, g = _fused(tdev, o, d, opt, target)
    jloss, jg = _reference(jdev, o, d, jopt, target)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert g.shape == jg.shape
    _assert_grads_close(g, jg)
    assert not np.any(g[:, tdev.data_dim:])
    # both sigma and coefficient gradients are alive
    assert np.abs(g[:, tdev.data_dim - 1]).max() > 0
    assert np.abs(g[:, :tdev.data_dim - 1]).max() > 0


def test_fused_grad_matches_autograd(setup):
    """The fused backward against autograd through the fixed-length loop
    (tests/test_grad.py's tolerance)."""
    _, tdev, o, d, target = setup
    opt, _ = _opts()
    loss_f, g_f = _fused(tdev, o, d, opt, target)
    loss_a, g_a = _autograd(tdev, o, d, opt, target)
    np.testing.assert_allclose(loss_f, loss_a, rtol=1e-5)
    _assert_grads_close(g_f, g_a, atol_rel=3e-3, rtol=2e-3)


def test_grad_finite_differences(setup):
    """Central finite differences of the fixed-length loop's loss on the
    largest-|grad| sigma coordinate and four coefficient coordinates
    (tests/test_grad.py: h = 2e-2, within 5e-2 relative)."""
    _, tdev, o, d, target = setup
    opt, _ = _opts()
    _, g = _fused(tdev, o, d, opt, target)
    data32 = tdev.data.float()
    to, td, tt = torch.tensor(o), torch.tensor(d), torch.tensor(target)

    def loss(data):
        with torch.no_grad():
            return float(_scan_loss_torch(tdev, data, to, td, opt, tt))

    sig = tdev.data_dim - 1
    coords = [(int(np.abs(g[:, sig]).argmax()), sig)]
    flat = np.abs(g[:, :sig]).copy()
    for _ in range(4):
        ij = np.unravel_index(flat.argmax(), flat.shape)
        coords.append((int(ij[0]), int(ij[1])))
        flat[ij] = 0
    h = 2e-2
    for i, j in coords:
        dp, dm = data32.clone(), data32.clone()
        dp[i, j] += h
        dm[i, j] -= h
        fd = (loss(dp) - loss(dm)) / (2 * h)
        assert abs(fd - g[i, j]) < 5e-2 * max(abs(fd), abs(g[i, j])), (
            i, j, fd, g[i, j])


def test_untouched_leaves_zero_grad(setup):
    """One central ray touches a few leaves; every other leaf gets exactly
    zero gradient, the same leaves as in the reference."""
    jdev, tdev, o, d, target = setup
    opt, jopt = _opts()
    mid = (SIZE // 2) * SIZE + SIZE // 2
    sl = slice(mid, mid + 1)
    _, g = _fused(tdev, o[sl], d[sl], opt, target[sl])
    _, jg = _reference(jdev, o[sl], d[sl], jopt, target[sl])
    touched = np.abs(g).sum(-1) > 0
    assert 0 < touched.sum() < g.shape[0] // 4
    np.testing.assert_array_equal(touched, np.abs(jg).sum(-1) > 0)


def _case(case):
    """(port tree, reference tree, rays (o, d), options) of one format or
    option case."""
    if case in ("rgba", "sg", "asg"):
        tt, jt = format_trees(case.upper())
        return (tt.to_device(lut_depth=0, device="cpu"),
                jt.to_device(lut_depth=0), None, {})
    if case == "ndc":
        tdev, _, jdev, _ = ndc_scene()
        cam = ndc_cam(width=SIZE, height=SIZE, fx=52.0 * SIZE / 48)
        o, d = cam.pixel_rays()
        return tdev, jdev, (np.ascontiguousarray(o), d), {}
    kw = {"lut": {}, "basis_minmax": dict(basis_minmax=(1, 2)),
          "rot_dirs": dict(rot_dirs=(0.3, -0.2, 0.5)),
          "render_bbox": dict(render_bbox=(0.25,) * 3 + (0.75,) * 3)}[case]
    tree_t, tree_j = t_synth.make_test_tree(**KW), j_synth.make_test_tree(**KW)
    lut = None if case == "lut" else 0
    return (tree_t.to_device(lut_depth=lut, device="cpu"),
            tree_j.to_device(lut_depth=lut), None, kw)


@pytest.mark.parametrize("case", ["rgba", "lut", "sg", "asg", "ndc",
                                  "basis_minmax", "rot_dirs", "render_bbox"])
def test_formats_and_options_match_reference(setup, case):
    """An RGBA tree, the full-depth LUT against descent, SG and ASG trees
    (tests/_torch_scenes.py), an NDC tree, and a basis window, rot_dirs and
    a render_bbox: the fused loss and gradient against the reference's
    (rtol 1e-5, GRAD_ATOL x max|g|) and against the port's own autograd
    (tests/test_grad.py's tolerance)."""
    _, base, o, d, target = setup
    tdev, jdev, rays, kw = _case(case)
    if rays is not None:
        o, d = rays
    opt, jopt = _opts(**kw)
    loss, g = _fused(tdev, o, d, opt, target)
    jloss, jg = _reference(jdev, o, d, jopt, target)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _assert_grads_close(g, jg)
    _, g_a = _autograd(tdev, o, d, opt, target)
    _assert_grads_close(g, g_a, atol_rel=3e-3, rtol=2e-3)
    if case == "lut":
        # the LUT resolves the same leaves as the descent
        _, g0 = _fused(base, o, d, opt, target)
        np.testing.assert_allclose(g, g0, atol=1e-5)


def test_render_train_vjp_matches_reference(setup):
    """render_train_vjp with a seeded RGBA cotangent (alpha included)."""
    jdev, tdev, o, d, _ = setup
    opt, jopt = _opts()
    g = np.random.default_rng(4).normal(size=(SIZE * SIZE, 4)).astype(
        np.float32)
    out, gd = grad.render_train_vjp(tdev, torch.tensor(o), torch.tensor(d),
                                    opt, torch.tensor(g),
                                    data=tdev.data.float())
    jout, jgd = j_grad.render_train_vjp(
        jdev, jnp.asarray(o), jnp.asarray(d), jopt, jnp.asarray(g),
        data=jnp.asarray(jdev.data, jnp.float32))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    _assert_grads_close(gd.numpy(), np.asarray(jgd))


def test_active_check_cadence_changes_nothing(setup, monkeypatch):
    """The march asks the device whether a ray is still active every
    ACTIVE_CHECK_EVERY iterations: the extra iterations past the last
    active ray change no output and no gradient (bit for bit against
    asking every iteration), and the counters see the syncs drop."""
    _, tdev, o, d, target = setup
    opt, _ = _opts()
    runs = {}
    for k in (1, render_exact.ACTIVE_CHECK_EVERY):
        monkeypatch.setattr(render_exact, "ACTIVE_CHECK_EVERY", k)
        render_exact.reset_march_counts()
        loss, g = grad.l2_loss_and_grad(
            tdev, torch.tensor(o), torch.tensor(d), torch.tensor(target),
            opt, data=tdev.data.float())
        counts = dict(render_exact.march_counts)
        img = render_exact.render_rays(tdev, torch.tensor(o),
                                       torch.tensor(d), RenderOptions())
        runs[k] = (loss, g, img, counts)
    (l1, g1, i1, c1), (l8, g8, i8, c8) = runs.values()
    assert torch.equal(l1, l8) and torch.equal(g1, g8)
    assert torch.equal(i1, i8)
    assert c8["syncs"] < c1["syncs"]
    assert c8["fwd"] >= c1["fwd"] and c8["bwd"] >= c1["bwd"]
    assert c1["syncs"] == c1["fwd"] + c1["bwd"] + 2


def test_depth_mode_and_quantized_trees_raise(setup):
    """Training through depth mode raises NotImplementedError, as in the
    reference; a codebook-quantized tree is not trainable (ValueError)."""
    _, tdev, o, d, target = setup
    with pytest.raises(NotImplementedError, match="depth"):
        grad.render_rays_train(tdev, torch.tensor(o), torch.tensor(d),
                               RenderOptions(render_depth=True))

    class Quant:                       # stands in for QuantLeaves
        def fetch_rows(self, idx):
            raise AssertionError("never fetched")

    qtree = dataclasses.replace(tdev, data=Quant())
    with pytest.raises(ValueError, match="QuantLeaves"):
        grad.l2_loss_and_grad(qtree, torch.tensor(o), torch.tensor(d),
                              torch.tensor(target), RenderOptions())
