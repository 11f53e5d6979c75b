"""The leaf-sharded tree (``volrend_torch/parallel/leaf_shard.py``) against
the reference's (``volrend_tpu/parallel/leaf_shard.py``) on the CPU: the
port's ranks are one gloo world of four spawned processes
(tests/_torch_dist.py), the reference's devices the 8 virtual CPU devices
of tests/conftest.py.

Tolerances are the reference's tests' (tests/test_dist.py): the render
atol 2e-5, rtol 1e-5; the loss atol 1e-6, rtol 1e-5 and the gradient rows
atol 2e-5, rtol 1e-4; fetch_rows is a gather, exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_dist as td
from volrend_tpu.models.synthetic import make_test_tree
from volrend_tpu.ops import grad as j_grad
from volrend_tpu.ops import render_jax
from volrend_tpu.ops.camera import Camera as JCamera
from volrend_tpu.parallel import dist as j_dist
from volrend_tpu.parallel import leaf_shard as j_leaf
from volrend_tpu.utils.options import RenderOptions as JOpt

torch.set_num_threads(1)

CASES = (
    ("render1", 1, "leaf_render", {}),
    ("render2", 2, "leaf_render", {}),
    ("render4", 4, "leaf_render", {}),
    ("grads2", 2, "leaf_grads", {}),
    ("grads4", 4, "leaf_grads", {}),
    ("fetch4", 4, "leaf_fetch", {}),
)


@pytest.fixture(scope="module")
def ranks():
    return td.world(4, CASES)


@pytest.fixture(scope="module")
def setup():
    tree = make_test_tree(max_depth=3, basis_dim=4, seed=2)
    dev = tree.to_device(lut_depth=None)
    cam = JCamera.from_vectors(width=24, height=24, fx=30.0)
    origins, dirs = cam.pixel_rays(xp=np)
    return dev, origins, dirs, JOpt(max_steps=128)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_leaf_sharded_tree_matches(ranks, setup, n):
    """The leaf rows split over n ranks, every fetch an all-gather of the
    indices and a reduce-scatter of the answers: the render equals the
    reference's replicated render and its leaf-sharded render over as many
    devices; every rank marches the same iterations (the active check is
    taken together)."""
    dev, origins, dirs, opt = setup
    single = np.asarray(render_jax.render_rays(
        dev, jnp.asarray(origins), jnp.asarray(dirs), opt))
    mesh = j_dist.make_mesh(jax.devices()[:n])
    tree_s, rps = j_leaf.shard_tree_leaves(dev, mesh)
    o, d, nv = j_dist.shard_rays(origins, dirs, mesh)
    ref = np.asarray(j_leaf.render_rays_leaf_sharded(tree_s, o, d, opt,
                                                     mesh, rps))[:nv]
    outs = td.result(ranks, f"render{n}")
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["out"], single, atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(out["out"], ref, atol=2e-5, rtol=1e-5)
        assert out["rps"] == rps
        # this rank's block of the padded rows
        rows = np.asarray(tree_s.data, np.float32)[r * rps:(r + 1) * rps]
        np.testing.assert_array_equal(out["rows"], rows)
        assert out["counts"] == outs[0]["counts"]


@pytest.mark.parametrize("n", [2, 4])
def test_leaf_sharded_train_grads_match_single(ranks, setup, n):
    """Rows gathered for compute, the gradient reduce-scattered back (the
    ZeRO-3 pattern): the loss and each rank's gradient rows equal the
    single-device fused VJP's and the reference's leaf-sharded step's."""
    dev, origins, dirs, opt = setup
    target = np.full((origins.shape[0], 4), 0.4, np.float32)

    def loss_fn(dat):
        out = j_grad.render_rays_train(
            dev, jnp.asarray(origins), jnp.asarray(dirs), opt, data=dat)
        diff = out[:, :3] - jnp.asarray(target)[:, :3]
        return jnp.sum(diff * diff) / (3.0 * origins.shape[0])

    ref_loss, ref_g = jax.value_and_grad(loss_fn)(
        jnp.asarray(dev.data, jnp.float32))
    ref_g = np.asarray(ref_g)
    mesh = j_dist.make_mesh(jax.devices()[:n])
    tree_s, rps = j_leaf.shard_tree_leaves(dev, mesh)
    o, d, _ = j_dist.shard_rays(origins, dirs, mesh)
    tgt = j_dist.shard_rays(target, np.zeros_like(target[:, :3]), mesh)[0]
    jl, jg = j_leaf.loss_and_grad_leaf_sharded(
        tree_s, tree_s.data.astype(jnp.float32), o, d, tgt, opt, mesh)
    jg = np.asarray(jg)
    outs = td.result(ranks, f"grads{n}")
    g = np.concatenate([gr for _, gr in outs])
    assert g.shape == jg.shape
    for loss, _ in outs:
        np.testing.assert_allclose(loss, float(ref_loss), atol=1e-6,
                                   rtol=1e-5)
        np.testing.assert_allclose(loss, float(jl), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(g[:ref_g.shape[0]], ref_g, atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(g, jg, atol=2e-5, rtol=1e-4)


def test_sharded_leaves_fetch_rows_is_a_gather(ranks):
    """ShardedLeaves.fetch_rows: each rank's own (5, 7) indices answered
    from the rows the four ranks hold, equal to a dense gather."""
    for got, want in td.result(ranks, "fetch4"):
        assert got.shape == (5, 7, want.shape[-1])
        np.testing.assert_array_equal(got, want)
