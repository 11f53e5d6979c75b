"""The port's ray-parallel layer (``volrend_torch/parallel/dist.py`` and
``mesh.py``) against the reference's (``volrend_tpu/parallel/dist.py``) on
the CPU: the port's ranks are one gloo world of four spawned processes
(tests/_torch_dist.py), the reference's devices the 8 virtual CPU devices
of tests/conftest.py.

Tolerances are the reference's own tests' (tests/test_dist.py): renders
atol 2e-5, rtol 1e-5 (f32, another summation order); the sharded loss
rtol 1e-6 against the unsharded one in the same package, and the
cross-package gradient rtol 1e-5, atol 1e-7 as the reference holds its
sharded gradient; the context-parallel render atol 5e-3 with a mean
below 2e-4 against the unsharded one (segment boundaries split leaf
chords), and atol 2e-5 against the reference's own CP render."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

import _torch_dist as td
from volrend_tpu.models.synthetic import make_test_tree
from volrend_tpu.ops import grad as j_grad
from volrend_tpu.ops import render_jax
from volrend_tpu.ops.camera import Camera as JCamera
from volrend_tpu.parallel import dist as j_dist
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch.parallel import mesh as mesh_mod

torch.set_num_threads(1)

CASES = (
    ("render1", 1, "rays_render", {}),
    ("render2", 2, "rays_render", {}),
    ("render4", 4, "rays_render", {}),
    ("image", 4, "rays_image", {}),
    ("grads", 4, "rays_grads", {}),
    ("cp", 4, "rays_cp", {}),
    ("scenes", 4, "scenes", {}),
    ("scenes4", 4, "scenes", dict(seeds=(2, 7, 12, 3), errors=True)),
    ("layout", 4, "mesh_layout", {}),
    ("collectives", 4, "collectives", {}),
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


def _same_on_every_rank(outs):
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    return outs[0]


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_sharded_render_matches_single(ranks, setup, n_dev):
    """Ray-sharded render over 1, 2 and 4 ranks: the gathered batch equals
    the reference's sharded render over as many devices."""
    dev, origins, dirs, opt = setup
    mesh = j_dist.make_mesh(jax.devices()[:n_dev])
    o, d, n = j_dist.shard_rays(origins, dirs, mesh)
    want = np.asarray(j_dist.render_rays_sharded(
        j_dist.replicate_tree(dev, mesh), o, d, opt, mesh))[:n]
    got = _same_on_every_rank(td.result(ranks, f"render{n_dev}"))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_sharded_image_matches_reference(ranks, setup):
    dev, _, _, opt = setup
    cam = JCamera.from_vectors(center=tuple(2.5 * np.array([0.92, 0.2, 0.27])
                                            / np.linalg.norm([0.92, 0.2,
                                                              0.27])),
                               v_back=(0.92, 0.2, 0.27), width=24,
                               height=24, fx=30.0)
    mesh = j_dist.make_mesh(jax.devices()[:4])
    want = j_dist.render_image_sharded(dev, cam, opt, mesh)
    got = _same_on_every_rank(td.result(ranks, "image"))
    assert got.shape == (24, 24, 4)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_sharded_grads_match_single(ranks, setup):
    """Loss normalized by the global ray count, one all-reduce of (loss,
    grad): equal to the reference's single-device fused VJP and to its
    sharded step."""
    dev, origins, dirs, opt = setup
    data32 = jnp.asarray(dev.data, jnp.float32)
    target = np.full((origins.shape[0], 4), 0.4, np.float32)

    def loss_fn(dat):
        out = j_grad.render_rays_train(
            dev, jnp.asarray(origins), jnp.asarray(dirs), opt, data=dat)
        diff = out[:, :3] - jnp.asarray(target)[:, :3]
        return jnp.sum(diff * diff) / (3.0 * origins.shape[0])

    loss_ref, grad_ref = jax.value_and_grad(loss_fn)(data32)
    outs = td.result(ranks, "grads")
    for loss, g in outs:
        assert np.isclose(loss, float(loss_ref), rtol=1e-6)
        np.testing.assert_allclose(g, np.asarray(grad_ref), rtol=1e-5,
                                   atol=1e-7)
    np.testing.assert_array_equal(outs[0][1], outs[-1][1])


def test_context_parallel_segments_match(ranks, setup):
    """CP mode (the t-range split over 4 ranks, associative fold) against
    the reference's CP render and the unsharded render with the training
    semantics."""
    dev, origins, dirs, opt = setup
    opt_t = opt.replace(stop_thresh=0.0, renormalize=False)
    single = np.asarray(render_jax.render_rays(
        dev, jnp.asarray(origins), jnp.asarray(dirs), opt_t))
    mesh = j_dist.make_mesh(jax.devices()[:4], axis_name="cp")
    want = np.asarray(j_dist.render_rays_cp(
        j_dist.replicate_tree(dev, mesh), jnp.asarray(origins),
        jnp.asarray(dirs), opt, mesh, axis_name="cp"))
    got = _same_on_every_rank(td.result(ranks, "cp"))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got, single, atol=5e-3)
    assert np.mean(np.abs(got - single)) < 2e-4


def _scene_refs(seeds):
    trees = [make_test_tree(max_depth=3, basis_dim=4, seed=s,
                            sigma_scale=50.0).to_device(lut_depth=None)
             for s in seeds]
    opt = JOpt(max_steps=128)
    cam = JCamera.from_vectors(width=16, height=16, fx=20.0)
    o, d = cam.pixel_rays(xp=np)
    refs = [np.asarray(render_jax.render_rays(t, jnp.asarray(o),
                                              jnp.asarray(d), opt))
            for t in trees]
    mesh = JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                 ("scene", "rays"))
    S = len(seeds)
    sharded = np.asarray(j_dist.render_scenes_sharded(
        j_dist.stack_trees(trees), jnp.asarray(np.stack([o] * S)),
        jnp.asarray(np.stack([d] * S)), opt, mesh))
    return refs, sharded


def test_multi_scene_sharded(ranks):
    """Two scenes on a 2 x 2 ("scene", "rays") mesh against the reference's
    per-scene renders and its 2 x 4 scene-sharded render."""
    refs, sharded = _scene_refs((2, 7))
    got = _same_on_every_rank([r["frames"] for r in td.result(ranks,
                                                              "scenes")])
    for s in range(2):
        np.testing.assert_allclose(got[s], refs[s], atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got, sharded, atol=2e-5, rtol=1e-5)


def test_multi_scene_sharded_multiple_per_group(ranks):
    """Four scenes on the 2-group axis (each group renders two), and bad
    shapes fail with the reference's messages."""
    refs, _ = _scene_refs((2, 7, 12, 3))
    out = td.result(ranks, "scenes4")[0]
    for s in range(4):
        np.testing.assert_allclose(out["frames"][s], refs[s], atol=2e-5,
                                   rtol=1e-5)
    assert "scenes do not tile" in out["tile"]
    assert "ray batches" in out["batches"]


def test_mesh_layout(ranks):
    """The 2 x 2 mesh is row-major over the ranks; each axis's group holds
    the ranks of this rank's line."""
    outs = td.result(ranks, "layout")
    for r, o in enumerate(outs):
        assert o["coord"] == (r // 2, r % 2)
        assert o["size"] == (2, 2, 4)
        assert o["rays"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert o["scene"] == [r % 2, r % 2 + 2]


def test_gloo_collectives(ranks):
    """On gloo: the all-gather stacks every rank's tensor in rank order,
    the reduce-scatter hands each rank its block of the sum, any_true is
    every rank's answer together; each call counted under its backend."""
    outs = td.result(ranks, "collectives")
    n = len(outs)
    base = np.arange(3, dtype=np.float32)
    rows = np.arange(2 * n, dtype=np.float32)[:, None] * sum(
        range(1, n + 1))
    for r, o in enumerate(outs):
        assert o["backend"] == "gloo"
        np.testing.assert_array_equal(
            o["gathered"], np.stack([base + 10 * k for k in range(n)]))
        np.testing.assert_array_equal(o["reduced"],
                                      n * base + 10 * sum(range(n)))
        np.testing.assert_array_equal(o["scattered"], rows[2 * r:2 * r + 2])
        assert o["any"] == (True, False)
        assert o["counts"] == {"gloo:all_gather": 1, "gloo:all_reduce": 3,
                               "gloo:reduce_scatter": 1}


class _FakeGroup:
    pass


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_collectives_pick_the_call_of_the_backend(monkeypatch, backend):
    """Each collective calls the form chosen for its group's backend:
    NCCL's single-tensor all_gather_into_tensor and reduce_scatter_tensor,
    gloo's list all_gather and reduce_scatter; a one-rank axis (no group)
    calls nothing."""
    import torch.distributed as tdist
    calls = []
    monkeypatch.setattr(tdist, "get_backend", lambda g: backend)
    monkeypatch.setattr(tdist, "get_world_size", lambda g=None: 2)
    monkeypatch.setattr(tdist, "get_rank", lambda g=None: 1)

    def agit(out, t, group=None):
        calls.append("all_gather_into_tensor")
        out.copy_(torch.stack([t, t + 1]))

    def ag(parts, t, group=None):
        calls.append("all_gather")
        parts[0].copy_(t)
        parts[1].copy_(t + 1)

    def rst(out, t, group=None):
        calls.append("reduce_scatter_tensor")
        out.copy_(2 * t[out.shape[0]:])

    def rs(out, parts, group=None):
        calls.append("reduce_scatter")
        out.copy_(2 * parts[1])

    def ar(t, op=None, group=None):
        calls.append("all_reduce")
        t.mul_(2)

    monkeypatch.setattr(tdist, "all_gather_into_tensor", agit)
    monkeypatch.setattr(tdist, "all_gather", ag)
    monkeypatch.setattr(tdist, "reduce_scatter_tensor", rst)
    monkeypatch.setattr(tdist, "reduce_scatter", rs)
    monkeypatch.setattr(tdist, "all_reduce", ar)
    g = _FakeGroup()
    t = torch.arange(3, dtype=torch.float32)
    np.testing.assert_array_equal(mesh_mod.all_gather(t, g).numpy(),
                                  np.stack([np.arange(3), np.arange(3) + 1]))
    rows = torch.arange(4, dtype=torch.float32)
    np.testing.assert_array_equal(mesh_mod.reduce_scatter(rows, g).numpy(),
                                  [4.0, 6.0])
    np.testing.assert_array_equal(mesh_mod.all_reduce(t.clone(), g).numpy(),
                                  2 * np.arange(3))
    want = {"nccl": ["all_gather_into_tensor", "reduce_scatter_tensor",
                     "all_reduce"],
            "gloo": ["all_gather", "reduce_scatter", "all_reduce"]}[backend]
    assert calls == want
    calls.clear()
    assert mesh_mod.all_gather(t, None).shape == (1, 3)
    assert mesh_mod.reduce_scatter(rows, None) is rows
    assert calls == []


def test_one_rank_mesh_needs_no_process_group():
    """Without a process group the mesh is this rank alone on the named
    device; its collectives return their input; the card is the default
    and a missing card raises (no drift to the CPU)."""
    import torch.distributed as tdist
    assert not tdist.is_initialized()
    mesh = mesh_mod.make_mesh("z", device="cpu")
    assert (mesh.size("z"), mesh.get_local_rank("z"),
            mesh.get_group("z")) == (1, 0, None)
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="no axis"):
        mesh.size("rays")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.make_mesh("z")


def test_dryrun_multichip():
    """The port's dry run over two spawned gloo ranks on the CPU: the
    ray-sharded step, the leaf-sharded render and step, a pose-sharded
    frame step, a z-sharded render, and a z-sharded training step equal to
    the unsharded one (loss 1e-5 relative; parameters atol 2e-4, rtol
    1e-4)."""
    from volrend_torch.parallel import dryrun
    res = dryrun.dryrun_multichip(2, "cpu", timeout_s=240)
    assert all(np.isfinite(v) for v in res.values()), res


@pytest.mark.parametrize("n", [3, 8])
def test_dryrun_refuses_ranks_it_cannot_check(n):
    """A rank count that does not split the dry run's grid into whole
    K-slab windows raises before any rank starts (no check is skipped)."""
    from volrend_torch.parallel import dryrun
    with pytest.raises(ValueError, match="whole 4-slab windows"):
        dryrun.dryrun_multichip(n, "cpu")
