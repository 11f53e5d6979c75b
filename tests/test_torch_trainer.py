"""The port's ray-batch ``Trainer`` (``volrend_torch/train.py``) against the
reference's (``volrend_tpu/train.py``) on the CPU, on tests/test_train.py's
problem (depth-3 SH4 tree, four 40^2 poses, 512-ray batches).

Tolerances: losses rtol 1e-5 (f32 in another summation order); the leaf
rows after five Adam steps within 1e-4, 2e-3 of an lr-sized step. Adam's
step is normalized, so a gradient of rounding-noise size could flip the
sign of an lr-sized update; the check covers every leaf row, and holds
because on this problem no coordinate's gradient sits at the noise level
(the largest difference is ~5e-5)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from volrend_tpu import train as j_train
from volrend_tpu.models import synthetic as j_synth
from volrend_tpu.ops import render_jax
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch import train
from volrend_torch.models import synthetic as t_synth
from volrend_torch.models.n3tree import N3Tree
from volrend_torch.ops import render_exact
from volrend_torch.ops.camera import Camera
from volrend_torch.utils.options import RenderOptions

torch.set_num_threads(1)

KW = dict(max_depth=3, basis_dim=4, seed=11, sigma_scale=50.0)
LR = 5e-2
STEPS = 5
BATCH = 512
PARAM_ATOL = 1e-4


@pytest.fixture(scope="module")
def problem():
    """Both packages' trees, the poses' rays and the reference's targets."""
    jdev = j_synth.make_test_tree(**KW).to_device(lut_depth=None)
    tdev = t_synth.make_test_tree(**KW).to_device(lut_depth=None,
                                                  device="cpu")
    jopt = JOpt(max_steps=256, renormalize=False)
    opt = RenderOptions(max_steps=256, renormalize=False)
    cams = []
    for th in (0.3, 1.5, 2.8, 4.2):
        back = np.array([np.cos(th), np.sin(th), 0.4])
        back /= np.linalg.norm(back)
        cams.append(Camera.from_vectors(
            center=tuple(2.5 * back), v_back=tuple(back),
            width=40, height=40, fx=48.0))
    rays = [tuple(np.ascontiguousarray(x) for x in c.pixel_rays(xp=np))
            for c in cams]
    targets = [np.asarray(render_jax.render_rays(
        jdev, jnp.asarray(o), jnp.asarray(d), jopt)) for o, d in rays]
    return jdev, tdev, jopt, opt, rays, targets


def _noisy_rows(jdev, scale=0.35, seed=3):
    """tests/test_train.py's corruption: Gaussian noise, then f16."""
    rng = np.random.default_rng(seed)
    rows = np.asarray(jdev.data, np.float32)
    return (rows + rng.normal(0, scale, rows.shape).astype(np.float32)
            ).astype(np.float16)


def _trainers(problem, lr=LR):
    jdev, tdev, jopt, opt, _, _ = problem
    rows = _noisy_rows(jdev)
    jt = j_train.Trainer(dataclasses.replace(jdev, data=jnp.asarray(rows)),
                         jopt, lr=lr)
    tt = train.Trainer(dataclasses.replace(tdev, data=torch.tensor(rows)),
                       opt, lr=lr)
    return jt, tt


def _batches(problem, n, seed=0):
    _, _, _, _, rays, targets = problem
    rng = np.random.default_rng(seed)
    out = []
    for it in range(n):
        k = it % len(rays)
        sel = rng.integers(0, rays[k][0].shape[0], BATCH)
        out.append((rays[k][0][sel], rays[k][1][sel], targets[k][sel]))
    return out


def test_trajectory_matches_reference(problem):
    """Five Trainer.step calls from the same corrupted leaves on the same
    batches: every loss to rtol 1e-5 and every leaf row to PARAM_ATOL after
    each step; the Adam state's count and moments match optax's."""
    jt, tt = _trainers(problem)
    for o, d, t in _batches(problem, STEPS):
        a = jt.step(o, d, t)
        b = tt.step(o, d, t)
        np.testing.assert_allclose(b, a, rtol=1e-5)
        np.testing.assert_allclose(tt.data.numpy(), np.asarray(jt.data),
                                   atol=PARAM_ATOL, rtol=0)
    assert tt.step_count == jt.step_count == STEPS
    assert int(tt.opt_state["count"]) == STEPS
    import jax
    leaves = jax.tree_util.tree_flatten(jt.opt_state)[0]
    mine = tt.optimizer.leaves(tt.opt_state)
    assert len(mine) == len(leaves) == 3
    np.testing.assert_allclose(mine[1].numpy(), np.asarray(leaves[1]),
                               atol=1e-6)


def test_training_recovers(problem):
    """tests/test_train.py's recovery gate: 60 steps from the corrupted
    leaves bring the total loss over the four poses below 0.35 of its
    start."""
    _, tdev, _, opt, rays, targets = problem
    tt = train.Trainer(dataclasses.replace(
        tdev, data=torch.tensor(_noisy_rows(problem[0]))), opt, lr=LR)

    def total_loss():
        return sum(float(torch.mean((render_exact.render_rays(
            tt.current_tree(), o, d, opt)[:, :3]
            - torch.tensor(t[:, :3])) ** 2))
            for (o, d), t in zip(rays, targets))

    loss0 = total_loss()
    for o, d, t in _batches(problem, 60):
        tt.step(o, d, t)
    loss1 = total_loss()
    assert loss1 < loss0 * 0.35, (loss0, loss1)


def test_checkpoint_round_trip(problem, tmp_path):
    """The port's checkpoint restores into a fresh trainer bit for bit, and
    the next step is equal."""
    batches = _batches(problem, 4)
    _, a = _trainers(problem, lr=1e-2)
    for b in batches[:3]:
        a.step(*b)
    p = str(tmp_path / "ckpt.npz")
    a.save_checkpoint(p)
    _, b_ = _trainers(problem, lr=1e-2)
    b_.restore_checkpoint(p)
    assert b_.step_count == 3 and int(b_.opt_state["count"]) == 3
    assert torch.equal(a.data, b_.data)
    for x, y in zip(a.optimizer.leaves(a.opt_state),
                    b_.optimizer.leaves(b_.opt_state)):
        assert torch.equal(x, y)
    assert a.step(*batches[3]) == b_.step(*batches[3])
    assert torch.equal(a.data, b_.data)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_checkpoint_crosses_packages(problem, tmp_path, direction):
    """A checkpoint written by either package's Trainer after three steps
    restores into the other's; the next step's loss agrees to rtol 1e-5
    and the leaf rows to PARAM_ATOL."""
    batches = _batches(problem, 4)
    jt, tt = _trainers(problem, lr=1e-2)
    src, dst = (jt, tt) if direction == "reference_to_port" else (tt, jt)
    for b in batches[:3]:
        src.step(*b)
    p = str(tmp_path / "ckpt.npz")
    src.save_checkpoint(p)
    dst.restore_checkpoint(p)
    assert dst.step_count == 3
    a, b = src.step(*batches[3]), dst.step(*batches[3])
    np.testing.assert_allclose(b, a, rtol=1e-5)
    mine = tt.data.numpy()
    np.testing.assert_allclose(mine, np.asarray(jt.data), atol=PARAM_ATOL,
                               rtol=0)


def test_export_npz_and_current_tree(problem, tmp_path):
    """export_npz writes the trainer's leaf rows as a reference-compatible
    scene the reference reads back; current_tree is f16."""
    from volrend_tpu.models.n3tree import N3Tree as JTree
    _, tt = _trainers(problem)
    tt.step(*_batches(problem, 1)[0])
    host = t_synth.make_test_tree(**KW)
    path = str(tmp_path / "scene.npz")
    tt.export_npz(host, path)
    D = host.data_dim
    want = tt.data.numpy().astype(np.float16)[:, :D]
    for back in (N3Tree(path), JTree(path)):
        np.testing.assert_array_equal(back.data.reshape(-1, D), want)
    assert tt.current_tree().data.dtype == torch.float16


def test_trainer_keeps_its_own_master_copy(problem):
    """The f32 master copy is the trainer's own: a tree whose leaves are
    already f32 is not updated in place."""
    _, tdev, _, opt, _, _ = problem
    t32 = dataclasses.replace(tdev, data=tdev.data.float())
    before = t32.data.clone()
    tt = train.Trainer(t32, opt, lr=LR)
    tt.step(*_batches(problem, 1)[0])
    assert torch.equal(t32.data, before)
    assert not torch.equal(tt.data, before)


@pytest.mark.parametrize("method", ["shard_batch", "step_sharded"])
def test_sharded_steps_raise(problem, method):
    """Ray-batch sharding comes with slice D (ROADMAP item 19)."""
    _, tt = _trainers(problem)
    with pytest.raises(NotImplementedError, match="item 19"):
        getattr(tt, method)(None, None, None, None)


def test_quantized_tree_is_not_trainable(problem, tmp_path):
    """As in the reference (its trainer densifies tree.data), a
    codebook-quantized tree raises ValueError."""
    from volrend_torch import compress
    from volrend_torch.models import quantized
    _, _, _, opt, _, _ = problem
    path = str(tmp_path / "tree.npz")
    t_synth.make_test_tree(**KW).save_npz(path)
    with np.load(path) as f:
        zq = compress.compress_tree(dict(f.items()), bits=6)
    np.savez_compressed(str(tmp_path / "tree_q.npz"), **zq)
    qtree = quantized.load_quantized(str(tmp_path / "tree_q.npz"))
    qdev = quantized.to_device_quantized(qtree, lut_depth=None,
                                         device="cpu")
    assert isinstance(qdev.data, quantized.QuantLeaves)
    with pytest.raises(ValueError, match="QuantLeaves"):
        train.Trainer(qdev, opt)


def test_frame_trainer_is_a_trainer(problem):
    """FrameTrainer subclasses Trainer, as in the reference: it refuses ray
    batches with the reference's TypeError, and a pose the slab path
    cannot take (a camera inside the volume) with a ValueError that sends
    it to Trainer.step."""
    _, tdev, _, opt, _, _ = problem
    assert issubclass(train.FrameTrainer, train.Trainer)
    ft = train.FrameTrainer(tdev, opt, lr=LR, gi=32)
    for method in (ft.step, ft.step_sharded):
        with pytest.raises(TypeError, match="use Trainer for ray-batch"):
            method(None, None, None)
    inside = Camera.from_vectors(center=(0.0, 0.0, 0.0), width=16,
                                 height=16, fx=8.0)
    with pytest.raises(ValueError, match="use Trainer.step"):
        ft._group(inside)
