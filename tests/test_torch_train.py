"""The port's trainer (``volrend_torch/train.py``) against the reference's
(``volrend_tpu/train.py``) on the CPU: the optimizers against optax and the
reference's ``lean_adam`` on seeded gradients, five ``FrameTrainer`` steps
on the same seeded scene and target (G=8, 24^2 frames), and a checkpoint
written by the reference's trainer restored into the port's.

The reference's CPU trainer marches its scan path in f32. The port's scan
backend does the same (tolerances at f32 rounding); its default kernel
path marches the payload rounded to bf16 at the kernel boundary, as the
reference's Pallas path does, so its losses are held to 2e-2 relative."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from volrend_tpu.models import synthetic as j_synth
from volrend_tpu.ops import slab_grad as j_sg
from volrend_tpu import train as j_train
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch import train
from volrend_torch.models import synthetic as t_synth
from volrend_torch.ops import slab_grad
from volrend_torch.utils.options import RenderOptions

from _torch_scenes import make_cam

torch.set_num_threads(1)

W = H = 24
GI = 32
LR = 5e-2
STEPS = 5
OPT = RenderOptions(max_steps=512)
KW = dict(max_depth=2, basis_dim=4, seed=5, sigma_scale=60.0)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

def _grads(rng, shapes, n):
    return [[rng.normal(size=s).astype(np.float32) for s in shapes]
            for _ in range(n)]


@pytest.mark.parametrize("lean", [False, True])
def test_adam_matches_reference(lean):
    """Three updates of two parameter tensors on seeded gradients: the port's
    ``adam`` against ``optax.adam`` and its ``lean_adam`` against the
    reference's, parameters to rtol 1e-6 (f32 arithmetic in another order);
    the bf16 moments to one bf16 rounding (2^-8)."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    gs = _grads(rng, shapes, 3)
    jopt = j_train.lean_adam(LR) if lean else optax.adam(LR)
    jp = tuple(jnp.asarray(p) for p in p0)
    js = jopt.init(jp)
    for g in gs:
        upd, js = jopt.update(tuple(jnp.asarray(x) for x in g), js, jp)
        jp = optax.apply_updates(jp, upd)
    topt = train.lean_adam(LR) if lean else train.adam(LR)
    tp = [torch.tensor(p) for p in p0]
    ts = topt.init(tp)
    for g in gs:
        topt.step(tp, [torch.tensor(x) for x in g], ts)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    leaves = jax.tree_util.tree_flatten(js)[0]
    mine = topt.leaves(ts)
    assert len(mine) == len(leaves)
    for a, b in zip(mine, leaves):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), b,
                                   rtol=2 ** -8 if lean else 1e-6)


def test_psnr_matches_reference():
    rng = np.random.default_rng(1)
    a, b = rng.uniform(size=(2, 8, 8, 3))
    assert np.isclose(train.psnr(torch.tensor(a), b), j_train.psnr(a, b))
    assert train.psnr(a, a) == float("inf")


# ---------------------------------------------------------------------------
# FrameTrainer
# ---------------------------------------------------------------------------

def _noisy_rows(jdev):
    rng = np.random.default_rng(1)
    rows = np.asarray(jdev.data, np.float32)
    return (rows + rng.normal(0, 0.3, rows.shape).astype(np.float32)
            ).astype(np.float16)


@pytest.fixture(scope="module")
def setting():
    """The noisy scene in both packages, one pose, a seeded target."""
    jdev = j_synth.make_test_tree(**KW).to_device(lut_depth=None)
    tdev = t_synth.make_test_tree(**KW).to_device(lut_depth=None,
                                                  device="cpu")
    rows = _noisy_rows(jdev)
    jdev = dataclasses.replace(jdev, data=jnp.asarray(rows))
    tdev = dataclasses.replace(tdev, data=torch.tensor(rows))
    cam = make_cam((1.0, 0.2, 0.3), width=W, height=H, fx=30.0)
    tgt = np.random.default_rng(2).uniform(0, 1, (H, W, 4)).astype(
        np.float32)
    return jdev, tdev, cam, tgt


@pytest.fixture(scope="module", params=[False, True], ids=["adam", "lean"])
def reference_run(setting, request, tmp_path_factory):
    """The reference's FrameTrainer: 2 steps, a checkpoint, 3 more steps;
    its losses and the pyramid after step 3."""
    lean = request.param
    jdev, _, cam, tgt = setting
    tr = j_train.FrameTrainer(jdev, JOpt(max_steps=512), lr=LR, gi=GI,
                              lean=lean)
    try:
        losses = [tr.step_frame(cam, tgt) for _ in range(2)]
        ckpt = str(tmp_path_factory.mktemp("ckpt") / "ref.npz")
        tr.save_checkpoint(ckpt)
        losses.append(tr.step_frame(cam, tgt))
        pyr3 = [np.asarray(p) for p in tr.pyramid]
        losses += [tr.step_frame(cam, tgt) for _ in range(STEPS - 3)]
    finally:
        # the reference's lean switch is process-global: put it back
        j_sg._GRAD_BF16 = False
        jax.clear_caches()
    return lean, np.asarray(losses), ckpt, pyr3


def _use_scan(monkeypatch):
    """Select the scan march (f32, like the reference's CPU path) where
    "auto" would take the kernels."""
    monkeypatch.setattr(slab_grad, "_kernel_train_ok", lambda cfg: False)


@pytest.mark.parametrize("backend,rtol", [("scan", 1e-4), ("kernel", 2e-2)])
def test_frame_trainer_trajectory_matches_reference(setting, reference_run,
                                                    backend, rtol,
                                                    monkeypatch):
    """Five step_frame losses of the port's trainer (default and lean)
    against the reference's: rtol 1e-4 on the f32 scan path, 2e-2 on the
    kernel path (bf16 payload at the kernel boundary; lean also rounds the
    cotangent to bf16)."""
    _, tdev, cam, tgt = setting
    lean, ref_losses, _, _ = reference_run
    if backend == "scan":
        _use_scan(monkeypatch)
    tr = train.FrameTrainer(tdev, OPT, lr=LR, gi=GI, lean=lean)
    assert tr.optimizer.lean == lean
    losses = np.asarray([tr.step_frame(cam, tgt) for _ in range(STEPS)])
    np.testing.assert_allclose(losses, ref_losses, rtol=rtol)
    assert losses[-1] < losses[0]
    assert tr.step_count == STEPS


def test_checkpoint_from_reference_restores_into_port(setting,
                                                      reference_run,
                                                      monkeypatch):
    """The reference trainer's checkpoint after 2 steps, restored into the
    port's trainer (scan march, f32 like the reference's CPU path); both
    take step 3: the losses agree to rtol 1e-5 and the pyramids to relative
    L2 1e-5."""
    _, tdev, cam, tgt = setting
    lean, ref_losses, ckpt, pyr3 = reference_run
    _use_scan(monkeypatch)
    tr = train.FrameTrainer(tdev, OPT, lr=LR, gi=GI, lean=lean)
    tr.restore_checkpoint(ckpt)
    assert tr.step_count == 2
    assert int(tr.opt_state["count"]) == 2
    loss = tr.step_frame(cam, tgt)
    assert np.isclose(loss, ref_losses[2], rtol=1e-5)
    mine = np.concatenate([p.detach().numpy().ravel() for p in tr.pyramid])
    ref = np.concatenate([p.ravel() for p in pyr3])
    assert _rel(mine, ref) < 1e-5


def test_checkpoint_round_trip_and_export(setting, tmp_path):
    """The port's own checkpoint restores bit-exactly (parameters and
    Adam state), and export_npz writes the leaf rows the trainer holds."""
    from volrend_torch.models.n3tree import N3Tree
    _, tdev, cam, tgt = setting
    tr = train.FrameTrainer(tdev, OPT, lr=LR, gi=GI)
    tr.step_frame(cam, tgt)
    tr.save_checkpoint(str(tmp_path / "a.npz"))
    tr2 = train.FrameTrainer(tdev, OPT, lr=LR, gi=GI)
    tr2.restore_checkpoint(str(tmp_path / "a.npz"))
    for a, b in zip(tr.pyramid, tr2.pyramid):
        assert torch.equal(a, b)
    for a, b in zip(tr.optimizer.leaves(tr.opt_state),
                    tr2.optimizer.leaves(tr2.opt_state)):
        assert torch.equal(a, b)
    assert tr2.step_count == 1
    host = t_synth.make_test_tree(**KW)
    tr.export_npz(host, str(tmp_path / "scene.npz"))
    back = N3Tree(str(tmp_path / "scene.npz"))
    D = host.data_dim
    np.testing.assert_array_equal(
        back.data.reshape(-1, D),
        tr.data.numpy().astype(np.float16)[:, :D])
    assert tr.current_tree().data.dtype == torch.float16


def test_lean_trainer_keeps_grid_metadata_only(setting):
    """The lean trainer drops the grid's payload and sigma plane (the
    reference leaves zero-length arrays there) and still trains; sync=False
    returns the loss as a tensor without a host sync."""
    _, tdev, cam, tgt = setting
    tr = train.FrameTrainer(tdev, OPT, lr=LR, gi=GI, lean=True)
    assert tr.grid.data.numel() == 0 and tr.grid.sigma_grid is None
    assert tr.opt_state["mu"][0].dtype == torch.bfloat16
    loss = tr.step_frame(cam, tgt, sync=False)
    assert isinstance(loss, torch.Tensor) and np.isfinite(float(loss))


@pytest.mark.parametrize("method", ["step", "step_sharded",
                                    "step_frame_zsharded",
                                    "step_frames_sharded"])
def test_later_slices_raise(setting, method):
    """FrameTrainer refuses ray batches with the reference's TypeError
    (``step``, ``step_sharded``: ray-batch training is ``Trainer.step``).
    The sharded frame steps that slice D brought run: on a one-rank mesh
    (no process group) each equals the unsharded step — the z-sharded one
    step_frame under the segment semantics (stop_thresh 0), the
    pose-sharded one step_frame on its one pose (the multi-rank cases are
    tests/test_torch_zshard.py's)."""
    from volrend_torch.parallel import mesh as mesh_mod
    _, tdev, cam, tgt = setting
    if method in ("step", "step_sharded"):
        tr = train.FrameTrainer(tdev, OPT, lr=LR, gi=GI)
        with pytest.raises(TypeError, match="use Trainer for ray-batch"):
            getattr(tr, method)()
        return
    opt = OPT.replace(stop_thresh=0.0) if method == "step_frame_zsharded" \
        else OPT
    tr = train.FrameTrainer(tdev, opt, lr=LR, gi=GI)
    tu = train.FrameTrainer(tdev, opt, lr=LR, gi=GI)
    if method == "step_frame_zsharded":
        loss = tr.step_frame_zsharded(mesh_mod.make_mesh("z", device="cpu"),
                                      cam, tgt)
    else:
        loss = tr.step_frames_sharded(
            mesh_mod.make_mesh("frames", device="cpu"), [cam], [tgt])
    want = tu.step_frame(cam, tgt)
    assert abs(loss - want) <= 1e-5 * max(1.0, abs(want))
    for a, b in zip(tr.pyramid, tu.pyramid):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=2e-4, rtol=1e-4)
