"""A multi-rank dry run of the parallel layer: ``dryrun_multichip(n,
device)`` starts n ranks (gloo; on the card every rank shares it) and
checks on a tiny scene what the reference's dry run
(``__graft_entry__.dryrun_multichip``) checks:

- a ray-sharded loss and gradient (``dist.loss_and_grad_sharded``) and the
  sharded forward render, against one rank's unsharded ones;
- the leaf-sharded render and training step against them;
- a pose-sharded frame step (``FrameTrainer.step_frames_sharded``);
- a z-sharded slab render (``dist.render_frame_slab_zsharded``);
- a z-sharded training step (``FrameTrainer.step_frame_zsharded``) whose
  loss (within 1e-5 relative) and parameters (atol 2e-4, rtol 1e-4) equal
  the unsharded step's.

Every check runs: n must split the tiny scene's grid into segments of
whole K-slab shading windows (``ValueError`` otherwise). The ranks run on
the card unless the caller names the CPU (``utils.device.resolve``). Run
it as ``python -m volrend_torch.parallel.dryrun N [cpu|cuda]``."""

from __future__ import annotations

import sys

import numpy as np
import torch

from volrend_torch.utils.device import DeviceLike, resolve

__all__ = ["dryrun_multichip"]


#: the tiny scene's tree depth (its grid has 2 ** (DEPTH + 1) slabs)
DEPTH = 3


def _tiny_setup(device, max_depth=DEPTH, basis_dim=9, n_rays=256):
    from volrend_torch.models.synthetic import make_test_tree
    from volrend_torch.ops.camera import Camera
    from volrend_torch.utils.options import RenderOptions
    dev = make_test_tree(max_depth=max_depth, basis_dim=basis_dim
                         ).to_device(lut_depth=None, device=device)
    cam = Camera.from_vectors(width=64, height=64, fx=80.0)
    origins, dirs = cam.pixel_rays(xp=np)
    # centre rays (these meet the volume)
    mid = origins.shape[0] // 2 - n_rays // 2
    opt = RenderOptions(max_steps=64)
    return (dev, np.ascontiguousarray(origins[mid:mid + n_rays]),
            np.ascontiguousarray(dirs[mid:mid + n_rays]), opt)


def _close(a, b, atol, rtol, what):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else b
    np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=what)


def _rank(rank: int, n: int, device: str) -> dict:
    from volrend_torch import train
    from volrend_torch.ops import grad as grad_mod
    from volrend_torch.ops import render_exact
    from volrend_torch.ops.camera import Camera
    from volrend_torch.parallel import dist, leaf_shard
    mesh = dist.make_mesh("rays", device=device)
    dev, origins, dirs, opt = _tiny_setup(mesh.device, n_rays=32 * n)
    tree = dist.replicate_tree(dev, mesh)
    o, d, _ = dist.shard_rays(origins, dirs, mesh)
    target_all = np.full((origins.shape[0], 4), 0.5, np.float32)
    t, _, _ = dist.shard_rays(target_all, np.zeros_like(origins), mesh)
    data32 = tree.data.to(torch.float32)

    loss, grad = dist.loss_and_grad_sharded(tree, data32, o, d, t, opt, mesh)
    assert np.isfinite(float(loss)), "non-finite loss in dry run"
    assert grad.shape == data32.shape
    uloss, ugrad = grad_mod.l2_loss_and_grad(tree, origins, dirs, target_all,
                                             opt, data=data32)
    _close(loss, uloss, 0, 1e-5, "ray-sharded loss != unsharded")
    _close(grad, ugrad, 1e-7, 1e-5, "ray-sharded grad != unsharded")
    out = dist.render_rays_sharded(tree, o, d, opt, mesh)
    _close(out, render_exact.render_rays(tree, origins, dirs, opt), 2e-5,
           1e-5, "ray-sharded render != unsharded")

    # tensor parallelism: the leaf rows split over the ranks
    tree_s, rps = leaf_shard.shard_tree_leaves(dev, mesh)
    tp_out = leaf_shard.render_rays_leaf_sharded(tree_s, o, d, opt, mesh,
                                                 rps)
    _close(tp_out, out, 2e-5, 1e-5, "leaf-sharded render != DP")
    tp_loss, tp_grad = leaf_shard.loss_and_grad_leaf_sharded(
        tree_s, tree_s.data.to(torch.float32), o, d, t, opt, mesh)
    assert np.isfinite(float(tp_loss)), "non-finite leaf-shard loss"
    lo = rank * rps
    hi = min(lo + rps, grad.shape[0])
    _close(tp_grad[:max(hi - lo, 0)], grad[lo:hi], 2e-5, 1e-4,
           "leaf-shard grad != DP grad")

    # whole frames sharded over the ranks, one all-reduce a step
    fmesh = dist.make_mesh("frames", device=device)
    tr = train.FrameTrainer(dev, opt=opt, lr=1e-2, gi=32)
    cams, targets = [], []
    for i in range(n):
        # every pose in one (perm, flip) group
        th = 0.3 + 0.4 * i / max(n, 1)
        back = np.array([np.cos(th), np.sin(th), 0.4])
        back /= np.linalg.norm(back)
        cams.append(Camera.from_vectors(
            center=tuple(2.5 * back), v_back=tuple(back), width=24,
            height=24, fx=30.0))
        targets.append(np.full((24, 24, 4), 0.5, np.float32))
    floss = tr.step_frames_sharded(fmesh, cams,
                                   tr.place_frames(cams, targets))
    assert np.isfinite(floss), "non-finite frame-step loss in dry run"

    # the slab path's z-segments: a render and a training step
    zmesh = dist.make_mesh("z", device=device)
    zout = dist.render_frame_slab_zsharded(
        tr.grid, cams[0].transform, cams[0].fx, cams[0].fy, 24, 24, opt,
        zmesh, gi=32)
    assert bool(torch.isfinite(zout).all()), "non-finite z-sharded frame"
    opt0 = opt.replace(stop_thresh=0.0, renormalize=False)
    tr_z = train.FrameTrainer(dev, opt=opt0, lr=1e-2, gi=32)
    tr_u = train.FrameTrainer(dev, opt=opt0, lr=1e-2, gi=32)
    zloss = tr_z.step_frame_zsharded(zmesh, cams[0], targets[0])
    uloss = tr_u.step_frame(cams[0], targets[0])
    assert np.isfinite(zloss), "non-finite z-sharded train loss"
    assert abs(zloss - uloss) <= 1e-5 * max(1.0, abs(uloss)), (
        f"z-sharded loss {zloss} != unsharded {uloss}")
    for pz, pu in zip(tr_z.pyramid, tr_u.pyramid):
        _close(pz, pu, 2e-4, 1e-4, "z-sharded step diverged from unsharded")
    return dict(loss=float(loss), grad_norm=float(torch.linalg.norm(grad)),
                frame_loss=floss, zshard_train_loss=zloss)


def _check_ranks(n: int) -> None:
    """Raise ValueError unless n ranks split the tiny scene's grid into
    z-segments of whole K-slab windows (what the z-sharded render needs)."""
    from volrend_torch.models.synthetic import make_test_tree
    from volrend_torch.ops import slab_march
    from volrend_torch.ops.dense_grid import full_resolution
    G = full_resolution(make_test_tree(max_depth=DEPTH))
    K = slab_march._march_k(G, slab_march._K_STEP)
    if n < 1 or G % n or (G // n) % K:
        raise ValueError(f"{n} ranks do not split the dry run's G={G} slabs "
                         f"into z-segments of whole {K}-slab windows")


def dryrun_multichip(n: int, device: DeviceLike = None,
                     timeout_s: float = 600.0) -> dict:
    """Start n gloo ranks on ``device`` (the card unless the caller names
    "cpu"; on the card every rank shares it) and run the checks above in
    each; raises ValueError for an n the checks cannot all take, and an
    error if any rank fails or the run passes ``timeout_s``. Returns rank
    0's numbers, printed."""
    from volrend_torch.parallel import launch
    _check_ranks(n)
    device = resolve(device).type
    res = launch.spawn(_rank, n, args=(n, device), backend="gloo",
                       timeout_s=timeout_s, threads=1)[0]
    print(f"dryrun_multichip({n}, {device}): loss={res['loss']:.6f} "
          f"grad_norm={res['grad_norm']:.6f} "
          f"frame_loss={res['frame_loss']:.6f} "
          f"zshard_train_loss={res['zshard_train_loss']:.6f} OK")
    return res


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                     sys.argv[2] if len(sys.argv) > 2 else None)
