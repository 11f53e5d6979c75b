"""Rank-side cases of the port's multi-rank tests (tests/test_torch_dist.py,
test_torch_zshard.py, test_torch_leaf_shard.py, test_torch_multihost.py).

Each test file starts ONE gloo world on the CPU per module
(``world(n, cases)``: ``volrend_torch.parallel.launch.spawn``, a FileStore
in a temporary directory, one thread a rank, every collective and the
whole run under a time limit) and runs every case in it; each case runs on
the first ``n`` ranks of the world (a mesh of its own) and returns numpy
values, which the test compares on the pytest side, against the JAX
package where the case mirrors one of its tests. This module imports
neither JAX nor the JAX package: the ranks import only the port.
"""

import traceback

import numpy as np
import torch

#: each world's limit: the per-collective timeout and the whole run's
WORLD_TIMEOUT_S = 240.0


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return x


def _mesh(axis, n, shape=None):
    from volrend_torch.parallel import mesh
    return mesh.make_mesh(axis, device="cpu", shape=shape, ranks=range(n))


def _run(rank, cases):
    """Rank ``rank``'s side of every case: {name: result, or ("error",
    traceback)} for the cases of at least rank + 1 ranks. Every rank first
    makes the process groups of every case's meshes (a group is made by
    the whole world; the cases' meshes then find theirs made)."""
    from volrend_torch.parallel import mesh
    for _, n, _, _ in cases:
        mesh.make_mesh("rays", device="cpu", ranks=range(n))
        if n >= 4 and n % 2 == 0:
            mesh.make_mesh(("scene", "rays"), device="cpu",
                           shape=(2, n // 2), ranks=range(n))
    out = {}
    for name, n, fn, kw in cases:
        if rank >= n:
            continue
        try:
            out[name] = globals()[fn](rank, n, **kw)
        except Exception:
            out[name] = ("error", traceback.format_exc())
    return out


def world(n: int, cases):
    """Run ``cases`` ((name, ranks, function name, kwargs), ...) in one
    n-rank gloo world; returns {name: [each rank's result]}, raising with
    the traceback of a case that failed on a rank."""
    from volrend_torch.parallel import launch
    per_rank = launch.spawn(_run, n, args=(cases,), backend="gloo",
                            timeout_s=WORLD_TIMEOUT_S, threads=1)
    res = {}
    for name, k, _, _ in cases:
        res[name] = [per_rank[r][name] for r in range(k)]
    return res


def result(res, name):
    """A case's per-rank results; fails on a rank's error."""
    for r, v in enumerate(res[name]):
        if (isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], str)
                and v[0] == "error"):
            raise AssertionError(f"case {name} failed on rank {r}:\n{v[1]}")
    return res[name]


# ---------------------------------------------------------------------------
# Scenes (the port's seeded generators: the same trees as the reference's)
# ---------------------------------------------------------------------------

def dist_scene():
    """tests/test_dist.py's setup: depth-3 SH4 tree (seed 2), 24^2 rays."""
    from volrend_torch.models.synthetic import make_test_tree
    from volrend_torch.ops.camera import Camera
    from volrend_torch.utils.options import RenderOptions
    dev = make_test_tree(max_depth=3, basis_dim=4, seed=2).to_device(
        lut_depth=None, device="cpu")
    cam = Camera.from_vectors(width=24, height=24, fx=30.0)
    origins, dirs = cam.pixel_rays(xp=np)
    return (dev, np.ascontiguousarray(origins), np.ascontiguousarray(dirs),
            RenderOptions(max_steps=128))


def zscene():
    """tests/test_dist.py's z-sharded scene: depth-3 SH4 (seed 5), its f16
    bake (G = 16)."""
    from volrend_torch.models.synthetic import make_test_tree
    from volrend_torch.ops import dense_grid
    tdev = make_test_tree(max_depth=3, basis_dim=4, seed=5,
                          sigma_scale=60.0).to_device(lut_depth=None,
                                                      device="cpu")
    return tdev, dense_grid.bake_dense(tdev)


def zcam(back=(0.92, 0.2, 0.27), center=None, size=32, fx=40.0):
    from volrend_torch.ops.camera import Camera
    back = np.asarray(back, np.float64)
    if center is None:
        center = tuple(2.5 * back / np.linalg.norm(back))
    return Camera.from_vectors(center=tuple(center), v_back=tuple(back),
                               width=size, height=size, fx=fx)


# ---------------------------------------------------------------------------
# Ray-parallel cases (test_torch_dist.py)
# ---------------------------------------------------------------------------

def rays_render(rank, n):
    from volrend_torch.parallel import dist
    dev, origins, dirs, opt = dist_scene()
    mesh = _mesh("rays", n)
    tree = dist.replicate_tree(dev, mesh)
    o, d, nv = dist.shard_rays(origins, dirs, mesh)
    return _np(dist.render_rays_sharded(tree, o, d, opt, mesh)[:nv])


def rays_image(rank, n):
    from volrend_torch.parallel import dist
    dev, _, _, opt = dist_scene()
    cam = zcam(size=24, fx=30.0)
    return _np(dist.render_image_sharded(dev, cam, opt, _mesh("rays", n)))


def rays_grads(rank, n):
    from volrend_torch.parallel import dist
    dev, origins, dirs, opt = dist_scene()
    target = np.full((origins.shape[0], 4), 0.4, np.float32)
    mesh = _mesh("rays", n)
    o, d, _ = dist.shard_rays(origins, dirs, mesh)
    t, _, _ = dist.shard_rays(target, np.zeros_like(origins), mesh)
    loss, g = dist.loss_and_grad_sharded(dev, dev.data.float(), o, d, t,
                                         opt, mesh)
    return float(loss), _np(g)


def rays_cp(rank, n):
    from volrend_torch.parallel import dist
    dev, origins, dirs, opt = dist_scene()
    return _np(dist.render_rays_cp(dev, origins, dirs, opt,
                                   _mesh("cp", n), axis_name="cp"))


def scenes(rank, n, seeds=(2, 7), errors=False):
    from volrend_torch.models.synthetic import make_test_tree
    from volrend_torch.ops.camera import Camera
    from volrend_torch.parallel import dist
    from volrend_torch.utils.options import RenderOptions
    trees = [make_test_tree(max_depth=3, basis_dim=4, seed=s,
                            sigma_scale=50.0).to_device(lut_depth=None,
                                                        device="cpu")
             for s in seeds]
    opt = RenderOptions(max_steps=128)
    cam = Camera.from_vectors(width=16, height=16, fx=20.0)
    o, d = cam.pixel_rays(xp=np)
    mesh = _mesh(("scene", "rays"), n, shape=(2, n // 2))
    stacked = dist.stack_trees(trees)
    S = len(seeds)
    out = {"frames": _np(dist.render_scenes_sharded(
        stacked, np.stack([o] * S), np.stack([d] * S), opt, mesh))}
    if errors:
        for key, args in (
                ("tile", (stacked, np.stack([o] * 3), np.stack([d] * 3))),
                ("batches", (dist.stack_trees(trees[:2]), np.stack([o] * S),
                             np.stack([d] * S)))):
            try:
                dist.render_scenes_sharded(*args, opt, mesh)
                out[key] = ""
            except ValueError as e:
                out[key] = str(e)
    return out


def mesh_layout(rank, n):
    """The 2-D mesh's coordinates and each axis's group members."""
    import torch.distributed as tdist
    mesh = _mesh(("scene", "rays"), n, shape=(2, n // 2))
    out = {"coord": (mesh.get_local_rank("scene"),
                     mesh.get_local_rank("rays")),
           "size": (mesh.size("scene"), mesh.size("rays"), mesh.size())}
    for ax in ("scene", "rays"):
        g = mesh.get_group(ax)
        out[ax] = tdist.get_process_group_ranks(g)
    return out


# ---------------------------------------------------------------------------
# Leaf sharding (test_torch_leaf_shard.py)
# ---------------------------------------------------------------------------

def leaf_render(rank, n):
    from volrend_torch.ops import render_exact
    from volrend_torch.parallel import dist, leaf_shard
    dev, origins, dirs, opt = dist_scene()
    mesh = _mesh("rays", n)
    tree_s, rps = leaf_shard.shard_tree_leaves(dev, mesh)
    o, d, nv = dist.shard_rays(origins, dirs, mesh)
    render_exact.reset_march_counts()
    out = leaf_shard.render_rays_leaf_sharded(tree_s, o, d, opt, mesh, rps)
    return {"out": _np(out[:nv]), "rps": rps,
            "rows": _np(tree_s.data), "counts": dict(
                render_exact.march_counts)}


def leaf_grads(rank, n):
    from volrend_torch.parallel import dist, leaf_shard
    dev, origins, dirs, opt = dist_scene()
    target = np.full((origins.shape[0], 4), 0.4, np.float32)
    mesh = _mesh("rays", n)
    tree_s, rps = leaf_shard.shard_tree_leaves(dev, mesh)
    o, d, _ = dist.shard_rays(origins, dirs, mesh)
    t = dist.shard_rays(target, np.zeros_like(target[:, :3]), mesh)[0]
    loss, g = leaf_shard.loss_and_grad_leaf_sharded(
        tree_s, tree_s.data.float(), o, d, t, opt, mesh)
    return float(loss), _np(g)


def leaf_fetch(rank, n):
    """ShardedLeaves.fetch_rows against a dense gather, each rank asking
    its own indices."""
    from volrend_torch.parallel import leaf_shard
    dev, _, _, _ = dist_scene()
    mesh = _mesh("rays", n)
    tree_s, rps = leaf_shard.shard_tree_leaves(dev, mesh)
    leaves = leaf_shard.ShardedLeaves(tree_s.data, mesh.get_group("rays"),
                                      rps, rps * n, tree_s.data.shape[1])
    g = torch.Generator().manual_seed(rank)
    idx = torch.randint(0, dev.data.shape[0], (5, 7), generator=g)
    return _np(leaves.fetch_rows(idx)), _np(dev.data[idx].float())


# ---------------------------------------------------------------------------
# The slab path on z-segments (test_torch_zshard.py)
# ---------------------------------------------------------------------------

def zframe(rank, n, back=(0.92, 0.2, 0.27), center=(2.4, 0.5, 0.7),
           dir_win=True):
    from volrend_torch.ops import slab_march
    from volrend_torch.parallel import dist
    from volrend_torch.utils.options import RenderOptions
    _, grid = zscene()
    cam = zcam(back, center=center)
    opt = RenderOptions(max_steps=512)
    prev = slab_march._DIR_WIN
    slab_march._DIR_WIN = dir_win
    try:
        return _np(dist.render_frame_slab_zsharded(
            grid, cam.transform, cam.fx, cam.fy, 32, 32, opt,
            _mesh("z", n), gi=96))
    except ValueError as e:
        return str(e)
    finally:
        slab_march._DIR_WIN = prev


def zframes_batched(rank, n):
    from volrend_torch.parallel import dist
    from volrend_torch.utils.options import RenderOptions
    _, grid = zscene()
    cams = []
    for i in range(3):
        back = np.array([0.92, 0.2 + 0.08 * i, 0.27])
        back /= np.linalg.norm(back)
        cams.append(zcam(back))
    opt = RenderOptions(max_steps=512)
    mesh = _mesh("z", n)
    trs = np.stack([c.transform for c in cams])
    batch = dist.render_frames_slab_zsharded(grid, trs, cams[0].fx,
                                             cams[0].fy, 32, 32, opt, mesh,
                                             gi=96)
    single = [dist.render_frame_slab_zsharded(grid, c.transform, c.fx, c.fy,
                                              32, 32, opt, mesh, gi=96)
              for c in cams]
    return _np(batch), np.stack([_np(s) for s in single])


def _train_setup():
    from volrend_torch.ops import slab_grad, slab_render
    from volrend_torch.utils.options import RenderOptions
    tdev, grid = zscene()
    bmap = slab_grad.build_bake_map(tdev)
    cam = zcam(center=(2.4, 0.5, 0.7), size=24, fx=30.0)
    perm, flip, _ = slab_render.choose_axis(grid, cam.transform, cam.fx,
                                            cam.fy, 24, 24)
    opt = RenderOptions(max_steps=512, stop_thresh=0.0)
    return tdev, grid, bmap, cam, perm, flip, opt


def ztrain_grad(rank, n, rows=None):
    """The z-sharded training frame's loss (sum of out * Wt) and its leaf
    gradient, and the unsharded kernel path's, from ``rows`` (K, D) f32."""
    from volrend_torch.ops import slab_grad
    tdev, grid, bmap, cam, perm, flip, opt = _train_setup()
    data = torch.as_tensor(rows if rows is not None
                           else tdev.data.float().numpy())
    Wt = torch.as_tensor(np.random.default_rng(4).normal(
        size=(24, 24, 4)).astype(np.float32))
    out = {}
    for name, fn in (("z", lambda d: slab_grad.render_frame_train_zsharded(
            d, bmap, grid, cam.transform, cam.fx, cam.fy, perm, flip, 24, 24,
            opt, _mesh("z", n), gi=48)),
                     ("whole", lambda d: slab_grad.render_frame_train(
            d, bmap, grid, cam.transform, cam.fx, cam.fy, perm, flip, 24, 24,
            opt, gi=48, backend="kernel"))):
        d = data.clone().requires_grad_(True)
        loss = torch.sum(fn(d) * Wt)
        (g,) = torch.autograd.grad(loss, d)
        out[name] = (float(loss), _np(g))
    return out


def zmarch(rank, n, inputs=None):
    """The z-sharded training march (slab_grad._MarchKernel with a mesh)
    and the unsharded one (without) on the reference's inputs (the
    bf16-rounded planar payload, params, z interval, cotangent): each
    one's (acc, T, payload gradient in the reference's (z, y, x, D)
    layout)."""
    from volrend_torch.ops import slab_grad
    from volrend_torch.utils.options import RenderOptions
    perm, flip = tuple(inputs["perm"]), bool(inputs["flip"])
    planar = torch.as_tensor(inputs["planar"])
    G, D = planar.shape[0], planar.shape[1]
    gi = inputs["zb"].shape[-1]
    q = (perm[0], 3, perm[1], perm[2])
    inv = slab_grad._inverse(q)
    opt = RenderOptions(max_steps=512, stop_thresh=0.0, renormalize=False)
    cfg = slab_grad.SlabCfg(G=G, gi=gi, D=D, bd=(D - 1) // 3, fmt=1,
                            perm=perm, flip=flip,
                            ids=tuple(range(G - 1, -1, -1) if flip
                                      else range(G)), opt=opt)
    params = torch.as_tensor(inputs["params"])
    zb = torch.as_tensor(inputs["zb"])
    g_acc = torch.as_tensor(inputs["g_acc"])
    g_T = torch.as_tensor(inputs["g_T"])
    out = {}
    for name in ("z", "whole"):
        bake = planar.permute(*inv).contiguous().requires_grad_(True)
        acc, T = slab_grad._MarchKernel.apply(
            bake.permute(*q), params, zb, cfg, None, None,
            _mesh("z", n) if name == "z" else None, "z")
        loss = torch.sum(acc * g_acc) + torch.sum(T * g_T)
        (g,) = torch.autograd.grad(loss, bake)
        out[name] = (_np(acc), _np(T),
                     _np(g.permute(perm[0], perm[1], perm[2], 3)))
    return out


def ztrain_steps(rank, n, steps=1, compare=True):
    """FrameTrainer: ``steps`` z-sharded steps and (``compare``) as many
    unsharded ones from the same noisy tree; losses and the pyramids after
    them."""
    import dataclasses
    from volrend_torch import train
    from volrend_torch.ops import render_exact
    tdev, grid, bmap, cam, perm, flip, opt = _train_setup()
    opt = opt.replace(renormalize=False)
    target = render_exact.render_image(tdev, cam, opt)
    rng = np.random.default_rng(1)
    noisy = dataclasses.replace(tdev, data=torch.as_tensor(
        (tdev.data.float().numpy() + rng.normal(0, 0.3, tdev.data.shape)
         .astype(np.float32)).astype(np.float16)))
    mesh = _mesh("z", n)
    tz = train.FrameTrainer(noisy, opt, lr=5e-2, gi=48)
    lz = [tz.step_frame_zsharded(mesh, cam, target) for _ in range(steps)]
    if not compare:
        return {"z": lz}
    tu = train.FrameTrainer(noisy, opt, lr=5e-2, gi=48)
    lu = [tu.step_frame(cam, target) for _ in range(steps)]
    return {"z": lz, "whole": lu, "pz": [_np(p) for p in tz.pyramid],
            "pu": [_np(p) for p in tu.pyramid]}


def frames_sharded(rank, n, n_poses=4):
    """loss_and_grad_frames_sharded over ``n_poses`` poses of one group
    against the per-frame losses and gradients, and one
    FrameTrainer.step_frames_sharded step against a one-rank world's."""
    import dataclasses
    from volrend_torch import train
    from volrend_torch.ops import slab_grad, slab_render
    tdev, grid, bmap, _, _, _, opt = _train_setup()
    opt = opt.replace(stop_thresh=1e-4, renormalize=False)
    cams, targets = [], []
    for i in range(n_poses):
        back = np.array([1.0, 0.15 + 0.02 * i, 0.25 + 0.015 * i])
        cams.append(zcam(back / np.linalg.norm(back), size=24, fx=30.0))
        targets.append(np.full((24, 24, 4), 0.3 + 0.05 * i, np.float32))
    keys = {slab_render.choose_axis(grid, c.transform, c.fx, c.fy, 24,
                                    24)[:2] for c in cams}
    assert len(keys) == 1, keys
    (perm, flip), = keys
    rows = tdev.data.float()
    pyr = slab_grad.data_to_pyramid(rows, bmap)
    mesh = _mesh("frames", n)
    trs = np.stack([c.transform for c in cams])
    loss, grads = slab_grad.loss_and_grad_frames_sharded(
        pyr, bmap, grid, trs, cams[0].fx, cams[0].fy, perm, flip, 24, 24,
        np.stack(targets), opt, mesh, gi=48)
    per = [slab_grad.loss_and_grad_frame(pyr, bmap, grid, c.transform, c.fx,
                                         c.fy, perm, flip, 24, 24, t, opt,
                                         gi=48)
           for c, t in zip(cams, targets)]
    rng = np.random.default_rng(2)
    noisy = dataclasses.replace(tdev, data=torch.as_tensor(
        (tdev.data.float().numpy() + rng.normal(0, 0.2, tdev.data.shape)
         .astype(np.float32)).astype(np.float16)))
    ts = train.FrameTrainer(noisy, opt, lr=5e-2, gi=48)
    t1 = train.FrameTrainer(noisy, opt, lr=5e-2, gi=48)
    placed = ts.place_frames(cams, targets)
    ls = ts.step_frames_sharded(mesh, cams, placed)
    l1 = t1.step_frames_sharded(_mesh("frames", 1) if n == 1 else
                                _one_rank_mesh(), cams, targets)
    return {"loss": float(loss), "grads": [_np(g) for g in grads],
            "per_loss": [float(p[0]) for p in per],
            "per_grads": [[_np(g) for g in p[1]] for p in per],
            "step": (ls, l1), "ps": [_np(p) for p in ts.pyramid],
            "p1": [_np(p) for p in t1.pyramid]}


def _one_rank_mesh():
    """A mesh of this rank alone (no collective), inside a larger world."""
    import torch.distributed as tdist
    from volrend_torch.parallel import mesh
    return mesh.make_mesh("frames", device="cpu",
                          ranks=[tdist.get_rank()])


# ---------------------------------------------------------------------------
# Trainer and the multi-process runtime (test_torch_multihost.py)
# ---------------------------------------------------------------------------

def trainer_sharded(rank, n, rows=None, rays=None):
    """Trainer.step_sharded against Trainer.step from the same rows."""
    import dataclasses
    from volrend_torch import train
    from volrend_torch.models.synthetic import make_test_tree
    from volrend_torch.utils.options import RenderOptions
    dev = make_test_tree(max_depth=3, basis_dim=4, seed=11,
                         sigma_scale=50.0).to_device(lut_depth=None,
                                                     device="cpu")
    noisy = dataclasses.replace(dev, data=torch.as_tensor(rows))
    opt = RenderOptions(max_steps=256, renormalize=False)
    o, d, t = rays
    ta = train.Trainer(noisy, opt, lr=1e-2)
    tb = train.Trainer(noisy, opt, lr=1e-2)
    tc = train.Trainer(noisy, opt, lr=1e-2)
    mesh = _mesh("rays", n)
    la = ta.step(o, d, t)
    lb = tb.step_sharded(mesh, o, d, t)
    lc = tc.step_sharded(mesh, tc.shard_batch(mesh, o, d, t))
    return {"loss": (la, lb, lc), "a": _np(ta.data), "b": _np(tb.data),
            "c": _np(tc.data)}


def queue_render(rank, n, out_dir=None):
    """Two ranks share one RenderQueue: each renders its round-robin shard
    of four poses (the exact renderer) and writes one .npy a pose; one
    all-reduce over the world's mesh."""
    import os
    from volrend_torch.ops import render_exact
    from volrend_torch.parallel import mesh as mesh_mod
    from volrend_torch.parallel import multihost
    from volrend_torch.parallel.work_queue import RenderQueue
    from volrend_torch.utils.options import RenderOptions
    multihost.init()
    tdev, _ = zscene()
    cams = queue_poses()
    q = RenderQueue(out_dir, n_items=len(cams),
                    process_index=multihost.process_index(),
                    process_count=multihost.process_count())

    def render_batch(ids):
        for i in ids:
            img = render_exact.render_image(tdev, cams[i], RenderOptions())
            np.save(os.path.join(out_dir, f"pose_{i}.npy"), _np(img))

    n_done = q.run(render_batch, batch_size=2)
    mesh = multihost.global_mesh(device="cpu")
    one = mesh_mod.all_reduce(torch.ones(1), mesh.get_group("rays"))
    return {"items": q.my_items(), "n_done": n_done,
            "psum": float(one[0]), "count": multihost.process_count(),
            "index": multihost.process_index(),
            "shard": multihost.pose_shard(5)}


def queue_poses(n=4):
    """tests/_mp_worker.py's poses."""
    from volrend_torch.ops.camera import Camera
    cams = []
    for i in range(n):
        th = 2 * np.pi * i / n + 0.3
        back = np.array([np.cos(th), np.sin(th), 0.5])
        back /= np.linalg.norm(back)
        cams.append(Camera.from_vectors(
            center=tuple(2.5 * back), v_back=tuple(back),
            width=24, height=24, fx=30.0))
    return cams


def collectives(rank, n):
    """The mesh's collectives on gloo: all_gather, all_reduce,
    reduce_scatter and any_true, and the counts they leave."""
    from volrend_torch.parallel import mesh as mesh_mod
    mesh = _mesh("rays", n)
    g = mesh.get_group("rays")
    mesh_mod.collective_counts.clear()
    t = torch.arange(3, dtype=torch.float32) + 10 * rank
    gathered = mesh_mod.all_gather(t, g)
    reduced = mesh_mod.all_reduce(t.clone(), g)
    rows = torch.arange(2 * n, dtype=torch.float32)[:, None] * (rank + 1)
    scattered = mesh_mod.reduce_scatter(rows, g)
    anyt = mesh_mod.any_true(torch.tensor([rank == n - 1]), g)
    nonet = mesh_mod.any_true(torch.tensor([False]), g)
    return {"gathered": _np(gathered), "reduced": _np(reduced),
            "scattered": _np(scattered), "any": (anyt, nonet),
            "backend": mesh_mod.backend_of(g),
            "counts": dict(mesh_mod.collective_counts)}


def coordinator_main(rank, addr, n, out_dir):
    """A process of a job joined by ``multihost.init`` over a coordinator
    address (no launcher): its view of the job and one all-reduce."""
    import json
    import os
    import torch.distributed as tdist
    from volrend_torch.parallel import mesh as mesh_mod
    from volrend_torch.parallel import multihost
    torch.set_num_threads(1)
    multihost.init(coordinator_address=addr, num_processes=n,
                   process_id=rank, backend="gloo", timeout_s=60)
    multihost.init()                      # idempotent
    mesh = multihost.global_mesh(device="cpu")
    s = mesh_mod.all_reduce(torch.full((1,), float(rank + 1)),
                            mesh.get_group("rays"))
    with open(os.path.join(out_dir, f"coord_{rank}.json"), "w") as f:
        json.dump({"index": multihost.process_index(),
                   "count": multihost.process_count(),
                   "shard": multihost.pose_shard(5), "sum": float(s[0]),
                   "size": mesh.size("rays"),
                   "local": mesh.get_local_rank("rays")}, f)
    tdist.destroy_process_group()


def scaled_epoch(rank, n, ckpt=None):
    """tests/test_train.py's scaled sharded epoch: 256^2 frames of 8 poses
    of one group sharded over the ranks, 4 epochs in one run; 2 epochs, a
    checkpoint, a fresh trainer restored from it and 2 more in another.
    Returns (PSNR of pose 0 before, after run A; whether the resumed run's
    rows equal run A's bit for bit)."""
    import dataclasses
    from volrend_torch import train
    from volrend_torch.models.synthetic import make_test_tree
    from volrend_torch.ops import dense_grid, slab_grad, slab_render
    from volrend_torch.ops.camera import Camera
    from volrend_torch.utils.options import RenderOptions
    W = H = 256
    dev = make_test_tree(max_depth=3, basis_dim=4, seed=11,
                         sigma_scale=50.0).to_device(lut_depth=None,
                                                     device="cpu")
    opt = RenderOptions(max_steps=256, renormalize=False)
    grid = dense_grid.bake_dense(dev)
    cams, targets, group, th = [], [], None, 0.25
    while len(cams) < 8:
        back = np.array([np.cos(th), np.sin(th) * 0.25, 0.4])
        th += 0.05
        back /= np.linalg.norm(back)
        cam = Camera.from_vectors(center=tuple(2.5 * back),
                                  v_back=tuple(back), width=W, height=H,
                                  fx=300.0)
        perm, flip, slope = slab_render.choose_axis(grid, cam.transform,
                                                    cam.fx, cam.fy, W, H)
        if not np.isfinite(slope):
            continue
        group = group or (perm, flip)
        if (perm, flip) != group:
            continue
        cams.append(cam)
        targets.append(slab_render.render_frame(
            grid, cam.transform, cam.fx, cam.fy, perm, flip, W, H, opt,
            gi=256).numpy())
    rng = np.random.default_rng(7)
    noisy = dataclasses.replace(dev, data=torch.as_tensor(
        (dev.data.float().numpy() + rng.normal(0, 0.3, dev.data.shape)
         .astype(np.float32)).astype(np.float16)))
    mesh = _mesh("frames", n)

    def eval_psnr(tr):
        with torch.no_grad():
            out = slab_grad.render_frame_train(
                tr.pyramid, tr.bmap, tr.grid, cams[0].transform, cams[0].fx,
                cams[0].fy, group[0], group[1], W, H, tr.opt, gi=256)
        return train.psnr(out[..., :3], targets[0][..., :3])

    tr_a = train.FrameTrainer(noisy, opt, lr=3e-2, gi=256)
    p0 = eval_psnr(tr_a)
    for _ in range(4):
        tr_a.step_frames_sharded(mesh, cams, targets)
    p1 = eval_psnr(tr_a)
    tr_b = train.FrameTrainer(noisy, opt, lr=3e-2, gi=256)
    for _ in range(2):
        tr_b.step_frames_sharded(mesh, cams, targets)
    if rank == 0:
        tr_b.save_checkpoint(ckpt)
    import torch.distributed as tdist
    tdist.barrier()
    tr_c = train.FrameTrainer(noisy, opt, lr=3e-2, gi=256)
    tr_c.restore_checkpoint(ckpt)
    steps = tr_c.step_count
    for _ in range(2):
        tr_c.step_frames_sharded(mesh, cams, targets)
    return {"p0": p0, "p1": p1, "steps": steps,
            "equal": bool(torch.equal(tr_a.data, tr_c.data))}
