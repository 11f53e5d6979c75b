"""The port's multi-process runtime (``volrend_torch/parallel/multihost.py``),
its resumable render queue (``parallel/work_queue.py``) and the sharded
ray-batch trainer step, on the CPU: the queue's cases mirror
tests/test_aux.py and tests/test_multiprocess.py, the trainer's
tests/test_train.py's sharded step. The ranks are one gloo world of two
spawned processes (tests/_torch_dist.py); ``multihost.init`` over a
coordinator address runs in two processes of its own.

Tolerances: the queue's images against the reference's exact renderer
atol 2e-5 (f32, another summation order); the sharded trainer step against
the unsharded one loss 1e-5, rows atol 1e-6 (tests/test_train.py's), and
against the reference's sharded step rows atol 1e-4
(tests/test_torch_trainer.py's PARAM_ATOL)."""

import dataclasses
import json
import os
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_dist as td
from volrend_tpu import train as j_train
from volrend_tpu.models import synthetic as j_synth
from volrend_tpu.ops import render_jax
from volrend_tpu.ops.camera import Camera as JCamera
from volrend_tpu.parallel import dist as j_dist
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch.parallel import multihost
from volrend_torch.parallel.work_queue import RenderQueue

torch.set_num_threads(1)

KW = dict(max_depth=3, basis_dim=4, seed=11, sigma_scale=50.0)


def _problem():
    """tests/test_torch_trainer.py's problem: noisy f16 rows, 512 rays of
    one 40^2 pose and the reference's target colours for them."""
    jdev = j_synth.make_test_tree(**KW).to_device(lut_depth=None)
    th = 1.5
    back = np.array([np.cos(th), np.sin(th), 0.4])
    back /= np.linalg.norm(back)
    cam = JCamera.from_vectors(center=tuple(2.5 * back), v_back=tuple(back),
                               width=40, height=40, fx=48.0)
    o, d = (np.ascontiguousarray(x[:512]) for x in cam.pixel_rays(xp=np))
    jopt = JOpt(max_steps=256, renormalize=False)
    t = np.asarray(render_jax.render_rays(jdev, jnp.asarray(o),
                                          jnp.asarray(d), jopt))
    rng = np.random.default_rng(3)
    rows = np.asarray(jdev.data, np.float32)
    rows = (rows + rng.normal(0, 0.35, rows.shape).astype(np.float32)
            ).astype(np.float16)
    return jdev, jopt, rows, (o, d, t)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("queue"))
    jdev, jopt, rows, rays = _problem()
    cases = (("queue", 2, "queue_render", dict(out_dir=out)),
             ("trainer", 2, "trainer_sharded", dict(rows=rows, rays=rays)))
    return td.world(2, cases), out, (jdev, jopt, rows, rays)


def test_two_process_render_queue(ranks):
    """Two ranks share one RenderQueue: round-robin shards, a manifest
    each, one all-reduce over the job's mesh, and the poses' images equal
    the reference's single-process render."""
    res, out, _ = ranks
    reports = td.result(res, "queue")
    assert [r["items"] for r in reports] == [[0, 2], [1, 3]]
    assert [r["n_done"] for r in reports] == [2, 2]
    for pid, r in enumerate(reports):
        assert (r["index"], r["count"], r["psum"]) == (pid, 2, 2.0)
        assert r["shard"] == [i for i in range(5) if i % 2 == pid]
        with open(os.path.join(out, f".manifest_p{pid:03d}.json")) as f:
            assert sorted(json.load(f)["done"]) == r["items"]
    dev = j_synth.make_test_tree(max_depth=3, basis_dim=4, seed=5,
                                 sigma_scale=60.0).to_device(lut_depth=None)
    for i, cam in enumerate(td.queue_poses()):
        got = np.load(os.path.join(out, f"pose_{i}.npy"))
        jcam = JCamera.from_vectors(center=tuple(cam.center),
                                    v_back=tuple(cam.v_back), width=24,
                                    height=24, fx=30.0)
        want = np.asarray(render_jax.render_image(dev, jcam, JOpt()))
        np.testing.assert_allclose(got, want, atol=2e-5)


def test_sharded_training_step(ranks):
    """Trainer.step_sharded over two ranks (whole arrays, and the
    RayShard of shard_batch) equals Trainer.step; the rows after the step
    equal the reference's sharded step's over 8 devices."""
    res, _, (jdev, jopt, rows, (o, d, t)) = ranks
    outs = td.result(res, "trainer")
    la, lb, lc = outs[0]["loss"]
    assert abs(la - lb) < 1e-5 and abs(la - lc) < 1e-5
    for r in outs:
        np.testing.assert_allclose(r["b"], r["a"], atol=1e-6)
        np.testing.assert_array_equal(r["c"], r["b"])
    np.testing.assert_array_equal(outs[1]["b"], outs[0]["b"])
    jt = j_train.Trainer(dataclasses.replace(jdev, data=jnp.asarray(rows)),
                         jopt, lr=1e-2)
    jl = jt.step_sharded(j_dist.make_mesh(jax.devices()[:8]), o, d, t)
    assert abs(jl - la) < 1e-5
    np.testing.assert_allclose(outs[0]["b"], np.asarray(jt.data), atol=1e-4)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_over_a_coordinator(tmp_path):
    """Two processes join one job through multihost.init with a
    coordinator address (as VOLREND_COORDINATOR would give it): each sees
    its index and the count, the global mesh spans both, and a collective
    sums over both; init is idempotent."""
    import torch.multiprocessing as mp
    addr = f"127.0.0.1:{_free_port()}"
    ctx = mp.start_processes(td.coordinator_main,
                             args=(addr, 2, str(tmp_path)), nprocs=2,
                             join=False, start_method="spawn")
    try:
        for _ in range(120):
            if ctx.join(timeout=1.0):
                break
        else:
            pytest.fail("the coordinator's processes ran past 120 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    for pid in range(2):
        with open(tmp_path / f"coord_{pid}.json") as f:
            r = json.load(f)
        assert (r["index"], r["count"], r["sum"]) == (pid, 2, 3.0)
        assert (r["size"], r["local"]) == (2, pid)
        assert r["shard"] == [i for i in range(5) if i % 2 == pid]


def test_multihost_single_process():
    """Without a coordinator or a launcher's environment init is a no-op:
    one process, every pose, a one-rank mesh."""
    multihost.init()
    assert multihost.process_count() == 1
    assert multihost.process_index() == 0
    assert multihost.pose_shard(5) == [0, 1, 2, 3, 4]
    mesh = multihost.global_mesh(device="cpu")
    assert mesh.size("rays") >= 1
    with pytest.raises(ValueError, match="coordinator"):
        multihost._initialized = False
        try:
            multihost.init(num_processes=2)
        finally:
            multihost._initialized = True


def test_render_queue_resume(tmp_path):
    out = str(tmp_path / "q")
    done_log = []
    q = RenderQueue(out, n_items=10, process_index=0, process_count=2)
    assert q.my_items() == [0, 2, 4, 6, 8]
    q.run(lambda b: done_log.extend(b), batch_size=2)
    assert len(done_log) == 5
    # a restarted queue has nothing pending; the other process's shard and
    # manifest are its own
    assert RenderQueue(out, n_items=10, process_index=0,
                       process_count=2).pending() == []
    assert RenderQueue(out, n_items=10, process_index=1,
                       process_count=2).pending() == [1, 3, 5, 7, 9]


def test_render_queue_partial_resume(tmp_path):
    out = str(tmp_path / "q2")
    q = RenderQueue(out, n_items=8)

    class Boom(Exception):
        pass

    calls = []

    def render(batch):
        calls.append(list(batch))
        if len(calls) == 2:
            raise Boom()

    with pytest.raises(Boom):
        q.run(render, batch_size=2)
    assert RenderQueue(out, n_items=8).pending() == [2, 3, 4, 5, 6, 7]


def test_render_queue_pipelined_overlap(tmp_path):
    """Batch k + 1 is dispatched before batch k finishes; items are marked
    done only after their finish."""
    q = RenderQueue(str(tmp_path / "q3"), n_items=6)
    events = []

    def render(batch):
        events.append(("dispatch", tuple(batch)))
        return {"ids": tuple(batch)}

    def finish(batch, result):
        assert result["ids"] == tuple(batch)
        events.append(("finish", tuple(batch)))

    assert q.run(render, batch_size=2, finish=finish) == 6
    assert q.pending() == []
    assert events == [
        ("dispatch", (0, 1)), ("dispatch", (2, 3)), ("finish", (0, 1)),
        ("dispatch", (4, 5)), ("finish", (2, 3)), ("finish", (4, 5)),
    ]


def test_render_queue_pipelined_resume_mid_finish(tmp_path):
    out = str(tmp_path / "q4")
    q = RenderQueue(out, n_items=4)

    class Boom(Exception):
        pass

    fins = []

    def finish(batch, result):
        if batch == [2, 3]:
            raise Boom()
        fins.append(tuple(batch))

    with pytest.raises(Boom):
        q.run(lambda b: tuple(b), batch_size=2, finish=finish)
    assert fins == [(0, 1)]
    assert RenderQueue(out, n_items=4).pending() == [2, 3]
