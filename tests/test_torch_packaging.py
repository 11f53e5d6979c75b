"""Packaging and device contract of the PyTorch port (``volrend_torch``):
it imports neither JAX nor the JAX package, its entry points default to the
card and never drift to the CPU, and its kernel wrappers refuse what they
do not take instead of quietly running something else."""

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from volrend_torch import kernels
from volrend_torch.ops import display_warp, slab_march
from volrend_torch.utils.options import RenderOptions

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "volrend_torch", "volrend_torch.kernels", "volrend_torch.convert",
    "volrend_torch.utils.options", "volrend_torch.utils.device",
    "volrend_torch.models.data_format", "volrend_torch.models.n3tree",
    "volrend_torch.models.synthetic", "volrend_torch.ops.camera",
    "volrend_torch.ops.basis", "volrend_torch.ops.render_exact",
    "volrend_torch.ops.dense_grid", "volrend_torch.ops.slab_render",
    "volrend_torch.ops.slab_march", "volrend_torch.ops.display_warp",
    "volrend_torch.ops.slab_grad", "volrend_torch.train",
    "volrend_torch.probes", "volrend_torch.probes._common",
    "volrend_torch.probes.perf_overlap", "volrend_torch.probes.perf_sq3",
    "volrend_torch.probes.perf_sq4", "volrend_torch.probes.display_tiles",
    "volrend_torch.probes.tma_box", "volrend_torch.probes.display_info",
    "volrend_torch.models.mesh", "volrend_torch.ops.rasterize",
    "volrend_torch.ops.composite", "volrend_torch.compress",
    "volrend_torch.models.quantized", "volrend_torch.ops.grad",
    "volrend_torch.ops.oracle", "volrend_torch.utils.png",
    "volrend_torch.cli", "volrend_torch.cli.opts",
    "volrend_torch.cli.headless", "volrend_torch.parallel",
    "volrend_torch.parallel.mesh", "volrend_torch.parallel.dist",
    "volrend_torch.parallel.leaf_shard", "volrend_torch.parallel.multihost",
    "volrend_torch.parallel.work_queue", "volrend_torch.parallel.launch",
    "volrend_torch.parallel.dryrun",
]


def test_port_imports_without_jax():
    """Importing every port module loads neither jax nor volrend_tpu."""
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m.startswith('jaxlib') or "
              "m.startswith('volrend_tpu'))\n"
              "print(repr(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "volrend_torch")):
        files += [os.path.join(base, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    return sorted(files)


def test_port_sources_import_no_jax():
    """No source of the port (nor chip_smoke.py) imports JAX or the JAX
    package. (The kernel notes and the smoke's report name the reference
    kernels they replace by file and line; that is a reference, not an
    import.)"""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|volrend_tpu)\b"
                     r"|import_module\(\s*[\"'](jax|volrend_tpu)"
                     r"|__import__\(\s*[\"'](jax|volrend_tpu)", re.M)
    files = _port_files()
    assert len(files) > 15
    bad = [f for f in files if pat.search(open(f).read())]
    assert bad == [], bad


def test_parallel_layer_is_scanned_and_its_entry_points_run():
    """The parallel layer (volrend_torch/parallel/) is in the scans above,
    and the sharded entry points it brought no longer raise
    NotImplementedError: the trainers' sharded steps and slab_grad's
    sharded frame training."""
    import inspect
    from volrend_torch import train
    from volrend_torch.ops import slab_grad
    files = _port_files()
    for name in ("__init__", "mesh", "dist", "leaf_shard", "multihost",
                 "work_queue", "launch", "dryrun"):
        assert os.path.join(ROOT, "volrend_torch", "parallel",
                            name + ".py") in files
        assert f"volrend_torch.parallel.{name}".replace(
            ".__init__", "") in MODULES
    for fn in (train.Trainer.shard_batch, train.Trainer.step_sharded,
               train.FrameTrainer.step_frame_zsharded,
               train.FrameTrainer.place_frames,
               train.FrameTrainer.step_frames_sharded,
               slab_grad.loss_and_grad_frames_sharded,
               slab_grad.render_frame_train_zsharded,
               slab_march.march_slabs, slab_march.march_slabs_bwd):
        assert "NotImplementedError" not in inspect.getsource(fn), fn
    src = open(os.path.join(ROOT, "volrend_torch", "train.py")).read()
    assert "slice D" not in src
    assert "slice D" not in inspect.getsource(slab_grad)


def test_cuda_sources_name_their_tpu_kernel():
    """Each CUDA source opens with a note naming the TPU kernel it
    replaces, what bounds it on the card and its design."""
    want = {"slab_march.cu": "pallas_slab.py:_make_kernel",
            "slab_march_display.cu": "pallas_slab.py:_make_kernel",
            "slab_march_bwd.cu": "pallas_slab.py:_make_bwd_kernel",
            "warp_build.cu": "display_warp.py:_make_build",
            "warp_combine.cu": "display_warp.py:_make_combine_kernel",
            "warp_display.cu": "display_warp.py:_make_combine_kernel",
            "warp_combine_adj.cu": "display_warp.py:_combine_adjoint_kernel",
            "warp_build_adj.cu": "display_warp.py:_build_adjoint",
            "probe_combine.cu": "perf_sq3.py:combine_pallas",
            "probe_stream.cu": "perf_overlap.py:dma_once",
            "probe_build.cu": "perf_sq4.py:build_pallas",
            "bake_pyramid.cu": "slab_grad.py:bake_from_pyramid"}
    # (kernel M's training mode and M-bwd are each built as three
    # libraries from one source, its display mode as two)
    assert sorted(want) == sorted({src for src, _ in
                                   kernels.SOURCES.values()})
    for name, ref in want.items():
        head = open(os.path.join(ROOT, "volrend_torch", "csrc", name)
                    ).read()[:4000]
        assert ref in head, name
        assert "bounds it on the H100" in head, name
        assert "Design" in head, name
        assert name in kernels.SOURCES[name[:-3]][0]


_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
            "long": ctypes.c_longlong}


@pytest.mark.parametrize("name", sorted(kernels.SOURCES))
def test_c_entries_match_their_argtypes(name):
    """Each C entry that ``kernels.SOURCES`` binds is defined in its source
    with the parameters its ctypes argtypes list: pointers as c_void_p,
    ints as c_int, long longs as c_longlong, floats as c_float (a
    mismatch would pass a truncated pointer or a wrong value without an
    error)."""
    src, entries = kernels.SOURCES[name]
    text = open(os.path.join(ROOT, "volrend_torch", "csrc", src)).read()
    for fn, argtypes in entries.items():
        m = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text)
        assert m, (src, fn)
        want = [ctypes.c_void_p if "*" in decl else _C_TYPES[decl.split()[-2]]
                for decl in m.group(1).split(",")]
        assert want == argtypes, (src, fn)


@pytest.mark.parametrize("entry", ["to_device", "bake_dense", "resolve",
                                   "trainer", "headless", "dryrun"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    """Called without ``device=`` on a machine with no card, the entry
    points raise instead of running on the CPU: the ray-batch Trainer
    (on a tree uploaded by default), the headless CLI (without
    ``--device cpu``) and the parallel layer's dry run too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from volrend_torch import train
    from volrend_torch.cli import headless
    from volrend_torch.models.synthetic import make_test_tree
    from volrend_torch.ops import dense_grid
    from volrend_torch.parallel import dryrun
    from volrend_torch.utils.device import resolve
    tree = make_test_tree(max_depth=1, basis_dim=1, seed=0)
    tree_path, pose = str(tmp_path / "t.npz"), str(tmp_path / "p.txt")
    tree.save_npz(tree_path)
    np.savetxt(pose, np.eye(4))
    call = {"to_device": lambda: tree.to_device(),
            "bake_dense": lambda: dense_grid.bake_dense(tree),
            "resolve": lambda: resolve(None),
            "trainer": lambda: train.Trainer(tree.to_device()),
            "headless": lambda: headless.main([tree_path, pose]),
            "dryrun": lambda: dryrun.dryrun_multichip(2)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    # asking for the CPU explicitly works
    assert tree.to_device(device="cpu").data.device.type == "cpu"
    if entry == "trainer":
        tr = train.Trainer(tree.to_device(device="cpu"))
        assert tr.data.device.type == "cpu"
    if entry == "headless":
        assert headless.main([tree_path, pose, "--device", "cpu", "-W",
                              "4", "-H", "4", "--renderer", "exact"]) == 0


def _march_args(**over):
    G, bd = 4, 4
    D = 3 * bd + 1
    kw = dict(gplanar=torch.zeros((G, D + 1, G, G), dtype=torch.int8),
              params=torch.zeros((1, 30)), qscale=torch.ones(D + 1),
              zbounds=torch.zeros((1, 2, 8, 8)), G=G, gi=8, D=D, bd=bd,
              perm=(0, 1, 2), sig2=True, bbox_full=True, dir_win=True)
    kw.update(over)
    return kw


@pytest.mark.parametrize("option,item", [
    (dict(shade_bf16=True), "item 10c"), (dict(dir_win=False), "item 10c"),
    (dict(acc_init=0.0), "item 19"), (dict(z_base=0.5), "item 19"),
])
def test_march_refuses_later_slices_options(option, item):
    """Kernel M's wrapper runs the options the later slices brought: the
    display knobs of item 10c (bf16 shading, per-slab directions on the
    int8 payload; tests/test_torch_display_knobs.py holds them against the
    reference) and the z-segments of item 19 (``z_base``, ``acc_init``:
    tests/test_torch_zshard.py); an acc_init of the wrong shape raises
    ValueError rather than running something else."""
    if "acc_init" in option:
        with pytest.raises(ValueError, match="acc_init must be"):
            slab_march.march_slabs(**_march_args(**option))
        init = torch.rand((4, 8, 8))
        option = dict(acc_init=init)
    acc = slab_march.march_slabs(**_march_args(**option))
    assert tuple(acc.shape) == (1, 4, 8, 8)


def _bf16_display(**over):
    """The f16 bake's display payload: bf16, Dp = D, window directions."""
    kw = _march_args(sig2=False)
    kw["gplanar"] = torch.zeros((4, kw["D"], 4, 4), dtype=torch.bfloat16)
    kw["qscale"] = torch.ones(kw["D"])
    kw.update(over)
    return kw


@pytest.mark.parametrize("case", [
    "sg", "depth", "rot", "bbox", "window", "bf16", "bf16_rgba"])
def test_march_runs_display_options(case):
    """The display path's formats and options that kernel M's wrapper took
    only from this slice on run (tests/test_torch_options.py and
    tests/test_torch_formats.py hold each against the reference)."""
    kw = {"sg": lambda: _march_args(fmt=2, extra=torch.ones((4, 4))),
          "depth": lambda: _march_args(depth=True),
          "rot": lambda: _march_args(rot=tuple(np.eye(3).ravel())),
          "bbox": lambda: _march_args(bbox_full=False),
          "window": lambda: _march_args(basis_hi=8),
          "bf16": lambda: _bf16_display(),
          "bf16_rgba": lambda: _bf16_display(
              fmt=0, bd=-1, D=4, qscale=torch.ones(4),
              gplanar=torch.zeros((4, 4, 4, 4), dtype=torch.bfloat16)),
          }[case]()
    acc = slab_march.march_slabs(**kw)
    assert tuple(acc.shape) == (1, 4, 8, 8) and acc.dtype == torch.float32


def test_march_default_options_run_on_cpu():
    acc = slab_march.march_slabs(**_march_args())
    assert tuple(acc.shape) == (1, 4, 8, 8)


def _train_args(**over):
    """The training path's option set: a bf16 payload with Dp = D and
    per-slab view directions, in the training mode."""
    kw = _march_args(sig2=False, dir_win=False, train=True)
    kw["gplanar"] = torch.zeros((4, kw["D"], 4, 4), dtype=torch.bfloat16)
    kw["qscale"] = torch.ones(kw["D"])
    kw.update(over)
    return kw


@pytest.mark.parametrize("option,error,match", [
    (dict(depth=True), ValueError, "never marches depth"),
    (dict(shade_bf16=True), NotImplementedError, "item 10c"),
    (dict(z_base=0.5), NotImplementedError, "item 19"),
])
def test_march_training_mode_refuses_other_options(option, error, match):
    """On the training payload (per-slab directions) the wrapper raises on
    every option it does not take: depth mode, which the reference's
    training path never marches (ValueError). bf16 shading, which item 10c
    brought to the display mode, is refused here as a ValueError: the
    reference's training path shades in f32. The z-segments of item 19
    run (``z_base``: tests/test_torch_zshard.py holds them); a payload of
    more than G slabs raises ValueError. A bf16 payload outside the
    training mode is the f16 bake's display route
    (test_march_runs_display_options)."""
    if option.get("shade_bf16"):
        error, match = ValueError, "shades in f32"
    if match == "item 19":
        acc = slab_march.march_slabs(**_train_args(**option))
        assert tuple(acc.shape) == (1, 4, 8, 8)
        error, match = ValueError, "at most G"
        option = dict(option, G=2)
    with pytest.raises(error, match=match):
        slab_march.march_slabs(**_train_args(**option))


@pytest.mark.parametrize("option", [
    dict(rot=tuple(np.eye(3).ravel())), dict(bbox_full=False),
    dict(basis_hi=2), dict(fmt=2, extra=torch.ones((4, 4))),
], ids=["rot", "bbox", "window", "sg"])
def test_march_training_mode_runs_formats_and_options(option):
    """The training payload's formats and options run, forward and
    backward (tests/test_torch_train_formats.py holds each against the
    reference)."""
    kw = _train_args(**option)
    acc = slab_march.march_slabs(**kw)
    assert tuple(acc.shape) == (1, 4, 8, 8) and acc.dtype == torch.float32
    for k in ("sig2", "dir_win", "train"):
        kw.pop(k)
    g = slab_march.march_slabs_bwd(
        kw.pop("gplanar"), kw.pop("params")[0], kw.pop("qscale"),
        kw.pop("zbounds")[0], torch.ones((4, 8, 8)), acc[0], **kw)
    assert tuple(g.shape) == (4, kw["D"], 4, 4) and g.dtype == torch.float32


def test_march_training_options_run_on_cpu():
    acc = slab_march.march_slabs(**_train_args())
    assert tuple(acc.shape) == (1, 4, 8, 8)
    with pytest.raises(ValueError):
        slab_march.march_slabs(**_train_args(sig2=True))


def test_kernel_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA card gets no kernel."""
    meta = torch.empty((1, 4, 16, 16), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        display_warp.build_table(meta, (4, 4))
    prm = torch.empty((1, 16), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        display_warp.level_fit_counts(prm, display_warp._CASCADE, 16, 16,
                                      16)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        display_warp.warp_display(
            meta, prm, torch.zeros(1, dtype=torch.int32, device="meta"),
            torch.empty((1, 16, 16, 4), dtype=torch.uint8, device="meta"),
            (2, 2), (4, 4), 16, 1.0)


@pytest.mark.parametrize("probe", ["combine", "stream", "build"])
def test_probe_wrappers_refuse_other_devices(probe):
    """The probes' kernel wrappers, too, run their plain versions only on
    CPU tensors and launch nothing for another device."""
    from volrend_torch.probes import perf_overlap, perf_sq3, perf_sq4
    meta = {"combine": lambda: perf_sq3.combine_probe(
                torch.empty((64, 8, 8), dtype=torch.bfloat16,
                            device="meta"),
                *(torch.empty((4, 8, 8), device="meta"),) * 3, 1.0),
            "stream": lambda: perf_overlap.stream_probe(
                torch.empty((8, 3, 8, 128), dtype=torch.int8,
                            device="meta"),
                torch.empty(2, dtype=torch.int32, device="meta")),
            "build": lambda: perf_sq4.build_probe(
                torch.empty((4, 19, 19), dtype=torch.bfloat16,
                            device="meta"), 19)}[probe]
    with pytest.raises(RuntimeError, match="no kernel for device"):
        meta()


def test_kernel_build_is_keyed_by_source():
    """The build target lives in the git-ignored build/ directory of the
    checkout and its name carries a hash of the source and flags; nothing
    is compiled at import time."""
    for name in kernels.SOURCES:
        t = kernels._target(name)
        assert t.parent == kernels.build_dir()
        assert re.fullmatch(rf"lib{name}_[0-9a-f]{{16}}\.so", t.name)
    assert str(kernels.build_dir()) == os.path.join(ROOT, "build",
                                                    "volrend_torch")
    assert "build/" in open(os.path.join(ROOT, ".gitignore")).read()


def test_installed_package_builds_into_user_cache(tmp_path, monkeypatch):
    """Outside a checkout (an installed package) the libraries go to a
    per-user cache directory, never next to the installed sources."""
    site = tmp_path / "site-packages" / "volrend_torch" / "csrc"
    site.mkdir(parents=True)
    monkeypatch.setattr(kernels, "_CSRC", site)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert kernels.build_dir() == tmp_path / "cache" / "volrend_torch"


def test_render_options_copy_matches_reference():
    from volrend_tpu.utils.options import RenderOptions as JOpt
    import dataclasses
    a = dataclasses.asdict(RenderOptions())
    b = dataclasses.asdict(JOpt())
    assert a == b
