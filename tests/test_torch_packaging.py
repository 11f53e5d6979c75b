"""Packaging and device contract of the PyTorch port (``volrend_torch``):
it imports neither JAX nor the JAX package, its entry points default to the
card and never drift to the CPU, and its kernel wrappers refuse what they
do not take instead of quietly running something else."""

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


def test_cuda_sources_name_their_tpu_kernel():
    """Each CUDA source opens with a note naming the TPU kernel it
    replaces, what bounds it on the card and its design."""
    want = {"slab_march.cu": "pallas_slab.py:_make_kernel",
            "slab_march_bwd.cu": "pallas_slab.py:_make_bwd_kernel",
            "warp_build.cu": "display_warp.py:_make_build",
            "warp_combine.cu": "display_warp.py:_make_combine_kernel"}
    for name, ref in want.items():
        head = open(os.path.join(ROOT, "volrend_torch", "csrc", name)
                    ).read()[:4000]
        assert ref in head, name
        assert "bounds it on the H100" in head, name
        assert "Design" in head, name
        assert name in kernels.SOURCES[name[:-3]][0]


@pytest.mark.parametrize("entry", ["to_device", "bake_dense", "resolve"])
def test_entry_points_default_to_cuda(entry):
    """Called without ``device=`` on a machine with no card, the entry
    points raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from volrend_torch.models.synthetic import make_test_tree
    from volrend_torch.ops import dense_grid
    from volrend_torch.utils.device import resolve
    tree = make_test_tree(max_depth=1, basis_dim=1, seed=0)
    call = {"to_device": lambda: tree.to_device(),
            "bake_dense": lambda: dense_grid.bake_dense(tree),
            "resolve": lambda: resolve(None)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    # asking for the CPU explicitly works
    assert tree.to_device(device="cpu").data.device.type == "cpu"


def _march_args(**over):
    G, bd = 4, 4
    D = 3 * bd + 1
    kw = dict(gplanar=torch.zeros((G, D + 1, G, G), dtype=torch.int8),
              params=torch.zeros((1, 30)), qscale=torch.ones(D + 1),
              zbounds=torch.zeros((1, 2, 8, 8)), G=G, gi=8, D=D, bd=bd,
              perm=(0, 1, 2), sig2=True, bbox_full=True, dir_win=True)
    kw.update(over)
    return kw


@pytest.mark.parametrize("option", [
    dict(fmt=2), dict(depth=True), dict(rot=tuple(np.eye(3).ravel())),
    dict(bbox_full=False), dict(basis_hi=8), dict(sig2=False),
    dict(shade_bf16=True), dict(dir_win=False), dict(acc_init=0.0),
])
def test_march_refuses_later_slices_options(option):
    """Kernel M's wrapper raises on every option it does not take (it does
    not run some other path instead)."""
    with pytest.raises(NotImplementedError, match="slices B-D"):
        slab_march.march_slabs(**_march_args(**option))


def test_march_default_options_run_on_cpu():
    acc = slab_march.march_slabs(**_march_args())
    assert tuple(acc.shape) == (1, 4, 8, 8)


def _train_args(**over):
    """The training path's option set: a bf16 payload with Dp = D and
    per-slab view directions."""
    kw = _march_args(sig2=False, dir_win=False)
    kw["gplanar"] = torch.zeros((4, kw["D"], 4, 4), dtype=torch.bfloat16)
    kw["qscale"] = torch.ones(kw["D"])
    kw.update(over)
    return kw


@pytest.mark.parametrize("option", [
    dict(dir_win=True), dict(depth=True), dict(shade_bf16=True),
    dict(rot=tuple(np.eye(3).ravel())), dict(bbox_full=False),
    dict(z_base=0.5),
])
def test_march_training_mode_refuses_other_options(option):
    """On the training payload the wrapper also raises on every option it
    does not take (window directions on bf16 are the display path's
    f16-bake route, slice B)."""
    with pytest.raises(NotImplementedError, match="slices B-D"):
        slab_march.march_slabs(**_train_args(**option))


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
