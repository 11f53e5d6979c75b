"""The port's host utilities against the reference's (``volrend_tpu``) on
the CPU: profiling (``utils/profiling.py``), Morton codes
(``utils/morton.py``), SH-lobe meshes (``utils/sh_mesh.py``) and the
native npz loader (``io/native_npz.py``, built by g++ into the port's build
directory and read by ``N3Tree.open``)."""

import json

import numpy as np
import pytest
import torch

from volrend_tpu.utils import morton as j_morton
from volrend_tpu.utils import sh_mesh as j_sh_mesh
from volrend_torch import kernels
from volrend_torch.io import native_npz
from volrend_torch.utils import morton, sh_mesh
from volrend_torch.utils.profiling import (FrameTimer, Metrics, fps_counter,
                                           sync, trace)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# Profiling (tests/test_aux.py's three, on torch tensors)
# ---------------------------------------------------------------------------

def test_frame_timer():
    t = FrameTimer(100, 100)
    t.start()
    x = torch.ones((8,))
    for _ in range(3):
        t.frame()
    t.stop(x)
    assert t.n_frames == 3
    assert t.elapsed > 0
    assert t.mrays_per_s > 0
    assert "ms per frame" in t.report()


def test_metrics(tmp_path):
    m = Metrics()
    m.log(0, loss=1.0, psnr=20.0)
    m.log(1, loss=0.5, psnr=25.0)
    p = str(tmp_path / "m.json")
    m.dump(p)
    hist = json.load(open(p))
    assert hist[1]["loss"] == 0.5


def test_fps_counter():
    c = fps_counter(window=5)
    for _ in range(10):
        c.tick()
    assert c.tick() > 0


def test_sync_and_trace(tmp_path):
    """``sync`` takes host data and CPU tensors (nothing to wait for);
    ``trace`` writes a Chrome trace of the region with its ops."""
    sync(np.ones(3))
    sync(torch.ones(3))
    with trace(str(tmp_path / "tr")):
        torch.matmul(torch.ones((16, 16)), torch.ones((16, 16)))
    doc = json.load(open(tmp_path / "tr" / "trace.json"))
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any("matmul" in n or "mm" in n for n in names), sorted(names)[:20]


# ---------------------------------------------------------------------------
# Morton codes (tests/test_tools.py:12-35) and parity
# ---------------------------------------------------------------------------

def test_morton_roundtrip():
    rng = np.random.default_rng(0)
    x, y, z = (rng.integers(0, 1 << 21, 1000) for _ in range(3))
    code = morton.morton_code_3(x, y, z)
    rx, ry, rz = morton.inv_morton_code_3(code)
    np.testing.assert_array_equal(rx, x)
    np.testing.assert_array_equal(ry, y)
    np.testing.assert_array_equal(rz, z)
    # locality: adjacent cells differ in low bits
    assert morton.morton_code_3(0, 0, 1) == 1
    assert morton.morton_code_3(0, 1, 0) == 2
    assert morton.morton_code_3(1, 0, 0) == 4


def test_ray_morton_order_groups_neighbors():
    pts = np.array([[0.9, 0.9, 0.9], [0.1, 0.1, 0.1],
                    [0.11, 0.1, 0.11], [0.89, 0.9, 0.91]])
    order = morton.ray_morton_order(pts)
    pairs = {tuple(sorted(order[:2])), tuple(sorted(order[2:]))}
    assert pairs == {(1, 2), (0, 3)}


def test_morton_matches_reference():
    """Codes, their inverse and the ray order equal the reference's."""
    rng = np.random.default_rng(1)
    x, y, z = (rng.integers(0, 1 << 21, 4096) for _ in range(3))
    code = morton.morton_code_3(x, y, z)
    np.testing.assert_array_equal(code, j_morton.morton_code_3(x, y, z))
    for a, b in zip(morton.inv_morton_code_3(code),
                    j_morton.inv_morton_code_3(code)):
        np.testing.assert_array_equal(a, b)
    pts = rng.uniform(size=(2048, 3))
    for grid in (16, 1024):
        np.testing.assert_array_equal(morton.ray_morton_order(pts, grid),
                                      j_morton.ray_morton_order(pts, grid))


# ---------------------------------------------------------------------------
# SH-lobe meshes
# ---------------------------------------------------------------------------

def test_sh_lobe_mesh(tmp_path):
    from volrend_torch.models.mesh import load_basic_obj
    m = sh_mesh.sh_lobe_mesh(6, rings=8, sectors=12)
    assert m.n_verts == 96
    r = np.linalg.norm(m.vert[:, :3], axis=-1)
    assert r.max() > 0.1  # lobe has extent
    p = str(tmp_path / "sh6.obj")
    sh_mesh.save_obj(m, p)
    back = load_basic_obj(p)
    np.testing.assert_allclose(back.vert[:, :3], m.vert[:, :3], atol=1e-5)
    np.testing.assert_allclose(back.vert[:, 3:6], m.vert[:, 3:6], atol=1e-3)


@pytest.mark.parametrize("k", [0, 3, 6, 15, 24])
def test_sh_lobe_mesh_matches_reference(k, tmp_path):
    """Vertices, faces and the OBJ text equal the reference's for lobes of
    every SH degree."""
    m = sh_mesh.sh_lobe_mesh(k, rings=10, sectors=14, scale=1.5)
    jm = j_sh_mesh.sh_lobe_mesh(k, rings=10, sectors=14, scale=1.5)
    assert m.name == jm.name
    np.testing.assert_array_equal(m.vert, jm.vert)
    np.testing.assert_array_equal(m.faces, jm.faces)
    a, b = str(tmp_path / "a.obj"), str(tmp_path / "b.obj")
    sh_mesh.save_obj(m, a)
    j_sh_mesh.save_obj(jm, b)
    assert open(a).read() == open(b).read()


# ---------------------------------------------------------------------------
# The native npz loader (tests/test_native_npz.py) and its build
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    d = tmp_path_factory.mktemp("npz")
    rng = np.random.default_rng(0)
    data = {
        "f32": rng.normal(size=(33, 7)).astype(np.float32),
        "f16": rng.normal(size=(2, 2, 2, 13)).astype(np.float16),
        "i32": rng.integers(-5, 5, (64,)).astype(np.int32),
        "u16": rng.integers(0, 60000, (31,)).astype(np.uint16),
        "scalar": np.int64(7),
        "string": np.str_("SH16"),
        "big": rng.normal(size=(1 << 20,)).astype(np.float32),
    }
    stored = str(d / "stored.npz")
    comp = str(d / "comp.npz")
    np.savez(stored, **data)
    np.savez_compressed(comp, **data)
    return stored, comp, data


def test_native_available():
    assert native_npz.available(), native_npz.native_error()
    assert native_npz.native_error() is None


@pytest.mark.parametrize("which", [0, 1])
def test_native_matches_numpy(archives, which):
    path = archives[which]
    got = native_npz.load_npz(path)
    ref = dict(np.load(path, allow_pickle=False).items())
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k])


def test_tree_open_uses_native(archives, tmp_path, monkeypatch):
    """N3Tree.open reads through the native loader, and the tree equals
    the one saved."""
    from volrend_torch.models.n3tree import N3Tree
    from volrend_torch.models.synthetic import make_test_tree
    tree = make_test_tree(max_depth=3, basis_dim=4, seed=1)
    p = str(tmp_path / "t.npz")
    tree.save_npz(p)
    calls = []
    orig = native_npz.load_npz
    monkeypatch.setattr(native_npz, "load_npz",
                        lambda path: calls.append(path) or orig(path))
    again = N3Tree(p)
    assert calls == [p]
    np.testing.assert_array_equal(again.child, tree.child)
    np.testing.assert_array_equal(again.data, tree.data)


def test_native_library_is_built_in_the_build_dir():
    """The loader's library lives in the port's git-ignored build
    directory, its name keyed by a hash of the source and flags; nothing
    is written beside ``native/npz_loader.cpp`` by the port."""
    assert native_npz.available()
    so = native_npz._NATIVE.target()
    assert so.parent == kernels.build_dir()
    assert so.name.startswith("libvolrend_npz_") and so.is_file()
    assert native_npz._NATIVE.src.parent.name == "native"


def test_native_failed_build_reads_with_numpy(archives, monkeypatch):
    """A loader that does not build (here: no source) leaves numpy.load
    reading, and says why."""
    from volrend_torch.utils.native import HostLib
    monkeypatch.setattr(native_npz, "_NATIVE", HostLib(
        "no_such_loader.cpp", "libvolrend_npz", lambda lib: None))
    got = native_npz.load_npz(archives[1])
    assert not native_npz.available()
    assert "no_such_loader.cpp not found" in native_npz.native_error()
    for k, v in archives[2].items():
        np.testing.assert_array_equal(got[k], v)
