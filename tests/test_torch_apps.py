"""The port's application CLIs against the reference's (``volrend_tpu``) on
the CPU: the animation renderer (``cli/animate.py``), the octree compressor
(``cli/compress.py``), the dataset pose extractor
(``cli/extract_poses.py``) and the offline HTML export
(``cli/export_html.py``).

The port's slab renderer bakes int8 (the bench's main path); the
reference's CLIs bake f16, so where frames are held to the reference CLI's
the reference's ``dense_grid.bake_dense`` is called with ``dtype="int8"``
for the run (a test-side wrapper; the reference is not edited).

Tolerances: the exact renderer's frames within one uint8 quantum of the
reference CLI's (as tests/test_torch_headless.py); the slab renderer's at
tests/test_torch_frames.py's gate, rgb PSNR >= 45 dB and alpha within 2e-2
(the reference's bf16 warp against the port's f32 one). The port's slab
frames are also held byte for byte to its own ``render_image`` of the same
cameras, through the same int8 bake and RGBA8 emit."""

import base64
import functools
import json
import os
import re
import zipfile

import numpy as np
import pytest
import torch

from volrend_tpu import anim as j_anim
from volrend_tpu.cli import animate as j_animate
from volrend_tpu.cli import compress as j_compress
from volrend_tpu.cli import export_html as j_export
from volrend_tpu.cli import extract_poses as j_extract
from volrend_tpu.ops import dense_grid as j_dense_grid
from volrend_torch.cli import animate, compress, export_html, extract_poses
from volrend_torch.models.n3tree import N3Tree
from volrend_torch.models.synthetic import make_test_tree
from volrend_torch.ops import dense_grid, slab_render
from volrend_torch.ops.camera import Camera
from volrend_torch.utils.options import RenderOptions
from volrend_torch.utils.png import read_png

from _torch_scenes import frames_agree

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tree_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("apps")
    tree = make_test_tree(max_depth=3, basis_dim=4, seed=5, sigma_scale=60.0)
    path = str(d / "tree.npz")
    tree.save_npz(path)
    return tree, path


@pytest.fixture
def ref_int8(monkeypatch):
    """The reference's bake forced to int8 (its CLIs bake f16)."""
    monkeypatch.setattr(j_dense_grid, "bake_dense", functools.partial(
        j_dense_grid.bake_dense, dtype="int8"))


# ---------------------------------------------------------------------------
# The animation CLI
# ---------------------------------------------------------------------------

SCRIPT = {
    "fps": 3,
    "keyframes": [
        {"center": [2.5, 0, 0.6], "v_back": [1, 0, 0.24], "fx": 40.0},
        {"center": [0, 2.5, 0.6], "v_back": [0, 1, 0.24], "fx": 40.0,
         "t_max": 1.0, "options": {"background_brightness": 0.5}},
        {"center": [-1.5, 1.5, 1.5], "v_back": [-1, 1, 1], "fx": 48.0,
         "t_max": 0.7, "loops": 1},
    ],
}


def _script(tmp_path) -> str:
    sp = str(tmp_path / "script.json")
    with open(sp, "w") as f:
        json.dump(SCRIPT, f)
    return sp


@pytest.mark.parametrize("renderer", ["slab", "exact"])
def test_animate_matches_reference_cli(tree_file, tmp_path, renderer,
                                       ref_int8):
    """Every frame of the port's CLI agrees with the reference CLI's from
    the same script (frames_agree); on the slab renderer each frame also
    equals the port's render_image of the interpolated camera (int8 bake, the
    CLI's gi, RGBA8) byte for byte."""
    _, tp = tree_file
    sp = _script(tmp_path)
    argv = [tp, sp, "-W", "32", "-H", "32", "--renderer", renderer,
            "--gi", "128"]
    out = str(tmp_path / "port")
    ref = str(tmp_path / "ref")
    assert animate.main(argv + ["-o", out, "--device", "cpu"]) == 0
    assert j_animate.main(argv + ["-o", ref]) == 0
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(out)) == names and len(names) == 7
    frames = [read_png(os.path.join(out, n)) for n in names]
    for n, got in zip(names, frames):
        frames_agree(got, read_png(os.path.join(ref, n)), renderer)
    assert not np.array_equal(frames[0], frames[-1])
    if renderer == "exact":
        return
    tree = N3Tree(tp)
    grid = dense_grid.bake_dense(tree.to_device(lut_depth=None,
                                                device="cpu"), dtype="int8")
    kfs, cfg = j_anim.load_script(sp)
    up = np.asarray((0.0, 0.0, 1.0))
    n_slab = 0
    for n, (seg, q) in zip(names, j_anim.frame_times(kfs, cfg["fps"])):
        center, v_back, fx, fy, opt, _ = j_anim.interpolate(
            kfs[seg], kfs[seg + 1], q, up, first_segment=(seg == 0))
        cam = Camera.from_vectors(center=tuple(center), v_back=tuple(v_back),
                                  width=32, height=32, fx=fx, fy=fy)
        if not slab_render.compatible(grid, cam.transform, fx, fy, 32, 32):
            continue
        o = RenderOptions(**{k: v for k, v in vars(opt).items()})
        want = slab_render.render_image(grid, cam, o.replace(max_steps=4096),
                                        gi=128, out_dtype=torch.uint8)
        np.testing.assert_array_equal(read_png(os.path.join(out, n)), want)
        n_slab += 1
    assert n_slab >= 4


# ---------------------------------------------------------------------------
# The compress CLI (tests/test_compress.py:106) and parity
# ---------------------------------------------------------------------------

def test_compress_cli(tree_file, tmp_path):
    tree = make_test_tree(max_depth=3, basis_dim=4, seed=9, sigma_scale=60.0)
    src = str(tmp_path / "t.npz")
    tree.save_npz(src)
    out = str(tmp_path / "out")
    rc = compress.main([src, "--out_dir", out, "--bits", "8", "--retain",
                        "1"])
    assert rc == 0
    dec = N3Tree(str(tmp_path / "out" / "t.npz"))
    assert dec.data is not None


def _members(path):
    """An npz's members and their uncompressed bytes (the archive's zip
    headers carry the write time, the members do not)."""
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


@pytest.mark.parametrize("flags", [
    ["--bits", "8", "--retain", "1"],
    ["--bits", "6", "--retain", "2", "--weighted", "--sigma_thresh", "1.0"],
    ["--noquant"],
], ids=["bits8", "weighted", "noquant"])
def test_compress_matches_reference_cli(tmp_path, flags):
    """Each member of the compressed npz byte-equal to the reference CLI's
    from the same input and flags."""
    tree = make_test_tree(max_depth=3, basis_dim=4, seed=9, sigma_scale=60.0)
    src = str(tmp_path / "t.npz")
    tree.save_npz(src)
    out, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    assert compress.main([src, "--out_dir", out, *flags]) == 0
    assert j_compress.main([src, "--out_dir", ref, *flags]) == 0
    a, b = _members(os.path.join(out, "t.npz")), _members(
        os.path.join(ref, "t.npz"))
    assert list(a) == list(b)
    for n in a:
        assert a[n] == b[n], n


# ---------------------------------------------------------------------------
# The pose extractor (tests/test_tools.py) and parity
# ---------------------------------------------------------------------------

def _write_synthetic_dataset(root, n_frames=3):
    scene = os.path.join(root, "lego")
    os.makedirs(scene, exist_ok=True)
    for split in ("test", "train"):
        frames = []
        for i in range(n_frames):
            th = 2 * np.pi * i / n_frames
            c2w = np.eye(4)
            c2w[:3, :3] = np.array([[np.cos(th), -np.sin(th), 0],
                                    [np.sin(th), np.cos(th), 0], [0, 0, 1]])
            c2w[:3, 3] = [3 * np.cos(th), 3 * np.sin(th), 1.0]
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(scene, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)
    return scene


def test_extract_test_poses(tmp_path):
    scene = _write_synthetic_dataset(str(tmp_path))
    n = extract_poses.extract_test_poses(str(tmp_path))
    assert n == 1
    pose = np.loadtxt(os.path.join(scene, "pose", "r_0.txt"))
    assert pose.shape == (4, 4)
    K = np.loadtxt(os.path.join(scene, "intrinsics.txt"))
    assert abs(K[0, 0] - 400 / np.tan(0.5 * 0.6911)) < 1e-6


def test_extract_cams_drawlist(tmp_path):
    from volrend_torch.models.mesh import open_drawlist
    scene = _write_synthetic_dataset(str(tmp_path))
    n = extract_poses.extract_cams_drawlist(str(tmp_path))
    assert n == 1
    meshes = open_drawlist(os.path.join(scene, "lego_cams.draw.npz"))
    assert len(meshes) == 1
    assert meshes[0].n_verts == 3 * 5  # 3 frusta


def test_rotvec_roundtrip():
    from volrend_torch.models.mesh import _axis_angle_matrix
    rng = np.random.default_rng(2)
    for _ in range(20):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = rng.uniform(0.01, np.pi - 0.01)
        R = _axis_angle_matrix(axis * ang)[None]
        rv = extract_poses._rotmat_to_rotvec(R)[0]
        np.testing.assert_allclose(rv, axis * ang, atol=1e-5)


def test_extract_poses_matches_reference_cli(tmp_path):
    """``main`` in both modes: every pose txt and the intrinsics byte-equal
    to the reference CLI's, the drawlist's members too."""
    outs = {}
    for tag, mod in (("port", extract_poses), ("ref", j_extract)):
        root = str(tmp_path / tag)
        scene = _write_synthetic_dataset(root)
        assert mod.main([root, "--mode", "both"]) == 0
        files = {}
        for base, _, names in os.walk(scene):
            for n in names:
                if n.endswith(".txt"):
                    p = os.path.join(base, n)
                    files[os.path.relpath(p, scene)] = open(p, "rb").read()
        outs[tag] = (files, _members(os.path.join(scene,
                                                  "lego_cams.draw.npz")))
    assert len(outs["port"][0]) == 4
    assert outs["port"] == outs["ref"]


# ---------------------------------------------------------------------------
# The HTML export (tests/test_cli.py:139) and parity
# ---------------------------------------------------------------------------

def _frames_of(html: str, tmp_path, tag: str):
    out = []
    for i, s in enumerate(re.findall(r'"([A-Za-z0-9+/=]{100,})"', html)):
        p = tmp_path / f"{tag}_{i}.png"
        p.write_bytes(base64.b64decode(s))
        out.append(read_png(str(p)))
    return out


def test_export_html_offline_preview(tree_file, tmp_path):
    _, tree_path = tree_file
    out = str(tmp_path / "scene.html")
    rc = export_html.main([tree_path, "-o", out, "--frames", "3",
                           "--size", "32", "--device", "cpu"])
    assert rc == 0
    html = open(out).read()
    assert html.count("<canvas") == 1 and "FRAMES" in html
    n = len(re.findall(r'"[A-Za-z0-9+/=]{100,}"', html))
    assert n == 3


@pytest.mark.parametrize("renderer", ["slab", "exact"])
def test_export_html_matches_reference_cli(tree_file, tmp_path, renderer,
                                           ref_int8):
    """The embedded frames agree with the reference CLI's
    (frames_agree); on the slab renderer byte-equal to the port's
    render_image of the same orbit (int8 bake, RGBA8); the page around
    them the reference's."""
    _, tree_path = tree_file
    argv = [tree_path, "--frames", "4", "--size", "32", "--renderer",
            renderer]
    out, ref = str(tmp_path / "port.html"), str(tmp_path / "ref.html")
    assert export_html.main(argv + ["-o", out, "--device", "cpu"]) == 0
    assert j_export.main(argv + ["-o", ref]) == 0
    html, rhtml = open(out).read(), open(ref).read()
    got = _frames_of(html, tmp_path, "port")
    want = _frames_of(rhtml, tmp_path, "ref")
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        frames_agree(a, b, renderer)
    strip = r'"[A-Za-z0-9+/=]{100,}"'
    assert re.sub(strip, "", html) == re.sub(strip, "", rhtml)
    if renderer == "slab":
        tree = N3Tree(tree_path)
        grid = dense_grid.bake_dense(tree.to_device(lut_depth=None,
                                                    device="cpu"),
                                     dtype="int8")
        cache = {}
        for i, a in enumerate(got):
            th = 2 * np.pi * i / 4
            back = np.array([np.cos(th) * np.cos(0.45),
                             np.sin(th) * np.cos(0.45), np.sin(0.45)])
            cam = Camera.from_vectors(center=tuple(2.8 * back),
                                      v_back=tuple(back), width=32,
                                      height=32)
            np.testing.assert_array_equal(a, slab_render.render_image(
                grid, cam, RenderOptions(), payload_cache=cache,
                out_dtype=torch.uint8))
