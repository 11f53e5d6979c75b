"""The port's headless batch renderer (``volrend_torch/cli/headless.py``)
and what it needs: the camera's pose-file readers, the PNG writer and the T1
NumPy oracle, against the reference's (``volrend_tpu``) on the CPU, on
tests/test_cli.py's scenes.

The CLI runs with ``--device cpu`` (the kernels' plain versions); its PNGs
are held to the port's own frames of the same files (the slab renderer's
byte for byte, the exact renderer's and the oracle's through the same
rounding), the exact renderer's PNGs to within one quantum of the
reference CLI's, and the NDC scene's slab PNG to test_cli.py's 30 dB gate
against the exact renderer's."""

import io
import os

import numpy as np
import pytest
import torch

from volrend_tpu.cli import headless as j_headless
from volrend_tpu.models import synthetic as j_synth
from volrend_tpu.ops import camera as j_camera
from volrend_tpu.ops import oracle as j_oracle
from volrend_tpu.utils import png as j_png
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch.cli import headless
from volrend_torch.models import synthetic as t_synth
from volrend_torch.ops import camera, dense_grid, oracle, render_exact
from volrend_torch.ops import slab_render
from volrend_torch.utils import png
from volrend_torch.utils.options import RenderOptions

torch.set_num_threads(1)


def _c2w(back, radius=2.5, up=(0.0, 0.0, 1.0)):
    back = np.asarray(back, np.float64)
    back /= np.linalg.norm(back)
    right = np.cross(up, back)
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, np.cross(back, right), back], 1)
    c2w[:3, 3] = radius * back
    return c2w


def _intrin(path, f):
    k = np.eye(4)
    k[0, 0] = k[1, 1] = f
    np.savetxt(path, k)


# ---------------------------------------------------------------------------
# Pose files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reverse_yz", [False, True])
def test_pose_readers_match_reference(tmp_path, reverse_yz):
    """3x4, 4x4 and 4Nx4 C2W files (and a 4N-1 row file whose last matrix
    has no homogeneous row): poses and basenames as the reference reads
    them, with and without -r; the intrinsics' fx, fy."""
    rng = np.random.default_rng(0)
    mats = [_c2w(rng.normal(size=3)) for _ in range(4)]
    files = {"p34.txt": mats[0][:3], "p44.txt": mats[1],
             "multi.txt": np.concatenate(mats[1:4]),
             "short.txt": np.concatenate(mats[2:4])[:-1]}
    paths = []
    for name, arr in files.items():
        paths.append(str(tmp_path / name))
        np.savetxt(paths[-1], arr)
    got, names = camera.poses_from_files(paths, reverse_yz)
    want, jnames = j_camera.poses_from_files(paths, reverse_yz)
    assert names == jnames and len(got) == 1 + 1 + 3 + 2
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == (3, 4)
        np.testing.assert_array_equal(a, b)
    _intrin(str(tmp_path / "k.txt"), 61.5)
    assert camera.read_intrins(str(tmp_path / "k.txt")) == \
        j_camera.read_intrins(str(tmp_path / "k.txt"))
    np.testing.assert_array_equal(camera.opencv_to_nerf(mats[0][:3]),
                                  j_camera.opencv_to_nerf(mats[0][:3]))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_round_trip(tmp_path, native, channels):
    """uint8 and float images written by both encoders read back equal by
    the reference's and the port's read_png; the Python encoder's bytes
    are the reference's."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (19, 23, channels), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    used = png.write_png(p, img, native=native)
    assert used == ("native" if native and png.native_error() is None
                    else "python")
    np.testing.assert_array_equal(j_png.read_png(p), img)
    np.testing.assert_array_equal(png.read_png(p), img)
    png.write_png(p, torch.tensor(img.astype(np.float32) / 255.0),
                  native=native)
    np.testing.assert_array_equal(j_png.read_png(p), img)
    if not native:
        q = str(tmp_path / "ref.png")
        j_png.write_png(q, img, native=False)
        assert open(p, "rb").read() == open(q, "rb").read()
        a, b = io.BytesIO(), io.BytesIO()
        png.write_png_bytes(a, img)
        j_png.write_png_bytes(b, img)
        assert a.getvalue() == b.getvalue()


def test_native_encoder_builds_into_the_build_dir():
    """The native encoder is built by g++ into the port's git-ignored build
    directory, keyed by a hash of its source, never into native/."""
    from volrend_torch import kernels
    png.write_png(os.devnull, np.zeros((2, 2, 3), np.uint8))
    if png.native_error() is not None:
        pytest.skip(f"no native encoder here: {png.native_error()}")
    t = png._NATIVE.target()
    assert t.parent == kernels.build_dir() and t.is_file()
    assert t.name.startswith("libvolrend_png_")


# ---------------------------------------------------------------------------
# The T1 oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["sh", "options", "depth"])
def test_oracle_matches_reference_and_exact(case):
    """The port's oracle against the reference's oracle (atol 1e-6) and
    against the exact renderer (atol 1e-5) on a 10x10 frame."""
    kw = dict(max_depth=3, basis_dim=4, seed=5, sigma_scale=60.0)
    tt, jt = t_synth.make_test_tree(**kw), j_synth.make_test_tree(**kw)
    o = {"sh": {}, "depth": dict(render_depth=True),
         "options": dict(rot_dirs=(0.3, -0.2, 0.5), basis_minmax=(1, 2),
                         render_bbox=(0.2,) * 3 + (0.8,) * 3)}[case]
    opt, jopt = RenderOptions(max_steps=512, **o), JOpt(max_steps=512, **o)
    cam = camera.Camera(10, 10, 12.0, 12.0,
                        _c2w((1.0, 0.2, 0.3))[:3].astype(np.float32))
    jcam = j_camera.Camera(10, 10, 12.0, 12.0, cam.transform)
    got = oracle.render_image(tt, cam, opt)
    want = j_oracle.render_image(jt, jcam, jopt)
    np.testing.assert_allclose(got, want, atol=1e-6)
    exact = render_exact.render_image(
        tt.to_device(lut_depth=None, device="cpu"), cam, opt).numpy()
    np.testing.assert_allclose(got, exact, atol=1e-5)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    """tests/test_cli.py's scene: the depth-3 SH4 tree, one 4x4 pose and a
    4x4 intrinsics file (f = 60), plus a second pose file."""
    d = tmp_path_factory.mktemp("scene")
    tree = t_synth.make_test_tree(max_depth=3, basis_dim=4, seed=5,
                                  sigma_scale=60.0)
    tree_path = str(d / "tree.npz")
    tree.save_npz(tree_path)
    poses = [str(d / "pose_000.txt"), str(d / "pose_001.txt")]
    np.savetxt(poses[0], _c2w((1.0, 0.2, 0.3)))
    np.savetxt(poses[1], _c2w((-0.4, 1.0, 0.5)))
    intrin = str(d / "intrinsics.txt")
    _intrin(intrin, 60.0)
    return tree, tree_path, poses, intrin


SIZE = 40


def _run(tmp_path, tree_path, poses, intrin, renderer, extra=(),
         module=headless, device=True):
    out_dir = str(tmp_path / f"out_{module.__name__.split('.')[0]}_"
                              f"{renderer}")
    argv = [tree_path, *poses, "-i", intrin, "-W", str(SIZE), "-H",
            str(SIZE), "-o", out_dir, "--renderer", renderer, *extra]
    rc = module.main(argv + (["--device", "cpu"] if device else []))
    assert rc == 0
    return out_dir


def _cams(poses, intrin, size=SIZE, scale=1.0):
    trans, names = camera.poses_from_files(poses)
    fx, fy = camera.read_intrins(intrin)
    w = int(size * scale)
    return [camera.Camera(w, w, fx * scale, fy * scale, t)
            for t in trans], names


def _opt():
    args = headless.build_parser().parse_args(["t.npz", "p.txt"])
    from volrend_torch.cli.opts import render_options_from_args
    return render_options_from_args(args).replace(max_steps=4096)


def test_cli_slab_matches_render_frames(scene_files, tmp_path, capsys):
    """``--renderer slab``: each PNG byte-equal to render_frames' uint8
    frame of its pose; the timing lines in the reference's format and the
    encoder named on stderr."""
    tree, tree_path, poses, intrin = scene_files
    out_dir = _run(tmp_path, tree_path, poses, intrin, "slab")
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert lines[0].endswith(" ms per frame") and lines[1].endswith(" fps")
    float(lines[0].split()[0])
    assert "png encoder" in err
    tdev = tree.to_device(lut_depth=None, device="cpu")
    grid = dense_grid.bake_dense(tdev)
    gi = slab_render.default_gi(grid)
    cams, names = _cams(poses, intrin)
    for cam, name in zip(cams, names):
        perm, flip, slope = slab_render.choose_axis(
            grid, cam.transform, cam.fx, cam.fy, SIZE, SIZE)
        assert slope < slab_render.MAX_SLAB_SLOPE
        want = slab_render.render_frames(
            grid, torch.tensor(cam.transform)[None], cam.fx, cam.fy, perm,
            flip, SIZE, SIZE, _opt(), gi=gi, out_dtype=torch.uint8)[0]
        got = png.read_png(os.path.join(out_dir, name + ".png"))
        np.testing.assert_array_equal(got, want.numpy())


def test_cli_exact_matches_render_image_and_reference(scene_files,
                                                      tmp_path):
    """``--renderer exact`` (at --scale 0.5 and --max_imgs 1): the PNG is
    render_image's frame rounded, and within one quantum of the reference
    CLI's PNG from the same files."""
    tree, tree_path, poses, intrin = scene_files
    extra = ("--scale", "0.5", "--max_imgs", "1")
    out_dir = _run(tmp_path, tree_path, poses, intrin, "exact", extra)
    assert sorted(os.listdir(out_dir)) == ["pose_000.png"]
    cams, names = _cams(poses, intrin, scale=0.5)
    want = png.rgba_to_bytes(render_exact.render_image(
        tree.to_device(lut_depth=None, device="cpu"), cams[0],
        _opt()).numpy())
    got = png.read_png(os.path.join(out_dir, "pose_000.png"))
    np.testing.assert_array_equal(got, want)
    ref_dir = _run(tmp_path, tree_path, poses, intrin, "exact", extra,
                   module=j_headless, device=False)
    ref = j_png.read_png(os.path.join(ref_dir, "pose_000.png"))
    assert np.abs(got.astype(np.int32) - ref).max() <= 1


def test_cli_oracle_matches_the_oracle(scene_files, tmp_path):
    """``--renderer oracle`` (12x12): the PNG is the port's oracle frame
    rounded, within one quantum of the exact renderer's."""
    tree, tree_path, poses, intrin = scene_files
    out_dir = str(tmp_path / "oracle")
    rc = headless.main([tree_path, poses[0], "-i", intrin, "-W", "12", "-H",
                        "12", "-o", out_dir, "--renderer", "oracle",
                        "--device", "cpu"])
    assert rc == 0
    cam = _cams(poses[:1], intrin, size=12)[0][0]
    got = png.read_png(os.path.join(out_dir, "pose_000.png"))
    want = oracle.render_image(tree, cam, _opt())
    np.testing.assert_array_equal(got, png.rgba_to_bytes(want))
    exact = render_exact.render_image(
        tree.to_device(lut_depth=None, device="cpu"), cam, _opt()).numpy()
    assert np.abs(got.astype(np.int32)
                  - png.rgba_to_bytes(exact)).max() <= 1


def test_cli_ndc_scene(tmp_path):
    """tests/test_cli.py:84-137: an LLFF/NDC scene (sidecar
    *_poses_bounds.npy): the slab renderer's PNG against the exact
    renderer's at test_cli.py's 30 dB gate."""
    tree = t_synth.make_test_tree(max_depth=3, basis_dim=4, seed=4,
                                  sigma_scale=60.0)
    tree_path = str(tmp_path / "ndc_tree.npz")
    tree.save_npz(tree_path)
    block = np.zeros((3, 5))
    block[:, 0] = [0.0, -1.0, 0.0]      # -up
    block[:, 1] = [1.0, 0.0, 0.0]       # right
    block[:, 2] = [0.0, 0.0, 1.0]       # backward
    block[:, 3] = [0.0, 0.0, 0.5]       # cen sum
    block[:, 4] = [800.0, 800.0, 1111.0]
    row = np.concatenate([block.reshape(-1), [1.0, 10.0]])
    np.save(str(tmp_path / "ndc_tree_poses_bounds.npy"), row[None])
    c2w = _c2w((0.05, 0.02, 1.0), up=(0.0, 1.0, 0.0))
    c2w[:3, 3] = [0.0, 0.0, 0.2]
    pose = str(tmp_path / "pose_000.txt")
    np.savetxt(pose, c2w)
    intrin = str(tmp_path / "intrinsics.txt")
    _intrin(intrin, 52.0)
    outs = {}
    for renderer in ("slab", "exact"):
        out_dir = str(tmp_path / f"out_{renderer}")
        assert headless.main([tree_path, pose, "-i", intrin, "-W", "48",
                              "-H", "48", "-o", out_dir, "--renderer",
                              renderer, "--gi", "128", "--device",
                              "cpu"]) == 0
        outs[renderer] = png.read_png(
            os.path.join(out_dir, "pose_000.png")).astype(np.float32)
    a, b = outs["slab"][..., :3], outs["exact"][..., :3]
    assert (a.min(-1) < 250).mean() > 0.1          # scene visible
    mse = float(np.mean(((a - b) / 255.0) ** 2))
    psnr = 99.0 if mse < 1e-12 else -10.0 * np.log10(mse)
    assert psnr > 30.0, f"NDC headless slab-vs-exact {psnr:.1f} dB"


def test_cli_needs_poses_and_a_device(scene_files, capsys):
    """No pose files: exit code 1 and the reference's message. Without a
    card and without --device cpu the CLI raises instead of running on
    the CPU."""
    _, tree_path, poses, _ = scene_files
    assert headless.main([tree_path, "--device", "cpu"]) == 1
    assert "No poses specified" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        headless.main([tree_path, poses[0]])
