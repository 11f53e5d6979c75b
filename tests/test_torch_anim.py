"""The port's keyframe animation (``volrend_torch/anim.py``) against the
reference's (``volrend_tpu/anim.py``) on the CPU: tests/test_anim.py's
cases on the port, and the keyframe math bit-equal between the packages
(``sphc_interp``, ``interpolate``, ``frame_times``, ``load_script``, on
scripts either package reads)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from volrend_tpu import anim as j_anim
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch import anim
from volrend_torch.anim import (AnimKF, frame_times, interpolate,
                                load_script, sphc_interp)
from volrend_torch.utils.options import RenderOptions

torch.set_num_threads(1)

AX = np.array([1.0, 0, 0])
AY = np.array([0, 1.0, 0])
AZ = np.array([0, 0, 1.0])


# ---------------------------------------------------------------------------
# tests/test_anim.py on the port
# ---------------------------------------------------------------------------

def test_sphc_endpoints():
    a = np.array([2.0, 0.0, 0.0])
    b = np.array([0.0, 3.0, 0.0])
    np.testing.assert_allclose(sphc_interp(a, b, 0.0, AX, AY, AZ), a,
                               atol=1e-12)
    np.testing.assert_allclose(sphc_interp(a, b, 1.0, AX, AY, AZ), b,
                               atol=1e-12)


def test_sphc_arc_radius():
    a = np.array([2.0, 0.0, 0.0])
    b = np.array([0.0, 2.0, 0.0])
    mid = sphc_interp(a, b, 0.5, AX, AY, AZ)
    np.testing.assert_allclose(np.linalg.norm(mid), 2.0, atol=1e-12)
    np.testing.assert_allclose(mid, 2.0 * np.array(
        [np.cos(np.pi / 4), np.sin(np.pi / 4), 0]), atol=1e-12)


def test_sphc_shortest_path_wrap():
    a = np.array([np.cos(0.1), np.sin(0.1), 0.0])
    b = np.array([np.cos(-0.1), np.sin(-0.1), 0.0])
    mid = sphc_interp(a, b, 0.5, AX, AY, AZ)
    np.testing.assert_allclose(mid, [1, 0, 0], atol=1e-9)  # through 0, not pi


def test_sphc_loops():
    a = np.array([1.0, 0.0, 0.0])
    q = sphc_interp(a, a, 0.25, AX, AY, AZ, loops=1)
    np.testing.assert_allclose(q, [0, 1, 0], atol=1e-9)  # quarter loop CCW


def test_interpolate_options_lerp():
    k0 = AnimKF(center=np.array([3.0, 0, 0]), v_back=np.array([1.0, 0, 0]),
                opt=RenderOptions(background_brightness=0.0, step_size=1e-4))
    k1 = AnimKF(center=np.array([0.0, 3, 0]), v_back=np.array([0.0, 1, 0]),
                opt=RenderOptions(background_brightness=1.0, step_size=3e-4))
    c, vb, fx, fy, opt, ms = interpolate(k0, k1, 0.5, (0, 0, 1),
                                         first_segment=True)
    np.testing.assert_allclose(np.linalg.norm(c), 3.0, atol=1e-9)
    assert abs(opt.background_brightness - 0.5) < 1e-9
    assert abs(opt.step_size - 2e-4) < 1e-12


def test_frame_times():
    kfs = [AnimKF(center=np.zeros(3), v_back=np.array([1.0, 0, 0])),
           AnimKF(center=np.zeros(3), v_back=np.array([1.0, 0, 0]),
                  t_max=1.0)]
    ft = frame_times(kfs, fps=10)
    assert len(ft) == 11
    assert ft[0] == (0, 0.0) and ft[-1] == (0, 1.0)


def test_anim_cli(tmp_path):
    from volrend_torch.cli import animate
    from volrend_torch.models.synthetic import make_test_tree
    from volrend_torch.utils.png import read_png

    tree = make_test_tree(max_depth=3, basis_dim=4, seed=5, sigma_scale=60.0)
    tp = str(tmp_path / "tree.npz")
    tree.save_npz(tp)
    script = {
        "fps": 4,
        "keyframes": [
            {"center": [2.5, 0, 0.5], "v_back": [1, 0, 0.2], "fx": 60.0},
            {"center": [0, 2.5, 0.5], "v_back": [0, 1, 0.2], "fx": 60.0,
             "t_max": 1.0},
        ],
    }
    sp = str(tmp_path / "script.json")
    with open(sp, "w") as f:
        json.dump(script, f)
    out = str(tmp_path / "frames")
    rc = animate.main([tp, sp, "-W", "32", "-H", "32", "-o", out,
                       "--renderer", "exact", "--device", "cpu"])
    assert rc == 0
    img = read_png(str(tmp_path / "frames" / "000000.png"))
    assert img.shape == (32, 32, 4)
    img_last = read_png(str(tmp_path / "frames" / "000004.png"))
    assert not np.array_equal(img, img_last)


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------

def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def test_sphc_interp_bit_equal():
    """Random vectors, zero-length ends, wraps and loops: the same float64
    bits as the reference's."""
    rng = np.random.default_rng(3)
    axes = []
    for _ in range(4):
        az = _unit(rng.normal(size=3))
        ax = _unit(np.cross(az, rng.normal(size=3)))
        axes.append((ax, np.cross(az, ax), az))
    cases = [(rng.normal(size=3) * 2, rng.normal(size=3) * 3)
             for _ in range(12)]
    cases += [(np.zeros(3), np.ones(3)), (np.ones(3), np.zeros(3)),
              (np.zeros(3), np.zeros(3))]
    for i, (a, b) in enumerate(cases):
        ax, ay, az = axes[i % len(axes)]
        for q in (0.0, 0.3, 0.5, 1.0):
            for loops in (0, 2):
                got = anim.sphc_interp(a, b, q, ax, ay, az, loops)
                want = j_anim.sphc_interp(a, b, q, ax, ay, az, loops)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


def _kf_pair(mod, Opt, seed):
    """Two keyframes with every interpolated field set, from ``seed``."""
    rng = np.random.default_rng(seed)

    def kf(i, show):
        o = Opt(background_brightness=float(rng.uniform()),
                step_size=float(rng.uniform(1e-4, 1e-3)),
                stop_thresh=float(rng.uniform(1e-3, 1e-1)),
                sigma_thresh=float(rng.uniform(1e-3, 1e-1)),
                render_bbox=tuple(float(v) for v in np.concatenate(
                    [rng.uniform(0, 0.3, 3), rng.uniform(0.7, 1, 3)])),
                enable_probe=True,
                probe=tuple(float(v) for v in rng.normal(size=3)),
                show_grid=show, grid_max_depth=int(2 + 3 * i),
                rot_dirs=tuple(float(v) for v in rng.normal(size=3) * 0.3))
        ms = {"Cube": mod.MeshState(rotation=rng.normal(size=3),
                                    translation=rng.normal(size=3),
                                    scale=float(rng.uniform(0.5, 2)),
                                    visible=bool(i), unlit=not i)}
        if i:
            ms["Extra"] = mod.MeshState(scale=0.5)
        return mod.AnimKF(center=rng.normal(size=3) * 3,
                          v_back=_unit(rng.normal(size=3)),
                          origin=rng.normal(size=3) * 0.1,
                          fx=float(rng.uniform(300, 1200)),
                          fy=float(rng.uniform(300, 1200)), opt=o,
                          mesh_state=ms, t_max=float(rng.uniform(0.5, 2)),
                          spherical_interp=bool(seed % 2 == 0),
                          loops=int(seed % 3))

    return kf(0, bool(seed % 2)), kf(1, True)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_interpolate_bit_equal(seed):
    """Camera, focal lengths, every lerped option and the mesh states equal
    the reference's bit for bit, spherical and linear, first segment and
    not."""
    k0, k1 = _kf_pair(anim, RenderOptions, seed)
    j0, j1 = _kf_pair(j_anim, JOpt, seed)
    up = _unit(np.random.default_rng(seed + 10).normal(size=3))
    for q in (0.0, 0.25, 0.7, 1.0):
        for first in (True, False):
            got = anim.interpolate(k0, k1, q, up, first_segment=first)
            want = j_anim.interpolate(j0, j1, q, up, first_segment=first)
            for a, b in zip(got[:2], want[:2]):
                np.testing.assert_array_equal(a, b)
            assert got[2:4] == want[2:4]
            assert dataclasses.asdict(got[4]) == dataclasses.asdict(want[4])
            assert sorted(got[5]) == sorted(want[5])
            for name in got[5]:
                a, b = got[5][name], want[5][name]
                for f in ("rotation", "translation"):
                    np.testing.assert_array_equal(getattr(a, f),
                                                  getattr(b, f))
                assert (a.scale, a.visible, a.unlit) == (b.scale, b.visible,
                                                         b.unlit)


def test_frame_times_equal():
    rng = np.random.default_rng(5)
    for n in (2, 3, 5):
        t = rng.uniform(0.1, 2.0, n)
        kfs = [AnimKF(center=np.zeros(3), v_back=AX, t_max=float(x))
               for x in t]
        jkfs = [j_anim.AnimKF(center=np.zeros(3), v_back=AX, t_max=float(x))
                for x in t]
        for fps in (4.0, 24.0, 30.0):
            assert frame_times(kfs, fps) == j_anim.frame_times(jkfs, fps)


def test_load_script_equal(tmp_path):
    """A script with options and meshes loads to the same keyframes in
    both packages."""
    script = {
        "fps": 12, "world_up": [0, 1, 0],
        "keyframes": [
            {"center": [2.5, 0, 0.5], "v_back": [1, 0, 0.2], "fx": 60.0,
             "options": {"background_brightness": 0.2,
                         "render_bbox": [0.1, 0, 0, 1, 1, 0.9],
                         "rot_dirs": [0.0, 0.1, 0.0]},
             "meshes": {"Cube": {"rotation": [0, 0.2, 0], "scale": 2.0,
                                 "unlit": True}}},
            {"center": [0, 2.5, 0.5], "v_back": [0, 1, 0.2], "fx": 60.0,
             "fy": 70.0, "t_max": 1.5, "loops": 1, "origin": [0, 0, 0.1],
             "spherical_interp": False},
        ],
    }
    sp = str(tmp_path / "s.json")
    with open(sp, "w") as f:
        json.dump(script, f)
    kfs, cfg = load_script(sp)
    jkfs, jcfg = j_anim.load_script(sp)
    assert cfg == jcfg and len(kfs) == len(jkfs) == 2
    for a, b in zip(kfs, jkfs):
        for f in ("center", "v_back", "origin"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.fx, a.fy, a.t_max, a.spherical_interp, a.loops) == \
            (b.fx, b.fy, b.t_max, b.spherical_interp, b.loops)
        assert dataclasses.asdict(a.opt) == dataclasses.asdict(b.opt)
        assert sorted(a.mesh_state) == sorted(b.mesh_state)
        for name in a.mesh_state:
            assert repr(a.mesh_state[name]) == repr(b.mesh_state[name])
