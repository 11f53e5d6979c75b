"""The port's measurement probes (``volrend_torch/probes/``) against the
reference's probes under ``tools/``, on the CPU (the probe kernels' plain
versions; the reference's Pallas kernels in interpret mode).

- P7 (``perf_sq3.combine_probe``) against ``tools/perf_sq3.py``'s
  ``combine_pallas``: f32 both, another summation order: atol 1e-5;
- P8 (``perf_overlap.stream_probe``) against a verbatim copy of the
  reference's ``dma_kernel`` and grid spec (``dma_once`` is a closure of
  ``tools/perf_overlap.py:main`` and cannot be imported): exact, as are
  the window sums against numpy;
- P9 (``perf_sq4.build_probe``, both layouts) against
  ``tools/perf_sq4.py``'s ``build_pallas`` and ``build_pallas_planar``:
  bit-equal on the window rows (the reference's padding rows are
  undefined; the port's are zero);
- the whole ``perf_sq3`` warp against the reference's at 96^2, gi=48
  (atol 1e-5: both round the table to bf16 the same way and sum in f32),
  and ``perf_sq4``'s variants through the port's ``tail``.
"""

import functools
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from volrend_tpu.ops import display_warp as j_dw
from volrend_tpu.ops import slab_render as j_slab
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch.ops import display_warp, slab_render
from volrend_torch.ops.camera import Camera
from volrend_torch.probes import perf_overlap, perf_sq3, perf_sq4
from volrend_torch.utils.options import RenderOptions

from _torch_scenes import interpret, scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)
import perf_sq3 as j_sq3  # noqa: E402  (tools/perf_sq3.py)
import perf_sq4 as j_sq4  # noqa: E402  (tools/perf_sq4.py)

torch.set_num_threads(1)

W = H = 96
GI = 48
FX = 134.4           # the superquad tests' 200^2 pose (fx 280), scaled
OPT = RenderOptions(max_steps=512)
JOPT = JOpt(max_steps=512)


def _bf16(x: np.ndarray) -> torch.Tensor:
    """``x`` rounded to bfloat16 (a torch tensor; its f32 values pass to
    JAX exactly)."""
    return torch.as_tensor(x.astype(np.float32)).to(torch.bfloat16)


def _bits(x) -> np.ndarray:
    """The 16-bit patterns of a bfloat16 torch tensor or JAX array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


# ---------------------------------------------------------------------------
# P7: the planar tent-combine
# ---------------------------------------------------------------------------

def test_chan_matches_reference():
    for cy in range(4):
        for cx in range(4):
            for c in range(4):
                assert perf_sq3.chan(cy, cx, c) == j_sq3.chan(cy, cx, c)
                assert perf_sq3.chan(cy, cx, c) == j_sq4._chan_idx(cy, cx, c)


def test_combine_probe_matches_combine_pallas():
    """Positions past the window [0, 3] on both sides (unclamped tents),
    masked subpixels and a background other than 1; Hh divisible by the
    reference's 8-row blocks."""
    Hh, Wh, bg = 16, 24, 0.7
    rng = np.random.default_rng(0)
    qgp = _bf16(rng.uniform(0.0, 1.0, (64, Hh, Wh)))
    ry = rng.uniform(-0.7, 3.7, (4, Hh, Wh)).astype(np.float32)
    rx = rng.uniform(-0.7, 3.7, (4, Hh, Wh)).astype(np.float32)
    okm = (rng.uniform(size=(4, Hh, Wh)) > 0.25).astype(np.float32)
    want = np.asarray(j_sq3.combine_pallas(
        jnp.asarray(qgp.float().numpy(), jnp.bfloat16), jnp.asarray(ry),
        jnp.asarray(rx), jnp.asarray(okm), Hh, Wh, 8, bg, True))
    got = perf_sq3.combine_probe(qgp, torch.as_tensor(ry),
                                 torch.as_tensor(rx), torch.as_tensor(okm),
                                 bg)
    assert got.shape == (16, Hh, Wh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # masked subpixels: the background, alpha 0
    off = okm == 0
    assert np.all(got.numpy()[3::4][off] == 0.0)
    assert np.all(got.numpy()[0::4][off] == np.float32(bg))


# ---------------------------------------------------------------------------
# P8: the payload stream
# ---------------------------------------------------------------------------

def _dma_once(pay, ids):
    """tools/perf_overlap.py:87-108 (dma_kernel and its grid spec),
    verbatim but for interpret mode and a grid over len(ids) windows."""
    G, Dp = pay.shape[0], pay.shape[1]

    def dma_kernel(ids_ref, slab_ref, o_ref):
        i = pl.program_id(0)

        @pl.when(i == 0)
        def _():
            o_ref[...] = jnp.zeros_like(o_ref)

        o_ref[...] += slab_ref[0, 0, :8, :128].astype(jnp.float32)

    return pl.pallas_call(
        dma_kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(ids.shape[0],),
            in_specs=[pl.BlockSpec((4, Dp, G, G),
                                   lambda i, ids: (ids[i], 0, 0, 0))],
        ),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        compiler_params=pltpu.CompilerParams(
            vmem_limit_bytes=100 * 1024 * 1024),
        interpret=True,
    )(ids, pay)


def test_stream_probe_matches_dma_kernel():
    G, Dp = 128, 3
    rng = np.random.default_rng(1)
    pay = rng.integers(-128, 128, (G, Dp, G, G), dtype=np.int8)
    ids = rng.permutation(G // 4)[:12].astype(np.int32)
    want = np.asarray(_dma_once(jnp.asarray(pay), jnp.asarray(ids)))
    out, sums = perf_overlap.stream_probe(torch.as_tensor(pay),
                                          torch.as_tensor(ids))
    assert out.dtype == torch.float32 and tuple(out.shape) == (8, 128)
    assert np.array_equal(out.numpy(), want)
    wsum = pay.reshape(G // 4, -1).astype(np.int64).sum(1)[ids]
    assert sums.dtype == torch.int64
    assert np.array_equal(sums.numpy(), wsum)


def test_stream_probe_refuses_bad_payloads():
    with pytest.raises(ValueError):        # G not a multiple of 4
        perf_overlap.stream_probe(torch.zeros((6, 3, 8, 128),
                                              dtype=torch.int8),
                                  torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):        # fewer than 128 columns
        perf_overlap.stream_probe(torch.zeros((8, 3, 8, 64),
                                              dtype=torch.int8),
                                  torch.zeros(1, dtype=torch.int32))
    pay = torch.zeros((8, 3, 8, 128), dtype=torch.int8)
    assert perf_overlap.stream_bytes(pay, 2) == 2 * 4 * 3 * 8 * 128 + 8 \
        + 8 * 128 * 4 + 16


# ---------------------------------------------------------------------------
# P9: the window-table build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("planar", [False, True])
def test_build_probe_matches_build_pallas(planar):
    """gi = 35: gi - 3 = 32 rows, two full 16-row blocks (a gi with a
    ragged last block makes the reference read past its input)."""
    gi = 35
    it = _bf16(np.random.default_rng(2).uniform(0.0, 1.0, (4, gi, gi)))
    jit = jnp.asarray(it.float().numpy(), jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = (j_sq4.build_pallas_planar(jit, gi) if planar
                else j_sq4.build_pallas(jit, gi))
    got = perf_sq4.build_probe(it, gi, planar=planar)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    n = gi - 3
    if planar:
        assert np.array_equal(_bits(got)[:, :n], _bits(want)[:, :n])
    else:
        assert np.array_equal(_bits(got)[:n], _bits(want)[:n])


@pytest.mark.parametrize("planar", [False, True])
def test_build_probe_pads_with_zeros(planar):
    """gi = 40: 37 window rows padded to 48; the port's padding rows are
    zero, the window rows are the input's cells in each layout's order."""
    gi, n = 40, 37
    it = _bf16(np.random.default_rng(3).uniform(0.0, 1.0, (4, gi, gi)))
    got = perf_sq4.build_probe(it, gi, planar=planar)
    assert perf_sq4.table_rows(gi) == (n, 48)
    src = it.float().numpy()
    cells = {(cy, cx, c): src[c, cy:cy + n, cx:cx + n]
             for cy in range(4) for cx in range(4) for c in range(4)}
    g = got.float().numpy()
    for (cy, cx, c), v in cells.items():
        if planar:
            assert np.array_equal(g[perf_sq3.chan(cy, cx, c), :n], v)
        else:
            assert np.array_equal(g[:n, :, (cy * 4 + cx) * 4 + c], v)
    pad = g[:, n:] if planar else g[n:]
    assert pad.size and np.all(pad == 0.0)


# ---------------------------------------------------------------------------
# The whole perf_sq3 warp, and perf_sq4's variants through the port's tail
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _geom():
    """Both packages' FrameGeom of one 96^2 pose (the reference's jitted),
    perm, and a seeded (gi, gi, 4) intermediate image (shared, read
    only)."""
    _, g, _, jg = scene("dense", 4, "int8")
    back = np.asarray((1.0, 0.25, 0.35))
    back /= np.linalg.norm(back)
    cam = Camera.from_vectors(center=tuple(2.5 * back), v_back=tuple(back),
                              v_world_up=(0.0, 0.0, 1.0), width=W,
                              height=H, fx=FX)
    perm, flip, _ = j_slab.choose_axis(jg, cam.transform, cam.fx, cam.fy,
                                       W, H)

    def geom(tr):
        m = j_slab.FrameGeom(jg, tr, FX, FX, perm, flip, W, H, JOPT, GI)
        return m.R, m.fx, m.fy, m.u0, m.du, m.v0, m.dv

    jgm = types.SimpleNamespace(scale=jg.scale, **dict(zip(
        ("R", "fx", "fy", "u0", "du", "v0", "dv"),
        jax.jit(geom)(jnp.asarray(cam.transform, jnp.float32)))))
    tg = slab_render.FrameGeom(g, cam.transform, FX, FX, perm, flip, W, H,
                               OPT, GI)
    inter = np.random.default_rng(7).uniform(0.0, 1.0, (GI, GI, 4)).astype(
        np.float32)
    return jgm, tg, perm, inter


def test_superquad_warp_matches_reference(monkeypatch):
    """The port's perf_sq3 warp against the reference's (interpret mode),
    and s1: each package's difference from its own production warp (both
    emitting f32)."""
    jgm, tg, perm, inter = _geom()
    jit_inter = jnp.asarray(inter)
    want = np.asarray(jax.jit(lambda it: j_sq3.superquad_warp(
        it, jgm, None, perm, W, H, GI, JOPT, True))(jit_inter))
    # the same geometry in: the reference's FrameGeom fields
    geo = tuple(torch.as_tensor(np.array(v)) for v in (
        jgm.R, jgm.fx, jgm.fy, jgm.u0, jgm.du, jgm.v0, jgm.dv, jgm.scale))
    got = perf_sq3.superquad_warp(torch.as_tensor(inter), geo, perm, W, H,
                                  GI, OPT)
    assert tuple(got.shape) == (H, W, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)

    # each package's production warp at the cascade level whose shape the
    # probe copies, (2, 2) blocks and a 4 x 4 window (the (4, 4) x (5, 5)
    # level's interpret-mode kernel alone takes ~15 s to trace here), with
    # the reference's exact (f32) emit: its default rounds each output
    # plane to bf16, which the port's kernel C does not (ROADMAP.md §3,
    # "f32 display emit")
    level = (((2, 2), (4, 4)),)
    monkeypatch.setattr(j_dw, "_EXACT_EMIT", True)
    with interpret(monkeypatch):
        jprod = np.asarray(jax.jit(lambda it: j_dw.warp_to_screen_sq(
            it, JOPT, jgm.R, jgm.fx, jgm.fy, W, H, GI, perm, jgm.u0,
            jgm.du, jgm.v0, jgm.dv, jgm.scale, block=level))(jit_inter))
    targs = (tg.R, tg.fx, tg.fy, W, H, GI, perm, tg.u0, tg.du, tg.v0,
             tg.dv, tg.scale)
    assert bool(display_warp._level_fits(*display_warp._pixel_slopes(
        *targs), GI, *level[0])[0])
    tprod = display_warp.warp_to_screen_sq(torch.as_tensor(inter)[None],
                                           OPT, *targs, block=level)[0]
    s1_ref = float(np.abs(want - jprod).max())
    s1_port = float((got - tprod).abs().max())
    assert 1e-3 < s1_ref < 1e-2
    assert abs(s1_port - s1_ref) <= 1e-4, (s1_port, s1_ref)


def test_sq4_variants_through_tail():
    """b1 and b4 (chan order) equal the perf_sq3 warp on the same pose; b2
    and b3 (stack order) agree with each other and not with it: the
    reference's channel-order mismatch, kept, not fixed."""
    _, tg, perm, _ = _geom()
    st = perf_sq4.Setup(tg.scale, perm, FX, FX, W, H, GI, OPT)
    a = torch.as_tensor(np.random.default_rng(4).uniform(
        0.1, 0.9, (4, GI, GI)).astype(np.float32))
    geo = (tg.R[0], tg.u0[0], tg.du[0], tg.v0[0], tg.dv[0])
    sq = perf_sq3.superquad_warp(perf_sq4.finalize(a, OPT),
                                 perf_sq3.pose_geom(tg), perm, W, H, GI, OPT)
    outs = {name: fn(st, a, *geo) for name, fn in perf_sq4.VARIANTS.items()}
    for name in ("b1 concat", "b4 probe+T"):
        np.testing.assert_allclose(outs[name].numpy(), sq.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    assert torch.equal(outs["b2 stack+T"], outs["b3 probe ilv"])
    assert float((outs["b3 probe ilv"] - sq).abs().max()) > 0.05
    # b0 (the f16 quad-gather warp) agrees with the bf16-table variants to
    # their rounding
    assert float((outs["b0 ref quad"] - sq).abs().max()) < 1e-2


# ---------------------------------------------------------------------------
# probes/display_march: kernel M's display mode by part of its job loop
# (the card runs it; here its host side)
# ---------------------------------------------------------------------------

def test_display_march_slots_follow_the_kernel_clock():
    """The probe's parts are the display kernel's DPart enum in order, then
    the loop's cycles and the jobs, slabs, windows and stages
    (DM_SLOTS)."""
    import re
    from volrend_torch import kernels
    from volrend_torch.probes import display_march
    src = (kernels._CSRC / "slab_march_display.cu").read_text()
    body = src[src.index("enum DPart {"):src.index("D_NPARTS")]
    names = re.findall(r"^\s*(D_[A-Z]+),", body, re.M)
    assert len(names) == len(display_march.PARTS) == 10
    assert names[0] == "D_PRO" and names[-1] == "D_COMP"
    assert "constexpr int DM_SLOTS = D_NPARTS + 5;" in src
    assert display_march.SLOTS[len(names):] == ("loop", "jobs", "slabs",
                                                "windows", "stages")


def test_display_march_summarize():
    """A launch's clock rows summed as the probe reports them: the parts
    and the loop over the blocks, each part's share, the slowest block's
    row, the jobs, slabs, windows and stages summed, a block's mean and
    most, the pieces a slab and the slabs a stage."""
    from volrend_torch.probes import display_march
    n = len(display_march.PARTS)
    rows = np.zeros((3, len(display_march.SLOTS)), np.int64)
    rows[:, :n] = np.arange(n) + 1
    rows[1, 4] = 100                    # block 1 shades longest
    rows[:, n] = rows[:, :n].sum(1)
    rows[:, n + 1:] = [[4, 2, 1, 4], [6, 3, 1, 2], [5, 5, 2, 4]]
    out = display_march.summarize(rows)
    assert out["blocks"] == 3
    assert out["cycles"]["shade"] == 5 + 100 + 5
    assert out["cycles"]["prologue"] == 3
    assert out["loop_sum"] == int(rows[:, n].sum())
    assert out["loop_max"] == int(rows[1, n])
    assert out["slowest"]["shade"] == 100 and out["slowest"]["jobs"] == 6
    assert out["jobs"] == {"sum": 15, "mean": 5.0, "max": 6}
    assert out["slabs"]["sum"] == 10 and out["windows"]["max"] == 2
    assert out["pieces_a_slab"] == 1.5
    assert out["stages"] == {"sum": 10, "mean": 10 / 3, "max": 4}
    assert out["slabs_a_stage"] == 1.0
    assert abs(sum(out["share"].values()) - 1.0) < 1e-3


def test_display_march_builds_apart_and_reports_failures(monkeypatch,
                                                         tmp_path):
    """The probe build is one nvcc of the display source with the port's
    flags and -DVT_DM_CYCLES, into the build directory's display_march/,
    apart from the port's libraries; a failed build raises with its
    log."""
    import subprocess
    from volrend_torch import kernels
    from volrend_torch.probes import display_march
    cmds = []

    class Proc:
        returncode = 1

        def __init__(self, cmd, **kw):
            cmds.append(cmd)

        def communicate(self):
            return "ptxas: no card here", None

    monkeypatch.setattr(kernels, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", Proc)
    with pytest.raises(RuntimeError, match="no card here"):
        display_march.build()
    (cmd,) = cmds
    assert cmd[0] == "nvcc" and "-DVT_DM_CYCLES" in cmd
    assert all(f in cmd for f in kernels._NVCC_FLAGS)
    out = cmd[cmd.index("-o") + 1]
    assert out.startswith(str(tmp_path / "display_march"))
    assert cmd[-1].endswith("slab_march_display.cu")


def test_display_march_refuses_to_run_without_a_card(monkeypatch):
    """The probe measures on the card only: without one it raises before
    building or timing anything."""
    from volrend_torch.probes import display_march
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["display_march"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        display_march.main()


def test_display_march_reuses_its_build(monkeypatch, tmp_path):
    """The probe build is keyed as the port's libraries are (source, shared
    headers, flags): when it is built, no nvcc starts."""
    import subprocess
    from volrend_torch import kernels
    from volrend_torch.probes import display_march
    monkeypatch.setattr(kernels, "build_dir", lambda: tmp_path)

    def no_nvcc(*a, **kw):
        raise AssertionError("nvcc started for a built probe")

    out, building = None, None
    monkeypatch.setattr(subprocess, "Popen", no_nvcc)
    key = kernels._target(display_march._NAME).name
    built = tmp_path / "display_march" / key.replace(
        "lib" + display_march._NAME + "_",
        "lib" + display_march._NAME + "_cycles_")
    built.parent.mkdir(parents=True)
    built.write_bytes(b"")
    out, building = display_march.start_build()
    assert out == built and building is None


@pytest.mark.parametrize("release, checked", [("12.9", True),
                                              ("13.0", False)])
def test_display_sass_pinned_digests_hold_only_their_toolkit(
        monkeypatch, capsys, release, checked):
    """``display_sass --pinned`` holds the defaults to the digests it pins
    only under the nvcc release they were read with: a default whose SASS
    differs fails there, and under another release every default is
    reported unchecked and the exit code is 0."""
    import json
    from volrend_torch.probes import display_sass
    name = ("void (anonymous namespace)::display_kernel<16, 2, "
            "(anonymous namespace)::Var<false, 1, false, false, false> >"
            "(LaunchArgs)")
    sass = {name.replace("<16, 2,", f"<{bd}, {r},"): ["SASS"]
            for bd in (1, 4, 9, 16, 25) for r in (1, 2)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(display_sass, "library", lambda root: root)
    monkeypatch.setattr(display_sass, "functions", lambda lib: sass)
    monkeypatch.setattr(display_sass, "toolkit", lambda: release)
    monkeypatch.setattr("sys.argv", ["display_sass", "--pinned"])
    if checked:
        with pytest.raises(SystemExit):
            display_sass.main()
    else:
        display_sass.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["checked"] is checked and out["toolkit"] == release
    assert len(out["defaults"]) == 10
    assert out["ok"] is not checked
    assert all(v["equal"] is (False if checked else None)
               for v in out["defaults"].values())


# ---------------------------------------------------------------------------
# probes/train_march --cases: the training pair's formats and options (the
# card runs them; here the cases' names)
# ---------------------------------------------------------------------------

#: chip_smoke.py's tree keys as (format, lobes or SH basis functions) of the
#: training bench's SH9 tree (_common.format_trees; SG6 its six-lobe SG)
_SMOKE_TREES = {"SH": ("SH", 9), "SG": ("SG", 9), "ASG": ("ASG", 9),
                "SG6": ("SG", 6), "RGBA": ("RGBA", None)}


@pytest.mark.parametrize("bf16", [False, True])
def test_train_march_cases_are_the_smoke_cases(bf16):
    """Every case name of chip_smoke.TRAIN_CASES, and the SH9 baseline, is a
    case ``train_march --cases`` accepts, with the tree format, lobe count,
    render options and payload (a -bf16 suffix: the lean trainer's bf16
    payload and cotangent) that the smoke's phase 12b gives it."""
    import chip_smoke
    from volrend_torch.probes import train_march
    dtype = torch.bfloat16 if bf16 else torch.float32
    cases = list(chip_smoke.TRAIN_CASES) + [("SH9", "SH", {})]
    assert {"RGBA", "SH9-rot", "SH9-window", "SH9-bbox"} <= {
        c[0] for c in cases}
    for name, key, option in cases:
        spec = train_march.case_spec(name + ("-bf16" if bf16 else ""))
        assert (spec.fmt, spec.nb) == _SMOKE_TREES[key], name
        assert spec.options == option and spec.dtype == dtype, name
        # the library that marches it (VT_TRAIN_SET: 0 defaults, 1 SH
        # options and RGBA, 2 SG/ASG) is the one the port picks
        fmt = {"SH": 1, "SG": 2, "ASG": 3, "RGBA": 0}[spec.fmt]
        opt = fmt != 1 or bool(option)
        suffix = train_march._SET_SUFFIX[train_march._case_set(spec)]
        assert suffix == ("_lobes" if fmt > 1 else "_opt" if opt else ""), \
            name


@pytest.mark.parametrize("name", ["SH4", "SH9-all", "SH9-rot-window",
                                  "SG0", "SG26", "ASG", "SG09", "RGBA-rot",
                                  "RGBA-bf16-bf16", "rgba", ""])
def test_train_march_refuses_unknown_cases(name, monkeypatch):
    """A case name outside SH9[-rot|-window|-bbox], SG<n>, ASG<n> (1 to 25
    lobes) and RGBA, each with an optional -bf16, is refused, also by the
    command line before anything is built or run."""
    from volrend_torch.probes import train_march
    with pytest.raises(ValueError, match="unknown case"):
        train_march.case_spec(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(train_march, "run_cases",
                        lambda *a: pytest.fail("the cases ran"))
    monkeypatch.setattr("sys.argv", ["train_march", "--cases",
                                     f"SH9,{name}"])
    with pytest.raises(ValueError, match="unknown case"):
        train_march.main()
