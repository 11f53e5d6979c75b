"""Kernel M's RGBA kernel of its own (``rgba_kernel`` in
csrc/slab_march_display.cu) and kernel W's fit mode for the production
cascade (``fit_cascade`` in csrc/warp_display.cu), mirrored in PyTorch on
the CPU; the kernels themselves are held to their plain versions on the
card (tests/test_torch_cuda.py).

- The fit mode: a float32 mirror of ``fit_cascade``'s pass (screen_x and
  each linear form's x product once a column, screen_y and the y products
  once a row, each pixel's add and subtract in ``lin``'s order, the
  (2, 2) blocks' extents from the positions, the (4, 4) blocks' extents
  as the min and max of their four (2, 2) blocks') gives misfit counts
  bit-equal to ``level_fit_counts_ref`` and fit decisions equal to the
  reference's ``_level_fits``, on orbit, steep and wide poses, a pose
  whose blocks straddle the grid's edge and one whose denominator comes
  within 1e-12 of zero.
- The RGBA taps: a mirror of ``rg_tap`` (the staged int8 or bf16 codes
  decoded where a tap reaches them, a cell under the sigma threshold
  adding nothing) held bit-equal to the option
  variant's shade pass followed by its taps (``shade_pair``'s RGBA
  arithmetic into a float4 a cell), and to the plain march's RGBA shading.
- The launch configuration: ``display_config``, ``MarchMode.rgba_raw``
  and ``display_variant`` for RGBA with and without a bbox at 1, 4 and 51
  poses (32x8 tiles; two or three blocks an SM); the RGBA kernel's two
  slots hold an orbit's and a cropped pose's tile-slab footprints at the
  bench's width whole and the steep pose's in pieces that tile them, and
  its jobs (runs of pieces in march order) fit a slot.

Tolerances: every comparison is exact but the plain march's shading
(rtol 1e-6: one float32 rounding apart, see above)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from volrend_tpu.ops import display_warp as j_dw
from volrend_torch.models.data_format import BasisType
from volrend_torch.ops import display_warp, slab_march

from _torch_scenes import GI, H, W, warp_geom, warp_jargs, warp_targs
from test_torch_display_pieces import (  # noqa: F401 (the grid fixture)
    G, GI as GI_BENCH, _footprints, _pieces, _pose, grid)

torch.set_num_threads(1)

F32 = torch.float32
_CSRC = Path(__file__).resolve().parents[1] / "volrend_torch" / "csrc"


# ---------------------------------------------------------------------------
# kernel W's fit mode: fit_cascade
# ---------------------------------------------------------------------------

def _fit_cascade_mirror(prm: torch.Tensor, gi: int, height: int,
                        width: int) -> torch.Tensor:
    """fit_cascade's pass in float32: (2, P) int32 misfit counts of the
    (4, 4) x (5, 5) level, then the (2, 2) x (4, 4) level."""
    P = prm.shape[0]
    c = prm.to(F32)
    # screen_x a column, screen_y a row; each form's products once each
    xs = (torch.arange(width, dtype=F32) - 0.5 * width)[None] / c[:, 9:10]
    ys = -(torch.arange(height, dtype=F32) - 0.5 * height)[None] / c[:,
                                                                    10:11]
    fx = [xs * c[:, 3 * i, None] for i in range(3)]          # (P, W)
    fy = [ys * c[:, 3 * i + 1, None] for i in range(3)]      # (P, H)
    den, nu, nv = ((fx[i][:, None, :] + fy[i][:, :, None])
                   - c[:, 3 * i + 2, None, None] for i in range(3))
    inv = 1.0 / torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12),
                            den)
    gy = (nu * inv - c[:, 11, None, None]) / c[:, 12, None, None]
    gx = (nv * inv - c[:, 13, None, None]) / c[:, 14, None, None]
    gmax = float(gi - 1)
    hi = float(np.float32((gi - 1) - 1e-6))
    ok = (gy >= 0) & (gy <= gmax) & (gx >= 0) & (gx <= gmax)
    cy, cx = torch.clamp(gy, max=hi), torch.clamp(gx, max=hi)
    Hs, Ws = height // 4, width // 4

    def blocks(t):
        # (P, Hs, 2, 2, Ws, 2, 2) -> (P, Hs, Ws, 2, 2, 4): the (2, 2)
        # blocks of each super block, their four pixels last
        return t.reshape(P, Hs, 2, 2, Ws, 2, 2).permute(
            0, 1, 4, 2, 5, 3, 6).reshape(P, Hs, Ws, 2, 2, 4)

    okb = blocks(ok)
    big = torch.tensor(1e9, dtype=F32)
    ymin = torch.where(okb, blocks(cy), big).amin(-1)
    ymax = torch.where(okb, blocks(cy), -big).amax(-1)
    xmin = torch.where(okb, blocks(cx), big).amin(-1)
    xmax = torch.where(okb, blocks(cx), -big).amax(-1)
    anyb = okb.any(-1)                              # (P, Hs, Ws, 2, 2)

    def misfit(y0, y1, x0, x1, any_, w):
        zero = torch.zeros((), dtype=F32)
        y0, y1, x0, x1 = (torch.where(any_, v, zero)
                          for v in (y0, y1, x0, x1))
        return ((y1 >= torch.floor(y0) + (w - 1.0))
                | (x1 >= torch.floor(x0) + (w - 1.0)))

    nf = misfit(ymin, ymax, xmin, xmax, anyb, 4).sum((1, 2, 3, 4))
    # the (4, 4) blocks' extents from their four (2, 2) blocks'
    nc = misfit(ymin.amin((3, 4)), ymax.amax((3, 4)), xmin.amin((3, 4)),
                xmax.amax((3, 4)), anyb.any(4).any(3), 5).sum((1, 2))
    return torch.stack([nc, nf]).to(torch.int32)


def _fit_pose(kind):
    """The warp tests' geometry (200^2, gi = 96) for ``kind``: (the
    reference's _pixel_slopes arguments, the port's)."""
    fx = {"wide": 45.0, "steep": 110.0}.get(kind, 280.0)
    jgm, tg, perm, _ = warp_geom(fx=fx)
    ja, ta = list(warp_jargs(jgm, perm)), list(warp_targs(tg, perm))
    if kind == "edge":
        # a coarser grid shifted by half the screen: blocks straddle the
        # grid's edge along both axes
        for args in (ja, ta):
            args[7] = args[7] + args[8] * np.float32(GI / 2)
            args[9] = args[9] - args[10] * np.float32(GI / 3)
            args[8] = args[8] * np.float32(1.5)
            args[10] = args[10] * np.float32(1.5)
    if kind == "den":
        # the den form made tiny and zero at a pixel near the centre: its
        # values there lie within 1e-12 of zero and are clamped to it
        a = np.asarray(tg.R, np.float32)[0].copy()
        sc = np.broadcast_to(np.asarray(tg.scale, np.float32), (3,))
        p0 = perm[0]
        xs0 = np.float32((103 - 0.5 * W) / np.float32(tg.fx))
        ys0 = np.float32(-(97 - 0.5 * H) / np.float32(tg.fy))
        a[p0, 0] = np.float32(3e-6) / sc[p0]
        a[p0, 1] = np.float32(-2e-6) / sc[p0]
        f0, f1 = a[p0, 0] * sc[p0], a[p0, 1] * sc[p0]
        a[p0, 2] = (np.float32(xs0 * f0) + np.float32(ys0 * f1)) / sc[p0]
        ja[0] = jnp.asarray(a)
        ta[0] = torch.as_tensor(a[None])
    return ja, ta


@pytest.mark.parametrize("kind", ["orbit", "steep", "wide", "edge", "den"])
def test_fit_cascade_mirror_counts_and_decides_as_reference(kind):
    """fit_cascade's float32 pass: its misfit counts equal the plain
    version's bit for bit, and its fit decisions the reference's
    _level_fits, at both production levels."""
    ja, ta = _fit_pose(kind)
    R, fx, fy, _, _, _, perm, u0, du, v0, dv, scale = ta
    prm = display_warp.display_params(R, fx, fy, u0, du, v0, dv, scale, perm)
    levels = display_warp._usable_levels(W, H, GI)
    assert [lv[0] for lv in levels] == [(4, 4), (2, 2)]
    got = _fit_cascade_mirror(prm, GI, H, W)
    want = display_warp.level_fit_counts_ref(prm, levels, GI, H, W)
    assert torch.equal(got, want), (got, want)
    gyf, gxf = j_dw._pixel_slopes(*ja)
    ref = [bool(j_dw._level_fits(gyf, gxf, GI, B, win)) for B, win in levels]
    dec = display_warp._fits_from_counts(got, levels, H, W)[:, 0].tolist()
    assert dec == ref
    if kind == "den":
        # the guard is reached: some pixel's denominator is within 1e-12
        xs = (torch.arange(W, dtype=F32) - 0.5 * W) / prm[0, 9]
        ys = -(torch.arange(H, dtype=F32) - 0.5 * H) / prm[0, 10]
        den = ((xs[None] * prm[0, 0] + ys[:, None] * prm[0, 1])
               - prm[0, 2])
        assert bool((den.abs() < 1e-12).any())
    if kind in ("edge", "wide"):
        # some blocks hold in-grid and off-grid subpixels both
        ok = (gyf >= 0) & (gyf <= GI - 1) & (gxf >= 0) & (gxf <= GI - 1)
        b = np.asarray(ok).reshape(H // 4, 4, W // 4, 4).any((1, 3))
        a = np.asarray(ok).reshape(H // 4, 4, W // 4, 4).all((1, 3))
        assert bool((b & ~a).any())


def test_fit_cascade_mirror_on_a_pose_batch():
    """The mirror over a batch of the five poses at once (one pose a row
    of prm, as the kernel's grid y) equals the plain version's counts."""
    prms = []
    for kind in ("orbit", "steep", "wide", "edge", "den"):
        R, fx, fy, _, _, _, perm, u0, du, v0, dv, scale = _fit_pose(kind)[1]
        prms.append(display_warp.display_params(R, fx, fy, u0, du, v0, dv,
                                                scale, perm))
    prm = torch.cat(prms)
    levels = display_warp._usable_levels(W, H, GI)
    assert torch.equal(_fit_cascade_mirror(prm, GI, H, W),
                       display_warp.level_fit_counts_ref(prm, levels, GI, H,
                                                         W))


# ---------------------------------------------------------------------------
# kernel M's RGBA kernel: the taps decode the staged codes
# ---------------------------------------------------------------------------

def _code_of_word(w: np.ndarray, i: np.ndarray) -> np.ndarray:
    """The kernel's code(word(p), i): the word's bytes biased by 128
    (w ^ 0x80808080), byte i permuted under the exponent 0x4B00_00xx and
    one float32 add of -(2^23 + 128)."""
    b = ((w ^ np.uint32(0x80808080)) >> (8 * i).astype(np.uint32)) & 0xFF
    f = (np.uint32(0x4B000000) | b.astype(np.uint32)).view(np.float32)
    return (f - np.float32(8388736.0)).astype(np.float32)


def _stage(rng, rows: int, BX: int, bf16: bool):
    """A staged piece of an RGBA payload: rows of the planes (int8: three
    colour codes, sigma's hi and lo codes; bf16: three colours and sigma),
    BX cells each, as the kernel's stage holds them."""
    if bf16:
        vals = rng.uniform(-1.0, 4.0, (rows, 4, BX)).astype(np.float32)
        return torch.as_tensor(vals).to(torch.bfloat16)
    codes = rng.integers(-128, 128, (rows, 5, BX)).astype(np.int8)
    codes[:, 3] = rng.integers(-2, 6, (rows, BX))   # sigma's hi plane
    return torch.as_tensor(codes)


def _cells(st: torch.Tensor, bf16: bool):
    """Each staged cell's [sigma code, r, g, b codes] as the kernel reads
    them: int8 through the word trick (each cell from the 32-bit word that
    holds it), bf16 by a 16-bit shift; (rows, BX) each."""
    if bf16:
        bits = st.view(torch.int16).numpy().astype(np.uint16)
        f = (bits.astype(np.uint32) << 16).view(np.float32)
        return f[:, 3], f[:, 0], f[:, 1], f[:, 2]
    raw = st.numpy().view(np.uint8)                       # (rows, 5, BX)
    rows, _, BX = raw.shape
    words = raw.reshape(rows, 5, BX // 4, 4).copy().view(np.uint32)[..., 0]
    lx = np.arange(BX)
    dec = [_code_of_word(words[:, d][:, lx // 4], lx % 4) for d in range(5)]
    assert all(np.array_equal(dec[d], raw[:, d].view(np.int8).astype(
        np.float32)) for d in range(5))
    hi, lo = dec[3], dec[4]
    return (hi * np.float32(128.0) + lo), dec[0], dec[1], dec[2]


def _shade(st, bf16, qs, thr):
    """The option variant's shade pass (shade_pair's RGBA arithmetic): a
    float4 [sigma, sigma*r, sigma*g, sigma*b] a cell, zero under the
    threshold; (rows, BX, 4) float32."""
    s, c0, c1, c2 = (torch.as_tensor(v) for v in _cells(st, bf16))
    s = s * qs[3]
    ok = s > thr
    out = torch.stack([s, s * (c0 * qs[0]), s * (c1 * qs[1]),
                       s * (c2 * qs[2])], -1)
    return torch.where(ok[..., None], out, torch.zeros_like(out))


def _taps(cells_of, ys, xs, wr, wc):
    """One pixel's tap sums in the kernels' order (rows outer, columns
    inner), acc += wgt * v per channel in float32 (a cell of None adds
    nothing)."""
    acc = torch.zeros(4, dtype=F32)
    for y, a in zip(ys, wr):
        for x, b in zip(xs, wc):
            wgt = torch.tensor(a, dtype=F32) * torch.tensor(b, dtype=F32)
            v = cells_of(y, x)
            if v is not None:
                acc = acc + wgt * v
    return acc


@pytest.mark.parametrize("bf16", [False, True])
def test_rgba_taps_decode_as_shade_then_taps(bf16):
    """rg_tap's decode inside the taps equals the option variant's shade
    pass followed by its taps bit for bit, on random staged pieces and
    spans (the sigma threshold cutting some cells); the shaded cells equal
    the plain march's RGBA shading (_slab_sigma's sigma bit for bit, the
    colours within a float32 rounding: it takes sigma times the code
    first)."""
    rng = np.random.default_rng(11)
    qs = torch.as_tensor(rng.uniform(0.001, 0.02, 4).astype(np.float32))
    if bf16:
        qs = torch.ones(4, dtype=F32)
    thr = float(np.float32(0.5 if bf16 else 0.05))
    for trial in range(6):
        rows, BX = int(rng.integers(2, 6)), 16 * int(rng.integers(1, 4))
        st = _stage(rng, rows, BX, bf16)
        shaded = _shade(st, bf16, qs, thr)
        s, c0, c1, c2 = _cells(st, bf16)

        def decoded(y, x):
            # rg_tap: the cell's codes decoded where the tap reaches it;
            # under the threshold it adds nothing
            sig = torch.tensor(s[y, x]) * qs[3]
            if not bool(sig > thr):
                return None
            return torch.stack([sig, sig * (torch.tensor(c0[y, x]) * qs[0]),
                                sig * (torch.tensor(c1[y, x]) * qs[1]),
                                sig * (torch.tensor(c2[y, x]) * qs[2])])

        # the plain march's shading of the same cells (_slab_sigma, then
        # sigma times the code times its scale, in that order: within a
        # float32 rounding of the kernel's sigma * (code * scale))
        slab = slab_march._slab_values(st.permute(1, 0, 2))  # (Dp, rows, BX)
        sig = slab_march._slab_sigma(slab, qs, 4, not bf16)
        sig = torch.where(sig > thr, sig, torch.zeros_like(sig))
        plain = torch.cat([sig[None], sig[None] * slab[:3]
                           * qs[:3, None, None]]).permute(1, 2, 0)
        assert torch.equal(shaded[..., 0], plain[..., 0])
        assert torch.allclose(shaded, plain, rtol=1e-6, atol=0.0)
        for _ in range(8):
            y0 = int(rng.integers(0, rows - 1))
            x0 = int(rng.integers(0, BX - 2))
            ys = list(range(y0, min(rows, y0 + int(rng.integers(1, 3)))))
            xs = list(range(x0, min(BX, x0 + int(rng.integers(1, 4)))))
            wr = rng.uniform(0.0, 1.0, len(ys)).astype(np.float32)
            wc = rng.uniform(0.0, 1.0, len(xs)).astype(np.float32)
            a = _taps(lambda y, x: shaded[y, x], ys, xs, wr, wc)
            b = _taps(decoded, ys, xs, wr, wc)
            assert torch.equal(a, b), (trial, a, b)


# ---------------------------------------------------------------------------
# the launch configuration
# ---------------------------------------------------------------------------

def _rg_nj() -> int:
    """RG_NJ, the pieces a job of the RGBA kernel takes at most (its
    source's default)."""
    src = (_CSRC / "slab_march_display.cu").read_text()
    return int(re.search(r"#define VT_RG_NJ (\d+)", src).group(1))


@pytest.mark.parametrize("P, blocks", [(1, 2), (4, 3), (51, 3)])
def test_rgba_launches_take_their_kernel(P, blocks):
    """RGBA without a bbox takes its kernel of its own (vt_march_display's
    opt 0 at two blocks an SM, 4 at three) on 32x8 tiles, named
    ``RGBA-<payload>``, its stage the whole block but the windows' ints
    and no shaded-cell buffer, at three blocks an SM in 72 KB a block
    where the launch holds more blocks than two an SM take at once (4 and
    51 poses), else two; rot and a basis window, which do nothing to RGBA,
    keep it; with a bbox it takes the option variant (``-opt``), in depth
    mode the depth variant and resumed the resume build's option
    variant, all at 32x8."""
    M = slab_march.MarchMode
    rgba = int(BasisType.RGBA)
    rot = (0.0,) * 9
    for mode in (M(rgba), M(rgba, rot=rot), M(rgba, basis_lo=1),
                 M(rgba, dir_slab=True)):
        assert mode.rgba_raw() and not mode.tall_tiles(-1)
        assert slab_march._variant_args(mode, -1, "cpu")[2] == 1
    assert slab_march._variant_args(M(rgba), -1, "cpu", True)[2] == 1
    for mode in (M(rgba, bbox_full=False), M(rgba, depth=True)):
        assert not mode.rgba_raw() and not mode.tall_tiles(-1)
    for bf16, Dp, esz in ((False, 5, 1), (True, 4, 2)):
        pay = "bf16" if bf16 else "int8"
        assert slab_march.display_variant(M(rgba), -1, bf16) == f"RGBA-{pay}"
        assert slab_march.display_variant(M(rgba, rot=rot), -1,
                                          bf16) == f"RGBA-{pay}"
        assert slab_march.display_variant(M(rgba, bbox_full=False), -1,
                                          bf16) == f"RGBA-{pay}-opt"
        assert slab_march.display_variant(M(rgba, depth=True), -1,
                                          bf16) == f"RGBA-{pay}-depth"
        assert slab_march.display_variant(M(rgba), -1, bf16,
                                          True) == f"RGBA-{pay}-resume"
        assert slab_march.display_variant(
            M(rgba, bbox_full=False), -1, bf16, True) == (
                f"RGBA-{pay}-opt-resume")
        for n_win in (1, 64, 256):
            cfg = slab_march.display_config(P, 256, n_win, Dp, 132, esz=esz,
                                            raw=True)
            assert cfg["rows"] == 1 and cfg["chan_cells"] == 0
            assert cfg["blocks"] == blocks
            assert cfg["smem"] == cfg["stage_bytes"] + 12 * n_win
            assert cfg["smem"] <= slab_march._RGBA_SMEM[blocks]
            # its blocks an SM fit (the smem, ~1.3 KB of static arrays
            # and the 1 KB the card reserves a block)
            assert blocks * (cfg["smem"] + 1024 + 1536) <= 228 * 1024
            assert cfg["stage_bytes"] % 128 == 0
            # each of the two slots holds a 256-cell row of every plane
            assert (cfg["stage_bytes"] // 2) & ~15 >= Dp * esz * 256
            opt = slab_march.display_config(P, 256, n_win, Dp, 132, esz=esz,
                                            opt=True)
            assert opt["rows"] == 1 and opt["chan_cells"] >= 256


@pytest.mark.parametrize("blocks", [None, 2, 3])
def test_display_march_rgba_blocks_forces_only_rgba(blocks):
    """probes/display_march's ``--alt NAME=@BLOCKS``: while
    ``rgba_blocks`` runs, RGBA's kernel of its own takes ``blocks`` blocks
    an SM whatever the launch's size (None: the rule's), every other
    launch's configuration is the rule's, and display_config is restored
    after."""
    from volrend_torch.probes import display_march
    own = slab_march.display_config
    with display_march.rgba_blocks(blocks):
        for P, rule in ((1, 2), (51, 3)):
            b = blocks or rule
            cfg = slab_march.display_config(P, 256, 64, 5, 132, raw=True)
            assert cfg == dict(own(P, 256, 64, 5, 132, raw=True,
                                   smem=slab_march._RGBA_SMEM[b]), blocks=b)
            assert slab_march.display_config(P, 256, 64, 5, 132) == own(
                P, 256, 64, 5, 132)
    assert slab_march.display_config is own


@pytest.mark.parametrize("kind", ["orbit", "steep", "cropped"])
@pytest.mark.parametrize("bf16", [False, True])
def test_rgba_jobs_cover_every_footprint(grid, kind, bf16):
    """The RGBA kernel's walk (display_kernel's, a slot for its stage) at
    two and three blocks an SM (a slot of ~55 and ~36 KB), on an orbit, a
    steep and a cropped pose at the bench's width (G = gi = 256): each
    32x8 tile-slab footprint's pieces tile it exactly, each fitting a
    slot; an orbit's and a cropped pose's
    footprints go whole into one piece (the steep pose's widest in
    several); its jobs (rg_stage: consecutive pieces in march order while
    they fit the slot, up to RG_NJ) fit a slot, and an orbit's take more
    than two slabs a job on average."""
    params, ids, crop, _ = _pose(grid, kind)
    Dp, esz, ch = (4, 2, 8) if bf16 else (5, 1, 16)
    nj = _rg_nj()
    n_jobs = n_slabs = 0
    (y_lo, y_hi), (x_lo, x_hi) = _footprints(params, ids, G, GI_BENCH, 1,
                                             crop)
    for P, blocks in ((1, 2), (51, 3)):
        cfg = slab_march.display_config(P, GI_BENCH, G // 4, Dp, 132,
                                        esz=esz, raw=True)
        assert (cfg["rows"], cfg["blocks"]) == (1, blocks)
        slot = (cfg["stage_bytes"] // 2) & ~15
        for ty in range(0, y_lo.shape[2], 3):
            for tx in range(0, x_lo.shape[2], 2):
                pieces = []
                for si in range(len(ids)):
                    f = (y_lo[0, si, ty], y_hi[0, si, ty], x_lo[0, si, tx],
                         x_hi[0, si, tx])
                    if f[0] > f[1] or f[2] > f[3]:
                        continue
                    cover = np.zeros((f[1] - f[0] + 1, f[3] - f[2] + 1), int)
                    pcs = _pieces(f, crop[2], Dp * esz, slot, 1 << 30, ch)
                    for py, px, nr, nc, bx in pcs:
                        assert nr * Dp * bx * esz <= slot
                        cover[py - f[0]:py - f[0] + nr,
                              px - f[2]:px - f[2] + nc] += 1
                        pieces.append(nr * Dp * bx * esz)
                    assert np.all(cover == 1)
                    if kind != "steep":
                        assert len(pcs) == 1, (kind, P, f, len(pcs))
                # rg_stage's jobs
                jobs, used, n = [], 0, 0
                for b in pieces:
                    if n == nj or used + b > slot:
                        jobs.append(n)
                        used, n = 0, 0
                    used += b
                    n += 1
                    assert used <= slot
                if n:
                    jobs.append(n)
                assert sum(jobs) == len(pieces)
                n_jobs += len(jobs)
                n_slabs += len(pieces)
    if kind == "orbit":
        assert n_slabs > 2 * n_jobs, (n_slabs, n_jobs)
