"""The pyramid bake with its live bits and the coarse occupancy's bits mode
(``volrend_torch/ops/slab_grad.py``: ``bake_from_pyramid``, ``_BakeKernel``,
``live_bits_ref``, ``level_map``; ``volrend_torch/ops/
slab_march.py``: ``march_occupancy`` with ``live``,
``march_occupancy_live_ref``) on the CPU, where the wrappers run their
plain versions, against the reference's ``bake_from_pyramid`` and
``jax.vjp``, numpy loops and the full-read occupancy, on seeded inputs at
G <= 16. The kernels themselves are held against these plain versions on
the card (tests/test_torch_cuda.py)."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from volrend_tpu.ops import slab_grad as j_sg
from volrend_torch.ops import slab_grad, slab_march

from _torch_scenes import scene
from _torch_trees import tree_n

torch.set_num_threads(1)

THRESH = 0.01  # RenderOptions' default sigma threshold
PERMS = list(itertools.permutations(range(3)))


@pytest.fixture(scope="module", params=[("dense", 4), ("solid", 16)],
                ids=lambda s: f"{s[0]}{s[1]}")
def maps(request):
    """(port BakeMap, reference BakeMap, seeded (K, D) f32 leaf rows)."""
    kind, bd = request.param
    tdev, _, jdev, _ = scene(kind, bd, "f16")
    tb, jb = slab_grad.build_bake_map(tdev), j_sg.build_bake_map(jdev)
    rows = np.random.default_rng(bd).normal(
        0.0, 0.05, size=(int(tdev.data.shape[0]), tb.D)).astype(np.float32)
    return tb, jb, rows


def test_bake_entry_equals_reference(maps):
    """(a) The entry (``_BakeKernel``'s forward) equals the reference's
    bake_from_pyramid bit for bit, with and without the live bits."""
    tb, jb, rows = maps
    tp = slab_grad.data_to_pyramid(torch.tensor(rows), tb)
    ref = np.asarray(jax.jit(j_sg.bake_from_pyramid)(
        j_sg.data_to_pyramid(jnp.asarray(rows), jb), jb))
    np.testing.assert_array_equal(slab_grad.bake_from_pyramid(tp, tb).numpy(),
                                  ref)
    bake, live = slab_grad.bake_from_pyramid(tp, tb, live_thresh=THRESH)
    np.testing.assert_array_equal(bake.numpy(), ref)
    assert torch.equal(live.bits, slab_grad.live_bits_ref(bake, THRESH).bits)
    assert live.thresh == float(np.float32(THRESH))


def test_bake_entry_gradient(maps):
    """(b) The entry's gradient (the transpose written out in
    ``_BakeKernel.backward``) equals autograd through bake_from_pyramid_ref
    bit for bit and the reference's VJP to 1e-6 of each level's largest
    entry (the tolerance of test_bake_from_pyramid_grad_matches_jax_vjp:
    the two sum the pooled blocks in different orders); entries outside a
    level's mask get exactly zero gradient; the live bits take none."""
    tb, jb, rows = maps
    G, D = tb.G, tb.D
    R = torch.tensor(np.random.default_rng(1).normal(
        size=(G, G, G, D)).astype(np.float32))
    tp = [p.requires_grad_(True) for p in slab_grad.data_to_pyramid(
        torch.tensor(rows), tb)]
    bake, live = slab_grad.bake_from_pyramid(tp, tb, live_thresh=THRESH)
    assert not live.bits.requires_grad
    gk = torch.autograd.grad(torch.sum(bake * R), tp)
    gp = torch.autograd.grad(
        torch.sum(slab_grad.bake_from_pyramid_ref(tp, tb) * R), tp)
    jp = j_sg.data_to_pyramid(jnp.asarray(rows), jb)
    (gj,) = jax.jit(lambda p, r: jax.vjp(
        lambda q: j_sg.bake_from_pyramid(q, jb), p)[1](r))(
        jp, jnp.asarray(R.numpy()))
    for a, b, c, m in zip(gk, gp, gj, tb.masks):
        assert torch.equal(a, b)
        c = np.asarray(c)
        np.testing.assert_allclose(a.numpy(), c, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(c).max()))
        assert not bool(a[~m.expand_as(a)].any())


def _bf16_np(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 (round to nearest even) -> f32, by bit arithmetic."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _near_thresh_bake(G: int, D: int, seed: int) -> torch.Tensor:
    """A (G, G, G, D) bake whose sigma lies around THRESH: some values are
    above it in f32 and not after bf16 rounding, or the other way round."""
    rng = np.random.default_rng(seed)
    bake = rng.normal(size=(G, G, G, D)).astype(np.float32)
    sig = rng.uniform(0.0098, 0.0102, size=(G, G, G)).astype(np.float32)
    sig[rng.random((G, G, G)) < 0.3] = -1.0
    bake[..., D - 1] = sig
    return torch.tensor(bake)


@pytest.mark.parametrize("G", [12, 16, 40])
def test_live_bits_ref_equals_numpy_loop(G):
    """(c) live_bits_ref against a loop over the voxels, with sigma values
    that cross the threshold only after bf16 rounding (both ways), at G
    that are and are not multiples of 32 (padding bits 0)."""
    D = 4
    bake = _near_thresh_bake(G, D, seed=G)
    live = slab_grad.live_bits_ref(bake, THRESH)
    sig = bake[..., D - 1].numpy()
    thr = np.float32(THRESH)
    on = _bf16_np(sig) > thr
    assert np.any(on != (sig > thr)), "no value crosses after rounding"
    nw = -(-G // 32)
    want = np.zeros((G, G, nw), np.uint32)
    for z in range(G):
        for y in range(G):
            for x in range(G):
                if on[z, y, x]:
                    want[z, y, x // 32] |= np.uint32(1) << np.uint32(x % 32)
    assert live.bits.dtype == torch.int32
    np.testing.assert_array_equal(live.bits.numpy().view(np.uint32), want)
    assert live.thresh == float(thr)


@pytest.mark.parametrize("perm", PERMS)
def test_occupancy_bits_mode_equals_full_read(perm):
    """(d) march_occupancy_live_ref (and the bits mode of the wrapper)
    equals march_occupancy_ref on the permuted bake, at a G that is not a
    multiple of 8."""
    G, D = 13, 4
    bake = _near_thresh_bake(G, D, seed=3)
    live = slab_grad.live_bits_ref(bake, THRESH)
    view = bake.permute(perm[0], 3, perm[1], perm[2])
    prm = torch.full((2, 15), 1.0)
    prm[:, 14] = torch.tensor([THRESH, 0.5])
    qs = torch.ones(D)
    want = slab_march.march_occupancy_ref(view, prm, qs)
    assert int(want.count_nonzero()) > 0
    assert torch.equal(slab_march.march_occupancy_live_ref(live, perm), want)
    assert torch.equal(slab_march.march_occupancy(
        view, prm, qs, live=live, perm=perm), want)


def test_occupancy_bits_mode_refuses_mismatches():
    """(e) The bits mode raises when the poses' lowest threshold is not the
    one the bits were taken at, and when the view is not the bake seen
    through ``perm``."""
    G, D = 8, 4
    bake = _near_thresh_bake(G, D, seed=4)
    live = slab_grad.live_bits_ref(bake, THRESH)
    perm = (1, 0, 2)
    view = bake.permute(perm[0], 3, perm[1], perm[2])
    qs = torch.ones(D)
    with pytest.raises(ValueError, match="threshold"):
        slab_march.march_occupancy(view, torch.full((1, 15), 0.02), qs,
                                   live=live, perm=perm)
    with pytest.raises(ValueError, match="perm"):
        slab_march.march_occupancy(view, torch.full((1, 15), THRESH), qs,
                                   live=live, perm=(0, 1, 2))
    with pytest.raises(ValueError, match="perm"):
        slab_march.march_occupancy(view, torch.full((1, 15), THRESH), qs,
                                   live=live)


@pytest.mark.parametrize("N,depth", [(2, 3), (3, 2)])
def test_level_map_covers_every_voxel_once(N, depth):
    """(f) The level map (what the bake kernel finds by walking the masks)
    names, for every voxel, the one level whose mask covers it (checked
    against each level's mask upsampled on its own), at N = 2 and N = 3;
    the pyramid bake gathered through it equals the plain chain."""
    tree = tree_n(N, depth, 4, seed=N)
    tdev = tree.to_device(lut_depth=None, device="cpu")
    bmap = slab_grad.build_bake_map(tdev)
    G = bmap.G
    assert G == N ** (depth + 1) and len(bmap.masks) == depth + 1
    lmap = slab_grad.level_map(bmap)
    assert lmap.dtype == torch.uint8 and tuple(lmap.shape) == (G, G, G)
    count = np.zeros((G, G, G), np.int64)
    for j, m in enumerate(bmap.masks):
        f = G // m.shape[0]
        up = np.repeat(np.repeat(np.repeat(m[..., 0].numpy(), f, 0), f, 1),
                       f, 2)
        count += up
        np.testing.assert_array_equal(lmap.numpy() == j, up)
    np.testing.assert_array_equal(count, 1)
    assert len(set(np.unique(lmap.numpy()))) > 1
    # the gather through the level map is the chain's bake
    pyr = slab_grad.data_to_pyramid(tdev.data.float(), bmap)
    bake = slab_grad.bake_from_pyramid_ref(pyr, bmap)
    idx = np.indices((G, G, G))
    for j, p in enumerate(pyr):
        sel = lmap.numpy() == j
        f = G // p.shape[0]
        src = p.numpy()[idx[0][sel] // f, idx[1][sel] // f, idx[2][sel] // f]
        np.testing.assert_array_equal(bake.numpy()[sel], src)


def _occupancy_live_mirror(bits: np.ndarray, G: int, perm) -> np.ndarray:
    """A mirror of csrc/slab_march.cu:occupancy_live_kernel's index
    arithmetic (its jobs, lanes, loads and ballots), in numpy."""
    NWB, RB, OCC = -(-G // 32), -(-G // 8), 8
    NH = 2 * (-(-RB // 64))
    bst = (G * NWB, NWB)
    st = [0, 0, 0]
    ax = perm.index(2)
    for a in range(3):
        if a != ax:
            st[a] = bst[perm[a]]
    jobs = {2: G * RB, 1: G * NWB, 0: NWB * RB}[ax] * NH
    lv = bits.reshape(-1).view(np.uint32).astype(np.int64)
    out = np.full(G * RB * NH, -1, np.int64)

    def ballot(pred):
        return sum(1 << lane for lane in range(32) if pred(lane))

    for job in range(jobs):
        h, rest = job % NH, job // NH
        ms = []
        for lane in range(32):
            cb = 32 * h + lane
            c0, c1, m = cb * OCC, min(cb * OCC + OCC, G), 0
            if cb < RB:
                if ax == 2:
                    s, rb = divmod(rest, RB)
                    for r in range(rb * OCC, min(rb * OCC + OCC, G)):
                        m |= int(lv[s * st[0] + r * st[1] + cb // 4])
                elif ax == 1:
                    s, rw = divmod(rest, NWB)
                    for c in range(c0, c1):
                        m |= int(lv[s * st[0] + c * st[2] + rw])
                else:
                    sw, rb = divmod(rest, RB)
                    for r in range(rb * OCC, min(rb * OCC + OCC, G)):
                        for c in range(c0, c1):
                            m |= int(lv[r * st[1] + c * st[2] + sw])
            ms.append(m)
        if ax == 2:
            out[rest * NH + h] = ballot(
                lambda l: (ms[l] >> (8 * ((32 * h + l) & 3))) & 0xFF)
        elif ax == 1:
            s, rw = divmod(rest, NWB)
            for k in range(4):
                if 4 * rw + k < RB:
                    out[(s * RB + 4 * rw + k) * NH + h] = ballot(
                        lambda l: (ms[l] >> (8 * k)) & 0xFF)
        else:
            sw, rb = divmod(rest, RB)
            for i in range(32):
                if 32 * sw + i < G:
                    out[((32 * sw + i) * RB + rb) * NH + h] = ballot(
                        lambda l: (ms[l] >> i) & 1)
    assert (out >= 0).all(), "a half mask word was not written"
    o = out.reshape(G, RB, NH // 2, 2)
    return (o[..., 0] | (o[..., 1] << 32)).astype(np.uint64).view(np.int64)


@pytest.mark.parametrize("perm", PERMS)
def test_occupancy_live_kernel_mirror(perm):
    """The bits-mode kernel's job and lane arithmetic (mirrored in numpy)
    writes every half mask word once and equals march_occupancy_live_ref,
    at a G with a partial bit word and a partial row block."""
    G, D = 37, 4
    bake = _near_thresh_bake(G, D, seed=5)
    live = slab_grad.live_bits_ref(bake, THRESH)
    np.testing.assert_array_equal(
        _occupancy_live_mirror(live.bits.numpy(), G, perm),
        slab_march.march_occupancy_live_ref(live, perm).numpy())
