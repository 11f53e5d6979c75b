"""Shared inputs for the port's tests (tests/test_torch_*.py): the same
seeded scenes built by both packages, and the reference's interpret-mode
switch. The port runs on the CPU (its kernels' plain versions); the JAX
package runs its Pallas kernels in interpret mode, as its own tests do."""

import contextlib
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from volrend_tpu.models import synthetic as j_synth
from volrend_tpu.ops import dense_grid as j_dense
from volrend_tpu.ops import pallas_slab
from volrend_tpu.ops import slab_render as j_slab
from volrend_torch.models import synthetic as t_synth
from volrend_torch.ops import dense_grid as t_dense
from volrend_torch.ops import slab_render as t_slab
from volrend_torch.ops.camera import Camera
from volrend_torch.utils.options import RenderOptions
from volrend_tpu.utils.options import RenderOptions as JOpt

CPU = torch.device("cpu")


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 99.0 if mse < 1e-12 else -10.0 * float(np.log10(mse))


#: uint8 frames of the slab path across packages: rgb PSNR and alpha
#: (the reference's bf16 warp against the port's f32 one)
FRAME_GATE_DB = 45.0
FRAME_ALPHA_ATOL = 2e-2


def frames_agree(got, want, renderer: str) -> None:
    """``got`` (a uint8 frame of the port's) against ``want`` (the
    reference's): within one quantum from the exact renderer; from the
    slab path rgb PSNR >= FRAME_GATE_DB and alpha within
    FRAME_ALPHA_ATOL."""
    got = np.asarray(got, np.int32)
    want = np.asarray(want, np.int32)
    assert got.shape == want.shape
    if renderer == "exact":
        assert int(np.abs(got - want).max()) <= 1
        return
    p = psnr(got[..., :3] / 255.0, want[..., :3] / 255.0)
    assert p >= FRAME_GATE_DB, p
    np.testing.assert_allclose(got[..., 3] / 255.0, want[..., 3] / 255.0,
                               atol=FRAME_ALPHA_ATOL)


def make_cam(back, width=48, height=48, fx=60.0, radius=2.5):
    back = np.asarray(back, np.float64)
    back /= np.linalg.norm(back)
    up = (0.0, 0.0, 1.0) if abs(back[2]) < 0.9 else (0.0, 1.0, 0.0)
    return Camera.from_vectors(center=tuple(radius * back),
                               v_back=tuple(back), v_world_up=up,
                               width=width, height=height, fx=fx)


@functools.lru_cache(maxsize=None)
def trees(kind: str, basis_dim: int):
    """(port N3Tree, reference N3Tree) built from the same seed."""
    if kind == "dense":
        kw = dict(max_depth=3, basis_dim=basis_dim, seed=5, sigma_scale=60.0)
        return t_synth.make_test_tree(**kw), j_synth.make_test_tree(**kw)
    kw = dict(max_depth=3, basis_dim=basis_dim, seed=3)
    return t_synth.make_solid_tree(**kw), j_synth.make_solid_tree(**kw)


@functools.lru_cache(maxsize=None)
def scene(kind: str = "dense", basis_dim: int = 4, dtype: str = "int8"):
    """(port TreeArrays, port DenseGrid, reference TreeArrays, reference
    DenseGrid) for one seeded scene, both baked with ``dtype``."""
    tt, jt = trees(kind, basis_dim)
    tdev = tt.to_device(lut_depth=None, device=CPU)
    jdev = jt.to_device(lut_depth=None)
    return (tdev, t_dense.bake_dense(tdev, dtype=dtype), jdev,
            j_dense.bake_dense(jdev, dtype=dtype))


@functools.lru_cache(maxsize=None)
def ndc_scene(dtype: str = "int8", seed: int = 4, sigma_scale: float = 60.0,
              ndc=(800.0, 800.0, 1111.0)):
    """(port TreeArrays, port DenseGrid, reference TreeArrays, reference
    DenseGrid) of an NDC (LLFF) scene, the reference's NDC test tree
    (test_slab_render.py's ``ndc_scene``) with its ``NdcConfig``."""
    from volrend_torch.models.n3tree import NdcConfig as TNdc
    from volrend_tpu.models.n3tree import NdcConfig as JNdc
    kw = dict(max_depth=3, basis_dim=4, seed=seed, sigma_scale=sigma_scale)
    tt, jt = t_synth.make_test_tree(**kw), j_synth.make_test_tree(**kw)
    for t, cfg in ((tt, TNdc), (jt, JNdc)):
        t.use_ndc = True
        t.ndc = cfg(width=ndc[0], height=ndc[1], focal=ndc[2])
    tdev = tt.to_device(lut_depth=None, device=CPU)
    jdev = jt.to_device(lut_depth=None)
    return (tdev, t_dense.bake_dense(tdev, dtype=dtype), jdev,
            j_dense.bake_dense(jdev, dtype=dtype))


def lobes(fmt: str, bd: int, seed: int) -> np.ndarray:
    """SG (bd, 4) or ASG (bd, 11) lobe parameters drawn from ``seed`` as the
    reference's tests draw them (test_slab_render.py
    test_pallas_interpret_sg, test_slab_asg_basis)."""
    rng = np.random.default_rng(seed)
    if fmt == "SG":
        mu = rng.normal(size=(bd, 3))
        mu /= np.linalg.norm(mu, axis=-1, keepdims=True)
        lam = rng.uniform(1.0, 6.0, (bd, 1))
        return np.concatenate([lam, mu], -1).astype(np.float32)
    extra = np.zeros((bd, 11), np.float32)
    for i in range(bd):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        extra[i, 0] = rng.uniform(0.5, 4.0)
        extra[i, 1] = rng.uniform(0.5, 4.0)
        extra[i, 2:] = q.T.reshape(-1)
    return extra


@functools.lru_cache(maxsize=None)
def format_trees(fmt: str, bd: int = 4):
    """(port N3Tree, reference N3Tree) of the reference's SG, ASG and RGBA
    test trees (test_slab_render.py: blob scenes at depth 3, SG and ASG
    with seeded lobes, RGBA with sinusoidal colours), built by each
    package's ``build_tree`` from the same seeds."""
    from volrend_torch.models import data_format as t_fmt
    from volrend_tpu.models import data_format as j_fmt
    out = []
    for synth, fm in ((t_synth, t_fmt), (j_synth, j_fmt)):
        if fmt == "RGBA":
            density, refine, _ = synth.make_blob_scene(n_blobs=3, seed=6,
                                                       sigma_scale=50.0)

            def leaf_fn(pts, cell, density=density):
                v = np.zeros((pts.shape[0], 4), np.float32)
                v[:, :3] = 0.5 + 0.5 * np.sin(pts * 7.0)
                v[:, 3] = density(pts)
                return v

            tree = synth.build_tree(
                refine, leaf_fn, max_depth=3, data_dim=4,
                data_format=fm.DataFormat(fm.BasisType.RGBA, -1))
        else:
            _, refine, factory = synth.make_blob_scene(n_blobs=3, seed=4,
                                                       sigma_scale=50.0)
            tree = synth.build_tree(
                refine, factory(bd, coeff_seed=2 if fmt == "SG" else 9),
                max_depth=3, data_dim=3 * bd + 1,
                data_format=fm.DataFormat(fm.BasisType[fmt], bd))
            tree.extra = lobes(fmt, bd, 4 if fmt == "SG" else 12)
        out.append(tree)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def format_scene(fmt: str, bd: int = 4, dtype: str = "int8"):
    """(port TreeArrays, port DenseGrid, reference TreeArrays, reference
    DenseGrid) of ``format_trees(fmt, bd)``, both baked with ``dtype``;
    fmt "SH" is ``scene("dense", bd, dtype)``."""
    if fmt == "SH":
        return scene("dense", bd, dtype)
    tt, jt = format_trees(fmt, bd)
    tdev = tt.to_device(lut_depth=None, device=CPU)
    jdev = jt.to_device(lut_depth=None)
    return (tdev, t_dense.bake_dense(tdev, dtype=dtype), jdev,
            j_dense.bake_dense(jdev, dtype=dtype))


def ndc_cam(center=(0.0, 0.0, 0.2), back=(0.05, 0.02, 1.0), width=48,
            height=48, fx=52.0):
    """The reference's NDC test pose (test_slab_render.py make_ndc_cam)."""
    return Camera.from_vectors(center=center, v_back=back,
                               v_world_up=(0.0, 1.0, 0.0), width=width,
                               height=height, fx=fx)


W = H = 200
GI = 96


def warp_cam(fx=280.0):
    back = np.asarray((1.0, 0.25, 0.35))
    back /= np.linalg.norm(back)
    return Camera.from_vectors(center=tuple(2.5 * back), v_back=tuple(back),
                               v_world_up=(0.0, 0.0, 1.0), width=W,
                               height=H, fx=fx)


def warp_geom(fx=280.0, seed=7):
    """The superquad warp tests' pose (200^2, gi=96, as the reference's
    superquad tests): both packages' FrameGeom, perm, and a seeded
    intermediate image ((gi, gi, 4) numpy)."""
    _, g, _, jg = scene("dense", 4, "int8")
    cam = warp_cam(fx)
    perm, flip, _ = j_slab.choose_axis(jg, cam.transform, cam.fx, cam.fy,
                                       W, H)
    jgm = j_slab.FrameGeom(jg, jnp.asarray(cam.transform), cam.fx, cam.fy,
                           perm, flip, W, H, JOpt(max_steps=512), GI)
    tg = t_slab.FrameGeom(g, cam.transform, cam.fx, cam.fy, perm, flip,
                          W, H, RenderOptions(max_steps=512), GI)
    inter = np.random.default_rng(seed).uniform(0.0, 1.0, (GI, GI, 4)
                                                ).astype(np.float32)
    return jgm, tg, perm, inter


def warp_jargs(jgm, perm):
    return (jgm.R, jgm.fx, jgm.fy, W, H, GI, perm, jgm.u0, jgm.du, jgm.v0,
            jgm.dv, jgm.scale)


def warp_targs(tg, perm):
    return (tg.R, tg.fx, tg.fy, W, H, GI, perm, tg.u0, tg.du, tg.v0, tg.dv,
            tg.scale)


@contextlib.contextmanager
def interpret(monkeypatch, crop_mult=None, force_dynamic=False):
    """Run the reference's Pallas kernels in interpret mode (and, with
    ``crop_mult``, shrink both packages' in-plane crop granularity the way
    the reference's crop tests do)."""
    monkeypatch.setattr(pallas_slab, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(pallas_slab, "_FORCE_DYNAMIC", force_dynamic)
    if crop_mult is not None:
        for mod in (j_slab, t_slab):
            monkeypatch.setattr(mod, "_CROP_MULT_Y", crop_mult)
            monkeypatch.setattr(mod, "_CROP_MULT_X", crop_mult)
    jax.clear_caches()
    try:
        yield
    finally:
        monkeypatch.setattr(pallas_slab, "_FORCE_INTERPRET", False)
        monkeypatch.setattr(pallas_slab, "_FORCE_DYNAMIC", False)
        jax.clear_caches()


def to_torch(x) -> torch.Tensor:
    """A JAX array (int8, f32 or bf16) as a CPU tensor of its dtype."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def march_pair(g, jg, cam, jopt, gi=32, dir_win=True, shade_bf16=False):
    """One pose marched by both packages on the reference's inputs (its
    params, z interval, permuted payload, culled slab ids and crop) with
    the formats and options of ``jopt`` (the reference's RenderOptions)
    and the display knobs ``dir_win`` and ``shade_bf16``, as the
    reference's display route calls its kernel; the reference runs in
    interpret mode (the caller's ``interpret`` context). Returns (port acc
    (4, gi, gi), reference acc) as numpy."""
    from volrend_torch.ops import slab_march as t_march
    W, H = cam.width, cam.height
    perm, flip, slope = j_slab.choose_axis(jg, cam.transform, cam.fx,
                                           cam.fy, W, H)
    assert slope < j_slab.MAX_SLAB_SLOPE
    crop = j_slab.inplane_crop(jg, perm, float(jopt.sigma_thresh))
    geom = j_slab.FrameGeom(jg, jnp.asarray(cam.transform), cam.fx, cam.fy,
                            perm, flip, W, H, jopt, gi)
    params, zb = j_slab._pallas_frame_fields(jg, geom, perm, flip, jopt)
    planar = j_slab._permuted_grid(jg, perm, True, crop=crop)[0]
    blo, bhi = jopt.basis_minmax
    rotm = j_slab._rodrigues(jopt.rot_dirs)
    kw = dict(slab_ids=tuple(jg.slab_ids(perm[0], flip, jopt.sigma_thresh)),
              basis_lo=int(blo), basis_hi=int(bhi), sig2=jg.quantized,
              fmt=int(jg.fmt), depth=bool(jopt.render_depth),
              rot=(None if rotm is None else
                   tuple(float(v) for v in np.asarray(rotm).reshape(-1))),
              flip=flip, bbox_full=j_slab._bbox_full(jopt), dir_win=dir_win,
              shade_bf16=shade_bf16, k_per_step=4, crop=crop)
    want = pallas_slab.march_slabs(planar, params, jg.qscale, zb, jg.G, gi,
                                   jg.data_dim, jg.basis_dim, perm,
                                   extra=jg.extra, **kw)
    got = t_march.march_slabs(
        to_torch(planar), to_torch(params)[None], to_torch(jg.qscale),
        to_torch(zb)[None], g.G, gi, g.data_dim, g.basis_dim, perm,
        extra=to_torch(jg.extra), **kw)
    return got[0].numpy(), np32(want)


def np32(x) -> np.ndarray:
    """A JAX array or a torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))
