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


def np32(x) -> np.ndarray:
    """A JAX array or a torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))
