"""The port's host foundations against the reference: synthetic trees, npz
IO, the leaf LUT, the device upload, the camera and the SH basis. All of
these are integer or numpy-exact stages, so they must match bit for bit
(the basis within float32 rounding)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from volrend_tpu.models import n3tree as j_n3tree
from volrend_tpu.models import data_format as j_fmt
from volrend_tpu.ops import basis as j_basis
from volrend_tpu.ops.camera import Camera as JCamera
from volrend_torch.models import data_format as t_fmt
from volrend_torch.models import n3tree as t_n3tree
from volrend_torch.ops import basis as t_basis
from volrend_torch.ops.camera import Camera

from _torch_scenes import CPU, trees

torch.set_num_threads(1)


@pytest.mark.parametrize("kind,bd", [("dense", 4), ("dense", 16),
                                     ("solid", 4), ("solid", 16)])
def test_synthetic_trees_bit_identical(kind, bd):
    t, j = trees(kind, bd)
    assert t.data_format.to_string() == j.data_format.to_string()
    for name in ("child", "data", "offset", "scale", "extra"):
        a, b = getattr(t, name), getattr(j, name)
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_npz_roundtrip_between_packages(tmp_path):
    """A tree saved by either package loads identically in the other."""
    t, j = trees("dense", 4)
    t.save_npz(str(tmp_path / "port.npz"))
    j.save_npz(str(tmp_path / "ref.npz"))
    from_port = j_n3tree.N3Tree(str(tmp_path / "port.npz"))
    from_ref = t_n3tree.N3Tree(str(tmp_path / "ref.npz"))
    for name in ("child", "data", "offset", "scale"):
        np.testing.assert_array_equal(getattr(from_port, name),
                                      getattr(j, name))
        np.testing.assert_array_equal(getattr(from_ref, name),
                                      getattr(t, name))
    assert from_ref.data_format == t.data_format


@pytest.mark.parametrize("lut_depth", [None, 2, 0])
def test_to_device_arrays_equal(lut_depth):
    """The tensor TreeArrays equals the reference's arrays, including the
    64-column row padding and the (full or truncated) leaf LUT."""
    t, j = trees("dense", 16)
    td = t.to_device(lut_depth=lut_depth, device=CPU)
    jd = j.to_device(lut_depth=lut_depth)
    assert (td.N, td.data_dim, td.basis_dim, int(td.fmt), td.max_depth,
            td.lut_depth, td.ndc) == (jd.N, jd.data_dim, jd.basis_dim,
                                      int(jd.fmt), jd.max_depth,
                                      jd.lut_depth, jd.ndc)
    for name in ("child", "data", "offset", "scale", "extra", "lut"):
        a = getattr(td, name).numpy()
        b = np.asarray(getattr(jd, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)
    assert td.data.shape[1] % 64 == 0
    assert int(t.max_depth) == 3 and td.max_depth == j.max_depth


def test_data_format_parse_matches():
    for s in ("SH1", "SH4", "SH9", "SH16", "SH25", "SG16", "ASG8", "RGBA"):
        a = t_fmt.DataFormat.parse(s)
        b = j_fmt.DataFormat.parse(s)
        assert (int(a.format), a.basis_dim) == (int(b.format), b.basis_dim)
        assert a.to_string() == b.to_string()


@pytest.mark.parametrize("back,fx", [((1.0, 0.3, 0.35), 60.0),
                                     ((-0.2, -0.1, -1.0), 280.0)])
def test_camera_rays_match(back, fx):
    kw = dict(center=tuple(2.5 * np.asarray(back)), v_back=back,
              width=40, height=24, fx=fx)
    if abs(back[2]) > 0.9:
        kw["v_world_up"] = (0.0, 1.0, 0.0)
    a, b = Camera.from_vectors(**kw), JCamera.from_vectors(**kw)
    np.testing.assert_array_equal(a.transform, b.transform)
    for x, y in zip(a.pixel_rays(xp=np), b.pixel_rays(xp=np)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("bd", [1, 4, 9, 16, 25])
def test_sh_basis_matches(bd):
    rng = np.random.default_rng(bd)
    d = rng.normal(size=(257, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = t_basis.eval_basis(t_fmt.BasisType.SH, bd,
                             torch.as_tensor(d)).numpy()
    want = np.asarray(j_basis.eval_basis(j_fmt.BasisType.SH, bd,
                                         jnp.asarray(d), xp=jnp))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    win = t_basis.apply_basis_window(torch.as_tensor(got), (1, bd - 2)
                                     ).numpy()
    wwin = np.asarray(j_basis.apply_basis_window(jnp.asarray(want),
                                                 (1, bd - 2), xp=jnp))
    np.testing.assert_allclose(win, wwin, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fmt", ["SG", "ASG", "RGBA"])
def test_basis_refuses_later_slices_formats(fmt):
    """The SG and ASG bases this test refused before their slice now
    evaluate, as the reference's (RGBA has no basis: None in both)."""
    from _torch_scenes import lobes
    rng = np.random.default_rng(2)
    d = rng.normal(size=(16, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    extra = lobes(fmt, 4, 5) if fmt != "RGBA" else None
    got = t_basis.eval_basis(t_fmt.BasisType[fmt], 4,
                             torch.as_tensor(d, dtype=torch.float32),
                             None if extra is None else torch.as_tensor(extra))
    want = j_basis.eval_basis(j_fmt.BasisType[fmt], 4,
                              jnp.asarray(d, jnp.float32),
                              None if extra is None else jnp.asarray(extra),
                              xp=jnp)
    if fmt == "RGBA":
        assert got is None and want is None
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
