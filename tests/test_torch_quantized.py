"""Codebook-quantized trees in the PyTorch port against the JAX reference:
the compressor (a NumPy copy, equal arrays), the device-resident codebook
form (``QuantLeaves.fetch_rows`` against the reference's and the host
decode), the exact renderer and the dense bake reading it, and a slab
frame of its bake; on the CPU at small sizes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_scenes import make_cam
from volrend_torch import compress as t_cmp
from volrend_torch.models import quantized as t_q
from volrend_torch.models.n3tree import N3Tree as TTree
from volrend_torch.models.synthetic import make_test_tree as t_make
from volrend_torch.ops import dense_grid as t_dense
from volrend_torch.ops import render_exact as t_exact
from volrend_torch.ops import slab_render as t_slab
from volrend_torch.utils.options import RenderOptions
from volrend_tpu import compress as j_cmp
from volrend_tpu.models import quantized as j_q
from volrend_tpu.models.n3tree import N3Tree as JTree
from volrend_tpu.ops import dense_grid as j_dense
from volrend_tpu.ops import render_jax as j_exact
from volrend_tpu.utils.options import RenderOptions as JOpt

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _dense_npz(tmp_path, bd=4, depth=3, seed=9):
    tree = t_make(max_depth=depth, basis_dim=bd, seed=seed, sigma_scale=60.0)
    path = str(tmp_path / "tree.npz")
    tree.save_npz(path)
    with np.load(path) as f:
        return dict(f.items())


@pytest.fixture(scope="module")
def quantized(tmp_path_factory):
    """(compressed npz path, the port's raw tree, the reference's raw tree,
    the port's host decode): an SH4 depth-3 tree compressed at 10 bits
    with its first basis function retained, as the reference's own
    compression tests make it."""
    d = tmp_path_factory.mktemp("q")
    z = _dense_npz(d)
    zq = t_cmp.compress_tree(z, bits=10, sigma_thresh=2.0, retain=1)
    path = str(d / "tree_q.npz")
    np.savez_compressed(path, **zq)
    return (path, t_q.load_quantized(path), j_q.load_quantized(path),
            TTree(path))


@pytest.mark.parametrize("kw", [dict(bits=10), dict(bits=6, retain=0),
                                dict(bits=8, retain=2, weighted=True,
                                     sigma_thresh=5.0)])
def test_compress_tree_equals_reference(tmp_path, kw):
    """compress_tree (median cut per basis function, the sigma threshold,
    the retained coefficients, the weighted mode) gives the reference's
    arrays, and quantize_median_cut its codebook and codes."""
    z = _dense_npz(tmp_path, bd=9, depth=3, seed=2)
    got, want = t_cmp.compress_tree(z, **kw), j_cmp.compress_tree(z, **kw)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    pts = np.random.default_rng(1).normal(size=(3000, 3)).astype(np.float32)
    w = np.random.default_rng(2).uniform(size=3000)
    for a, b in zip(t_cmp.quantize_median_cut(pts, 7, w),
                    j_cmp.quantize_median_cut(pts, 7, w)):
        np.testing.assert_array_equal(a, b)


def test_fetch_rows_bit_equal(quantized):
    """QuantLeaves.fetch_rows equals the reference's and the host decode's
    rows bit for bit, in the channel-major [retained..quant] + sigma
    layout; the leaves hold fewer bytes than the dense form (2 bytes a
    code where the dense form holds 6, beside the fixed codebooks)."""
    _, traw, jraw, host = quantized
    tdev = t_q.to_device_quantized(traw, device=CPU)
    jdev = j_q.to_device_quantized(jraw, lut_depth=None)
    idx = np.random.default_rng(3).integers(0, host.n_cells, (50, 20))
    got = tdev.data.fetch_rows(torch.as_tensor(idx)).numpy()
    assert got.dtype == np.float16 and got.shape == (50, 20, host.data_dim)
    np.testing.assert_array_equal(got, np.asarray(
        jdev.data.fetch_rows(jnp.asarray(idx))))
    np.testing.assert_array_equal(
        got, host.data.reshape(-1, host.data_dim)[idx])
    assert tdev.data.shape == (host.n_cells, host.data_dim)
    assert tdev.data.device == CPU
    leaves = tdev.data
    assert leaves.nbytes() < 0.75 * host.n_cells * host.data_dim * 2
    with pytest.raises(ValueError):
        t_q.to_device_quantized(host, device=CPU)


def test_render_exact_on_quant_leaves_matches_reference(quantized):
    """The exact renderer reading QuantLeaves against the reference's on
    its QuantLeaves (atol 1e-5, the reference's tests/test_compress.py
    tolerance) and against the port's render of the host decode."""
    _, traw, jraw, host = quantized
    cam = make_cam((1.0, 0.3, 0.4), width=32, height=32, fx=40.0)
    got = t_exact.render_image(t_q.to_device_quantized(traw, device=CPU),
                               cam, RenderOptions(max_steps=256)).numpy()
    want = np.asarray(j_exact.render_image(
        j_q.to_device_quantized(jraw, lut_depth=None), cam,
        JOpt(max_steps=256)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    dense = t_exact.render_image(host.to_device(lut_depth=None, device=CPU),
                                 cam, RenderOptions(max_steps=256)).numpy()
    np.testing.assert_allclose(got, dense, atol=1e-5)
    assert float(got[..., 3].max()) > 0.5


@pytest.mark.parametrize("dtype", ["int8", "f16"])
def test_bake_from_quant_leaves_bit_equal(quantized, dtype):
    """bake_dense reading the codebooks equals the reference's bake of its
    QuantLeaves and the port's bake of the host decode: codes, qscale,
    sigma grid and occupancy; a slab frame of it equals the decode's."""
    _, traw, jraw, host = quantized
    tq = t_q.to_device_quantized(traw, device=CPU)
    got = t_dense.bake_dense(tq, dtype=dtype)
    want = j_dense.bake_dense(j_q.to_device_quantized(jraw, lut_depth=None),
                              dtype=dtype)
    dense = t_dense.bake_dense(host.to_device(lut_depth=None, device=CPU),
                               dtype=dtype)
    wd = np.asarray(jnp.asarray(want.data, jnp.float32))
    np.testing.assert_array_equal(got.data.to(torch.float32).numpy(), wd)
    np.testing.assert_array_equal(got.qscale.numpy(),
                                  np.asarray(want.qscale))
    assert torch.equal(got.data, dense.data)
    assert torch.equal(got.sigma_grid, dense.sigma_grid)
    assert got.occ_max == dense.occ_max
    cam = make_cam((1.0, 0.25, 0.35), width=48, height=48)
    opt = RenderOptions(max_steps=256)
    np.testing.assert_array_equal(
        t_slab.render_image(got, cam, opt, gi=48),
        t_slab.render_image(dense, cam, opt, gi=48))


def test_load_quantized_keeps_the_tree(quantized):
    """load_quantized parses the tree's fields as the reference does and
    keeps the quantized arrays undecoded."""
    path, traw, jraw, host = quantized
    assert traw.data is None and jraw.data is None
    for k in ("quant_colors", "quant_map", "sigma", "data_retained"):
        np.testing.assert_array_equal(traw.quant[k], jraw.quant[k])
    assert (traw.capacity, traw.N, traw.data_dim) == (
        jraw.capacity, jraw.N, jraw.data_dim)
    np.testing.assert_array_equal(traw.child, JTree(path).child)
    np.testing.assert_array_equal(traw.scale, host.scale)
    with np.load(path) as f:
        d = dict(f.items())
    assert t_q.load_quantized(d).capacity == traw.capacity
    with pytest.raises(ValueError):
        t_q.load_quantized({k: v for k, v in d.items()
                            if k != "quant_colors"})
