"""Mesh overlays in the PyTorch port against the JAX reference: the mesh
layer and the host rasterizer (NumPy copies, equal arrays), the exact
renderer's mesh cap, the slab path's mesh z-clip, kernel W's mesh
background (its plain version against the reference's combine in
interpret mode) and whole mesh frames (``render_image(meshes=...)``,
``opt.show_grid``), on the CPU at small sizes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_scenes import interpret, make_cam, psnr, scene, trees
from volrend_torch.models import mesh as t_mesh
from volrend_torch.ops import composite as t_comp
from volrend_torch.ops import display_warp as t_dw
from volrend_torch.ops import rasterize as t_rast
from volrend_torch.ops import render_exact as t_exact
from volrend_torch.ops import slab_render as t_slab
from volrend_torch.utils.options import RenderOptions
from volrend_tpu.models import mesh as j_mesh
from volrend_tpu.ops import composite as j_comp
from volrend_tpu.ops import display_warp as j_dw
from volrend_tpu.ops import rasterize as j_rast
from volrend_tpu.ops import render_jax as j_exact
from volrend_tpu.ops import slab_render as j_slab
from volrend_tpu.utils.options import RenderOptions as JOpt

torch.set_num_threads(1)

OPT = RenderOptions(max_steps=512)
JOPT = JOpt(max_steps=512)


def _same_mesh(a, b):
    assert a.face_size == b.face_size and a.name == b.name
    np.testing.assert_array_equal(a.vert, b.vert)
    np.testing.assert_array_equal(a.faces, b.faces)
    np.testing.assert_array_equal(a.translation, b.translation)
    np.testing.assert_array_equal(a.rotation, b.rotation)
    assert a.scale == b.scale and a.visible == b.visible
    assert a.unlit == b.unlit


PRIMITIVES = {
    "cube": lambda M: M.Cube((0.2, 0.9, 0.3)),
    "sphere": lambda M: M.Sphere(7, 11, (0.5, 0.1, 0.9)),
    "lattice": lambda M: M.Lattice(3),
    "frustum": lambda M: M.CameraFrustum(111.0, 64, 48),
    "line": lambda M: M.Line((0, 0, 0), (1, 2, 3)),
    "lines": lambda M: M.Lines(np.arange(18, dtype=np.float32)),
    "points": lambda M: M.Points(np.linspace(-1, 1, 12, dtype=np.float32)),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitives_equal_reference(name):
    """Each primitive, repeated and transformed, equals the reference's."""
    a, b = (PRIMITIVES[name](M) for M in (t_mesh.Mesh, j_mesh.Mesh))
    _same_mesh(a, b)
    for m in (a, b):
        m.repeat(2)
        m.apply_transform((0.1, -0.2, 0.3), (1.0, 2.0, 3.0), 0, m.n_verts
                          // 2)
        m.translation = np.asarray((0.1, 0.2, -0.3), np.float32)
        m.rotation = np.asarray((0.0, 0.4, 0.1), np.float32)
        m.scale = 0.7
    _same_mesh(a, b)
    np.testing.assert_array_equal(a.transformed_verts(),
                                  b.transformed_verts())


def test_obj_offs_and_drawlist_equal_reference(tmp_path):
    """An OBJ with vertex colours (normals estimated), its .offs sidecar,
    and a drawlist npz of every mesh type load into equal arrays."""
    obj = tmp_path / "m.obj"
    obj.write_text("v 0 0 0 1 0 0\nv 1 0 0 0 1 0\nv 0 1 0 0 0 1\n"
                   "v 1 1 0.5\nf 1 2 3\nf 1 2 3 4\n")
    (tmp_path / "m.obj.offs").write_text("1 2 3 0.25 junk")
    _same_mesh(t_mesh.load_basic_obj(str(obj)),
               j_mesh.load_basic_obj(str(obj)))
    rng = np.random.default_rng(0)
    p = str(tmp_path / "draw.npz")
    np.savez(p, mycube="cube",
             mycube__color=np.array([0.1, 0.2, 0.3], np.float32),
             mycube__scale=np.float32(2.0),
             mycube__translation=np.array([1, 2, 3], np.float32),
             ball="sphere", ball__rings=np.int32(5),
             ball__sectors=np.int32(7),
             cams="camerafrustum",
             cams__t=rng.normal(size=(3, 3)).astype(np.float32),
             cams__r=rng.normal(size=(3, 3)).astype(np.float32),
             cams__connect=np.int32(1),
             pts="points",
             pts__points=rng.uniform(size=(10, 3)).astype(np.float32),
             pts__vert_color=rng.uniform(size=(10, 3)).astype(np.float32),
             ln="lines",
             ln__points=rng.uniform(size=(6, 3)).astype(np.float32),
             grid="lattice", grid__reso=np.int32(3))
    got, want = t_mesh.open_drawlist(p), j_mesh.open_drawlist(p)
    assert [m.name for m in got] == [m.name for m in want]
    for a, b in zip(got, want):
        _same_mesh(a, b)
    vert = rng.normal(size=(6, 9)).astype(np.float32)
    va, vb = vert.copy(), vert.copy()
    t_mesh.estimate_normals(va, np.array([0, 1, 2, 3, 4, 5], np.uint32))
    j_mesh.estimate_normals(vb, np.array([0, 1, 2, 3, 4, 5], np.uint32))
    np.testing.assert_array_equal(va, vb)


def _cube_pair(cam, k=0.35, color=(1.0, 0.1, 0.1)):
    out = []
    for M in (t_mesh.Mesh, j_mesh.Mesh):
        c = M.Cube(color)
        c.scale = 0.4
        c.translation = np.asarray(cam.center * k, np.float32)
        out.append(c)
    return out


def test_rasterize_bit_equal():
    """Triangles (a lit and an unlit cube), lines (a wireframe) and points
    rasterize into bit-equal colour and distance buffers."""
    cam = make_cam((1.0, 0.3, 0.4), width=40, height=32)
    tt, jt = trees("dense", 4)
    scenes = []
    for M, comp, tree in ((t_mesh.Mesh, t_comp, tt), (j_mesh.Mesh, j_comp,
                                                      jt)):
        a = M.Cube((0.2, 0.9, 0.3))
        b = M.Cube((0.9, 0.2, 0.3))
        b.unlit = True
        b.translation = np.asarray((0.3, -0.2, 0.1), np.float32)
        pts = M.Points(np.linspace(-1, 1, 30, dtype=np.float32))
        scenes.append([a, b, pts, comp.wireframe_mesh(tree, 2)])
    for i in range(len(scenes[0])):
        got = t_rast.rasterize_meshes(scenes[0][: i + 1], cam)
        want = j_rast.rasterize_meshes(scenes[1][: i + 1], cam)
        np.testing.assert_array_equal(got.dist, want.dist)
        np.testing.assert_array_equal(got.color, want.color)
    assert np.isfinite(got.dist).mean() > 0.1


def test_render_rays_mesh_cap_matches_reference():
    """The exact renderer with a mesh pass's distance cap and background
    (render_rays(tmax_bg=, bg_rgb=)) against the reference's, and the whole
    composited frame (render_frame_with_meshes), within the exact
    renderer's tolerance; rays the mesh hits report alpha 1."""
    tdev, _, jdev, _ = scene("dense", 4, "int8")
    cam = make_cam((1.0, 0.25, 0.35), width=32, height=32, fx=40.0)
    tc, jc = _cube_pair(cam)
    buf = j_rast.rasterize_meshes([jc], cam)
    origins, dirs = cam.pixel_rays(xp=np)
    got = t_exact.render_rays(tdev, np.ascontiguousarray(origins), dirs, OPT,
                              tmax_bg=buf.dist.reshape(-1),
                              bg_rgb=buf.color.reshape(-1, 3)).numpy()
    want = np.asarray(j_exact.render_rays(
        jdev, jnp.asarray(origins), jnp.asarray(dirs), JOPT,
        tmax_bg=jnp.asarray(buf.dist.reshape(-1)),
        bg_rgb=jnp.asarray(buf.color.reshape(-1, 3))))
    np.testing.assert_allclose(got, want, atol=2e-5)
    hit = np.isfinite(buf.dist.reshape(-1))
    assert hit.any() and np.all(got[hit, 3] == 1.0)
    frame = t_comp.render_frame_with_meshes(tdev, cam, OPT, [tc])
    np.testing.assert_allclose(frame.reshape(-1, 4), got, atol=1e-6)


def _jit_zb(jg, cam, perm, flip, gi, md):
    """The reference's zb with a mesh (_pallas_frame_fields), under jit as
    its render_frame runs it."""
    def f(tr, d):
        g = j_slab.FrameGeom(jg, tr, cam.fx, cam.fy, perm, flip, cam.width,
                             cam.height, JOPT, gi, mesh_dist=d)
        return j_slab._pallas_frame_fields(jg, g, perm, flip, JOPT)[1]
    return np.asarray(jax.jit(f)(jnp.asarray(cam.transform),
                                 jnp.asarray(md)))


@pytest.mark.parametrize("back,k", [((1.0, 0.25, 0.35), 0.35),
                                    ((-1.0, 0.2, 0.3), 0.55)])
def test_frame_geom_mesh_zbounds_match_reference(back, k):
    """FrameGeom(mesh_dist=) clips each pixel's z interval at the mesh as
    the reference does (both march directions): the z bounds within 1e-5
    (the same f32 operations; the reference's one-hot row gather picks
    what a plain gather picks), the clip active on some pixels."""
    _, g, _, jg = scene("dense", 4, "int8")
    cam = make_cam(back)
    _, jc = _cube_pair(cam, k)
    md = j_rast.rasterize_meshes([jc], cam).dist
    perm, flip, _ = t_slab.choose_axis(g, cam.transform, cam.fx, cam.fy,
                                       cam.width, cam.height)
    gi = 64
    tg = t_slab.FrameGeom(g, cam.transform, cam.fx, cam.fy, perm, flip,
                          cam.width, cam.height, OPT, gi, mesh_dist=md)
    got = np.stack([tg.z_lo_pix[0].numpy(), tg.z_hi_pix[0].numpy()])
    want = _jit_zb(jg, cam, perm, flip, gi, md)[:2]
    plain = t_slab.FrameGeom(g, cam.transform, cam.fx, cam.fy, perm, flip,
                             cam.width, cam.height, OPT, gi)
    assert not np.isnan(want).any()
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)
    clipped = got[0 if flip else 1] != (plain.z_lo_pix if flip
                                        else plain.z_hi_pix)[0].numpy()
    assert clipped.any()


def test_warp_display_mesh_matches_reference_combine(monkeypatch):
    """Kernel W's plain version with a mesh background against the
    reference's combine in its has_mesh mode (_combine_emit(mesh_planes=),
    interpret mode) at the (2, 2) x (4, 4) level: atol 1.2e-2 (the
    reference's test_superquad_warp_mesh_bg tolerance: its table is int8,
    its emit bf16), alpha 1 on every hit pixel; a 64^2 frame at gi=32."""
    _, g, _, jg = scene("dense", 4, "int8")
    H = W = 64
    GI = 32
    cam = make_cam((1.0, 0.25, 0.35), width=W, height=H, fx=90.0)
    perm, flip, _ = t_slab.choose_axis(g, cam.transform, cam.fx, cam.fy, W,
                                       H)
    jgm = j_slab.FrameGeom(jg, jnp.asarray(cam.transform), cam.fx, cam.fy,
                           perm, flip, W, H, JOPT, GI)
    tg = t_slab.FrameGeom(g, cam.transform, cam.fx, cam.fy, perm, flip, W,
                          H, OPT, GI)
    rng = np.random.default_rng(2)
    inter = rng.uniform(0.0, 1.0, (GI, GI, 4)).astype(np.float32)
    dist = rng.uniform(1.0, 3.0, (H, W)).astype(np.float32)
    dist[rng.uniform(size=dist.shape) < 0.4] = np.inf
    rgb = rng.uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)
    B, win = (2, 2), (4, 4)
    prm = t_dw.display_params(tg.R, tg.fx, tg.fy, tg.u0, tg.du, tg.v0,
                              tg.dv, tg.scale, perm)
    mesh = t_dw.mesh_background(dist, rgb, 1, H, W, torch.device("cpu"))
    out = torch.zeros((1, H, W, 4))
    got = t_dw.warp_display_ref(
        torch.as_tensor(np.moveaxis(inter, -1, 0)[None].copy()), prm,
        torch.zeros(1, dtype=torch.int32), out, B, win, GI, 1.0,
        mesh)[0].numpy()
    with interpret(monkeypatch):
        gys, gxs, okm, Y0, X0 = j_dw._level_geometry(
            (jgm.R, jgm.fx, jgm.fy, W, H, GI, perm, jgm.u0, jgm.du, jgm.v0,
             jgm.dv, jgm.scale, None, None), GI, B, win)
        tbl = j_dw._build_table(jnp.asarray(inter), GI, dtype=jnp.int8,
                                win=win)
        W3 = GI - win[1] + 1
        qgp = jnp.transpose(tbl[Y0 * W3 + X0], (2, 0, 1))
        m16 = np.asarray(mesh[0].to(torch.float32))
        planes = jnp.stack([jnp.asarray(m16)[p::2, q::2, c]
                            for p in range(2) for q in range(2)
                            for c in range(4)], 0)
        want = np.asarray(j_dw._combine_emit(
            qgp, gys - Y0.astype(jnp.float32)[None],
            gxs - X0.astype(jnp.float32)[None], okm, H // 2, W // 2, 1.0,
            mesh_planes=planes, B=B, qscale=1.0 / 255.0,
            qshift=128.0 / 255.0, win=win)).reshape(H, W, 4)
    np.testing.assert_allclose(got, want, atol=1.2e-2)
    hit = np.isfinite(dist)
    assert np.all(got[hit, 3] == 1.0) and np.all(want[hit, 3] >= 1.0)


def _mesh_frames(cam, k, gi=128, out_dtype=None):
    tdev, g, jdev, jg = scene("dense", 4, "int8")
    tc, jc = _cube_pair(cam, k)
    got = t_slab.render_image(g, cam, OPT, gi=gi, meshes=[tc],
                              out_dtype=out_dtype)
    want = np.asarray(j_slab.render_image(jg, cam, JOPT, gi=gi,
                                          meshes=[jc]))
    exact = t_comp.render_frame_with_meshes(tdev, cam, OPT, [tc])
    return got, want, exact, t_rast.rasterize_meshes([tc], cam)


@pytest.mark.parametrize("case", ["composite", "occluding", "split"])
def test_render_image_meshes_match_reference(monkeypatch, case):
    """render_image(meshes=) on a pose whose cube sits partly inside the
    volume, one whose cube occludes it, and a steep pose that takes the
    split-frame passes, against the reference's render_image(meshes=)
    (interpret mode; >= 45 dB, measured 59-66 dB) and the exact composite
    (the reference's own gates, tests/test_mesh.py:234-310: >= 28 dB,
    the split pose >= 26 dB); alpha 1 on every mesh pixel, and the
    occluding cube changes the frame."""
    back, k, floor = {"composite": ((1.0, 0.25, 0.35), 0.35, 28.0),
                      "occluding": ((1.0, 0.2, 0.3), 0.55, 28.0),
                      "split": ((1.0, 0.3, 0.4), 0.55, 26.0)}[case]
    cam = make_cam(back, radius=1.2 if case == "split" else 2.5,
                   fx=16.0 if case == "split" else 60.0)
    with interpret(monkeypatch):
        got, want, exact, buf = _mesh_frames(cam, k)
    if case == "split":
        _, _, slope = t_slab.choose_axis(scene("dense", 4, "int8")[1],
                                         cam.transform, cam.fx, cam.fy,
                                         48, 48)
        assert not slope < t_slab.MAX_SLAB_SLOPE
    hit = np.isfinite(buf.dist)
    assert hit.any() and np.all(got[..., 3][hit] > 0.999)
    assert psnr(got[..., :3], want[..., :3]) >= 45.0
    np.testing.assert_allclose(got[..., 3], want[..., 3], atol=2e-3)
    assert psnr(got[..., :3], exact[..., :3]) > floor
    if case == "occluding":
        plain = t_slab.render_image(scene("dense", 4, "int8")[1], cam, OPT,
                                    gi=128)
        assert (np.abs(got - plain).max(-1) > 0.05).any()


def test_render_frame_mesh_superquad_and_uint8():
    """A mesh frame through the superquad warp (gi <= the screen: kernel
    W's plain version with the background) against the same frame through
    the reference warp (the per-pose fallback with the background), and
    the RGBA8 frame against the f32 one within a quantum."""
    _, g, _, _ = scene("dense", 4, "int8")
    cam = make_cam((1.0, 0.25, 0.35), width=96, height=96, fx=120.0)
    tc, _ = _cube_pair(cam, 0.35)
    buf = t_rast.rasterize_meshes([tc], cam)
    perm, flip, _ = t_slab.choose_axis(g, cam.transform, cam.fx, cam.fy, 96,
                                       96)
    n = t_dw.warp_display.mesh_poses
    r0 = t_slab._warp_to_screen_ref.poses
    sq = t_slab.render_frame(g, cam.transform, cam.fx, cam.fy, perm, flip,
                             96, 96, OPT, 48, mesh_dist=buf.dist,
                             mesh_rgb=buf.color)
    assert t_slab._warp_to_screen_ref.poses == r0
    u8 = t_slab.render_frame(g, cam.transform, cam.fx, cam.fy, perm, flip,
                             96, 96, OPT, 48, mesh_dist=buf.dist,
                             mesh_rgb=buf.color, out_dtype=torch.uint8)
    ref = t_slab.render_frame(g, cam.transform, cam.fx, cam.fy, perm, flip,
                              96, 96, OPT, 128, mesh_dist=buf.dist,
                              mesh_rgb=buf.color)
    hit = np.isfinite(buf.dist)
    for f in (sq.numpy(), ref.numpy()):
        assert np.all(f[..., 3][hit] == 1.0)
    assert psnr(sq[..., :3].numpy(), ref[..., :3].numpy()) > 30.0
    q = np.round(np.clip(sq.numpy(), 0, 1) * 255)
    assert np.abs(u8.numpy().astype(np.float64) - q).max() <= 1.0
    assert t_dw.warp_display.mesh_poses == n   # counted on the card only


def test_ndc_mesh_raises():
    """NDC trees take meshes on the exact renderer only (ValueError), as
    in the reference."""
    from _torch_scenes import ndc_scene, ndc_cam
    _, g, _, _ = ndc_scene()
    cam = ndc_cam()
    with pytest.raises(ValueError):
        t_slab.render_image(g, cam, OPT, gi=32,
                            meshes=[t_mesh.Mesh.Cube((1, 0, 0))])
    with pytest.raises(ValueError):
        t_slab.render_frame(g, cam.transform, cam.fx, cam.fy, (2, 0, 1),
                            False, cam.width, cam.height, OPT, 32,
                            mesh_dist=np.ones((cam.height, cam.width)),
                            mesh_rgb=np.zeros((cam.height, cam.width, 3)))


def test_show_grid_composites_the_wireframe(monkeypatch):
    """opt.show_grid with a host tree draws the octree wireframe: the frame
    equals render_image(meshes=[wireframe_mesh(tree, grid_max_depth)]),
    differs from the plain frame on the wire pixels (alpha 1 there), and
    agrees with the exact composite and the reference's frame."""
    tt, jt = trees("dense", 4)
    tdev, g, _, jg = scene("dense", 4, "int8")
    cam = make_cam((1.0, 0.25, 0.35))
    gopt = OPT.replace(show_grid=True, grid_max_depth=2)
    got = t_slab.render_image(g, cam, gopt, gi=128, host_tree=tt)
    same = t_slab.render_image(g, cam, OPT, gi=128,
                               meshes=[t_comp.wireframe_mesh(tt, 2)])
    np.testing.assert_array_equal(got, same)
    buf = t_rast.rasterize_meshes([t_comp.wireframe_mesh(tt, 2)], cam)
    hit = np.isfinite(buf.dist)
    assert hit.sum() > 20 and np.all(got[..., 3][hit] == 1.0)
    plain = t_slab.render_image(g, cam, OPT, gi=128)
    assert (np.abs(got - plain).max(-1)[hit] > 0.01).any()
    exact = t_comp.render_frame_with_meshes(tdev, cam, gopt, [],
                                            host_tree=tt)
    with interpret(monkeypatch):
        want = np.asarray(j_slab.render_image(
            jg, cam, JOPT.replace(show_grid=True, grid_max_depth=2),
            gi=128, host_tree=jt))
    assert psnr(got[..., :3], want[..., :3]) >= 45.0
    # one-pixel wires quantize the slab path's mesh clip (nearest screen
    # pixel of each slope-grid ray) well below a solid mesh's 28 dB: the
    # port stays within 0.5 dB of the reference's frame against the exact
    # composite (both ~24.8 dB here)
    p_ref = psnr(want[..., :3], exact[..., :3])
    assert psnr(got[..., :3], exact[..., :3]) >= p_ref - 0.5 > 20.0


def test_probe_helpers_match_reference():
    """probe_coeffs, probe_image and draw_probe_inset (float and uint8
    frames) against the reference's."""
    tdev, _, jdev, _ = scene("dense", 4, "int8")
    cam = make_cam((1.0, 0.25, 0.35), width=64, height=64)
    opt = OPT.replace(enable_probe=True, probe=(0.1, -0.2, 0.05),
                      probe_disp_size=24, basis_minmax=(0, 2))
    jopt = JOPT.replace(enable_probe=True, probe=(0.1, -0.2, 0.05),
                        probe_disp_size=24, basis_minmax=(0, 2))
    np.testing.assert_array_equal(t_comp.probe_coeffs(tdev, opt.probe),
                                  j_comp.probe_coeffs(jdev, opt.probe))
    np.testing.assert_allclose(t_comp.probe_image(tdev, opt.probe, 16),
                               j_comp.probe_image(jdev, opt.probe, 16),
                               atol=1e-6)
    frame = np.random.default_rng(1).uniform(size=(64, 64, 4)).astype(
        np.float32)
    for f in (frame, (frame * 255).astype(np.uint8)):
        got = t_comp.draw_probe_inset(f, tdev, cam, opt)
        want = j_comp.draw_probe_inset(f, jdev, cam, jopt)
        assert got.dtype == f.dtype
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), atol=1e-5)
