"""The port's web viewer (``volrend_torch/web/server.py``) and its cameras
(``ops/camera.py``'s ``DragCamera`` and ``ndc_camera``) against the
reference's (``volrend_tpu``) on the CPU: tests/test_web.py's cases on the
port (``device="cpu"``), then parity: the drag camera after the same input
sequence, the NDC camera, ``/info`` (all but the backend's name), frames
after the same events (the exact renderer within one uint8 quantum; the
slab path with a visible cube, both packages on the int8 bake, at
tests/test_torch_frames.py's gate), the backend names, and the bake's
errors raising instead of falling through to the exact renderer."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from volrend_torch.models.mesh import Mesh
from volrend_torch.models.synthetic import make_test_tree
from volrend_torch.utils.png import read_png
from volrend_torch.web.server import ViewerState, make_handler

from _torch_scenes import frames_agree

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def server():
    from http.server import ThreadingHTTPServer
    tree = make_test_tree(max_depth=3, basis_dim=4, seed=5, sigma_scale=60.0)
    cube = Mesh.Cube((1, 0, 0))
    cube.visible = False
    state = ViewerState(tree, [cube], use_slab=False, device="cpu")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_port}", state
    httpd.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.read()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def test_index_and_info(server):
    base, state = server
    html = _get(base + "/").decode()
    assert "<canvas" in html
    info = json.loads(_get(base + "/info"))
    assert info["format"] == "SH4"
    assert info["meshes"][0]["name"] == "Cube"
    assert "step_size" in info["options"]


def test_frame_render(server, tmp_path):
    base, state = server
    png = _get(base + "/frame?w=64&h=64")
    p = tmp_path / "f.png"
    p.write_bytes(png)
    img = read_png(str(p))
    assert img.shape == (64, 64, 4)
    assert (img[..., :3].min(-1) < 250).mean() > 0.005  # scene visible


def test_drag_orbit_changes_view(server, tmp_path):
    base, state = server
    before = _get(base + "/frame?w=48&h=48")
    _post(base + "/event", {"type": "down", "x": 10, "y": 10, "pan": False,
                            "about_origin": True})
    _post(base + "/event", {"type": "move", "x": 35, "y": 14})
    _post(base + "/event", {"type": "up"})
    after = _get(base + "/frame?w=48&h=48")
    assert before != after


def test_options_and_mesh_toggle(server):
    base, state = server
    _post(base + "/options", {"background_brightness": 0.25})
    assert state.opt.background_brightness == 0.25
    _post(base + "/mesh", {"name": "Cube", "visible": True})
    assert state.meshes[0].visible
    _post(base + "/mesh", {"name": "Cube", "visible": False})
    assert not state.meshes[0].visible


def test_wheel_dolly(server):
    base, state = server
    c0 = np.linalg.norm(state.cam.center - state.cam.origin)
    _post(base + "/event", {"type": "wheel", "dy": -100})
    c1 = np.linalg.norm(state.cam.center - state.cam.origin)
    assert c1 < c0


def test_probe_endpoint(server, tmp_path):
    base, state = server
    png = _get(base + "/probe?x=0.1&y=0.2&z=0.3&size=32")
    p = tmp_path / "probe.png"
    p.write_bytes(png)
    img = read_png(str(p))
    assert img.shape == (32, 32, 3)


def test_probe_inset_in_served_frame(server, tmp_path):
    """enable_probe draws the in-frame inset circle at the top-right of
    viewer frames (volrend.cu:100-134), and disabling removes it."""
    base, state = server
    _post(base + "/options", {"enable_probe": True, "probe": [0.1, 0.2, 0.3],
                              "probe_disp_size": 20})
    on = _get(base + "/frame?w=64&h=64")
    _post(base + "/options", {"enable_probe": False})
    off = _get(base + "/frame?w=64&h=64")
    pa, pb = tmp_path / "on.png", tmp_path / "off.png"
    pa.write_bytes(on)
    pb.write_bytes(off)
    a, b = read_png(str(pa)), read_png(str(pb))
    # the inset region differs; the bottom half doesn't
    assert np.any(a[:25, 64 - 25:] != b[:25, 64 - 25:])
    assert np.array_equal(a[32:], b[32:])


def test_ndc_camera_init():
    """NDC mean-pose camera init (main.cpp:731-741): fixed canonical pose
    + focal = ndc_focal * 0.25."""
    from volrend_torch.models.n3tree import NdcConfig
    from volrend_torch.ops.camera import ndc_camera
    ndc = NdcConfig(width=1008.0, height=756.0, focal=800.0,
                    avg_up=(0.1, 0.9, 0.2), avg_back=(0, 0, 1),
                    avg_cen=(1, 2, 3))
    cam = ndc_camera(ndc, width=640, height=480)
    assert cam.fx == pytest.approx(200.0)
    assert cam.fy == pytest.approx(200.0)
    # nudged 1e-3 off the z=0 plane so the default pose stays on the slab
    # fast path (pi(origin) is at infinity exactly on the plane)
    np.testing.assert_allclose(cam.center, [0, 0, 1e-3], atol=1e-7)
    np.testing.assert_allclose(cam.v_back, [0, 0, 1])
    np.testing.assert_allclose(cam.origin, [0, 0, -3])
    np.testing.assert_allclose(cam.v_world_up, [0, 1, 0])
    assert cam.movement_speed == pytest.approx(0.1)
    # orthonormal basis, right = up x back
    R = cam.transform[:, :3]
    np.testing.assert_allclose(R.T @ R, np.eye(3), atol=1e-6)
    # explicit fx wins over the ndc default
    assert ndc_camera(ndc, fx=333.0).fx == pytest.approx(333.0)


def test_viewer_ndc_tree_faces_scene(tmp_path):
    """Viewer on an NDC tree opens with the mean-pose camera and renders
    non-empty output."""
    from volrend_torch.models.n3tree import NdcConfig
    tree = make_test_tree(max_depth=3, basis_dim=4, seed=7, sigma_scale=80.0)
    tree.use_ndc = True
    tree.ndc = NdcConfig(width=800.0, height=800.0, focal=1000.0)
    state = ViewerState(tree, use_slab=False, device="cpu")
    assert state.fixed_focal
    assert state.cam.fx == pytest.approx(250.0)
    img = state.render(64, 64)
    p = tmp_path / "ndc.png"
    p.write_bytes(img)
    arr = read_png(str(p))
    assert state.cam.fx == pytest.approx(250.0)  # render didn't clobber it
    assert float(np.asarray(arr, np.float32).std()) > 1.0


def test_mesh_transform_endpoints(server):
    """The ImGuizmo manipulation surface (main.cpp:238-413): per-mesh
    translate/rotate/scale/unlit + delete via POST /mesh."""
    base, state = server
    _post(base + "/mesh", {"name": "Cube", "translation": [0.1, 0.2, 0.3],
                           "rotation": [0.0, 0.5, 0.0], "scale": 1.5,
                           "unlit": True, "visible": True})
    m = next(mm for mm in state.meshes if mm.name == "Cube")
    np.testing.assert_allclose(m.translation, [0.1, 0.2, 0.3])
    np.testing.assert_allclose(m.rotation, [0.0, 0.5, 0.0])
    assert m.scale == 1.5 and m.unlit and m.visible
    info = json.loads(_get(base + "/info"))
    mi = next(mm for mm in info["meshes"] if mm["name"] == "Cube")
    assert mi["scale"] == 1.5 and mi["unlit"]

    # add a primitive, then delete it
    out = json.loads(_post(base + "/mesh/add", {"type": "sphere"}))
    assert out["name"] == "Sphere"
    assert any(mm.name == "Sphere" for mm in state.meshes)
    _post(base + "/mesh", {"name": "Sphere", "delete": True})
    assert not any(mm.name == "Sphere" for mm in state.meshes)


def test_probe_and_camera_keys(server):
    base, state = server
    # probe keys only act when the probe is enabled (main.cpp:519)
    _post(base + "/options", {"enable_probe": True, "probe": [0, 0, 1]})
    p0 = np.asarray(state.opt.probe)
    _post(base + "/event", {"type": "key", "key": "l"})
    _post(base + "/event", {"type": "key", "key": "i", "shift": True})
    p1 = np.asarray(state.opt.probe)
    assert p1[0] > p0[0]
    assert p1[1] - p0[1] > 5 * (p1[0] - p0[0]) - 1e-9  # shift = 5x
    # focal keys
    f0 = state.cam.fx
    _post(base + "/event", {"type": "key", "key": "-"})
    assert state.cam.fx < f0
    _post(base + "/event", {"type": "key", "key": "0"})
    from volrend_torch.ops.camera import DEFAULT_FOCAL
    assert state.cam.fx == DEFAULT_FOCAL
    # world_up presets (main.cpp:546-570)
    _post(base + "/event", {"type": "key", "key": "3"})
    np.testing.assert_allclose(state.cam.v_world_up, [0, 1, 0])
    _post(base + "/event", {"type": "key", "key": "1"})
    np.testing.assert_allclose(state.cam.v_world_up, [0, 0, 1])
    _post(base + "/options", {"enable_probe": False})


def test_runtime_asset_loading(server, tmp_path):
    """Runtime tree/drawlist/obj loading via upload bytes and server path
    (web/main_web.cpp:139-294 analog)."""
    base, state = server
    # tree upload (bytes)
    t2 = make_test_tree(max_depth=3, basis_dim=1, seed=9, sigma_scale=70.0)
    p = tmp_path / "t2.npz"
    t2.save_npz(str(p))
    with open(p, "rb") as f:
        raw = f.read()
    import urllib.request
    req = urllib.request.Request(base + "/upload?kind=tree", data=raw,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        out = json.loads(r.read())
    assert out["loaded"] == "tree"
    assert state.tree.data_dim == t2.data_dim

    # drawlist via server-side path
    draw = {"mycube": np.array(["cube"]),
            "mycube__color": np.array([1.0, 0.0, 0.0], np.float32)}
    dp = tmp_path / "draw.npz"
    np.savez(str(dp), **draw)
    out = json.loads(_post(base + "/load",
                           {"kind": "drawlist", "path": str(dp)}))
    assert out["meshes"] == ["mycube"]
    assert any(m.name == "mycube" for m in state.meshes)

    # obj upload
    obj = b"v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n"
    req = urllib.request.Request(base + "/upload?kind=obj", data=obj,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        out = json.loads(r.read())
    assert out["loaded"] == "obj"


def test_viewer_page_has_touch_and_mesh_ui(server):
    base, _ = server
    html = _get(base + "/").decode()
    for needle in ("touchstart", "touchmove", "touchend", "uploadAsset",
                   "addMesh", "meshVec"):
        assert needle in html, needle


def test_visualization_options_roundtrip(server):
    """The reference GUI's visualization section (main.cpp:200-236): SH
    band window, viewdir rotation, render bbox, depth toggle — /info must
    expose them and /options must accept them."""
    base, state = server
    info = json.loads(_get(base + "/info"))
    for k in ("basis_minmax", "rot_dirs", "render_bbox"):
        assert k in info["options"], k
    _post(base + "/options", {"basis_minmax": [1, 3],
                              "rot_dirs": [0.1, 0.0, -0.2],
                              "render_bbox": [0.1, 0.1, 0.1, 0.9, 0.9,
                                              0.9],
                              "render_depth": True})
    assert state.opt.basis_minmax == (1, 3)
    assert state.opt.rot_dirs == (0.1, 0.0, -0.2)
    assert state.opt.render_bbox == (0.1, 0.1, 0.1, 0.9, 0.9, 0.9)
    assert state.opt.render_depth is True
    # frame still renders with the visualization options active
    png = _get(base + "/frame?w=32&h=32")
    assert png[:4] == b"\x89PNG"
    _post(base + "/options", {"render_depth": False,
                              "basis_minmax": [0, 24],
                              "rot_dirs": [0.0, 0.0, 0.0],
                              "render_bbox": [0, 0, 0, 1, 1, 1]})


def test_anim_keyframe_editor(server, tmp_path):
    """Keyframe animation editor endpoints (the main_anim.cpp:350-925
    ImGui editor analog): capture/list/update/goto/seek/save/delete."""
    base, state = server
    state.keyframes = []
    # two poses captured from live camera state
    _post(base + "/event", {"type": "key", "key": "w"})
    a = json.loads(_post(base + "/anim/capture", {"t_max": 2.0}))
    assert a["n"] == 1 and a["index"] == 0
    c0 = np.asarray(state.cam.center, float).copy()
    _post(base + "/event", {"type": "key", "key": "d", "shift": True})
    a = json.loads(_post(base + "/anim/capture", {}))
    assert a["n"] == 2
    c1 = np.asarray(state.cam.center, float).copy()
    assert not np.allclose(c0, c1)

    lst = json.loads(_get(base + "/anim/list"))
    assert lst["n"] == 2
    # segment duration = END keyframe's t_max (frame_times semantics)
    assert lst["total"] == lst["keyframes"][1]["t_max"]

    # update duration
    json.loads(_post(base + "/anim/update", {"index": 1, "t_max": 4.0}))
    lst = json.loads(_get(base + "/anim/list"))
    assert lst["total"] == 4.0

    # goto restores the captured pose exactly
    _post(base + "/anim/goto", {"index": 0})
    np.testing.assert_allclose(np.asarray(state.cam.center, float), c0,
                               atol=1e-5)

    # seek to the midpoint matches anim.interpolate directly
    from volrend_torch import anim
    out = json.loads(_post(base + "/anim/seek", {"t": 2.0}))
    assert out["segment"] == 0 and abs(out["q"] - 0.5) < 1e-6
    want = anim.interpolate(state.keyframes[0], state.keyframes[1], 0.5,
                            state.cam.v_world_up, first_segment=True)
    np.testing.assert_allclose(np.asarray(state.cam.center, float),
                               np.asarray(want[0], float), atol=1e-5)

    # save round-trips through the cli/animate script loader
    p = tmp_path / "anim.json"
    out = json.loads(_post(base + "/anim/save", {"path": str(p)}))
    assert out["n"] == 2
    kfs, cfg = anim.load_script(str(p))
    assert len(kfs) == 2 and kfs[1].t_max == 4.0
    np.testing.assert_allclose(kfs[0].center, c0, atol=1e-6)

    # load replaces the editor state
    state.keyframes = []
    out = json.loads(_post(base + "/anim/load", {"path": str(p)}))
    assert out["n"] == 2

    # delete
    out = json.loads(_post(base + "/anim/delete", {"index": 0}))
    assert out["n"] == 1
    state.keyframes = []


def test_anim_export_frames(server, tmp_path):
    """Export renders every scheduled frame to PNG (main_anim.cpp:95-110
    export mode), reporting progress via /anim/list."""
    import time
    base, state = server
    state.keyframes = []
    _post(base + "/anim/capture", {})
    _post(base + "/event", {"type": "key", "key": "a"})
    _post(base + "/anim/capture", {"t_max": 0.5})
    out_dir = tmp_path / "frames"
    out = json.loads(_post(base + "/anim/export", {
        "path": str(out_dir), "fps": 4, "width": 32, "height": 32}))
    assert out["started"]
    for _ in range(600):
        if not state.anim_status["running"]:
            break
        time.sleep(0.1)
    assert not state.anim_status["running"]
    import os
    files = sorted(os.listdir(out_dir))
    assert len(files) == out["total"] == state.anim_status["done"]
    from volrend_torch.utils.png import read_png
    img = read_png(str(out_dir / files[0]))
    assert img.shape == (32, 32, 4)
    state.keyframes = []


def test_anim_error_paths(server):
    base, state = server
    state.keyframes = []
    import urllib.error
    with pytest.raises(urllib.error.HTTPError):
        _post(base + "/anim/seek", {"t": 0.0})   # needs >= 2 keyframes
    with pytest.raises(urllib.error.HTTPError):
        _post(base + "/anim/bogus", {})


def test_viewer_page_has_anim_ui(server):
    base, _ = server
    html = _get(base + "/").decode()
    for frag in ("animCapture", "animPlay", "animExport", "/anim/seek"):
        assert frag in html


def test_anim_unlit_roundtrips_through_script(server, tmp_path):
    """Mesh unlit state survives capture -> save -> load (the script
    writer and reader carry it, not only capture and apply)."""
    from volrend_torch import anim
    base, state = server
    state.keyframes = []
    state.meshes[0].unlit = True
    _post(base + "/anim/capture", {})
    _post(base + "/anim/capture", {})
    p = tmp_path / "unlit.json"
    _post(base + "/anim/save", {"path": str(p)})
    kfs, _ = anim.load_script(str(p))
    assert kfs[0].mesh_state["Cube"].unlit is True
    state.meshes[0].unlit = False
    state.keyframes = []


def test_anim_export_bad_path_does_not_wedge(server, tmp_path):
    """A failing export request must not leave anim_status running=True
    (the output directory is made before the status is set running)."""
    import urllib.error
    base, state = server
    state.keyframes = []
    _post(base + "/anim/capture", {})
    _post(base + "/anim/capture", {})
    blocker = tmp_path / "afile"
    blocker.write_text("x")
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/anim/export", {"path": str(blocker)})
    assert ei.value.code == 400
    assert not state.anim_status["running"]
    # feature still usable afterwards
    out_dir = tmp_path / "ok"
    out = json.loads(_post(base + "/anim/export", {
        "path": str(out_dir), "fps": 2, "width": 16, "height": 16}))
    assert out["started"]
    import time
    for _ in range(300):
        if not state.anim_status["running"]:
            break
        time.sleep(0.1)
    assert state.anim_status["done"] == out["total"]
    # load of a missing script returns 400, not a closed connection
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/anim/load", {"path": str(tmp_path / "nope.json")})
    assert ei.value.code == 400
    state.keyframes = []


def test_mesh_gizmo_projection_and_drag(server):
    """In-viewport gizmo (ImGuizmo analog): /gizmo projects the mesh center
    through the live camera; /mesh/drag maps pixel deltas to transforms."""
    base, state = server
    m = next(mm for mm in state.meshes if mm.name == "Cube")
    m.translation = np.zeros(3, np.float32)
    m.rotation = np.zeros(3, np.float32)
    m.scale = 1.0

    g = json.loads(_get(base + "/gizmo?name=Cube"))
    assert g["visible"]
    cx, cy = g["center"]
    # projected center must re-project consistently: move the mesh exactly
    # +right in world via a drag, screen x must increase
    out = json.loads(_post(base + "/mesh/drag",
                           {"name": "Cube", "mode": "translate",
                            "dx": 40.0, "dy": 0.0}))
    g2 = json.loads(_get(base + "/gizmo?name=Cube"))
    assert g2["center"][0] > cx + 20  # moved ~40 px right
    assert abs(g2["center"][1] - cy) < 2

    # vertical drag translates along -v_up
    before = np.asarray(out["translation"])
    out = json.loads(_post(base + "/mesh/drag",
                           {"name": "Cube", "mode": "translate",
                            "dx": 0.0, "dy": 30.0}))
    moved = np.asarray(out["translation"]) - before
    up = np.asarray(state.cam.v_up, np.float64)
    assert moved @ up < 0

    # rotate about the view axis changes the rotation vector
    out = json.loads(_post(base + "/mesh/drag",
                           {"name": "Cube", "mode": "rotate",
                            "dx": 50.0, "dy": 0.0}))
    rv = np.asarray(out["rotation"], np.float64)
    assert np.linalg.norm(rv) == pytest.approx(0.5, rel=1e-3)
    view = -np.asarray(state.cam.v_back, np.float64)
    assert abs(abs(rv / np.linalg.norm(rv) @ view) - 1.0) < 1e-6

    # scale: drag up grows, exp-compounded
    out = json.loads(_post(base + "/mesh/drag",
                           {"name": "Cube", "mode": "scale",
                            "dx": 0.0, "dy": -69.3}))
    assert out["scale"] == pytest.approx(2.0, rel=1e-2)

    # unknown mesh -> 404/400
    import urllib.error
    with pytest.raises(urllib.error.HTTPError):
        _get(base + "/gizmo?name=Nope")
    with pytest.raises(urllib.error.HTTPError):
        _post(base + "/mesh/drag", {"name": "Nope", "mode": "translate"})
    m.translation = np.zeros(3, np.float32)
    m.rotation = np.zeros(3, np.float32)
    m.scale = 1.0


def test_viewer_page_has_gizmo_ui(server):
    base, _ = server
    html = _get(base + "/").decode()
    for frag in ("drawGizmo", "/mesh/drag", "grab", "gizmo.mode"):
        assert frag in html


def test_info_reports_backend(server):
    """get_backend() parity (cuda_renderer.cpp:225): /info names the path
    that produced the last frame."""
    base, state = server
    _get(base + "/frame?w=32&h=32")
    info = json.loads(_get(base + "/info"))
    assert info["backend"] == "exact"   # fixture runs use_slab=False


def test_slab_backend_with_visible_mesh():
    """A visible mesh (+ show_grid wireframe) must
    STAY on the slab fast path — /info reports slab-*, not 'exact' (the
    reference composites meshes inside the render kernel at full speed,
    volrend.cu:143-163)."""
    tree = make_test_tree(max_depth=3, basis_dim=4, seed=5,
                          sigma_scale=60.0)
    cube = Mesh.Cube((1.0, 0.2, 0.2))
    cube.scale = 0.4
    state = ViewerState(tree, [cube], use_slab=True, device="cpu")
    state.opt = state.opt.replace(show_grid=True)
    png = state.render(64, 64)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert state.last_backend.startswith("slab-"), state.last_backend
    assert state.last_backend == "slab-cpu"   # the plain versions ran


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------

def _camera_script(cam):
    """Drags about the origin and about the camera, a pan, a drag the
    pole check refuses, a wheel dolly (the viewer's), moves and a
    world-up change, applied to ``cam``; the transform after each step."""
    out = []
    seq = [("drag", 10, 10, False, True, [(40, 14), (80, 30)]),
           ("drag", 50, 50, False, False, [(60, 40), (30, 20)]),
           ("drag", 20, 20, True, True, [(35, 50)]),
           ("drag", 0, 0, False, True, [(0, -900)]),
           ("wheel", -60.0), ("move", (0.1, -0.2, 0.05)),
           ("up", (0.0, 1.0, 0.0)), ("drag", 5, 5, False, True, [(25, 9)]),
           ("wheel", 35.0), ("move", (-0.3, 0.0, 0.2))]
    for step in seq:
        if step[0] == "drag":
            _, x, y, pan, about, moves = step
            cam.begin_drag(x, y, pan, about)
            for mx, my in moves:
                cam.drag_update(mx, my)
                out.append(cam.transform.copy())
            if step is seq[1]:
                cam.move((0.05, 0.0, 0.0))     # a move during a drag
                cam.drag_update(31, 21)
                out.append(cam.transform.copy())
            cam.end_drag()
        elif step[0] == "wheel":
            sp = 1.0 + np.clip(step[1], -100, 100) * 0.002
            cam.update_basis(center=cam.origin + (cam.center - cam.origin)
                             * sp)
        elif step[0] == "move":
            cam.move(step[1])
        else:
            cam.v_world_up = np.asarray(step[1], np.float32)
            cam.update_basis()
        out.append(cam.transform.copy())
    out.append(cam.origin.copy())
    return out


def test_drag_camera_matches_reference():
    """DragCamera after the same drag, pan, wheel, move and world-up
    sequence: every transform within 1e-6 of the reference's."""
    from volrend_tpu.ops import camera as j_camera
    from volrend_torch.ops import camera

    def make(mod):
        cam = mod.DragCamera(width=640, height=480, fx=300.0,
                             movement_speed=0.7)
        cam.update_basis(v_back=np.array([-0.7071, 0.0, 0.7071]),
                         center=np.array([-3.55, 0.0, 3.55]) / 1.3)
        return cam

    got = _camera_script(make(camera))
    want = _camera_script(make(j_camera))
    assert len(got) == len(want) > 10
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for a, b in ((0.3, 1.2), (0.0, 1.0), (1.1, 1e-13)):
        np.testing.assert_allclose(camera._axis_angle((a, b, 0.5), b),
                                   j_camera._axis_angle((a, b, 0.5), b),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("fx", [-1.0, 333.0])
def test_ndc_camera_matches_reference(fx):
    from volrend_tpu.models.n3tree import NdcConfig as JNdc
    from volrend_tpu.ops.camera import ndc_camera as j_ndc_camera
    from volrend_torch.models.n3tree import NdcConfig
    from volrend_torch.ops.camera import ndc_camera
    kw = dict(width=1008.0, height=756.0, focal=800.0,
              avg_up=(0.1, 0.9, 0.2), avg_back=(0, 0, 1), avg_cen=(1, 2, 3))
    a = ndc_camera(NdcConfig(**kw), width=640, height=480, fx=fx)
    b = j_ndc_camera(JNdc(**kw), width=640, height=480, fx=fx)
    for f in ("transform", "origin", "v_world_up"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=0,
                                   atol=1e-6)
    assert (a.fx, a.fy, a.width, a.height, a.movement_speed) == \
        (b.fx, b.fy, b.width, b.height, b.movement_speed)


EVENTS = [{"type": "down", "x": 10, "y": 10, "pan": False,
           "about_origin": True},
          {"type": "move", "x": 30, "y": 16},
          {"type": "up"},
          {"type": "wheel", "dy": -40},
          {"type": "key", "key": "d"},
          {"type": "down", "x": 20, "y": 20, "pan": True,
           "about_origin": True},
          {"type": "move", "x": 24, "y": 22},
          {"type": "up"},
          {"type": "key", "key": "="}]


def _pair(use_slab, with_cube):
    """The port's and the reference's ViewerState on the same tree (and
    cube), the reference's grid its int8 bake."""
    from volrend_tpu.models.mesh import Mesh as JMesh
    from volrend_tpu.models.synthetic import make_test_tree as j_make
    from volrend_tpu.ops import dense_grid as j_dense_grid
    from volrend_tpu.web.server import ViewerState as JViewerState

    def cube(M):
        c = M.Cube((1.0, 0.2, 0.2))
        c.scale = 0.4
        c.visible = with_cube
        return [c]

    kw = dict(max_depth=3, basis_dim=4, seed=5, sigma_scale=60.0)
    a = ViewerState(make_test_tree(**kw), cube(Mesh), use_slab=use_slab,
                    device="cpu")
    b = JViewerState(j_make(**kw), cube(JMesh), use_slab=use_slab)
    if use_slab:
        b.grid = j_dense_grid.bake_dense(b.dev, dtype="int8")
    return a, b


def _png(data, tmp_path, tag):
    p = tmp_path / f"{tag}.png"
    p.write_bytes(data)
    return read_png(str(p)).astype(np.int32)


def test_info_matches_reference():
    """/info equals the reference's in every field but the backend's name
    (after a render, the backends are slab-cpu and slab-xla)."""
    a, b = _pair(True, True)
    a.render(32, 32)
    b.render(32, 32)
    ia, ib = a.info(), b.info()
    assert (ia.pop("backend"), ib.pop("backend")) == ("slab-cpu", "slab-xla")
    assert json.loads(json.dumps(ia)) == json.loads(json.dumps(ib))


@pytest.mark.parametrize("use_slab", [False, True], ids=["exact", "slab"])
def test_frames_after_events_match_reference(use_slab, tmp_path):
    """The same event sequence through both viewers: equal cameras, and
    frames that agree (the exact renderer within one quantum; the slab
    path with the cube visible at the frame gate); /info's backend names
    what ran."""
    a, b = _pair(use_slab, with_cube=use_slab)
    for i, ev in enumerate(EVENTS):
        a.handle_event(dict(ev))
        b.handle_event(dict(ev))
        np.testing.assert_allclose(a.cam.transform, b.cam.transform,
                                   rtol=0, atol=1e-6)
        if i % 4 == 3 or i == len(EVENTS) - 1:
            got = _png(a.render(48, 40), tmp_path, f"a{i}")
            want = _png(b.render(48, 40), tmp_path, f"b{i}")
            assert got.shape == want.shape == (40, 48, 4)
            frames_agree(got, want, "slab" if use_slab else "exact")
            assert a.last_backend == ("slab-cpu" if use_slab else "exact")


def test_backend_names_split_and_ndc():
    """A pose past the slab gate on a world tree renders as split-frame
    passes (slab-split); on an NDC tree the default pose takes the slab
    path, a visible mesh the exact renderer."""
    from volrend_torch.models.n3tree import NdcConfig
    tree = make_test_tree(max_depth=3, basis_dim=4, seed=5,
                          sigma_scale=60.0)
    state = ViewerState(tree, use_slab=True, device="cpu")
    # tools/perf_split.py's e = 0.5 sweep pose (boundary slope ~5.1),
    # its focal length scaled from 800 to 32 pixels
    back = np.array([np.cos(0.5), 0.2, np.sin(0.5)])
    back /= np.linalg.norm(back)
    state.cam.update_basis(v_back=back, center=1.35 * back)
    state.fixed_focal = True
    state.cam.fx = state.cam.fy = 420.0 * 32 / 800
    state.render(32, 32)
    assert state.last_backend == "slab-split"
    ndc = make_test_tree(max_depth=3, basis_dim=4, seed=7, sigma_scale=80.0)
    ndc.use_ndc = True
    ndc.ndc = NdcConfig(width=800.0, height=800.0, focal=1000.0)
    cube = Mesh.Cube()
    cube.visible = False
    st = ViewerState(ndc, [cube], use_slab=True, device="cpu")
    st.render(32, 32)
    assert st.last_backend == "slab-cpu"
    st.meshes[0].visible = True
    st.render(32, 32)
    assert st.last_backend == "exact"


def test_bake_errors_raise(monkeypatch, tmp_path):
    """A failing bake raises from ViewerState and from a tree load; the
    viewer never falls through to the exact renderer on its own, and a
    failed load leaves the current tree in place."""
    from volrend_torch.ops import dense_grid
    tree = make_test_tree(max_depth=2, basis_dim=1, seed=1)
    state = ViewerState(tree, use_slab=True, device="cpu")
    p = tmp_path / "t.npz"
    make_test_tree(max_depth=2, basis_dim=4, seed=2).save_npz(str(p))

    def broken(*a, **kw):
        raise RuntimeError("bake failed")

    monkeypatch.setattr(dense_grid, "bake_dense", broken)
    with pytest.raises(RuntimeError, match="bake failed"):
        ViewerState(tree, use_slab=True, device="cpu")
    with pytest.raises(RuntimeError, match="bake failed"):
        state.load_asset("tree", path=str(p))
    assert state.tree is tree and state.grid is not None
    assert ViewerState(tree, use_slab=False, device="cpu").grid is None


def test_build_server_warms_and_serves():
    """build_server renders one warm frame before it takes requests and
    serves the state it holds."""
    import tempfile
    from volrend_torch.web.server import build_server
    with tempfile.TemporaryDirectory() as d:
        p = f"{d}/t.npz"
        make_test_tree(max_depth=2, basis_dim=4, seed=3).save_npz(p)
        httpd = build_server(p, port=0, host="127.0.0.1", device="cpu")
    state = httpd.state
    assert state.last_backend == "slab-cpu"
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        info = json.loads(_get(f"http://127.0.0.1:{httpd.server_port}"
                               "/info"))
        assert info["backend"] == "slab-cpu"
    finally:
        httpd.shutdown()
        httpd.server_close()
