"""Interactive web viewer — the CUDA-rendering equivalent of the reference
web app (``web/main_web.cpp`` + ``web/js/*``; the counterpart of
``volrend_tpu/web/server.py``).

The reference compiles the GL renderer to WASM and runs client-side; here
rendering stays server-side on the card and the browser is a thin canvas +
input layer. The JS API surface mirrors the embind bindings
(``web/main_web.cpp:455-545``): camera orbit/pan/zoom with the reference
drag semantics (DragCamera), get/set RenderOptions, mesh layer visibility,
FPS readout. The page is the reference package's, byte for byte.

Frames: on a world tree the int8 bake through ``slab_render.render_image``
(kernel M's display mode and kernel W, W's mesh mode under a visible mesh
or ``show_grid``; split-frame passes for poses past the slab gate); on an
NDC tree the same where the pose passes the gate (kernels M and W, W on
the NDC rows) and the exact renderer where it does not or where a mesh is
visible. A bake or render error raises: nothing falls through to a slower
path on its own (``use_slab=False`` is the caller's choice of the exact
renderer).
``ViewerState.last_backend`` names what rendered the last frame:
``slab-cuda`` (kernels on the card), ``slab-cpu`` (their plain versions,
on a CPU device), ``slab-split`` (split-frame passes) or ``exact``.

Endpoints:
  GET  /                     viewer page (mouse + touch/pinch input)
  GET  /info                 tree metadata + mesh layers/transforms + options
  GET  /frame?w=&h=          current-state render as PNG
  GET  /probe?x=&y=&z=       lumisphere probe ball PNG
  POST /event                {type: down|move|up|wheel|key, ...} input
                             (keys: wasdqe camera, ijkluo probe, -/=/0
                             focal, 1-6 world_up presets; main.cpp:452-573)
  POST /options              partial RenderOptions update
  POST /mesh                 {name, visible?, unlit?, translation?,
                             rotation?, scale?, delete?} — the ImGuizmo
                             manipulation surface (main.cpp:238-413)
  POST /mesh/add             {type: sphere|cube|lattice} primitive
  POST /load                 {kind, path} server-side runtime asset load
  POST /upload?kind=         raw tree/drawlist/obj bytes from the browser
                             (web/main_web.cpp:139-294 analog)
"""

from __future__ import annotations

import dataclasses
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from volrend_torch.models.mesh import Mesh
from volrend_torch.models.n3tree import N3Tree
from volrend_torch.ops.camera import DragCamera
from volrend_torch.utils import png as png_mod
from volrend_torch.utils.device import DeviceLike, resolve
from volrend_torch.utils.options import RenderOptions
from volrend_torch.utils.profiling import fps_counter

_INDEX_HTML = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>volrend-tpu viewer</title>
<style>
body { margin:0; background:#111; color:#ddd; font:13px sans-serif;
       display:flex; height:100vh; overflow:hidden }
#view { flex:1; display:flex; align-items:center; justify-content:center }
canvas { background:#000; cursor:grab; max-width:100%; max-height:100% }
#panel { width:260px; padding:12px; background:#1b1b1f; overflow-y:auto }
#panel h3 { margin:10px 0 4px; font-size:13px; color:#9cf }
.row { display:flex; justify-content:space-between; margin:3px 0 }
.row input[type=range] { width:130px }
#fps { position:fixed; left:10px; top:8px; color:#6f6; font-weight:bold }
label { user-select:none }
</style></head><body>
<div id="view"><canvas id="c" width="640" height="640"></canvas></div>
<div id="panel">
  <h3>Camera</h3>
  <div class="row"><span>drag: orbit &middot; shift/right: pan &middot;
    wheel: dolly</span></div>
  <h3>Render</h3>
  <div id="opts"></div>
  <h3>Layers</h3>
  <div id="layers"></div>
  <h3>Add / load</h3>
  <div class="row">
    <button onclick="addMesh('sphere')">+sphere</button>
    <button onclick="addMesh('cube')">+cube</button>
    <button onclick="addMesh('lattice')">+lattice</button>
  </div>
  <div class="row">
    <a href="/frame?w=800&h=800" download="screenshot.png">
      <button>save screenshot (800&times;800)</button></a>
  </div>
  <div class="row"><label>tree</label>
    <input type="file" style="width:150px"
     onchange="uploadAsset('tree', this)"></div>
  <div class="row"><label>drawlist</label>
    <input type="file" style="width:150px"
     onchange="uploadAsset('drawlist', this)"></div>
  <div class="row"><label>obj</label>
    <input type="file" style="width:150px"
     onchange="uploadAsset('obj', this)"></div>
  <h3>Animation</h3>
  <div class="row">
    <button onclick="animCapture()">capture kf</button>
    <button id="playbtn" onclick="animPlay()">play</button>
  </div>
  <div id="kfs"></div>
  <div class="row">
    <input id="animt" type="range" min="0" max="1" step="0.01" value="0"
     style="width:180px" oninput="animSeek(+this.value)">
  </div>
  <div class="row">
    <input id="animpath" placeholder="anim.json" style="width:110px">
    <button onclick="animIO('save')">save</button>
    <button onclick="animIO('load')">load</button>
  </div>
  <div class="row">
    <input id="animexp" placeholder="frames/" style="width:110px">
    <button onclick="animExport()">export</button>
    <span id="animstat"></span>
  </div>
  <h3>Lumisphere probe</h3>
  <div class="row">
    <input id="px" type="number" value="0" step="0.1" style="width:55px">
    <input id="py" type="number" value="0" step="0.1" style="width:55px">
    <input id="pz" type="number" value="0" step="0.1" style="width:55px">
    <button onclick="probe()">probe</button>
  </div>
  <img id="probeimg" width="100" height="100" style="background:#000">
</div>
<div id="fps"></div>
<script>
const canvas = document.getElementById('c');
let busy = false, dirty = true;
// in-viewport mesh gizmo (ImGuizmo analog): pick a layer's "grab" toggle,
// then drag in the canvas; g/r/s switch translate/rotate/scale
const gizmo = {name: null, mode: 'translate'};
async function drawGizmo(ctx) {
  if (!gizmo.name) return;
  const g = await (await fetch(
    `/gizmo?name=${encodeURIComponent(gizmo.name)}`)).json();
  if (!g.visible) return;
  const [ox, oy] = g.center;
  const cols = ['#f55', '#5f5', '#59f'];
  ctx.lineWidth = 2;
  g.axes.forEach((a, i) => {
    if (!a) return;
    ctx.strokeStyle = cols[i];
    ctx.beginPath(); ctx.moveTo(ox, oy);
    ctx.lineTo(ox + a[0], oy + a[1]); ctx.stroke();
  });
  ctx.strokeStyle = '#fff';
  ctx.beginPath(); ctx.arc(ox, oy, 6, 0, 2 * Math.PI); ctx.stroke();
  ctx.fillStyle = '#fff'; ctx.font = '11px sans-serif';
  ctx.fillText(`${gizmo.name} [${gizmo.mode}]`, ox + 8, oy - 8);
}
async function refresh() {
  if (busy) { dirty = true; return; }
  busy = true; dirty = false;
  const t0 = performance.now();
  // adaptive drag resolution: while the user drags, fetch a reduced
  // frame (4-16x smaller transfer — the tunnel/device download dominates
  // per-frame latency) and upscale on the canvas; the mouseup refresh
  // restores full resolution. The divisor adapts to the measured frame
  // time (slow link -> quarter res, fast link -> half). Sizes snap to
  // multiples of 4 so the (4,4)-block superquad fast path stays usable.
  const sc = dragging ? dragScale : 1;
  const rw = sc > 1 ? Math.max(4, Math.floor(canvas.width / sc / 4) * 4)
                    : canvas.width;
  const rh = sc > 1 ? Math.max(4, Math.floor(canvas.height / sc / 4) * 4)
                    : canvas.height;
  const r = await fetch(`/frame?w=${rw}&h=${rh}`);
  const blob = await r.blob();
  const img = await createImageBitmap(blob);
  const ctx = canvas.getContext('2d');
  ctx.imageSmoothingEnabled = true;
  ctx.drawImage(img, 0, 0, canvas.width, canvas.height);
  await drawGizmo(ctx);
  const dt = performance.now() - t0;
  document.getElementById('fps').textContent = (1000/dt).toFixed(1) + ' fps';
  if (dragging) {
    if (dt > 90 && dragScale < 4) dragScale *= 2;
    else if (dt < 35 && dragScale > 2) dragScale /= 2;
  }
  busy = false;
  if (dirty) refresh();
}
async function post(path, body) {
  await fetch(path, {method:'POST', body: JSON.stringify(body)});
  refresh();
}
let dragging = false, lastXY = null, dragScale = 2;
canvas.addEventListener('mousedown', e => {
  dragging = true;
  if (gizmo.name) { lastXY = [e.offsetX, e.offsetY]; return; }
  post('/event', {type:'down', x:e.offsetX, y:e.offsetY,
                  pan: e.shiftKey || e.button !== 0, about_origin: true});
});
window.addEventListener('mousemove', e => {
  if (!dragging) return;
  const r = canvas.getBoundingClientRect();
  const x = e.clientX - r.left, y = e.clientY - r.top;
  if (gizmo.name) {
    if (lastXY) post('/mesh/drag', {name: gizmo.name, mode: gizmo.mode,
                                    dx: x - lastXY[0], dy: y - lastXY[1]});
    lastXY = [x, y];
    return;
  }
  post('/event', {type:'move', x, y});
});
window.addEventListener('mouseup', () => {
  if (dragging) {
    dragging = false; lastXY = null;
    if (!gizmo.name) post('/event', {type:'up'});
    else refresh();  // restore full resolution after a gizmo drag
  }
});
canvas.addEventListener('contextmenu', e => e.preventDefault());
canvas.addEventListener('wheel', e => {
  e.preventDefault();
  post('/event', {type:'wheel', dy: e.deltaY});
});
window.addEventListener('keydown', e => {
  if (e.target.tagName === 'INPUT') return;
  const k = e.key.toLowerCase();
  if (gizmo.name) {           // gizmo mode keys (Blender-style g/r/s)
    if (k === 'g') { gizmo.mode = 'translate'; refresh(); return; }
    if (k === 'r') { gizmo.mode = 'rotate'; refresh(); return; }
    if (k === 's') { gizmo.mode = 'scale'; refresh(); return; }
    if (e.key === 'Escape') { gizmo.name = null; refresh(); return; }
  }
  if ('wasdqeijkluo-=0123456'.includes(k) && k.length === 1)
    post('/event', {type:'key', key:k, shift: e.shiftKey});
});
// touch + pinch (reference web/js/init.js): 1 finger orbit, 2 pinch-zoom
let touches = null;
function tpos(t) {
  const r = canvas.getBoundingClientRect();
  return [t.clientX - r.left, t.clientY - r.top];
}
canvas.addEventListener('touchstart', e => {
  e.preventDefault();
  touches = e.touches;
  if (e.touches.length === 1) {
    const [x, y] = tpos(e.touches[0]);
    post('/event', {type:'down', x, y, pan:false, about_origin:true});
  } else {
    post('/event', {type:'up'});
  }
}, {passive:false});
canvas.addEventListener('touchmove', e => {
  e.preventDefault();
  if (e.touches.length === 1) {
    const [x, y] = tpos(e.touches[0]);
    post('/event', {type:'move', x, y});
  } else if (e.touches.length === 2 && touches &&
             touches.length === 2) {
    const d = (ts) => Math.hypot(
      ts[0].clientX - ts[1].clientX, ts[0].clientY - ts[1].clientY);
    post('/event', {type:'wheel', dy: d(touches) - d(e.touches)});
  }
  touches = e.touches;
}, {passive:false});
canvas.addEventListener('touchend', e => {
  e.preventDefault();
  touches = null;
  post('/event', {type:'up'});
}, {passive:false});
// keyframe animation editor (main_anim.cpp editor analog)
let animTotal = 0, playTimer = null;
async function animList() {
  const a = await (await fetch('/anim/list')).json();
  animTotal = a.total;
  document.getElementById('animt').max = Math.max(a.total, 0.01);
  const kd = document.getElementById('kfs');
  kd.innerHTML = '';
  a.keyframes.forEach((kf, i) => {
    kd.insertAdjacentHTML('beforeend',
      `<div class="row"><a href="#" onclick="post('/anim/goto',{index:${i}});
         return false">kf${i}</a>
       t<input type="number" value="${kf.t_max}" step="0.25" min="0.05"
        style="width:44px" onchange="post('/anim/update',
         {index:${i}, t_max:+this.value}).then(animList)">
       loops<input type="number" value="${kf.loops}" step="1"
        style="width:34px" onchange="post('/anim/update',
         {index:${i}, loops:+this.value})">
       <button onclick="post('/anim/delete',{index:${i}})
        .then(animList)">x</button></div>`);
  });
  if (a.export.running)
    document.getElementById('animstat').textContent =
      `${a.export.done}/${a.export.total}`;
  return a;
}
async function animCapture() {
  await fetch('/anim/capture', {method:'POST', body:'{}'});
  animList();
}
function animSeek(t) { post('/anim/seek', {t}); }
function animPlay() {
  const btn = document.getElementById('playbtn');
  if (playTimer) {
    clearInterval(playTimer); playTimer = null;
    btn.textContent = 'play'; return;
  }
  let t = 0;
  const t0 = performance.now();
  btn.textContent = 'stop';
  playTimer = setInterval(() => {
    t = (performance.now() - t0) / 1000;
    if (t >= animTotal) { clearInterval(playTimer); playTimer = null;
                          btn.textContent = 'play'; t = animTotal; }
    document.getElementById('animt').value = t;
    animSeek(t);
  }, 100);
}
async function animIO(op) {
  const path = document.getElementById('animpath').value || 'anim.json';
  await fetch(`/anim/${op}`, {method:'POST',
                              body: JSON.stringify({path})});
  animList();
}
async function animExport() {
  const path = document.getElementById('animexp').value || 'frames';
  await fetch('/anim/export', {method:'POST',
                               body: JSON.stringify({path, fps: 30})});
  const tick = setInterval(async () => {
    const a = await animList();
    if (!a.export.running) clearInterval(tick);
  }, 500);
}
async function probe() {
  const v = k => document.getElementById(k).value;
  const r = await fetch(`/probe?x=${v('px')}&y=${v('py')}&z=${v('pz')}`);
  document.getElementById('probeimg').src =
    URL.createObjectURL(await r.blob());
}
function bminmax() {
  post('/options', {basis_minmax: [
    +document.getElementById('bm0').value,
    +document.getElementById('bm1').value]});
}
function rotdirs() {
  post('/options', {rot_dirs:
    [...document.querySelectorAll('.rd')].map(e => +e.value)});
}
function bbox() {
  post('/options', {render_bbox:
    [...document.querySelectorAll('.bb')].map(e => +e.value)});
}
const OPT_SLIDERS = [
  ['step_size', 1e-5, 2e-3, 'log'],
  ['sigma_thresh', 0.0, 1.0, 'lin'],
  ['stop_thresh', 0.0, 0.2, 'lin'],
  ['background_brightness', 0.0, 1.0, 'lin'],
];
async function init() {
  const info = await (await fetch('/info')).json();
  const od = document.getElementById('opts');
  for (const [name, lo, hi] of OPT_SLIDERS) {
    const v = info.options[name];
    od.insertAdjacentHTML('beforeend',
      `<div class="row"><label>${name}</label>
       <input type="range" min="${lo}" max="${hi}" step="${(hi-lo)/200}"
        value="${v}" oninput="post('/options', {${name}: +this.value})">
       </div>`);
  }
  od.insertAdjacentHTML('beforeend',
    `<div class="row"><label>show grid</label>
     <input type="checkbox" onchange="post('/options',
      {show_grid: this.checked})"></div>
     <div class="row"><label>depth</label>
     <input type="checkbox" onchange="post('/options',
      {render_depth: this.checked})"></div>`);
  // visualization section (reference main.cpp:200-236): SH band window,
  // viewdir rotation, render bbox
  const bm = info.options.basis_minmax;
  od.insertAdjacentHTML('beforeend',
    `<div class="row"><label>SH bands</label>
     <input id="bm0" type="number" value="${bm[0]}" min="0" max="24"
      style="width:48px" onchange="bminmax()">
     <input id="bm1" type="number" value="${bm[1]}" min="0" max="24"
      style="width:48px" onchange="bminmax()"></div>`);
  const rd = info.options.rot_dirs;
  od.insertAdjacentHTML('beforeend',
    `<div class="row"><label>rot dirs</label>` +
    [0, 1, 2].map(i => `<input class="rd" type="number" value="${rd[i]}"
      step="0.1" style="width:48px" onchange="rotdirs()">`).join('')
    + `</div>`);
  const bb = info.options.render_bbox;
  od.insertAdjacentHTML('beforeend',
    `<div class="row"><label>bbox lo</label>` +
    [0, 1, 2].map(i => `<input class="bb" type="number" value="${bb[i]}"
      step="0.05" min="0" max="1" style="width:48px"
      onchange="bbox()">`).join('') + `</div>
     <div class="row"><label>bbox hi</label>` +
    [3, 4, 5].map(i => `<input class="bb" type="number" value="${bb[i]}"
      step="0.05" min="0" max="1" style="width:48px"
      onchange="bbox()">`).join('') + `</div>`);
  const ld = document.getElementById('layers');
  ld.innerHTML = '';
  for (const m of info.meshes) {
    const v3 = (k, vals, step) => vals.map((v, i) =>
      `<input type="number" value="${v}" step="${step}" style="width:48px"
        onchange="meshVec('${m.name}','${k}',this.parentElement)">`).join('');
    ld.insertAdjacentHTML('beforeend',
      `<details class="mesh" data-name="${m.name}"><summary>${m.name}
        <input type="checkbox" ${m.visible ? 'checked' : ''}
         onclick="event.stopPropagation()"
         onchange="post('/mesh', {name:'${m.name}',
                   visible:this.checked})">
        <button onclick="event.stopPropagation();
         gizmo.name = gizmo.name === '${m.name}' ? null : '${m.name}';
         refresh()">grab</button></summary>
       <div class="row"><label>trans</label>
        <span data-k="translation">${v3('translation', m.translation,
                                        0.05)}</span></div>
       <div class="row"><label>rot</label>
        <span data-k="rotation">${v3('rotation', m.rotation,
                                     0.1)}</span></div>
       <div class="row"><label>scale</label>
        <input type="number" value="${m.scale}" step="0.05"
         style="width:60px" onchange="post('/mesh',
          {name:'${m.name}', scale:+this.value})"></div>
       <div class="row">
        <label><input type="checkbox" ${m.unlit ? 'checked' : ''}
         onchange="post('/mesh', {name:'${m.name}',
                   unlit:this.checked})"> unlit</label>
        <button onclick="post('/mesh', {name:'${m.name}', delete:true});
                setTimeout(init, 150)">delete</button></div>
      </details>`);
  }
  refresh();
  animList();
}
function meshVec(name, key, span) {
  const vals = [...span.querySelectorAll('input')].map(i => +i.value);
  post('/mesh', {name, [key]: vals});
}
async function addMesh(type) {
  await fetch('/mesh/add', {method:'POST',
                            body: JSON.stringify({type})});
  init();
}
async function uploadAsset(kind, input) {
  if (!input.files.length) return;
  const buf = await input.files[0].arrayBuffer();
  await fetch(`/upload?kind=${kind}`, {method:'POST', body: buf});
  init();
}
init();
</script></body></html>
"""


def _rotvec_to_mat(v):
    v = np.asarray(v, np.float64)
    ang = float(np.linalg.norm(v))
    if ang < 1e-12:
        return np.eye(3)
    k = v / ang
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) * np.cos(ang) + np.sin(ang) * K \
        + (1 - np.cos(ang)) * np.outer(k, k)


def _mat_to_rotvec(R):
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    ang = float(np.arccos(cos))
    if ang < 1e-12:
        return np.zeros(3)
    if ang > np.pi - 1e-6:
        # near-pi: axis from the symmetric part
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.clip(np.diag(A), 0.0, None))
        axis *= np.sign([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]]) + (axis == 0)
        n = np.linalg.norm(axis)
        return axis / (n if n else 1.0) * ang
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]]) / (2.0 * np.sin(ang))
    return axis * ang


def _compose_rotvec(base, delta):
    """rotvec of R(delta) @ R(base) (world-space delta applied on top)."""
    return _mat_to_rotvec(_rotvec_to_mat(delta) @ _rotvec_to_mat(base))


def _bake(tdev):
    """The viewer's grid: the tree's int8 bake on its device."""
    from volrend_torch.ops import dense_grid
    return dense_grid.bake_dense(tdev, dtype="int8")


class ViewerState:
    def __init__(self, tree: N3Tree, meshes: Optional[List[Mesh]] = None,
                 use_slab: bool = True, device: DeviceLike = None):
        self.device = resolve(device)
        self.tree = tree
        self.dev = tree.to_device(lut_depth=None, device=self.device)
        self.meshes = list(meshes or [])
        self.opt = RenderOptions(max_steps=2048)
        if tree.use_ndc and tree.ndc is not None:
            # LLFF/NDC scene: mean-pose camera init (main.cpp:731-741)
            from volrend_torch.ops.camera import ndc_camera
            self.cam = ndc_camera(tree.ndc, width=640, height=640)
            self.fixed_focal = True
        else:
            self.cam = DragCamera(width=640, height=640, fx=300.0)
            self.cam.update_basis(
                v_back=np.array([-0.7071, 0.0, 0.7071]),
                center=np.array([-3.55, 0.0, 3.55]) / max(tree.scale))
            self.fixed_focal = False
        self.use_slab = use_slab
        self.grid = _bake(self.dev) if use_slab else None
        self._payload_cache = {}
        self.lock = threading.Lock()
        self.fps = fps_counter()
        #: which render path produced the last frame (the reference's
        #: get_backend(), cuda_renderer.cpp:225): "slab-cuda", "slab-cpu",
        #: "slab-split" or "exact"
        self.last_backend = "exact"
        #: keyframe animation editor state (main_anim.cpp:136-182 AnimKF;
        #: the browser panel is the ImGui keyframe editor analog)
        self.keyframes: list = []
        self.anim_status = {"running": False, "done": 0, "total": 0}

    def render(self, w: int, h: int) -> bytes:
        with self.lock:
            return self._render_locked(w, h)

    def _render_locked(self, w: int, h: int) -> bytes:
        """Render the current state; caller must hold self.lock (the export
        thread applies a keyframe state and renders under ONE lock scope so
        concurrent viewer input cannot corrupt exported frames)."""
        self.cam.width, self.cam.height = w, h
        if not self.fixed_focal:
            self.cam.fx = self.cam.fy = 0.55 * max(w, h) / np.tan(0.35)
        any_mesh = any(m.visible for m in self.meshes) or \
            self.opt.show_grid
        img = None
        if self.grid is not None and \
                not (any_mesh and self.grid.ndc is not None):
            # meshes stay on the fast path too (rasterized host-side,
            # march clipped at the mesh distance, transmittance
            # composited over mesh color — ops/slab_render mesh args);
            # only NDC trees with meshes need the exact renderer
            from volrend_torch.ops import slab_render
            is_compat = slab_render.compatible(
                self.grid, self.cam.transform, self.cam.fx, self.cam.fy,
                w, h)
            # steep/interior world-tree poses render via split-frame
            # slab passes (render_image routes internally) — meshes
            # composite there too, so only NDC trees ever fall to exact
            if is_compat or self.grid.ndc is None:
                # RGBA8 frames off kernel W (4x smaller device->host
                # copy; the PNG encode consumes u8 anyway — the
                # reference's framebuffer format)
                img = slab_render.render_image(
                    self.grid, self.cam, self.opt,
                    payload_cache=self._payload_cache,
                    meshes=self.meshes if any_mesh else None,
                    host_tree=self.tree, out_dtype=torch.uint8)
                if is_compat:
                    self.last_backend = (
                        "slab-cuda" if self.grid.device.type == "cuda"
                        else "slab-cpu")
                else:
                    self.last_backend = "slab-split"
        if img is None:
            from volrend_torch.ops import composite
            img = composite.render_frame_with_meshes(
                self.dev, self.cam, self.opt, self.meshes,
                host_tree=self.tree)
            self.last_backend = "exact"
        if self.opt.enable_probe:
            # in-frame lumisphere inset at the top-right, the reference's
            # in-kernel probe circle (volrend.cu:100-134); the /probe
            # endpoint's separate panel stays for the HTML UI
            from volrend_torch.ops import composite
            img = composite.draw_probe_inset(np.asarray(img), self.dev,
                                             self.cam, self.opt)
        buf = io.BytesIO()
        _write_png_bytes(buf, img)
        return buf.getvalue()

    def handle_event(self, ev: dict) -> None:
        with self.lock:
            t = ev.get("type")
            if t == "down":
                self.cam.begin_drag(ev["x"], ev["y"], bool(ev.get("pan")),
                                    bool(ev.get("about_origin", True)))
            elif t == "move":
                self.cam.drag_update(ev["x"], ev["y"])
            elif t == "up":
                self.cam.end_drag()
            elif t == "wheel":
                # wheel up (negative dy) dollies in
                sp = 1.0 + np.clip(ev.get("dy", 0.0), -100, 100) * 0.002
                c = self.cam.center - self.cam.origin
                self.cam.update_basis(center=self.cam.origin + c * sp)
            elif t == "key":
                self._handle_key(ev)

    def _handle_key(self, ev: dict) -> None:
        """Keyboard surface of the reference GUI (main.cpp:452-573):
        WASDQE camera moves, IJKLUO probe moves, -/= /0 focal zoom,
        1-6 world_up presets; shift = 5x speed."""
        key = str(ev.get("key", "")).lower()
        mult = 5.0 if ev.get("shift") else 1.0
        step = 0.1 * mult
        moves = {"w": -self.cam.v_back, "s": self.cam.v_back,
                 "a": -self.cam.v_right, "d": self.cam.v_right,
                 "q": -self.cam.v_up, "e": self.cam.v_up}
        if key in moves:
            self.cam.move(moves[key] * step)
        elif key in "ijkluo" and key and self.opt.enable_probe:
            # probe moves (main.cpp:519-531): l/j = +/-x, i/k = +/-y,
            # o/u = +/-z
            sp = 0.02 * mult
            dim = {"j": 0, "l": 0, "i": 1, "k": 1, "u": 2, "o": 2}[key]
            if key in "jku":
                sp = -sp
            p = list(self.opt.probe)
            p[dim] += sp
            self.opt = self.opt.replace(probe=tuple(p))
        elif key == "-":
            self.cam.fx *= 0.99
            self.cam.fy *= 0.99
            self.fixed_focal = True
        elif key == "=":
            self.cam.fx *= 1.01
            self.cam.fy *= 1.01
            self.fixed_focal = True
        elif key == "0":
            from volrend_torch.ops.camera import DEFAULT_FOCAL
            self.cam.fx = self.cam.fy = DEFAULT_FOCAL
            self.fixed_focal = True
        elif key in "123456":
            ups = {"1": (0, 0, 1), "2": (0, 0, -1), "3": (0, 1, 0),
                   "4": (0, -1, 0), "5": (1, 0, 0), "6": (-1, 0, 0)}
            self.cam.v_world_up = np.asarray(ups[key], np.float32)
            self.cam.update_basis()

    # -- mesh manipulation (the ImGuizmo surface, main.cpp:238-413) ---------

    def update_mesh(self, body: dict) -> bool:
        """Set per-mesh transform/appearance or delete (main.cpp:290-300)."""
        with self.lock:
            for i, m in enumerate(self.meshes):
                if m.name != body.get("name"):
                    continue
                if body.get("delete"):
                    del self.meshes[i]
                    return True
                if "visible" in body:
                    m.visible = bool(body["visible"])
                if "unlit" in body:
                    m.unlit = bool(body["unlit"])
                if "translation" in body:
                    m.translation = np.asarray(body["translation"],
                                               np.float32)
                if "rotation" in body:
                    m.rotation = np.asarray(body["rotation"], np.float32)
                if "scale" in body:
                    m.scale = float(body["scale"])
                return True
        return False

    def add_mesh(self, body: dict) -> str:
        """Add a primitive like the GUI buttons (main.cpp:322-413)."""
        kind = body.get("type", "sphere")
        with self.lock:
            if kind == "sphere":
                m = Mesh.Sphere()
                m.scale, m.translation = 0.1, np.array([0, 0, 1.0],
                                                       np.float32)
            elif kind == "cube":
                m = Mesh.Cube()
                m.scale, m.translation = 0.2, np.array([0, 0, 1.0],
                                                       np.float32)
            elif kind == "lattice":
                m = Mesh.Lattice()
            else:
                raise ValueError(f"unknown primitive {kind!r}")
            names = {mm.name for mm in self.meshes}
            base = body.get("name") or kind.capitalize()
            name, k = base, 0
            while name in names:
                k += 1
                name = f"{base}{k}"
            m.name = name
            self.meshes.append(m)
            return name

    def mesh_gizmo(self, name: str) -> dict:
        """Screen-space gizmo info for a mesh: its projected center + the
        projected world-axis directions (the ImGuizmo drawing surface,
        main.cpp:238-413 — the browser draws the handles, the server does
        the projection with the live camera)."""
        with self.lock:
            m = next((mm for mm in self.meshes if mm.name == name), None)
            if m is None:
                raise KeyError(f"no mesh {name!r}")
            R = np.asarray(self.cam.transform[:, :3], np.float64)
            c = np.asarray(self.cam.center, np.float64)
            w, h = self.cam.width, self.cam.height
            fx, fy = float(self.cam.fx), float(self.cam.fy)

            def project(p):
                q = R.T @ (np.asarray(p, np.float64) - c)
                if q[2] >= -1e-9:           # behind the camera
                    return None
                return [0.5 * w + fx * q[0] / (-q[2]),
                        0.5 * h - fy * q[1] / (-q[2])]

            center = np.asarray(m.translation, np.float64)
            o = project(center)
            axes = []
            if o is not None:
                alen = 0.25 * max(float(m.scale), 1e-3)
                for k in range(3):
                    e = np.zeros(3)
                    e[k] = alen
                    p = project(center + e)
                    axes.append(None if p is None
                                else [p[0] - o[0], p[1] - o[1]])
            return {"name": name, "center": o, "axes": axes,
                    "visible": o is not None}

    def mesh_drag(self, body: dict) -> dict:
        """Apply a screen-space drag to a mesh transform (gizmo semantics:
        translate in the camera plane, rotate about the view axis, scale
        by vertical drag). dx/dy in canvas pixels."""
        name = body.get("name")
        mode = body.get("mode", "translate")
        dx = float(body.get("dx", 0.0))
        dy = float(body.get("dy", 0.0))
        with self.lock:
            m = next((mm for mm in self.meshes if mm.name == name), None)
            if m is None:
                raise KeyError(f"no mesh {name!r}")
            if mode == "translate":
                # pixel delta -> world delta at the mesh's depth
                R = np.asarray(self.cam.transform[:, :3], np.float64)
                c = np.asarray(self.cam.center, np.float64)
                q = R.T @ (np.asarray(m.translation, np.float64) - c)
                depth = max(-q[2], 1e-3)
                dw = (R[:, 0] * (dx * depth / float(self.cam.fx))
                      - R[:, 1] * (dy * depth / float(self.cam.fy)))
                m.translation = (np.asarray(m.translation, np.float64)
                                 + dw).astype(np.float32)
            elif mode == "rotate":
                # rotate about the camera view axis (axis-angle composed
                # onto the mesh's rotation vector)
                axis = -np.asarray(self.cam.transform[:, 2], np.float64)
                ang = dx * 0.01
                m.rotation = _compose_rotvec(
                    np.asarray(m.rotation, np.float64), axis * ang
                ).astype(np.float32)
            elif mode == "scale":
                m.scale = float(np.clip(
                    float(m.scale) * np.exp(-dy * 0.01), 1e-4, 1e4))
            else:
                raise ValueError(f"unknown drag mode {mode!r}")
            return {"name": name,
                    "translation": [float(v) for v in m.translation],
                    "rotation": [float(v) for v in m.rotation],
                    "scale": float(m.scale)}

    # -- runtime asset loading (web/main_web.cpp:139-294 analog) ------------

    def load_asset(self, kind: str, data: Optional[bytes] = None,
                   path: Optional[str] = None) -> dict:
        """Load a tree / drawlist / OBJ at runtime, from raw bytes (browser
        upload) or a server-side path."""
        from volrend_torch.models import mesh as mesh_mod
        if kind == "tree":
            tree = N3Tree()
            if data is not None:
                tree.open_mem(data)
            else:
                tree.open(path)
            with self.lock:
                # upload and bake before replacing anything: a failure
                # leaves the viewer on its current tree
                tdev = tree.to_device(lut_depth=None, device=self.device)
                grid = _bake(tdev) if self.use_slab else None
                self.tree, self.dev, self.grid = tree, tdev, grid
                self._payload_cache.clear()
            return {"loaded": "tree", "data_dim": tree.data_dim}
        if kind == "drawlist":
            new = mesh_mod.open_drawlist(data if data is not None else path)
            with self.lock:
                self.meshes.extend(new)
            return {"loaded": "drawlist",
                    "meshes": [m.name for m in new]}
        if kind == "obj":
            if data is not None:
                m = mesh_mod.load_basic_obj(data.decode(), from_string=True)
            else:
                m = mesh_mod.load_basic_obj(path)
            with self.lock:
                self.meshes.append(m)
            return {"loaded": "obj", "meshes": [m.name]}
        raise ValueError(f"unknown asset kind {kind!r}")

    def probe(self, point, size: int = 100) -> bytes:
        """Lumisphere probe ball (the reference GUI's inset display)."""
        from volrend_torch.ops.composite import probe_image
        with self.lock:
            img = probe_image(self.dev, point, size=size)
        buf = io.BytesIO()
        _write_png_bytes(buf, img)
        return buf.getvalue()

    # -- keyframe animation editor (main_anim.cpp:350-925 analog) -----------

    def _capture_kf(self, body: dict):
        """Snapshot camera + options + mesh transforms as an AnimKF
        (AnimKF capture semantics, main_anim.cpp:136-182)."""
        from volrend_torch import anim
        ms = {m.name: anim.MeshState(
            rotation=np.asarray(m.rotation, float).copy(),
            translation=np.asarray(m.translation, float).copy(),
            scale=float(m.scale), visible=bool(m.visible),
            unlit=bool(m.unlit)) for m in self.meshes}
        return anim.AnimKF(
            center=np.asarray(self.cam.center, float).copy(),
            v_back=np.asarray(self.cam.v_back, float).copy(),
            origin=np.asarray(getattr(self.cam, "origin", np.zeros(3)),
                              float).copy(),
            fx=float(self.cam.fx), fy=float(self.cam.fy),
            opt=self.opt,
            mesh_state=ms,
            t_max=float(body.get("t_max", 1.0)),
            spherical_interp=bool(body.get("spherical_interp", True)),
            loops=int(body.get("loops", 0)))

    def _anim_summary(self) -> dict:
        total = float(sum(kf.t_max for kf in self.keyframes[1:]))
        return {
            "n": len(self.keyframes),
            "total": total,
            "export": dict(self.anim_status),
            "keyframes": [{
                "center": [float(v) for v in kf.center],
                "v_back": [float(v) for v in kf.v_back],
                "fx": float(kf.fx),
                "t_max": float(kf.t_max),
                "loops": int(kf.loops),
                "spherical_interp": bool(kf.spherical_interp),
            } for kf in self.keyframes],
        }

    def _apply_state(self, center, v_back, fx, fy, opt, mstate) -> None:
        """Set viewer state from an (interpolated) keyframe
        (AnimState::update application, main_anim.cpp:230-335)."""
        self.cam.update_basis(v_back=np.asarray(v_back, np.float64),
                              center=np.asarray(center, np.float64))
        self.cam.fx, self.cam.fy = float(fx), float(fy)
        self.fixed_focal = True
        self.opt = opt.replace(max_steps=self.opt.max_steps)
        for m in self.meshes:
            if m.name in mstate:
                s = mstate[m.name]
                m.rotation = np.asarray(s.rotation, np.float32)
                m.translation = np.asarray(s.translation, np.float32)
                m.scale = float(s.scale)
                m.visible = bool(s.visible)
                m.unlit = bool(s.unlit)

    def anim_op(self, op: str, body: dict) -> dict:
        from volrend_torch import anim
        if op == "capture":
            with self.lock:
                kf = self._capture_kf(body)
                idx = body.get("index")
                if idx is None:
                    self.keyframes.append(kf)
                    idx = len(self.keyframes) - 1
                else:
                    self.keyframes.insert(int(idx), kf)
                return {"index": int(idx), **self._anim_summary()}
        if op == "list":
            with self.lock:
                return self._anim_summary()
        if op == "update":
            with self.lock:
                i = int(body["index"])
                kf = self.keyframes[i]
                if body.get("recapture"):
                    new = self._capture_kf({})
                    new.t_max = kf.t_max
                    new.spherical_interp = kf.spherical_interp
                    new.loops = kf.loops
                    self.keyframes[i] = kf = new
                if "t_max" in body:
                    kf.t_max = float(body["t_max"])
                if "loops" in body:
                    kf.loops = int(body["loops"])
                if "spherical_interp" in body:
                    kf.spherical_interp = bool(body["spherical_interp"])
                return self._anim_summary()
        if op == "delete":
            with self.lock:
                del self.keyframes[int(body["index"])]
                return self._anim_summary()
        if op == "goto":
            with self.lock:
                kf = self.keyframes[int(body["index"])]
                self._apply_state(kf.center, kf.v_back, kf.fx, kf.fy,
                                  kf.opt, kf.mesh_state)
                return {"ok": True}
        if op == "seek":
            return self.anim_seek(float(body.get("t", 0.0)))
        if op == "save":
            return self.anim_save(body["path"])
        if op == "load":
            kfs, cfg = anim.load_script(body["path"])
            with self.lock:
                self.keyframes = kfs
                if "world_up" in cfg:
                    self.cam.v_world_up = np.asarray(cfg["world_up"],
                                                     np.float32)
                    self.cam.update_basis()
                return self._anim_summary()
        if op == "export":
            return self.anim_export(body)
        raise ValueError(f"unknown anim op {op!r}")

    def anim_seek(self, t: float) -> dict:
        """Apply the interpolated animation state at global time t (the
        preview scrub/playback surface; segment durations are the END
        keyframe's t_max, like frame_times)."""
        from volrend_torch import anim
        with self.lock:
            kfs = self.keyframes
            if len(kfs) < 2:
                raise ValueError("need >= 2 keyframes")
            acc = 0.0
            for i in range(len(kfs) - 1):
                dur = max(float(kfs[i + 1].t_max), 1e-9)
                if t <= acc + dur or i == len(kfs) - 2:
                    q = min(max((t - acc) / dur, 0.0), 1.0)
                    st = anim.interpolate(kfs[i], kfs[i + 1], q,
                                          self.cam.v_world_up,
                                          first_segment=(i == 0))
                    self._apply_state(*st)
                    return {"segment": i, "q": float(q)}
                acc += dur
        raise AssertionError("unreachable")

    def anim_save(self, path: str) -> dict:
        """Write the keyframes as a cli/animate-compatible JSON script."""
        with self.lock:
            cfg = {
                "fps": 30,
                "world_up": [float(v) for v in self.cam.v_world_up],
                "keyframes": [{
                    "center": [float(v) for v in kf.center],
                    "v_back": [float(v) for v in kf.v_back],
                    "origin": [float(v) for v in kf.origin],
                    "fx": float(kf.fx), "fy": float(kf.fy),
                    "t_max": float(kf.t_max),
                    "spherical_interp": bool(kf.spherical_interp),
                    "loops": int(kf.loops),
                    "options": {
                        k: (list(v) if isinstance(v, tuple) else v)
                        for k, v in dataclasses.asdict(kf.opt).items()
                        if isinstance(v, (int, float, bool, tuple))},
                    "meshes": {
                        name: {"rotation": [float(v) for v in s.rotation],
                               "translation": [float(v)
                                               for v in s.translation],
                               "scale": float(s.scale),
                               "visible": bool(s.visible),
                               "unlit": bool(s.unlit)}
                        for name, s in kf.mesh_state.items()},
                } for kf in self.keyframes],
            }
        with open(path, "w") as f:
            json.dump(cfg, f, indent=1)
        return {"saved": path, "n": len(cfg["keyframes"])}

    def anim_export(self, body: dict) -> dict:
        """Render every animation frame to PNG files in a directory (the
        reference's export mode, main_anim.cpp:95-110; runs in a thread so
        the viewer reports progress via /anim/list)."""
        import os
        from volrend_torch import anim
        out_dir = body["path"]
        fps = float(body.get("fps", 30.0))
        w = int(body.get("width", 800))
        h = int(body.get("height", 800))
        try:
            os.makedirs(out_dir, exist_ok=True)
        except OSError as e:
            raise ValueError(f"cannot create {out_dir!r}: {e}")
        with self.lock:
            if self.anim_status["running"]:
                raise ValueError("export already running")
            if len(self.keyframes) < 2:
                raise ValueError("need >= 2 keyframes")
            # snapshot so concurrent keyframe edits can't break the export
            kfs = list(self.keyframes)
            schedule = anim.frame_times(kfs, fps)
            self.anim_status = {"running": True, "done": 0,
                                "total": len(schedule)}

        def run():
            try:
                for f_idx, (seg, q) in enumerate(schedule):
                    # apply + render under ONE lock scope: concurrent
                    # viewer input between them would corrupt the frame
                    with self.lock:
                        st = anim.interpolate(
                            kfs[seg], kfs[seg + 1], q,
                            self.cam.v_world_up, first_segment=(seg == 0))
                        self._apply_state(*st)
                        png = self._render_locked(w, h)
                    with open(os.path.join(out_dir,
                                           f"{f_idx:06d}.png"), "wb") as f:
                        f.write(png)
                    self.anim_status["done"] = f_idx + 1
            except Exception as e:      # surfaced via /anim/list
                self.anim_status["error"] = str(e)
            finally:
                self.anim_status["running"] = False

        threading.Thread(target=run, daemon=True).start()
        return {"started": True, "total": len(schedule), "dir": out_dir}

    def info(self) -> dict:
        return {
            "backend": self.last_backend,
            "data_dim": self.tree.data_dim,
            "basis_dim": self.tree.data_format.basis_dim,
            "format": self.tree.data_format.to_string(),
            "options": {k: (list(v) if isinstance(v, tuple) else v)
                        for k, v in dataclasses.asdict(self.opt).items()
                        if isinstance(v, (int, float, bool, tuple))},
            "meshes": [{"name": m.name, "visible": bool(m.visible),
                        "unlit": bool(m.unlit),
                        "translation": [float(v) for v in m.translation],
                        "rotation": [float(v) for v in m.rotation],
                        "scale": float(m.scale)}
                       for m in self.meshes],
            "ndc": (None if not self.tree.use_ndc or self.tree.ndc is None
                    else {"focal": float(self.tree.ndc.focal),
                          "avg_up": list(self.tree.ndc.avg_up),
                          "avg_back": list(self.tree.ndc.avg_back),
                          "avg_cen": list(self.tree.ndc.avg_cen)}),
        }


_write_png_bytes = png_mod.write_png_bytes


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(200, _INDEX_HTML.encode(), "text/html")
            elif u.path == "/info":
                self._send(200, json.dumps(state.info()).encode())
            elif u.path == "/frame":
                q = parse_qs(u.query)
                w = int(q.get("w", ["640"])[0])
                h = int(q.get("h", ["640"])[0])
                self._send(200, state.render(w, h), "image/png")
            elif u.path == "/probe":
                q = parse_qs(u.query)
                pt = tuple(float(q.get(k, ["0"])[0]) for k in "xyz")
                size = int(q.get("size", ["100"])[0])
                self._send(200, state.probe(pt, size), "image/png")
            elif u.path == "/anim/list":
                self._send(200,
                           json.dumps(state.anim_op("list", {})).encode())
            elif u.path == "/gizmo":
                q = parse_qs(u.query)
                try:
                    out = state.mesh_gizmo(q.get("name", [""])[0])
                except KeyError as e:
                    self._send(404, json.dumps({"error": str(e)}).encode())
                    return
                self._send(200, json.dumps(out).encode())
            else:
                self._send(404, b"{}")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) if n else b""
            u = urlparse(self.path)
            if u.path == "/upload":
                # raw asset bytes from the browser (runtime loading,
                # web/main_web.cpp:139-294 analog)
                q = parse_qs(u.query)
                kind = q.get("kind", ["tree"])[0]
                try:
                    out = state.load_asset(kind, data=raw)
                except Exception as e:
                    self._send(400, json.dumps({"error": str(e)}).encode())
                    return
                self._send(200, json.dumps(out).encode())
                return
            body = json.loads(raw or b"{}")
            if u.path == "/event":
                state.handle_event(body)
            elif u.path == "/options":
                with state.lock:
                    state.opt = state.opt.replace(**{
                        k: (tuple(v) if isinstance(v, list) else v)
                        for k, v in body.items()})
            elif u.path == "/mesh":
                if not state.update_mesh(body):
                    self._send(404, b'{"error": "no such mesh"}')
                    return
            elif u.path == "/mesh/drag":
                try:
                    out = state.mesh_drag(body)
                except (ValueError, KeyError) as e:
                    self._send(400, json.dumps({"error": str(e)}).encode())
                    return
                self._send(200, json.dumps(out).encode())
                return
            elif u.path == "/mesh/add":
                try:
                    name = state.add_mesh(body)
                except ValueError as e:
                    self._send(400, json.dumps({"error": str(e)}).encode())
                    return
                self._send(200, json.dumps({"name": name}).encode())
                return
            elif u.path == "/load":
                try:
                    out = state.load_asset(body.get("kind", "tree"),
                                           path=body.get("path"))
                except Exception as e:
                    self._send(400, json.dumps({"error": str(e)}).encode())
                    return
                self._send(200, json.dumps(out).encode())
                return
            elif u.path.startswith("/anim/"):
                try:
                    out = state.anim_op(u.path[len("/anim/"):], body)
                except (ValueError, KeyError, IndexError, OSError) as e:
                    self._send(400, json.dumps({"error": str(e)}).encode())
                    return
                self._send(200, json.dumps(out).encode())
                return
            self._send(200, b"{}")

    return Handler


def build_server(tree_path: str, draw: Optional[str] = None,
                 port: int = 8781, use_slab: bool = True,
                 device: DeviceLike = None,
                 host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """The viewer's HTTP server on ``(host, port)`` (port 0: any free
    port; ``httpd.server_port`` says which), its ``ViewerState`` as
    ``httpd.state``. One frame of the page's default size is rendered
    first, so the kernels are built and loaded before the first
    request."""
    from volrend_torch.models import mesh as mesh_mod
    tree = N3Tree(tree_path)
    meshes: List[Mesh] = []
    if draw:
        if draw.endswith(".obj"):
            meshes = [mesh_mod.load_basic_obj(draw)]
        else:
            meshes = mesh_mod.open_drawlist(draw)
    state = ViewerState(tree, meshes, use_slab=use_slab, device=device)
    state.render(640, 640)
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    httpd.state = state
    return httpd


def serve(tree_path: str, draw: Optional[str] = None, port: int = 8781,
          use_slab: bool = True, device: DeviceLike = None):
    httpd = build_server(tree_path, draw=draw, port=port, use_slab=use_slab,
                         device=device)
    print(f"volrend-torch viewer on {httpd.state.device}: "
          f"http://localhost:{httpd.server_port}/")
    httpd.serve_forever()
