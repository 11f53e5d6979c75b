"""Keyframe animation: local-spherical camera interpolation (the port's own
copy of ``volrend_tpu/anim.py``, NumPy on the host; scripts either package
writes are read by both).

Re-implements the ``volrend_anim`` keyframe math (``main_anim.cpp``):

- ``sphc_interp`` (main_anim.cpp:60-93): interpolate a vector in local
  spherical coordinates about the world-up axis — azimuth/elevation/radius
  lerp with shortest-path azimuth wrap and optional extra CCW loops;
- ``AnimKF`` (main_anim.cpp:136-182): a keyframe captures camera (center,
  origin, v_back, fx, fy) + RenderOptions + per-mesh transform state;
- ``interpolate`` (AnimState::update, main_anim.cpp:230-335): camera via
  sphc about world_up (or lerp), options lerped field-by-field exactly as
  the reference (bg, step_size, thresholds, probe, bbox, rot_dirs via sphc,
  grid depth), mesh rotation via sphc / translation+scale lerp.

The CLI (``cli/animate.py``) drives this headlessly from a JSON keyframe
script instead of the reference's interactive ImGui editor.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Tuple

import numpy as np

from volrend_torch.utils.options import RenderOptions

__all__ = ["sphc_interp", "MeshState", "AnimKF", "interpolate",
           "frame_times", "load_script"]


def _local_sph(v, ax, ay, az):
    x, y, z = float(v @ ax), float(v @ ay), float(v @ az)
    return np.arctan2(y, x), np.arcsin(np.clip(z, -1.0, 1.0))


def _local_unsph(u, v, ax, ay, az):
    return (np.cos(v) * np.cos(u) * ax + np.cos(v) * np.sin(u) * ay
            + np.sin(v) * az)


def lerp(a, b, q: float):
    return (1.0 - q) * np.asarray(a) + q * np.asarray(b)


def sphc_interp(vec_start, vec_end, q: float, ax, ay, az,
                loops: int = 0) -> np.ndarray:
    """Interpolate in local spherical coordinates (main_anim.cpp:60-93)."""
    vec_start = np.asarray(vec_start, np.float64)
    vec_end = np.asarray(vec_end, np.float64)
    d_start = float(np.linalg.norm(vec_start))
    d_end = float(np.linalg.norm(vec_end))
    if d_start == 0.0 and d_end == 0.0:
        su = eu = np.asarray(az, np.float64)
    elif d_start == 0.0:
        su = eu = vec_end / d_end
    elif d_end == 0.0:
        su = eu = vec_start / d_start
    else:
        su = vec_start / d_start
        eu = vec_end / d_end
    u0, v0 = _local_sph(su, ax, ay, az)
    u1, v1 = _local_sph(eu, ax, ay, az)
    if abs(u0 - u1) > np.pi:
        if u1 > u0:
            u1 -= 2 * np.pi
        else:
            u0 -= 2 * np.pi
    u1 += loops * 2 * np.pi
    uc = lerp(u0, u1, q)
    vc = lerp(v0, v1, q)
    dc = lerp(d_start, d_end, q)
    return (_local_unsph(uc, vc, ax, ay, az) * dc).astype(np.float64)


@dataclasses.dataclass
class MeshState:
    rotation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    translation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    scale: float = 1.0
    visible: bool = True
    unlit: bool = False


@dataclasses.dataclass
class AnimKF:
    """A keyframe (main_anim.cpp:136-182)."""
    center: np.ndarray
    v_back: np.ndarray
    origin: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    fx: float = 1111.11
    fy: float = 1111.11
    opt: RenderOptions = dataclasses.field(default_factory=RenderOptions)
    mesh_state: Dict[str, MeshState] = dataclasses.field(default_factory=dict)
    #: segment duration in seconds
    t_max: float = 1.0
    spherical_interp: bool = True
    #: extra CCW loops about world_up during this segment
    loops: int = 0


def interpolate(start: AnimKF, end: AnimKF, q: float, world_up,
                first_segment: bool = False
                ) -> Tuple[np.ndarray, np.ndarray, float, float,
                           RenderOptions, Dict[str, MeshState]]:
    """One interpolated state (AnimState::update semantics).

    Returns (center, v_back, fx, fy, options, mesh_state)."""
    az = np.asarray(world_up, np.float64)
    az = az / np.linalg.norm(az)
    vb = np.asarray(start.v_back, np.float64)
    ax = vb - (vb @ az) * az
    nax = np.linalg.norm(ax)
    ax = ax / nax if nax > 1e-12 else np.array([1.0, 0.0, 0.0])
    ay = np.cross(az, ax)
    ay /= np.linalg.norm(ay)

    origin = lerp(start.origin, end.origin, q)
    if end.spherical_interp:
        loops = 0 if first_segment else end.loops
        center = origin + sphc_interp(
            np.asarray(start.center) - start.origin,
            np.asarray(end.center) - end.origin, q, ax, ay, az, loops)
        v_back = sphc_interp(start.v_back, end.v_back, q, ax, ay, az, loops)
    else:
        center = lerp(start.center, end.center, q)
        v_back = lerp(start.v_back, end.v_back, q)

    fx = float(lerp(start.fx, end.fx, q))
    fy = float(lerp(start.fy, end.fy, q))

    so, eo = start.opt, end.opt
    kw = dict(
        background_brightness=float(
            lerp(so.background_brightness, eo.background_brightness, q)),
        step_size=float(lerp(so.step_size, eo.step_size, q)),
        stop_thresh=float(lerp(so.stop_thresh, eo.stop_thresh, q)),
        sigma_thresh=float(lerp(so.sigma_thresh, eo.sigma_thresh, q)),
        render_bbox=tuple(
            float(lerp(a, b, q))
            for a, b in zip(so.render_bbox, eo.render_bbox)),
    )
    if so.enable_probe:
        kw["probe"] = tuple(float(lerp(a, b, q))
                            for a, b in zip(so.probe, eo.probe))
    if eo.show_grid:
        sd = so.grid_max_depth if so.show_grid else 0
        if sd != eo.grid_max_depth:
            kw["grid_max_depth"] = int(round(lerp(sd, eo.grid_max_depth, q)))
    if tuple(so.rot_dirs) != tuple(eo.rot_dirs):
        kw["rot_dirs"] = tuple(
            sphc_interp(so.rot_dirs, eo.rot_dirs, q, ax, ay, az))
    opt = eo.replace(**kw)

    mesh_state: Dict[str, MeshState] = {}
    for name, es in end.mesh_state.items():
        cs = dataclasses.replace(es)
        if name in start.mesh_state:
            ss = start.mesh_state[name]
            cs.rotation = sphc_interp(ss.rotation, es.rotation, q, ax, ay, az)
            cs.translation = lerp(ss.translation, es.translation, q)
            cs.scale = float(lerp(ss.scale, es.scale, q))
        mesh_state[name] = cs
    return center, v_back, fx, fy, opt, mesh_state


def frame_times(keyframes: List[AnimKF], fps: float):
    """Export-mode schedule: yields (segment_index, q) per output frame
    (fixed 1/fps steps through each segment, main_anim.cpp:240-243)."""
    out = []
    for i in range(len(keyframes) - 1):
        t_max = keyframes[i + 1].t_max
        n = max(1, int(np.ceil(t_max * fps - 1e-9)))
        for f in range(n):
            out.append((i, min(f / (fps * t_max), 1.0)))
    out.append((len(keyframes) - 2, 1.0))
    return out


def load_script(path: str) -> Tuple[List[AnimKF], dict]:
    """Load keyframes from a JSON script: {"fps": 30, "world_up": [...],
    "keyframes": [{"center": [...], "v_back": [...], "t_max": 1.0,
    "spherical_interp": true, "loops": 0, "fx": ..., "options": {...},
    "meshes": {name: {rotation, translation, scale}}} ...]}."""
    with open(path) as f:
        cfg = json.load(f)
    kfs = []
    for k in cfg["keyframes"]:
        opt = RenderOptions(**k.get("options", {}))
        meshes = {
            name: MeshState(
                rotation=np.asarray(m.get("rotation", (0, 0, 0)), float),
                translation=np.asarray(m.get("translation", (0, 0, 0)),
                                       float),
                scale=float(m.get("scale", 1.0)),
                visible=bool(m.get("visible", True)),
                unlit=bool(m.get("unlit", False)),
            ) for name, m in k.get("meshes", {}).items()}
        kfs.append(AnimKF(
            center=np.asarray(k["center"], float),
            v_back=np.asarray(k["v_back"], float) /
            np.linalg.norm(k["v_back"]),
            origin=np.asarray(k.get("origin", (0, 0, 0)), float),
            fx=float(k.get("fx", 1111.11)),
            fy=float(k.get("fy", k.get("fx", 1111.11))),
            opt=opt,
            mesh_state=meshes,
            t_max=float(k.get("t_max", 1.0)),
            spherical_interp=bool(k.get("spherical_interp", True)),
            loops=int(k.get("loops", 0)),
        ))
    return kfs, cfg
