"""Mesh overlay subsystem: procedural primitives, OBJ, drawlist npz.

Python/NumPy re-design of the reference mesh layer (``src/mesh.cpp``,
``include/volrend/mesh.hpp``) minus the GL plumbing: same 9-float interleaved
vertex layout (pos3 + rgb3 + normal3, mesh.cpp:26), same primitive
generators (mesh.cpp:399-627), same drawlist npz schema (mesh.cpp:770-938:
``<name>`` -> type string, ``<name>__<field>`` -> field arrays), same OBJ
handling (vertex colors + accumulated face-normal estimation,
mesh.cpp:62-97, 680-768). Rendering happens in ``ops/rasterize.py`` which
produces the color + euclidean-distance buffers the volume renderer
composites against (the reference's attachment-1 contract, mesh.cpp:159).

All construction is vectorized; no per-vertex Python loops.

The port's own copy of ``volrend_tpu/models/mesh.py`` (NumPy only): the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

VERT_SZ = 9
DEFAULT_COLOR = (1.0, 0.5, 0.2)

__all__ = ["Mesh", "load_basic_obj", "open_drawlist", "estimate_normals"]


def _axis_angle_matrix(r: np.ndarray) -> np.ndarray:
    r = np.asarray(r, np.float64)
    angle = float(np.linalg.norm(r))
    if angle < 1e-3:  # reference threshold (mesh.cpp:651)
        return np.eye(3, dtype=np.float32)
    k = r / angle
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = (np.eye(3) * np.cos(angle) + np.sin(angle) * K
         + (1 - np.cos(angle)) * np.outer(k, k))
    return R.astype(np.float32)


def estimate_normals(vert: np.ndarray, faces: Optional[np.ndarray]) -> None:
    """Accumulate unnormalized face cross products per vertex, then
    normalize (mesh.cpp:62-97 semantics). vert (n,9) modified in place."""
    n = vert.shape[0]
    if faces is not None and faces.size:
        idx = faces.reshape(-1, 3).astype(np.int64)
    else:
        idx = np.arange((n // 3) * 3, dtype=np.int64).reshape(-1, 3)
    p = vert[:, :3]
    a = p[idx[:, 1]] - p[idx[:, 0]]
    b = p[idx[:, 2]] - p[idx[:, 0]]
    cross = np.cross(a, b)
    acc = np.zeros((n, 3), np.float32)
    for j in range(3):
        np.add.at(acc, idx[:, j], cross)
    norm = np.linalg.norm(acc, axis=-1, keepdims=True)
    vert[:, 6:9] = np.where(norm > 1e-6, acc / np.maximum(norm, 1e-12), acc)


@dataclasses.dataclass
class Mesh:
    """Host-side mesh with the reference's model-transform semantics."""
    vert: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, VERT_SZ), np.float32))
    faces: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.uint32))
    #: 1 = points, 2 = lines, 3 = triangles
    face_size: int = 3
    rotation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    translation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    scale: float = 1.0
    visible: bool = True
    unlit: bool = False
    name: str = "Mesh"

    @property
    def n_verts(self) -> int:
        return self.vert.shape[0]

    def transform_matrix(self) -> np.ndarray:
        """4x4 model matrix: translate * (rot(axis-angle) * uniform scale)."""
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = _axis_angle_matrix(self.rotation) * np.float32(self.scale)
        m[:3, 3] = np.asarray(self.translation, np.float32)
        return m

    def transformed_verts(self) -> np.ndarray:
        """World-space positions/colors/normals after the model transform."""
        m = self.transform_matrix()
        out = self.vert.copy()
        out[:, :3] = self.vert[:, :3] @ m[:3, :3].T + m[:3, 3]
        R = _axis_angle_matrix(self.rotation)
        out[:, 6:9] = self.vert[:, 6:9] @ R.T
        return out

    def auto_faces(self) -> None:
        self.faces = np.arange(self.n_verts, dtype=np.uint32)

    def repeat(self, n: int) -> None:
        """Tile vertices/faces n times, offsetting face indices
        (mesh.cpp:633-651)."""
        if n < 1:
            return
        nv = self.n_verts
        self.vert = np.tile(self.vert, (n, 1))
        offs = (np.arange(n, dtype=np.uint32)[:, None]
                * np.uint32(nv)).repeat(self.faces.shape[0], 1)
        self.faces = (np.tile(self.faces, n).reshape(n, -1)
                      + offs).reshape(-1).astype(np.uint32)

    def apply_transform(self, r, t, start: int = 0, end: int = -1) -> None:
        """Axis-angle + translation applied directly to a vertex range."""
        if end == -1:
            end = self.n_verts
        R = _axis_angle_matrix(np.asarray(r, np.float32))
        t = np.asarray(t, np.float32)
        self.vert[start:end, :3] = self.vert[start:end, :3] @ R.T + t
        self.vert[start:end, 6:9] = self.vert[start:end, 6:9] @ R.T

    # -- primitives (mesh.cpp:399-627 semantics) -----------------------------

    @staticmethod
    def _fill(pos: np.ndarray, color, normal=None) -> np.ndarray:
        n = pos.shape[0]
        v = np.zeros((n, VERT_SZ), np.float32)
        v[:, :3] = pos
        v[:, 3:6] = np.asarray(color, np.float32)
        v[:, 6:9] = (0.0, 0.0, 1.0) if normal is None else normal
        return v

    @staticmethod
    def Cube(color=DEFAULT_COLOR) -> "Mesh":
        """Unit cube centered at 0: 36 unindexed verts, per-face normals."""
        tri = np.array([[0, 0], [1, 1], [1, 0], [1, 1], [0, 0], [0, 1]],
                       np.float32) - 0.5                     # 2 tris in 2-D
        verts = []
        for axis in range(3):
            for sgn in (-1.0, 1.0):
                p = np.zeros((6, 3), np.float32)
                u, w = (axis + 1) % 3, (axis + 2) % 3
                # match the reference's (u, w) assignment order per face
                p[:, w], p[:, u] = tri[:, 0], tri[:, 1]
                p[:, axis] = 0.5 * sgn
                nrm = np.zeros(3, np.float32)
                nrm[axis] = sgn
                verts.append(Mesh._fill(p, color, nrm))
        m = Mesh(np.concatenate(verts), np.zeros((0,), np.uint32), 3)
        m.name = "Cube"
        return m

    @staticmethod
    def Sphere(rings: int = 15, sectors: int = 30,
               color=DEFAULT_COLOR) -> "Mesh":
        r = np.arange(rings)[:, None]
        s = np.arange(sectors)[None, :]
        Rstep = np.pi / (rings - 1)
        Sstep = 2 * np.pi / sectors
        z = np.sin(-0.5 * np.pi + r * Rstep) + 0 * s
        x = np.cos(s * Sstep) * np.sin(r * Rstep)
        y = np.sin(s * Sstep) * np.sin(r * Rstep)
        pos = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
        m = Mesh(Mesh._fill(pos, color, None), face_size=3)
        m.vert[:, 6:9] = pos
        rr = np.arange(rings - 1)[:, None]
        ss = np.arange(sectors)[None, :]
        nx_s = (ss + 1) % sectors
        quad = np.stack([
            rr * sectors + nx_s, rr * sectors + ss, (rr + 1) * sectors + ss,
            (rr + 1) * sectors + ss, (rr + 1) * sectors + nx_s,
            rr * sectors + nx_s,
        ], -1)
        m.faces = quad.reshape(-1).astype(np.uint32)
        m.name = "Sphere"
        return m

    @staticmethod
    def Lattice(reso: int = 8, color=(0.5, 0.5, 0.5)) -> "Mesh":
        g = (np.arange(reso, dtype=np.float32) + 0.5) / reso
        x, y, z = np.meshgrid(g, g, g, indexing="ij")
        pos = np.stack([x, y, z], -1).reshape(-1, 3)
        m = Mesh(Mesh._fill(pos, color, (1.0, 0.0, 0.0)), face_size=1)
        m.name = "Lattice"
        m.unlit = True
        return m

    @staticmethod
    def CameraFrustum(focal_length: float, image_width: float,
                      image_height: float, z: float = -0.3,
                      color=(0.5, 0.5, 0.5)) -> "Mesh":
        invf = 1.0 / focal_length
        hw, hh = image_width * 0.5, image_height * 0.5
        pos = np.array([
            [0, 0, 0],
            [z * -hw * invf, z * -hh * invf, z],
            [z * -hw * invf, z * hh * invf, z],
            [z * hw * invf, z * hh * invf, z],
            [z * hw * invf, z * -hh * invf, z],
        ], np.float32)
        m = Mesh(Mesh._fill(pos, color), face_size=2)
        m.faces = np.array([0, 1, 0, 2, 0, 3, 0, 4, 1, 2, 2, 3, 3, 4, 4, 1],
                           np.uint32)
        m.name = "CameraFrustum"
        m.unlit = True
        return m

    @staticmethod
    def Line(a, b, color=(0.5, 0.5, 0.5)) -> "Mesh":
        pos = np.stack([np.asarray(a, np.float32),
                        np.asarray(b, np.float32)])
        m = Mesh(Mesh._fill(pos, color), face_size=2)
        m.faces = np.array([0, 1], np.uint32)
        m.name = "Line"
        m.unlit = True
        return m

    @staticmethod
    def Lines(points, color=(0.5, 0.5, 0.5)) -> "Mesh":
        pos = np.asarray(points, np.float32).reshape(-1, 3)
        n = pos.shape[0]
        m = Mesh(Mesh._fill(pos, color), face_size=2)
        seg = np.stack([np.arange(n - 1), np.arange(1, n)], -1)
        m.faces = seg.reshape(-1).astype(np.uint32)
        m.name = "Lines"
        m.unlit = True
        return m

    @staticmethod
    def Points(points, color=(0.5, 0.5, 0.5)) -> "Mesh":
        pos = np.asarray(points, np.float32).reshape(-1, 3)
        m = Mesh(Mesh._fill(pos, color), face_size=1)
        m.name = "Points"
        m.unlit = True
        return m


# ---------------------------------------------------------------------------
# OBJ loader (tiny_obj_loader replacement; mesh.cpp:680-768 semantics)
# ---------------------------------------------------------------------------

def load_basic_obj(path_or_str: str, from_string: bool = False) -> Mesh:
    """Triangles + optional per-vertex colors (v x y z [r g b]); normals
    estimated when absent; polygon faces fan-triangulated."""
    text = path_or_str if from_string else open(path_or_str).read()
    verts: List[List[float]] = []
    colors: List[List[float]] = []
    normals: List[List[float]] = []
    faces: List[int] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if parts[0] == "v":
            vals = [float(x) for x in parts[1:]]
            verts.append(vals[:3])
            # tinyobj (vertex_color=true) defaults colorless verts to white
            colors.append(vals[3:6] if len(vals) >= 6 else [1.0, 1.0, 1.0])
        elif parts[0] == "vn":
            normals.append([float(x) for x in parts[1:4]])
        elif parts[0] == "f":
            idx = [int(p.split("/")[0]) for p in parts[1:]]
            idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
            for k in range(1, len(idx) - 1):  # fan triangulation
                faces.extend([idx[0], idx[k], idx[k + 1]])

    n = len(verts)
    vert = np.zeros((n, VERT_SZ), np.float32)
    vert[:, :3] = np.asarray(verts, np.float32).reshape(n, 3)
    vert[:, 3:6] = np.asarray(colors[:n], np.float32)
    farr = np.asarray(faces, np.uint32)
    if len(normals) >= n:
        vert[:, 6:9] = np.asarray(normals[:n], np.float32)
    else:
        estimate_normals(vert, farr)
    m = Mesh(vert, farr, 3)
    m.name = "OBJ" if from_string else path_or_str
    if not from_string:
        _apply_offs_sidecar(m, path_or_str + ".offs")
    return m


def _apply_offs_sidecar(m: Mesh, offs_path: str) -> None:
    """Auto-offset sidecar: a ``<name>.obj.offs`` file next to the OBJ
    holds ``tx ty tz [scale]`` applied to the mesh's model transform on
    load (main.cpp:423-431)."""
    try:
        with open(offs_path) as f:
            tokens = f.read().split()
    except OSError:
        return
    # stream-extraction semantics (main.cpp:425-430): read leading floats,
    # stop at the first non-numeric token instead of discarding the file
    vals = []
    for t in tokens[:4]:
        try:
            vals.append(float(t))
        except ValueError:
            break
    if len(vals) >= 3:
        m.translation = np.asarray(vals[:3], np.float32)
        if len(vals) >= 4:
            m.scale = vals[3]


# ---------------------------------------------------------------------------
# Drawlist npz (mesh.cpp:770-938 schema)
# ---------------------------------------------------------------------------

def _split2u(s: str) -> List[str]:
    """Split on double underscore (mesh.cpp:167-182)."""
    out, j, i = [], 0, 1
    while i < len(s):
        if s[i] == "_" and s[i - 1] == "_":
            if i - 1 - j > 0:
                out.append(s[j:i - 1])
            j = i + 1
        i += 1
    if j < len(s):
        out.append(s[j:])
    return out


def _get(fields, key, default):
    if key not in fields:
        return default
    v = np.asarray(fields[key]).ravel()
    if isinstance(default, (int, bool)):
        return int(v[0])
    if isinstance(default, float):
        return float(v[0])
    return v


def _get_vec3(fields, key, default):
    if key not in fields:
        return np.asarray(default, np.float32)
    return np.asarray(fields[key], np.float32).ravel()[:3]


def open_drawlist(path_or_dict, default_visible: bool = True) -> List[Mesh]:
    """Load a drawlist npz: keys ``<name>`` (type string) and
    ``<name>__<field>``; returns meshes sorted by name (reference map
    iteration order)."""
    if isinstance(path_or_dict, dict):
        npz = path_or_dict
    elif isinstance(path_or_dict, (bytes, bytearray)):
        import io as _io
        with np.load(_io.BytesIO(path_or_dict), allow_pickle=False) as f:
            npz = dict(f.items())   # open_drawlist_mem parity
    else:
        with np.load(path_or_dict, allow_pickle=False) as f:
            npz = dict(f.items())

    parsed: Dict[str, Tuple[Optional[str], dict]] = {}
    for full, arr in npz.items():
        spl = _split2u(full)
        if len(spl) == 1:
            tname = str(np.asarray(arr).ravel()[0]).lower()
            parsed.setdefault(spl[0], [None, {}])[0] = tname
            parsed[spl[0]] = [tname, parsed[spl[0]][1]]
        elif len(spl) == 2:
            parsed.setdefault(spl[0], [None, {}])[1][spl[1]] = arr

    meshes: List[Mesh] = []
    for name in sorted(parsed.keys()):
        mtype, fields = parsed[name]
        if mtype is None:
            continue
        color = _get_vec3(fields, "color", DEFAULT_COLOR)
        if mtype == "cube":
            me = Mesh.Cube(color)
        elif mtype == "sphere":
            me = Mesh.Sphere(_get(fields, "rings", 15),
                             _get(fields, "sectors", 30), color)
        elif mtype == "line":
            me = Mesh.Line(_get_vec3(fields, "a", (0, 0, 0)),
                           _get_vec3(fields, "b", (0, 0, 1)), color)
        elif mtype == "camerafrustum":
            me = Mesh.CameraFrustum(
                _get(fields, "focal_length", 1111.0),
                _get(fields, "image_width", 800.0),
                _get(fields, "image_height", 800.0),
                _get(fields, "z", -0.3), color)
            if "t" in fields:
                t = np.asarray(fields["t"], np.float32).reshape(-1, 3)
                r = np.asarray(fields["r"], np.float32).reshape(-1, 3)
                nv = me.n_verts
                me.repeat(t.shape[0])
                for i in range(t.shape[0]):
                    me.apply_transform(r[i], t[i], nv * i, nv * (i + 1))
                if _get(fields, "connect", 0):
                    traj = np.stack([np.arange(t.shape[0] - 1) * nv,
                                     np.arange(1, t.shape[0]) * nv], -1)
                    me.faces = np.concatenate(
                        [me.faces, traj.reshape(-1).astype(np.uint32)])
        elif mtype == "lines":
            me = Mesh.Lines(np.asarray(fields["points"], np.float32), color)
            if "segs" in fields:
                me.faces = np.asarray(fields["segs"],
                                      np.uint32).reshape(-1)
        elif mtype == "points":
            me = Mesh.Points(np.asarray(fields["points"], np.float32), color)
        elif mtype == "mesh":
            me = Mesh.Points(np.asarray(fields["points"], np.float32), color)
            me.face_size = _get(fields, "face_size", 3)
            if me.face_size not in (1, 2, 3):
                me.face_size = 3
            if "faces" in fields:
                me.faces = np.asarray(fields["faces"], np.uint32).reshape(-1)
            if me.face_size == 3:
                estimate_normals(me.vert, me.faces)
                me.unlit = False
        else:
            continue
        if "vert_color" in fields:
            vc = np.asarray(fields["vert_color"], np.float32).reshape(-1, 3)
            if vc.shape[0] == me.n_verts:
                me.vert[:, 3:6] = vc
        me.name = name
        me.scale = _get(fields, "scale", 1.0)
        me.translation = _get_vec3(fields, "translation", (0, 0, 0))
        me.rotation = _get_vec3(fields, "rotation", (0, 0, 0))
        me.visible = bool(_get(fields, "visible", int(default_visible)))
        me.unlit = bool(_get(fields, "unlit", int(me.unlit)))
        meshes.append(me)
    return meshes
