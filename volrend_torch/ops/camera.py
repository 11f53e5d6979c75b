"""Camera model: CV-style pinhole with C2W basis-vector pose.

Same conventions as the reference (``src/camera.cpp``,
``include/volrend/camera.hpp``): the pose is a 3x4 matrix whose columns are
(right, up, back, center); rays leave the pixel grid with GL's y-down flip
(``src/cuda/volrend.cu:22-32``): d_cam = ((ix-W/2)/fx, -(iy-H/2)/fy, -1).
Default focal 1111.11 (camera.hpp:12) and default orbit pose (camera.cpp:32-36).

The drag camera of the viewer and the animator (``src/camera.cpp:78-138``),
the NDC scenes' initial camera and the pose-file readers of the headless
renderer (``main_headless.cpp``) are host numpy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_FOCAL = 1111.11


@dataclasses.dataclass
class Camera:
    width: int = 800
    height: int = 800
    fx: float = DEFAULT_FOCAL
    fy: float = DEFAULT_FOCAL
    #: 3x4 C2W [right | up | back | center]
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(3, 4, dtype=np.float32))
    movement_speed: float = 1.0

    def __post_init__(self):
        if self.fx < 0:
            self.fx = DEFAULT_FOCAL
        if self.fy < 0:
            self.fy = self.fx
        self.transform = np.asarray(self.transform, np.float32).reshape(3, 4)

    # -- pose construction ----------------------------------------------------

    @staticmethod
    def from_vectors(center=(-3.55, 0.0, 3.55),
                     v_back=(-0.7071068, 0.0, 0.7071068),
                     v_world_up=(0.0, 0.0, 1.0),
                     width: int = 800, height: int = 800,
                     fx: float = DEFAULT_FOCAL,
                     fy: float = -1.0) -> "Camera":
        """Reference Camera::_update(true): orthonormalize from back/world-up."""
        back = np.asarray(v_back, np.float64)
        back = back / np.linalg.norm(back)
        wup = np.asarray(v_world_up, np.float64)
        right = np.cross(wup, back)
        right = right / np.linalg.norm(right)
        up = np.cross(back, right)
        t = np.stack([right, up, back, np.asarray(center, np.float64)], axis=1)
        return Camera(width, height, fx, fy, t.astype(np.float32))

    @property
    def center(self) -> np.ndarray:
        return self.transform[:, 3]

    @property
    def v_back(self) -> np.ndarray:
        return self.transform[:, 2]

    # -- ray generation --------------------------------------------------------

    def pixel_rays(self, xp=np):
        """All-pixel ray origins/dirs in world space, row-major pixel order.

        Returns (origins (H*W,3), dirs (H*W,3) unit). dirs follow
        screen2worlddir exactly (integer pixel coords, y-down flip, -z fwd).
        """
        ix = xp.arange(self.width, dtype=xp.float32)
        iy = xp.arange(self.height, dtype=xp.float32)
        u = (ix - 0.5 * self.width) / self.fx
        v = -(iy - 0.5 * self.height) / self.fy
        uu, vv = xp.meshgrid(u, v, indexing="xy")  # (H, W)
        d_cam = xp.stack(
            [uu, vv, -xp.ones_like(uu)], axis=-1).reshape(-1, 3)
        rot = xp.asarray(self.transform[:, :3])
        dirs = d_cam @ rot.T
        dirs = dirs / xp.linalg.norm(dirs, axis=-1, keepdims=True)
        origins = xp.broadcast_to(
            xp.asarray(self.transform[:, 3]), dirs.shape)
        return origins, dirs


@dataclasses.dataclass
class DragCamera(Camera):
    """Camera with the GUI drag state machine (src/camera.cpp:78-138):
    orbit about origin with pole-flip prevention, pan, move."""
    origin: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    v_world_up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 1.0], np.float32))
    _drag: Optional[dict] = None

    @property
    def v_right(self) -> np.ndarray:
        return self.transform[:, 0]

    @property
    def v_up(self) -> np.ndarray:
        return self.transform[:, 1]

    def update_basis(self, v_back=None, center=None) -> None:
        """Orthonormalize basis from back + world_up (Camera::_update)."""
        if v_back is None:
            v_back = self.v_back
        if center is None:
            center = self.center
        back = np.asarray(v_back, np.float64)
        back /= np.linalg.norm(back)
        right = np.cross(self.v_world_up.astype(np.float64), back)
        n = np.linalg.norm(right)
        if n < 1e-9:
            right = np.array([1.0, 0.0, 0.0])
            n = 1.0
        right /= n
        up = np.cross(back, right)
        self.transform = np.stack(
            [right, up, back, np.asarray(center, np.float64)],
            axis=1).astype(np.float32)

    def begin_drag(self, x: float, y: float, is_pan: bool,
                   about_origin: bool) -> None:
        self._drag = dict(
            start=np.array([x, y], np.float64),
            back=self.v_back.copy(), right=self.v_right.copy(),
            up=self.v_up.copy(), center=self.center.copy(),
            origin=self.origin.copy(), is_pan=is_pan,
            about_origin=about_origin)

    def drag_update(self, x: float, y: float) -> None:
        d = self._drag
        if d is None:
            return
        delta = (np.array([x, y], np.float64) - d["start"]) * (
            -2.0 * self.movement_speed / max(self.width, self.height))
        if d["is_pan"]:
            shift = delta[0] * d["right"] - delta[1] * d["up"]
            self.update_basis(center=d["center"] + shift)
            if d["about_origin"]:
                self.origin = (d["origin"] + shift).astype(np.float32)
            return
        if d["about_origin"]:
            delta = -delta

        def rot(axis, angle):
            return _axis_angle(axis, angle)

        m_tmp = rot(d["right"], -delta[1])
        v_back_tmp = m_tmp @ d["back"]
        # prevent flip over the pole (camera.cpp:111-115)
        if np.dot(np.cross(self.v_world_up, v_back_tmp), d["right"]) < 0:
            return
        m = rot(self.v_world_up, -np.fmod(delta[0], 2 * np.pi)) @ m_tmp
        new_back = m @ d["back"]
        if d["about_origin"]:
            center = m @ (d["center"] - d["origin"]) + d["origin"]
        else:
            center = self.center
        self.update_basis(v_back=new_back, center=center)

    def end_drag(self) -> None:
        self._drag = None

    def move(self, xyz) -> None:
        shift = np.asarray(xyz, np.float64) * self.movement_speed
        self.update_basis(center=self.center + shift)
        if self._drag is not None:
            self._drag["center"] = self._drag["center"] + shift


def _axis_angle(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n < 1e-12 or abs(angle) < 1e-12:
        return np.eye(3)
    k = axis / n
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) * np.cos(angle) + np.sin(angle) * K
            + (1 - np.cos(angle)) * np.outer(k, k))


def ndc_camera(ndc, width: int = 800, height: int = 800,
               fx: float = -1.0, fy: float = -1.0) -> "DragCamera":
    """Initial camera for an NDC/LLFF scene (main.cpp:731-741).

    In NDC space the mean training camera is at the origin looking down -z
    (the warp is defined in the mean-pose frame), so the init is the fixed
    pose center=(0,0,0), back=(0,0,1), world_up=(0,1,0), orbit pivot
    origin=(0,0,-3); default focal = ndc.focal * 0.25. The ``ndc.avg_*``
    fields (the mean pose in *world* coordinates, n3tree.cpp:21-52) supply
    the orbit pivot direction hint; the reference parses but never reads
    them — here they are kept for /info display and pivot sanity.
    """
    if fx <= 0:
        fx = float(ndc.focal) * 0.25
    if fy <= 0:
        fy = fx
    cam = DragCamera(width=width, height=height, fx=fx, fy=fy,
                     movement_speed=0.1)
    cam.origin = np.array([0.0, 0.0, -3.0], np.float32)
    cam.v_world_up = np.array([0.0, 1.0, 0.0], np.float32)
    # nudged off the exact z=0 plane: there the projective NDC image of the
    # camera is at infinity (warped rays turn parallel), which the slab
    # fast path's finite-pinhole parameterization cannot express — 1e-3
    # is visually identical at this focal and keeps the default LLFF pose
    # on the fast path (slab_render.choose_axis NDC gates)
    cam.update_basis(v_back=np.array([0.0, 0.0, 1.0]),
                     center=np.array([0.0, 0.0, 1e-3]))
    return cam


# ---------------------------------------------------------------------------
# Pose files (main_headless.cpp)
# ---------------------------------------------------------------------------

def opencv_to_nerf(transform: np.ndarray) -> np.ndarray:
    """Flip OpenCV camera axes to NeRF convention: negate y & z columns."""
    out = np.array(transform, np.float32).reshape(3, 4).copy()
    out[:, 1] *= -1
    out[:, 2] *= -1
    return out


def read_transform_matrices(path: str) -> List[np.ndarray]:
    """Read one or more 3x4/4x4 row-major C2W poses from a whitespace txt.

    Matches main_headless.cpp:40-63: reads rows of 4 floats; every 4th row
    (if present) is discarded; multiple matrices may be concatenated.
    """
    vals = np.loadtxt(path, dtype=np.float32).reshape(-1, 4)
    out = []
    i = 0
    n = vals.shape[0]
    while i + 3 <= n:
        out.append(vals[i:i + 3].copy())
        i += 3
        if i < n:
            i += 1  # homogeneous/garbage row, consumed whenever present
    return out


def read_intrins(path: str) -> Tuple[float, float]:
    """fx, fy from a 4x4 intrinsics txt (main_headless.cpp:65-74)."""
    vals = np.loadtxt(path, dtype=np.float32).reshape(-1)
    return float(vals[0]), float(vals[5])


def poses_from_files(paths: Sequence[str], reverse_yz: bool = False
                     ) -> Tuple[List[np.ndarray], List[str]]:
    """Load poses + basenames like the headless app
    (main_headless.cpp:113-128)."""
    trans, basenames = [], []
    for path in paths:
        mats = read_transform_matrices(path)
        stem = os.path.splitext(os.path.basename(path))[0]
        if len(mats) == 1:
            basenames.append(stem)
        else:
            basenames.extend(f"{stem}_{i:06d}" for i in range(len(mats)))
        trans.extend(mats)
    if reverse_yz:
        trans = [opencv_to_nerf(t) for t in trans]
    return trans, basenames
