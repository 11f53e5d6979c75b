"""Camera model: CV-style pinhole with C2W basis-vector pose.

Same conventions as the reference (``src/camera.cpp``,
``include/volrend/camera.hpp``): the pose is a 3x4 matrix whose columns are
(right, up, back, center); rays leave the pixel grid with GL's y-down flip
(``src/cuda/volrend.cu:22-32``): d_cam = ((ix-W/2)/fx, -(iy-H/2)/fy, -1).
Default focal 1111.11 (camera.hpp:12) and default orbit pose (camera.cpp:32-36).

The pose-file readers and the drag camera of the apps are ported with the
apps; the display path needs the camera and its rays only.
"""

from __future__ import annotations

import dataclasses

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
