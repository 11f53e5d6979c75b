"""Dataset tooling: NeRF-synthetic transforms -> pose txts / cam drawlists
(the port's own copy of ``volrend_tpu/cli/extract_poses.py``, NumPy only).

Parity with ``scripts/extract_test_poses.py`` (per-frame 4x4 pose txt +
intrinsics from camera_angle_x at 800x800) and
``scripts/extract_cams_drawlist.py`` (train poses as a camerafrustum
drawlist npz, rotations as rotation vectors) — no scipy dependency, the
matrix->rotvec conversion is inlined.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
from glob import glob

import numpy as np

__all__ = ["extract_test_poses", "extract_cams_drawlist", "main"]


def _rotmat_to_rotvec(R: np.ndarray) -> np.ndarray:
    """Batch (N,3,3) rotation matrices -> axis-angle vectors (N,3)."""
    tr = np.clip((np.trace(R, axis1=1, axis2=2) - 1.0) * 0.5, -1.0, 1.0)
    angle = np.arccos(tr)
    axis = np.stack([R[:, 2, 1] - R[:, 1, 2],
                     R[:, 0, 2] - R[:, 2, 0],
                     R[:, 1, 0] - R[:, 0, 1]], -1)
    sin = np.sin(angle)
    small = np.abs(sin) < 1e-7
    scale = np.where(small, 0.5, angle / np.maximum(2.0 * sin, 1e-12))
    out = axis * scale[:, None]
    # angle ~ pi: axis from the symmetric part
    near_pi = angle > np.pi - 1e-3
    if near_pi.any():
        for i in np.flatnonzero(near_pi):
            M = (R[i] + np.eye(3)) * 0.5
            ax = np.sqrt(np.maximum(np.diag(M), 0.0))
            k = int(np.argmax(ax))
            v = M[:, k] / max(ax[k], 1e-12)
            v = v / np.linalg.norm(v)
            out[i] = v * angle[i]
    return out


def extract_test_poses(root: str, half_width: float = 400.0) -> int:
    n = 0
    for transform_path in sorted(glob(
            osp.join(root, "*", "transforms_test.json"))):
        print(transform_path)
        root_dir = osp.dirname(transform_path)
        poses_dir = osp.join(root_dir, "pose")
        os.makedirs(poses_dir, exist_ok=True)
        with open(transform_path) as f:
            j = json.load(f)
        for frame in j["frames"]:
            basename = osp.basename(frame["file_path"])
            np.savetxt(osp.join(poses_dir, basename + ".txt"),
                       np.array(frame["transform_matrix"]))
        focal = half_width / np.tan(0.5 * j["camera_angle_x"])
        K = np.diag([focal, focal, 1.0, 1.0])
        K[:2, 2] = [half_width, half_width]
        np.savetxt(osp.join(root_dir, "intrinsics.txt"), K)
        n += 1
    return n


def extract_cams_drawlist(root: str, half_width: float = 400.0) -> int:
    n = 0
    for transform_path in sorted(glob(
            osp.join(root, "*", "transforms_train.json"))):
        root_dir = osp.dirname(transform_path)
        out_path = osp.join(root_dir,
                            osp.basename(root_dir) + "_cams.draw.npz")
        print(transform_path, "to", out_path)
        with open(transform_path) as f:
            j = json.load(f)
        mtx = np.array([fr["transform_matrix"] for fr in j["frames"]])
        focal = half_width / np.tan(0.5 * j["camera_angle_x"])
        np.savez_compressed(
            out_path,
            cameras="camerafrustum",
            cameras__t=mtx[:, :3, 3],
            cameras__r=_rotmat_to_rotvec(mtx[:, :3, :3]),
            cameras__focal_length=np.float32(focal),
            cameras__image_width=np.float32(half_width * 2),
            cameras__image_height=np.float32(half_width * 2),
            cameras__z=np.float32(-0.25),
            cameras__color=np.array([1.0, 0.5, 0.0], np.float32),
        )
        n += 1
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="extract_poses")
    p.add_argument("root", help="nerf_synthetic root directory")
    p.add_argument("--mode", choices=("test_poses", "cams_drawlist", "both"),
                   default="both")
    args = p.parse_args(argv)
    if args.mode in ("test_poses", "both"):
        extract_test_poses(args.root)
    if args.mode in ("cams_drawlist", "both"):
        extract_cams_drawlist(args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
