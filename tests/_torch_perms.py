"""One camera per (perm, flip) slab group, for the port's tests of the
training march (tests/test_torch_march_layout.py, test_torch_slab_grad.py,
test_torch_cuda.py). Imports neither JAX nor the JAX package."""

import numpy as np

from volrend_torch.ops import slab_render
from volrend_torch.ops.camera import Camera


def group_cams(grid, width: int, height: int, fx: float,
               radius: float = 2.5, tilt=(0.2, 0.15)) -> dict:
    """{(perm, flip): Camera} over the 12 groups: for each slab axis m and
    side, a view along m tilted toward the two other axes, with either of
    them as the world's up (which picks the order of the row and column
    axes). Only slab-renderable poses are kept."""
    out = {}
    for m in range(3):
        a, b = (m + 1) % 3, (m + 2) % 3
        for side in (1.0, -1.0):
            back = np.zeros(3)
            back[m], back[a], back[b] = side, tilt[0], tilt[1]
            back /= np.linalg.norm(back)
            for up in (a, b):
                cam = Camera.from_vectors(
                    center=tuple(radius * back), v_back=tuple(back),
                    v_world_up=tuple(np.eye(3)[up]), width=width,
                    height=height, fx=fx)
                perm, flip, slope = slab_render.choose_axis(
                    grid, cam.transform, fx, fx, width, height)
                if slope < slab_render.MAX_SLAB_SLOPE:
                    out.setdefault((tuple(perm), bool(flip)), cam)
    return out
