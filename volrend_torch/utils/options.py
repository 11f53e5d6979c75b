"""Render options.

Mirrors the reference tunables (``include/volrend/render_options.hpp:11-53``)
with identical defaults so headless CLI output is drop-in comparable:
step_size 1e-4, sigma_thresh 1e-2, stop_thresh 1e-2, background 1.0.

The dataclass is frozen & hashable, so option sets can key caches (option
changes are per-run, not per-frame).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

GLOBAL_BASIS_MAX = 25  # reference VOLREND_GLOBAL_BASIS_MAX (render_options.hpp:6)


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    # * Basic rendering
    #: Epsilon added to each voxel-skip step to avoid re-hitting the same cube
    step_size: float = 1e-4
    #: Treat sigma < this as empty space
    sigma_thresh: float = 1e-2
    #: Stop marching when remaining light intensity < this
    stop_thresh: float = 1e-2
    #: Background brightness composited behind the volume
    background_brightness: float = 1.0

    # * Visualization
    #: Render bounding box in tree coords [minx,miny,minz,maxx,maxy,maxz]
    render_bbox: Tuple[float, float, float, float, float, float] = (
        0.0, 0.0, 0.0, 1.0, 1.0, 1.0)
    #: Window of spherical-basis indices to keep (inclusive)
    basis_minmax: Tuple[int, int] = (0, GLOBAL_BASIS_MAX - 1)
    #: Axis-angle rotation applied to all view directions (rodrigues)
    rot_dirs: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    # * Advanced visualization
    #: Render depth instead of color
    render_depth: bool = False
    #: Draw octree wireframe grid (handled by the mesh-overlay subsystem)
    show_grid: bool = False
    grid_max_depth: int = 4

    # * Lumisphere probe
    enable_probe: bool = False
    probe: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    probe_disp_size: int = 100

    # * Training-mode extensions (not in the reference, which is forward-only)
    #: When False, skip the early-termination renormalization
    #: (``rt_core.cuh:181-183``); required for a well-defined backward pass.
    renormalize: bool = True
    #: Hard cap on march iterations (safety; reference loops unboundedly)
    max_steps: int = 10000

    def replace(self, **kw) -> "RenderOptions":
        return dataclasses.replace(self, **kw)
