"""Shared CLI flags, mirroring the reference option layer (the counterpart
of ``volrend_tpu/cli/opts.py``).

Same names/defaults as ``src/opts.cpp:7-31`` (add_common_opts) and
``render_options_from_args`` (``src/opts.cpp:44-66``) so invocations are
drop-in comparable with the reference executables. The reference's
``--platform {auto,cpu,tpu}`` is ``--device`` here: ``cuda`` by default,
``cpu`` to run the plain PyTorch versions on the host.
"""

from __future__ import annotations

import argparse

import torch

from volrend_torch.utils.device import resolve
from volrend_torch.utils.options import RenderOptions

__all__ = ["add_common_opts", "render_options_from_args", "device_from_args"]


def add_common_opts(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("file", help="npz PlenOctree file")
    parser.add_argument("--draw", default=None,
                        help="npz drawlist or OBJ mesh overlay file")
    parser.add_argument("--gpu", type=int, default=-1,
                        help="device id (-1 = default)")
    parser.add_argument("-W", "--width", type=int, default=800)
    parser.add_argument("-H", "--height", type=int, default=800)
    parser.add_argument("--fx", type=float, default=-1.0,
                        help="focal x; -1 = default 1111.11")
    parser.add_argument("--fy", type=float, default=-1.0,
                        help="focal y; -1 = use fx")
    parser.add_argument("-b", "--bg", type=float, default=1.0,
                        help="background brightness")
    parser.add_argument("-s", "--step_size", type=float, default=1e-4)
    parser.add_argument("-e", "--stop_thresh", type=float, default=1e-2)
    parser.add_argument("-a", "--sigma_thresh", type=float, default=1e-2)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default; raises without a "
                             "card) or cpu (the plain PyTorch versions)")


def device_from_args(args) -> torch.device:
    """The device the command runs on: ``--device``, with ``--gpu``'s index
    on a CUDA device. Raises when CUDA is asked for and no card is
    present."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None and args.gpu >= 0:
        dev = torch.device("cuda", args.gpu)
    return resolve(dev)


def render_options_from_args(args) -> RenderOptions:
    return RenderOptions(
        step_size=args.step_size,
        sigma_thresh=args.sigma_thresh,
        stop_thresh=args.stop_thresh,
        background_brightness=args.bg,
    )
