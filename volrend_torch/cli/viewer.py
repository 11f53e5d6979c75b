"""Interactive viewer CLI — the ``volrend`` GUI equivalent, served over
HTTP with server-side CUDA rendering (see volrend_torch/web/server.py; the
counterpart of ``volrend_tpu/cli/viewer.py``)."""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="volrend_viewer")
    p.add_argument("file", help="npz PlenOctree file")
    p.add_argument("--draw", default=None, help="drawlist npz / OBJ overlay")
    p.add_argument("--port", type=int, default=8781)
    p.add_argument("--no-slab", action="store_true",
                   help="disable the dense-grid fast path")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a "
                        "card) or cpu (the plain PyTorch versions)")
    args = p.parse_args(argv)
    from volrend_torch.utils.device import resolve
    from volrend_torch.web.server import serve
    serve(args.file, draw=args.draw, port=args.port,
          use_slab=not args.no_slab, device=resolve(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
