"""The training kernels' launches as the card makes them.

For every instantiation of kernel M's training mode (``csrc/slab_march.cu``)
and of the backward march (``csrc/slab_march_bwd.cu``, both passes), on f32
and bf16 payloads: resident blocks per SM, registers a thread, spill bytes
a thread and dynamic shared memory, from ``vt_march_slabs_info`` and
``vt_march_slabs_bwd_info``, printed as one JSON line keyed by variant
(``slab_march.train_variant``'s names, with the lobe bound for SG/ASG).

``--root DIR`` reads the kernels of another checkout (an unpacked older
commit, built there); where its info entries take (bd, f32) alone, only
its default SH instantiations are read. Run on a card::

    python volrend_torch/probes/train_info.py [--root DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))

#: (name, fmt, bd, opt) of each instantiation (the SG/ASG ones by lobe
#: bound; csrc/slab_common.cuh tmarch::with_variant)
VARIANTS = ([(f"SH{b}", 1, b, 0) for b in (1, 4, 9, 16, 25)]
            + [(f"SH{b}-opt", 1, b, 1) for b in (1, 4, 9, 16, 25)]
            + [(f"{f}<={b}", fm, b, 1) for f, fm in (("SG", 2), ("ASG", 3))
               for b in (4, 9, 16, 25)]
            + [("RGBA", 0, -1, 1)])


def read(kernels, fmt: int, bd: int, opt: int, f32: int,
         old: bool) -> dict:
    """The launches of one instantiation: M's and M-bwd's passes."""
    m = (ctypes.c_int * 11)()
    b = (ctypes.c_int * 7)()
    if old:
        args, fwd, bwd = ((bd, f32), kernels.lib("slab_march"),
                          kernels.lib("slab_march_bwd"))
    else:
        from volrend_torch.ops.slab_march import train_lib
        args, fwd, bwd = ((bd, f32, fmt, opt),
                          train_lib("slab_march", fmt, opt),
                          train_lib("slab_march_bwd", fmt, opt))
    kernels.check(fwd.vt_march_slabs_info(*args, m), "slab_march")
    kernels.check(bwd.vt_march_slabs_bwd_info(*args, b), "slab_march_bwd")
    keys = ("blocks_per_sm", "regs", "spill_bytes", "smem")
    return {"M": dict(zip(keys, m[:4])),
            "M-bwd pass 1": dict(zip(keys, b[:4])),
            "M-bwd pass 2": dict(zip(keys[:3], b[4:]))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(_HERE)), help="the checkout whose kernels to read")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from volrend_torch import kernels
    if not torch.cuda.is_available():
        raise SystemExit("train_info: needs a CUDA device")
    old = len(kernels.SOURCES["slab_march"][1]["vt_march_slabs_info"]) == 3
    out = {"root": os.path.abspath(args.root),
           "device": torch.cuda.get_device_name(0)}
    for name, fmt, bd, opt in VARIANTS:
        if old and (fmt != 1 or opt):
            continue
        for f32 in (1, 0):
            key = f"{name}-{'f32' if f32 else 'bf16'}"
            out[key] = read(kernels, fmt, bd, opt, f32, old)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
