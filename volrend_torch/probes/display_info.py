"""The display kernels' launches as the card makes them.

For every instantiation of kernel M's display mode
(``csrc/slab_march_display.cu``: resident blocks per SM, registers a
thread, spill bytes a thread and static shared memory, from
``vt_march_display_info`` at the display path's shared-memory budget,
keyed ``<fmt><bd>-<payload>[-opt|-bf16shade|-bf16shade-opt]-r<rows>``
(``-bf16shade``: bf16 shading without options), SG and ASG without
a lobe count, ``RGBA-<payload>-r1`` RGBA's kernel of its own
(``rgba_kernel`` at two blocks an SM) and ``RGBA-<payload>-b3-r1`` at
three (read at its budget: ``info_smem``), ``depth-<payload>-r1`` the
depth variant) and of kernel W
(``csrc/warp_display.cu``: registers and spill stores of each entry
function, from the build's ``ptxas -v`` report, keyed by the demangled
name where ``c++filt`` is on the path), printed as one JSON line.

``--root DIR`` reads the kernels of another checkout (an unpacked older
commit, built there); instantiations that checkout does not build are
left out. Run on a card::

    python volrend_torch/probes/display_info.py [--root DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))

#: (key, bd, rows, fmt, bf16, opt) of kernel M's display instantiations
#: (SG and ASG: one for every lobe count, read at 16 lobes; depth: opt 5,
#: one for every format)
M_VARIANTS = (
    [(f"SH{b}-{p}-r{r}", b, r, 1, bf, 0)
     for b in (1, 4, 9, 16, 25) for bf, p in ((0, "int8"), (1, "bf16"))
     for r in (1, 2)]
    + [(f"SH{b}-{p}-{o}-r1", b, 1, 1, bf, code)
       for o, code in (("opt", 1), ("bf16shade-opt", 3))
       for b in (1, 4, 9, 16, 25) for bf, p in ((0, "int8"), (1, "bf16"))]
    + [(f"SH{b}-{p}-bf16shade-r{r}", b, r, 1, bf, 2)
       for b in (1, 4, 9, 16, 25) for bf, p in ((0, "int8"), (1, "bf16"))
       for r in (1, 2)]
    + [(f"{f}-{p}-opt-r{r}", 16, r, fm, bf, 1)
       for f, fm in (("SG", 2), ("ASG", 3))
       for bf, p in ((0, "int8"), (1, "bf16")) for r in (1, 2)]
    + [(f"RGBA-{p}-opt-r1", -1, 1, 0, bf, 1)
       for bf, p in ((0, "int8"), (1, "bf16"))]
    + [(f"RGBA-{p}{b}-r1", -1, 1, 0, bf, code)
       for b, code in (("", 0), ("-b3", 4))
       for bf, p in ((0, "int8"), (1, "bf16"))]
    + [(f"depth-{p}-r1", 16, 1, 1, bf, 5)
       for bf, p in ((0, "int8"), (1, "bf16"))])


def info_smem(opt: int) -> int:
    """The shared memory a variant's launch is read at: RGBA's kernel at
    three blocks an SM (opt 4) at its own budget, every other at the
    display path's."""
    from volrend_torch.ops import slab_march
    if opt == 4:
        # a checkout that builds no such kernel leaves the row out (its
        # info call fails), whatever budget it is read at
        return getattr(slab_march, "_RGBA_SMEM", {3: 72 * 1024})[3]
    return slab_march._DISPLAY_SMEM


def ptxas_entries(log: str) -> dict:
    """{entry: [registers, spill store bytes]} from a ``-Xptxas -v``
    build log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = [None, None]
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return out


def demangle(names) -> dict:
    names = list(names)
    tool = shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    res = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True)
    outs = res.stdout.splitlines()
    return dict(zip(names, outs)) if len(outs) == len(names) else \
        {n: n for n in names}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(_HERE)), help="the checkout whose kernels to read")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from volrend_torch import kernels
    if not torch.cuda.is_available():
        raise SystemExit("display_info: needs a CUDA device")
    out = {"root": os.path.abspath(args.root),
           "device": torch.cuda.get_device_name(0), "M": {}, "W": {}}
    lib = kernels.lib("slab_march_display")
    for key, bd, rows, fmt, bf16, opt in M_VARIANTS:
        info = (ctypes.c_int * 4)()
        if lib.vt_march_display_info(bd, rows, fmt, bf16, opt,
                                     info_smem(opt), info) == 0:
            out["M"][key] = list(info)
    kernels.lib("warp_display")
    log = kernels._target("warp_display").with_suffix(".log").read_text()
    ent = ptxas_entries(log)
    names = demangle(ent)
    out["W"] = {names[k]: v for k, v in ent.items()}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
