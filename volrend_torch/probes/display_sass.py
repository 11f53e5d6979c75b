"""Kernel M's display defaults in machine code, against another checkout's.

Builds the display library (``csrc/slab_march_display.cu``) of this
checkout and of ``--parent DIR`` (an unpacked older commit, built there:
each in a process of its own that imports that checkout's package),
disassembles both with ``cuobjdump -sass`` and compares, function by
function, the SASS of the SH int8 defaults (``Var<false, F_SH, false>``
at both tile heights, degrees 0-4): a redesign of the other variants must
leave these instructions as they were. Prints one JSON line ({kernel:
{"equal": bool, "instructions": n, "parent_instructions": n}} and the
other instantiations' counts) and exits 1 if a default differs or is
missing. Run on a card (the build needs the toolkit's nvcc and
cuobjdump)::

    python -m volrend_torch.probes.display_sass --parent DIR
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))

#: the default instantiations' demangled names: display_kernel<BD, ROWS,
#: Var<false, 1, false, false, false>>
DEFAULT = re.compile(r"display_kernel<(\d+), (\d+), "
                     r"\(anonymous namespace\)::Var<false, 1, false, false, "
                     r"false> >")


def library(root: str) -> str:
    """The path of ``root``'s display library, built if it is not."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from volrend_torch import kernels; "
            "kernels.lib('slab_march_display'); "
            "print(kernels._target('slab_march_display'))")
    out = subprocess.run([sys.executable, "-c", code, root], check=True,
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[-1]


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise RuntimeError(f"display_sass: {name} not found")
    return path


def functions(lib: str) -> dict:
    """{demangled kernel name: its SASS lines} of a library."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            out[name].append(line.strip())
    filt = shutil.which("c++filt")
    if filt and out:
        names = list(out)
        res = subprocess.run([filt], input="\n".join(names), text=True,
                             capture_output=True).stdout.splitlines()
        if len(res) == len(names):
            out = {res[i]: out[n] for i, n in enumerate(names)}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the checkout whose defaults to compare with")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("display_sass reads kernels built for a CUDA "
                           "device; none is available")
    mine = functions(library(_ROOT))
    theirs = functions(library(os.path.abspath(args.parent)))
    out, ok = {"defaults": {}, "others": {}}, True
    for name, sass in sorted(mine.items()):
        m = DEFAULT.search(name)
        if not m:
            out["others"][name] = len(sass)
            continue
        key = f"SH{m.group(1)}-int8-r{m.group(2)}"
        old = next((v for k, v in theirs.items() if DEFAULT.search(k)
                    and DEFAULT.search(k).groups() == m.groups()), None)
        equal = old == sass
        ok &= equal
        out["defaults"][key] = {
            "equal": equal, "instructions": len(sass),
            "parent_instructions": None if old is None else len(old)}
    ok &= len(out["defaults"]) == 10
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
