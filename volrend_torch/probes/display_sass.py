"""Kernel M's display defaults in machine code, against another checkout's.

Builds the display library (``csrc/slab_march_display.cu``) of this
checkout and of ``--parent DIR`` (an unpacked older commit, built there:
each in a process of its own that imports that checkout's package),
disassembles both with ``cuobjdump -sass`` and compares, function by
function, the SASS of the SH int8 defaults (``Var<false, F_SH, false>``
at both tile heights, degrees 0-4): a redesign of the other variants must
leave these instructions as they were. Prints one JSON line ({kernel:
{"equal": bool, "instructions": n, "parent_instructions": n, "sha256":
digest of its SASS lines}} and the other instantiations' counts) and exits
1 if a default differs or is missing. ``--pinned`` compares the defaults
with the digests this file pins (PINNED: read from the commit whose
defaults every later one keeps, with the toolkit PINNED_TOOLKIT names)
instead of a parent checkout, for a checkout that has no parent beside
it; under another toolkit release the digests say nothing, so the
defaults are reported unchecked (``"checked": false``) and the exit code
is 0. Run on a card (the build needs the toolkit's nvcc and cuobjdump)::

    python -m volrend_torch.probes.display_sass (--parent DIR | --pinned)
"""

from __future__ import annotations

import argparse
import hashlib
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


#: the nvcc release PINNED was read with
PINNED_TOOLKIT = "12.9"

#: the defaults' SASS digests (sha256 of the lines ``functions`` keeps) of
#: the commit whose machine code every later commit keeps (ec5a22c, read
#: beside it with --parent), on NVIDIA H100 80GB HBM3, built by nvcc
#: release PINNED_TOOLKIT
PINNED = {
    "SH1-int8-r1":
        "943191aa6fe5da773ea1f0b849d2c4f274f2c336639470ec0dc01cfff0e056d7",
    "SH1-int8-r2":
        "1cb43af26a268bd7ffdd4813cef3f6591cc7d4e639a0cc74bcb40bda099f00ef",
    "SH4-int8-r1":
        "122aeb45cbb41c4111fee6d07820279935fa6cd26707b4b70d6e1708ae89738a",
    "SH4-int8-r2":
        "a2e377ce1f241b394c2fee0d1b1f9abd67804db97c8e68a15a93abe70852943e",
    "SH9-int8-r1":
        "20e1701256c17043a9d767af37191c5d0a5a582fb4fc5489fe8c26b391fa4b18",
    "SH9-int8-r2":
        "a25210d7f61b7c08860308e80af54f0860ab0555d6fa9ebd7f29157dd430e36d",
    "SH16-int8-r1":
        "ac3eb09652255cf051c01a3250685100898fd0b543d9778f90349267ada91d6a",
    "SH16-int8-r2":
        "2bc0060b5a6981c1fc647dbc15f28ee68fe2fca13064913358c87ebb673a6868",
    "SH25-int8-r1":
        "345a58140ffaaeeb5f4c15849e31882b554a4ceeecbbaf35cf0c29af0788bbbc",
    "SH25-int8-r2":
        "708b8a15b559804f58d9ac3050f3efe78d676872ddb46cae521f28b2748b7d8d",
}


def digest(sass) -> str:
    """The sha256 of a function's SASS lines."""
    return hashlib.sha256("\n".join(sass).encode()).hexdigest()


def library(root: str) -> str:
    """The path of ``root``'s display library, built if it is not."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from volrend_torch import kernels; "
            "kernels.lib('slab_march_display'); "
            "print(kernels._target('slab_march_display'))")
    out = subprocess.run([sys.executable, "-c", code, root], check=True,
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[-1]


def toolkit() -> str:
    """The release of the nvcc the kernels are built with ("12.9")."""
    from volrend_torch import kernels
    text = subprocess.run([kernels._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    m = re.search(r"release (\d+\.\d+)", text)
    return m.group(1) if m else text.strip().splitlines()[-1]


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise RuntimeError(f"display_sass: {name} not found")
    return path


def functions(lib: str) -> dict:
    """{demangled kernel name: its SASS lines} of a library, each line's
    runs of whitespace collapsed to one space: cuobjdump pads its comment
    column to the longest instruction of the whole library, so a new
    instantiation with a longer instruction moves every function's padding
    while their instructions and encodings stay as they were."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            out[name].append(" ".join(line.split()))
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
    how = ap.add_mutually_exclusive_group(required=True)
    how.add_argument("--parent",
                     help="the checkout whose defaults to compare with")
    how.add_argument("--pinned", action="store_true",
                     help="compare with the digests PINNED holds")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("display_sass reads kernels built for a CUDA "
                           "device; none is available")
    mine = functions(library(_ROOT))
    theirs = ({} if args.pinned
              else functions(library(os.path.abspath(args.parent))))
    out, ok = {"defaults": {}, "others": {}, "checked": True}, True
    if args.pinned:
        out["toolkit"] = toolkit()
        out["checked"] = out["toolkit"] == PINNED_TOOLKIT
    for name, sass in sorted(mine.items()):
        m = DEFAULT.search(name)
        if not m:
            out["others"][name] = len(sass)
            continue
        key = f"SH{m.group(1)}-int8-r{m.group(2)}"
        if args.pinned:
            # None: not checked, the digests come from another toolkit
            equal = (PINNED.get(key) == digest(sass) if out["checked"]
                     else None)
            old = None
        else:
            old = next((v for k, v in theirs.items() if DEFAULT.search(k)
                        and DEFAULT.search(k).groups() == m.groups()), None)
            equal = old == sass
        ok &= equal is not False
        out["defaults"][key] = {
            "equal": equal, "instructions": len(sass),
            "parent_instructions": None if old is None else len(old),
            "sha256": digest(sass)}
        if old is not None and not equal:
            # where they part: the differing lines' count and the first few
            diff = [(i, a, b) for i, (a, b) in enumerate(zip(sass, old))
                    if a != b]
            out["defaults"][key]["differing_lines"] = len(diff)
            out["defaults"][key]["first_differences"] = diff[:6]
    ok &= len(out["defaults"]) == 10
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
