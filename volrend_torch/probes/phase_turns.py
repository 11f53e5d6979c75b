"""Phase 12b of ``chip_smoke.py`` (the training pair's formats at the
training bench's width) for two checkouts in turns: parent, change,
change, parent.

Each turn is a process started in the checkout's root, with that root first
on ``PYTHONPATH``, so that it imports the checkout's own ``chip_smoke.py``
and ``volrend_torch`` and builds and runs its own kernels (the first turn of
a checkout builds them into its ``build/``). The process keeps the phase's
cases named by ``--cases`` (``chip_smoke.TRAIN_CASES``: SG9, with the lean
trainer's bf16 payload, ASG9, RGBA, SG6, the SH9 options), runs
``train_variants_phase`` as the smoke does (each kernel against its plain
version, timed steps, every loss falling; a failure ends the turn), and
prints the kernels line's rows of kernel M's training mode, M-bwd and
the bake kernel at the cases' widths (``MT_*``, ``MB_*``, ``BK_*``: D = 19
for SG6, 4 for RGBA); every case's and payload's M and M-bwd numbers are
read from the phase's log lines (``train <case> kernels [<dtype>]``).
Run on a card from the root of the change's checkout::

    python -m volrend_torch.probes.phase_turns --parent DIR
        [--cases SG9,ASG9,SG6] [--out turns.json]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

from volrend_torch.probes import _common as c

_TURN = r"""
import json, sys
import torch
import chip_smoke as cs
keep = set(sys.argv[1].split(","))
cs.TRAIN_CASES = tuple(t for t in cs.TRAIN_CASES if t[0] in keep)
stats = {}
cs.train_variants_phase(torch, torch.device("cuda"), stats)
rows = {k: v for k, v in stats.items()
        if k.startswith(("MT_", "MB_", "BK_"))}
print("PHASE_ROWS " + json.dumps(rows, default=str), flush=True)
"""


#: the phase's log line of one case's kernels on one payload
_KERNELS = re.compile(r"train (\S+) kernels \[(torch\.\w+)\]: M \(training "
                      r"mode\) (\{.*\}); M-bwd (\{.*\})$")


def turn(root: str, cases: str, log_path: str) -> dict:
    """One turn in the checkout at ``root``: {"rows": the kernels line's
    rows, "cases": {case-dtype: M and M-bwd}}, or raises."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    proc = subprocess.run([sys.executable, "-c", _TURN, cases], cwd=root,
                          env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    with open(log_path, "w") as fh:
        fh.write(proc.stdout)
    rows = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("PHASE_ROWS ")]
    if proc.returncode != 0 or not rows:
        raise RuntimeError(f"phase_turns: the turn in {root} failed (exit "
                           f"{proc.returncode}; its log: {log_path})")
    per = {}
    for ln in proc.stdout.splitlines():
        m = _KERNELS.search(ln)
        if m:
            mt, mb = json.loads(m.group(3)), json.loads(m.group(4))
            per[f"{m.group(1)}-{m.group(2)[6:]}"] = {
                "M_ms": mt["ms"], "M_bound_ms": mt["bound_ms"],
                "Mbwd_ms": mb["ms"], "Mbwd_bound_ms": mb["bound_ms"],
                "Mbwd_rel_l2": mb.get("rel_l2")}
    return {"rows": json.loads(rows[-1][len("PHASE_ROWS "):]), "cases": per}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the parent checkout (unpacked) to run in turns")
    ap.add_argument("--cases", default="SG9,ASG9,SG6",
                    help="phase 12b's cases to run, comma-separated")
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON to this file")
    args = ap.parse_args()
    roots = {"parent": args.parent, "change": c._ROOT}
    out = {"turns": []}
    log_dir = os.path.dirname(os.path.abspath(args.out or "turns.json"))
    for i, tag in enumerate(("parent", "change", "change", "parent")):
        res = turn(roots[tag], args.cases,
                   os.path.join(log_dir, f"phase_turn{i}_{tag}.log"))
        out["turns"].append(dict(res, tag=tag))
        c.log(f"phase_turns {tag}: " + "; ".join(
            f"{k} M {v['M_ms']:.4f} ms, M-bwd {v['Mbwd_ms']:.4f} ms"
            for k, v in sorted(res["cases"].items())) + "; " + "; ".join(
            f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f})"
            for k, v in sorted(res["rows"].items()) if k.startswith("BK_")))
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
