"""The training bench's forward bake and coarse occupancy on the card.

On the training bench's pyramid (``make_solid_tree(max_depth=7,
basis_dim=9, seed=7)``, G=256 SH9, f32 levels, as ``FrameTrainer`` holds
them; the scene from the smoke's npz cache), traces the plain forward
bake (``slab_grad.bake_from_pyramid_ref``: the coarse-to-fine expand /
where chain the port ran before the bake kernel) with torch.profiler and
logs its device time by launch. With ``--kernel`` it also traces and
times the bake kernel (``csrc/bake_pyramid.cu``) with and without its
live bits, and the
coarse occupancy in both modes for each of the six view permutations (the
bits mode, ``vt_march_occupancy_live``, equal to the full read of the
bake's sigma, ``vt_march_occupancy``, bit for bit).

Every time is the card's: CUDA events around back-to-back launches queued
behind a device sleep, median of three runs. Run on a card from the root of
the checkout::

    python -m volrend_torch.probes.bake [--kernel] [--out bake.json]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

import torch

from volrend_torch.probes import _common as c
from volrend_torch.probes.display_tiles import device_ms
from volrend_torch.utils.options import RenderOptions

CACHE_TRAIN = os.path.join(c._ROOT, ".torch_bench_train_cache.npz")
SIGMA_THRESH = RenderOptions().sigma_thresh  # the training bench's


def run(dev, kernel: bool) -> dict:
    from volrend_torch import kernels
    from volrend_torch.models.synthetic import make_solid_tree
    from volrend_torch.ops import slab_grad, slab_march
    # every kernel library loaded before the first trace (the kernel's
    # trace below saw no device activity without it)
    for name in kernels.SOURCES:
        kernels.lib(name)
    tree = c.load_tree(CACHE_TRAIN, lambda: make_solid_tree(
        max_depth=7, basis_dim=9, seed=7))
    tdev = tree.to_device(lut_depth=None, device=dev)
    bmap = slab_grad.build_bake_map(tdev)
    pyr = slab_grad.data_to_pyramid(tdev.data.float(), bmap)
    del tdev
    G, D = bmap.G, bmap.D
    c.log(f"bake: G={G} D={D}, level sizes {bmap.sizes}")
    prof = c.profile_run(lambda: slab_grad.bake_from_pyramid_ref(pyr, bmap),
                         "forward bake, plain chain", c.log)
    out = {"G": G, "D": D, "sizes": list(bmap.sizes),
           "plain_ms": device_ms(
               lambda: slab_grad.bake_from_pyramid_ref(pyr, bmap), 5),
           "plain_by_kernel": {k: v[:2] for k, v in prof.items()}}
    if kernel:
        bake, live = slab_grad.bake_from_pyramid(pyr, bmap, SIGMA_THRESH)
        c.profile_run(lambda: slab_grad.bake_from_pyramid(
            pyr, bmap, SIGMA_THRESH), "forward bake, kernel", c.log)
        out["kernel_ms"] = device_ms(
            lambda: slab_grad.bake_from_pyramid(pyr, bmap), 5)
        out["kernel_live_ms"] = device_ms(
            lambda: slab_grad.bake_from_pyramid(pyr, bmap, SIGMA_THRESH), 5)
        prm = torch.full((1, 15), SIGMA_THRESH, device=dev)
        host = prm.cpu()  # the bits mode checks the threshold on the host
        qs = torch.ones(D, device=dev)
        occ = {}
        for perm in itertools.permutations(range(3)):
            view = bake.permute(perm[0], 3, perm[1], perm[2])
            full = slab_march.march_occupancy(view, prm, qs)
            bits = slab_march.march_occupancy(view, host, qs, live=live,
                                              perm=perm)
            if not torch.equal(full, bits):
                raise SystemExit(f"bake: the bits mode differs from the full "
                                 f"read at perm {perm}")
            occ["".join(map(str, perm))] = {
                "full_ms": device_ms(lambda: slab_march.march_occupancy(
                    view, prm, qs), 10),
                "bits_ms": device_ms(lambda: slab_march.march_occupancy(
                    view, host, qs, live=live, perm=perm), 10)}
        out["occupancy"] = occ
    c.log(f"bake: {json.dumps(out)}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", action="store_true",
                    help="also time the bake kernel and both occupancy modes")
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bake: needs a CUDA device")
    out = run(torch.device("cuda"), args.kernel)
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
