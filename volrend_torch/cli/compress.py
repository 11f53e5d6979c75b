"""Octree compression CLI — ``scripts/compress_octree.py`` flag parity
(the counterpart of ``volrend_tpu/cli/compress.py``; NumPy on the host, see
volrend_torch/compress.py)."""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys

import numpy as np

from volrend_torch.compress import compress_tree


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="compress_octree")
    parser.add_argument("input", type=str, nargs="+", help="Input npz(s)")
    parser.add_argument("--noquant", action="store_true",
                        help="Disable quantization")
    parser.add_argument("--bits", type=int, default=16,
                        help="Quantization bits (order)")
    parser.add_argument("--out_dir", type=str, default="min_alt",
                        help="Where to write compressed npz")
    parser.add_argument("--overwrite", action="store_true",
                        help="Overwrite existing compressed npz")
    parser.add_argument("--weighted", action="store_true",
                        help="Use weighted median cut")
    parser.add_argument("--sigma_thresh", type=float, default=2.0,
                        help="Kill voxels under this sigma")
    parser.add_argument("--retain", type=int, default=1,
                        help="Do not compress first x SH coeffs")
    args = parser.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    print("Quantization disabled, only applying deflate" if args.noquant
          else "Quantization enabled")

    for fname in args.input:
        fname_c = osp.join(args.out_dir, osp.basename(fname))
        print("Compressing", fname, "to", fname_c)
        if not args.overwrite and osp.exists(fname_c):
            print(" > skip")
            continue
        with np.load(fname, allow_pickle=False) as f:
            z = dict(f.items())
        if not args.noquant and "quant_colors" in z:
            print(" > skip since source already compressed")
            continue
        if args.noquant:
            for k in ("parent_depth", "geom_resize_fact", "n_free",
                      "n_internal", "depth_limit"):
                z.pop(k, None)
        else:
            z = compress_tree(z, bits=args.bits,
                              sigma_thresh=args.sigma_thresh,
                              retain=args.retain, weighted=args.weighted)
        np.savez_compressed(fname_c, **z)
        print(" > Size", osp.getsize(fname) // (1024 * 1024), "MB ->",
              osp.getsize(fname_c) // (1024 * 1024), "MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
