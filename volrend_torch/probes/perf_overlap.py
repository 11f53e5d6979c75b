"""The payload stream floor against kernel M (the counterpart of
``tools/perf_overlap.py``).

The reference asks how far its march sits above a pure DMA stream of the
same (4, Dp, G, G) window blocks, and sweeps K (slabs per grid step) and
its VMEM limit. Here:

- ``stream_probe`` (``csrc/probe_stream.cu``) reads every byte of each
  window of the (G, Dp, G, G) int8 payload, as the reference's block DMA
  moves it, and folds the bytes into one integer sum per window (the
  consumer that keeps the loads from being dropped); it also returns the
  reference kernel's own (8, 128) output;
- ``main()`` times the stream (ms per launch, GB/s, share of the data
  sheet's 3.35 TB/s), kernel M's K sweep over one pose per launch, and the
  full frame through ``slab_render.render_frames``.

Differences from the reference's sweep: kernel M takes the display path's
options (``dir_win=True`` and ``bbox_full=True``, as
``slab_render._march_finalize`` passes them), since its wrapper refuses the
reference probe's defaults on an int8 payload; and the VMEM-limit axis has
no counterpart (kernel M's shared buffer is fixed at compile time).

    python -m volrend_torch.probes.perf_overlap
"""

from __future__ import annotations

import torch

from volrend_torch import kernels

_F32 = torch.float32
#: the reference's window: 4 slabs per block DMA
WIN = 4
HBM_BYTES_PER_S = 3.35e12


def _windows(pay: torch.Tensor) -> int:
    G = pay.shape[0]
    if pay.dim() != 4 or G % WIN or pay.shape[2] < 8 or pay.shape[3] < 128:
        raise ValueError(f"stream_probe: payload must be (G, Dp, Gy, Gx) "
                         f"with G % {WIN} == 0, Gy >= 8, Gx >= 128; got "
                         f"{tuple(pay.shape)}")
    return G // WIN


def stream_probe(pay: torch.Tensor, ids: torch.Tensor):
    """Stream windows ``ids`` of the (G, Dp, Gy, Gx) int8 payload.

    Returns (out, win_sums): out (8, 128) f32 = sum over i of
    pay[4*ids[i], 0, :8, :128] (the reference's ``dma_once``; sums of int8
    values, exact in f32 in any order), win_sums (n,) int64 = the sum of
    every byte of window ids[i] (the 4 slabs 4*ids[i] .. 4*ids[i]+3).
    Launches ``csrc/probe_stream.cu`` on CUDA tensors (counted in
    ``launches``); runs ``stream_probe_ref`` on CPU tensors."""
    n_win = _windows(pay)
    dev = pay.device
    if dev.type == "cpu":
        return stream_probe_ref(pay, ids)
    if dev.type != "cuda":
        raise RuntimeError(f"stream_probe: no kernel for device {dev}")
    if pay.dtype != torch.int8 or not pay.is_contiguous():
        raise ValueError("stream_probe: the payload must be a contiguous "
                         f"int8 tensor; got {pay.dtype}")
    if (ids.device != dev or ids.dtype != torch.int32 or ids.dim() != 1
            or not ids.is_contiguous() or ids.numel() < 1):
        raise ValueError("stream_probe: ids must be a non-empty contiguous "
                         f"int32 vector on {dev}")
    out = torch.zeros((8, 128), dtype=_F32, device=dev)
    sums = torch.zeros((ids.numel(),), dtype=torch.int64, device=dev)
    _, Dp, Gy, Gx = pay.shape
    lib = kernels.lib("probe_stream")
    kernels.check(lib.vt_probe_stream(
        pay.data_ptr(), ids.data_ptr(), ids.numel(), n_win, WIN * Dp, Gy,
        Gx, out.data_ptr(), sums.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "probe_stream")
    stream_probe.launches += 1
    return out, sums


stream_probe.launches = 0


def stream_probe_ref(pay: torch.Tensor, ids: torch.Tensor):
    """Plain PyTorch version of ``stream_probe`` (exact: integer sums)."""
    n_win = _windows(pay)
    idx = ids.to(device=pay.device, dtype=torch.long)
    out = pay[WIN * idx, 0, :8, :128].to(_F32).sum(0)
    sums = pay.reshape(n_win, -1).index_select(0, idx).sum(
        1, dtype=torch.int64)
    return out, sums


def stream_bytes(pay: torch.Tensor, n: int) -> int:
    """The bytes a stream of ``n`` windows must move: each window read once,
    the ids read and both outputs written."""
    return (n * pay[:WIN].numel() * pay.element_size() + n * 4 + 8 * 128 * 4
            + n * 8)


def march_one_pose(grid, pay, params, zb, perm, flip, gi, slab_ids, k):
    """Kernel M on one pose (params (1, 30), zb (1, 2, gi, gi)) with K = k
    slabs per window: the reference probe's ``march_one``, with the display
    path's options."""
    from volrend_torch.ops import slab_march
    return slab_march.march_slabs(
        pay, params, grid.qscale, zb, grid.G, gi, grid.data_dim,
        grid.basis_dim, perm, slab_ids=slab_ids, sig2=grid.quantized,
        flip=flip, bbox_full=True, dir_win=True, k_per_step=k)


def main():
    from volrend_torch.ops import slab_render
    from volrend_torch.probes import _common as c
    from volrend_torch.utils.options import RenderOptions

    dev = torch.device("cuda")
    W, H, gi = c.W, c.H, c.GI
    grid = c.dense_grid_on(dev)
    opt = RenderOptions(max_steps=1024)
    cams = c.orbit_poses(c.N_ORBIT)
    groups = c.pose_groups(grid, cams)
    (perm, flip), idx = next((k, v) for k, v in groups.items() if 0 in v)
    trs = c.transforms(cams, idx, dev)
    n = len(idx)
    fx, fy = cams[0].fx, cams[0].fy
    c.log(f"setup done; {n} poses; {torch.cuda.get_device_name(0)}")

    pay = slab_render._permuted_grid(grid, perm)
    n_win = grid.G // WIN
    ids = torch.arange(n_win, dtype=torch.int32, device=dev)
    t = c.sync_time(lambda: [stream_probe(pay, ids) for _ in range(n)])
    ms = t / n * 1e3
    gbs = stream_bytes(pay, n_win) / (ms * 1e-3) / 1e9
    c.log(f"pure payload stream: {ms:7.4f} ms/frame ({gbs:6.0f} GB/s, "
          f"{gbs * 1e9 / HBM_BYTES_PER_S:.3f} of 3.35 TB/s)")

    g = slab_render.FrameGeom(grid, trs, fx, fy, perm, flip, W, H, opt, gi)
    params, zb = slab_render._march_frame_fields(grid, g, perm, flip, opt)
    slab_ids = grid.slab_ids(perm[0], flip, opt.sigma_thresh)
    c.log("K sweep with the display path's options (dir_win, bbox_full); "
          "the reference's VMEM-limit axis has no counterpart (kernel M's "
          "shared buffer is fixed at compile time)")
    for k in (1, 2, 4):
        t = c.sync_time(lambda k=k: [
            march_one_pose(grid, pay, params[i:i + 1], zb[i:i + 1], perm,
                           flip, gi, slab_ids, k) for i in range(n)])
        c.log(f"K={k}: {t / n * 1e3:7.3f} ms/frame (kernel M, one pose per "
              f"launch)")

    t = c.sync_time(lambda: slab_render.render_frames(
        grid, trs, fx, fy, perm, flip, W, H, opt, gi))
    c.log(f"full frame (superquad warp): {t / n * 1e3:7.3f} ms/frame "
          f"({n * W * H / t / 1e6:6.1f} Mrays/s)")


if __name__ == "__main__":
    main()
