"""Hand-written backward pass of the exact renderer: pixel gradients ->
per-leaf SH/sigma gradients (the counterpart of
``volrend_tpu/ops/grad.py``).

Two paths:

1. ``render_exact.render_rays(..., differentiable=True)``: autograd through
   a fixed-length loop; simple, memory O(steps), the ground truth for the
   fused path.

2. ``render_rays_train`` here: a ``torch.autograd.Function`` whose forward
   is the masked while-march and whose backward *re-marches* the rays with
   O(1) memory per ray, since front-to-back compositing lets suffix sums be
   reconstructed from the forward totals:

       out_c    = sum_i w_i s_ci + bg * T_end,   w_i = T_i (1 - att_i)
       dL/ds_i  = g_c w_i                         (-> SH coeffs via sigmoid')
       dL/dsig_i = dt_i * delta * [ T_i att_i G_i - (Ctot - A_i)
                                    - T_end (bg * sum_c g_c - g_alpha) ]
       with G_i = sum_c g_c s_ci, A_i = prefix sum of w_j G_j (j <= i),
       Ctot = sum_c g_c acc_c — all recomputable in one forward re-march.

   Each sample's gradient row is added into a dense (K, D) f32 buffer with
   ``index_add_`` (the reference's ``.at[leaf_idx].add``).

Training semantics: no early-stop renormalization (rt_core.cuh:181-183 is a
display-only rescale), smooth alpha = 1 - T_end. Early termination at
stop_thresh is kept as an epsilon-sized truncation of the integral.

The march and its re-march are plain PyTorch on the tree's device: no TPU
kernel lies on this path (the reference's is a ``lax.while_loop`` that XLA
compiles).
"""

from __future__ import annotations

import torch

from volrend_torch.models.n3tree import TreeArrays
from volrend_torch.ops.render_exact import (TreeMeta, _dda_world, _march,
                                            _precalc_basis, _sample_step,
                                            any_active, march_counts,
                                            prepare_rays, tree_meta)
from volrend_torch.utils.options import RenderOptions

__all__ = ["render_rays_train", "render_train_vjp", "l2_loss_and_grad"]

_F32 = torch.float32


class _FusedRender(torch.autograd.Function):
    """Primal: the while-march with training semantics, background
    composited; (R, 4) RGBA. Saves only its inputs and its output."""

    @staticmethod
    def forward(ctx, data, child, lut, basis_vals, cen, d, invdir,
                delta_scale, tmin, tmax, meta: TreeMeta,
                opt: RenderOptions):
        rgb, alpha = _march(data, child, lut, meta, opt, cen, d, invdir,
                            delta_scale, basis_vals, tmin, tmax,
                            differentiable=False, train=True)
        rgb = rgb + (float(opt.background_brightness)
                     * (1.0 - alpha))[:, None]
        out = torch.cat([rgb, alpha[:, None]], -1)
        # acc and T_end are recoverable from the output: nothing else
        ctx.save_for_backward(data, child, lut, basis_vals, cen, d, invdir,
                              delta_scale, tmin, tmax, out)
        ctx.meta, ctx.opt = meta, opt
        return out

    @staticmethod
    def backward(ctx, g):
        (data, child, lut, basis_vals, cen, d, invdir, delta_scale, tmin,
         tmax, out) = ctx.saved_tensors
        grad = _fused_bwd(ctx.opt, ctx.meta, data, child, lut, basis_vals,
                          cen, d, invdir, delta_scale, tmin, tmax, out, g)
        return (grad.to(data.dtype),) + (None,) * 11


def _fused_bwd(opt: RenderOptions, meta: TreeMeta, data, child, lut,
               basis_vals, cen, d, invdir, delta_scale, tmin, tmax, out, g):
    """The re-march: (K, D) f32 gradient of ``data`` for the cotangent
    ``g`` (R, 4) of ``out``."""
    Rn = cen.shape[0]
    dev = cen.device
    bg = float(opt.background_brightness)
    g_rgb = g[:, :3].to(_F32)
    g_alpha = g[:, 3].to(_F32)

    light_end = 1.0 - out[:, 3]
    acc = out[:, :3] - bg * light_end[:, None]
    ctot = torch.sum(g_rgb * acc, -1)
    gsum = torch.sum(g_rgb, -1)
    # dL/dT_end: the background enters each channel, alpha = 1 - T_end
    dl_dlight = bg * gsum - g_alpha

    hit = (tmax >= 0) & (tmin <= tmax)
    bd = meta.basis_dim
    t = torch.where(hit, tmin, tmax)
    light = torch.ones(Rn, dtype=_F32, device=dev)
    prefix = torch.zeros(Rn, dtype=_F32, device=dev)
    active = hit & (tmin < tmax)
    grad = torch.zeros(tuple(data.shape), dtype=_F32, device=dev)
    pad = data.shape[1] - (3 * bd if bd >= 0 else 3) - 1

    for i in range(opt.max_steps):
        if not any_active(active, i):
            break
        march_counts["bwd"] += 1
        leaf_idx, sigma, delta_t, rgb_s, _ = _sample_step(
            data, child, lut, meta, opt, cen, d, invdir, basis_vals, t)
        valid = active & (sigma > opt.sigma_thresh)
        dt_ds = delta_t * delta_scale
        att = torch.exp(-dt_ds * sigma)
        weight = light * (1.0 - att)
        G = torch.sum(g_rgb * rgb_s, -1)
        prefix = prefix + torch.where(valid, weight * G, 0.0)

        dsigma = dt_ds * (light * att * G - (ctot - prefix)
                          - light_end * dl_dlight)
        if bd >= 0:
            # d raw_ck = g_c * w_i * s_ci (1 - s_ci); d coeff = d raw * basis_k
            graw = (g_rgb * weight[:, None]) * rgb_s * (1.0 - rgb_s)
            gcoef = (graw[:, :, None] * basis_vals[:, None, :]).reshape(
                Rn, 3 * bd)
        else:
            gcoef = g_rgb * weight[:, None]
        parts = [gcoef, dsigma[:, None]]
        if pad:
            parts.append(torch.zeros((Rn, pad), dtype=_F32, device=dev))
        row = torch.where(valid[:, None], torch.cat(parts, -1), 0.0)
        grad.index_add_(0, leaf_idx.long(), row)

        light = torch.where(valid, light * att, light)
        stopped_now = valid & (light < opt.stop_thresh)
        active = active & ~stopped_now
        t = torch.where(active, t + delta_t, t)
        active = active & (t < tmax)
    return grad


def _check_trainable(tree: TreeArrays, opt: RenderOptions, data) -> None:
    if opt.render_depth:
        raise NotImplementedError("training through depth mode")
    if hasattr(data, "fetch_rows"):
        raise ValueError(
            "a codebook-quantized tree (QuantLeaves) is not trainable: the "
            "trainer optimizes dense leaf rows; densify the tree first")


def render_rays_train(tree: TreeArrays, origins, dirs, opt: RenderOptions,
                      data=None) -> torch.Tensor:
    """Differentiable render with the fused hand-written backward; (R, 4)
    RGBA.

    Gradients flow to ``data`` (per-leaf SH coefficients + sigma) only:
    camera and ray inputs take no gradient. Pass ``data`` explicitly
    (float32 recommended) to differentiate with respect to a master copy;
    defaults to ``tree.data``."""
    if data is None:
        data = tree.data
    _check_trainable(tree, opt, data)
    dev = tree.child.device
    with torch.no_grad():
        origins = torch.as_tensor(origins, device=dev)
        dirs = torch.as_tensor(dirs, device=dev)
        cen, d, vdir, invdir, delta_scale = prepare_rays(tree, origins, dirs,
                                                         opt)
        basis_vals = _precalc_basis(tree, vdir, opt)
        tmin, tmax = _dda_world(cen, invdir, opt.render_bbox)
    return _FusedRender.apply(data, tree.child, tree.lut, basis_vals, cen,
                              d, invdir, delta_scale, tmin, tmax,
                              tree_meta(tree), opt)


def _leaf(data) -> torch.Tensor:
    return data.detach().requires_grad_(True)


def render_train_vjp(tree: TreeArrays, origins, dirs, opt: RenderOptions,
                     g, data=None):
    """Apply the fused backward to an upstream RGBA cotangent ``g``;
    returns (rgba, grad_data)."""
    if data is None:
        data = tree.data
    _check_trainable(tree, opt, data)
    dat = _leaf(data)
    with torch.enable_grad():
        out = render_rays_train(tree, origins, dirs, opt, data=dat)
        (gd,) = torch.autograd.grad(
            out, dat, torch.as_tensor(g, dtype=out.dtype, device=out.device))
    return out.detach(), gd


def l2_loss_and_grad(tree: TreeArrays, origins, dirs, target,
                     opt: RenderOptions, data=None):
    """Mean-squared pixel loss on RGB and its per-leaf gradients; returns
    (loss (0-d tensor on the device), grad_data)."""
    if data is None:
        data = tree.data
    _check_trainable(tree, opt, data)
    dat = _leaf(data)
    with torch.enable_grad():
        out = render_rays_train(tree, origins, dirs, opt, data=dat)
        target = torch.as_tensor(target, device=out.device)
        diff = out[:, :3] - target[:, :3].to(_F32)
        loss = torch.mean(diff * diff)
        (gd,) = torch.autograd.grad(loss, dat)
    return loss.detach(), gd

