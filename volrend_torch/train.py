"""Training: optimize per-leaf SH/sigma from whole-frame supervision (the
counterpart of ``volrend_tpu/train.py``'s ``FrameTrainer``).

Pixel L2 loss -> the differentiable slab path (``ops/slab_grad``: pyramid
bake, kernel M in its training mode, the backward march kernel, the precise
screen warp) -> grid-space (pyramid) gradients -> Adam on float32 master
parameters, all on the trainer's device.

Checkpoints are plain npz files with the reference's keys (``step``,
``data``, ``n_opt_leaves``, ``opt_i``) and leaf order, so a checkpoint
written by either package restores into the other
(``convert.frame_trainer_state_from_numpy``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from volrend_torch.models.n3tree import N3Tree, TreeArrays
from volrend_torch.utils.options import RenderOptions

__all__ = ["FrameTrainer", "Adam", "adam", "lean_adam", "psnr"]

_F32 = torch.float32
_SLICE_C2 = "ROADMAP.md item 18 (T2 training)"
_SLICE_D = "slice D of the port (ROADMAP.md item 20)"


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam with optax's defaults and arithmetic (``optax.adam``: eps
    outside the square root, bias correction by 1 - b**t), as plain
    functions on lists of tensors.

    ``state_dtype`` None keeps both moments in the parameters' dtype (the
    default optimizer, f32); bf16 is ``lean_adam``: both moments stored in
    bf16, the update math in f32.

    State: ``{"count": int64 0-d tensor, "mu": [...], "nu": [...]}``.
    ``leaves`` / ``from_leaves`` convert it to and from the reference's
    ``jax.tree_util.tree_flatten`` order: (count, mu..., nu...) for
    ``optax.adam``, (m..., v..., t) for ``lean_adam``."""
    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    state_dtype: Optional[torch.dtype] = None

    @property
    def lean(self) -> bool:
        return self.state_dtype is not None

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        dt = self.state_dtype
        return {
            "count": torch.zeros((), dtype=torch.int64,
                                 device=params[0].device),
            "mu": [torch.zeros_like(p, dtype=dt or p.dtype) for p in params],
            "nu": [torch.zeros_like(p, dtype=dt or p.dtype) for p in params],
        }

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor], state: dict) -> None:
        """One update of ``params`` and ``state``, in place (the
        reference returns new arrays; updating in place keeps one copy of
        each G^3-sized tensor). The step count stays on the device, so a
        step needs no host sync."""
        b1, b2 = self.b1, self.b2
        state["count"] += 1
        t = state["count"].to(_F32)
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)
        for p, g, m, v in zip(params, grads, state["mu"], state["nu"]):
            g = g.to(_F32)
            if self.lean:
                mf = b1 * m.to(_F32) + (1.0 - b1) * g
                vf = b2 * v.to(_F32) + (1.0 - b2) * (g * g)
            else:
                mf = m.mul_(b1).add_(g, alpha=1.0 - b1)
                vf = v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = torch.sqrt(vf / c2).add_(self.eps)
            p.addcdiv_(mf / c1, denom, value=-self.lr)
            if self.lean:
                m.copy_(mf)
                v.copy_(vf)

    def leaves(self, state: dict) -> List[torch.Tensor]:
        if self.lean:
            return [*state["mu"], *state["nu"], state["count"]]
        return [state["count"], *state["mu"], *state["nu"]]

    def from_leaves(self, leaves: Sequence[torch.Tensor]) -> dict:
        n = (len(leaves) - 1) // 2
        if len(leaves) != 2 * n + 1:
            raise ValueError(f"{len(leaves)} optimizer leaves: expected "
                             "a count and two moments per parameter")
        if self.lean:
            count, mom = leaves[-1], leaves[:-1]
        else:
            count, mom = leaves[0], leaves[1:]
        dt = self.state_dtype
        return {"count": torch.as_tensor(count).to(torch.int64).reshape(()),
                "mu": [m.to(dt or _F32) for m in mom[:n]],
                "nu": [v.to(dt or _F32) for v in mom[n:]]}


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Adam:
    """The default optimizer: ``optax.adam(lr)``'s update."""
    return Adam(lr, b1, b2, eps)


def lean_adam(lr: float, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, state_dtype=torch.bfloat16) -> Adam:
    """Adam with BOTH moments stored in ``state_dtype`` (bf16 default):
    halves the optimizer state. The update math runs in f32; only the
    carried state rounds."""
    return Adam(lr, b1, b2, eps, state_dtype)


def psnr(a, b) -> float:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else b
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else -10.0 * math.log10(mse)


class FrameTrainer:
    """Trains leaf payloads through the fast slab path (``ops/slab_grad``):
    whole-frame supervision, gradients flowing leaf -> baked grid -> slab
    march -> pixels.

    The trainable state lives in grid space: ``pyramid`` is a list of
    ``nn.Parameter`` levels (``slab_grad.data_to_pyramid``) on the tree's
    device. ``data`` is a (K, dim) view derived on read and converted on
    write, so checkpoints and exports keep the leaf-row format.

    lean=True is the memory mode: bf16 Adam moments (``lean_adam``) and a
    bf16 backward-kernel payload cotangent (a setting of this trainer,
    passed to each step), and the grid keeps its metadata only (its payload
    and sigma plane are dropped: training never reads them).
    """

    def __init__(self, tree: TreeArrays, opt: Optional[RenderOptions] = None,
                 optimizer: Optional[Adam] = None, lr: float = 1e-2,
                 G: Optional[int] = None, gi: int = 512, lean: bool = False):
        from volrend_torch.ops import dense_grid, slab_grad
        if lean and optimizer is None:
            optimizer = lean_adam(lr)
        self.tree = tree
        self.opt = (opt or RenderOptions()).replace(renormalize=False)
        self.optimizer = optimizer or adam(lr)
        self.gi = gi
        self.lean = lean
        self.grid = dense_grid.bake_dense(tree, G=G)
        if lean:
            self.grid = dataclasses.replace(
                self.grid, data=self.grid.data.new_zeros((0,)),
                sigma_grid=None)
        # choose_axis reads the grid's scale on the host: a host copy keeps
        # each step from waiting for the device to read it back
        self._axis_grid = dataclasses.replace(self.grid,
                                              scale=self.grid.scale.cpu())
        self.bmap = slab_grad.build_bake_map(tree, G=G)
        self._K = int(tree.data.shape[0])
        self._dim = int(tree.data.shape[-1])
        self.data = tree.data.to(_F32)
        self.opt_state = self.optimizer.init(self.pyramid)
        self.step_count = 0

    # ``data`` is a derived view over the pyramid ---------------------------

    @property
    def data(self) -> torch.Tensor:
        from volrend_torch.ops import slab_grad
        with torch.no_grad():
            return slab_grad.pyramid_to_data(self.pyramid, self.bmap,
                                             self._K, data_dim=self._dim)

    @data.setter
    def data(self, value) -> None:
        from volrend_torch.ops import slab_grad
        value = torch.as_tensor(value, dtype=_F32,
                                device=self.tree.data.device)
        self.pyramid = [torch.nn.Parameter(p) for p in
                        slab_grad.data_to_pyramid(value, self.bmap)]

    # -- steps -----------------------------------------------------------------

    def step(self, *args, **kw):
        raise NotImplementedError(
            "ray-batch training (Trainer.step) comes with " + _SLICE_C2
            + "; FrameTrainer takes whole frames (step_frame)")

    def step_sharded(self, *args, **kw):
        raise NotImplementedError(
            "ray-batch sharded training comes with " + _SLICE_C2)

    def step_frame_zsharded(self, *args, **kw):
        raise NotImplementedError(
            f"z-sharded frame training comes with {_SLICE_D}")

    def step_frames_sharded(self, *args, **kw):
        raise NotImplementedError(
            f"pose-sharded frame training comes with {_SLICE_D}")

    def _group(self, cam):
        from volrend_torch.ops import slab_render
        perm, flip, slope = slab_render.choose_axis(
            self._axis_grid, cam.transform, cam.fx, cam.fy, cam.width,
            cam.height)
        if not np.isfinite(slope):
            raise ValueError("pose not slab-renderable (ray-batch training "
                             f"comes with {_SLICE_C2})")
        return perm, flip

    def step_frame(self, cam, target, sync: bool = True):
        """One Adam step on a full frame; returns the loss.

        sync=False returns the loss as a device tensor without a host sync,
        so steps enqueue back to back; fetch it (``float()``) to
        synchronize."""
        from volrend_torch.ops import slab_grad
        perm, flip = self._group(cam)
        loss, grads = slab_grad.loss_and_grad_frame(
            self.pyramid, self.bmap, self.grid, cam.transform,
            float(cam.fx), float(cam.fy), perm, flip, cam.width, cam.height,
            target, self.opt, gi=self.gi, grad_bf16=self.lean)
        self.optimizer.step(self.pyramid, grads, self.opt_state)
        del grads
        self.step_count += 1
        return float(loss) if sync else loss

    # -- state export ----------------------------------------------------------

    def current_tree(self) -> TreeArrays:
        """TreeArrays with the optimized payloads (f16, render-ready)."""
        return dataclasses.replace(self.tree,
                                   data=self.data.to(torch.float16))

    def export_npz(self, host_tree: N3Tree, path: str) -> None:
        """Write the optimized scene as a reference-compatible npz."""
        ht = host_tree
        shape = (ht.capacity, ht.N, ht.N, ht.N, ht.data_dim)
        rows = self.data.cpu().numpy().astype(np.float16)[:, :ht.data_dim]
        ht.data = rows.reshape(shape)
        ht.save_npz(path)

    # -- checkpoint / resume -----------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        leaves = self.optimizer.leaves(self.opt_state)
        np.savez(
            path,
            step=np.int64(self.step_count),
            data=self.data.cpu().numpy().astype(np.float32),
            n_opt_leaves=np.int64(len(leaves)),
            **{f"opt_{i}": _leaf_np(leaf) for i, leaf in enumerate(leaves)},
        )

    def restore_checkpoint(self, path: str) -> None:
        """Restore a checkpoint of this trainer or of the reference's
        ``FrameTrainer`` (same keys, same leaf order)."""
        from volrend_torch import convert
        with np.load(path, allow_pickle=False) as z:
            step = int(z["step"])
            data = np.asarray(z["data"], np.float32)
            n = int(z["n_opt_leaves"])
            leaves = [np.asarray(z[f"opt_{i}"]) for i in range(n)]
        self.data = data
        self.pyramid, self.opt_state = \
            convert.frame_trainer_state_from_numpy(
                self.pyramid, leaves, self.optimizer,
                device=self.tree.data.device)
        self.step_count = step


def _leaf_np(t: torch.Tensor) -> np.ndarray:
    """A state leaf as numpy; bf16 moments are widened to f32 (numpy has
    no bf16; the widening is exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(_F32)
    if t.dtype == torch.int64 and t.dim() == 0:
        return np.int32(int(t))
    return t.numpy()
