"""Training: optimize per-leaf SH/sigma from pixel supervision (the
counterpart of ``volrend_tpu/train.py``).

``Trainer``: ray batches. Pixel L2 loss -> the exact renderer's fused
hand-written backward (``ops/grad.py``: the T2 march and its O(1)-memory
re-march) -> per-leaf gradients -> Adam on a float32 master copy of the
leaf payloads.

``FrameTrainer``: whole frames. Pixel L2 loss -> the differentiable slab
path (``ops/slab_grad``: pyramid bake, kernel M in its training mode, the
backward march kernel, the precise screen warp) -> grid-space (pyramid)
gradients -> Adam on float32 master parameters.

Both run on the trainer's device. Checkpoints are plain npz files with the
reference's keys (``step``, ``data``, ``n_opt_leaves``, ``opt_i``) and leaf
order, so a checkpoint written by either package restores into the other
(``convert.trainer_state_from_numpy``,
``convert.frame_trainer_state_from_numpy``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from volrend_torch.models.n3tree import N3Tree, TreeArrays
from volrend_torch.utils.device import to_device
from volrend_torch.utils.options import RenderOptions

__all__ = ["Trainer", "FrameTrainer", "Adam", "adam", "lean_adam", "psnr",
           "RayShard"]

_F32 = torch.float32


class RayShard(NamedTuple):
    """This rank's block of a ray batch, placed on the mesh's device
    (``Trainer.shard_batch``): origins, dirs, target."""
    origins: torch.Tensor
    dirs: torch.Tensor
    target: torch.Tensor


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


class Trainer:
    """Optimizes a tree's leaf payloads against (rays, rgb) batches through
    the exact renderer's fused backward (``ops/grad.py``).

    ``data`` is an f32 master copy of ``tree.data`` on the tree's device;
    the optimizer is ``adam(lr)`` unless one is given. A codebook-quantized
    tree (``QuantLeaves``) is not trainable (ValueError), as in the
    reference, whose trainer densifies ``tree.data``."""

    def __init__(self, tree: TreeArrays, opt: Optional[RenderOptions] = None,
                 optimizer: Optional[Adam] = None, lr: float = 1e-2):
        if hasattr(tree.data, "fetch_rows"):
            raise ValueError(
                "a codebook-quantized tree (QuantLeaves) is not trainable: "
                "the trainer optimizes dense leaf rows; densify it first")
        self.tree = tree
        self.opt = (opt or RenderOptions()).replace(renormalize=False)
        self.optimizer = optimizer or adam(lr)
        self.data = tree.data.to(_F32, copy=True)
        self.opt_state = self.optimizer.init([self.data])
        self.step_count = 0

    def step(self, origins, dirs, target) -> float:
        """One Adam step on a ray batch ((R, 3) origins and directions,
        (R, >=3) target colours: arrays or tensors); returns the mean RGB
        L2 loss."""
        from volrend_torch.ops import grad as grad_mod
        dev = self.data.device
        origins, dirs, target = (to_device(x, _F32, dev)
                                 for x in (origins, dirs, target))
        loss, g = grad_mod.l2_loss_and_grad(self.tree, origins, dirs, target,
                                            self.opt, data=self.data)
        self.optimizer.step([self.data], [g], self.opt_state)
        self.step_count += 1
        return float(loss)

    def shard_batch(self, mesh, origins, dirs, target) -> RayShard:
        """This rank's block of a whole ray batch on the mesh's device (one
        host-to-device copy); pass it to ``step_sharded`` as ``origins`` to
        skip the per-step copy."""
        from volrend_torch.parallel import dist
        o, d, _ = dist.shard_rays(origins, dirs, mesh)
        t = to_device(dist._block(target, mesh, "rays"), _F32, mesh.device)
        return RayShard(o, d, t)

    def step_sharded(self, mesh, origins, dirs=None, target=None) -> float:
        """One Adam step with the ray batch sharded over ``mesh`` (its
        "rays" axis): each rank marches its block, and one all-reduce sums
        (loss, grad) (``parallel.dist.loss_and_grad_sharded``); the Adam
        state stays replicated, the same on every rank. Takes the whole
        batch (every rank the same arrays; sharded here) or, as
        ``origins``, a ``RayShard`` from ``shard_batch``."""
        from volrend_torch.parallel import dist
        shard = (origins if isinstance(origins, RayShard)
                 else self.shard_batch(mesh, origins, dirs, target))
        loss, g = dist.loss_and_grad_sharded(
            self.tree, self.data, shard.origins, shard.dirs, shard.target,
            self.opt, mesh)
        self.optimizer.step([self.data], [g], self.opt_state)
        self.step_count += 1
        return float(loss)

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

    def _read_checkpoint(self, path: str):
        with np.load(path, allow_pickle=False) as z:
            step = int(z["step"])
            data = np.asarray(z["data"], np.float32)
            n = int(z["n_opt_leaves"])
            leaves = [np.asarray(z[f"opt_{i}"]) for i in range(n)]
        return step, data, leaves

    def restore_checkpoint(self, path: str) -> None:
        """Restore a checkpoint of this trainer or of the reference's
        ``Trainer`` (same keys, same leaf order)."""
        from volrend_torch import convert
        step, data, leaves = self._read_checkpoint(path)
        self.data, self.opt_state = convert.trainer_state_from_numpy(
            data, leaves, self.optimizer, device=self.data.device)
        self.step_count = step


class FrameTrainer(Trainer):
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
        # Trainer.__init__ is not called: the state lives in the pyramid
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

    def step(self, *args, **kw) -> float:
        raise TypeError(
            "FrameTrainer optimizes grid-space (pyramid) parameters and "
            "takes whole-frame supervision (step_frame / "
            "step_frames_sharded); use Trainer for ray-batch training")

    step_sharded = step

    def _group(self, cam):
        from volrend_torch.ops import slab_render
        perm, flip, slope = slab_render.choose_axis(
            self._axis_grid, cam.transform, cam.fx, cam.fy, cam.width,
            cam.height)
        if not np.isfinite(slope):
            raise ValueError("pose not slab-renderable; use Trainer.step")
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

    def step_frame_zsharded(self, mesh, cam, target,
                            axis_name: str = "z") -> float:
        """One Adam step with the march's kernels z-sharded over ``mesh``
        (``slab_grad.render_frame_train_zsharded``): the march's work
        splits over the ranks; each holds the whole bake, its cotangent
        and the Adam state. Segment semantics (stop_thresh = 0). Every rank passes the same
        pose and target; the gradient, and so the parameters and the Adam
        state, come out the same on every rank. Returns the loss."""
        from volrend_torch.ops import slab_grad
        perm, flip = self._group(cam)
        leaves = [p.detach().requires_grad_(True) for p in self.pyramid]
        with torch.enable_grad():
            out = slab_grad.render_frame_train_zsharded(
                tuple(leaves), self.bmap, self.grid, cam.transform,
                float(cam.fx), float(cam.fy), perm, flip, cam.width,
                cam.height, self.opt, mesh, gi=self.gi, axis_name=axis_name,
                grad_bf16=self.lean)
            tgt = to_device(target, _F32, out.device)
            diff = out[..., :3] - tgt[..., :3]
            loss = torch.mean(diff * diff)
            grads = torch.autograd.grad(loss, leaves)
        self.optimizer.step(self.pyramid, grads, self.opt_state)
        del grads
        self.step_count += 1
        return float(loss.detach())

    def place_frames(self, cams, targets) -> torch.Tensor:
        """A pose batch's targets as one (F, H, W, C) f32 tensor on the
        trainer's device, placed ONCE: pass it as ``targets`` to
        ``step_frames_sharded`` on every epoch."""
        dev = self.tree.data.device
        return to_device(np.stack([
            t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t) for t in targets]), _F32, dev)

    def step_frames_sharded(self, mesh, cams, targets,
                            axis_name: str = "frames") -> float:
        """One Adam step on a pose batch sharded over ``mesh``: each rank
        takes its block of the poses through the frame backward, and one
        all-reduce sums (loss, grads) (``slab_grad.
        loss_and_grad_frames_sharded``). All cams share (perm, flip), (fx,
        fy) and (W, H); len(cams) divisible by the axis's size. ``targets``:
        the whole batch (a list of frames, copied here every call) or the
        tensor of ``place_frames``. Returns the loss, the mean over the
        batch."""
        from volrend_torch.ops import slab_grad
        groups = {self._group(c) for c in cams}
        if len(groups) != 1:
            raise ValueError(f"poses span {len(groups)} (perm, flip) "
                             "groups; shard each group separately")
        (perm, flip), = groups
        cam = cams[0]
        if not isinstance(targets, torch.Tensor):
            targets = self.place_frames(cams, targets)
        trs = np.stack([np.asarray(c.transform, np.float32) for c in cams])
        loss, grads = slab_grad.loss_and_grad_frames_sharded(
            self.pyramid, self.bmap, self.grid, trs, float(cam.fx),
            float(cam.fy), perm, flip, cam.width, cam.height, targets,
            self.opt, mesh, gi=self.gi, axis_name=axis_name,
            grad_bf16=self.lean)
        self.optimizer.step(self.pyramid, grads, self.opt_state)
        del grads
        self.step_count += 1
        return float(loss)

    # -- checkpoint / resume -----------------------------------------------------

    def restore_checkpoint(self, path: str) -> None:
        """Restore a checkpoint of this trainer or of the reference's
        ``FrameTrainer`` (same keys, same leaf order)."""
        from volrend_torch import convert
        step, data, leaves = self._read_checkpoint(path)
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
