"""Leaf-sharded octree: tensor parallelism for trees larger than one
card's memory (the counterpart of ``volrend_tpu/parallel/leaf_shard.py``).

The default mode replicates the tree on every rank. Here the leaf payload
``data[K, D]`` is split row-wise over a mesh axis and every fetch is
resolved collectively:

    every march step:
      1. all-gather the step's leaf indices over the axis   (R_total int32)
      2. each rank looks up the rows it owns, zeros the rest
      3. one reduce-scatter returns each rank its answered rows (R x D)

``ShardedLeaves`` plugs into the renderer through the ``fetch_rows``
interface ``QuantLeaves`` (models/quantized.py) uses, so
``render_exact.render_rays`` runs unchanged; its loop checks for active
rays together over the axis (``sync_group``), since every iteration is a
collective every rank must make. Communication is ~R_total (4 + 4 D)
bytes a step: the mode trades bandwidth for capacity.

Conventions (as ``parallel.dist``): ray batches are this rank's block
(``dist.shard_rays``), a rendered batch comes back gathered to every rank;
the leaf rows and their gradient stay sharded (this rank's block).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from volrend_torch.models.n3tree import TreeArrays
from volrend_torch.ops import grad as grad_mod
from volrend_torch.ops import render_exact
from volrend_torch.parallel.mesh import (Mesh, all_gather, all_reduce,
                                         reduce_scatter)
from volrend_torch.utils.device import to_device
from volrend_torch.utils.options import RenderOptions

__all__ = ["ShardedLeaves", "shard_tree_leaves", "render_rays_leaf_sharded",
           "loss_and_grad_leaf_sharded"]

_F32 = torch.float32


class ShardedLeaves:
    """Row-sharded leaf payloads that resolve fetches with collectives.

    rows: (rows_per_shard, D), this rank's block of the padded rows;
    group: the mesh axis's process group (None for one rank)."""

    def __init__(self, rows: torch.Tensor, group, rows_per_shard: int,
                 n_total: int, data_dim: int):
        self.rows = rows
        self.group = group
        self.rows_per_shard = rows_per_shard
        self.n_total = n_total
        self.data_dim = data_dim
        self.rank = dist.get_rank(group) if group is not None else 0

    @property
    def shape(self):
        return (self.n_total, self.data_dim)

    @property
    def dtype(self):
        return self.rows.dtype

    @property
    def device(self):
        return self.rows.device

    def fetch_rows(self, leaf_idx: torch.Tensor) -> torch.Tensor:
        """The rows ``leaf_idx`` (...,) of the whole table, (..., D) f32:
        one all-gather of every rank's indices, the local lookup, one
        reduce-scatter of the answers."""
        flat = all_gather(leaf_idx.reshape(-1).to(torch.int32),
                          self.group).reshape(-1)
        local = flat.long() - self.rank * self.rows_per_shard
        mine = (local >= 0) & (local < self.rows_per_shard)
        got = self.rows[torch.clamp(local, 0, self.rows_per_shard - 1)]
        got = torch.where(mine[:, None], got.to(_F32), 0.0)
        ans = reduce_scatter(got, self.group)
        return ans.reshape(tuple(leaf_idx.shape) + (self.data_dim,))


def shard_tree_leaves(tree: TreeArrays, mesh: Mesh,
                      axis_name: str = "rays"):
    """The tree on the mesh's device with ``data`` replaced by this rank's
    block of its rows (padded with zero rows to a multiple of the axis's
    size); everything else replicated. Returns (tree, rows_per_shard); use
    with ``render_rays_leaf_sharded``."""
    n = mesh.size(axis_name)
    i = mesh.get_local_rank(axis_name)
    data = tree.data
    k = data.shape[0]
    rps = -(-k // n)
    block = data[i * rps:(i + 1) * rps]
    if block.shape[0] < rps:
        block = torch.cat([block, block.new_zeros(
            (rps - block.shape[0],) + tuple(data.shape[1:]))])
    dev = mesh.device
    rest = {f: getattr(tree, f).to(dev)
            for f in ("child", "offset", "scale", "extra", "lut")}
    return dataclasses.replace(tree, data=block.to(dev), **rest), rps


def render_rays_leaf_sharded(tree: TreeArrays, origins, dirs,
                             opt: RenderOptions, mesh: Mesh,
                             rows_per_shard: int,
                             axis_name: str = "rays") -> torch.Tensor:
    """Forward render with the leaf payload sharded over the mesh axis
    (``shard_tree_leaves``) and the rays sharded the same way (this rank's
    block, ``dist.shard_rays``); child and LUT stay replicated. Returns the
    (R_padded, 4) RGBA of every rank's block on every rank."""
    group = mesh.get_group(axis_name)
    leaves = ShardedLeaves(tree.data, group, rows_per_shard,
                           rows_per_shard * mesh.size(axis_name),
                           tree.data.shape[1])
    out = render_exact.render_rays(dataclasses.replace(tree, data=leaves),
                                   origins, dirs, opt, sync_group=group)
    g = all_gather(out, group)
    return g.reshape(-1, 4)


def loss_and_grad_leaf_sharded(tree: TreeArrays, rows, origins, dirs,
                               target, opt: RenderOptions, mesh: Mesh,
                               axis_name: str = "rays"):
    """Tensor-parallel training step core: the leaf rows sharded at rest,
    gathered for compute, the gradient scattered back (the ZeRO-3 / FSDP
    pattern on the leaf table). One all-gather of the rows up front, the
    fused re-march backward (``ops/grad.py``) on the gathered table, then
    one all-reduce of the loss and one reduce-scatter that hands each rank
    the gradient rows it owns.

    rows: (rows_per_shard, D) f32, this rank's block of the master copy;
    origins/dirs/target: this rank's block of the padded batch. The loss
    is normalized by the global ray count. Returns (loss 0-d tensor, the
    same on every rank; grad (rows_per_shard, D) f32, this rank's block)."""
    group = mesh.get_group(axis_name)
    n_total = int(origins.shape[0]) * mesh.size(axis_name)
    full = all_gather(rows.to(_F32), group).reshape(-1, rows.shape[1])
    dat = full.detach().requires_grad_(True)
    with torch.enable_grad():
        out = grad_mod.render_rays_train(tree, origins, dirs, opt, data=dat)
        tgt = to_device(target, _F32, out.device)
        diff = out[:, :3] - tgt[:, :3]
        loss = torch.sum(diff * diff) / (3.0 * n_total)
        (g,) = torch.autograd.grad(loss, dat)
    loss = all_reduce(loss.detach().reshape(1), group)[0]
    return loss, reduce_scatter(g.to(_F32), group)
