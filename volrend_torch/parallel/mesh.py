"""The port's device mesh and its collectives (the counterpart of the
reference's ``jax.sharding.Mesh`` and the ``lax`` collectives it uses
inside ``shard_map``).

The reference is single-controller: one process holds every device and
``shard_map`` runs a function per device. The port is SPMD: one process a
rank, every rank making the same calls. ``Mesh`` names the ranks' logical
axes ("rays", "z", "frames", or ("scene", "rays")) and holds one process
group per axis and position; its accessors are ``DeviceMesh``'s
(``size``, ``get_local_rank``, ``get_group``). A one-rank mesh needs no
process group: its collectives return their input.

Each collective picks its call by the group's backend, explicitly:

- NCCL: the single-tensor forms ``all_gather_into_tensor`` and
  ``reduce_scatter_tensor`` (no per-rank copies), and ``all_reduce``;
- gloo (CPU tensors, and CUDA tensors of ranks that share one card, which
  NCCL refuses): the list forms ``all_gather`` and ``reduce_scatter``, and
  ``all_reduce``. Gloo takes CUDA tensors in all of them (torch 2.11 on
  the H100 machine, where the single-tensor forms work too); newer torch
  deprecates the single-tensor forms, so gloo keeps the list ones.

A collective that fails raises; nothing retries another way.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from volrend_torch.utils.device import DeviceLike, resolve

__all__ = ["Mesh", "make_mesh", "all_gather", "all_reduce",
           "reduce_scatter", "any_true", "backend_of", "collective_counts"]

#: collectives issued, by backend and kind (``backend_of`` names the
#: backend; a one-rank group issues none)
collective_counts: Dict[str, int] = {}


class Mesh:
    """A logical mesh of ranks: ``shape`` ranks along the axes
    ``mesh_dim_names``, row-major over ``ranks`` (the world's ranks, in
    order, by default), every rank's tensors on ``device``.

    Every rank of the world builds the same meshes in the same order, as
    ``DeviceMesh`` asks: making a line's process group is a collective call
    of the whole world (a line's group is made once and kept). A rank
    outside ``ranks`` gets a mesh it is not a member of (``member``
    False), whose accessors raise."""

    def __init__(self, shape: Sequence[int], mesh_dim_names: Sequence[str],
                 device: torch.device, ranks: Optional[Sequence[int]] = None):
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(mesh_dim_names)
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.mesh_dim_names} differ in length")
        n = 1
        for s in self.shape:
            n *= s
        world = dist.get_world_size() if dist.is_initialized() else 1
        rank = dist.get_rank() if dist.is_initialized() else 0
        self.ranks = tuple(range(n) if ranks is None else ranks)
        if len(self.ranks) != n or n > world or max(self.ranks) >= world:
            raise ValueError(f"a mesh of shape {self.shape} needs {n} of the "
                             f"world's {world} ranks, got {self.ranks}")
        self.device = device
        self.member = rank in self.ranks
        self._coord = None
        if self.member:
            pos = self.ranks.index(rank)
            coord = []
            for s in reversed(self.shape):
                coord.append(pos % s)
                pos //= s
            self._coord = tuple(reversed(coord))
        self._groups = {}
        for a, name in enumerate(self.mesh_dim_names):
            self._groups[name] = self._axis_group(a)

    def _axis_group(self, a: int):
        """The group of this rank's line along axis ``a`` (every line's is
        made, on every rank): the world's group when the mesh is the
        world's one line, None for a line of one rank otherwise or without
        a process group."""
        if not dist.is_initialized():
            return None
        if len(self.shape) == 1 and len(self.ranks) == dist.get_world_size():
            # the world's line (one rank too: its collectives then run on
            # the world's backend)
            return dist.group.WORLD
        if self.shape[a] == 1:
            return None
        grid = torch.arange(len(self.ranks)).reshape(self.shape)
        mine = None
        others = [range(s) for i, s in enumerate(self.shape) if i != a]
        for idx in itertools.product(*others):
            sel = list(idx)
            sel.insert(a, slice(None))
            line = [self.ranks[int(i)] for i in grid[tuple(sel)].tolist()]
            g = _line_group(line) if len(line) > 1 else None
            if dist.get_rank() in line:
                mine = g
        return mine

    def _axis(self, axis: Optional[str]) -> int:
        if axis is None:
            if len(self.shape) != 1:
                raise ValueError(f"name an axis of {self.mesh_dim_names}")
            return 0
        if axis not in self.mesh_dim_names:
            raise ValueError(f"mesh has no axis {axis!r} "
                             f"({self.mesh_dim_names})")
        if not self.member:
            raise ValueError(f"this rank is not in the mesh {self.ranks}")
        return self.mesh_dim_names.index(axis)

    def size(self, axis: Optional[str] = None) -> int:
        """Ranks along ``axis`` (None: all of the mesh's)."""
        if axis is None:
            return len(self.ranks)
        return self.shape[self._axis(axis)]

    def get_local_rank(self, axis: Optional[str] = None) -> int:
        """This rank's position along ``axis``."""
        return self._coord[self._axis(axis)]

    def get_group(self, axis: Optional[str] = None):
        """The process group of this rank's line along ``axis`` (None: a
        line of one rank, whose collectives are the identity)."""
        return self._groups[self.mesh_dim_names[self._axis(axis)]]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, names={self.mesh_dim_names}, "
                f"device={self.device}, coord={self._coord})")


#: the process groups of the lines made so far, by (world group, ranks)
_LINE_GROUPS: Dict[tuple, object] = {}


def _line_group(line: Sequence[int]):
    """The process group of the ranks ``line``, made once a world by every
    rank of it (``dist.new_group`` is the world's collective call; its
    form with only the line's ranks taking part hangs once the ranks have
    made different groups before)."""
    key = (id(dist.group.WORLD), tuple(line))
    if key not in _LINE_GROUPS:
        _LINE_GROUPS[key] = dist.new_group(list(line))
    return _LINE_GROUPS[key]


def _default_device(device: DeviceLike) -> torch.device:
    """The mesh's device: the named one (a card without an index: the
    current one), else this rank's card (its local rank's under
    ``torchrun``: ``LOCAL_RANK``)."""
    import os
    if device is None and torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                            % torch.cuda.device_count())
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(axis_name="rays", device: DeviceLike = None,
              shape: Optional[Sequence[int]] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the world's ranks (or ``ranks``): a flat 1-D mesh named
    ``axis_name`` by default, or ``shape`` with a tuple of axis names (the
    reference's 2-D ("scene", "rays") mesh). ``device``: the ranks' device,
    the card unless the caller names another (``utils.device.resolve``:
    no drift to the CPU). Without a process group the world is this one
    rank."""
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    if shape is None:
        n = len(ranks) if ranks is not None else (
            dist.get_world_size() if dist.is_initialized() else 1)
        shape = (n,) if len(names) == 1 else None
        if shape is None:
            raise ValueError("a mesh of several axes needs its shape")
    return Mesh(shape, names, _default_device(device), ranks)


def backend_of(group) -> Optional[str]:
    """The backend of ``group`` ("nccl" or "gloo"), None for a one-rank
    axis (no group)."""
    if group is None:
        return None
    return str(dist.get_backend(group)).lower()


def _count(kind: str, be: str) -> None:
    key = f"{be}:{kind}"
    collective_counts[key] = collective_counts.get(key, 0) + 1


def all_gather(t: torch.Tensor, group,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` along the group, in group-rank
    order (the reference's ``lax.all_gather``), gathered into ``out``
    when given (a contiguous (n, *t.shape) tensor; no other copy is
    made)."""
    be = backend_of(group)
    n = 1 if be is None else dist.get_world_size(group)
    shape = (n,) + tuple(t.shape)
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != t.dtype
                            or not out.is_contiguous()):
        raise ValueError(f"all_gather: out must be a contiguous {t.dtype} "
                         f"tensor of shape {shape}")
    if be is None:
        return t[None] if out is None else out.copy_(t[None])
    t = t.contiguous()
    if out is None:
        out = torch.empty(shape, dtype=t.dtype, device=t.device)
    if be == "nccl":
        dist.all_gather_into_tensor(out, t, group=group)
    elif be == "gloo":
        dist.all_gather(list(out.unbind(0)), t, group=group)
    else:
        raise RuntimeError(f"no all_gather for backend {be!r}")
    _count("all_gather", be)
    return out


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the group, in place (the reference's
    ``lax.psum``); returns ``t``."""
    be = backend_of(group)
    if be is None:
        return t
    if be not in ("nccl", "gloo"):
        raise RuntimeError(f"no all_reduce for backend {be!r}")
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    _count("all_reduce", be)
    return t


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of ``t`` (n * k, ...), this rank's block of k
    rows (the reference's ``lax.psum_scatter(..., tiled=True)``)."""
    be = backend_of(group)
    if be is None:
        return t
    n = dist.get_world_size(group)
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split over {n} ranks")
    k = t.shape[0] // n
    t = t.contiguous()
    out = torch.empty((k,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    if be == "nccl":
        dist.reduce_scatter_tensor(out, t, group=group)
    elif be == "gloo":
        dist.reduce_scatter(out, list(t.split(k)), group=group)
    else:
        raise RuntimeError(f"no reduce_scatter for backend {be!r}")
    _count("reduce_scatter", be)
    return out


def any_true(flag: torch.Tensor, group) -> bool:
    """Whether ``flag`` (a bool tensor) holds anywhere on the group: one
    all-reduce of its count, so every rank takes the same branch."""
    n = flag.sum().to(torch.int32).reshape(1)
    return bool(all_reduce(n, group).item() > 0)


def shard_range(n_items: int, n: int, i: int) -> Tuple[int, int]:
    """[lo, hi) of block ``i`` of ``n`` equal blocks of ``n_items``."""
    if n_items % n:
        raise ValueError(f"{n_items} items do not split over {n} ranks")
    k = n_items // n
    return i * k, (i + 1) * k
