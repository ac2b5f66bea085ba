"""The data-parallel group and the helpers that shard a step over it.

The PyTorch counterpart of :mod:`geomapnet_tpu.parallel.mesh`. A JAX step
over a 1-D ``('data',)`` mesh is one global program: its batch splits over
the devices, BatchNorm takes its statistics over the global (micro)batch
and XLA all-reduces the gradient. Here one process drives one device (a
rank, launched by ``torchrun``), and the same semantics are spelled out
with ``torch.distributed`` collectives: NCCL on the card, gloo on the CPU.

- :class:`DataParallel` (built by :func:`make_mesh`) stands for the mesh:
  world size, rank, device and process group, and the collectives the port
  calls on it (``all_reduce``, ``all_gather_into_tensor``,
  ``reduce_scatter_tensor``, ``broadcast``, and the point-to-point
  :meth:`DataParallel.exchange`). Without a process group it is the
  one-process mesh and every collective is the identity.
- :class:`Grid` (``make_mesh(axis_names=..., shape=...)``) is JAX's
  multi-axis mesh: the ranks arranged row-major into ``shape`` (the
  trailing axis groups adjacent ranks), with one :class:`DataParallel`
  per axis, this rank's sub-group along it. Tensor parallelism, spatial
  sharding and the pipeline (:mod:`.tensor`, :mod:`.pipeline`) run on its
  sub-groups.
- :func:`shard_batch` takes this rank's rows of a global batch;
  :func:`microbatch_rows` says which rows of a global batch a rank holds
  when the step accumulates microbatches (JAX reshapes the GLOBAL batch
  into ``(A, B/A)``, so each rank holds its share of every microbatch).
- :func:`replicated` broadcasts a module's parameters and buffers from
  rank 0, as JAX replicates the train state.
- :func:`shard_step` makes a train step data-parallel: BatchNorm synced
  over the group when it has several ranks (:func:`geomapnet_tpu_torch.
  models.resnet.sync_batch_norm`) and the gradients all-reduced and averaged after the
  local backward, in one flat bucket (:class:`GradientBucket`), before the
  clip and the update. The bucket is a static tensor, so the all-reduce
  can be captured in a CUDA graph (``--steps_per_launch``).

The collectives are called under the names torch 2.11 and 2.13 both have
(``all_gather_into_tensor``, ``reduce_scatter_tensor``). Nothing here
stages a tensor through the host for a backend that refuses it: a refusal
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

__all__ = [
    "DataParallel",
    "Grid",
    "make_mesh",
    "shard_batch",
    "microbatch_rows",
    "replicated",
    "shard_step",
    "GradientBucket",
]


def _dist():
    import torch.distributed as dist

    return dist


@dataclasses.dataclass(frozen=True, eq=False)
class DataParallel:
    """A 1-D data-parallel group: JAX's ``('data',)`` mesh.

    :param world_size: ranks in the group (JAX: devices on the mesh axis)
    :param rank: this process's rank
    :param device: the device this rank computes on
    :param group: the ``torch.distributed`` process group; None is the
        one-process mesh, whose collectives are identities
    """

    world_size: int
    rank: int
    device: torch.device
    group: Any = None

    @property
    def active(self) -> bool:
        """True when a process group exists, even of one rank: the
        collectives then launch (over one rank on a one-card machine)."""
        return self.group is not None

    @property
    def backend(self) -> str | None:
        return None if self.group is None else _dist().get_backend(
            self.group)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        if self.group is not None:
            _dist().all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated on dim 0, in rank order."""
        if self.group is None:
            return t
        t = t.contiguous()
        out = t.new_empty((self.world_size * t.shape[0],)
                          + tuple(t.shape[1:]))
        _dist().all_gather_into_tensor(out, t, group=self.group)
        return out

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks and keep this rank's block of dim 0
        (``t.shape[0] / world_size`` rows, block ``rank``)."""
        if self.group is None:
            return t
        t = t.contiguous()
        out = t.new_empty((t.shape[0] // self.world_size,)
                          + tuple(t.shape[1:]))
        _dist().reduce_scatter_tensor(out, t, group=self.group)
        return out

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` from rank ``src`` on every rank, in place."""
        if self.group is None:
            return t
        if t.is_contiguous():
            _dist().broadcast(t, src, group=self.group)
        else:   # channels_last weights: broadcast a contiguous copy
            tmp = t.contiguous()
            _dist().broadcast(tmp, src, group=self.group)
            t.copy_(tmp)
        return t

    def barrier(self) -> None:
        """Wait for every rank (one small all-reduce on the group's
        device)."""
        if self.group is not None:
            self.all_reduce_(torch.zeros(1, device=self.device))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    @property
    def p2p(self) -> bool:
        """Whether :meth:`exchange` sends point to point: gloo sends only
        host memory, so a gloo group on a card exchanges through an
        all-gather on the card instead."""
        return not (self.backend == "gloo" and self.device.type == "cuda")

    def exchange(self, sends: dict, recvs: dict, numel: int,
                 dtype: torch.dtype = torch.float32) -> None:
        """Send ``sends[q]`` to group rank ``q`` and fill ``recvs[q]`` from
        rank ``q``, for every ``q`` at once. Every rank calls it, with or
        without messages; ``numel`` is the largest message any rank sends
        in this call and ``dtype`` every message's, the same on every
        rank.

        Point to point (``batch_isend_irecv``) where the backend sends the
        tensors' memory; otherwise (:attr:`p2p`) each rank packs its
        messages into ``world_size`` slots of ``numel`` elements, one
        all-gather delivers every slot, and each rank copies out the slots
        addressed to it. Nothing goes through the host."""
        if self.group is None:
            if sends or recvs:
                raise ValueError("a one-process mesh has no peer")
            return
        dist = _dist()
        if self.p2p:
            ops = [dist.P2POp(dist.isend, t.contiguous(),
                              dist.get_global_rank(self.group, q), self.group)
                   for q, t in sends.items()]
            ops += [dist.P2POp(dist.irecv, t,
                               dist.get_global_rank(self.group, q), self.group)
                    for q, t in recvs.items()]
            if ops:
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
            return
        slots = torch.zeros((self.world_size, numel), dtype=dtype,
                            device=self.device)
        for q, t in sends.items():
            slots[q, :t.numel()] = t.reshape(-1)
        every = self.all_gather(slots.reshape(1, -1)).view(
            self.world_size, self.world_size, numel)
        for q, t in recvs.items():
            t.copy_(every[q, self.rank, :t.numel()].view(t.shape))


@dataclasses.dataclass(frozen=True, eq=False)
class Grid:
    """A multi-axis mesh: JAX's ``Mesh(devices.reshape(shape),
    axis_names)`` over ranks, one process per rank.

    :param axis_names: one name per axis, e.g. ``("data", "model")``
    :param sizes: the ranks along each axis
    :param coords: this rank's index along each axis
    :param axes: this rank's sub-group along each axis (the ranks that
        share its other coordinates), in axis order
    :param device: the device this rank computes on
    """

    axis_names: tuple
    sizes: tuple
    coords: tuple
    axes: tuple
    device: torch.device

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as JAX's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    def __getitem__(self, axis: str) -> DataParallel:
        """This rank's sub-group along ``axis``."""
        return self.axes[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        """This rank's index along ``axis`` (its rank in that sub-group)."""
        return self.coords[self.axis_names.index(axis)]


def make_mesh(device: torch.device | str | None = None,
              group: Any = None, axis_names: tuple = ("data",),
              shape: tuple | None = None,
              ranks: Sequence[int] | None = None
              ) -> DataParallel | Grid | None:
    """The data-parallel group of this process: every rank of ``group``
    (default: the whole ``torch.distributed`` world once it is
    initialized, else the one-process mesh).

    With ``axis_names`` other than ``("data",)``, a ``shape`` or ``ranks``,
    a :class:`Grid` instead: ``ranks`` (default: every rank of the world;
    JAX's ``devices``) arranged row-major into ``shape`` (one extent per
    axis, a single -1 inferred; JAX's ``make_mesh(devices, axis_names,
    shape)``). Every rank of the world must make the same call, since every
    sub-group is created on every rank in one order; a rank outside
    ``ranks`` gets None. The sub-groups' communicators are set up before
    it returns (one barrier on each of this rank's sub-groups).

    :param device: where this rank computes (default: the card named by
        ``LOCAL_RANK``; see :func:`geomapnet_tpu_torch.parallel.multihost.
        local_device`)
    """
    from .multihost import local_device

    device = local_device() if device is None else torch.device(device)
    dist = _dist()
    up = dist.is_available() and dist.is_initialized()
    if axis_names == ("data",) and shape is None and ranks is None:
        if up:
            group = dist.group.WORLD if group is None else group
            return DataParallel(dist.get_world_size(group),
                                dist.get_rank(group), device, group)
        return DataParallel(1, 0, device, None)
    axis_names = tuple(axis_names)
    if ranks is None:
        ranks = range(dist.get_world_size() if up else 1)
    ranks = [int(r) for r in ranks]
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError(
                f"mesh with axes {axis_names} needs an explicit shape")
        shape = (-1,)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} does not match axes {axis_names}")
    try:
        grid = np.asarray(ranks).reshape(shape)
    except ValueError:
        raise ValueError(
            f"cannot arrange {len(ranks)} devices into a {shape} "
            f"{axis_names} mesh") from None
    me = dist.get_rank() if up else 0
    where = np.argwhere(grid == me)
    coords = tuple(int(c) for c in where[0]) if len(where) else None
    axes = []
    for a in range(grid.ndim):
        # every line of ranks along axis a, in one order on every rank
        lines = np.moveaxis(grid, a, -1).reshape(-1, grid.shape[a])
        mine = None
        for line in lines:
            line = [int(r) for r in line]
            sub = dist.new_group(line) if up else None
            if me in line:
                mine = DataParallel(len(line), line.index(me), device, sub)
        axes.append(mine)
    if coords is None:
        return None
    for ax in axes:
        ax.barrier()
    return Grid(axis_names, tuple(int(n) for n in grid.shape), coords,
                tuple(axes), device)


def shard_batch(batch: Any, mesh: DataParallel, axis: str = "data") -> Any:
    """This rank's rows of a global batch (an array, a tensor, or a tuple /
    list of them): rows ``[rank * n / W, (rank + 1) * n / W)``.

    Raises a clear error when the batch does not divide over the group."""
    W = mesh.world_size

    def take(x):
        if x.shape[0] % W:
            raise ValueError(
                f"batch dim {x.shape[0]} is not divisible by the {W}-rank "
                f"'{axis}' group; pick a (global) batch size that is a "
                f"multiple of {W}")
        n = x.shape[0] // W
        return x[mesh.rank * n:(mesh.rank + 1) * n]

    if isinstance(batch, (tuple, list)):
        return type(batch)(take(x) for x in batch)
    return take(batch)


def microbatch_rows(rank: int, world: int, batch: int,
                    accum_steps: int = 1) -> np.ndarray:
    """The rows of a ``batch``-row global batch that ``rank`` of ``world``
    holds when a step splits it into ``accum_steps`` microbatches.

    JAX's step reshapes the global batch into ``(accum_steps, batch /
    accum_steps)`` (``geomapnet_tpu/train/state.py:134-136``) and shards
    each microbatch over the mesh, so microbatch ``k`` is global rows
    ``[k * batch / A, (k + 1) * batch / A)`` and rank ``r`` holds the
    ``r``-th of its ``W`` equal parts. The returned rows are microbatch
    major: split them into ``accum_steps`` equal chunks and chunk ``k`` is
    this rank's share of microbatch ``k``. With one microbatch they are
    the rank's own block, ``shard_batch``'s rows.
    """
    if batch % (accum_steps * world):
        raise ValueError(
            f"batch {batch} is not divisible into {accum_steps} "
            f"accumulation microbatches over {world} ranks")
    micro = batch // accum_steps
    share = micro // world
    return (np.arange(accum_steps)[:, None] * micro + rank * share
            + np.arange(share)[None, :]).reshape(-1)


def replicated(module: torch.nn.Module | Sequence[torch.Tensor],
               mesh: DataParallel) -> None:
    """Make every rank hold rank 0's values: a broadcast of the module's
    parameters and buffers (or of the given tensors), in place. JAX places
    the train state replicated over the mesh; a rank-per-process world
    broadcasts it once."""
    if not mesh.active:
        return
    tensors = (list(module.parameters()) + list(module.buffers())
               if isinstance(module, torch.nn.Module) else list(module))
    with torch.no_grad():
        for t in tensors:
            mesh.broadcast_(t.data)


def shard_step(step, mesh: DataParallel):
    """Make a :class:`~geomapnet_tpu_torch.train.state.TrainStep`
    data-parallel over ``mesh``: its model's BatchNorm layers normalize with
    the group's batch statistics, and after the local backward the
    gradients (and the loss) are all-reduced and averaged, before the clip
    and the update. Every rank must feed its share of the same global
    batch (:func:`microbatch_rows`). Returns ``step``.

    Over one rank the local batch is the global one: BatchNorm stays the
    one-device layer (no collective), and only the gradient all-reduce
    launches."""
    from ..models.resnet import sync_batch_norm

    sync_batch_norm(step.model,
                    mesh if mesh.active and mesh.world_size > 1 else None)
    step.mesh = mesh if mesh.active else None
    return step


class GradientBucket:
    """One flat buffer that carries a list of same-dtype tensors through a
    single all-reduce: packed, summed over the ranks, scaled by ``1 / W``
    and copied back. The buffer (and its views) are made on the first call
    and kept, so a CUDA graph that captured the all-reduce replays it on
    the same memory."""

    def __init__(self):
        self.flat: torch.Tensor | None = None
        self._key = None
        self._views: list[torch.Tensor] = []

    def all_reduce_mean_(self, tensors: Sequence[torch.Tensor],
                         mesh: DataParallel) -> None:
        if not tensors or not mesh.active:
            return
        dtypes = {t.dtype for t in tensors}
        if len(dtypes) != 1:
            raise ValueError(f"one bucket holds one dtype, got {dtypes}")
        key = tuple((tuple(t.shape), t.device) for t in tensors)
        if key != self._key:
            n = sum(t.numel() for t in tensors)
            self.flat = torch.empty(n, dtype=tensors[0].dtype,
                                    device=tensors[0].device)
            self._views, o = [], 0
            for t in tensors:
                self._views.append(self.flat[o:o + t.numel()].view(t.shape))
                o += t.numel()
            self._key = key
        torch._foreach_copy_(self._views, list(tensors))
        mesh.all_reduce_(self.flat)
        self.flat.mul_(1.0 / mesh.world_size)
        torch._foreach_copy_(list(tensors), self._views)
