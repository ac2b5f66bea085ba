"""Process-group set-up and the global-batch bookkeeping of a rank.

The PyTorch counterpart of :mod:`geomapnet_tpu.parallel.multihost`. JAX
runs one process over all of a host's devices and ``jax.distributed``
joins the hosts; the port runs one process per card, launched by
``torchrun --nproc_per_node=N`` (which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``), and
:func:`initialize_distributed` joins them with
``torch.distributed.init_process_group``: NCCL for ranks on cards, gloo
on the CPU.

Every rank draws the same seeded permutation and loads a disjoint strided
slice of it (:class:`geomapnet_tpu_torch.data.loader.Loader`'s
``process_index`` / ``process_count``), so the rank-ordered concatenation
of the local batches is the global batch, as in the JAX package.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Any

import numpy as np
import torch

__all__ = [
    "initialize_distributed",
    "is_distributed",
    "process_index",
    "process_count",
    "local_device",
    "local_batch_size",
    "assert_same_across_processes",
    "make_global_batch",
    "global_row_offset",
]

_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _dist():
    import torch.distributed as dist

    return dist


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: torch.device | str | None = None,
    timeout_s: float = 600.0,
) -> tuple[int, int]:
    """Join the process group once; returns (process_index, count).

    With no arguments it reads the launcher's environment (``torchrun``:
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); when that
    is absent it warns and runs single-process. With explicit arguments
    (``coordinator_address`` ``host:port``, ``num_processes``,
    ``process_id``) a failure raises, and so does a failure under a
    launcher: a requested multi-process run must never silently become
    independent runs.

    :param backend: "nccl" (cards) or "gloo" (CPU); default NCCL when a
        card is visible. The choice is the caller's: nothing falls back to
        another backend.
    :param device: the card an NCCL rank uses (default ``LOCAL_RANK``'s,
        or ``process_id``'s with explicit arguments); set as the current
        CUDA device before the group forms
    """
    dist = _dist()
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    explicit = coordinator_address is not None or num_processes is not None
    launched = all(v in os.environ for v in _LAUNCHER_VARS)
    if not explicit and not launched:
        warnings.warn(
            "initialize_distributed(): no coordinator given and no launcher "
            "environment (torchrun's RANK / WORLD_SIZE / MASTER_ADDR / "
            "MASTER_PORT unset); continuing single-process. Launch with "
            "torchrun --nproc_per_node=N to use several cards.")
        return 0, 1
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError(
                "explicit initialize_distributed() needs coordinator_address, "
                "num_processes and process_id")
        world, rank = int(num_processes), int(process_id)
        address = coordinator_address
        init_method = (address if "://" in address else f"tcp://{address}")
        local = rank
    else:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        init_method = "env://"
        local = int(os.environ.get("LOCAL_RANK", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(torch.device("cuda", local)
                              if device is None else torch.device(device))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def is_distributed() -> bool:
    """True when more than one process participates."""
    return process_count() > 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The ranks in the process group (1 without one)."""
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device() -> torch.device:
    """The card this rank runs on: ``cuda:LOCAL_RANK`` (``cuda:0`` outside
    a launcher). Raises when no card is visible; a caller that wants the
    CPU asks for it."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass the CPU device "
                           "explicitly to run there")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def local_batch_size(global_batch: int, mesh=None) -> int:
    """Per-rank share of a global batch: each rank loads ``global_batch /
    count`` samples of every global batch (``count``: the group's ranks)."""
    count = mesh.world_size if mesh is not None else process_count()
    if global_batch % count:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count "
            f"{count}")
    return global_batch // count


def assert_same_across_processes(values, name: str = "values",
                                 mesh=None) -> None:
    """Assert a small host array is identical on every rank.

    Single-process: free. Multi-process: one ``all_gather_object`` per
    call, so call it once per epoch, not per batch. Guards invariants the
    data-parallel math assumes (every rank pads its validation tail
    identically: the weighted validation loss multiplies the local pad by
    the rank count)."""
    group = None if mesh is None else mesh.group
    if mesh is not None and not mesh.active:
        return
    if mesh is None and process_count() == 1:
        return
    dist = _dist()
    local = np.atleast_1d(np.asarray(values))
    gathered = [None] * dist.get_world_size(group)
    dist.all_gather_object(gathered, local, group=group)
    if not all(g.shape == gathered[0].shape and (g == gathered[0]).all()
               for g in gathered):
        raise AssertionError(
            f"multi-host invariant violated: {name} differ across processes "
            f"(process 0 saw {gathered[0]!r}; full gather {gathered!r})")


def make_global_batch(batch: Any, mesh, non_blocking: bool = False):
    """The counterpart of JAX's ``make_global_batch``: there it assembles
    each process's local arrays into one globally sharded array. With one
    rank per process the global batch is never materialized: each rank
    keeps its local shard (moved to its device as tensors; ``mesh`` is a
    :class:`~geomapnet_tpu_torch.parallel.DataParallel` or a device) and the
    global batch is the rank-ordered concatenation of the shards, this
    rank's starting at :func:`global_row_offset`. ``non_blocking`` copies
    to a card through pinned memory without a host sync."""
    device = torch.device(getattr(mesh, "device", mesh))

    def put(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        if non_blocking and device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=non_blocking)

    if isinstance(batch, (tuple, list)):
        return tuple(put(x) for x in batch)
    return put(batch)


def global_row_offset(mesh, local_rows: int) -> int:
    """The row of the global batch at which this rank's ``local_rows``
    start (the ranks' shards concatenate in rank order)."""
    return 0 if mesh is None else mesh.rank * int(local_rows)
