"""Data parallelism over ``torch.distributed``: the counterpart of
:mod:`geomapnet_tpu.parallel`'s mesh and multi-host helpers (one rank per
card, NCCL on cards, gloo on the CPU). Tensor parallelism and GPipe are
not ported yet (ROADMAP.md, Queue 1)."""

from .mesh import (
    DataParallel,
    GradientBucket,
    make_mesh,
    microbatch_rows,
    replicated,
    shard_batch,
    shard_step,
)
from .multihost import (
    assert_same_across_processes,
    global_row_offset,
    initialize_distributed,
    is_distributed,
    local_batch_size,
    local_device,
    make_global_batch,
    process_count,
    process_index,
)

__all__ = [
    "DataParallel", "GradientBucket", "make_mesh", "microbatch_rows",
    "replicated", "shard_batch", "shard_step",
    "assert_same_across_processes", "global_row_offset",
    "initialize_distributed", "is_distributed", "local_batch_size",
    "local_device", "make_global_batch", "process_count", "process_index",
]
