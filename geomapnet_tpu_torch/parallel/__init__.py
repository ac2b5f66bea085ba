"""Parallelism over ``torch.distributed``: the counterpart of
:mod:`geomapnet_tpu.parallel` (one rank per card, NCCL on cards, gloo on
the CPU). Data parallelism (:mod:`.mesh`, first-class), the multi-axis
grid, tensor parallelism and spatial partitioning (:mod:`.tensor`), GPipe
pipelining (:mod:`.pipeline`) and the process-group helpers
(:mod:`.multihost`)."""

from .mesh import (
    DataParallel,
    GradientBucket,
    Grid,
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
    on_shutdown,
    process_count,
    process_index,
    shutdown_distributed,
)
from .pipeline import (
    StageParamsMeta,
    pack_stage_params,
    pipeline_apply,
    shard_stage_params,
    stage_shapes,
    unpack_stage_params,
)
from .tensor import (
    gather_head,
    head_tp_spec,
    make_spatial_eval_step,
    shard_step_tp,
    spatial_image_sharding,
    tp_state_shardings,
)

__all__ = [
    "DataParallel", "GradientBucket", "Grid", "make_mesh",
    "microbatch_rows", "replicated", "shard_batch", "shard_step",
    "StageParamsMeta", "pack_stage_params", "pipeline_apply",
    "shard_stage_params", "stage_shapes", "unpack_stage_params",
    "gather_head", "head_tp_spec", "make_spatial_eval_step",
    "shard_step_tp", "spatial_image_sharding", "tp_state_shardings",
    "assert_same_across_processes", "global_row_offset",
    "initialize_distributed", "is_distributed", "local_batch_size",
    "local_device", "make_global_batch", "on_shutdown", "process_count",
    "process_index", "shutdown_distributed",
]
