"""Share of rank 0's device time (the union of its intervals) spent in
NCCL's kernels: the gradient all-reduce, SyncBatchNorm's all-reduces and
the sharded cache's reduce-scatter."""

KERNELS = ("nccl",)


def read(window):
    if window.trace is None:
        return None
    share = window.trace.share_of_busy(KERNELS)
    return None if share is None else 100.0 * share
