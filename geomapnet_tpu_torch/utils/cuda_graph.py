"""The port's one CUDA-graph capture: the serving rows, a stream's trunk
and recurrence, and the Trainer's K-step launch all record through it."""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["capture"]


def capture(run: Callable, device, *, pool=None, warm_up: bool = True):
    """``(graph, out)``: ``run()`` captured on a side stream of ``device``
    that waits on the current one, after one eager ``run()`` there when
    ``warm_up`` (the allocator, cuBLAS and cuDNN set themselves up lazily,
    which a capture may not), in memory ``pool`` (another graph's
    ``pool()``, or None for its own); the current stream then waits on the
    side stream."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    if warm_up:
        with torch.cuda.stream(side):
            run()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, pool=pool):
        out = run()
    current.wait_stream(side)
    return graph, out
