"""Shared fixtures of the benchmark's own tests (``pytest benchmark/tests``;
the repository's ``pytest tests/`` does not collect them)."""

from __future__ import annotations

import pytest

# the CPU rehearsal size of every cell: the configurations' stage sizes and
# frames cut so that a run takes seconds on the CPU
TINY_CONFIG = {
    "mapnet-r34-7scenes": {
        "stage_sizes": [1, 1, 1, 1], "feat_dim": 32, "frame": [64, 96],
        "scene": {"sequences": 2, "frames_per_sequence": 60}},
    "mapnet-r34-robotcar-bayer": {
        "stage_sizes": [1, 1, 1, 1], "feat_dim": 32, "raw_frame": [128, 192],
        "frame": [64, 96], "scene": {"sequences": 2, "frames_per_sequence": 40}},
}
TINY_PARAMS = {"checkpoints": 2, "check_frames": 10_000, "warm_requests": 1,
               "check_requests": 10_000}


@pytest.fixture
def card():
    """The CUDA device; skips where there is none (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
