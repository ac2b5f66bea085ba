"""A one-rank NCCL group on the card, without JAX.

The card's machine has no JAX, so this file imports none; run it there with

    python -m pytest --noconftest tests/test_torch_dp_card.py -q

One rank (a spawned process, :mod:`dp_ranks`) joins an NCCL group on card
0 and runs every collective the port calls (``all_reduce``,
``reduce_scatter_tensor``, ``all_gather_into_tensor``, ``broadcast``) on
CUDA tensors, the frame-sharded cache's gather (equal to plain indexing),
and three ``KLaunch`` launches of 3 data-parallel train steps of a
ResNet-18 MapNet at 32x48 (the first eager, the second captured in a CUDA
graph with the all-reduce and the sharded gather's collectives, the third
a replay) against the same 9 steps run eagerly: losses and parameters
bit-equal under deterministic cuDNN (the graph replays the eager steps'
kernels). Skips without a card.
"""

import numpy as np
import pytest
import torch

from dp_ranks import run_group


@pytest.mark.cuda
def test_one_rank_nccl_group_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (NCCL)")
    (res,) = run_group("card", 1, backend="nccl", device="cuda:0")
    assert res["backend"] == "nccl"
    assert res["all_reduce"] == list(range(8))
    assert res["reduce_scatter"] == res["all_gather"] == list(range(12))
    assert res["broadcast"] == list(range(8))
    assert res["gather_equal"]
    assert res["replays"] == 2
    assert res["losses"]["graph"] == res["losses"]["eager"]
    assert np.isfinite(res["losses"]["graph"]).all()
    for k, v in res["eager_state"].items():
        np.testing.assert_array_equal(res["graph_state"][k], v, err_msg=k)
