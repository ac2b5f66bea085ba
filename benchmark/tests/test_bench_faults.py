"""A run whose timed path is broken underneath must come out not correct.

Each case skips the harness's look for a card and drives the rest of a run
(set-up, window, release, the comparison with the reference) at the CPU
rehearsal size, with one fault of :mod:`benchmark.core.faults` planted in
the measured program: an answer altered where it is produced (the eval
epoch's pose table, the serving artifact's output), translations left at
zero (both), the eval epoch's rows permuted, a train step that
leaves the state unchanged, and one that leaves out half of the batch and
takes the mean over the rest; in the data-parallel cell (four gloo ranks
on the CPU) the ranks leave out the exchange of their gradients."""

from __future__ import annotations

import pytest

from benchmark.core import manifest as mf
from benchmark.core.faults import planted
from benchmark.core.runner import run_cell
from benchmark.tests.conftest import TINY_CONFIG, TINY_PARAMS

SEED = 2 ** 31 + 12345     # past 32 signed bits, as a run's seed may be


def _run(cell: str) -> dict:
    wl = mf.workload(cell)
    params = {k: v for k, v in TINY_PARAMS.items() if k in wl["params"]}
    return run_cell(cell, SEED, 0.5 if wl["chips"] == 1 else 1.0, False,
                    device="cpu",
                    params_override=params,
                    config_override=TINY_CONFIG[wl["config"]])


def _assert_caught(out: dict) -> None:
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values()), \
        out["checks"]


@pytest.mark.parametrize("cell,fault", [
    ("7scenes-eval-int8", "altered_eval"),
    ("7scenes-eval-int8", "zero_t_eval"),
    ("7scenes-eval-int8", "permuted_eval"),
    ("7scenes-serve-tuple", "altered_serve"),
    ("7scenes-serve-tuple", "zero_t_serve"),
    ("robotcar-train-f32", "unchanged"),
    ("robotcar-train-f32", "half_batch"),
    ("robotcar-train-f32-dp4", "no_exchange"),
])
def test_fault_is_caught(cell, fault):
    with planted(fault):
        out = _run(cell)
    _assert_caught(out)
    if fault == "unchanged":
        # a state left unchanged reads 1 by the change's measure, from the
        # seeded state and in the window
        for k in ("change_gap", "win_change_gap"):
            assert out["checks"][k]["value"] == pytest.approx(1.0)
