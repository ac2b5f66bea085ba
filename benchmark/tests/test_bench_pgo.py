"""The MapNet+PGO cell (``7scenes-eval-int8-pgo``) on the CPU: its run at a
rehearsal size, sound and with three faults planted in the program's pose
graph (left out, the VOs of other windows, its inputs rounded to bfloat16),
which the check must catch; the DSO-like poses; and the cell's two span
readers on untraced and hand-built traced windows."""

from __future__ import annotations

import types
from unittest import mock

import numpy as np
import pytest
import torch

from benchmark.core import manifest as mf
from benchmark.core.runner import run_cell
from benchmark.core.trace import Trace
from benchmark.reference import pgo as ref_pgo
from benchmark.tests import test_bench_control

# test_bench_control.py takes every cell but has a window only for the
# drivers that came before this one: the sweep's eight checkpoints, as
# eval_sweep's
test_bench_control.SECONDS.setdefault("eval_sweep_pgo", 8.0)

CELL = "7scenes-eval-int8-pgo"
SEED = 2 ** 31 + 2468     # past 32 signed bits, as a run's seed may be
CONFIG = mf.config("mapnet-pgo-r34-7scenes")
# frames 4 apart, so that a window spans 25 of a 60-frame sequence
TINY_CONFIG = {"stage_sizes": [1, 1, 1, 1], "feat_dim": 32, "frame": [64, 96],
               "scene": {"sequences": 2, "frames_per_sequence": 60},
               "experiment": {**CONFIG["experiment"], "skip": 4}}
TINY_PARAMS = {"checkpoints": 2}


def _no_pgo(real):
    def pgo(poses, vos, **kw):
        return poses.clone()

    return pgo


def _permuted_vos(real):
    def pgo(poses, vos, **kw):
        return real(poses, vos.roll(vos.shape[0] // 2, dims=0), **kw)

    return pgo


def _bf16_inputs(real):
    def pgo(poses, vos, **kw):
        return real(poses.to(torch.bfloat16).float(),
                    vos.to(torch.bfloat16).float(), **kw)

    return pgo


FAULTS = {"no_pgo": _no_pgo, "permuted_vos": _permuted_vos,
          "bf16_inputs": _bf16_inputs}


def _run(fault: str | None) -> dict:
    from geomapnet_tpu_torch.cli import eval as cli_eval

    real = cli_eval.optimize_poses_batch
    planted = real if fault is None else FAULTS[fault](real)
    with mock.patch.object(cli_eval, "optimize_poses_batch", planted):
        return run_cell(CELL, SEED, 0.5, False, device="cpu",
                        params_override=TINY_PARAMS,
                        config_override=TINY_CONFIG)


def test_sound_run_is_correct():
    out = _run(None)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == {"t_gap", "q_gap_deg", "pgo_t_gap",
                                  "pgo_q_gap_deg"}
    assert set(out["metrics"]) == {"eval_images_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(fault):
    out = _run(fault)
    assert out["correct"] is False
    over = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    # the pose graph's own numbers catch each, apart from the int8 trunk
    assert over & {"pgo_t_gap", "pgo_q_gap_deg"}, out["checks"]


def test_dso_poses_drift_from_each_sequence_start():
    from benchmark.traffic import eval_sweep_pgo as drv

    rng = np.random.default_rng(0)
    gt = np.concatenate([rng.normal(size=(40, 3)),
                         0.3 * rng.normal(size=(40, 3))], 1)
    same = drv.dso_poses(1, gt, 2, 0.0, 0.0)
    np.testing.assert_allclose(same, gt, rtol=0, atol=1e-6)
    dso = drv.dso_poses(1, gt, 2, 0.01, 0.001)
    assert dso.shape == gt.shape and dso.dtype == np.float32
    np.testing.assert_array_equal(dso, drv.dso_poses(1, gt, 2, 0.01, 0.001))
    # each sequence starts one step of drift away from the ground truth,
    # and wanders further along it
    err = np.linalg.norm(dso[:, :3] - gt[:, :3], axis=1)
    assert err[0] < 0.05 and err[20] < 0.05
    assert err[1:20].max() > err[0] and err[21:].max() > err[20]
    q = ref_pgo.qexp(torch.from_numpy(dso[:, 3:]).double())
    torch.testing.assert_close(torch.linalg.vector_norm(q, dim=-1),
                               torch.ones(40, dtype=torch.float64))


PGO_METRICS = ("eval.pgo_share", "device.idle.eval.pgo")


def _window(trace):
    return types.SimpleNamespace(trace=trace, record={}, params={},
                                 config=CONFIG, chips=1)


@pytest.mark.parametrize("metric", PGO_METRICS)
def test_readers_return_none_untraced(metric):
    assert mf.metric_reader(metric).read(_window(None)) is None


def _trace(host, dev) -> Trace:
    return Trace(
        dev_name=np.array(["k"] * len(dev), dtype=object),
        dev_start=np.array([d[0] for d in dev], np.float64),
        dev_end=np.array([d[1] for d in dev], np.float64),
        host_name=np.array([h[0] for h in host], dtype=object),
        host_start=np.array([h[1] for h in host], np.float64),
        host_end=np.array([h[2] for h in host], np.float64),
        host_span=np.array([h[0].startswith("bench.") for h in host], bool),
        start=0.0, end=200.0)


def test_readers_on_a_hand_built_trace():
    # window [0, 200) us; two calls, each with an eval.pgo span: [50, 90)
    # and [150, 180); the device runs [40, 60), [70, 75) and [160, 190):
    # PGO covers 70 us, idle in it [60, 70) + [75, 90) + [150, 160) = 35
    tr = _trace([("bench.eval_call", 0.0, 100.0),
                 ("bench.eval_call", 100.0, 200.0),
                 ("gm.eval.pgo", 50.0, 90.0), ("gm.eval.pgo", 150.0, 180.0),
                 ("gm.pgo.solve", 60.0, 80.0), ("gm.eval.epoch", 0.0, 50.0)],
                [(40.0, 60.0), (70.0, 75.0), (160.0, 190.0)])
    read = {m: mf.metric_reader(m).read(_window(tr)) for m in PGO_METRICS}
    assert read["eval.pgo_share"] == pytest.approx(35.0)
    assert read["device.idle.eval.pgo"] == pytest.approx(17.5)
    # a trace with no eval.pgo span (a program without the pose graph)
    # reads nothing
    bare = _trace([("bench.eval_call", 0.0, 200.0)], [(0.0, 10.0)])
    assert all(mf.metric_reader(m).read(_window(bare)) is None
               for m in PGO_METRICS)
