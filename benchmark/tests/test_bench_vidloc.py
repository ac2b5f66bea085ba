"""The streaming cell's yardstick on the CPU: the reference's gate-equation
LSTM against ``torch.nn.LSTM`` in float64; the cell's run at a rehearsal
size, sound and with three faults planted in the program's session (a stale
ring slot, a dropped backward direction, a state carried across windows),
which the check must catch; and the cell's metric readers on untraced and
hand-built traced windows."""

from __future__ import annotations

import contextlib
import types
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.core import manifest as mf
from benchmark.core.runner import run_cell
from benchmark.core.trace import Trace
from benchmark.metrics._stream import stream_request_macs
from benchmark.reference import vidloc as ref
from benchmark.tests import test_bench_control

# test_bench_control.py takes every cell but has a window only for the
# drivers that came before this one: a second at the stream's ~4.4 ms a
# request judges its 64 drawn windows and the last one
test_bench_control.SECONDS.setdefault("closed_loop_stream", 1.0)

CELL = "7scenes-vidloc-stream"
SEED = 2 ** 31 + 4321     # past 32 signed bits, as a run's seed may be
TINY_CONFIG = {"stage_sizes": [1, 1, 1, 1], "hidden_size": 16, "window": 7,
               "frame": [64, 96],
               "scene": {"sequences": 2, "frames_per_sequence": 30}}
TINY_PARAMS = {"warm_requests": 2, "settle_frames": 20,
               "check_requests": 10_000}


def test_gate_equations_equal_nn_lstm_in_float64():
    torch.manual_seed(0)
    lstm = torch.nn.LSTM(12, 8, batch_first=True, bidirectional=True,
                         dtype=torch.float64)
    p = {f"lstm.{k}": v.detach() for k, v in lstm.state_dict().items()}
    x = torch.randn(3, 9, 12, dtype=torch.float64)
    with torch.no_grad():
        want, _ = lstm(x)
    got = ref.recurrence(p, x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    # the backward half reads the future: changing the last frame moves
    # the first frame's backward output and leaves its forward output
    x2 = x.clone()
    x2[:, -1] += 1.0
    got2 = ref.recurrence(p, x2)
    assert torch.equal(got2[:, 0, :8], got[:, 0, :8])
    assert not torch.allclose(got2[:, 0, 8:], got[:, 0, 8:])


def _params(recurrence) -> dict:
    """The loaded window program's weights, by the module's own names."""
    return {k: v.detach() for k, v in
            list(recurrence.named_parameters())
            + list(recurrence.named_buffers())}


def _head(p, fwd, bwd):
    return F.linear(torch.cat([fwd, bwd], dim=-1), p["fc_pose.weight"],
                    p["fc_pose.bias"])


def _stale_slot(real):
    prev = {}

    def recurrence(win):
        out = real(prev.get("win", win))
        prev["win"] = win.clone()
        return out

    return recurrence


def _no_backward(real):
    p = _params(real)

    def recurrence(win):
        fwd, _ = ref.direction(p, win, ref.DIRECTIONS[0])
        return _head(p, fwd, torch.zeros_like(fwd))

    return recurrence


def _carried_state(real):
    p = _params(real)
    carried = {}

    def recurrence(win):
        fwd, carried["state"] = ref.direction(p, win, ref.DIRECTIONS[0],
                                              carried.get("state"))
        bwd, _ = ref.direction(p, win.flip(1), ref.DIRECTIONS[1])
        return _head(p, fwd, bwd.flip(1))

    return recurrence


FAULTS = {"stale_slot": _stale_slot, "no_backward": _no_backward,
          "carried_state": _carried_state}


def _planted(fault: str | None):
    """Every session the program opens runs the faulty recurrence."""
    from geomapnet_tpu_torch import serving

    if fault is None:
        return contextlib.nullcontext()
    real_init = serving.StreamSession.__init__

    def init(self, stream):
        real_init(self, stream)
        self.recurrence = FAULTS[fault](stream.recurrence)

    return mock.patch.object(serving.StreamSession, "__init__", init)


def _run(fault: str | None) -> dict:
    with _planted(fault):
        return run_cell(CELL, SEED, 0.5, False, device="cpu",
                        params_override=TINY_PARAMS,
                        config_override=TINY_CONFIG)


def test_sound_run_is_correct():
    out = _run(None)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"pose_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(fault):
    out = _run(fault)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values()), \
        out["checks"]


# the cell's per-layer readers: its own three, and the serving cells' two
STREAM_METRICS = ("mfu.stream", "stream.rnn_busy_share",
                  "stream.recurrence_idle", "device.idle.serve",
                  "serve.host_ms")


def _window(trace, record=None, config=None):
    return types.SimpleNamespace(
        trace=trace, record=record or {}, params={},
        config=config or mf.config("vidloc-r34-7scenes"), chips=1)


@pytest.mark.parametrize("metric", STREAM_METRICS)
def test_readers_return_none_untraced(metric):
    assert mf.metric_reader(metric).read(_window(None)) is None


def test_readers_on_a_hand_built_trace():
    # window [0, 100) us; the device runs a conv [0, 20), an RNN step
    # [30, 50) and another [60, 70); the host is inside serve.recurrence
    # over [25, 75): idle there [25, 30) + [50, 60) + [70, 75) = 20 us
    tr = Trace(
        dev_name=np.array(["sm80_xmma_fprop_implicit_gemm_f32f32",
                           "gemv2T_kernel_val<int, int, float>",
                           "elemWiseRNNcell<float, float, float>"],
                          dtype=object),
        dev_start=np.array([0.0, 30.0, 60.0]),
        dev_end=np.array([20.0, 50.0, 70.0]),
        host_name=np.array(["bench.request", "gm.serve.recurrence"],
                           dtype=object),
        host_start=np.array([0.0, 25.0]), host_end=np.array([100.0, 75.0]),
        host_span=np.array([True, False]), start=0.0, end=100.0)
    # two requests, 1 ms and 3 ms of host time inside the session's step
    rec = {"host_s": [1e-3, 3e-3]}
    read = {m: mf.metric_reader(m).read(_window(tr, rec))
            for m in STREAM_METRICS}
    assert read["device.idle.serve"] == pytest.approx(50.0)
    assert read["serve.host_ms"] == pytest.approx(2.0)
    assert read["stream.rnn_busy_share"] == pytest.approx(60.0)
    assert read["stream.recurrence_idle"] == pytest.approx(20.0)
    assert read["mfu.stream"] is None          # no requests recorded


def test_mfu_counts_a_request_from_shapes():
    cfg = mf.config("vidloc-r34-7scenes")
    # ResNet-34 at 256x341, the LSTM over 200 frames, fc_pose: ~14.7 GFLOP
    assert 2 * stream_request_macs(cfg) == pytest.approx(14.698e9, rel=1e-3)
    rec = {"attempted": 1000, "wall_s": 10.0}
    got = mf.metric_reader("mfu.stream").read(_window(None, rec, cfg))
    assert got == pytest.approx(100 * 14.698e9 * 100 / 67e12, rel=1e-3)
