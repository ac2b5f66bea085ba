"""The arithmetic of the metrics that read the program's spans
(``metrics/_spans.py`` and the readers of the ``program_span`` metrics) on
hand-built traces (times in us)."""

from __future__ import annotations

import types

import numpy as np
import pytest

from benchmark.core import manifest as mf
from benchmark.core.trace import Trace
from benchmark.metrics import _spans

SPAN_METRICS = ("eval.tree_share", "eval.rows_share", "device.idle.eval.tree",
                "serve.op_host_share")


def _trace(host: list, dev: list, start: float = 0.0,
           end: float = 100.0) -> Trace:
    """``host``: (name, start, end); ``dev``: (start, end)."""
    return Trace(
        dev_name=np.array(["k"] * len(dev), dtype=object),
        dev_start=np.array([d[0] for d in dev], np.float64),
        dev_end=np.array([d[1] for d in dev], np.float64),
        host_name=np.array([h[0] for h in host], dtype=object),
        host_start=np.array([h[1] for h in host], np.float64),
        host_end=np.array([h[2] for h in host], np.float64),
        host_span=np.array([h[0].startswith("bench.") for h in host], bool),
        start=start, end=end)


def _window(trace) -> types.SimpleNamespace:
    return types.SimpleNamespace(trace=trace, record={}, params={},
                                 config={}, chips=1)


def test_overlapping_spans_count_once():
    t = _trace([("gm.a", 0.0, 30.0), ("gm.a", 20.0, 50.0),
                ("gm.a", 70.0, 80.0), ("gm.b", 0.0, 100.0),
                ("aten::mm", 0.0, 100.0)], [])
    assert _spans.covered_s(t, "a") == pytest.approx(60e-6)
    s, e = _spans.intervals(t, "a")
    assert s.tolist() == [0.0, 70.0] and e.tolist() == [50.0, 80.0]
    # the raw events stay as they are
    assert _spans.events(t, "a")[0].tolist() == [0.0, 20.0, 70.0]
    assert _spans.covered_s(t, "missing") == 0.0


def test_device_interval_straddling_a_span_edge():
    # span [10, 40); the device runs [0, 20) and [35, 60): busy 10 + 5
    # inside the span, idle 15 of its 30
    t = _trace([("gm.a", 10.0, 40.0)], [(0.0, 20.0), (35.0, 60.0)])
    assert _spans.device_idle_s(t, "a") == pytest.approx(15e-6)
    assert _spans.overlap_s(_spans.intervals(t, "a"),
                            (t.dev_start, t.dev_end)) == pytest.approx(15e-6)


def test_overlapping_device_streams_count_once_under_a_span():
    # two streams busy at once over [10, 30) of the span [0, 40)
    t = _trace([("gm.a", 0.0, 40.0)], [(10.0, 30.0), (15.0, 25.0)])
    assert _spans.device_idle_s(t, "a") == pytest.approx(20e-6)


def test_span_with_no_device_events():
    t = _trace([("gm.a", 10.0, 40.0), ("gm.a", 20.0, 30.0)], [])
    assert _spans.device_idle_s(t, "a") == pytest.approx(30e-6)
    # device intervals only outside the span leave it all idle
    t = _trace([("gm.a", 10.0, 40.0)], [(0.0, 10.0), (40.0, 90.0)])
    assert _spans.device_idle_s(t, "a") == pytest.approx(30e-6)


@pytest.mark.parametrize("seed", range(5))
def test_idle_under_span_within_its_cover(seed):
    rng = np.random.default_rng(seed)
    hs = rng.uniform(0, 100, 20)
    ds = rng.uniform(0, 100, 200)
    t = _trace([("gm.a", s, s + d) for s, d in
                zip(hs, rng.uniform(0, 20, 20))],
               list(zip(ds, ds + rng.uniform(0, 5, 200))), end=120.0)
    idle = _spans.device_idle_s(t, "a")
    assert -1e-12 <= idle <= _spans.covered_s(t, "a") + 1e-12
    # by brute force on a 1e-3 us grid
    grid = np.arange(0, 120, 1e-3) + 5e-4
    inside = np.zeros(grid.size, bool)
    for s, e in zip(*_spans.events(t, "a")):
        inside |= (grid >= s) & (grid < e)
    busy = np.zeros(grid.size, bool)
    for s, e in zip(t.dev_start, t.dev_end):
        busy |= (grid >= s) & (grid < e)
    assert idle == pytest.approx((inside & ~busy).sum() * 1e-9, abs=1e-9)


def test_readers():
    eval_t = _trace([("bench.eval_call", 0.0, 100.0),
                     ("gm.eval.serving_tree", 0.0, 30.0),
                     ("gm.eval.quantize_rows", 30.0, 40.0)],
                    [(20.0, 35.0)], end=200.0)
    read = {m: mf.metric_reader(m).read for m in SPAN_METRICS}
    assert read["eval.tree_share"](_window(eval_t)) == pytest.approx(15.0)
    assert read["eval.rows_share"](_window(eval_t)) == pytest.approx(5.0)
    # idle under the tree: [0, 20) of its [0, 30)
    assert read["device.idle.eval.tree"](_window(eval_t)) == \
        pytest.approx(10.0)
    serve_t = _trace([("gm.serve.call", 0.0, 4000.0),
                      ("geomapnet::int8_conv", 100.0, 1100.0),
                      ("geomapnet::int8_conv", 500.0, 700.0),
                      ("geomapnet::int8_maxpool3x3s2", 1200.0, 1300.0),
                      ("aten::add", 1300.0, 1400.0),
                      ("gm.serve.call", 5000.0, 7000.0),
                      ("geomapnet::int8_conv", 6000.0, 6500.0)],
                     [], end=8000.0)
    # (1000 + 100 + 500) of 6000 us
    assert read["serve.op_host_share"](_window(serve_t)) == \
        pytest.approx(100.0 * 1600 / 6000)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_readers_none_without_their_span(metric):
    """A program without the span (the parent commit's) or an untraced run
    reads nothing, and nothing raises."""
    read = mf.metric_reader(metric).read
    assert read(_window(None)) is None
    bare = _trace([("bench.eval_call", 0.0, 100.0),
                   ("geomapnet::int8_conv", 10.0, 20.0)], [(0.0, 50.0)])
    assert read(_window(bare)) is None
