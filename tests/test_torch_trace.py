"""The port's spans (geomapnet_tpu_torch/utils/trace.py) on the CPU.

- With no profiler recording, ``span`` enters no profiler range and still
  returns its host seconds; the gate is torch's private
  ``torch.autograd.profiler._is_profiler_enabled`` flag, pinned here so
  that a torch that drops it fails loudly.
- Under ``torch.profiler``, the int8 serving ``evaluate()`` (the uint8
  device cache, calibration, quantized heads, fused requant), the loader
  path with PGO, a two-step ``Trainer`` epoch and ``Inference.__call__``
  leave their ``gm.*`` ranges in the Chrome trace, each nested by time in
  its parent (PGO's ``pgo.*`` inside ``eval.pgo``, its ``solves`` counting
  windows and iterations, its window poses returned as the solve's input
  and output), and the numbers the program returns (``images_per_sec``,
  ``upload_secs``, ``pgo_secs``, ``epoch_stats``) are the spans' seconds:
  exactly, on a stepped clock put in the spans' place, whose seconds for a
  span follow from the spans the trace puts inside it.
- On the real clock a span's seconds run inside its range.
"""

import functools
import itertools
import json
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from geomapnet_tpu_torch import serving
from geomapnet_tpu_torch.cli.config import ExperimentConfig
from geomapnet_tpu_torch.cli.eval import evaluate
from geomapnet_tpu_torch.cli.eval_epoch import tuple_index_matrix
from geomapnet_tpu_torch.data.composite import MF
from geomapnet_tpu_torch.data.synthetic import SyntheticScene
from geomapnet_tpu_torch.losses.criterion import MapNetCriterion
from geomapnet_tpu_torch.models.posenet import MapNet, PoseNet
from geomapnet_tpu_torch.models.resnet import ResNet
from geomapnet_tpu_torch.ops import image as port_image
from geomapnet_tpu_torch.train.loop import Trainer
from geomapnet_tpu_torch.utils import trace
from geomapnet_tpu_torch.utils.trace import span
# an autouse fixture: one torch thread while this module runs
from test_torch_train_step import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
H, W = 32, 48
MEAN, STD = (0.5,) * 3, (0.25,) * 3
SERVING = dict(quantize=True, calib_batches=1, quantize_heads=True,
               fuse_requant=True)
# the phases of evaluate(), in order, and the parent of each nested span
EVAL_PHASES = ["eval.tuples", "eval.upload", "eval.serving_tree",
               "eval.quantize_rows", "eval.targets", "eval.epoch",
               "eval.errors"]
EVAL_PARENT = {
    "quant.weights": "eval.serving_tree",
    "quant.tree": "eval.serving_tree",
    "quant.calibrate": "eval.serving_tree",
    "quant.build": "eval.serving_tree",
    "eval.readback": "eval.epoch",
}
# the spans inside eval.pgo, and how many a call of ten iterations opens
PGO_SPANS = {"pgo.linearize": 10, "pgo.solve": 10, "pgo.check": 1}
# the stepped clock's tick
STEP_NS = 1_000_000


def _posenet(seed=0) -> PoseNet:
    torch.manual_seed(seed)
    return PoseNet(ResNet((1, 1, 1, 1)), droprate=0.0, feat_dim=32)


def _profiled(fn, tmp_path):
    """``fn()`` under the CPU profiler: (its result, the trace's program
    ranges as {name: [(start us, end us), ...]})."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e["name"].startswith(trace.PREFIX):
            spans.setdefault(e["name"][len(trace.PREFIX):], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out, spans


def _ops(tmp_path) -> list:
    """(start, end) of the last trace's kernel operator events."""
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X" and e["name"] in (
                "geomapnet::int8_conv", "geomapnet::int8_maxpool3x3s2")]


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.fixture
def stepped_clock(monkeypatch):
    """The spans' clock, advanced by STEP_NS at each read."""
    monkeypatch.setattr(trace, "_clock",
                        functools.partial(next, itertools.count(0, STEP_NS)))


def _stepped(interval, spans) -> float:
    """The seconds of the span whose range is ``interval`` on the stepped
    clock: one tick of its own and two for each span inside it, each of
    which reads the clock at entry and at exit."""
    inner = sum(_inside(iv, interval) for ivs in spans.values()
                for iv in ivs) - 1
    return (1 + 2 * inner) * STEP_NS / 1e9


def _within(seconds: float, interval) -> bool:
    """A span's real-clock ``seconds`` against its range in the trace: the
    span opens its range before it reads the clock and closes it after, so
    the seconds are no more than the range."""
    return seconds <= (interval[1] - interval[0]) / 1e6 + 1e-6


def test_span_off_enters_no_profiler_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert autograd_profiler._is_profiler_enabled is False
    with span("x") as s:
        assert s.seconds == 0.0
        time.sleep(0.01)
    assert 0.01 <= s.seconds < 1.0
    assert s._range is None


def test_gate_flag_flips_under_the_profiler(tmp_path):
    """The private flag the gate reads: False, True while a profiler
    records, False again. The spans' real-clock seconds run inside their
    ranges."""
    assert autograd_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
    assert autograd_profiler._is_profiler_enabled is False
    (outer, inner), spans = _profiled(lambda: _nested(), tmp_path)
    assert _inside(spans["inner"][0], spans["outer"][0])
    assert 0 < inner.seconds <= outer.seconds
    assert _within(outer.seconds, spans["outer"][0])
    assert _within(inner.seconds, spans["inner"][0])


def _nested():
    with span("outer") as outer, span("inner") as inner:
        torch.ones(4).sum()
    return outer, inner


def _scene(n=24, **kw) -> MF:
    return MF(SyntheticScene(n_frames=n, height=H, width=W), steps=3,
              skip=2, **kw)


def _frames(n=24) -> torch.Tensor:
    g = torch.Generator().manual_seed(0)
    return torch.randint(0, 256, (n, H, W, 3), generator=g,
                         dtype=torch.uint8)


def test_int8_evaluate_spans_nest_and_feed_its_clocks(tmp_path,
                                                     stepped_clock):
    ds = _scene()
    model = MapNet(_posenet())
    res, spans = _profiled(lambda: evaluate(
        model, ds, CPU, batch_size=4, device_cache=_frames(),
        preprocess=lambda u: port_image.normalize(u, MEAN, STD),
        progress=False, **SERVING), tmp_path)
    assert set(spans) == set(EVAL_PHASES) | set(EVAL_PARENT)
    assert all(len(v) == 1 for v in spans.values()), spans
    for child, parent in EVAL_PARENT.items():
        assert _inside(spans[child][0], spans[parent][0]), child
        # the parent is the tightest range around it
        around = [n for n, (iv,) in spans.items()
                  if n != child and _inside(spans[child][0], iv)]
        assert min(around, key=lambda n: np.diff(spans[n][0])) == parent
    # the phases follow one another, each inside no other span
    assert all(spans[a][0][1] <= spans[b][0][0]
               for a, b in zip(EVAL_PHASES, EVAL_PHASES[1:]))
    for phase in EVAL_PHASES:
        assert not any(_inside(spans[phase][0], iv)
                       for n, (iv,) in spans.items() if n != phase), phase
    order = ["quant.weights", "quant.tree", "quant.calibrate",
             "quant.build"]
    assert all(spans[a][0][1] <= spans[b][0][0]
               for a, b in zip(order, order[1:]))
    # the returned clocks are the spans' seconds
    secs = {n: _stepped(iv, spans) for n, (iv,) in spans.items()}
    assert secs["eval.epoch"] == 3 * STEP_NS / 1e9   # around eval.readback
    assert res["images_per_sec"] == len(ds) * ds.steps / secs["eval.epoch"]
    assert res["upload_secs"] == (secs["eval.upload"]
                                  + secs["eval.quantize_rows"])
    # the row cache came out and the poses are finite
    assert res["device_frames"].dtype == torch.int8
    assert np.isfinite(res["pred_poses"]).all()


def test_loader_evaluate_with_pgo_spans(tmp_path, stepped_clock):
    ds = _scene(16, include_vos=True)
    res, spans = _profiled(lambda: evaluate(
        MapNet(_posenet()), ds, CPU, batch_size=4, pose_graph=True,
        progress=False), tmp_path)
    assert set(spans) == {"eval.tuples", "eval.epoch", "eval.readback",
                          "eval.pgo", "eval.errors"} | set(PGO_SPANS)
    assert _inside(spans["eval.readback"][0], spans["eval.epoch"][0])
    for name in PGO_SPANS:
        assert all(_inside(iv, spans["eval.pgo"][0]) for iv in spans[name])
    assert spans["eval.tuples"][0][1] <= spans["eval.epoch"][0][0]
    assert spans["eval.epoch"][0][1] <= spans["eval.pgo"][0][0]
    assert spans["eval.pgo"][0][1] <= spans["eval.errors"][0][0]
    assert res["pgo_secs"] == _stepped(spans["eval.pgo"][0], spans)
    assert res["images_per_sec"] == len(ds) * ds.steps / _stepped(
        spans["eval.epoch"][0], spans)
    assert "upload_secs" not in res


def test_pgo_spans_counts_and_window_poses(tmp_path, monkeypatch):
    """A pose-graph eval opens each iteration's ``pgo.linearize`` and then
    ``pgo.solve``, and one ``pgo.check`` after the last, all inside
    ``eval.pgo``; ``solves`` counts the call, its S windows and its ten
    iterations; the returned window poses are the solve's input and
    output, and a run without the pose graph returns neither."""
    from geomapnet_tpu_torch.cli import eval as cli_eval
    from geomapnet_tpu_torch.pgo import pose_graph

    seen = {}
    real = cli_eval.optimize_poses_batch

    def recorded(poses, vos, **kw):
        out = real(poses, vos, **kw)
        seen.update(poses=poses.clone(), vos=vos.clone(), out=out.clone())
        return out

    monkeypatch.setattr(cli_eval, "optimize_poses_batch", recorded)
    ds = _scene(16, include_vos=True)
    S, T = len(ds), ds.steps
    before = dict(pose_graph.solves)
    res, spans = _profiled(lambda: evaluate(
        MapNet(_posenet()), ds, CPU, batch_size=4, pose_graph=True,
        progress=False), tmp_path)
    assert {k: v - before[k] for k, v in pose_graph.solves.items()} == {
        "calls": 1, "windows": S, "iterations": 10}
    assert {n: len(spans[n]) for n in PGO_SPANS} == PGO_SPANS
    (pgo,) = spans["eval.pgo"]
    lin, sol = sorted(spans["pgo.linearize"]), sorted(spans["pgo.solve"])
    (check,) = spans["pgo.check"]
    steps = [iv for pair in zip(lin, sol) for iv in pair] + [check]
    assert all(a[1] <= b[0] for a, b in zip(steps, steps[1:]))
    assert _inside(steps[0], pgo) and _inside(steps[-1], pgo)
    for k in ("pgo_input_poses", "pgo_poses"):
        assert res[k].shape == (S, T, 7) and res[k].dtype == np.float64
    np.testing.assert_array_equal(res["pgo_input_poses"].astype(np.float32),
                                  seen["poses"].numpy())
    np.testing.assert_array_equal(res["pgo_poses"],
                                  seen["out"].double().numpy())
    assert seen["vos"].shape == (S, T - 1, 7)
    # the errors' middle-frame poses come from the solve's output (no pose
    # statistics: translations as they are)
    mid = tuple_index_matrix(ds, True)[:, T // 2]
    np.testing.assert_array_equal(res["pred_poses"][mid],
                                  res["pgo_poses"][:, T // 2])
    plain = evaluate(MapNet(_posenet()), ds, CPU, batch_size=4,
                     progress=False)
    assert not {"pgo_input_poses", "pgo_poses", "pgo_secs"} & set(plain)
    assert pose_graph.solves["calls"] == before["calls"] + 1


def test_trainer_epoch_spans(tmp_path, stepped_clock):
    conf = ExperimentConfig(batch_size=8, seed=7, print_freq=1, opt="adam",
                            lr=1e-6, num_workers=1, do_val=False)
    trainer = Trainer(MapNet(_posenet()), MapNetCriterion(saq=-3.0,
                                                          srq=-3.0),
                      conf, "trace", _scene(16), None,
                      logdir_root=str(tmp_path), device=CPU)
    _, spans = _profiled(lambda: trainer.train_epoch(0), tmp_path)
    (epoch,) = spans["train.epoch"]
    stats = trainer.epoch_stats[-1]
    assert stats["steps"] == 2
    assert len(spans["train.step"]) == len(spans["train.emit"]) == 2
    # one wait per step, and the last one that finds the loader exhausted
    assert len(spans["train.data"]) == 3
    for name in ("train.data", "train.step", "train.emit"):
        assert all(_inside(iv, epoch) for iv in spans[name]), name
    # each step's wait comes before it, and its print point after it
    waits, steps = sorted(spans["train.data"]), sorted(spans["train.step"])
    emits = sorted(spans["train.emit"])
    assert all(w[1] <= s[0] for w, s in zip(waits, steps))
    assert all(s[1] <= e[0] for s, e in zip(steps, emits))
    assert set(spans) == {"train.epoch", "train.data", "train.step",
                          "train.emit"}
    # data_secs: the waits that fed a step; secs: the epoch span
    assert stats["data_secs"] == sum(_stepped(iv, spans) for iv in waits[:2])
    assert stats["secs"] == _stepped(epoch, spans)


def test_inference_call_span(tmp_path):
    x = _frames(3)[None]
    infer = serving.load_inference(serving.export_inference(
        MapNet(_posenet()), None, (3, H, W, 3), dtype=torch.uint8,
        preprocess=lambda u: port_image.normalize(u, MEAN, STD),
        quantize=True, platforms=("cpu",)), "cpu")
    out, spans = _profiled(lambda: infer(x), tmp_path)
    assert out.shape == (1, 3, 6)
    (call,) = spans["serve.call"]
    # the hand kernels' operators run inside the call (what
    # serve.op_host_share reads)
    ops = _ops(tmp_path)
    assert ops and all(_inside(iv, call) for iv in ops)


def test_profile_dir_trace_holds_the_spans(tmp_path):
    """The Trainer's own profiler (``--profile_dir``) records the spans of
    the batches it traces; the epoch's span, open when it stops, is left
    out or cut, and the epoch still runs to its end."""
    conf = ExperimentConfig(batch_size=8, seed=7, print_freq=1, opt="adam",
                            lr=1e-6, num_workers=1, do_val=False)
    trainer = Trainer(MapNet(_posenet()), MapNetCriterion(), conf, "prof",
                      _scene(16), None, logdir_root=str(tmp_path),
                      device=CPU, profile_dir=str(tmp_path / "prof"))
    trainer.train_epoch(0)
    assert trainer.epoch_stats[-1]["steps"] == 2
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())[
        "traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X"]
    assert names.count("gm.train.step") == 2
    assert names.count("gm.train.emit") == 2
    assert autograd_profiler._is_profiler_enabled is False
