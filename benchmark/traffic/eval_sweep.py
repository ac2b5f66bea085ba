"""Checkpoint sweep: ``evaluate()`` over one scene's test split from the
device frame cache, the checkpoints in turn, as a researcher scores every
saved epoch.

Set-up makes ``checkpoints`` MapNets from the seed and the scene's uint8
frame stack on the card, and warms up with one call. Each call of the
window is the port's ``cli.eval.evaluate`` with the stack as
``device_cache`` and the serving options of the parameters (the serving
tree, calibration, the int8 rows, the dedup epoch, the readback and the
errors). Calls that start inside the window count; the rate is their
tuple-images over the wall from the first call's start to the last one's
return.

Parameters: ``checkpoints``, ``settle_frames`` (frames spread over the
scene on which the random weights' BatchNorm statistics and translation
head are settled),
``eval`` (keyword arguments of ``evaluate``), ``check_frames`` (frames of
each judged call compared with the reference).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.core import inputs, program
from benchmark.reference import poses
from benchmark.reference.compare import pose_gaps, qexp

__all__ = ["setup", "window", "release", "check", "control"]


def setup(run) -> None:
    from geomapnet_tpu_torch.cli.builders import build_device_preprocess
    from geomapnet_tpu_torch.cli.eval import evaluate
    from geomapnet_tpu_torch.data.composite import MF

    cfg, p, dev = run.config, run.params, run.device
    s_weights, s_frames, s_poses, s_check = inputs.seeds(run.seed, 4)
    seqs, per = cfg["scene"]["sequences"], cfg["scene"]["frames_per_sequence"]
    h, w = cfg["frame"]
    frames = inputs.panorama_frames(s_frames, seqs, per, h, w, dev)
    poses = inputs.trajectory_poses(s_poses, seqs * per, seqs)
    conf = program.experiment_config(cfg, run.seed)
    dataset = MF(inputs.Frames(poses), steps=conf.steps, skip=conf.skip,
                 seed=conf.seed)
    states = inputs.seeded_states(s_weights, p["checkpoints"], dev,
                                  cfg["stage_sizes"], cfg["feat_dim"])
    inputs.settle_batch_norm(states, frames, p["settle_frames"],
                             cfg["stage_sizes"], cfg["pixel_stats"])
    inputs.settle_translation_head(states, frames, p["settle_frames"],
                                   cfg["stage_sizes"], cfg["pixel_stats"])
    assets = program.asset_root(cfg)
    preprocess = build_device_preprocess(cfg["dataset"], cfg["scene_name"],
                                         assets.name)
    models = [program.mapnet(cfg, st, dev) for st in states]
    kwargs = dict(p["eval"], batch_size=conf.batch_size,
                  preprocess=preprocess, device_cache=frames, progress=False,
                  num_workers=conf.num_workers)
    t = time.time()
    program.reset_launches()
    warm = evaluate(models[0], dataset, dev, **kwargs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run.log(f"warm-up call {time.time() - t:.3f} s, "
            f"{warm['frames_computed']} frames computed, launches "
            f"{program.launches()}")
    del warm
    run.state.update(frames=frames, dataset=dataset, states=states,
                     models=models, kwargs=kwargs, evaluate=evaluate,
                     assets=assets, check_seed=s_check, conf=conf)


def window(run, seconds: float) -> dict:
    st = run.state
    evaluate, dataset, kwargs = st["evaluate"], st["dataset"], st["kwargs"]
    calls = []
    program.reset_launches()
    t0 = time.time()
    while time.time() - t0 < seconds:
        k = len(calls) % len(st["models"])
        ts = time.time()
        with run.tracer.span("eval_call"):
            res = evaluate(st["models"][k], dataset, run.device, **kwargs)
        te = time.time()
        calls.append(dict(ckpt=k, start=ts, end=te,
                          images_per_sec=res["images_per_sec"],
                          frames_computed=res["frames_computed"],
                          poses=res["pred_poses"]))
        del res
    wall = calls[-1]["end"] - t0
    S, T = len(dataset), dataset.steps
    durations = [c["end"] - c["start"] for c in calls]
    run.log(f"{len(calls)} calls of {S} tuples x {T} frames in {wall:.3f} s;"
            f" per call median {np.median(durations):.4f} s, min "
            f"{min(durations):.4f} s, max {max(durations):.4f} s; epoch "
            f"(the program's images/s clock) median "
            f"{np.median([S * T / c['images_per_sec'] for c in calls]):.4f}"
            f" s; launches {program.launches()}")
    failed = sum(not np.isfinite(c["poses"]).all() for c in calls)
    return {"e2e": {"eval_images_per_s": len(calls) * S * T / wall},
            "attempted": len(calls), "failed": int(failed), "calls": calls,
            "wall_s": wall, "tuples": S, "steps": T,
            "unique_frames": len(dataset.dset),
            "frames_computed": calls[-1]["frames_computed"]}


def release(run) -> None:
    st = run.state
    for k in ("models", "evaluate", "kwargs"):
        st.pop(k, None)
    st["assets"].cleanup()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def _judged(run, record) -> list:
    """The calls judged: each checkpoint's last call of the window, with a
    sample of its frames drawn from the seed."""
    rng = np.random.default_rng(run.state["check_seed"])
    last = {}
    for c in record["calls"]:
        last[c["ckpt"]] = c
    n = len(run.state["dataset"].dset)
    m = min(n, run.params["check_frames"])
    return [(c, np.sort(rng.choice(n, m, replace=False)))
            for _, c in sorted(last.items())]


def _poses(run, state, idx, quant=None) -> np.ndarray:
    cfg = run.config
    return poses.frame_poses(run.state["frames"], idx, state,
                             cfg["stage_sizes"], cfg["pixel_stats"], quant)


def check(run, record) -> dict:
    """The worst ``t_gap`` and ``q_gap_deg`` over the judged calls."""
    worst = {}
    for call, idx in _judged(run, record):
        want = _poses(run, run.state["states"][call["ckpt"]], idx)
        got = call["poses"][idx]
        for k, v in pose_gaps(got[:, :3], got[:, 3:], want[:, :3],
                              want[:, 3:]).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def control(run, record, bits: int = 4) -> dict:
    """The numbers of :func:`check` for the reference computed at ``bits``
    (weights per channel, activations per tensor) in the program's
    place."""
    worst = {}
    for call, idx in _judged(run, record):
        state = run.state["states"][call["ckpt"]]
        conf, cfg = run.state["conf"], run.config
        rows = poses.tuple_rows(
            run.params["eval"]["calib_batches"] * conf.batch_size,
            conf.steps, conf.skip, len(run.state["dataset"].dset))
        quant = poses.calibrated(run.state["frames"], rows, state,
                                 cfg["stage_sizes"], cfg["pixel_stats"], bits)
        got = _poses(run, state, idx, quant)
        want = _poses(run, state, idx)
        for k, v in pose_gaps(got[:, :3], qexp(got[:, 3:]), want[:, :3],
                              want[:, 3:]).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst
