"""Closed-loop serving: one client, no think time, each request one tuple
of ``steps`` uint8 frames taken in trajectory order from the scene, through
the port's serving artifact.

Set-up makes the scene's frames and one MapNet from the seed, exports the
inference function with the export options of the parameters
(``serving.export_inference``: the uint8 normalize fused in front of the
model, calibrated on the scene's first ``calib_batches`` batches of
tuples), loads it on the card (``serving.load_inference``) and sends
``warm_requests`` requests. A request of the window runs from the host's
uint8 tuple (``torch.from_numpy(...).to(card)``) through the artifact to
the poses in host memory (``.cpu()``); its latency is that host clock.

Parameters: ``settle_frames`` (frames spread over the scene on which the
random weights' BatchNorm statistics and translation head are settled),
``export`` (keyword arguments of ``export_inference``), ``calib_batches``, ``warm_requests``, ``check_requests`` (requests of the
window compared with the reference, drawn from the seed).
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
    from geomapnet_tpu_torch.serving import export_inference, load_inference

    cfg, p, dev = run.config, run.params, run.device
    s_weights, s_frames, _, s_check = inputs.seeds(run.seed, 4)
    seqs, per = cfg["scene"]["sequences"], cfg["scene"]["frames_per_sequence"]
    h, w = cfg["frame"]
    frames = inputs.panorama_frames(s_frames, seqs, per, h, w, dev)
    host = frames.cpu().numpy()
    conf = program.experiment_config(cfg, run.seed)
    state = inputs.seeded_states(s_weights, 1, dev, cfg["stage_sizes"],
                                 cfg["feat_dim"])[0]
    inputs.settle_batch_norm([state], frames, p["settle_frames"],
                             cfg["stage_sizes"], cfg["pixel_stats"])
    inputs.settle_translation_head([state], frames, p["settle_frames"],
                                   cfg["stage_sizes"], cfg["pixel_stats"])
    assets = program.asset_root(cfg)
    preprocess = build_device_preprocess(cfg["dataset"], cfg["scene_name"],
                                         assets.name)
    model = program.mapnet(cfg, state, dev)
    B, T = conf.batch_size, conf.steps
    rows = poses.tuple_rows(len(host), T, conf.skip, len(host))
    calib = [preprocess(frames.index_select(0, torch.as_tensor(
        rows[i * B:(i + 1) * B].reshape(-1), device=dev)))
        for i in range(p["calib_batches"])]
    t = time.time()
    blob = export_inference(model, None, frame_shape=(T, h, w, 3),
                            dtype=torch.uint8, preprocess=preprocess,
                            calib_data=calib, **p["export"])
    t_export = time.time() - t
    t = time.time()
    infer = load_inference(blob, dev)
    run.log(f"export {t_export:.3f} s ({len(blob) / 2 ** 20:.1f} MiB), "
            f"load {time.time() - t:.3f} s")
    del model, calib, blob
    assets.cleanup()
    run.state.update(frames=frames, host=host, rows=rows, state=state,
                     infer=infer, check_seed=s_check, conf=conf)
    program.reset_launches()
    for i in range(p["warm_requests"]):
        _request(run, i)
    run.log(f"{p['warm_requests']} warm-up requests, launches "
            f"{program.launches()}")


def _request(run, i: int) -> tuple:
    """Request ``i``: (latency s, host s inside the artifact call, poses)."""
    st = run.state
    x = st["host"][st["rows"][i % len(st["rows"])]][None]
    ta = time.perf_counter()
    xd = torch.from_numpy(x).to(run.device)
    with run.tracer.span("serve_call"):
        tb = time.perf_counter()
        y = st["infer"](xd)
        tc = time.perf_counter()
    out = y.cpu().numpy()
    return time.perf_counter() - ta, tc - tb, out


def window(run, seconds: float) -> dict:
    lat, host, outs = [], [], []
    program.reset_launches()
    t0 = time.time()
    while time.time() - t0 < seconds:
        with run.tracer.span("request"):
            a, b, out = _request(run, len(lat))
        lat.append(a)
        host.append(b)
        outs.append(out[0])
    wall = time.time() - t0
    lat_ms = np.asarray(lat) * 1e3
    run.log(f"{len(lat)} requests in {wall:.3f} s; latency p50 "
            f"{np.percentile(lat_ms, 50):.4f} ms, p95 "
            f"{np.percentile(lat_ms, 95):.4f} ms, max {lat_ms.max():.4f} ms; "
            f"host in the artifact call mean {np.mean(host) * 1e3:.4f} ms; "
            f"launches {program.launches()}")
    failed = sum(not np.isfinite(o).all() for o in outs)
    return {"e2e": {"pose_p95_ms": float(np.percentile(lat_ms, 95))},
            "attempted": len(lat), "failed": int(failed), "outs": outs,
            "latency_s": lat, "host_s": host, "wall_s": wall}


def release(run) -> None:
    run.state.pop("infer", None)
    run.state.pop("host", None)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def _judged(run, record) -> np.ndarray:
    """Requests judged: a sample drawn from the seed, and the last one."""
    n = len(record["outs"])
    rng = np.random.default_rng(run.state["check_seed"])
    m = min(n, run.params["check_requests"])
    return np.unique(np.append(rng.choice(n, m, replace=False), n - 1))


def _want(run, req, quant=None) -> np.ndarray:
    st, cfg = run.state, run.config
    rows = st["rows"][req % len(st["rows"])]
    return poses.frame_poses(st["frames"], rows, st["state"],
                             cfg["stage_sizes"], cfg["pixel_stats"], quant)


def _gaps(got: np.ndarray, want: np.ndarray) -> dict:
    return pose_gaps(got[:, :3], qexp(got[:, 3:]), want[:, :3], want[:, 3:])


def check(run, record) -> dict:
    """``t_gap`` and ``q_gap_deg`` over every frame of the judged
    requests."""
    req = _judged(run, record)
    got = np.concatenate([record["outs"][i] for i in req])
    return _gaps(got, _want(run, req))


def control(run, record, bits: int = 4) -> dict:
    """:func:`check`'s numbers for the reference computed at ``bits``
    (calibrated on the export's calibration frames) in the program's
    place."""
    st, cfg, conf = run.state, run.config, run.state["conf"]
    calib = st["rows"][:run.params["calib_batches"] * conf.batch_size]
    quant = poses.calibrated(st["frames"], calib, st["state"],
                             cfg["stage_sizes"], cfg["pixel_stats"], bits)
    req = _judged(run, record)
    return _gaps(_want(run, req, quant), _want(run, req))
