"""Closed-loop streaming: one client, no think time, each request ONE uint8
frame, taken in trajectory order from the scene (its sequences back to
back, then again from the first), through a VidLoc streaming session of
the port's serving artifact; each response is the poses of the session's
window, the last T frames.

Set-up makes the scene's frames and one VidLoc from the seed
(:func:`seeded_vidloc`), exports it as a streaming artifact with the uint8
normalize fused in front of the trunk (``serving.export_inference(...,
window=T)``), loads it on the card, opens a session primed with the stream's
first T - 1 frames and sends ``warm_requests`` requests, so that every
request of the window has a full window. A request runs from the host's
uint8 frame (``torch.from_numpy(...).to(card)``) through
``StreamSession.step`` to the window's (T, 6) poses in host memory
(``.cpu()``); its latency is that host clock.

Parameters: ``settle_frames`` (frames spread over the scene on which the
trunk's BatchNorm statistics and the LSTM's input scale are settled),
``settle_windows`` (windows of T frames, spread over the scene, on which
``fc_pose`` is settled), ``warm_requests``, ``check_requests`` (windows of
the run compared with the reference, drawn from the seed; the last one is
always compared).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.core import inputs, program
from benchmark.reference import vidloc as ref
from benchmark.reference.compare import pose_gaps, qexp
from benchmark.reference.mapnet import normalize_rgb, trunk

__all__ = ["setup", "window", "release", "check", "control", "seeded_vidloc",
           "window_frames"]

# the spread of each log-quaternion output over the scene, radians
LOGQ_SPREAD = 0.25


def _orthogonal(gen: torch.Generator, n: int, size: int, device
                ) -> torch.Tensor:
    """(n * size, size): ``n`` random orthogonal blocks stacked."""
    z = torch.randn((n, size, size), generator=gen, device=device)
    q, r = torch.linalg.qr(z)
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
    return q.reshape(n * size, size)


def window_frames(positions, window: int, n_frames: int) -> np.ndarray:
    """(len(positions), T) scene frames of the windows that end at stream
    positions ``positions``, oldest first; position ``p`` is frame ``p %
    n_frames``."""
    p = np.asarray(positions, np.int64).reshape(-1, 1)
    return (p + np.arange(1 - window, 1)) % n_frames


def seeded_vidloc(seed: int, frames: torch.Tensor, cfg: dict, settle: int,
                  settle_windows: int) -> dict:
    """A VidLoc state dict (float32, on ``frames``' device) from ``seed``:
    the trunk as :func:`benchmark.core.inputs.seeded_states` draws it, its
    BatchNorm settled on ``settle`` frames spread over ``frames``; the
    LSTM's input kernels at a standard deviation of 1 / (sqrt(F) * the
    settled features' root mean square), so that the gates' pre-activations
    are of unit size; its recurrent kernels orthogonal a gate; biases of
    0.1; ``fc_pose``'s translation rows the three leading principal
    directions of the LSTM's outputs over ``settle_windows`` windows of T
    frames spread over the scene, divided by the first one's spread, and
    its rotation rows random, scaled to a spread of :data:`LOGQ_SPREAD`,
    both centred on those outputs' mean."""
    dev = frames.device
    s_trunk, s_lstm, s_head = inputs.seeds(seed, 3)
    stages, stats = cfg["stage_sizes"], cfg["pixel_stats"]
    hidden, feat, T = cfg["hidden_size"], cfg["features"], cfg["window"]
    st = inputs.seeded_states(s_trunk, 1, dev, stages, 6)[0]
    st = {k: v for k, v in st.items() if k.startswith("feature_extractor.")}
    inputs.settle_batch_norm([st], frames, settle, stages, stats)
    idx = torch.linspace(0, len(frames) - 1, settle, device=dev)
    x = normalize_rgb(frames.index_select(0, idx.round().long()),
                      list(stats[0]), list(np.sqrt(stats[1])))
    with torch.no_grad():
        f = trunk(st, x, stages)
    rms = float(f.pow(2).mean().sqrt())
    gen = torch.Generator(device=dev)
    gen.manual_seed(s_lstm)
    for sfx in ref.DIRECTIONS:
        st[f"lstm.weight_ih_{sfx}"] = torch.randn(
            (4 * hidden, feat), generator=gen, device=dev) / (
                math.sqrt(feat) * rms)
        st[f"lstm.weight_hh_{sfx}"] = _orthogonal(gen, 4, hidden, dev)
        for b in ("ih", "hh"):
            st[f"lstm.bias_{b}_{sfx}"] = 0.1 * torch.randn(
                4 * hidden, generator=gen, device=dev)
    starts = np.linspace(0, len(frames) - T, settle_windows).round()
    wins = starts.astype(np.int64)[:, None] + np.arange(T)
    with torch.no_grad():
        feats = ref.frame_features(frames, np.unique(wins), st, stages, stats)
        pos = np.searchsorted(np.unique(wins), wins)
        h = ref.recurrence(st, feats[torch.as_tensor(pos, device=dev)])
    h = h.reshape(-1, 2 * hidden).double()
    mu = h.mean(0)
    _, sv, vh = torch.linalg.svd(h - mu, full_matrices=False)
    w_t = vh[:3] * (math.sqrt(len(h)) / sv[0].clamp_min(1e-12))
    gen.manual_seed(s_head)
    w_q = torch.randn((3, 2 * hidden), generator=gen, device=dev).double()
    w_q *= LOGQ_SPREAD / ((h - mu) @ w_q.t()).std(0)[:, None]
    w = torch.cat([w_t, w_q])
    st["fc_pose.weight"] = w.float()
    st["fc_pose.bias"] = (-(w @ mu)).float()
    return st


def _vidloc(cfg: dict, state: dict, device):
    """The port's VidLoc of the configuration with ``state`` loaded."""
    from geomapnet_tpu_torch.models.resnet import ResNet
    from geomapnet_tpu_torch.models.vidloc import VidLoc

    with torch.device(device):
        model = VidLoc(ResNet(tuple(cfg["stage_sizes"])),
                       hidden_size=cfg["hidden_size"],
                       bidirectional=cfg["bidirectional"])
    model.load_state_dict(state)
    return model.eval()


def setup(run) -> None:
    # the streaming session is what the cell measures: a program without
    # one stops here, before any work
    from geomapnet_tpu_torch.serving import (
        Stream,
        export_inference,
        load_inference,
    )
    from geomapnet_tpu_torch.cli.builders import build_device_preprocess

    cfg, p, dev = run.config, run.params, run.device
    s_weights, s_frames, s_check = inputs.seeds(run.seed, 3)
    seqs, per = cfg["scene"]["sequences"], cfg["scene"]["frames_per_sequence"]
    h, w = cfg["frame"]
    T = cfg["window"]
    frames = inputs.panorama_frames(s_frames, seqs, per, h, w, dev)
    host = frames.cpu().numpy()
    state = seeded_vidloc(s_weights, frames, cfg, p["settle_frames"],
                          p["settle_windows"])
    assets = program.asset_root(cfg)
    preprocess = build_device_preprocess(cfg["dataset"], cfg["scene_name"],
                                         assets.name)
    model = _vidloc(cfg, state, dev)
    t = time.time()
    blob = export_inference(model, None, frame_shape=(h, w, 3),
                            dtype=torch.uint8, preprocess=preprocess,
                            window=T)
    t_export = time.time() - t
    t = time.time()
    stream = load_inference(blob, dev)
    if not isinstance(stream, Stream):
        raise TypeError(f"a VidLoc export loaded as {type(stream).__name__}, "
                        f"not a Stream")
    session = stream.session()
    run.log(f"export {t_export:.3f} s ({len(blob) / 2 ** 20:.1f} MiB), "
            f"load {time.time() - t:.3f} s")
    del model, blob
    assets.cleanup()
    first = torch.from_numpy(host[window_frames([T - 2], T - 1, len(host))[0]])
    session.open(first.to(dev))
    run.state.update(frames=frames, host=host, state=state, session=session,
                     check_seed=s_check, position=T - 1)
    for _ in range(p["warm_requests"]):
        _request(run)
    run.log(f"{p['warm_requests']} warm-up requests; the window starts at "
            f"stream position {run.state['position']}")


def _request(run) -> tuple:
    """The next frame of the stream: (latency s, host s inside the
    session's step, the window's poses, the frame's stream position)."""
    st = run.state
    pos = st["position"]
    x = st["host"][pos % len(st["host"])]
    ta = time.perf_counter()
    xd = torch.from_numpy(x).to(run.device)
    with run.tracer.span("serve_step"):
        tb = time.perf_counter()
        y = st["session"].step(xd)
        tc = time.perf_counter()
    out = y.cpu().numpy()
    st["position"] = pos + 1
    return time.perf_counter() - ta, tc - tb, out, pos


def window(run, seconds: float) -> dict:
    lat, host, outs, positions = [], [], [], []
    t0 = time.time()
    while time.time() - t0 < seconds:
        with run.tracer.span("request"):
            a, b, out, pos = _request(run)
        lat.append(a)
        host.append(b)
        outs.append(out)
        positions.append(pos)
    wall = time.time() - t0
    lat_ms = np.asarray(lat) * 1e3
    run.log(f"{len(lat)} requests in {wall:.3f} s; latency p50 "
            f"{np.percentile(lat_ms, 50):.4f} ms, p95 "
            f"{np.percentile(lat_ms, 95):.4f} ms, max {lat_ms.max():.4f} ms; "
            f"host in the session's step mean {np.mean(host) * 1e3:.4f} ms")
    T = run.config["window"]
    failed = sum(o.shape != (T, 6) or not np.isfinite(o).all() for o in outs)
    return {"e2e": {"pose_p95_ms": float(np.percentile(lat_ms, 95))},
            "attempted": len(lat), "failed": int(failed), "outs": outs,
            "positions": positions, "latency_s": lat, "host_s": host,
            "wall_s": wall}


def release(run) -> None:
    run.state.pop("session", None)
    run.state.pop("host", None)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def _judged(run, record) -> np.ndarray:
    """Requests judged: a sample drawn from the seed, and the last one."""
    n = len(record["outs"])
    rng = np.random.default_rng(run.state["check_seed"])
    m = min(n, run.params["check_requests"])
    return np.unique(np.append(rng.choice(n, m, replace=False), n - 1))


def _want(run, positions, tf32: bool = False) -> np.ndarray:
    """(len(positions), T, 6) reference poses of the windows that end at
    the stream ``positions``: the trunk once over the union of their
    frames, then the recurrence over every window."""
    st, cfg = run.state, run.config
    wins = window_frames(positions, cfg["window"], len(st["frames"]))
    uniq, pos = np.unique(wins, return_inverse=True)
    with ref.precision(tf32):
        feats = ref.frame_features(st["frames"], uniq, st["state"],
                                   cfg["stage_sizes"], cfg["pixel_stats"])
        return ref.window_poses(st["state"], feats, pos.reshape(wins.shape))


def _gaps(got: np.ndarray, want: np.ndarray) -> dict:
    got, want = got.reshape(-1, 6), want.reshape(-1, 6)
    return pose_gaps(got[:, :3], qexp(got[:, 3:]), want[:, :3], want[:, 3:])


def check(run, record) -> dict:
    """``t_gap`` and ``q_gap_deg`` over every pose of the judged requests'
    windows (T a request), against the reference's full forward over the
    same frames."""
    req = _judged(run, record)
    got = np.stack([record["outs"][i] for i in req])
    return _gaps(got, _want(run, np.asarray(record["positions"])[req]))


def control(run, record) -> dict:
    """:func:`check`'s numbers for the reference computed with TF32
    convolutions and matmuls (the precision below the configuration's) in
    the program's place."""
    positions = np.asarray(record["positions"])[_judged(run, record)]
    return _gaps(_want(run, positions, tf32=True), _want(run, positions))
