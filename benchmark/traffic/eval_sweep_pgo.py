"""Checkpoint sweep with MapNet+PGO: ``evaluate(pose_graph=True)`` over one
scene's test split from the device frame cache, the checkpoints in turn, as
a researcher scores every saved epoch with the paper's pose-graph
inference.

Set-up makes ``checkpoints`` MapNets from the seed, the scene's uint8
frame stack on the card, its ground-truth path and DSO-like poses (that
path under a seeded random-walk drift; ``dso_drift`` of the
configuration), and the port's ``MF`` dataset as ``cli/eval.py::main``
builds it for 7Scenes with ``--pose_graph`` (``include_vos``, ``real``,
the ground truth as ``gt_dataset``, ``vos_logq_np``), then warms up with
one call. Each call of the window is the port's ``cli.eval.evaluate`` with
the stack as ``device_cache``, the serving options of the parameters and
the configuration's PGO weights: the int8 epoch, then every window's seven
poses fused with its six VOs on the card. Calls that start inside the
window count; the rate is their tuple-images over the wall from the first
call's start to the last one's return, PGO included.

Parameters: ``checkpoints``, ``settle_frames`` (frames on which the random
weights' BatchNorm statistics and translation head are settled), ``eval``
(keyword arguments of ``evaluate``), ``check_windows`` (windows of each
judged call compared with the reference).

The check, on each checkpoint's last call and ``check_windows`` windows of
it drawn from the seed:

- ``t_gap``, ``q_gap_deg`` (:func:`benchmark.reference.compare.pose_gaps`):
  the program's fused middle-frame poses against the reference's, which
  are the float32 reference network's poses of the window's frames through
  the float64 reference PGO (:mod:`benchmark.reference.pgo`) with float64
  VOs of the generated DSO-like poses (windows from the reference's own
  tuple rows), so that the whole path is judged, the program's VOs
  included;
- ``pgo_t_gap``, ``pgo_q_gap_deg``: the program's post-PGO poses of all the
  window's frames against the reference PGO of the solve's inputs as the
  program gave them (its pre-PGO poses, its dataset's VOs), which holds
  the float32 solve to the float64 one apart from the int8 trunk and from
  the float32 VOs (whose log of a near-identity rotation, as between a
  window's repeated frames at the scene's ends, is off by up to ~4e-4 rad
  through the arccos).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.core import inputs, program
from benchmark.reference import pgo as ref_pgo
from benchmark.reference import poses
from benchmark.reference.compare import pose_gaps
# the sweep's own: the models and the asset root go, the frames, weights and
# dataset stay for the check
from benchmark.traffic.eval_sweep import release

__all__ = ["setup", "window", "release", "check", "control", "dso_poses"]

# the program's results a judged call keeps (the others drop them)
KEPT = ("pgo_input_poses", "pgo_poses")


def dso_poses(seed: int, gt: np.ndarray, sequences: int, translation_step,
              rotation_step) -> np.ndarray:
    """(n, 6) float32 [xyz, log q] poses: the ground truth ``gt`` under a
    random-walk drift that starts at zero at each sequence's first frame,
    added to the translations and right-multiplied into the rotations."""
    rng = np.random.default_rng(seed)
    n = len(gt)
    drift = rng.normal(0.0, 1.0, (n, 6)) * np.array(
        [translation_step] * 3 + [rotation_step] * 3)
    drift = np.concatenate([np.cumsum(d, axis=0)
                            for d in np.array_split(drift, sequences)])
    g = torch.from_numpy(np.asarray(gt, np.float64))
    d = torch.from_numpy(drift)
    q = ref_pgo.qmul(ref_pgo.qexp(g[:, 3:]), ref_pgo.qexp(d[:, 3:]))
    return torch.cat([g[:, :3] + d[:, :3], ref_pgo.qlog(q)], 1).numpy(
        ).astype(np.float32)


def setup(run) -> None:
    from geomapnet_tpu_torch.cli.builders import build_device_preprocess
    from geomapnet_tpu_torch.cli.eval import evaluate
    from geomapnet_tpu_torch.data.composite import MF
    from geomapnet_tpu_torch.data.vo_np import vos_logq_np

    cfg, p, dev = run.config, run.params, run.device
    s_weights, s_frames, s_poses, s_check, s_drift = inputs.seeds(run.seed, 5)
    seqs, per = cfg["scene"]["sequences"], cfg["scene"]["frames_per_sequence"]
    h, w = cfg["frame"]
    frames = inputs.panorama_frames(s_frames, seqs, per, h, w, dev)
    gt = inputs.trajectory_poses(s_poses, seqs * per, seqs)
    dso = dso_poses(s_drift, gt, seqs, **cfg["dso_drift"])
    conf = program.experiment_config(cfg, run.seed)
    dataset = MF(inputs.Frames(dso), steps=conf.steps, skip=conf.skip,
                 variable_skip=conf.variable_skip, include_vos=True,
                 real=conf.real, gt_dataset=inputs.Frames(gt),
                 vo_func=vos_logq_np, seed=conf.seed)
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
    variances = (conf.s_abs_trans, conf.s_abs_rot, conf.s_rel_trans,
                 conf.s_rel_rot)
    kwargs = dict(p["eval"], batch_size=conf.batch_size,
                  preprocess=preprocess, device_cache=frames, progress=False,
                  num_workers=conf.num_workers, pose_graph=True, fc_vos=False,
                  pgo_weights=dict(zip(("sax", "saq", "srx", "srq"),
                                       variances)))
    t = time.time()
    program.reset_launches()
    warm = evaluate(models[0], dataset, dev, **kwargs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    missing = [k for k in KEPT if k not in warm]
    if missing:
        raise RuntimeError(
            f"evaluate(pose_graph=True) returned no {missing}: the pose "
            f"graph's window poses, which the check compares")
    run.log(f"warm-up call {time.time() - t:.3f} s, "
            f"{warm['frames_computed']} frames computed, PGO "
            f"{warm['pgo_secs']:.4f} s, launches {program.launches()}")
    del warm
    run.state.update(frames=frames, dataset=dataset, states=states,
                     models=models, kwargs=kwargs, evaluate=evaluate,
                     assets=assets, check_seed=s_check, conf=conf,
                     dso=dso, variances=variances)


def window(run, seconds: float) -> dict:
    from geomapnet_tpu_torch.pgo import pose_graph

    st = run.state
    evaluate, dataset, kwargs = st["evaluate"], st["dataset"], st["kwargs"]
    calls, last = [], {}
    program.reset_launches()
    solved = dict(pose_graph.solves)
    t0 = time.time()
    while time.time() - t0 < seconds:
        k = len(calls) % len(st["models"])
        ts = time.time()
        with run.tracer.span("eval_call"):
            res = evaluate(st["models"][k], dataset, run.device, **kwargs)
        te = time.time()
        call = dict(ckpt=k, start=ts, end=te,
                    images_per_sec=res["images_per_sec"],
                    frames_computed=res["frames_computed"],
                    pgo_secs=res["pgo_secs"], poses=res["pred_poses"],
                    finite=bool(all(np.isfinite(res[x]).all()
                                    for x in ("pred_poses",) + KEPT)))
        # only each checkpoint's last call is judged
        if k in last:
            for x in KEPT:
                last[k].pop(x, None)
        call.update({x: res[x] for x in KEPT})
        last[k] = call
        calls.append(call)
        del res
    wall = calls[-1]["end"] - t0
    S, T = len(dataset), dataset.steps
    durations = [c["end"] - c["start"] for c in calls]
    solved = {k: v - solved[k] for k, v in pose_graph.solves.items()}
    run.log(f"{len(calls)} calls of {S} windows x {T} frames in {wall:.3f} "
            f"s; per call median {np.median(durations):.4f} s, min "
            f"{min(durations):.4f} s, max {max(durations):.4f} s; epoch "
            f"(the program's images/s clock) median "
            f"{np.median([S * T / c['images_per_sec'] for c in calls]):.4f}"
            f" s; PGO median {np.median([c['pgo_secs'] for c in calls]):.4f}"
            f" s; solves {solved}; launches {program.launches()}")
    failed = sum(not c["finite"] for c in calls)
    return {"e2e": {"eval_images_per_s": len(calls) * S * T / wall},
            "attempted": len(calls), "failed": int(failed), "calls": calls,
            "wall_s": wall, "tuples": S, "steps": T,
            "unique_frames": len(dataset.dset),
            "frames_computed": calls[-1]["frames_computed"]}


def _judged(run, record) -> list:
    """The calls judged: each checkpoint's last call of the window, with
    ``check_windows`` of its windows drawn from the seed, and the frame rows
    of those windows (centred, ``skip`` apart, clamped to the scene)."""
    rng = np.random.default_rng(run.state["check_seed"])
    conf = run.state["conf"]
    n = len(run.state["dso"])
    rows = poses.tuple_rows(n, conf.steps, conf.skip, n)
    last = {}
    for c in record["calls"]:
        last[c["ckpt"]] = c
    m = min(n, run.params["check_windows"])
    out = []
    for _, c in sorted(last.items()):
        w = np.sort(rng.choice(n, m, replace=False))
        out.append((c, w, rows[w]))
    return out


def _seven(p6: np.ndarray) -> torch.Tensor:
    """[t, log q] (..., 6) -> [t, q] (..., 7), float64."""
    p = torch.as_tensor(np.asarray(p6, np.float64))
    return torch.cat([p[..., :3], ref_pgo.qexp(p[..., 3:])], -1)


def _network(run, state, rows, quant=None) -> torch.Tensor:
    """(W, T, 7) reference network poses of the frames ``rows`` (W, T)."""
    cfg = run.config
    uniq, inv = np.unique(rows, return_inverse=True)
    net = poses.frame_poses(run.state["frames"], uniq, state,
                            cfg["stage_sizes"], cfg["pixel_stats"], quant)
    return _seven(net[inv.reshape(-1)].reshape(rows.shape + (6,)))


def _vos(run, rows) -> torch.Tensor:
    """(W, T-1, 7) chain VOs of the DSO-like poses of ``rows``."""
    return ref_pgo.relative(_seven(run.state["dso"][rows]))


def _program_vos(run, windows) -> torch.Tensor:
    """(W, T-1, 7) the VOs of ``windows`` as the program's dataset gives
    them to its PGO."""
    ds = run.state["dataset"]
    return _seven(np.stack([ds[int(i)][1][ds.steps:] for i in windows]))


def _pgo(run, poses7, vos, **kw) -> torch.Tensor:
    dev = run.device
    return ref_pgo.optimize(torch.as_tensor(poses7).to(dev), vos.to(dev),
                            run.state["variances"], **kw).cpu()


def _gaps(out, want, prefix="") -> dict:
    """:func:`pose_gaps` of poses ``out`` against ``want`` ((..., 7) [t, q]
    each, flattened), the quaternions of ``out`` taken to unit norm first:
    the angle between two rotations, not a float32 norm's last bits (a
    norm off by 1e-7 reads as 0.05 degrees through the arccos of the dot
    product)."""
    out = torch.as_tensor(out, dtype=torch.float64).reshape(-1, 7)
    want = torch.as_tensor(want, dtype=torch.float64).reshape(-1, 7)
    q = out[:, 3:] / torch.linalg.vector_norm(out[:, 3:], dim=-1,
                                              keepdim=True)
    gaps = pose_gaps(out[:, :3].numpy(), q.numpy(), want[:, :3].numpy(),
                     ref_pgo.qlog(want[:, 3:]).numpy())
    return {prefix + k: v for k, v in gaps.items()}


def _worst(into: dict, numbers: dict) -> None:
    for k, v in numbers.items():
        into[k] = max(into.get(k, 0.0), v)


def check(run, record) -> dict:
    """The worst ``t_gap``, ``q_gap_deg``, ``pgo_t_gap`` and
    ``pgo_q_gap_deg`` over the judged calls."""
    worst = {}
    mid = run.state["conf"].steps // 2
    for call, w, rows in _judged(run, record):
        want = _pgo(run, _network(run, run.state["states"][call["ckpt"]],
                                  rows), _vos(run, rows))
        _worst(worst, {
            **_gaps(call["poses"][rows[:, mid]], want[:, mid]),
            **_gaps(call["pgo_poses"][w],
                    _pgo(run, call["pgo_input_poses"][w],
                         _program_vos(run, w)), "pgo_")})
    return worst


def control(run, record, bits: int = 4) -> dict:
    """The numbers of :func:`check` for what the reference computes in the
    program's place, the solve's inputs as the program gave them standing
    in where a control leaves the network and the VOs alone:

    - unprefixed, the precision below the configuration's: ``t_gap`` and
      ``q_gap_deg`` of the reference network at ``bits`` (weights per
      channel, activations per tensor, as the int8 cell's control) through
      the float64 PGO; ``pgo_t_gap`` and ``pgo_q_gap_deg`` of a float32
      PGO of the poses and VOs rounded to bfloat16 (``cholesky_ex`` has no
      bfloat16 kernel);
    - ``no_pgo.``: the pre-PGO poses returned as they are;
    - ``permuted_vos.``: the PGO with the VOs of other windows (a
      permutation of the scene's windows drawn from the seed);
    - ``one_iter.``: one Gauss-Newton iteration in the place of the
      configuration's ten (recorded; it need not fail).
    """
    out = {}
    conf, cfg = run.state["conf"], run.config
    mid = conf.steps // 2
    n = len(run.state["dso"])
    perm = np.random.default_rng(run.state["check_seed"] + 1).permutation(n)
    calib = poses.tuple_rows(
        run.params["eval"]["calib_batches"] * conf.batch_size, conf.steps,
        conf.skip, n)
    for call, w, rows in _judged(run, record):
        state = run.state["states"][call["ckpt"]]
        vos = _vos(run, rows)
        want = _pgo(run, _network(run, state, rows), vos)
        quant = poses.calibrated(run.state["frames"], calib, state,
                                 cfg["stage_sizes"], cfg["pixel_stats"], bits)
        low_in = _network(run, state, rows, quant)
        low = _gaps(_pgo(run, low_in, vos)[:, mid], want[:, mid])
        got_in = torch.as_tensor(call["pgo_input_poses"][w])
        got_vos = _program_vos(run, w)
        ref_out = _pgo(run, got_in, got_vos)
        bf16 = _pgo(run, got_in.to(torch.bfloat16).double(),
                    got_vos.to(torch.bfloat16).double(), dtype=torch.float32)
        _worst(out, {**low, **_gaps(bf16, ref_out, "pgo_")})
        variants = {
            "no_pgo.": got_in,
            "permuted_vos.": _pgo(run, got_in, _program_vos(run, perm[w])),
            "one_iter.": _pgo(run, got_in, got_vos, n_iters=1),
        }
        for name, got_out in variants.items():
            _worst(out, {**_gaps(got_out[:, mid], want[:, mid], name),
                         **_gaps(got_out, ref_out, name + "pgo_")})
    return out
