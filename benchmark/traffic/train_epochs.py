"""Training epochs: the port's ``Trainer`` on a raw-Bayer scene from its
device frame cache, whole shuffled epochs back to back.

Set-up makes the scene's mosaics (host views) and one MapNet from the seed,
builds the ``Trainer`` as ``cli.train --raw_bayer --device_cache`` builds it
(the criterion with the learned weights the parameters name, the optimizer
of the configuration, the K4 preprocess), uploads the cache and trains one
warm epoch, whose first ``check_steps`` steps are recorded for the check:
their batches and losses, Adam's first moments after the first step and
the weights after the last. The window's epochs are ``Trainer.train_epoch``
calls; those that start inside it count, the rate being their training
images over their wall time back to back.

Parameters: ``learn_beta``, ``learn_gamma``, ``device_cache`` (True, or
"shard" over a data-parallel group), ``steps_per_launch``, ``check_steps``.

Over a data-parallel group (the ``dp_train`` driver starts the ranks) every
rank runs these functions alike; rank 0 decides when the window ends.
"""

from __future__ import annotations

import tempfile
import time

import numpy as np
import torch

from benchmark.core import inputs, program
from benchmark.reference.compare import train_gaps
from benchmark.reference.train import follow_steps

__all__ = ["setup", "window", "release", "check", "control"]


class _Recorder:
    """Wraps a train step; records the first ``n`` steps' global batches
    (every rank's rows, in rank order, over a data-parallel ``mesh``) and
    losses, the first gradient as Adam took it (its first moment after the
    first step, less the decayed one before) and the trainable leaves after
    the last. With ``start`` (a function returning the state before the
    first recorded step) that state is kept too, as ``start``."""

    def __init__(self, step, named: dict, n: int, mesh=None, start=None):
        self.step, self.named, self.n, self.mesh = step, named, n, mesh
        self.snapshot = start
        self.batches, self.losses = [], []
        self.start = self.grad0 = self.leaves = None

    def _moments(self, key: str) -> dict:
        state = self.step.optimizer.optimizer.state
        # a leaf with no update yet has no moment: zero
        return {k: state.get(p, {}).get(key, torch.zeros_like(p)).detach()
                .clone() for k, p in self.named.items()}

    def __call__(self, x, poses, **kw):
        if len(self.losses) >= self.n:
            return self.step(x, poses, **kw)
        batch = (x.detach().clone(), poses.detach().clone())
        if self.mesh is not None:
            batch = tuple(self.mesh.all_gather(t) for t in batch)
        self.batches.append(batch)
        if not self.losses:
            before = self._moments("exp_avg")
            if self.snapshot is not None:
                self.start = self.snapshot()
        loss = self.step(x, poses, **kw)
        self.losses.append(float(loss))
        if len(self.losses) == 1:
            beta1 = 0.9
            self.grad0 = {k: (m - beta1 * before[k]) / (1 - beta1)
                          for k, m in self._moments("exp_avg").items()}
        if len(self.losses) == self.n:
            self.leaves = {k: p.detach().clone()
                           for k, p in self.named.items()}
        return loss


def _snapshot(trainer, model, crit):
    """The training state as it stands: the model's tensors (BatchNorm
    statistics among them), the loss weights, Adam's moments and the
    update count."""
    def start():
        named = {k.removeprefix("posenet."): p
                 for k, p in model.named_parameters() if p.requires_grad}
        named.update({k: p for k, p in crit.named_parameters()
                      if p.requires_grad})
        state = trainer.optimizer.optimizer.state
        return dict(
            params={k.removeprefix("posenet."): v.detach().clone()
                    for k, v in model.state_dict().items()},
            weights={k: getattr(crit, k).item()
                     for k in ("sax", "saq", "srx", "srq")},
            # a leaf with no update yet has no moment: zero
            moments=tuple({k: state.get(p, {}).get(
                key, torch.zeros_like(p)).detach().clone()
                for k, p in named.items()}
                for key in ("exp_avg", "exp_avg_sq")),
            count=int(trainer.optimizer.count))
    return start


def setup(run) -> None:
    from geomapnet_tpu_torch.cli.builders import (
        build_criteria,
        build_raw_device_preprocess,
    )
    from geomapnet_tpu_torch.data.composite import MF
    from geomapnet_tpu_torch.train.loop import Trainer

    cfg, p, dev = run.config, run.params, run.device
    s_weights, s_frames, s_poses, _ = inputs.seeds(run.seed, 4)
    seqs, per = cfg["scene"]["sequences"], cfg["scene"]["frames_per_sequence"]
    raw_h, raw_w = cfg["raw_frame"]
    scene = inputs.MosaicScene(s_frames, seqs, per, raw_h, raw_w)
    frames = inputs.Frames(inputs.trajectory_poses(s_poses, seqs * per, seqs),
                           images=scene)
    conf = program.experiment_config(cfg, run.seed)
    dataset = MF(frames, steps=conf.steps, skip=conf.skip, seed=conf.seed)
    state = inputs.seeded_states(s_weights, 1, dev, cfg["stage_sizes"],
                                 cfg["feat_dim"])[0]
    model = program.mapnet(cfg, state, dev)
    crit, _ = build_criteria("mapnet", conf, p["learn_beta"],
                             p["learn_gamma"])
    assets = program.asset_root(cfg)
    preprocess = build_raw_device_preprocess(
        cfg["scene_name"], assets.name, dtype=torch.float32,
        raw_size=(raw_h, raw_w), resize=cfg["frame"][0])
    logs = tempfile.TemporaryDirectory(prefix="bench_train_")
    trainer = Trainer(model, crit, conf, "bench", dataset, None,
                      logdir_root=logs.name, device=dev,
                      preprocess=preprocess, device_cache=p["device_cache"],
                      steps_per_launch=p["steps_per_launch"])
    named = {k.removeprefix("posenet."): v
             for k, v in model.named_parameters() if v.requires_grad}
    named.update({k: v for k, v in trainer.train_criterion.named_parameters()
                  if v.requires_grad})
    weights0 = {k: getattr(crit, k).item() for k in ("sax", "saq", "srx",
                                                     "srq")}
    rec = _Recorder(trainer.train_step, named, p["check_steps"],
                    trainer.mesh)
    trainer.train_step = rec
    program.reset_launches()
    t = time.time()
    trainer.train_epoch(0)
    run.log(f"cache upload {trainer.upload_secs:.3f} s; warm epoch "
            f"{time.time() - t:.3f} s; launches {program.launches()}")
    # the window's first steps are recorded too, with the state they start
    # from
    trainer.train_step = _Recorder(rec.step, named, p["check_steps"],
                                   trainer.mesh,
                                   start=_snapshot(trainer, model, crit))
    run.state.update(trainer=trainer, rec=rec, state=state, scene=scene,
                     poses=frames.poses, conf=conf, logs=logs, assets=assets,
                     weights0=weights0, epoch=1)


def _go(mesh, flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank of ``mesh`` (None: ``flag``)."""
    if mesh is None:
        return flag
    import torch.distributed as dist

    t = torch.tensor([float(flag)], device=mesh.device)
    dist.broadcast(t, 0, group=mesh.group)
    return bool(t.item())


def window(run, seconds: float) -> dict:
    tr = run.state["trainer"]
    first = len(tr.epoch_stats)
    program.reset_launches()
    t0 = time.time()
    while _go(tr.mesh, time.time() - t0 < seconds):
        with run.tracer.span("train_epoch"):
            tr.train_epoch(run.state["epoch"])
        run.state["epoch"] += 1
    wall = time.time() - t0
    run.state["win_rec"] = tr.train_step
    tr.train_step = tr.train_step.step
    stats = tr.epoch_stats[first:]
    images = sum(s["images"] for s in stats)
    run.log(f"{len(stats)} epochs, {sum(s['steps'] for s in stats)} steps, "
            f"{images} images in {wall:.3f} s; epoch s "
            f"{[round(s['secs'], 4) for s in stats]}; loader wait s "
            f"{[round(s['data_secs'], 4) for s in stats]}; launches "
            f"{program.launches()}")
    return {"e2e": {"train_images_per_s": images / wall},
            "attempted": sum(s["steps"] for s in stats), "failed": 0,
            "epochs": stats, "images": images, "wall_s": wall,
            "frames_per_step": (tr.config.batch_size * tr.config.steps
                                // tr.process_count)}


def release(run) -> None:
    st = run.state
    tr = st.pop("trainer")
    if tr.tee is not None:
        tr.tee.uninstall()
        tr.tee.close()
    tr.metrics.close()
    del tr
    st["logs"].cleanup()
    st["assets"].cleanup()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def _reference(run, rec, start=None) -> dict:
    """The reference's steps over ``rec``'s batches: from the seeded state
    (``start`` None), or from ``start`` (the program's state before them).
    Frames and targets are looked up by the batches' frame indices."""
    st, cfg, conf = run.state, run.config, run.state["conf"]
    scene, dev = st["scene"], run.device
    batches = []
    for idx, _ in rec.batches:
        flat = idx.cpu().numpy().reshape(-1)
        raw = torch.from_numpy(np.stack([scene[i] for i in flat])).to(dev)
        targ = torch.from_numpy(st["poses"][flat]).to(dev)
        batches.append((raw.view(tuple(idx.shape) + raw.shape[1:]),
                        targ.view(tuple(idx.shape) + targ.shape[1:])))
    if start is None:
        start = dict(params=st["state"], weights=st["weights0"])
    return follow_steps(
        start["params"], start["weights"], batches, seed=conf.seed,
        lr=conf.lr, weight_decay=conf.weight_decay, droprate=conf.dropout,
        stage_sizes=cfg["stage_sizes"], mean=cfg["pixel_stats"][0],
        std=list(np.sqrt(cfg["pixel_stats"][1])),
        out_hw=(cfg["frame"][0], cfg["frame"][1]),
        moments=start.get("moments"), start_step=start.get("count", 0))


def _gaps(run, got: dict, want: dict, start=None) -> dict:
    """``train_gaps`` of two followed runs (``losses``, ``grad0``,
    ``params``) from the same start (None: the seeded state)."""
    if start is None:
        start = dict(params=run.state["state"], weights=run.state["weights0"])
    at = {**start["params"], **{k: torch.tensor(v, device=run.device)
                                for k, v in start["weights"].items()}}
    change = {k: got["params"][k] - at[k] for k in want["params"]}
    ref_change = {k: want["params"][k] - at[k] for k in want["params"]}
    return train_gaps(got["losses"], want["losses"], got["grad0"],
                      want["grad0"], change, ref_change)


def _recorded(rec) -> dict:
    return {"losses": rec.losses, "grad0": rec.grad0, "params": rec.leaves}


def check(run, record) -> dict:
    """``loss_gap``, ``loss1_gap``, ``grad_gap`` and ``change_gap`` of the
    program's first steps from the seeded state against the reference's,
    and the same numbers, prefixed ``win_``, of the window's first steps
    followed from the program's state before them."""
    st = run.state
    out = _gaps(run, _recorded(st["rec"]), _reference(run, st["rec"]))
    win = st["win_rec"]
    out.update({f"win_{k}": v for k, v in _gaps(
        run, _recorded(win), _reference(run, win, win.start),
        win.start).items()})
    return out


def control(run, record) -> dict:
    """:func:`check`'s numbers for the reference computed with TF32 in the
    program's place."""
    st = run.state
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    out = {}
    for prefix, rec, start in (("", st["rec"], None),
                               ("win_", st["win_rec"], st["win_rec"].start)):
        want = _reference(run, rec, start)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got = _reference(run, rec, start)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        out.update({prefix + k: v
                    for k, v in _gaps(run, got, want, start).items()})
    return out
