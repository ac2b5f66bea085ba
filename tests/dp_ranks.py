"""Process groups for the data-parallel tests, and what their ranks run.

Imports torch, numpy and the port only: the ranks are fresh interpreters
(``torch.multiprocessing``'s ``spawn``) that import no JAX; the test
modules compare their results with the JAX package in the parent.

:func:`run_group` starts ``world`` ranks of a gloo group on the CPU (one
torch thread each, a free port per group), runs ``rank_<name>(mesh,
**kwargs)`` on each and returns the ranks' results in rank order. A rank
that fails fails the call; a group that outlives its timeout is killed
and fails it too.
"""

from __future__ import annotations

import os
import pickle
import socket
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
if str(REPO) not in sys.path:     # a rank imports the port from this tree
    sys.path.insert(0, str(REPO))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, name: str, backend: str,
           device: str, kwargs: dict, out: str) -> None:
    torch.set_num_threads(1)
    from geomapnet_tpu_torch.parallel import initialize_distributed, \
        make_mesh

    try:
        initialize_distributed(f"127.0.0.1:{port}", world, rank,
                               backend=backend, device=device,
                               timeout_s=120)
        result = globals()[f"rank_{name}"](make_mesh(device), **kwargs)
        with open(Path(out) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    import torch.distributed as dist

    dist.destroy_process_group()


def run_group(name: str, world: int, timeout: float = 240.0,
              backend: str = "gloo", device: str = "cpu", **kwargs) -> list:
    """``rank_<name>(mesh, **kwargs)`` on each rank of a ``world``-rank
    group (gloo ranks on the CPU by default); the ranks' results in rank
    order."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as out:
        procs = [ctx.Process(target=_entry,
                             args=(r, world, port, name, backend, device,
                                   kwargs, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        # a rank that fails ends the group: the others would wait on it
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and any(
                p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise RuntimeError(f"rank_{name} over {world} ranks: exit codes "
                               f"{codes}")
        results = []
        for r in range(world):
            with open(Path(out) / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
    return results


# --- parallel helpers and the frame cache ------------------------------------

class Frames:
    """In-memory frame dataset: frame i is an (h, w, c) array of a seeded
    pattern; frames in ``bad`` fail to decode."""

    def __init__(self, n, shape=(4, 6, 3), dtype=np.uint8, seed=0, bad=()):
        self.n, self.shape, self.dtype, self.bad = n, shape, dtype, set(bad)
        rs = np.random.RandomState(seed)
        self.data = rs.randint(0, 256, (n,) + shape).astype(np.int64)
        if dtype == np.int8:
            self.data -= 128
        self.data = self.data.astype(dtype)

    def __len__(self):
        return self.n

    def get_image(self, i):
        return None if int(i) in self.bad else self.data[int(i)]

    def get_images(self, idx, num_workers=1):
        return [self.get_image(i) for i in idx]


def rank_card(mesh) -> dict:
    """A one-rank NCCL group on the card: each collective the port calls,
    the sharded gather against plain indexing, and a data-parallel train
    step captured in a CUDA graph (``KLaunch``) against the same steps
    run eagerly, under deterministic cuDNN."""
    import copy

    from geomapnet_tpu_torch.data.device_cache import make_sharded_gather
    from geomapnet_tpu_torch.losses.criterion import MapNetCriterion
    from geomapnet_tpu_torch.models.posenet import MapNet, PoseNet
    from geomapnet_tpu_torch.models.resnet import resnet18
    from geomapnet_tpu_torch.train.loop import KLaunch
    from geomapnet_tpu_torch.train.optim import make_optimizer
    from geomapnet_tpu_torch.train.state import make_train_step

    dev = mesh.device
    out = {"backend": mesh.backend}
    t = torch.arange(8, dtype=torch.float32, device=dev)
    out["all_reduce"] = mesh.all_reduce_(t.clone()).tolist()
    u = torch.arange(12, dtype=torch.uint8, device=dev)
    out["reduce_scatter"] = mesh.reduce_scatter(u).tolist()
    out["all_gather"] = mesh.all_gather(u).tolist()
    out["broadcast"] = mesh.broadcast_(t.clone()).tolist()
    frames = torch.from_numpy(Frames(10).data).to(dev)
    idx = torch.tensor([[9, 0, 3], [5, 5, 1]], dtype=torch.int32,
                       device=dev)
    out["gather_equal"] = bool(torch.equal(
        make_sharded_gather(mesh)(frames, idx), frames[idx.long()]))

    torch.backends.cudnn.deterministic = True
    torch.manual_seed(0)
    model = MapNet(PoseNet(resnet18(), feat_dim=32, droprate=0.5))
    model.to(device=dev, memory_format=torch.channels_last)
    crit = MapNetCriterion(learn_beta=True, learn_gamma=True).to(dev)
    rs = np.random.RandomState(0)
    stack = torch.from_numpy(rs.randint(0, 256, (12, 32, 48, 3)).astype(
        np.float32) / 255).to(dev)
    idx_k = rs.randint(0, 12, (3, 4, 3)).astype(np.int32)
    poses_k = (rs.randn(3, 4, 3, 6) * 0.1).astype(np.float32)
    losses = {}
    for mode in ("graph", "eager"):
        m, c = copy.deepcopy(model), copy.deepcopy(crit)
        opt = make_optimizer("adam", 1e-4, m, c)
        step = make_train_step(m, c, opt, mesh=mesh)
        if mode == "graph":
            launch = KLaunch(lambda i, p, f: step(i, p, seed=3, frames=f),
                             3, dev)
            got = [launch(idx_k, poses_k, stack) for _ in range(3)]
            out["replays"] = launch.replays
        else:
            got = [torch.stack([step(torch.from_numpy(i).to(dev),
                                     torch.from_numpy(p).to(dev), seed=3,
                                     frames=stack)
                                for i, p in zip(idx_k, poses_k)])
                   for _ in range(3)]
        losses[mode] = torch.cat(got).tolist()
        out[f"{mode}_state"] = {k: v.cpu().numpy()
                                for k, v in m.state_dict().items()}
    out["losses"] = losses
    return out


def sync_bn_case(seed: int) -> tuple:
    """A well-conditioned global batch for a BatchNorm layer, from
    ``seed``: (8, 16, 5, 6) float32 activations whose channel means lie
    within about a standard deviation of 0, the layer's scale and bias,
    and an upstream gradient."""
    rs = np.random.RandomState(seed)
    c = 16
    x = (rs.randn(8, c, 5, 6) * rs.uniform(0.5, 2.0, (1, c, 1, 1))
         + rs.uniform(-1.0, 1.0, (1, c, 1, 1))).astype(np.float32)
    w = rs.uniform(0.5, 1.5, c).astype(np.float32)
    b = rs.randn(c).astype(np.float32)
    g = rs.randn(*x.shape).astype(np.float32)
    return x, w, b, g


def batch_norm_step(x, w, b, g, mesh=None) -> dict:
    """One train-mode forward and backward of the port's ``BatchNorm2d``
    on ``x`` (synced over ``mesh`` when given): its output, the gradients
    and the running statistics."""
    from geomapnet_tpu_torch.models.resnet import BatchNorm2d, \
        sync_batch_norm

    bn = BatchNorm2d(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    sync_batch_norm(bn, mesh)
    bn.train()
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    y.backward(torch.from_numpy(g))
    return dict(y=y.detach().numpy(), dx=xt.grad.numpy(),
                dw=bn.weight.grad.numpy(), db=bn.bias.grad.numpy(),
                running_mean=bn.running_mean.numpy(),
                running_var=bn.running_var.numpy())


def rank_collectives(mesh, frames: dict, batches: dict,
                     bn_seeds: tuple = ()) -> dict:
    """The sharded and replicated uploads of each frame set, the sharded
    gather of each index batch, the invariant check, the batch helpers
    and, for each of ``bn_seeds``, a synced BatchNorm step on this rank's
    rows of :func:`sync_bn_case`, on this rank."""
    from geomapnet_tpu_torch.data import device_cache as dc
    from geomapnet_tpu_torch.parallel import (
        assert_same_across_processes,
        local_batch_size,
        shard_batch,
    )

    out = {"shards": {}, "replicated": {}, "gathered": {}}
    for name, spec in frames.items():
        src = Frames(**spec)
        shard = dc.upload_frames_sharded(src, mesh, chunk=3)
        out["shards"][name] = shard.numpy()
        out["replicated"][name] = dc.upload_dataset_frames(
            src, mesh.device, mesh=mesh, chunk=3).numpy()
        out["range", name] = dc.local_shard_range(len(src), mesh)
        gather = dc.make_sharded_gather(mesh)
        for bname, idx in batches.items():
            out["gathered"][name, bname] = gather(
                shard, torch.from_numpy(idx)).numpy()
    out["sync_bn"] = {
        seed: batch_norm_step(*(shard_batch(a, mesh) if i in (0, 3) else a
                                for i, a in enumerate(sync_bn_case(seed))),
                              mesh=mesh)
        for seed in bn_seeds}
    out["local_batch"] = local_batch_size(8 * mesh.world_size, mesh)
    out["shard_batch"] = shard_batch(np.arange(4 * mesh.world_size), mesh)
    assert_same_across_processes([1, 2, 3], "same", mesh)
    try:
        assert_same_across_processes([mesh.rank], "rank", mesh)
        out["differ_raised"] = None
    except AssertionError as e:
        out["differ_raised"] = str(e)
    return out


# --- training ----------------------------------------------------------------

def rank_train_step(mesh, cases: list) -> list:
    """Each case: the model and criterion state dicts, this rank's rows of
    the global batch (and keep-masks), the optimizer settings; runs
    ``n_steps`` data-parallel steps and returns the losses and the final
    state dicts."""
    from geomapnet_tpu_torch.losses.criterion import MapNetCriterion
    from geomapnet_tpu_torch.models.posenet import MapNet, PoseNet
    from geomapnet_tpu_torch.models.resnet import resnet18
    from geomapnet_tpu_torch.parallel import microbatch_rows
    from geomapnet_tpu_torch.train.optim import make_optimizer
    from geomapnet_tpu_torch.train.state import make_train_step

    results = []
    for case in cases:
        model = MapNet(PoseNet(resnet18(), droprate=case["droprate"],
                               feat_dim=case["feat"]))
        model.posenet.load_state_dict(case["state"])
        crit = MapNetCriterion(saq=-3.0, srq=-3.0, learn_beta=True,
                               learn_gamma=True)
        opt = make_optimizer("adam", case["lr"], model, crit,
                             weight_decay=case["weight_decay"],
                             steps_per_epoch=1)
        accum = case["accum"]
        step = make_train_step(model, crit, opt, accum_steps=accum,
                               mesh=mesh)
        x, y = case["x"], case["y"]
        rows = microbatch_rows(mesh.rank, mesh.world_size, len(x), accum)
        keep = None
        if case.get("mask") is not None:
            # this rank's rows of the (global) microbatch's mask
            m = case["mask"]
            per = len(m) // mesh.world_size
            keep = [torch.from_numpy(m[mesh.rank * per:(mesh.rank + 1) * per])
                    ] * accum
        losses = [float(step(torch.from_numpy(x[rows]),
                             torch.from_numpy(y[rows]), seed=case["seed"],
                             keep_masks=keep))
                  for _ in range(case["n_steps"])]
        results.append(dict(
            losses=losses,
            state={k: v.numpy().copy()
                   for k, v in model.posenet.state_dict().items()},
            crit={k: float(v) for k, v in crit.named_parameters()},
            count=opt.count))
    return results


def rank_trainer(mesh, runs: list) -> list:
    """Each run: the port's Trainer on a synthetic MapNet scene from the
    given initial state, over ``n_epochs``; returns what the tests
    compare. ``resume``: a second Trainer restarts from the last
    checkpoint in the shared logdir."""
    from geomapnet_tpu_torch.cli.config import ExperimentConfig
    from geomapnet_tpu_torch.data.composite import MF
    from geomapnet_tpu_torch.data.synthetic import SyntheticScene
    from geomapnet_tpu_torch.losses.criterion import MapNetCriterion
    from geomapnet_tpu_torch.models.posenet import MapNet, PoseNet
    from geomapnet_tpu_torch.models.resnet import resnet18
    from geomapnet_tpu_torch.train.checkpoint import latest_checkpoint
    from geomapnet_tpu_torch.train.loop import Trainer

    out = []
    for run in runs:
        def trainer(cfg, checkpoint=None, resume=False):
            model = MapNet(PoseNet(resnet18(), feat_dim=run["feat"],
                                   droprate=0.0))
            if mesh.rank == 0 or not run.get("only_rank0_init"):
                model.posenet.load_state_dict(run["state"])
            train = MF(SyntheticScene(n_frames=run["n_train"], height=32,
                                      width=48), steps=3, skip=2)
            val = MF(SyntheticScene(n_frames=run["n_val"], height=32,
                                    width=48, train=False), steps=3, skip=2)
            return Trainer(
                model, MapNetCriterion(saq=-3.0, srq=-3.0, learn_beta=True,
                                       learn_gamma=True),
                ExperimentConfig(**cfg), run["name"], train, val,
                logdir_root=run["logdir"], device="cpu", mesh=mesh,
                checkpoint=checkpoint, resume_optim=resume,
                **run.get("kwargs", {}))

        t = trainer(run["cfg"])
        t.train_val()
        res = dict(
            state={k: v.numpy().copy()
                   for k, v in t.model.posenet.state_dict().items()},
            count=t.optimizer.count,
            per_replay=t.graph_launches())
        if run.get("resume"):
            cfg = dict(run["cfg"], n_epochs=run["cfg"]["n_epochs"] + 1)
            latest = latest_checkpoint(Path(run["logdir"]) / run["name"])
            t2 = trainer(cfg, checkpoint=str(latest), resume=True)
            res["resumed_at"] = t2.start_epoch
            res["resumed_count"] = t2.optimizer.count
            t2.train_val()
            res["final_count"] = t2.optimizer.count
            res["final_state"] = {
                k: v.numpy().copy()
                for k, v in t2.model.posenet.state_dict().items()}
        out.append(res)
    return out


# --- evaluation --------------------------------------------------------------

def rank_evaluate(mesh, scene: str, weights: str, calls: list,
                  n_frames: int) -> list:
    """The port's ``evaluate()`` under the group for each call's keyword
    arguments, on the 7Scenes fixture ``scene`` (its test split at 32x43)
    with the MapNet / PoseNet weights of the npz ``weights``."""
    from geomapnet_tpu_torch.cli import builders
    from geomapnet_tpu_torch.cli import eval as port_eval
    from geomapnet_tpu_torch.cli.config import ExperimentConfig
    from geomapnet_tpu_torch.data.composite import MF
    from geomapnet_tpu_torch.data.sevenscenes import SevenScenes
    from geomapnet_tpu_torch.data.transforms import ImageTransform
    from geomapnet_tpu_torch.models.flax_import import (
        load_npz,
        variables_to_state_dict,
    )

    root = Path(scene)
    stats = tuple(np.loadtxt(root / "assets" / "7Scenes" / "heads"
                             / "pose_stats.txt"))
    pre = builders.build_device_preprocess("7Scenes", "heads",
                                           str(root / "assets"))
    out = []
    for call in calls:
        call = dict(call)
        model_name = call.pop("model", "mapnet")
        frames = SevenScenes(
            "heads", str(root / "deepslam" / "7Scenes"), train=False,
            transform=ImageTransform(resize=32, keep_uint8=True),
            asset_dir=str(root / "assets" / "7Scenes"))
        is_tuple = model_name == "mapnet"
        ds = MF(frames, steps=3, skip=2) if is_tuple else frames
        model, _ = builders.build_model(model_name, ExperimentConfig(),
                                        trunk="resnet18")
        (model.posenet if is_tuple else model).load_state_dict(
            variables_to_state_dict(load_npz(weights[model_name])))
        res = port_eval.evaluate(
            model, ds, torch.device("cpu"), pose_stats=stats,
            progress=False, preprocess=pre, mesh=mesh, **call)
        keep = {k: v for k, v in res.items()
                if k in ("pred_poses", "targ_poses", "frames_computed",
                         "dedup_slice")}
        if "device_frames" in res:
            keep["device_frames_shape"] = tuple(res["device_frames"].shape)
            keep["device_frames_dtype"] = str(res["device_frames"].dtype)
        out.append(keep)
    return out
