"""What the ranks of the grid tests run: tensor parallelism, spatial
partitioning, the pipeline and the dry run, on gloo ranks started by
:func:`dp_ranks.run_group` (``run_group("grid_ranks:<case>", ...)``).

Imports torch, numpy and the port only; the test modules compare the
results with the JAX package in the parent.
"""

from __future__ import annotations

import numpy as np
import torch


def _tiny_mapnet(feat: int, droprate: float = 0.0):
    from geomapnet_tpu_torch.models.posenet import MapNet, PoseNet
    from geomapnet_tpu_torch.models.resnet import resnet18

    return MapNet(PoseNet(resnet18(), feat_dim=feat, droprate=droprate))


def _grads(model, grid=None) -> dict:
    """Each parameter's gradient, the head's blocks all-gathered over the
    grid's ``model`` group (the logical gradient)."""
    from geomapnet_tpu_torch.parallel import gather_head

    grads = {k: p.grad for k, p in model.named_parameters()}
    if grid is not None:
        grads = gather_head(model, grid, state=grads)
    return {k: g.cpu().numpy().copy() for k, g in grads.items()}


def train_step_case(case: dict, grid=None, device="cpu") -> dict:
    """One train step of ``case`` (the tiny MapNet from ``case["state"]``):
    over ``grid`` with tensor parallelism (this rank's rows of the global
    batch), or on one process over the whole batch. With
    ``case["pre_steps"]``, that many one-process steps over the whole batch
    come first (seeds ``seed + 1``, ...), so that the optimizer has state
    when the head is sharded. Returns the loss, the gradients after the
    clip, the criterion's gradients, and the logical state and the
    optimizer's per-parameter state before the (last) update and the
    logical state after it."""
    from geomapnet_tpu_torch.losses.criterion import MapNetCriterion
    from geomapnet_tpu_torch.parallel import gather_head, shard_step_tp
    from geomapnet_tpu_torch.train.optim import make_optimizer
    from geomapnet_tpu_torch.train.state import make_train_step

    torch.manual_seed(0)
    model = _tiny_mapnet(case["feat"], case["droprate"])
    model.posenet.load_state_dict(case["state"])
    model.to(device)
    crit = MapNetCriterion(saq=-3.0, srq=-3.0, learn_beta=True,
                           learn_gamma=True).to(device)
    opt = make_optimizer("adam", case["lr"], model, crit,
                         weight_decay=case["weight_decay"],
                         max_grad_norm=case["max_grad_norm"])
    step = make_train_step(model, crit, opt)
    x, y = case["x"], case["y"]
    for i in range(case.get("pre_steps", 0)):
        step(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device),
             seed=case["seed"] + 1 + i)
    before = {k: v.cpu().numpy().copy() for k, v in
              model.posenet.state_dict().items()}
    moments = {k: {m: v.cpu().numpy().copy() for m, v in
                   opt.optimizer.state[p].items()}
               for k, p in model.posenet.named_parameters()
               if p in opt.optimizer.state}
    if grid is not None:
        shard_step_tp(step, grid)
        d = grid["data"]
        n = len(x) // d.world_size
        x, y = x[d.rank * n:(d.rank + 1) * n], y[d.rank * n:(d.rank + 1) * n]
    loss = float(step(torch.from_numpy(x).to(device),
                      torch.from_numpy(y).to(device), seed=case["seed"]))
    state = (gather_head(model, grid) if grid is not None
             else model.state_dict())
    forward = None
    if case.get("images") is not None:
        model.eval()
        with torch.no_grad():
            forward = model(torch.from_numpy(case["images"]).to(device)
                            ).cpu().numpy()
    return dict(
        forward=forward,
        loss=loss,
        grads=_grads(model, grid),
        crit={k: float(p.grad) for k, p in crit.named_parameters()},
        before=before,
        moments=moments,
        state={k.removeprefix("posenet."): v.cpu().numpy().copy()
               for k, v in state.items()})


def digest(arrays: dict) -> dict:
    """Each array's SHA-256: ranks other than 0 return these in place of
    the full states and gradients (bit-equal across ranks, and a quarter of
    the bytes through the temporary directory)."""
    import hashlib

    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in arrays.items()}


def rank_tp(mesh, cases: list, spatial: dict, errors: bool = True) -> dict:
    """The tensor-parallel cases on a 2x2 ``('data', 'model')`` grid, the
    spatially partitioned evals of ``spatial`` (the model state and the
    images, over a 1x4 and a 2x2 grid) and the grid's errors. Ranks other
    than 0 return the digests of the cases' gradients and states."""
    from geomapnet_tpu_torch.parallel import (
        make_mesh,
        make_spatial_eval_step,
        spatial_image_sharding,
        tp_state_shardings,
    )

    out = {}
    grid = make_mesh(mesh.device, axis_names=("data", "model"), shape=(2, 2))
    out["grid"] = dict(shape=grid.shape, coords=grid.coords,
                       data=grid["data"].world_size,
                       model=grid["model"].world_size)
    out["cases"] = [train_step_case(c, grid) for c in cases]

    # a model trained tensor-parallel loads its gathered state on one card:
    # the same eval forward
    one = _tiny_mapnet(cases[0]["feat"])
    one.posenet.load_state_dict({k: torch.from_numpy(v) for k, v in
                                 out["cases"][0]["state"].items()})
    x = torch.from_numpy(spatial["images"])
    one.eval()
    with torch.no_grad():
        out["gathered_forward"] = one(x).numpy()
    if mesh.rank != 0:
        for c in out["cases"]:
            c["grads"], c["state"] = digest(c["grads"]), digest(c["state"])
            del c["before"], c["moments"]

    model = _tiny_mapnet(spatial["feat"])
    model.posenet.load_state_dict(spatial["state"])
    out["spatial"] = {}
    for shape in ((1, 4), (2, 2)):
        g = make_mesh(mesh.device, axis_names=("data", "model"), shape=shape)
        sh = spatial_image_sharding(g, ndim=5, h_dim=2)
        out["spatial"][shape] = dict(
            spec=sh.spec, block=tuple(sh.shard(x).shape),
            out=make_spatial_eval_step(model, sh)(x)[1].numpy())
    out["spec4"] = spatial_image_sharding(g, ndim=4, h_dim=1).spec
    if errors:
        out["errors"] = {}
        for kw in (dict(shape=(3, 2)), dict(), dict(shape=(2,))):
            try:
                make_mesh(mesh.device, axis_names=("data", "model"), **kw)
            except ValueError as e:
                out["errors"][str(kw)] = str(e)
        inferred = make_mesh(mesh.device, axis_names=("data", "model"),
                             shape=(-1, 2))
        out["inferred"] = inferred.shape
        narrow = _tiny_mapnet(30)
        g4 = make_mesh(mesh.device, axis_names=("data", "model"),
                       shape=(1, 4))
        out["dims"] = tp_state_shardings(model, g4)
        try:
            tp_state_shardings(narrow, g4)
        except ValueError as e:
            out["errors"]["indivisible"] = str(e)
    return out


# --- pipeline ----------------------------------------------------------------

def _tanh_stage(w, a):
    return torch.tanh(a @ w)


def _closure(w):
    return lambda a: torch.tanh(a @ w)


def _stage_grid(mesh, n: int, shape=None, axes=("stage",)):
    from geomapnet_tpu_torch.parallel import make_mesh

    return make_mesh(mesh.device, axis_names=axes,
                     shape=shape or (n,), ranks=range(n) if shape is None
                     else None)


def rank_pipeline(mesh, mlp: dict, posenet: dict) -> dict:
    """The pipeline cases on 4 gloo ranks: the MLP chains of the JAX tests
    (closure weights, ``stage_params`` and the packed buffer, forward and
    gradients, at 1-4 stages and dp2 x pp2), the transport of uint8 and
    bf16, the validation errors, and the PoseNet trunk | head split at
    S = 2 and dp2 x pp2 with packed weights (forward, loss and the packed
    row's gradient)."""
    from geomapnet_tpu_torch.parallel import (
        pack_stage_params,
        pipeline_apply,
        shard_stage_params,
    )

    out = {}
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else
         [torch.from_numpy(a) for a in v] for k, v in mlp.items()}

    g4 = _stage_grid(mesh, 4)
    out["forward"] = {
        m: pipeline_apply([_closure(w) for w in t["w4"]], g4, t["x12"], m
                          ).numpy()
        for m in (1, 3, 6, 12)}
    g1 = _stage_grid(mesh, 1)
    if g1 is not None:
        out["single"] = pipeline_apply([_closure(t["w1"][0])], g1,
                                       t["x4"], 2).numpy()

    g3 = _stage_grid(mesh, 3)
    if g3 is not None:
        fns = [_tanh_stage] * 3
        # replicated stage_params
        ws = [w.clone().requires_grad_() for w in t["w3"]]
        loss = ((pipeline_apply(fns, g3, t["x6"], 3, stage_params=ws)
                 - t["targ6"]) ** 2).mean()
        loss.backward()
        out["stage_params"] = dict(loss=float(loss),
                                   grads=[w.grad.numpy() for w in ws])
        # the packed buffer, one row a rank
        row, meta = shard_stage_params(list(t["w3"]), g3)
        fwd = pipeline_apply(fns, g3, t["x6"], 3, packed_params=row,
                             params_meta=meta)
        loss = ((fwd - t["targ6"]) ** 2).mean()
        loss.backward()
        out["packed"] = dict(forward=fwd.detach().numpy(), loss=float(loss),
                             row=row.detach().numpy(),
                             grad=row.grad.numpy(), max_size=meta.max_size)
    # dp2 x pp2 on the 4 ranks
    dpp = _stage_grid(mesh, 4, shape=(2, 2), axes=("data", "stage"))
    fns = [_tanh_stage] * 2
    row, meta = shard_stage_params(list(t["w2"]), dpp)
    fwd = pipeline_apply(fns, dpp, t["x8"], 2, packed_params=row,
                         params_meta=meta, data_axis="data")
    loss = ((fwd - t["targ8"]) ** 2).mean()
    loss.backward()
    out["dpp"] = dict(forward=fwd.detach().numpy(), loss=float(loss),
                      grad=row.grad.numpy(), coords=dpp.coords)

    g2 = _stage_grid(mesh, 2)
    if g2 is not None:
        u8 = t["u8"]
        out["transport"] = dict(
            u8=pipeline_apply([lambda a: a + 1,
                               lambda a: a.to(torch.float32) / 255.0],
                              g2, u8, 2).numpy(),
            bf16=pipeline_apply(
                [lambda a: (a.to(torch.bfloat16) / 255.0) * 2 - 1,
                 lambda a: (a * a).to(torch.float32)], g2, u8, 2).numpy())
        out["errors"] = _pipeline_errors(g2, g4)
        out["pack_rows"] = pack_stage_params(
            [{"w": torch.zeros(2, 3)}, {"w": torch.zeros(4, 1)}])[0].shape
    out["posenet"] = _posenet_split(mesh, posenet)
    return out


def _pipeline_errors(g2, g4) -> dict:
    from geomapnet_tpu_torch.parallel import pack_stage_params, pipeline_apply

    add = [lambda w, a: a + w] * 2
    buf, meta = pack_stage_params([torch.zeros(()), torch.zeros(())])
    calls = {
        "stage_fns": lambda: pipeline_apply([_closure(torch.eye(6))] * 2, g4,
                                            torch.zeros(4, 6), 2),
        "microbatches": lambda: pipeline_apply(
            [_closure(torch.eye(6))] * 2, g2, torch.zeros(5, 6), 2),
        "meta": lambda: pipeline_apply(add, g2, torch.zeros(2, 3), 1,
                                       packed_params=buf),
        "both": lambda: pipeline_apply(add, g2, torch.zeros(2, 3), 1,
                                       packed_params=buf, params_meta=meta,
                                       stage_params=[torch.zeros(())] * 2),
        "stage_params": lambda: pipeline_apply(
            add, g2, torch.zeros(2, 3), 1, stage_params=[torch.zeros(())]),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _posenet_split(mesh, case: dict) -> dict:
    from geomapnet_tpu_torch.dryrun import posenet_stages, stage_params
    from geomapnet_tpu_torch.models.posenet import PoseNet
    from geomapnet_tpu_torch.models.resnet import ResNet
    from geomapnet_tpu_torch.parallel import pipeline_apply, shard_stage_params

    net = PoseNet(ResNet(stage_sizes=(1, 1)), feat_dim=case["feat"],
                  droprate=0.5)
    net.load_state_dict(case["state"])
    net.eval()
    fns = posenet_stages(net)
    x = torch.from_numpy(case["x"])
    out = {}
    for name, shape, axes, data in (
            ("pp2", None, ("stage",), None),
            ("dp2xpp2", (2, 2), ("data", "stage"), "data")):
        grid = _stage_grid(mesh, 2 if shape is None else 4, shape, axes)
        if grid is None:
            continue
        row, meta = shard_stage_params(stage_params(net), grid)
        y = pipeline_apply(fns, grid, x, 2, packed_params=row,
                           params_meta=meta, data_axis=data)
        loss = (y ** 2).mean()
        loss.backward()
        out[name] = dict(forward=y.detach().numpy(), loss=float(loss),
                         grad=row.grad.numpy(), stage=grid.index("stage"))
    return out


def rank_dryrun(mesh, n: int) -> dict:
    """``dryrun_multichip(n)`` on this rank."""
    from geomapnet_tpu_torch.dryrun import dryrun_multichip

    return dryrun_multichip(n, mesh.device)


def rank_shutdown(mesh) -> dict:
    """Leave the group through ``shutdown_distributed``, with two
    ``on_shutdown`` hooks registered: a live object's bound method (called
    while the group still exists) and a dropped object's (held weakly, so
    gone)."""
    import gc

    import torch.distributed as dist

    from geomapnet_tpu_torch.parallel import on_shutdown, shutdown_distributed

    calls = []

    class Owner:
        def __init__(self, name):
            self.name = name

        def release(self):
            calls.append((self.name, dist.is_initialized()))

    live, dropped = Owner("live"), Owner("dropped")
    on_shutdown(live.release)
    on_shutdown(dropped.release)
    del dropped
    gc.collect()
    before = dist.is_initialized()
    shutdown_distributed()
    return dict(before=before, after=dist.is_initialized(), calls=calls)


def rank_card_grid(mesh, case: dict, spatial: dict, split: dict) -> dict:
    """On the card, over two ranks: the tensor-parallel step on a 1x2 grid,
    the spatially partitioned eval on it, the PoseNet split pipelined over
    the two ranks with packed weights (forward and the row's gradient) and,
    on NCCL, the tensor-parallel step captured in CUDA graphs (``KLaunch``)
    against the same steps run eagerly."""
    from geomapnet_tpu_torch.dryrun import posenet_stages, stage_params
    from geomapnet_tpu_torch.losses.criterion import MapNetCriterion
    from geomapnet_tpu_torch.models.posenet import PoseNet
    from geomapnet_tpu_torch.models.resnet import ResNet
    from geomapnet_tpu_torch.parallel import (
        make_mesh,
        make_spatial_eval_step,
        pipeline_apply,
        shard_stage_params,
        shard_step_tp,
        spatial_image_sharding,
    )
    from geomapnet_tpu_torch.train.loop import KLaunch
    from geomapnet_tpu_torch.train.optim import make_optimizer
    from geomapnet_tpu_torch.train.state import make_train_step

    dev, W = mesh.device, mesh.world_size
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    grid = make_mesh(dev, axis_names=("data", "model"), shape=(1, W))
    out = {"backend": mesh.backend, "tp": train_step_case(case, grid, dev)}
    model = _tiny_mapnet(spatial["feat"]).to(dev)
    model.posenet.load_state_dict(spatial["state"])
    sh = spatial_image_sharding(grid, ndim=5, h_dim=2)
    out["spatial"] = make_spatial_eval_step(model, sh)(
        torch.from_numpy(spatial["images"]))[1].cpu().numpy()

    net = PoseNet(ResNet(stage_sizes=(1, 1)), feat_dim=split["feat"])
    net.load_state_dict(split["state"])
    net.to(dev).eval()
    stages = make_mesh(dev, axis_names=("stage",), shape=(W,))
    row, meta = shard_stage_params(stage_params(net), stages)
    fns = posenet_stages(net)
    y = pipeline_apply(fns, stages, torch.from_numpy(split["x"]), 2,
                       packed_params=row, params_meta=meta)
    (y ** 2).mean().backward()
    out["pipeline"] = dict(forward=y.detach().cpu().numpy(),
                           grad=row.grad.cpu().numpy(),
                           stage=stages.index("stage"))

    if mesh.backend == "nccl":
        torch.backends.cudnn.deterministic = True
        frames = torch.from_numpy(case["x"].reshape((-1,) + case["x"].shape[2:])
                                  ).to(dev)
        idx = np.arange(len(frames), dtype=np.int32).reshape(
            case["x"].shape[:2])
        losses = {}
        for mode in ("graph", "eager"):
            m = _tiny_mapnet(case["feat"], case["droprate"]).to(dev)
            m.posenet.load_state_dict(case["state"])
            c = MapNetCriterion(saq=-3.0, srq=-3.0, learn_beta=True,
                                learn_gamma=True).to(dev)
            step = shard_step_tp(make_train_step(
                m, c, make_optimizer("adam", case["lr"], m, c,
                                     max_grad_norm=1.0)), grid)
            idx_k = np.stack([idx] * 2)
            y_k = np.stack([case["y"]] * 2)
            if mode == "graph":
                launch = KLaunch(lambda i, p, f: step(i, p, seed=3, frames=f),
                                 2, dev)
                got = [launch(idx_k, y_k, frames) for _ in range(3)]
                out["replays"] = launch.replays
            else:
                got = [torch.stack([step(torch.from_numpy(i).to(dev),
                                         torch.from_numpy(t).to(dev), seed=3,
                                         frames=frames)
                                    for i, t in zip(idx_k, y_k)])
                       for _ in range(3)]
            losses[mode] = torch.cat(got).tolist()
        out["losses"] = losses
    return out


def rank_all_gather_exchange(mesh, spatial: dict, mlp: dict) -> dict:
    """The spatial eval (1x4 grid) and a 4-stage packed pipeline (forward
    and gradients) with the exchanges point to point, and again through
    the all-gather a gloo group on cards takes (forced here on the CPU)."""
    import dataclasses

    from geomapnet_tpu_torch.parallel import (
        Grid,
        make_mesh,
        make_spatial_eval_step,
        pipeline_apply,
        shard_stage_params,
        spatial_image_sharding,
    )
    from geomapnet_tpu_torch.parallel.mesh import DataParallel

    class AllGather(DataParallel):
        @property
        def p2p(self) -> bool:
            return False

    def gathered(grid):
        return Grid(grid.axis_names, grid.sizes, grid.coords,
                    tuple(AllGather(**{f.name: getattr(ax, f.name) for f in
                                       dataclasses.fields(ax)})
                          for ax in grid.axes), grid.device)

    model = _tiny_mapnet(spatial["feat"])
    model.posenet.load_state_dict(spatial["state"])
    x = torch.from_numpy(spatial["images"])
    grid = make_mesh(mesh.device, axis_names=("data", "model"), shape=(1, 4))
    stages = make_mesh(mesh.device, axis_names=("stage",), shape=(4,))
    ws = [torch.from_numpy(w) for w in mlp["w4"]]
    out = {}
    for name, g, st in (("p2p", grid, stages),
                        ("all_gather", gathered(grid), gathered(stages))):
        row, meta = shard_stage_params(ws, st)
        y = pipeline_apply([_tanh_stage] * 4, st,
                           torch.from_numpy(mlp["x12"]), 3,
                           packed_params=row, params_meta=meta)
        (y ** 2).mean().backward()
        out[name] = dict(
            spatial=make_spatial_eval_step(
                model, spatial_image_sharding(g))(x)[1].numpy(),
            forward=y.detach().numpy(), grad=row.grad.numpy())
    return out
