"""The multi-card dry run: every parallel layout of the port on a tiny model.

The counterpart of ``__graft_entry__.dryrun_multichip`` of the JAX package.
There one process drives an n-device mesh (a virtual CPU mesh when the
devices are missing); here every rank of an n-rank ``torch.distributed``
group runs :func:`dryrun_multichip` (one rank per card under ``torchrun``,
or gloo ranks on the CPU):

    torchrun --nproc_per_node=4 -m geomapnet_tpu_torch.dryrun
    torchrun --nproc_per_node=4 -m geomapnet_tpu_torch.dryrun --device cpu
    torchrun --nproc_per_node=4 -m geomapnet_tpu_torch.dryrun \
        --device cuda:0 --backend gloo      # four ranks on one card

The model is JAX's: a MapNet with a 2-stage ResNet (one basic block a
stage), feat_dim 64, dropout 0.5, on 64x64 tuples of 3 frames, a global
batch of 2n tuples (seeded normal images and targets where JAX feeds
zeros, so that the checks below compare something). The legs and their
lines are JAX's, each followed by its seconds:

- ``dp``: one data-parallel train step (Adam 1e-4, weight decay 5e-4,
  clip 5);
- with n >= 4 and even: ``dp(n/2)xtp2`` (tensor-parallel head,
  :func:`~geomapnet_tpu_torch.parallel.shard_step_tp`), ``spatial eval``
  on the same grid, ``pp2`` forward and ``pp2-train`` with stage-sharded
  packed weights on ranks 0-1, and ``dp2xpp2-train`` on ranks 0-3;
- ``dp-devicecache-train`` and ``dp-devicecache-scan2-train`` (two
  launches of ``KLaunch`` K=2: the second a CUDA graph on a card, with the
  gradient all-reduce captured; gloo collectives cannot be captured, so a
  gloo group's launches run eagerly);
- ``serving-artifact-dp``: the int8 fused-requant serving artifact
  (:mod:`geomapnet_tpu_torch.serving`), exported on rank 0, loaded on every
  rank and run on its share of the batch; on a card its int8 convs and
  max-pool are the K1 and K2 kernels.

Beyond finiteness, it holds the tensor-parallel step to the one-rank step
on the same global batch (loss within 1e-5 relative, each gradient within
1e-2 relative norm: the JAX package's bars), the spatial eval to the
one-rank forward (1e-4 absolute plus 1e-4 relative) and the pipeline's
forward, loss and packed-row gradients to the sequential composition
(PIPE_TOL of the largest output, loss and gradient entry), and on each
rank the serving artifact's rows to the plain path: every int8 conv and
max-pool call bit-equal to its plain version on CPU copies of the same
inputs, the poses within SERVING_TOL of the largest of the same artifact
loaded on the CPU. A miss raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

__all__ = ["dryrun_multichip", "tiny_mapnet", "posenet_stages",
           "stage_params"]

TP_LOSS_RTOL = 1e-5
TP_GRAD_RELNORM = 1e-2
SPATIAL_TOL = 1e-4
# pipelined against sequential: the same float32 operations on microbatches
# instead of the whole batch (a library may pick other algorithms for the
# other batch size), the activations carried exactly in float32
PIPE_TOL = 1e-4
# the int8 artifact on the device against its CPU load: the int8 layers
# bit-equal, the float32 pooling and head matmuls summed in another order
SERVING_TOL = 1e-5
K = 2


def tiny_mapnet(device, seed: int = 0):
    """JAX's dry-run model: MapNet over a ResNet(stage_sizes=(1, 1)),
    feat_dim 64, dropout 0.5, with weights from ``seed``."""
    from .models.posenet import MapNet, PoseNet
    from .models.resnet import ResNet

    torch.manual_seed(seed)
    return MapNet(PoseNet(ResNet(stage_sizes=(1, 1)), feat_dim=64,
                          droprate=0.5)).to(device)


def posenet_stages(posenet) -> list:
    """The trunk | head split of ``posenet`` as pipeline stages
    ``fn(params, a)``: the trunk in eval mode through
    ``torch.func.functional_call`` (differentiable in its BatchNorm
    statistics too, as the JAX package's ``trunk.apply`` is) and
    :func:`~geomapnet_tpu_torch.models.posenet.posenet_head_apply`."""
    from torch.func import functional_call

    from .models.posenet import posenet_head_apply

    trunk = posenet.feature_extractor

    def trunk_stage(p, a):
        return functional_call(trunk, p, (a,))

    return [trunk_stage, posenet_head_apply]


def stage_params(posenet) -> list:
    """[the trunk's floating state (state-dict names), the head's
    parameters] of ``posenet``, for :func:`posenet_stages`."""
    trunk = {k: v.detach() for k, v in
             posenet.feature_extractor.state_dict().items()
             if v.is_floating_point()}
    head = {k: {"weight": getattr(posenet, k).weight.detach(),
                "bias": getattr(posenet, k).bias.detach()}
            for k in ("fc_feat", "fc_xyz", "fc_wpqr")}
    return [trunk, head]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _relnorm(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / (b.norm() + 1e-9))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n: int, device: torch.device | str | None = None,
                     repeats: int = 0) -> dict:
    """The dry run's legs on this rank of an ``n``-rank group (see the
    module docstring); rank 0 prints JAX's leg lines. Returns ``{"lines":
    [...], "legs": {leg: {"seconds": s, ...checks}}}``. With ``repeats``,
    the dp, tensor-parallel and pipeline train legs also time their step
    (``step_ms``: the mean of ``repeats`` more steps after one more warm
    one, the device synchronized), outside the legs' seconds."""
    from .losses.criterion import MapNetCriterion
    from .models.resnet import sync_batch_norm
    from .parallel import (
        DataParallel,
        gather_head,
        make_mesh,
        pack_stage_params,
        pipeline_apply,
        replicated,
        shard_batch,
        shard_stage_params,
        shard_step_tp,
        spatial_image_sharding,
        unpack_stage_params,
    )
    from .parallel.tensor import make_spatial_eval_step
    from .train.loop import KLaunch
    from .train.optim import make_optimizer
    from .train.state import make_train_step

    mesh = make_mesh(device)
    if mesh.world_size != n:
        raise ValueError(f"dryrun_multichip({n}) runs on an {n}-rank group; "
                         f"this one has {mesh.world_size}")
    dev = mesh.device
    out = {"lines": [], "legs": {}}
    t_start = time.perf_counter()
    t_prev = [t_start]

    def leg_done(leg: str, msg: str, **checks) -> None:
        now = time.perf_counter()
        line = (f"dryrun_multichip({n}): {msg} "
                f"[leg {now - t_prev[0]:.1f}s, total {now - t_start:.1f}s]")
        out["lines"].append(line)
        out["legs"][leg] = dict(seconds=now - t_prev[0], **checks)
        if mesh.rank == 0:
            print(line, flush=True)
        t_prev[0] = now

    timers = []

    def timed(leg: str, fn) -> None:
        """``step_ms`` of ``leg``: ``fn`` run 1 + ``repeats`` times, after
        the checks (a timed step moves the weights the next legs check)."""
        if repeats:
            timers.append((leg, fn))

    def run_timers() -> None:
        for leg, fn in timers:
            time_step(leg, fn)

    def time_step(leg: str, fn) -> None:
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        out["legs"][leg]["step_ms"] = (now - t0) / repeats * 1e3
        t_prev[0] = now

    def criterion():
        return MapNetCriterion(saq=-3.0, srq=-3.0, learn_beta=True,
                               learn_gamma=True).to(dev)

    def optimizer(model, crit):
        return make_optimizer("adam", 1e-4, model, crit, weight_decay=5e-4,
                              max_grad_norm=5.0)

    def copy_of(model):
        other = tiny_mapnet(dev)
        other.load_state_dict(model.state_dict())
        return other

    batch = 2 * n
    rs = np.random.RandomState(0)
    images = torch.from_numpy(rs.randn(batch, 3, 64, 64, 3).astype(
        np.float32))
    targets = torch.from_numpy((rs.randn(batch, 3, 6) * 0.1).astype(
        np.float32))

    model = tiny_mapnet(dev)
    replicated(model, mesh)
    crit = criterion()
    step = make_train_step(model, crit, optimizer(model, crit), mesh=mesh)
    x, y = shard_batch((images.to(dev), targets.to(dev)), mesh)
    loss = float(step(x, y, seed=1))
    _check(np.isfinite(loss), f"non-finite loss {loss}")
    leg_done("dp", f"dp ok, loss={loss:.4f}")
    timed("dp", lambda: step(x, y, seed=1))

    if n >= 4 and n % 2 == 0:
        # 2-D grid: data-parallel batch x Megatron tensor-parallel head,
        # from the dp leg's weights, against the one-rank step on the same
        # global batch
        grid = make_mesh(dev, axis_names=("data", "model"),
                         shape=(n // 2, 2))
        # the one-rank reference normalizes with the synced layers' one-pass
        # variance (JAX's formula) over its whole batch, so that the gap is
        # the tensor parallelism's, not the BatchNorm formula's; cuDNN's
        # deterministic algorithms keep atomics out of the two backwards
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        ref = sync_batch_norm(copy_of(model), DataParallel(1, 0, dev))
        ref_crit = criterion()
        ref_step = make_train_step(ref, ref_crit, optimizer(ref, ref_crit))
        ref_loss = float(ref_step(images.to(dev), targets.to(dev), seed=2))
        tp = copy_of(model)
        tp_crit = criterion()
        tp_step = shard_step_tp(make_train_step(tp, tp_crit,
                                                optimizer(tp, tp_crit)),
                                grid)
        x, y = shard_batch((images.to(dev), targets.to(dev)), grid["data"])
        tp_loss = float(tp_step(x, y, seed=2))
        grads = gather_head(tp, grid, state={
            k: p.grad for k, p in tp.named_parameters()})
        torch.backends.cudnn.deterministic = deterministic
        loss_gap = abs(tp_loss - ref_loss) / abs(ref_loss)
        grad_gap, worst = max((_relnorm(grads[k], p.grad), k)
                              for k, p in ref.named_parameters())
        _check(np.isfinite(tp_loss), f"non-finite tp loss {tp_loss}")
        _check(loss_gap <= TP_LOSS_RTOL and grad_gap <= TP_GRAD_RELNORM,
               f"tp step off the one-rank step: loss {loss_gap}, gradient "
               f"relative norm {grad_gap} ({worst})")
        leg_done("tp", f"dp{n // 2}xtp2 ok, loss={tp_loss:.4f}",
                 loss_gap=loss_gap, grad_relnorm=grad_gap, worst=worst)
        timed("tp", lambda: tp_step(x, y, seed=2))

        # spatial partitioning: the eval forward with image height banded
        # over 'model', of the tensor-parallel model, against the one-rank
        # forward of its gathered weights
        one = tiny_mapnet(dev)
        one.load_state_dict(gather_head(tp, grid))
        one.eval()
        with torch.no_grad():
            want = one(images.to(dev))
        sp = spatial_image_sharding(grid, ndim=5, h_dim=2)
        _, got = make_spatial_eval_step(tp, sp)(images)
        gap = float(((got - want).abs()
                     - SPATIAL_TOL * want.abs()).max())
        _check(bool(torch.isfinite(got).all()),
               "non-finite spatial eval output")
        _check(gap <= SPATIAL_TOL, f"spatial eval off the one-rank forward "
               f"by {gap} past the relative bound")
        leg_done("spatial", f"spatial eval ok, out={tuple(got.shape)}",
                 gap=float((got - want).abs().max()))

        # pipeline parallelism: GPipe over a 2-rank stage group, the trunk |
        # head split of the same (one-card) model
        frames = images.reshape((-1,) + tuple(images.shape[2:])).to(dev)
        posenet = one.posenet
        fns = posenet_stages(posenet)
        params = stage_params(posenet)
        with torch.no_grad():
            seq = fns[1](params[1], fns[0](params[0], frames))
        pp = make_mesh(dev, axis_names=("stage",), shape=(2,),
                       ranks=range(2))
        if pp is not None:
            with torch.no_grad():
                poses = pipeline_apply(
                    [lambda a: fns[0](params[0], a),
                     lambda a: fns[1](params[1], a)], pp, frames, 2)
            fwd_gap = _rel(poses, seq)
            _check(bool(torch.isfinite(poses).all()),
                   "non-finite pipeline output")
            _check(fwd_gap <= PIPE_TOL,
                   f"pp2 forward off the sequential one by {fwd_gap}")
            leg_done("pp2", f"pp2 ok, out={tuple(poses.shape)}",
                     gap=fwd_gap)
        else:
            leg_done("pp2", "pp2: not a stage rank")

        # the sequential loss and gradients of the packed buffer
        buf, meta = pack_stage_params(params)
        buf = buf.detach().requires_grad_(True)
        p0, p1 = unpack_stage_params(buf, meta)
        seq_loss = (fns[1](p1, fns[0](p0, frames)) ** 2).mean()
        seq_loss.backward()

        def pp_train(grid_, leg, data_axis=None):
            row, meta_ = shard_stage_params(params, grid_)
            s = grid_.index("stage")

            def train():
                out_ = pipeline_apply(fns, grid_, frames, 2,
                                      packed_params=row, params_meta=meta_,
                                      data_axis=data_axis)
                lval = (out_ ** 2).mean()
                lval.backward()
                return lval

            lval = train()
            lval, ref_loss = float(lval.detach()), float(seq_loss.detach())
            gaps = dict(loss_gap=abs(lval - ref_loss) / abs(ref_loss),
                        grad_gap=_rel(row.grad[0], buf.grad[s]))
            _check(np.isfinite(lval) and bool(torch.isfinite(row.grad).all()),
                   f"non-finite {leg} loss {lval} or gradients")
            _check(gaps["loss_gap"] <= PIPE_TOL
                   and gaps["grad_gap"] <= PIPE_TOL,
                   f"{leg} off the sequential step: {gaps}")
            return lval, row, gaps, train

        if pp is not None:
            lval, row, gaps, train = pp_train(pp, "pp2-train")
            leg_done("pp2-train",
                     f"pp2-train ok, loss={lval:.4f}, per-device params "
                     f"{row.numel() * 4 // 1024} KiB of "
                     f"{buf.numel() * 4 // 1024} KiB total", **gaps)
            timed("pp2-train", train)
        else:
            leg_done("pp2-train", "pp2-train: not a stage rank")

        dpp = make_mesh(dev, axis_names=("data", "stage"), shape=(2, 2),
                        ranks=range(4))
        if dpp is not None:
            lval, _, gaps, train = pp_train(dpp, "dp2xpp2-train", "data")
            leg_done("dp2xpp2-train", f"dp2xpp2-train ok, loss={lval:.4f}",
                     **gaps)
            timed("dp2xpp2-train", train)
        else:
            leg_done("dp2xpp2-train", "dp2xpp2-train: not a grid rank")

    run_timers()

    # the device frame cache x dp: every rank holds the frame buffer and
    # gathers its batch rows' frames from (B, T) indices
    frame_buf = torch.from_numpy(rs.randn(batch + 4, 64, 64, 3).astype(
        np.float32)).to(dev)
    idx = np.tile(np.arange(3, dtype=np.int32)[None], (batch, 1))
    dc = tiny_mapnet(dev, seed=3)
    replicated(dc, mesh)
    dc_crit = criterion()
    dc_step = make_train_step(dc, dc_crit, optimizer(dc, dc_crit), mesh=mesh)
    idx_l, y_l = shard_batch((idx, targets.numpy()), mesh)
    loss = float(dc_step(torch.from_numpy(idx_l).to(dev),
                         torch.from_numpy(y_l).to(dev), seed=4,
                         frames=frame_buf))
    _check(np.isfinite(loss), f"non-finite device-cache loss {loss}")
    leg_done("dp-devicecache-train", f"dp-devicecache-train ok, "
             f"loss={loss:.4f}")

    # K steps per launch x dp: two launches, the second a CUDA graph (the
    # all-reduce captured) on a card with NCCL
    launch = KLaunch(lambda i, p, f: dc_step(i, p, seed=5, frames=f), K,
                     dev)
    idx_k = np.stack([idx_l] * K)
    poses_k = np.stack([y_l] * K)
    for _ in range(2):
        k_losses = launch(idx_k, poses_k, frame_buf).tolist()
    _check(len(k_losses) == K and bool(np.isfinite(k_losses).all()),
           f"non-finite scanned-launch losses {k_losses}")
    leg_done("dp-devicecache-scan2-train",
             f"dp-devicecache-scan{K}-train ok, "
             f"losses={[round(v, 4) for v in k_losses]}",
             graph=launch.graph is not None)

    # the serving artifact x dp: the int8 fused-requant configuration,
    # exported once, run on every rank's share of the batch
    import torch.distributed as dist

    from . import serving

    blob = [None]
    if mesh.rank == 0:
        calib = [torch.from_numpy(np.random.RandomState(6).randn(
            2, 3, 64, 64, 3).astype(np.float32)).to(dev)]
        blob[0] = serving.export_inference(
            dc, None, frame_shape=(3, 64, 64, 3), dtype=torch.float32,
            quantize=True, calib_data=calib, quantize_heads=True,
            fuse_requant=True, platforms=("cuda", "cpu"))
    if mesh.active:
        dist.broadcast_object_list(blob, src=0, group=mesh.group,
                                   device=dev if mesh.backend == "nccl"
                                   else None)
    infer = serving.load_inference(blob[0], dev)
    mine = shard_batch(images, mesh)
    local = infer(mine.to(dev)).float()
    poses = mesh.all_gather(local)
    _check(tuple(poses.shape) == (batch, 3, 6), f"serving output "
           f"{tuple(poses.shape)}")
    _check(bool(torch.isfinite(poses).all()), "non-finite serving output")
    # this rank's rows against the plain path: every int8 kernel call of the
    # artifact bit-equal to its plain version on the same inputs, and the
    # poses to the same blob loaded on the CPU
    calls, mismatched = _int8_calls_against_plain(infer, mine.to(dev))
    _check(calls > 0 and not mismatched,
           f"serving artifact's int8 kernels differ from their plain "
           f"versions in {mismatched} of {calls} calls")
    plain = serving.load_inference(blob[0], "cpu")(mine).float()
    gap = _rel(local.cpu(), plain)
    _check(gap <= SERVING_TOL, f"serving artifact's poses off the CPU "
           f"load's by {gap} of the largest")
    leg_done("serving-artifact-dp", f"serving-artifact-dp ok, "
             f"{len(blob[0]) // 1024} KiB artifact, "
             f"out={tuple(poses.shape)}", int8_calls=calls, gap=gap)
    return out


def _int8_calls_against_plain(infer, x: torch.Tensor) -> tuple[int, int]:
    """Run the artifact ``infer`` on ``x`` node by node and hold the output
    of every int8 conv and max-pool call against the same operator on CPU
    copies of its inputs (where the wrappers run the plain versions),
    bit for bit. Returns (calls, calls that differ). Its launches are not
    counted: the counters are as they were before."""
    from .ops import cuda_quant

    ops = (torch.ops.geomapnet.int8_conv.default,
           torch.ops.geomapnet.int8_maxpool3x3s2.default)
    counts = dict(cuda_quant.launches)
    calls = [0, 0]

    def cpu(v):
        return v.cpu() if torch.is_tensor(v) else v

    class Compare(torch.fx.Interpreter):
        def call_function(self, target, args, kwargs):
            res = super().call_function(target, args, kwargs)
            if target in ops:
                want = target(*[cpu(a) for a in args],
                              **{k: cpu(v) for k, v in kwargs.items()})
                calls[0] += 1
                calls[1] += not torch.equal(res.cpu(), want)
            return res

    try:
        with torch.inference_mode():
            Compare(infer.module).run(x)
    finally:
        cuda_quant.launches.update(counts)
    return calls[0], calls[1]


def main(argv=None) -> dict:
    """``torchrun --nproc_per_node=N -m geomapnet_tpu_torch.dryrun``: join
    the launcher's group, run the dry run over all of its ranks with the
    int8 kernels' launch counters set to 0 just before, leave the group.
    With ``--out DIR`` each rank writes its result and its launches to
    ``DIR/rank<R>.json``."""
    import json
    from pathlib import Path

    from .ops import cuda_quant
    from .parallel import (
        initialize_distributed,
        local_device,
        process_count,
        process_index,
        shutdown_distributed,
    )

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="this rank's device (default: the card of "
                        "LOCAL_RANK); cpu runs gloo ranks")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="default: nccl on a card, gloo on the CPU; "
                        "gloo with --device cuda:0 puts every rank on one "
                        "card")
    parser.add_argument("--repeats", type=int, default=0,
                        help="also time the train legs' steps: the mean "
                        "of this many after a warm one")
    parser.add_argument("--out", default=None,
                        help="a directory for each rank's rank<R>.json")
    args = parser.parse_args(argv)
    device = (local_device() if args.device is None
              else torch.device(args.device))
    # float32 means float32: cuDNN convs and matmuls would otherwise run TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    initialize_distributed(backend=backend,
                           device=device if backend == "nccl" else None)
    try:
        for k in cuda_quant.launches:
            cuda_quant.launches[k] = 0
        result = dryrun_multichip(process_count(), device,
                                  repeats=args.repeats)
        result["launches"] = dict(cuda_quant.launches)
        if args.out is not None:
            Path(args.out, f"rank{process_index()}.json").write_text(
                json.dumps(result))
        return result
    finally:
        shutdown_distributed(device)


if __name__ == "__main__":
    main()
