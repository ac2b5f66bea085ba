"""Evaluation CLI: batched inference and median/mean pose errors.

The PyTorch counterpart of :mod:`geomapnet_tpu.cli.eval` (upstream
scripts/eval.py): per-frame L2 translation error and quaternion
angular error, median and mean, over the middle frame of each tuple, with
translations un-normalized by the scene's ``pose_stats.txt``.

Ported so far, with PoseNet, MapNet or MapNet++ weights from a port checkpoint
(``epoch_*.pth.tar`` of :mod:`geomapnet_tpu_torch.cli.train`), an upstream
``.pth.tar`` or a Flax ``.npz``, in float32 or (``--bf16``) bfloat16:

- 7Scenes and the synthetic scene: host decode and resize to uint8, upload,
  normalize on the device; or, with ``--device_cache``, the whole scene
  uploaded once and the epoch run from the device, each unique frame
  computed once (:mod:`geomapnet_tpu_torch.cli.eval_epoch`)::

    python -m geomapnet_tpu_torch.cli.eval --dataset 7Scenes --scene heads \\
        --model mapnet --config_file configs/mapnet.ini --weights w.npz \\
        --val --device_cache --data_path <root> --asset_root <assets>

- RobotCar: the processed RGB frames as 7Scenes' are, or the raw-Bayer
  mosaics through the device pipeline (``--raw_bayer``; undistorted on the
  device with ``--camera_models_dir``).

- The serving trunks of :mod:`geomapnet_tpu_torch.models.quant`:
  ``--fold_bn`` (BatchNorm folded into the convs, the model's dtype) and
  ``--quantize int8`` (int8 convs through the hand-written CUDA kernel,
  bf16 heads), with ``--calibrate N`` static activation scales observed on
  the first N eval batches, ``--quantize_heads`` (int8 ``fc_feat``) and
  ``--fuse_requant`` (int8 between every conv). With ``--device_cache`` the
  fused run caches the scene as prequantized space-to-depth int8 rows and
  runs the stride-1 4x4 stem; the loader path keeps the 7x7 stem. The
  serving configuration::

    python -m geomapnet_tpu_torch.cli.eval --dataset 7Scenes --scene heads \\
        --model mapnet --config_file configs/mapnet.ini --weights w.npz \\
        --val --device_cache --quantize int8 --calibrate 2 \\
        --quantize_heads --fuse_requant --data_path <root> \\
        --asset_root <assets>

- MapNet+PGO (``--pose_graph``): the tuples carry the VOs between their
  frames (7Scenes: consecutive, RobotCar: all pairs), from the dataset's VO
  poses when the config says ``real = yes`` (then the absolute targets come
  from the ground truth); after the epoch every window's poses are fused
  with its VOs by the batched Gauss-Newton of
  :mod:`geomapnet_tpu_torch.pgo` on the device, in float32::

    python -m geomapnet_tpu_torch.cli.eval --dataset 7Scenes --scene heads \
        --model mapnet --config_file configs/pgo_inference_7Scenes.ini \
        --weights w.npz --val --pose_graph --device_cache \
        --data_path <root> --asset_root <assets>

- Eval-time dropout (``--eval_dropout``, the reference's ungated
  ``F.dropout``), drawn per batch from generators seeded by the config's
  seed and the batch index: the loader path and the device-cache tuple
  epoch give the same draws.

- The native decoder (``--native_loader``): colour frames decoded and
  resized by the C++ batch decoder (:mod:`geomapnet_tpu_torch.native`), one
  call per batch, instead of PIL; the run fails with the compiler's message
  on a host where the decoder cannot be built.

- Several cards: launched by ``torchrun --nproc_per_node=N``, the CLI
  joins the process group (NCCL; gloo with ``--device cpu``) and
  evaluates data-parallel, rank ``r`` on ``cuda:LOCAL_RANK``: every batch
  or window shards over the ranks through the trunk (a ``batch_size`` the
  ranks do not divide runs whole on every rank, with the JAX package's
  message), the trunk features are all-gathered and every rank runs the
  heads on the whole batch, and only rank 0 prints and writes files.
  ``--device_cache shard`` keeps the scene frame-sharded over the ranks
  (``make_sharded_gather``: one reduce-scatter a window), also as the int8
  serving configuration's row cache::

    torchrun --nproc_per_node=8 -m geomapnet_tpu_torch.cli.eval \
        --dataset 7Scenes --scene heads --model mapnet \
        --config_file configs/mapnet.ini --weights w.npz --val \
        --device_cache shard --quantize int8 --calibrate 2 \
        --quantize_heads --fuse_requant --batch_size 64 \
        --data_path <root> --asset_root <assets>

The trajectory plot of ``--output_dir`` is not written.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from ..data.composite import MF
from ..data.device_cache import (
    _probe_frames,
    make_sharded_gather,
    quantize_rows,
    s2d_frame_shape,
    upload_frames,
    upload_frames_global,
    upload_frames_sharded,
)
from ..data.loader import Loader
from ..data.vo_np import vos_logq_fc_np, vos_logq_np
from ..geometry.metrics import quaternion_angular_error, translation_error
from ..geometry.rotations import qexp_np
from ..models.flax_import import state_dict_to_variables
from ..models.quant import (
    QuantizedPoseNet,
    calibrate_activation_scales,
    convert_stem_s2d,
    fold_posenet_variables,
    quantize_posenet_variables,
)
from ..pgo import optimize_poses_batch
from ..train.checkpoint import load_weights
from .builders import (
    TRUNKS,
    build_device_preprocess,
    build_frame_dataset,
    build_model,
    build_raw_device_preprocess,
    build_transform,
    pick_device,
)
from .config import parse_ini
from .eval_epoch import (
    gather_windows,
    make_step,
    plan_epoch,
    run_epoch,
    tuple_index_matrix,
    tuple_outputs,
    window_generator,
)

__all__ = ["evaluate", "main"]


class _Single:
    """Gives a plain frame dataset a frame axis of 1, so that it takes the
    same loader and batch path as an MF dataset."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        img, pose = self.ds[i]
        return (None if img is None else img[None],
                np.asarray(pose, np.float32)[None])


class _Rows:
    """The samples ``rows`` of a dataset, in that order: a rank's share of
    every padded global batch on the data-parallel loader path."""

    def __init__(self, ds, rows: np.ndarray):
        self.ds, self.rows = ds, rows
        if hasattr(ds, "fetch_many"):
            self.fetch_many = lambda idx, **kw: ds.fetch_many(
                [int(self.rows[i]) for i in idx], **kw)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.ds[int(self.rows[i])]


def _rank_rows(S: int, batch_size: int, mesh) -> np.ndarray:
    """This rank's rows of every global batch of ``batch_size`` samples of
    ``S`` (the last padded with the last sample, as the Loader pads)."""
    nb = -(-S // batch_size)
    order = np.minimum(np.arange(nb * batch_size), S - 1)
    per = batch_size // mesh.world_size
    return order.reshape(nb, batch_size)[
        :, mesh.rank * per:(mesh.rank + 1) * per].reshape(-1)


def evaluate(model: torch.nn.Module, dataset, device: torch.device,
             **kwargs) -> dict:
    """Run batched evaluation of ``model`` over an MF (or plain frame)
    dataset on ``device``.

    ``preprocess`` maps the uploaded raw batch to model input on the device
    (the uint8 normalize, or the raw-Bayer pipeline). Returns
    {"pred_poses", "targ_poses", "t_err", "q_err", "median_t", "median_q",
    "mean_t", "mean_q", "images_per_sec"}; ``images_per_sec`` counts the
    evaluated tuple-images.

    ``device_cache``: False runs the loader path (host decode, one upload
    per batch). True uploads every frame once
    (:func:`geomapnet_tpu_torch.data.device_cache.upload_frames`) and runs
    the epoch from the device (:mod:`geomapnet_tpu_torch.cli.eval_epoch`); a
    tensor returned earlier as ``result["device_frames"]`` is reused without
    an upload. The result then also holds "device_frames", "upload_secs"
    (not in the rate's clock), "frames_computed" (forwards run, pads
    included) and "dedup_slice".

    ``dedup_frames`` (device cache only): None computes each unique frame
    once when that saves forwards (MapNet), True always does (MapNet only),
    False keeps the tuple epoch.

    ``pose_graph`` (an MF dataset with ``include_vos``): after the epoch's
    readback every window's poses and VOs go through
    :func:`geomapnet_tpu_torch.pgo.optimize_poses_batch` on ``device`` in
    float32, before translations are un-normalized, with the
    ``pgo_weights`` {sax, saq, srx, srq} and ``fc_vos`` (all-pairs VOs).
    Its time is outside ``images_per_sec``, as in the JAX package, and is
    returned as "pgo_secs" (host clock, results on the host).

    ``stochastic`` keeps the PoseNet's dropout active; batch (window) ``k``
    draws from ``window_generator(seed, k)``. The device cache then runs
    the tuple epoch (dedup is refused), and the serving trunks are refused.

    ``mesh`` (a :class:`geomapnet_tpu_torch.parallel.DataParallel` with a
    process group; every rank calls ``evaluate`` alike): data-parallel
    eval. Each batch or window shards over the ranks through the trunk;
    the features are all-gathered and the heads run on the whole batch
    (:func:`~geomapnet_tpu_torch.cli.eval_epoch.make_step`), so every rank
    returns the same result and the heads see the one-rank batch. A
    ``batch_size`` that the ranks do not divide runs whole on every rank,
    with the JAX package's message. ``device_cache="shard"`` (which needs
    the group) uploads each rank's share of the frames and reads each
    window through
    :func:`geomapnet_tpu_torch.data.device_cache.make_sharded_gather`; the
    returned "device_frames" is then this rank's shard, and a reused tensor
    of ``ceil(N/W)`` rows is taken as one. With several ranks the
    replicated cache uploads by an all-gather (each rank decodes its
    share).

    Serving trunks (:mod:`geomapnet_tpu_torch.models.quant`), under the JAX
    package's argument names and checks: ``fold_bn`` runs the BN-folded
    float trunk in the model's dtype; ``quantize`` the int8 trunk in bf16,
    with dynamic scales unless ``calib_batches`` > 0 observes that many
    eval batches (on the device-cache path gathered from the uploaded
    frames, otherwise from a loader; the same batches either way, so the
    same scales); ``quantize_heads`` runs ``fc_feat`` in int8 too;
    ``fuse_requant`` keeps every activation int8 between convs. A
    device-cache run with ``fuse_requant`` turns the cache into
    prequantized space-to-depth int8 rows
    (:func:`geomapnet_tpu_torch.data.device_cache.quantize_rows`, inside
    ``upload_secs``), returned as "device_frames" and reusable as they are,
    and runs the S2D stem. Dynamic-scale int8 couples batchmates, so it
    keeps the tuple epoch.

    With a variable-skip MF dataset the loader's get_indices draws and the
    middle-frame scatter's re-draws would differ under the shared RNG, so
    per-index deterministic sampling is forced for the duration of the call
    (and restored afterwards).
    """
    needs_det = (
        isinstance(dataset, MF)
        and dataset.sampler.variable_skip
        and not dataset.deterministic_indices
    )
    if not needs_det:
        return _evaluate(model, dataset, device, **kwargs)
    dataset.deterministic_indices = True
    try:
        return _evaluate(model, dataset, device, **kwargs)
    finally:
        dataset.deterministic_indices = False


def _evaluate(
    model: torch.nn.Module,
    dataset,
    device: torch.device,
    batch_size: int = 64,
    pose_stats: tuple[np.ndarray, np.ndarray] | None = None,
    pose_graph: bool = False,
    fc_vos: bool = False,
    pgo_weights: dict | None = None,
    progress: bool = True,
    preprocess=None,
    stochastic: bool = False,
    seed: int = 7,
    num_workers: int = 1,
    device_cache=False,
    dedup_frames: bool | None = None,
    quantize: bool = False,
    fold_bn: bool = False,
    calib_batches: int = 0,
    quantize_heads: bool = False,
    fuse_requant: bool = False,
    mesh=None,
) -> dict:
    is_tuple = isinstance(dataset, MF)
    L = len(dataset.dset) if is_tuple else len(dataset)
    steps = dataset.steps if is_tuple else 1
    use_device_cache = device_cache is not False and device_cache is not None
    if dedup_frames and not use_device_cache:
        raise ValueError(
            "dedup_frames=True requires device_cache (the dedup epoch runs "
            "over unique cached frame indices)")
    if pose_graph and not (is_tuple and dataset.include_vos):
        raise ValueError("pose_graph needs an MF dataset with include_vos "
                         "(the VOs between each tuple's frames)")
    if stochastic and (quantize or fold_bn):
        raise ValueError(
            "--quantize/--fold_bn are incompatible with --eval_dropout")
    if quantize and fold_bn:
        raise ValueError("--fold_bn is implied by --quantize; pick one")
    if fuse_requant and not (quantize and calib_batches):
        raise ValueError(
            "--fuse_requant needs --quantize int8 with --calibrate N "
            "(static scales on every site)")
    # dynamic-scale int8 quantizes each site at its batch's absmax, so a
    # frame's pose depends on its batchmates: no dedup epoch
    dynamic_q = quantize and not calib_batches
    if dedup_frames and (dynamic_q or stochastic):
        raise ValueError(
            "dedup_frames needs a per-frame (MapNet-style) tuple model: "
            "no --eval_dropout (stochastic draws are per tuple slot) "
            "and no dynamic-scale int8 (--quantize without --calibrate "
            "quantizes at the batch absmax, coupling rows)")
    prequant = bool(fuse_requant) and use_device_cache
    pose_m, pose_s = (
        pose_stats if pose_stats is not None else (np.zeros(3), np.ones(3))
    )
    # data-parallel eval: batches shard over the group's ranks; the full
    # batch on every rank when they do not divide it
    dp = mesh if mesh is not None and mesh.active else None
    if dp is not None and batch_size % dp.world_size:
        print(f"eval: batch_size {batch_size} not divisible by "
              f"{dp.world_size} devices; running single-device (pick a "
              f"multiple to shard)")
        dp = None
    if device_cache == "shard" and dp is None:
        raise ValueError(
            "device_cache='shard' needs a data-parallel group (a torchrun "
            "launch with batch_size divisible by the ranks)")
    model.eval()
    result = {}
    frame_buf = frame_shape = None
    cache_sharded = False
    upload_secs = 0.0
    idx_mat = tuple_index_matrix(dataset, is_tuple)

    if use_device_cache:
        frames_src = dataset.dset if is_tuple else dataset
        n_frames = len(frames_src)
        t_up = time.time()
        if isinstance(device_cache, torch.Tensor):
            frame_buf = device_cache
            # a returned shard has ceil(N/W) rows
            cache_sharded = (dp is not None and dp.world_size > 1
                             and frame_buf.shape[0] != n_frames)
        elif device_cache == "shard":
            frame_buf = upload_frames_sharded(frames_src, dp,
                                              num_workers=num_workers)
            cache_sharded = True
        elif dp is not None and dp.world_size > 1:
            frame_buf = upload_frames_global(frames_src, dp,
                                             num_workers=num_workers)
        else:
            frame_buf = upload_frames(frames_src, device,
                                      num_workers=num_workers)
        if frame_buf.device.type == "cuda":
            torch.cuda.synchronize(frame_buf.device)
        upload_secs = time.time() - t_up
    sharded_gather = make_sharded_gather(dp) if cache_sharded else None
    row_cache = (frame_buf is not None and frame_buf.dtype == torch.int8
                 and frame_buf.dim() == 2)
    if row_cache and not prequant:
        raise ValueError("an int8 row cache (the device_frames of a "
                         "fuse_requant run) needs fuse_requant")

    net = getattr(model, "posenet", model)
    if quantize or fold_bn:
        read = None
        if frame_buf is not None and not row_cache:
            if cache_sharded:
                def read(rows):
                    # the full batch on every rank: the sharded gather's
                    # shards, all-gathered (rows padded to a multiple of W)
                    pad = -len(rows) % dp.world_size
                    idx = torch.cat([rows, rows[-1:].repeat(pad)])
                    return dp.all_gather(sharded_gather(frame_buf, idx))[
                        :len(rows)]
            else:
                def read(rows):
                    return frame_buf.index_select(0, rows)
        qtree = _serving_tree(
            net, quantize, quantize_heads, calib_batches,
            _calibration_batches(
                dataset, is_tuple, read, idx_mat, calib_batches, batch_size,
                preprocess, device, num_workers))
        # int8 serves in bf16; BN folding keeps the model's own dtype
        dtype = torch.bfloat16 if quantize else net.fc_feat.compute_dtype
        if prequant:
            # the prequantized row cache (JAX: cli/eval.py:304-365): the
            # S2D stem over rows made once per scene, inside upload_secs
            net = QuantizedPoseNet(convert_stem_s2d(qtree), dtype,
                                   fused=True).to(device)
            t_up = time.time()
            if row_cache:
                # a reused row cache; its frame geometry from one probe
                frame_shape = s2d_frame_shape(_probe_frames(
                    frames_src, len(frames_src), float("inf")).shape)
                if np.prod(frame_shape) != frame_buf.shape[1]:
                    raise ValueError(
                        f"the row cache's rows of {frame_buf.shape[1]} "
                        f"bytes are not the dataset's frames {frame_shape}")
            else:
                frame_shape = s2d_frame_shape(tuple(frame_buf.shape[1:]))
                frame_buf = quantize_rows(frame_buf, net, preprocess)
                if frame_buf.device.type == "cuda":
                    torch.cuda.synchronize(frame_buf.device)
            upload_secs += time.time() - t_up
        else:
            net = QuantizedPoseNet(qtree, dtype,
                                   fused=bool(fuse_requant)).to(device)
    # batches run T-FOLDED, (B*T, H, W, C), through the per-frame PoseNet
    # (MapNet is exactly this fold) and fold back to (B, T, 6)
    step = make_step(net, preprocess, steps, dp)

    if use_device_cache:
        if is_tuple:
            targ = np.stack([dataset._poses_for(ti) for ti in idx_mat])
        else:
            tt = getattr(frames_src, "target_transform", None)
            targ = np.stack([
                np.asarray(tt(p) if tt is not None else p, np.float32)[None]
                for p in frames_src.poses])
        t_start = time.time()
        plan = plan_epoch(idx_mat, batch_size,
                          per_frame=is_tuple and not (dynamic_q or stochastic),
                          dedup_frames=dedup_frames)
        if progress and (dp is None or dp.rank == 0):
            print(f"eval: {plan.mode} epoch, {len(plan.windows)} windows of "
                  f"{plan.window_frames} frames from the device cache"
                  + (f" over {dp.world_size} ranks" if dp is not None
                     else ""))
        outs = run_epoch(plan, frame_buf, step, frame_shape,
                         dropout_seed=seed if stochastic else None, mesh=dp,
                         sharded_gather=sharded_gather)
        output = tuple_outputs(plan, outs.to("cpu", torch.float64).numpy())
        elapsed = time.time() - t_start
        result.update(device_frames=frame_buf, upload_secs=upload_secs,
                      frames_computed=plan.frames_computed,
                      dedup_slice=plan.mode == "slice")
    else:
        # outputs stay on the device: one readback after the loop instead
        # of a host sync per batch
        dev_outputs = []
        host_targets = []
        source = dataset if is_tuple else _Single(dataset)
        local_bs = batch_size
        if dp is not None:
            # this rank's rows of every (padded) global batch; the step
            # returns the whole batch's poses
            local_bs = batch_size // dp.world_size
            source = _Rows(source, _rank_rows(len(idx_mat), batch_size, dp))
        loader = Loader(source, local_bs, shuffle=False, drop_last=False,
                        num_workers=num_workers)
        t_start = time.time()
        with torch.inference_mode():
            for batch_idx, (imgs, poses, _) in enumerate(loader):
                if progress and batch_idx % 10 == 0 and (
                        dp is None or dp.rank == 0):
                    print(f"Batch {batch_idx} / {len(loader)}")
                x = torch.from_numpy(imgs.reshape(-1, *imgs.shape[2:]))
                gen = (window_generator(seed, batch_idx, device)
                       if stochastic else None)
                dev_outputs.append(step(x.to(device), gen))
                host_targets.append(torch.from_numpy(poses))
            output = torch.cat(dev_outputs)
            targ = torch.cat(host_targets)
            if dp is not None:
                # every rank's target rows of every batch, in batch order
                targ = gather_windows(targ.to(device).reshape(
                    (len(loader), local_bs) + tuple(targ.shape[1:])), dp)
                targ = targ.reshape((-1,) + tuple(targ.shape[2:]))
            output = output.to("cpu", torch.float64).numpy()
            targ = targ.to("cpu").numpy()
        elapsed = time.time() - t_start
    # drop the last batch's pad rows
    S = len(idx_mat)
    output = output[:S]
    targ = np.asarray(targ[:S], np.float64)

    # log-q -> unit quaternion
    out7 = np.concatenate([output[..., :3], qexp_np(output[..., 3:])], axis=-1)
    targ_abs = targ[:, :steps]
    targ7 = np.concatenate(
        [targ_abs[..., :3], qexp_np(targ_abs[..., 3:])], axis=-1
    )

    if pose_graph:
        # targets carry [steps abs | VOs]; every window in one batched
        # solve on the device (JAX: cli/eval.py:676-691)
        t_pgo = time.time()
        vos_log = targ[:, steps:]
        vos7 = np.concatenate(
            [vos_log[..., :3], qexp_np(vos_log[..., 3:])], axis=-1)
        out7 = optimize_poses_batch(
            torch.from_numpy(out7).to(device, torch.float32),
            torch.from_numpy(vos7).to(device, torch.float32),
            fc=fc_vos, **(pgo_weights or {}),
        ).to("cpu", torch.float64).numpy()
        result["pgo_secs"] = time.time() - t_pgo

    # un-normalize translations
    out7[..., :3] = out7[..., :3] * pose_s + pose_m
    targ7[..., :3] = targ7[..., :3] * pose_s + pose_m

    # middle-frame selection into the global arrays
    pred_poses = np.zeros((L, 7))
    targ_poses = np.zeros((L, 7))
    mid = idx_mat[:, steps // 2]
    pred_poses[mid] = out7[:, steps // 2]
    targ_poses[mid] = targ7[:, steps // 2]
    t_err = translation_error(pred_poses[:, :3], targ_poses[:, :3])
    q_err = quaternion_angular_error(pred_poses[:, 3:], targ_poses[:, 3:])
    result.update({
        "pred_poses": pred_poses,
        "targ_poses": targ_poses,
        "t_err": t_err,
        "q_err": q_err,
        "median_t": float(np.median(t_err)),
        "mean_t": float(np.mean(t_err)),
        "median_q": float(np.median(q_err)),
        "mean_q": float(np.mean(q_err)),
        "images_per_sec": S * steps / max(elapsed, 1e-9),
    })
    return result


def _serving_tree(posenet, quantize: bool, quantize_heads: bool,
                  calib_batches: int, batches) -> dict:
    """The int8 (calibrated on the iterable ``batches`` when
    ``calib_batches``) or BN-folded tree of ``posenet``'s weights."""
    variables = state_dict_to_variables(posenet.state_dict())
    stage_sizes = posenet.feature_extractor.stage_sizes
    if not quantize:
        return fold_posenet_variables(variables, stage_sizes)
    qtree = quantize_posenet_variables(variables, stage_sizes,
                                       quantize_heads=quantize_heads)
    if calib_batches:
        qtree = calibrate_activation_scales(qtree, batches)
    return qtree


def _calibration_batches(dataset, is_tuple: bool, read, idx_mat,
                         n: int, batch_size: int, preprocess, device,
                         num_workers: int):
    """The first ``n`` eval batches, folded to (B*T, H, W, C) and
    preprocessed on ``device``: ``read(frame_indices)`` from the uploaded
    frames when given (rows ``idx_mat[i*B:(i+1)*B]``; a short last batch
    stays short where the loader repeats its last tuple, which leaves every
    absmax as it is), else decoded by a loader as the JAX package does.
    Every rank of a data-parallel eval reads whole batches, so every rank
    calibrates the same scales. A generator: nothing runs until it is
    iterated."""
    if read is not None:
        for i in range(min(n, -(-len(idx_mat) // batch_size))):
            rows = torch.from_numpy(
                idx_mat[i * batch_size:(i + 1) * batch_size].reshape(-1))
            x = read(rows.to(device))
            yield preprocess(x) if preprocess is not None else x
        return
    loader = iter(Loader(dataset if is_tuple else _Single(dataset),
                         batch_size, shuffle=False, drop_last=False,
                         num_workers=num_workers))
    try:
        for _, (imgs, _poses, _pad) in zip(range(n), loader):
            x = torch.from_numpy(imgs.reshape(-1, *imgs.shape[2:])).to(device)
            yield preprocess(x) if preprocess is not None else x
    finally:
        loader.close()   # stops its prefetch thread


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Evaluation script for PoseNet and MapNet (PyTorch)"
    )
    parser.add_argument("--dataset", type=str, required=True,
                        choices=("7Scenes", "RobotCar", "synth"))
    parser.add_argument("--scene", type=str, default="synth")
    parser.add_argument(
        "--weights", type=str, required=True,
        help="a port checkpoint (epoch_*.pth.tar), an upstream .pth.tar, or "
        "Flax variables as an .npz (save_npz format)")
    parser.add_argument("--model", required=True,
                        choices=("posenet", "mapnet", "mapnet++"))
    parser.add_argument("--trunk", default="resnet34",
                        choices=tuple(TRUNKS),
                        help="feature extractor (reference fixes resnet34)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device, e.g. cuda:1 or cpu (default: "
                        "the first CUDA device; fails when there is none)")
    parser.add_argument("--config_file", type=str, required=True)
    parser.add_argument("--val", action="store_true")
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument(
        "--pose_graph", action="store_true",
        help="MapNet+PGO: fuse each window's poses with its VOs by a batched "
        "Gauss-Newton on the device after the epoch")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--data_path", type=str, default="data/deepslam_data")
    parser.add_argument("--asset_root", type=str, default="data")
    parser.add_argument(
        "--bf16", action="store_true",
        help="bfloat16 compute at the JAX package's placement (convs and "
        "dense layers in bf16, BatchNorm and residuals in float32)")
    parser.add_argument(
        "--host_normalize", action="store_true",
        help="normalize images on the host (float32 transfer) instead of the "
        "default device-side normalize (uint8 transfer, 4x smaller)",
    )
    parser.add_argument(
        "--eval_dropout", action="store_true",
        help="keep dropout active at eval (the reference's ungated F.dropout "
        "quirk; its published numbers include it), seeded by the config")
    parser.add_argument(
        "--raw_bayer", action="store_true",
        help="RobotCar raw Bayer mosaics + on-device "
        "demosaic/[undistort]/resize/normalize",
    )
    parser.add_argument(
        "--camera_models_dir", type=str, default=None,
        help="RobotCar camera model dir for on-device undistortion with "
        "--raw_bayer (omit to skip undistortion)")
    parser.add_argument(
        "--cache_frames", type=float, default=0.0, metavar="GB",
        help="decoded-frame RAM cache: repeated passes over a split decode "
        "each frame once",
    )
    parser.add_argument(
        "--native_loader", action="store_true",
        help="decode+resize images with the C++ batch decoder "
        "(geomapnet_tpu_torch.native) instead of PIL: the fast host IO path")
    parser.add_argument(
        "--device_cache", nargs="?", const=True, default=False,
        choices=["shard"],
        help="upload the whole scene's frames to the device once and run "
        "the epoch from there (no per-batch decode or upload); 'shard' "
        "keeps the frames sharded over the ranks of a torchrun launch "
        "(capacity scales with the rank count; one reduce-scatter a "
        "window)",
    )
    parser.add_argument(
        "--no_frame_dedup", action="store_true",
        help="with --device_cache: keep the tuple epoch instead of the "
        "default frame-dedup epoch (each unique frame's forward computed "
        "once, per-tuple poses gathered from the pose table)",
    )
    parser.add_argument(
        "--quantize", choices=["int8"], default=None,
        help="run the trunk with int8 post-training quantization "
        "(models/quant.py; int8 convs on the hand-written CUDA kernel, "
        "bf16 heads)")
    parser.add_argument(
        "--fold_bn", action="store_true",
        help="serving float path: fold BatchNorm into conv weights+bias "
        "(no quantization; implied by --quantize)")
    parser.add_argument(
        "--calibrate", type=int, default=0, metavar="N",
        help="with --quantize: observe N eval batches to bake static "
        "activation scales (default 0 = dynamic per-batch scales)")
    parser.add_argument(
        "--quantize_heads", action="store_true",
        help="with --quantize: run the fc_feat head matmul in int8 too")
    parser.add_argument(
        "--fuse_requant", action="store_true",
        help="with --quantize + --calibrate: int8 dataflow, requantization "
        "fused into each conv's epilogue; with --device_cache the scene is "
        "cached as prequantized space-to-depth int8 rows")
    args = parser.parse_args(argv)
    if args.raw_bayer and args.dataset != "RobotCar":
        parser.error("--raw_bayer requires --dataset RobotCar")
    if Path(args.weights).suffix not in (".npz", ".tar", ".pth"):
        parser.error("--weights must be a .pth.tar / .pth checkpoint or an "
                     ".npz of Flax variables")
    device, mesh = _join_launch(args.device)
    if args.device_cache == "shard" and mesh is None:
        parser.error("--device_cache shard needs a data-parallel group: "
                     "launch the eval with torchrun --nproc_per_node=N")
    is_main = mesh is None or mesh.rank == 0

    # fp32 eval: the JAX CLI's default dtype is float32, and cuDNN convs
    # would otherwise run in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    config = parse_ini(args.config_file)
    fc_vos = args.dataset == "RobotCar"
    use_tuples = args.model.startswith("mapnet") or args.pose_graph
    model, _ = build_model("mapnet" if use_tuples else "posenet", config,
                           trunk=args.trunk, dtype=dtype)
    kind = load_weights(args.weights, model)
    model.to(device=device, memory_format=torch.channels_last)
    train = not args.val
    if is_main:
        print(f"Loaded weights from {args.weights} ({kind})")
        print(f"Running {args.model} on {'TRAIN' if train else 'VAL'} data "
              f"on {device}" + ("" if mesh is None else
                                f" and {mesh.world_size - 1} more ranks "
                                f"({mesh.backend})"))

    data_path = (
        args.data_path if args.dataset == "synth"
        else f"{args.data_path}/{args.dataset}"
    )
    if args.raw_bayer:
        preprocess = build_raw_device_preprocess(
            args.scene, args.asset_root, dtype=dtype,
            camera_models_dir=args.camera_models_dir)
    elif args.host_normalize:
        preprocess = None
    else:
        preprocess = build_device_preprocess(args.dataset, args.scene,
                                             args.asset_root, dtype=dtype)
    tf = None if args.raw_bayer else build_transform(
        args.dataset, args.scene, config, args.asset_root,
        train=False, seed=config.seed, keep_uint8=preprocess is not None,
    )
    frames = build_frame_dataset(
        args.dataset, args.scene, data_path, train, config, transform=tf,
        real=config.real if use_tuples else False,
        asset_root=args.asset_root,
        vo_lib=config.vo_lib if args.pose_graph else None,
        raw_bayer=args.raw_bayer, native_loader=args.native_loader,
        cache_gb=args.cache_frames,
    )
    if use_tuples:
        gt_frames = None
        if args.pose_graph and config.real:
            # VO poses in the frames: the absolute targets come from the
            # ground truth (JAX: cli/eval.py:933-947)
            gt_frames = build_frame_dataset(
                args.dataset, args.scene, data_path, train, config,
                skip_images=True, asset_root=args.asset_root)
        dataset = MF(
            frames, steps=config.steps, skip=config.skip,
            variable_skip=config.variable_skip,
            include_vos=args.pose_graph, real=config.real and args.pose_graph,
            gt_dataset=gt_frames,
            vo_func=vos_logq_fc_np if fc_vos else vos_logq_np,
            seed=config.seed,
        )
    else:
        dataset = frames
    if args.dataset == "synth":
        pose_stats = (np.zeros(3), np.ones(3))
    else:
        pose_stats = tuple(np.loadtxt(
            Path(args.asset_root) / args.dataset / args.scene
            / "pose_stats.txt"))

    pgo_weights = dict(
        sax=config.s_abs_trans, saq=config.s_abs_rot,
        srx=config.s_rel_trans, srq=config.s_rel_rot,
    ) if args.pose_graph else None

    results = evaluate(
        model, dataset, device, batch_size=args.batch_size,
        pose_stats=pose_stats, pose_graph=args.pose_graph, fc_vos=fc_vos,
        pgo_weights=pgo_weights, preprocess=preprocess,
        stochastic=args.eval_dropout, seed=config.seed,
        num_workers=config.num_workers,
        device_cache=args.device_cache,
        dedup_frames=False if args.no_frame_dedup else None,
        quantize=args.quantize == "int8",
        fold_bn=args.fold_bn,
        calib_batches=args.calibrate,
        quantize_heads=args.quantize_heads,
        fuse_requant=args.fuse_requant,
        mesh=mesh,
    )
    if not is_main:   # every rank holds the same result; rank 0 reports
        return results

    print(
        "Error in translation: median {:3.2f} m,  mean {:3.2f} m\n"
        "Error in rotation: median {:3.2f} degrees, mean {:3.2f} degree".format(
            results["median_t"], results["mean_t"],
            results["median_q"], results["mean_q"],
        )
    )
    print(f"Eval throughput: {results['images_per_sec']:.1f} images/sec "
          f"on {device}")
    if args.device_cache:
        print(f"Device cache: upload {results['upload_secs']:.2f} s, "
              f"{results['frames_computed']} frames computed, "
              f"slice epoch {results['dedup_slice']}")
    if args.pose_graph:
        print(f"PGO: {results['pgo_secs']:.3f} s on {device}")

    if args.output_dir:
        out = Path(args.output_dir).expanduser()
        out.mkdir(parents=True, exist_ok=True)
        model_name = args.model + ("_pgo" if args.pose_graph else "")
        name = f"{args.dataset}_{args.scene}_{model_name}"
        with open(out / f"{name}.pkl", "wb") as f:
            pickle.dump({"targ_poses": results["targ_poses"],
                         "pred_poses": results["pred_poses"]}, f)
        with open(out / f"{name}_metrics.json", "w") as f:
            json.dump({
                k: results[k] for k in
                ("median_t", "mean_t", "median_q", "mean_q",
                 "images_per_sec")
            }, f, indent=2)
        print(f"{out / name}.pkl / _metrics.json saved")
    return results


def _join_launch(name: str | None):
    """(device, group) of this process: under a ``torchrun`` launch (its
    ``RANK`` / ``WORLD_SIZE`` set) the process joins the group, NCCL on
    ``cuda:LOCAL_RANK`` unless ``name`` asks for the CPU (then gloo);
    otherwise ``pick_device(name)`` and no group. The counterpart of the
    JAX CLI's evaluating over every local device."""
    from ..parallel import initialize_distributed, local_device, make_mesh

    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return pick_device(name), None
    if name is None:
        device = local_device()
    else:
        device = torch.device(name)
    initialize_distributed(
        backend="nccl" if device.type == "cuda" else "gloo",
        device=device if device.type == "cuda" else None)
    return device, make_mesh(device)


if __name__ == "__main__":
    main()
