"""Training CLI for PoseNet, MapNet and MapNet++.

The PyTorch counterpart of :mod:`geomapnet_tpu.cli.train` (upstream
scripts/train.py): the same flags, ``.ini`` semantics and experiment naming,
on one device or data-parallel over several::

    python -m geomapnet_tpu_torch.cli.train --dataset 7Scenes --scene heads \\
        --config_file configs/mapnet.ini --model mapnet \\
        --learn_beta --learn_gamma --data_path <root> --asset_root <assets>

MapNet++ fine-tunes a trained MapNet on the test split's VOs (or GPS
positions, ``vo_lib = gps``) beside the labeled train split, from the
MapNet checkpoint's weights (``--checkpoint`` without ``--resume_optim``)::

    python -m geomapnet_tpu_torch.cli.train --dataset RobotCar --scene loop \\
        --model mapnet++ --config_file configs/mapnet++_RobotCar.ini \\
        --checkpoint logs/<mapnet experiment>/epoch_300.pth.tar \\
        --raw_bayer --device_cache --learn_beta --learn_gamma ...

Checkpoints ``logs/<experiment>/epoch_*.pth.tar`` load into
``geomapnet_tpu_torch.cli.eval --weights``. ``--device`` defaults to the
first CUDA device and fails when there is none; ``--device cpu`` trains on
the CPU. TF32 stays off (float32 means float32, as in eval).

``--device_cache`` trains from the device frame cache (each split uploaded
once, batches gathered on the device by index), ``--ingest_overlap``
overlaps its upload with the first epoch, ``--steps_per_launch K`` runs K
steps per launch (a CUDA graph on the card) and ``--bn_bf16_bwd`` gives
BatchNorm the bfloat16 backward, each with the JAX CLI's meaning. RobotCar
trains on its processed RGB frames, or with ``--raw_bayer`` on the raw
mosaics, demosaiced on the device (and undistorted there with
``--camera_models_dir``). ``--native_loader`` decodes (and resizes) the
frames with the C++ batch decoder (:mod:`geomapnet_tpu_torch.native`)
instead of PIL, also for the device cache's upload; it fails with the
compiler's message where the decoder cannot be built.

``--distributed`` trains data-parallel, one rank per card, under
``torchrun`` (which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the
rendezvous address): rank ``r`` trains on ``cuda:LOCAL_RANK`` (gloo ranks
on the CPU with ``--device cpu``), each loads ``batch_size / N`` rows of
every global batch, and only rank 0 writes ``log.txt``, ``metrics.jsonl``
and checkpoints::

    torchrun --nproc_per_node=8 -m geomapnet_tpu_torch.cli.train \
        --distributed --dataset RobotCar --scene loop --model mapnet \
        --config_file configs/mapnet.ini --raw_bayer \
        --device_cache shard --steps_per_launch 5 ...

``--device_cache shard`` keeps the frames sharded over the ranks;
``--no_mesh`` trains one process alone, and is ignored (as in the JAX
CLI) when several processes run. Flags of the JAX CLI that the port does
not run yet are refused, each naming the ROADMAP.md item that ports it.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import torch

from ..train.checkpoint import latest_checkpoint, load_weights
from ..train.loop import Trainer
from .builders import (
    TRUNKS,
    build_criteria,
    build_datasets,
    build_device_preprocess,
    build_model,
    build_raw_device_preprocess,
    experiment_name,
    pick_device,
)
from .config import parse_ini

__all__ = ["main"]

# flags of the JAX CLI that the port refuses, and the ROADMAP.md item that
# ports each
_UNPORTED_FLAGS = {
    "tensorboard": "Queue 1, item 18 (aux; the card's machine has no "
                   "tensorboard package)",
}


def main(argv=None) -> Trainer:
    """Parse ``argv``, train, and return the :class:`Trainer`."""
    parser = argparse.ArgumentParser(
        description="Training script for PoseNet, MapNet and MapNet++ "
        "(PyTorch)"
    )
    parser.add_argument("--dataset", type=str, required=True,
                        choices=("7Scenes", "RobotCar", "synth"))
    parser.add_argument("--scene", type=str, default="synth")
    parser.add_argument("--config_file", type=str, required=True)
    parser.add_argument("--model", required=True,
                        choices=("posenet", "mapnet", "mapnet++"))
    parser.add_argument("--trunk", default="resnet34", choices=tuple(TRUNKS),
                        help="feature extractor (reference fixes resnet34)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device, e.g. cuda:1 or cpu (default: "
                        "the first CUDA device; fails when there is none)")
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--learn_beta", action="store_true")
    parser.add_argument("--learn_gamma", action="store_true")
    parser.add_argument("--resume_optim", action="store_true")
    parser.add_argument(
        "--auto_resume", action="store_true",
        help="resume from the latest epoch_*.pth.tar in the experiment's "
        "logdir if one exists (full state: optimizer, epoch, criterion)")
    parser.add_argument("--suffix", type=str, default="")
    parser.add_argument("--data_path", type=str, default="data/deepslam_data")
    parser.add_argument("--asset_root", type=str, default="data")
    parser.add_argument(
        "--pretrained_npz", type=str, default=None,
        help="weights merged over the fresh model: a Flax .npz, an upstream "
        ".pth.tar or a torchvision state dict (trunk only: the heads keep "
        "their init); ignored after a restored checkpoint")
    parser.add_argument(
        "--bf16", action="store_true",
        help="bfloat16 compute at the JAX package's placement (convs and "
        "dense layers in bf16, BatchNorm and residuals in float32)")
    parser.add_argument(
        "--no_mesh", action="store_true",
        help="train this process alone (ignored when several processes "
        "run: a multi-process run always uses the group)")
    parser.add_argument(
        "--distributed", action="store_true",
        help="join torch.distributed for data-parallel training under "
        "torchrun (one rank per card: NCCL; gloo with --device cpu); the "
        "rendezvous comes from the launcher's environment")
    parser.add_argument(
        "--host_normalize", action="store_true",
        help="normalize images on the host (float32 transfer) instead of the "
        "default device-side normalize (uint8 transfer, 4x smaller)")
    parser.add_argument(
        "--raw_bayer", action="store_true",
        help="RobotCar only: raw Bayer mosaics, demosaic/[undistort]/resize/"
        "normalize on the device (no offline image processing)")
    parser.add_argument(
        "--camera_models_dir", type=str, default=None,
        help="RobotCar camera model dir for on-device undistortion with "
        "--raw_bayer (omit to skip undistortion)")
    parser.add_argument(
        "--native_loader", action="store_true",
        help="decode+resize images with the C++ batch decoder "
        "(geomapnet_tpu_torch.native) instead of PIL: the fast host IO path")
    parser.add_argument(
        "--cache_frames", type=float, default=0.0, metavar="GB",
        help="decoded-frame RAM cache per split: decode is paid once "
        "(skipped for jittered transforms)")
    parser.add_argument(
        "--device_cache", nargs="?", const=True, default=False,
        choices=["shard"],
        help="upload each split's frames to the device once and feed "
        "training by on-device index gather: no host decode or image "
        "transfer after the upload (replicated over the ranks, each rank "
        "decoding its share). '--device_cache shard' keeps the stack "
        "frame-sharded over the ranks: capacity scales with their count")
    parser.add_argument(
        "--ingest_overlap", action="store_true",
        help="with --device_cache: train the first epoch from the image "
        "loader while staging its frames; the cache is uploaded at the end "
        "of that epoch instead of before the first step")
    parser.add_argument(
        "--steps_per_launch", type=int, default=1, metavar="K",
        help="with --device_cache, K optimizer steps per launch (a CUDA "
        "graph of K steps on the card): the same updates, 1/K the host "
        "dispatch")
    parser.add_argument(
        "--bn_bf16_bwd", action="store_true",
        help="bfloat16 BatchNorm backward: the forward and running "
        "statistics unchanged, the backward's elementwise math in bfloat16")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="torch.profiler trace of the first batches")
    parser.add_argument(
        "--debug_nans", action="store_true",
        help="anomaly detection in the backward, and a finite-loss check at "
        "every print point")
    parser.add_argument(
        "--grad_accum", type=int, default=1,
        help="gradient-accumulation microbatches per optimizer step: the "
        ".ini batch_size stays the EFFECTIVE batch")
    for flag, where in _UNPORTED_FLAGS.items():
        parser.add_argument(f"--{flag}", action="store_true",
                            help=f"not ported yet (ROADMAP.md, {where})")
    args = parser.parse_args(argv)

    for flag, where in _UNPORTED_FLAGS.items():
        if getattr(args, flag):
            parser.error(f"--{flag} is not ported yet (ROADMAP.md, {where})")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not args.distributed:
        parser.error("the launcher started several processes "
                     f"(WORLD_SIZE={os.environ['WORLD_SIZE']}): pass "
                     "--distributed, or they would train independently")
    if args.raw_bayer and args.dataset != "RobotCar":
        parser.error("--raw_bayer requires --dataset RobotCar")
    config = parse_ini(args.config_file)
    if config.visdom:
        parser.error("visdom = yes (the TensorBoard writer) is not ported yet "
                     "(ROADMAP.md, Queue 1, item 18); set visdom = no")
    if args.distributed:
        from ..parallel import initialize_distributed, local_device

        device = (local_device() if args.device is None
                  else torch.device(args.device))
        idx, count = initialize_distributed(
            backend="nccl" if device.type == "cuda" else "gloo",
            device=device if device.type == "cuda" else None)
        print(f"torch.distributed: process {idx}/{count} on {device}")
    else:
        device = pick_device(args.device)

    # float32 means float32: cuDNN convs and matmuls would otherwise run TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    model, _ = build_model(args.model, config, trunk=args.trunk, dtype=dtype,
                           bn_bf16_bwd=args.bn_bf16_bwd)
    train_criterion, val_criterion = build_criteria(
        args.model, config, args.learn_beta, args.learn_gamma)
    data_path = (args.data_path if args.dataset == "synth"
                 else f"{args.data_path}/{args.dataset}")
    if args.raw_bayer:
        preprocess = build_raw_device_preprocess(
            args.scene, args.asset_root, dtype=dtype,
            camera_models_dir=args.camera_models_dir)
    elif args.host_normalize:
        preprocess = None
    else:
        preprocess = build_device_preprocess(args.dataset, args.scene,
                                             args.asset_root, dtype=dtype)
    train_set, val_set = build_datasets(
        args.model, args.dataset, args.scene, data_path, config,
        asset_root=args.asset_root,
        keep_uint8=preprocess is not None and not args.raw_bayer,
        raw_bayer=args.raw_bayer, native_loader=args.native_loader,
        cache_gb=args.cache_frames,
    )

    name = experiment_name(args.dataset, args.scene, args.model,
                           args.config_file, args.learn_beta,
                           args.learn_gamma, args.suffix)
    checkpoint, resume_optim = args.checkpoint, args.resume_optim
    if args.auto_resume and checkpoint is None:
        latest = latest_checkpoint(Path("logs") / name)
        if latest is not None:
            checkpoint, resume_optim = str(latest), True
            print(f"Auto-resuming from {latest}")
    trainer = Trainer(
        model, train_criterion, config, name, train_set, val_set,
        val_criterion=val_criterion, checkpoint=checkpoint,
        resume_optim=resume_optim, device=device,
        use_mesh=not args.no_mesh,
        profile_dir=args.profile_dir, debug_nans=args.debug_nans,
        preprocess=preprocess, accum_steps=args.grad_accum,
        device_cache=args.device_cache,
        steps_per_launch=args.steps_per_launch,
        ingest_overlap=args.ingest_overlap,
    )

    if args.pretrained_npz and checkpoint is not None:
        # a restored checkpoint already holds trained weights; importing on
        # top would clobber them (an --auto_resume restart of a run launched
        # with --pretrained_npz)
        print(f"Checkpoint {checkpoint} restored; ignoring --pretrained_npz")
    elif args.pretrained_npz:
        kind = load_weights(args.pretrained_npz, trainer.model)
        print(f"Imported pretrained weights from {args.pretrained_npz} "
              f"({kind})")

    trainer.train_val()
    return trainer


if __name__ == "__main__":
    main()
