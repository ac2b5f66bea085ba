"""Training CLI for PoseNet, MapNet and MapNet++.

The PyTorch counterpart of :mod:`geomapnet_tpu.cli.train` (upstream
scripts/train.py): the same flags, ``.ini`` semantics and experiment naming,
on one device::

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
``--camera_models_dir``).

Flags of the JAX CLI that the port does not run yet are refused, each
naming the ROADMAP.md item that ports it (``--device_cache shard`` among
them); ``--no_mesh`` is accepted and does nothing (the port trains on one
card).
"""

from __future__ import annotations

import argparse
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
    "native_loader": "Queue 1, item 15 (native decoder)",
    "distributed": "Queue 1, item 17 (multi-GPU)",
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
    parser.add_argument("--no_mesh", action="store_true",
                        help="accepted for parity; the port runs on one card")
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
        "--cache_frames", type=float, default=0.0, metavar="GB",
        help="decoded-frame RAM cache per split: decode is paid once "
        "(skipped for jittered transforms)")
    parser.add_argument(
        "--device_cache", nargs="?", const=True, default=False,
        choices=["shard"],
        help="upload each split's frames to the device once and feed "
        "training by on-device index gather: no host decode or image "
        "transfer after the upload ('shard', the frame-sharded cache, is "
        "not ported yet: ROADMAP.md, Queue 1, item 17)")
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
    if args.device_cache == "shard":
        parser.error("--device_cache shard is not ported yet (ROADMAP.md, "
                     "Queue 1, item 17: the frame-sharded cache needs "
                     "several GPUs)")
    if args.raw_bayer and args.dataset != "RobotCar":
        parser.error("--raw_bayer requires --dataset RobotCar")
    config = parse_ini(args.config_file)
    if config.visdom:
        parser.error("visdom = yes (the TensorBoard writer) is not ported yet "
                     "(ROADMAP.md, Queue 1, item 18); set visdom = no")
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
        raw_bayer=args.raw_bayer, cache_gb=args.cache_frames,
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
