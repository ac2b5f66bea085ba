"""Evaluation CLI: batched inference and median/mean pose errors.

The PyTorch counterpart of :mod:`geomapnet_tpu.cli.eval` for its loader path
(upstream scripts/eval.py): per-frame L2 translation error and quaternion
angular error, median and mean, over the middle frame of each tuple, with
translations un-normalized by the scene's ``pose_stats.txt``.

Ported so far: RobotCar raw-Bayer mosaics through the device pipeline, with
PoseNet or MapNet weights from a Flax ``.npz``::

    python -m geomapnet_tpu_torch.cli.eval --dataset RobotCar --scene loop \\
        --raw_bayer --model mapnet --config_file configs/mapnet.ini \\
        --weights weights.npz --val --data_path <root> --asset_root <assets>

The device frame cache, pose-graph optimization, int8 / BN-folded / bf16
serving, eval-time dropout and the trajectory plot are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from ..data.composite import MF
from ..data.loader import Loader
from ..geometry.metrics import quaternion_angular_error, translation_error
from ..geometry.rotations import qexp_np
from ..models.flax_import import load_npz, variables_to_state_dict
from .builders import (
    TRUNKS,
    build_frame_dataset,
    build_model,
    build_raw_device_preprocess,
)
from .config import parse_ini

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


def evaluate(model: torch.nn.Module, dataset, device: torch.device,
             **kwargs) -> dict:
    """Run batched evaluation of ``model`` over an MF (or plain frame)
    dataset on ``device``.

    ``preprocess`` maps the uploaded raw batch to model input on the device
    (e.g. the raw-Bayer pipeline). Returns {"pred_poses", "targ_poses",
    "t_err", "q_err", "median_t", "median_q", "mean_t", "mean_q",
    "images_per_sec"}.

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
    progress: bool = True,
    preprocess=None,
    num_workers: int = 1,
) -> dict:
    is_tuple = isinstance(dataset, MF)
    L = len(dataset.dset) if is_tuple else len(dataset)
    steps = dataset.steps if is_tuple else 1
    # Tuple batches upload T-FOLDED, (B*T, H, W[, C]): a free host-side view;
    # the shared-weight PoseNet runs on the folded axis and the poses fold
    # back to (B, T, 6) (MapNet is exactly this fold).
    posenet = getattr(model, "posenet", None)
    fold_T = steps if (is_tuple and posenet is not None) else None

    pose_m, pose_s = (
        pose_stats if pose_stats is not None else (np.zeros(3), np.ones(3))
    )
    pred_poses = np.zeros((L, 7))
    targ_poses = np.zeros((L, 7))
    n_images = 0
    # outputs stay on the device: one readback after the loop instead of a
    # host sync per batch
    dev_outputs = []
    host_targets = []
    valids = []

    loader = Loader(dataset if is_tuple else _Single(dataset), batch_size,
                    shuffle=False, drop_last=False, num_workers=num_workers)
    model.eval()
    t_start = time.time()
    with torch.inference_mode():
        for batch_idx, (imgs, poses, pad) in enumerate(loader):
            valid = imgs.shape[0] - pad
            if progress and batch_idx % 10 == 0:
                print(f"Batch {batch_idx} / {len(loader)}")
            if fold_T is not None:
                imgs = imgs.reshape(-1, *imgs.shape[2:])
            x = torch.from_numpy(imgs).to(device)
            if not is_tuple:
                x = x[:, 0]  # PoseNet consumes (B, H, W, C)
            if preprocess is not None:
                x = preprocess(x)
            if fold_T is not None:
                out = posenet(x).reshape(-1, fold_T, 6)
            else:
                out = model(x)
            dev_outputs.append(out if out.ndim == 3 else out[:, None, :])
            targ = np.asarray(poses, np.float64)
            host_targets.append(targ if targ.ndim == 3 else targ[:, None, :])
            valids.append(valid)
            n_images += valid * steps

        output = torch.cat(dev_outputs).to("cpu", torch.float64).numpy()
    elapsed = time.time() - t_start
    targ = np.concatenate(host_targets)

    # log-q -> unit quaternion
    out7 = np.concatenate([output[..., :3], qexp_np(output[..., 3:])], axis=-1)
    targ_abs = targ[:, :steps]
    targ7 = np.concatenate(
        [targ_abs[..., :3], qexp_np(targ_abs[..., 3:])], axis=-1
    )

    # un-normalize translations
    out7[..., :3] = out7[..., :3] * pose_s + pose_m
    targ7[..., :3] = targ7[..., :3] * pose_s + pose_m

    # middle-frame selection into the global arrays (pad rows skipped)
    base = 0
    row = 0
    for batch_idx, valid in enumerate(valids):
        for b in range(valid):
            sample_idx = base + b
            if is_tuple:
                idx = dataset.get_indices(sample_idx)
                idx = idx[len(idx) // 2]
            else:
                idx = sample_idx
            pred_poses[idx] = out7[row + b, steps // 2]
            targ_poses[idx] = targ7[row + b, steps // 2]
        base += valid
        row += len(host_targets[batch_idx])
    t_err = translation_error(pred_poses[:, :3], targ_poses[:, :3])
    q_err = quaternion_angular_error(pred_poses[:, 3:], targ_poses[:, 3:])
    return {
        "pred_poses": pred_poses,
        "targ_poses": targ_poses,
        "t_err": t_err,
        "q_err": q_err,
        "median_t": float(np.median(t_err)),
        "mean_t": float(np.mean(t_err)),
        "median_q": float(np.median(q_err)),
        "mean_q": float(np.mean(q_err)),
        "images_per_sec": n_images / max(elapsed, 1e-9),
    }


def _pick_device(name: str | None) -> torch.device:
    """The card unless ``--device`` names another device; no silent CPU."""
    if name is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device is visible; pass --device cpu "
                             "to evaluate on the CPU")
        return torch.device("cuda")
    return torch.device(name)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Evaluation script for PoseNet and MapNet (PyTorch)"
    )
    parser.add_argument("--dataset", type=str, required=True,
                        choices=("RobotCar",))
    parser.add_argument("--scene", type=str, required=True)
    parser.add_argument("--weights", type=str, required=True,
                        help="Flax variables as an .npz (save_npz format)")
    parser.add_argument("--model", required=True,
                        choices=("posenet", "mapnet"))
    parser.add_argument("--trunk", default="resnet34",
                        choices=tuple(TRUNKS),
                        help="feature extractor (reference fixes resnet34)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device, e.g. cuda:1 or cpu (default: "
                        "the first CUDA device; fails when there is none)")
    parser.add_argument("--config_file", type=str, required=True)
    parser.add_argument("--val", action="store_true")
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--data_path", type=str, default="data/deepslam_data")
    parser.add_argument("--asset_root", type=str, default="data")
    parser.add_argument(
        "--raw_bayer", action="store_true",
        help="RobotCar raw Bayer mosaics + on-device "
        "demosaic/resize/normalize (the only RobotCar input ported so far)",
    )
    args = parser.parse_args(argv)
    if not args.raw_bayer:
        parser.error("only --raw_bayer RobotCar input is ported so far "
                     "(ROADMAP.md, Queue 1)")
    if Path(args.weights).suffix != ".npz":
        parser.error("--weights must be an .npz of Flax variables")
    device = _pick_device(args.device)

    # fp32 eval: the JAX CLI's default dtype is float32, and cuDNN convs
    # would otherwise run in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    config = parse_ini(args.config_file)
    use_tuples = args.model == "mapnet"
    model, _ = build_model(args.model, config, trunk=args.trunk)
    posenet = model.posenet if use_tuples else model
    posenet.load_state_dict(variables_to_state_dict(load_npz(args.weights)))
    model.to(device=device, memory_format=torch.channels_last)
    print(f"Loaded weights from {args.weights}")

    train = not args.val
    print(f"Running {args.model} on {'TRAIN' if train else 'VAL'} data "
          f"on {device}")

    preprocess = build_raw_device_preprocess(args.scene, args.asset_root)
    frames = build_frame_dataset(
        args.dataset, args.scene, f"{args.data_path}/{args.dataset}", train,
        real=config.real if use_tuples else False,
        asset_root=args.asset_root, raw_bayer=True,
    )
    dataset = (
        MF(frames, steps=config.steps, skip=config.skip,
           variable_skip=config.variable_skip, seed=config.seed)
        if use_tuples else frames
    )
    pose_stats = tuple(np.loadtxt(
        Path(args.asset_root) / args.dataset / args.scene / "pose_stats.txt"))

    results = evaluate(
        model, dataset, device, batch_size=args.batch_size,
        pose_stats=pose_stats, preprocess=preprocess,
        num_workers=config.num_workers,
    )

    print(
        "Error in translation: median {:3.2f} m,  mean {:3.2f} m\n"
        "Error in rotation: median {:3.2f} degrees, mean {:3.2f} degree".format(
            results["median_t"], results["mean_t"],
            results["median_q"], results["mean_q"],
        )
    )
    print(f"Eval throughput: {results['images_per_sec']:.1f} images/sec "
          f"on {device}")

    if args.output_dir:
        out = Path(args.output_dir).expanduser()
        out.mkdir(parents=True, exist_ok=True)
        name = f"{args.dataset}_{args.scene}_{args.model}"
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


if __name__ == "__main__":
    main()
