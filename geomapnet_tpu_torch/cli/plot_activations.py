"""Saliency visualization: |input x d(pose)/d(input)| heatmaps over frames.

The PyTorch counterpart of :mod:`geomapnet_tpu.cli.plot_activations`
(upstream scripts/plot_activations.py): a forward with gradients to the
input, the backward of ``mean(pose)``, saliency = the channel-max of
|input * grad|, jet-colormapped and alpha-blended over the un-normalized
frame, written as a video::

    python -m geomapnet_tpu_torch.cli.plot_activations --dataset 7Scenes \\
        --scene heads --model mapnet --config_file configs/mapnet.ini \\
        --weights w.npz --val --output_dir saliency \\
        --data_path <root> --asset_root <assets>

The saliency of a whole batch is one autograd backward (upstream
backpropagates frame by frame), on the card unless ``--device`` names
another device. ``--weights`` reads what the eval CLI's does
(:func:`geomapnet_tpu_torch.train.checkpoint.load_weights`). The output is
``saliency.mp4`` where imageio can write one, else ``saliency_NNNN.png``
frames through PIL, as the JAX tool does.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..data.loader import Loader
from ..train.checkpoint import load_weights, refuse_orbax
from .builders import TRUNKS, build_datasets, build_model, pick_device
from .config import parse_ini

__all__ = ["saliency_fn", "main"]


def saliency_fn(model: torch.nn.Module):
    """Batched saliency: images (N, [T,] H, W, 3) -> (N, [T,] H, W), the
    model in eval mode; one backward of the mean pose a batch."""

    def saliency(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        x = images.detach().requires_grad_(True)
        with torch.enable_grad():
            # the gradient of the mean pose output w.r.t. every input pixel
            (g,) = torch.autograd.grad(model(x).mean(), x)
        return (x.detach() * g).abs().amax(dim=-1)

    return saliency


def _jet(x: np.ndarray) -> np.ndarray:
    """Minimal jet colormap: (H, W) in [0,1] -> (H, W, 3) uint8."""
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def _blend(img: np.ndarray, s: np.ndarray) -> np.ndarray:
    """One frame: the saliency ``s`` (H, W), min-max scaled and jet-mapped,
    half over the frame ``img`` (H, W, 3) min-max scaled to uint8."""
    lo, hi = s.min(), s.max()
    heat = _jet((s - lo) / (hi - lo + 1e-12))
    base = img - img.min()
    base = (base / (base.max() + 1e-12) * 255).astype(np.uint8)
    return (0.5 * base + 0.5 * heat).astype(np.uint8)


def write_frames(frames: list, out_dir: Path) -> list[Path]:
    """``saliency.mp4`` (imageio, where it and a video backend are
    installed), else ``saliency_NNNN.png`` frames through PIL; returns the
    files written."""
    try:
        import imageio.v2 as imageio

        video = out_dir / "saliency.mp4"
        imageio.mimwrite(video, frames, fps=10)
        print(f"{video} written ({len(frames)} frames)")
        return [video]
    except (ImportError, ValueError):   # no imageio, or no video backend
        from PIL import Image

        paths = [out_dir / f"saliency_{i:04d}.png" for i in range(len(frames))]
        for path, f in zip(paths, frames):
            Image.fromarray(f).save(path)
        print(f"{len(frames)} saliency frames -> {out_dir}")
        return paths


def main(argv=None) -> list[Path]:
    """The tool on ``argv`` (default: the command line); returns the files
    written."""
    parser = argparse.ArgumentParser(description="Saliency video tool")
    parser.add_argument("--dataset", required=True,
                        choices=("7Scenes", "RobotCar", "synth"))
    parser.add_argument("--scene", default="synth")
    parser.add_argument(
        "--weights", required=True,
        help="a port checkpoint (epoch_*.pth.tar), an upstream .pth.tar, or "
        "Flax variables as an .npz (save_npz format)")
    parser.add_argument("--model", required=True,
                        choices=("posenet", "mapnet", "mapnet++"))
    parser.add_argument("--trunk", default="resnet34", choices=tuple(TRUNKS))
    parser.add_argument("--config_file", required=True)
    parser.add_argument("--val", action="store_true")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--frames", type=int, default=50)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--data_path", type=str, default="data/deepslam_data")
    parser.add_argument("--asset_root", type=str, default="data")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device, e.g. cuda:1 or cpu (default: "
                        "the first CUDA device; fails when there is none)")
    args = parser.parse_args(argv)
    try:
        refuse_orbax(args.weights)
    except ValueError as e:
        parser.error(str(e))
    device = pick_device(args.device)
    # float32 means float32: cuDNN convs would otherwise run TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    config = parse_ini(args.config_file)
    model_kind = "mapnet" if args.model.startswith("mapnet") else "posenet"
    model, _ = build_model(model_kind, config, trunk=args.trunk)
    load_weights(args.weights, model)
    model.to(device=device, memory_format=torch.channels_last)

    data_path = (args.data_path if args.dataset == "synth"
                 else f"{args.data_path}/{args.dataset}")
    train_set, val_set = build_datasets(
        model_kind, args.dataset, args.scene, data_path, config,
        asset_root=args.asset_root)
    dataset = train_set if not args.val else (val_set or train_set)

    sal_fn = saliency_fn(model)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    frames = []
    loader = Loader(dataset, args.batch_size, shuffle=False, drop_last=False)
    for imgs, _, pad in loader:
        sal = sal_fn(torch.from_numpy(imgs).to(device)).cpu().numpy()
        for img, s in zip(imgs[:imgs.shape[0] - pad],
                          sal[:imgs.shape[0] - pad]):
            if len(frames) >= args.frames:
                break
            if img.ndim == 4:   # tuple model: visualize the middle frame
                mid = img.shape[0] // 2
                img, s = img[mid], s[mid]
            frames.append(_blend(img, s))
        if len(frames) >= args.frames:
            break
    return write_frames(frames, out_dir)


if __name__ == "__main__":
    main()
