"""Data-preparation, diagnostic and export tools (one CLI, subcommands).

The PyTorch counterpart of :mod:`geomapnet_tpu.cli.tools`, with its
subcommands and flags (the reference's scripts/ toolbox):

- ``calc_pose_stats``  — write ``pose_stats.txt`` by constructing the train
  split (upstream scripts/calc_pose_stats.py);
- ``dataset_mean``     — per-channel pixel mean/variance -> ``stats.txt``
  (upstream scripts/dataset_mean.py; it stores VARIANCE, the training
  transform takes the sqrt);
- ``align_vo_poses``   — per-sequence VO->GT Horn alignment ->
  ``*_vo_stats.pkl`` (upstream scripts/align_vo_poses.py);
- ``process_robotcar_gps``    — rewrite ``gps.csv`` into the INS schema;
- ``process_robotcar_images`` — offline demosaic+undistort+resize of raw
  stereo images;
- ``time_imload`` — image loading timed: the native decoder, PIL, the host
  demosaic and the device pipeline (the demosaic kernel and the matmul
  resize), with a synchronize on the card;
- ``reverse_vo_poses`` — reverse the frame ordering of a VO pose file;
- ``export_model`` — a checkpoint as a serving artifact
  (:mod:`geomapnet_tpu_torch.serving`); ``--platforms`` names the devices
  it may be loaded on, the first of which traces it.

``plot_vo_poses`` (a matplotlib figure) is not ported yet and is refused,
naming the ROADMAP.md item that ports it.

Usage: ``python -m geomapnet_tpu_torch.cli.tools <subcommand> [options]``.
"""

from __future__ import annotations

import argparse
import csv
import pickle
import timeit
from pathlib import Path

import numpy as np

from ..geometry.align import align_camera_poses
from .config import ExperimentConfig, parse_ini

__all__ = ["main"]

# subcommands of the JAX CLI that the port refuses, and the ROADMAP.md item
# that ports each
_UNPORTED = {
    "plot_vo_poses": "Queue 1, item 18 (plots: matplotlib, which the "
                     "card's machine lacks)",
}


def calc_pose_stats(args) -> None:
    """Construct the train/GT dataset, which writes pose_stats.txt."""
    from .builders import build_frame_dataset

    config = parse_ini(args.config_file) if args.config_file \
        else ExperimentConfig()
    ds = build_frame_dataset(
        args.dataset, args.scene, args.data_path, train=True, config=config,
        skip_images=True, asset_root=args.asset_root)
    print(f"{args.dataset}/{args.scene}: {len(ds)} poses; pose_stats written")


def dataset_mean(args) -> None:
    """Per-channel mean and variance over resized+cropped train images."""
    from PIL import Image

    from ..data.transforms import resize_shorter_side
    from .builders import build_frame_dataset

    crop = None
    crop_file = Path(args.asset_root) / args.dataset / "crop_size.txt"
    if crop_file.exists():
        crop = tuple(np.loadtxt(crop_file).astype(int))
    ds = build_frame_dataset(
        args.dataset, args.scene, args.data_path, train=True,
        config=ExperimentConfig(), asset_root=args.asset_root)
    rng = np.random.RandomState(7)
    acc = np.zeros(3)
    acc_sq = np.zeros(3)
    n_px = 0
    for i in range(len(ds)):
        img = ds.get_image(i)
        if img is None:
            continue
        pil = (Image.fromarray(np.uint8(np.clip(img, 0, 255)))
               if isinstance(img, np.ndarray) else img)
        pil = resize_shorter_side(pil, 256)
        arr = np.asarray(pil.convert("RGB"), dtype=np.float64) / 255.0
        if crop is not None:
            ch, cw = crop
            y0 = rng.randint(0, max(1, arr.shape[0] - ch + 1))
            x0 = rng.randint(0, max(1, arr.shape[1] - cw + 1))
            arr = arr[y0:y0 + ch, x0:x0 + cw]
        acc += arr.sum(axis=(0, 1))
        acc_sq += (arr ** 2).sum(axis=(0, 1))
        n_px += arr.shape[0] * arr.shape[1]
        if i % 200 == 0:
            print(f"image {i} / {len(ds)}")
    mean = acc / n_px
    var = acc_sq / n_px - mean ** 2   # stored as VARIANCE, like upstream
    out = Path(args.asset_root) / args.dataset / args.scene / "stats.txt"
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savetxt(out, np.vstack((mean, var)), fmt="%8.7f")
    print(f"{out} written: mean={mean}, var={var}")


def _load_seq_raw_poses(args):
    """(frame_idx, real N x 12, gt N x 12) for one sequence (upstream
    scripts/align_vo_poses.py:40-78): 7Scenes reads the precomputed
    ``<vo_lib>_poses`` file and the per-frame GT pose files; RobotCar
    interpolates vo.csv / gps_ins.csv and ins.csv at the image timestamps."""
    import os

    from ..data.robotcar_sdk import interpolate_ins_poses, interpolate_vo_poses

    data_dir = Path(args.data_path)
    aux_dir = Path(args.asset_root) / args.dataset
    if args.dataset == "7Scenes":
        assert args.vo_lib == "dso", "7Scenes alignment uses DSO VO"
        seq = int(args.seq)
        real = np.loadtxt(
            aux_dir / args.scene / f"{args.vo_lib}_poses" / f"seq-{seq:02d}.txt")
        frame_idx, real = real[:, 0].astype(int), real[:, 1:13]
        seq_dir = data_dir / args.scene / f"seq-{seq:02d}"
        n = len([f for f in os.listdir(seq_dir) if "pose" in f])
        gt = np.asarray([
            np.loadtxt(seq_dir / f"frame-{i:06d}.pose.txt").flatten()[:12]
            for i in range(n)])
        return frame_idx, real, gt[frame_idx]
    if args.dataset == "RobotCar":
        seq_dir = data_dir / args.scene / args.seq
        with open(seq_dir / "stereo.timestamps") as f:
            ts = [int(line.rstrip().split(" ")[0]) for line in f]
        if args.vo_lib == "stereo":
            real = np.asarray(
                interpolate_vo_poses(seq_dir / "vo" / "vo.csv", ts, ts[0]))
        elif args.vo_lib == "gps":
            real = np.asarray(interpolate_ins_poses(
                seq_dir / "gps" / "gps_ins.csv", ts, ts[0]))
        else:
            raise NotImplementedError(args.vo_lib)
        gt = np.asarray(
            interpolate_ins_poses(seq_dir / "gps" / "ins.csv", ts, ts[0]))
        real = real[:, :3, :].reshape(len(real), -1)
        gt = gt[:, :3, :].reshape(len(gt), -1)
        return np.arange(len(gt)), real, gt
    raise NotImplementedError(args.dataset)


def align_vo_poses(args) -> None:
    """Horn-align one sequence's integrated VO onto GT; save {R, t, s} pkl."""
    _, real, gt = _load_seq_raw_poses(args)
    o1 = real[:, [3, 7, 11]].T
    o2 = gt[:, [3, 7, 11]].T
    R1 = real.reshape(-1, 3, 4)[:, :3, :3]
    R2 = gt.reshape(-1, 3, 4)[:, :3, :3]
    R, t, s = align_camera_poses(o1, o2, R1, R2, use_rotation_constraint=True)
    seq_name = (f"seq-{int(args.seq):02d}" if args.dataset == "7Scenes"
                else args.seq)
    out = (Path(args.asset_root) / args.dataset / args.scene / seq_name
           / f"{args.vo_lib}_vo_stats.pkl")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump({"R": R, "t": t.squeeze(), "s": s}, f)
    aligned = (s * R @ (o1 - t)).T   # the residual alignment quality
    err = np.linalg.norm(aligned - o2.T, axis=1)
    print(f"{out} written: s={s:.4f}, median residual {np.median(err):.4f}")


def process_robotcar_gps(args) -> None:
    """gps.csv -> gps_ins.csv: remap into the INS schema with zeroed
    velocities/attitude so the INS interpolator can consume GPS."""
    data_dir = Path(args.data_path) / args.scene / args.seq
    gps_file = data_dir / "gps" / "gps.csv"
    out_file = data_dir / "gps" / "gps_ins.csv"
    header = ("timestamp,ins_status,latitude,longitude,altitude,northing,"
              "easting,down,utm_zone,velocity_north,velocity_east,"
              "velocity_down,roll,pitch,yaw\n")
    with open(gps_file) as fin, open(out_file, "w") as fout:
        reader = csv.DictReader(fin)
        fout.write(header)
        writer = csv.writer(fout)
        for row in reader:
            writer.writerow([
                row["timestamp"], "INS_SOLUTION_GOOD",
                row["latitude"], row["longitude"], row["altitude"],
                row["northing"], row["easting"], row["down"],
                row.get("utm_zone", "30U"), 0, 0, 0, 0, 0, 0,
            ])
    print(f"{out_file} written")


def process_robotcar_images(args) -> None:
    """Offline demosaic + undistort + shortest-side-256 resize of raw
    stereo/centre images into ``centre_processed/``."""
    from PIL import Image

    from ..data.robotcar_sdk import CameraModel, load_stereo_image
    from ..data.transforms import resize_shorter_side

    seq_dir = Path(args.data_path) / args.scene / args.seq
    in_dir = seq_dir / "stereo" / "centre"
    out_dir = seq_dir / "stereo" / "centre_processed"
    out_dir.mkdir(parents=True, exist_ok=True)
    model = CameraModel(args.camera_models, Path("stereo") / "centre")
    images = sorted(in_dir.glob("*.png"))
    for i, path in enumerate(images):
        img = load_stereo_image(path, model)
        if img is None:
            continue
        pil = Image.fromarray(np.uint8(np.clip(img, 0, 255)))
        resize_shorter_side(pil, 256).save(out_dir / path.name)
        if i % 200 == 0:
            print(f"{i} / {len(images)}")
    print(f"{len(images)} images -> {out_dir}")


def time_imload(args) -> None:
    """Image loading timed (upstream dataset_loaders/time_imload.py): the
    native batch decoder, PIL decode, the host demosaic, and the device
    pipeline on a batch of the image as a mosaic (the demosaic kernel, the
    matmul resize to a shortest side of 256, a synchronize per call)."""
    import torch
    from PIL import Image

    from .. import native
    from ..data.robotcar_sdk import demosaic_gbrg
    from ..ops.image import make_device_pipeline, resize_shorter_side_shape
    from .builders import pick_device

    path, n = args.image, args.number
    if native.available():
        print(f"native decoder: built, batch-read backend = "
              f"{native.io_backend()}")
        h, w = np.asarray(Image.open(path)).shape[:2]
        t_nat = min(timeit.repeat(
            lambda: native.decode_batch([path] * args.batch, h, w),
            repeat=3, number=max(1, n // 4))) / max(1, n // 4) / args.batch
        print(f"native decode (B={args.batch}, 4 threads): "
              f"{t_nat * 1e3:8.2f} ms/image")
    else:
        first = (native.build_error() or "").strip().splitlines()
        print(f"native decoder: not buildable on this host: "
              f"{first[0] if first else 'unknown error'}")

    t_plain = min(timeit.repeat(
        lambda: np.asarray(Image.open(path).convert("RGB")),
        repeat=3, number=n)) / n
    print(f"plain decode:            {t_plain * 1e3:8.2f} ms/image")

    raw = np.asarray(Image.open(path).convert("L"))
    t_dem = min(timeit.repeat(lambda: demosaic_gbrg(raw),
                              repeat=3, number=n)) / n
    print(f"host demosaic:           {t_dem * 1e3:8.2f} ms/image")

    device = pick_device(args.device)
    h, w = raw.shape[0] // 2 * 2, raw.shape[1] // 2 * 2
    target = resize_shorter_side_shape(h, w, 256)
    pipe = make_device_pipeline(mean=[0.5] * 3, std=[0.25] * 3,
                                resize_to=target, bayer=True,
                                dtype=torch.bfloat16)
    batch = torch.from_numpy(np.ascontiguousarray(np.tile(
        raw[None, :h, :w], (args.batch, 1, 1)))).to(device)

    def run():
        pipe(batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run()   # builds the kernel
    reps = max(1, n // 4)
    t_dev = min(timeit.repeat(run, repeat=3, number=reps)) / reps / args.batch
    print(f"device pipeline (B={args.batch}, {h}x{w} -> {target[0]}x"
          f"{target[1]}, {device}): {t_dev * 1e3:8.2f} ms/image")


def reverse_vo_poses(args) -> None:
    """Reverse the frame ordering of a ``[frame_idx, 12-dim pose]`` VO file
    (for sequences run backwards through the VO system)."""
    data = np.loadtxt(args.input)
    frame_idx = data[:, 0].astype(int)
    poses = data[:, 1:13].reshape(-1, 3, 4)
    T = np.tile(np.eye(4), (len(poses), 1, 1))
    T[:, :3, :] = poses
    last_inv = np.linalg.inv(T[-1])
    # re-express every pose relative to the (new) first frame, reversed
    rev = np.einsum("ij,njk->nik", last_inv, T[::-1])
    out = np.concatenate(
        [frame_idx[:, None].astype(float), rev[:, :3, :].reshape(-1, 12)],
        axis=1)
    np.savetxt(args.output, out)
    print(f"{args.output} written ({len(out)} poses)")


def export_model(args) -> None:
    """Export a checkpoint as a serving artifact (``torch.export`` with the
    weights baked in; see :mod:`geomapnet_tpu_torch.serving`)."""
    import torch

    from ..serving import export_inference
    from ..train.checkpoint import load_weights
    from .builders import build_device_preprocess, build_model, pick_device

    config = parse_ini(args.config_file)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model, is_tuple = build_model(args.model, config, trunk=args.trunk,
                                  dtype=dtype)
    load_weights(args.weights, model)
    platforms = tuple(args.platforms.split(",")) if args.platforms else None
    device = (torch.device(platforms[0]) if platforms
              else pick_device(None))
    model.to(device=device, memory_format=torch.channels_last).eval()
    h, w = args.height, args.width
    frame_shape = (config.steps, h, w, 3) if is_tuple else (h, w, 3)
    preprocess = None
    in_dtype = dtype
    if not args.host_normalize and args.dataset != "synth":
        preprocess = build_device_preprocess(
            args.dataset, args.scene, args.asset_root, dtype=dtype)
        in_dtype = torch.uint8   # the artifact consumes resized uint8
    blob = export_inference(
        model, None, frame_shape, dtype=in_dtype, preprocess=preprocess,
        platforms=platforms, quantize=args.quantize == "int8")
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"{args.output} written ({len(blob)} bytes, input "
          f"(b, {', '.join(map(str, frame_shape))}) "
          f"{str(in_dtype).replace('torch.', '')})")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="geomapnet_tpu_torch data tools")
    sub = parser.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--dataset", default="7Scenes",
                        choices=("7Scenes", "RobotCar", "synth"))
    common.add_argument("--scene", required=False, default="synth")
    common.add_argument("--data_path", default="data/deepslam_data/7Scenes")
    common.add_argument("--asset_root", default="data")

    p = sub.add_parser("calc_pose_stats", parents=[common])
    p.add_argument("--config_file", default=None)
    p.set_defaults(fn=calc_pose_stats)

    p = sub.add_parser("dataset_mean", parents=[common])
    p.set_defaults(fn=dataset_mean)

    p = sub.add_parser("align_vo_poses", parents=[common])
    p.add_argument("--seq", required=True)
    p.add_argument("--vo_lib", default="dso")
    p.add_argument("--val", action="store_true")
    p.set_defaults(fn=align_vo_poses)

    for name, where in _UNPORTED.items():
        p = sub.add_parser(name, parents=[common],
                           help=f"not ported yet (ROADMAP.md, {where})")
        p.add_argument("--vo_lib", default="dso")
        p.add_argument("--val", action="store_true")
        p.add_argument("--output", default=None)
        p.set_defaults(fn=None)

    p = sub.add_parser("process_robotcar_gps", parents=[common])
    p.add_argument("--seq", required=True)
    p.set_defaults(fn=process_robotcar_gps)

    p = sub.add_parser("process_robotcar_images", parents=[common])
    p.add_argument("--seq", required=True)
    p.add_argument("--camera_models", default="data/robotcar_camera_models")
    p.set_defaults(fn=process_robotcar_images)

    p = sub.add_parser("time_imload")
    p.add_argument("--image", required=True)
    p.add_argument("--number", type=int, default=20)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--device", default=None,
                   help="torch device of the device pipeline (default: the "
                   "first CUDA device; fails when there is none)")
    p.set_defaults(fn=time_imload)

    p = sub.add_parser("reverse_vo_poses")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=reverse_vo_poses)

    p = sub.add_parser("export_model", parents=[common])
    p.add_argument("--model", required=True,
                   choices=("posenet", "mapnet", "mapnet++"))
    p.add_argument("--trunk", default="resnet34",
                   choices=("resnet18", "resnet34", "resnet50"))
    p.add_argument("--config_file", required=True)
    p.add_argument("--weights", required=True,
                   help="a port checkpoint (epoch_*.pth.tar), an upstream "
                   ".pth.tar, or Flax variables as an .npz")
    p.add_argument("--output", required=True)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=341)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--host_normalize", action="store_true",
                   help="export a float artifact without the fused uint8 "
                   "normalize stage")
    p.add_argument("--platforms", default=None,
                   help="comma-separated devices the artifact may be loaded "
                   "on, e.g. cuda,cpu; the first traces it (default: the "
                   "card)")
    p.add_argument("--quantize", choices=["int8"], default=None,
                   help="bake an int8-PTQ trunk into the artifact")
    p.set_defaults(fn=export_model)

    args = parser.parse_args(argv)
    if args.cmd in _UNPORTED:
        parser.error(f"{args.cmd} is not ported yet (ROADMAP.md, "
                     f"{_UNPORTED[args.cmd]})")
    args.fn(args)


if __name__ == "__main__":
    main()
