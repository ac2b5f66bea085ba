"""Oxford RobotCar scene: processed RGB frames or raw Bayer mosaics.

A copy of :class:`geomapnet_tpu.data.robotcar.RobotCar`; it reads the same
disk layout (upstream dataset_loaders/robotcar.py): a scene directory
(``data_path/<scene>``) with ``train_split.txt`` / ``test_split.txt``
naming sequence dirs, each holding ``stereo.timestamps``,
``gps/ins.csv`` (ground truth), ``vo/vo.csv`` or ``gps/gps_ins.csv`` (the
"real" poses) and ``stereo/centre/<ts>.png`` images; an assets dir with the
scene's ``pose_stats.txt`` and per-sequence ``<vo_lib>_vo_stats.pkl``
alignments of the real poses into the ground-truth frame.

Frames are either the images on disk through PIL and the host
``transform`` (the offline-processed RGB frames; with ``undistort`` a raw
mosaic is demosaiced and undistorted on the host first, upstream
robotcar.py:110-125), or with ``raw_bayer`` the untouched single-channel
GBRG mosaics, uint8 (H, W), which the device pipeline
(:func:`geomapnet_tpu_torch.ops.image.make_device_pipeline`) demosaics,
[undistorts,] resizes and normalizes. Poses are normalized by the
ground-truth translation mean/std, written when the ground-truth train
split is built and read back otherwise (upstream robotcar.py:89-99).

Where the JAX package decodes through its C++ library, so does this copy
(:mod:`geomapnet_tpu_torch.native`): mosaics go through
``decode_batch_gray`` whenever the library is available (one call per
batch), and processed RGB frames through ``decode_image`` /
``decode_batch`` (decode and resize to ``native_size``) with
``use_native``. A mosaic is a lossless PNG: reading it gives the same
pixels either way. Without the library, mosaics decode through PIL on
``num_workers`` threads; an explicit ``use_native`` then raises.
"""

from __future__ import annotations

import os
import pickle
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..geometry.process import process_poses
from .robotcar_sdk import (
    CameraModel,
    interpolate_ins_poses,
    interpolate_vo_poses,
    load_stereo_image,
)
from .transforms import write_pose_stats

__all__ = ["RobotCar"]


def _read_timestamps(seq_dir: Path) -> list[int]:
    with open(seq_dir / "stereo.timestamps") as f:
        return [int(line.rstrip().split(" ")[0]) for line in f]


def _load_sequence(seq_dir: Path, asset_seq_dir: Path, real: bool,
                   vo_lib: str) -> tuple[np.ndarray, dict, list[Path]]:
    """(F, 12) flattened ``[R|t]`` rows at the image timestamps, their
    similarity alignment {R, t, s} into the ground-truth frame, and the image
    paths, for one sequence: INS ground truth, or with ``real`` the
    integrated stereo VO (``vo_lib`` "stereo") or GPS ("gps") with its
    pickled alignment."""
    stamps = _read_timestamps(seq_dir)
    if real:
        if vo_lib == "stereo":
            se3 = interpolate_vo_poses(seq_dir / "vo" / "vo.csv", stamps,
                                       stamps[0])
        elif vo_lib == "gps":
            se3 = interpolate_ins_poses(seq_dir / "gps" / "gps_ins.csv",
                                        stamps, stamps[0])
        else:
            raise NotImplementedError(f"unknown vo_lib {vo_lib}")
        with open(asset_seq_dir / f"{vo_lib}_vo_stats.pkl", "rb") as f:
            alignment = pickle.load(f)
    else:
        se3 = interpolate_ins_poses(seq_dir / "gps" / "ins.csv", stamps,
                                    stamps[0])
        alignment = {"R": np.eye(3), "t": np.zeros(3), "s": 1}
    se3 = np.asarray(se3)
    raw = se3[:, :3, :].reshape(len(se3), -1)
    paths = [seq_dir / "stereo" / "centre" / f"{t}.png" for t in stamps]
    return raw, alignment, paths


def _real_pose_stats(stats_file: Path, write_from: np.ndarray | None):
    """Translation mean/std: computed from ``write_from`` and saved, or read
    back from ``stats_file``. A ~zero std along an axis (a constant
    trajectory coordinate) is clamped to 1 with a warning, as the JAX
    package does, so normalization never divides by zero."""
    if write_from is not None:
        mean_t = np.mean(write_from[:, [3, 7, 11]], axis=0)
        std_t = np.std(write_from[:, [3, 7, 11]], axis=0)
        # %8.7f quantizes anything below 5e-8 to a literal 0.0 on disk
        std_t = _clamp_degenerate_std(std_t, threshold=1e-6)
        write_pose_stats(stats_file, mean_t, std_t)
        return mean_t, std_t
    stats = np.loadtxt(stats_file)
    return stats[0], _clamp_degenerate_std(stats[1], threshold=1e-8)


def _clamp_degenerate_std(std_t: np.ndarray, threshold: float) -> np.ndarray:
    degenerate = std_t < threshold
    if degenerate.any():
        warnings.warn(
            f"pose std is ~0 along axes {np.nonzero(degenerate)[0]} "
            f"(constant trajectory coordinate); clamping to 1 to avoid "
            f"NaN normalization", stacklevel=3,
        )
        std_t = np.where(degenerate, 1.0, std_t)
    return std_t


class RobotCar:
    """One RobotCar scene (e.g. 'loop', 'full') as a frame dataset.

    :param scene: sequence collection name
    :param data_path: raw dataset root (contains ``<scene>/<seq dirs>``)
    :param train: train vs test split; the ground-truth train split writes
        ``pose_stats.txt``, every other split reads it
    :param transform: callable PIL image -> array for the RGB frames
        (ignored with ``raw_bayer``)
    :param target_transform: callable on the (6,) pose of ``__getitem__``
    :param real: poses from VO/GPS integration instead of INS ground truth
    :param skip_images: pose-only dataset (images None)
    :param seed: seeds numpy's global generator, as upstream does
    :param undistort: demosaic and undistort raw mosaics on the host when
        loading an RGB frame (slow; the device pipeline does it on the
        card)
    :param vo_lib: 'stereo' (vo.csv) or 'gps' (gps_ins.csv) for real=True
    :param asset_dir: processed-assets root (defaults to ``data/RobotCar``)
    :param camera_models_dir: the SDK's camera models, for ``undistort``
        (defaults to ``data/robotcar_camera_models``)
    :param raw_bayer: frames are the untouched (H, W) uint8 mosaics, for
        the device pipeline; ``transform`` is ignored
    :param raw_size: expected (H, W) of the mosaics (RobotCar Grasshopper2:
        960x1280); a mosaic of another shape counts as corrupt
    :param use_native: decode and resize the processed RGB frames with the
        C++ decoder instead of PIL (raises when the library cannot be built
        on this host)
    :param native_size: (H, W) for the native decode path
    """

    def __init__(
        self,
        scene: str,
        data_path: str,
        train: bool,
        transform=None,
        target_transform=None,
        real: bool = False,
        skip_images: bool = False,
        seed: int = 7,
        undistort: bool = False,
        vo_lib: str = "stereo",
        asset_dir: str | None = None,
        camera_models_dir: str | None = None,
        raw_bayer: bool = False,
        raw_size: tuple[int, int] = (960, 1280),
        use_native: bool = False,
        native_size: tuple[int, int] | None = None,
    ):
        if use_native and not (raw_bayer or skip_images):
            from .. import native

            native.require()   # a missing library is never silent
        np.random.seed(seed)
        self.transform = transform
        self.target_transform = target_transform
        self.undistort = undistort
        self.raw_bayer = raw_bayer
        self.raw_size = tuple(raw_size)
        self.skip_images = skip_images
        self.use_native = use_native
        self.native_size = native_size or (256, 341)
        scene_dir = Path(os.path.expanduser(data_path)) / scene
        asset_scene_dir = Path(asset_dir or Path("data") / "RobotCar") / scene

        split_name = "train_split.txt" if train else "test_split.txt"
        with open(scene_dir / split_name) as f:
            seq_names = [l.rstrip() for l in f if not l.startswith("#")]

        sequences = [_load_sequence(scene_dir / seq, asset_scene_dir / seq,
                                    real, vo_lib)
                     for seq in seq_names]
        self.imgs = [p for _, _, paths in sequences for p in paths]

        all_raw = np.vstack([raw for raw, _, _ in sequences])
        mean_t, std_t = _real_pose_stats(
            asset_scene_dir / "pose_stats.txt",
            write_from=all_raw if (train and not real) else None,
        )
        self.poses = np.concatenate([
            process_poses(raw, mean_t, std_t, align["R"], align["t"],
                          align["s"])
            for raw, align, _ in sequences
        ]).astype(np.float32)
        self.gt_idx = np.arange(len(self.poses))

        self._camera_model = None
        if undistort:
            models_dir = camera_models_dir or str(
                Path("data") / "robotcar_camera_models")
            self._camera_model = CameraModel(models_dir,
                                             Path("stereo") / "centre")

    def get_image(self, index: int):
        """The frame, or None when it cannot be read (always None with
        ``skip_images``): with ``raw_bayer`` the (H, W) uint8 mosaic (None
        when it has another shape than ``raw_size``), else the image through
        the host ``transform`` (a numpy array of the PIL image without
        one)."""
        if self.skip_images:
            return None
        from PIL import Image

        from .. import native

        if self.raw_bayer:
            if native.available():
                batch, ok = native.decode_batch_gray(
                    [self.imgs[index]], *self.raw_size, n_threads=1)
                return batch[0] if ok[0] else None
            try:
                raw = np.asarray(Image.open(self.imgs[index]))
            except (IOError, OSError) as e:
                print(f"Could not load image {self.imgs[index]}: {e}")
                return None
            if raw.ndim != 2 or raw.shape != self.raw_size:
                return None
            return raw.astype(np.uint8)
        if self.use_native:
            img = native.decode_image(self.imgs[index], *self.native_size)
            if img is None:
                return None
            if self.transform is not None:
                return self.transform(img)
            return img
        if self.undistort:
            img = load_stereo_image(self.imgs[index], self._camera_model)
            if img is None:
                return None
            img = Image.fromarray(np.uint8(np.clip(img, 0, 255)))
        else:
            try:
                img = Image.open(self.imgs[index])
            except (IOError, OSError) as e:
                print(f"Could not load image {self.imgs[index]}: {e}")
                return None
        if self.transform is not None:
            return self.transform(img)
        return np.asarray(img)

    def get_images(self, indices, num_workers: int = 4) -> list:
        """:meth:`get_image` for many frames: mosaics and native RGB frames
        through one C++ call on ``num_workers`` threads; without the
        library, mosaics on ``num_workers`` PIL threads (PNG decodes release
        the GIL). RGB frames otherwise load in order (a jittering transform
        draws from one generator)."""
        from .. import native

        indices = [int(i) for i in indices]
        if self.skip_images:
            return [None] * len(indices)
        if self.raw_bayer and native.available():
            batch, ok = native.decode_batch_gray(
                [self.imgs[i] for i in indices], *self.raw_size,
                n_threads=num_workers)
            return [img if good else None for img, good in zip(batch, ok)]
        if self.use_native and not self.raw_bayer:
            batch, ok = native.decode_batch(
                [self.imgs[i] for i in indices], *self.native_size,
                n_threads=num_workers)
            return [(self.transform(img) if self.transform else img)
                    if good else None for img, good in zip(batch, ok)]
        if not self.raw_bayer or num_workers <= 1 or len(indices) <= 1:
            return [self.get_image(i) for i in indices]
        with ThreadPoolExecutor(num_workers) as pool:
            return list(pool.map(self.get_image, indices))

    def __getitem__(self, index: int):
        pose = self.poses[index]
        if self.target_transform is not None:
            pose = self.target_transform(pose)
        return self.get_image(index), pose

    def __len__(self) -> int:
        return len(self.poses)
