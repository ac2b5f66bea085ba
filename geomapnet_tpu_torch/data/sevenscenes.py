"""7Scenes dataset: disk-format-compatible frame dataset.

A numpy + PIL copy of :class:`geomapnet_tpu.data.sevenscenes.SevenScenes`
(that package cannot be imported without jax); tests/test_torch_sevenscenes.py
and tests/test_torch_native.py pin the copy to the original. It reads the
same on-disk layout as the reference (upstream
dataset_loaders/seven_scenes.py): a raw scene directory (``data_path/<scene>``)
containing ``seq-XX/`` folders with ``frame-%06d.color.png`` /
``frame-%06d.depth.png`` / ``frame-%06d.pose.txt`` and ``TrainSplit.txt`` /
``TestSplit.txt``, plus an assets directory (``asset_dir/<scene>``) with
``pose_stats.txt``, per-sequence ``<vo_lib>_vo_stats.pkl`` alignments and
``<vo_lib>_poses/seq-XX.txt`` precomputed VO (for ``real=True``).

Each sequence loads into a :class:`SequenceFrames` record (GT poses from
per-frame pose.txt files, or integrated-VO poses + a pickled similarity
alignment), and the dataset is the concatenation of those records with pose
processing applied per sequence.

Frames are the colour images (``mode=0``), the 16-bit depth images
(``mode=1``, uint16 millimetres) or both (``mode=2``, a ``[colour, depth]``
list), through PIL, or with ``use_native`` through the C++ batch decoder
(:mod:`geomapnet_tpu_torch.native`): colour decoded and resized to
``native_size`` in one call per batch, depth decoded at its own resolution.
The native resize (box halving, then bilinear) is not PIL's, so native
frames are close to the PIL path's, not equal.

Behavioral parity notes:
- ``pose_stats.txt`` is written (identity stats) when constructing the
  train/GT dataset and read otherwise — the reference's hidden ordering
  dependency (seven_scenes.py:98-104) is preserved so asset files interop;
- VO pose files carry a leading frame-number column (libviso2's numbering is
  1-based, seven_scenes.py:71-73); ``gt_idx`` maps those frames onto the
  GT frame numbering across sequence boundaries;
- corrupt images yield None from ``get_image`` (the loader skips them).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from pathlib import Path

import numpy as np

from ..geometry.process import process_poses

__all__ = ["SevenScenes"]

_IDENTITY_ALIGN = {"R": np.eye(3), "t": np.zeros(3), "s": 1}


def _load_image(path: Path):
    from PIL import Image

    try:
        return Image.open(path)
    except (IOError, OSError) as e:
        print(f"Could not load image {path}: {e}")
        return None


@dataclasses.dataclass
class SequenceFrames:
    """Everything one ``seq-XX`` directory contributes to the dataset."""

    color_paths: list[Path]
    depth_paths: list[Path]
    raw_poses: np.ndarray  # (F, 12) flattened [R|t] rows
    frame_numbers: np.ndarray  # (F,) indices into the GT frame numbering
    alignment: dict  # {R, t, s} similarity mapping into the GT frame
    gt_frame_count: int  # number of GT frames in this sequence directory


def _split_sequence_numbers(split_file: Path) -> list[int]:
    """Sequence numbers listed in a TrainSplit/TestSplit file."""
    with open(split_file) as f:
        return [
            int(line.split("sequence")[-1])
            for line in f
            if not line.startswith("#")
        ]


def _count_gt_frames(seq_dir: Path) -> int:
    return sum(1 for name in os.listdir(seq_dir) if "pose" in name)


def _frame_paths(seq_dir: Path, frame_numbers) -> tuple[list[Path], list[Path]]:
    color = [seq_dir / f"frame-{i:06d}.color.png" for i in frame_numbers]
    depth = [seq_dir / f"frame-{i:06d}.depth.png" for i in frame_numbers]
    return color, depth


def _gt_sequence(seq_dir: Path) -> SequenceFrames:
    """Load a sequence with ground-truth poses (one pose.txt per frame)."""
    n = _count_gt_frames(seq_dir)
    frame_numbers = np.arange(n)
    raw = np.asarray([
        np.loadtxt(seq_dir / f"frame-{i:06d}.pose.txt").flatten()[:12]
        for i in frame_numbers
    ])
    color, depth = _frame_paths(seq_dir, frame_numbers)
    return SequenceFrames(color, depth, raw, frame_numbers,
                          dict(_IDENTITY_ALIGN), n)


def _vo_sequence(seq_dir: Path, asset_scene_dir: Path, seq: int,
                 vo_lib: str) -> SequenceFrames:
    """Load a sequence with integrated-VO poses + its GT alignment."""
    table = np.loadtxt(asset_scene_dir / f"{vo_lib}_poses" / f"seq-{seq:02d}.txt")
    frame_numbers = table[:, 0].astype(int)
    if vo_lib == "libviso2":  # 1-based frame numbering
        frame_numbers = frame_numbers - 1
    with open(asset_scene_dir / f"seq-{seq:02d}" / f"{vo_lib}_vo_stats.pkl",
              "rb") as f:
        alignment = pickle.load(f)
    color, depth = _frame_paths(seq_dir, frame_numbers)
    return SequenceFrames(color, depth, table[:, 1:13], frame_numbers,
                          alignment, _count_gt_frames(seq_dir))


def _pose_stats(stats_file: Path, write_identity: bool):
    """Translation mean/std — written as identity for the train/GT dataset
    (7Scenes trajectories are small), read back otherwise."""
    if write_identity:
        mean_t, std_t = np.zeros(3), np.ones(3)
        stats_file.parent.mkdir(parents=True, exist_ok=True)
        np.savetxt(stats_file, np.vstack((mean_t, std_t)), fmt="%8.7f")
        return mean_t, std_t
    return np.loadtxt(stats_file)


class SevenScenes:
    """One 7Scenes scene as a frame dataset (protocol of data.composite).

    :param scene: 'chess' | 'fire' | 'heads' | 'office' | 'pumpkin' |
        'redkitchen' | 'stairs'
    :param data_path: raw dataset root (contains ``<scene>/seq-XX``)
    :param train: use TrainSplit.txt vs TestSplit.txt
    :param transform: callable PIL -> array (data.transforms)
    :param target_transform: optional callable on the (6,) pose
    :param mode: 0 color, 1 depth, 2 both ([color, depth] list)
    :param real: load integrated-VO poses instead of GT
    :param skip_images: pose-only dataset (images None)
    :param vo_lib: VO source for real=True ('dso', 'orbslam', 'libviso2')
    :param asset_dir: processed-assets root (defaults to ``data/7Scenes``)
    :param use_native: decode (and resize colour) through the native C++
        path; raises when the library cannot be built on this host
    :param native_size: (H, W) of the natively decoded colour frames
        (default 256x341: 480x640 at a shortest side of 256)
    """

    def __init__(
        self,
        scene: str,
        data_path: str,
        train: bool,
        transform=None,
        target_transform=None,
        mode: int = 0,
        seed: int = 7,
        real: bool = False,
        skip_images: bool = False,
        vo_lib: str = "orbslam",
        asset_dir: str | None = None,
        use_native: bool = False,
        native_size: tuple[int, int] | None = None,
    ):
        if use_native and not skip_images:
            from .. import native

            native.require()   # a missing library is never silent
        self.mode = mode
        self.transform = transform
        self.target_transform = target_transform
        self.skip_images = skip_images
        # native C++ decode+resize path: images arrive as pre-resized uint8
        # arrays, and the transform skips its PIL work
        self.use_native = use_native
        self.native_size = native_size or (256, 341)
        self._depth_size: tuple[int, int] | None = None  # probed lazily
        np.random.seed(seed)

        scene_dir = Path(os.path.expanduser(data_path)) / scene
        asset_scene_dir = Path(asset_dir or Path("data") / "7Scenes") / scene

        split_name = "TrainSplit.txt" if train else "TestSplit.txt"
        seq_numbers = _split_sequence_numbers(scene_dir / split_name)
        sequences = [
            _vo_sequence(scene_dir / f"seq-{seq:02d}", asset_scene_dir, seq,
                         vo_lib)
            if real else _gt_sequence(scene_dir / f"seq-{seq:02d}")
            for seq in seq_numbers
        ]

        self.c_imgs = [p for s in sequences for p in s.color_paths]
        self.d_imgs = [p for s in sequences for p in s.depth_paths]

        # frame numbers -> global GT indices (offset by the GT frame counts
        # of the preceding sequences)
        offsets = np.cumsum([0] + [s.gt_frame_count for s in sequences][:-1])
        self.gt_idx = (
            np.concatenate([s.frame_numbers + off
                            for s, off in zip(sequences, offsets)])
            if sequences else np.empty((0,), int)
        )

        mean_t, std_t = _pose_stats(
            asset_scene_dir / "pose_stats.txt",
            write_identity=train and not real,
        )
        self.poses = np.concatenate(
            [
                process_poses(s.raw_poses, mean_t, std_t,
                              s.alignment["R"], s.alignment["t"],
                              s.alignment["s"])
                for s in sequences
            ]
            or [np.empty((0, 6))]
        ).astype(np.float32)

    def _depth_dims(self) -> tuple[int, int]:
        """(H, W) of the depth frames, probed once from the first file's
        header (the native decoder works at fixed batch dimensions)."""
        if self._depth_size is None:
            from PIL import Image

            with Image.open(self.d_imgs[0]) as im:
                self._depth_size = (im.height, im.width)
        return self._depth_size

    def _native_color(self, indices, num_workers: int) -> list:
        from .. import native

        batch, ok = native.decode_batch(
            [self.c_imgs[i] for i in indices], *self.native_size,
            n_threads=num_workers)
        return [(self.transform(img) if self.transform else img)
                if good else None for img, good in zip(batch, ok)]

    def _native_depth(self, indices, num_workers: int) -> list:
        """Depth frames through the C++ 16-bit decoder at their own
        resolution (uint16 millimetres; a resize belongs to the device)."""
        from .. import native

        batch, ok = native.decode_batch_gray16(
            [self.d_imgs[i] for i in indices], *self._depth_dims(),
            n_threads=num_workers)
        return [(self.transform(img) if self.transform else img)
                if good else None for img, good in zip(batch, ok)]

    def get_image(self, index: int):
        """Image array for frame ``index`` (None if unreadable); a
        ``[colour, depth]`` list in mode 2."""
        if self.skip_images:
            return None
        if self.use_native:
            return self.get_images([index], num_workers=1)[0]
        if self.mode == 0:
            img = _load_image(self.c_imgs[index])
        elif self.mode == 1:
            img = _load_image(self.d_imgs[index])
        elif self.mode == 2:
            c = _load_image(self.c_imgs[index])
            d = _load_image(self.d_imgs[index])
            if c is None or d is None:
                return None
            if self.transform is not None:
                return [self.transform(c), self.transform(d)]
            return [np.asarray(c), np.asarray(d)]
        else:
            raise ValueError(f"wrong mode {self.mode}")
        if img is None:
            return None
        if self.transform is not None:
            return self.transform(img)
        return np.asarray(img)

    def get_images(self, indices, num_workers: int = 4) -> list:
        """Batch counterpart of :meth:`get_image` with the same outputs; on
        the native path one C++ batch call per modality (colour: decode and
        resize; depth: 16-bit at its own resolution)."""
        if self.skip_images:
            return [None] * len(indices)
        if self.use_native:
            if self.mode == 0:
                return self._native_color(indices, num_workers)
            if self.mode == 1:
                return self._native_depth(indices, num_workers)
            if self.mode == 2:
                colors = self._native_color(indices, num_workers)
                depths = self._native_depth(indices, num_workers)
                return [None if c is None or d is None else [c, d]
                        for c, d in zip(colors, depths)]
            raise ValueError(f"wrong mode {self.mode}")
        return [self.get_image(i) for i in indices]

    def __getitem__(self, index: int):
        pose = self.poses[index]
        if self.target_transform is not None:
            pose = self.target_transform(pose)
        return self.get_image(index), pose

    def __len__(self) -> int:
        return self.poses.shape[0]
