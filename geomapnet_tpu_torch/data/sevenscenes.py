"""7Scenes dataset: disk-format-compatible frame dataset.

A numpy + PIL copy of :class:`geomapnet_tpu.data.sevenscenes.SevenScenes`
(that package cannot be imported without jax); tests/test_torch_sevenscenes.py
pins the copy to the original. It reads the same on-disk layout as the
reference (upstream dataset_loaders/seven_scenes.py): a raw scene directory
(``data_path/<scene>``) containing ``seq-XX/`` folders with
``frame-%06d.color.png`` / ``frame-%06d.pose.txt`` and ``TrainSplit.txt`` /
``TestSplit.txt``, plus an assets directory
(``asset_dir/<scene>``) with ``pose_stats.txt``, per-sequence
``<vo_lib>_vo_stats.pkl`` alignments and ``<vo_lib>_poses/seq-XX.txt``
precomputed VO (for ``real=True``).

Each sequence loads into a :class:`SequenceFrames` record (GT poses from
per-frame pose.txt files, or integrated-VO poses + a pickled similarity
alignment), and the dataset is the concatenation of those records with pose
processing applied per sequence.

Behavioral parity notes:
- ``pose_stats.txt`` is written (identity stats) when constructing the
  train/GT dataset and read otherwise — the reference's hidden ordering
  dependency (seven_scenes.py:98-104) is preserved so asset files interop;
- VO pose files carry a leading frame-number column (libviso2's numbering is
  1-based, seven_scenes.py:71-73); ``gt_idx`` maps those frames onto the
  GT frame numbering across sequence boundaries;
- corrupt images yield None from ``get_image`` (the loader skips them).

Colour frames only: the depth modes (``mode=1|2``), which no caller uses,
and the native C++ decoder (``use_native``) are not ported.
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


def _color_paths(seq_dir: Path, frame_numbers) -> list[Path]:
    return [seq_dir / f"frame-{i:06d}.color.png" for i in frame_numbers]


def _gt_sequence(seq_dir: Path) -> SequenceFrames:
    """Load a sequence with ground-truth poses (one pose.txt per frame)."""
    n = _count_gt_frames(seq_dir)
    frame_numbers = np.arange(n)
    raw = np.asarray([
        np.loadtxt(seq_dir / f"frame-{i:06d}.pose.txt").flatten()[:12]
        for i in frame_numbers
    ])
    return SequenceFrames(_color_paths(seq_dir, frame_numbers), raw,
                          frame_numbers, dict(_IDENTITY_ALIGN), n)


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
    return SequenceFrames(_color_paths(seq_dir, frame_numbers),
                          table[:, 1:13], frame_numbers, alignment,
                          _count_gt_frames(seq_dir))


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
    :param real: load integrated-VO poses instead of GT
    :param skip_images: pose-only dataset (images None)
    :param vo_lib: VO source for real=True ('dso', 'orbslam', 'libviso2')
    :param asset_dir: processed-assets root (defaults to ``data/7Scenes``)
    :param use_native: the native C++ decoder; not ported yet, raises
    """

    def __init__(
        self,
        scene: str,
        data_path: str,
        train: bool,
        transform=None,
        target_transform=None,
        seed: int = 7,
        real: bool = False,
        skip_images: bool = False,
        vo_lib: str = "orbslam",
        asset_dir: str | None = None,
        use_native: bool = False,
    ):
        if use_native:
            raise NotImplementedError(
                "the native C++ decoder is not ported yet (ROADMAP.md, "
                "Queue 1, item 15)")
        self.transform = transform
        self.target_transform = target_transform
        self.skip_images = skip_images
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

    def get_image(self, index: int):
        """Image array for frame ``index`` (None if unreadable)."""
        if self.skip_images:
            return None
        img = _load_image(self.c_imgs[index])
        if img is None:
            return None
        if self.transform is not None:
            return self.transform(img)
        return np.asarray(img)

    def get_images(self, indices, num_workers: int = 4) -> list:
        """Batch counterpart of :meth:`get_image`, with the same outputs."""
        if self.skip_images:
            return [None] * len(indices)
        return [self.get_image(i) for i in indices]

    def __getitem__(self, index: int):
        pose = self.poses[index]
        if self.target_transform is not None:
            pose = self.target_transform(pose)
        return self.get_image(index), pose

    def __len__(self) -> int:
        return self.poses.shape[0]
