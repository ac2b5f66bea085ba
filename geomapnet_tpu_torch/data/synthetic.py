"""Synthetic pose-regression scene: procedural images with recoverable pose.

A numpy copy of :mod:`geomapnet_tpu.data.synthetic` (that package cannot be
imported without jax); tests/test_torch_import_isolation.py pins the copy to
the original. Images are rendered deterministically from the pose (blob
positions encode translation, a gradient encodes heading), so a small
network can fit pose from pixels. Implements the frame-dataset protocol of
:class:`geomapnet_tpu_torch.data.composite.MF`.
"""

from __future__ import annotations

import numpy as np

from ..geometry.process import process_poses
from ..geometry.rotations import euler2mat

__all__ = ["SyntheticScene"]


class SyntheticScene:
    """A smooth synthetic camera trajectory with procedurally rendered frames.

    :param n_frames: trajectory length
    :param height/width: rendered image size
    :param train: train/val split (val uses a phase-shifted trajectory)
    :param real: emulate drifted "VO" poses (adds smooth noise; ``gt_idx``
        maps back to the GT frames as in the reference's real datasets)
    :param skip_images: pose-only mode (images return None)
    """

    def __init__(
        self,
        n_frames: int = 64,
        height: int = 64,
        width: int = 96,
        train: bool = True,
        real: bool = False,
        skip_images: bool = False,
        seed: int = 7,
        mean_t: np.ndarray | None = None,
        std_t: np.ndarray | None = None,
    ):
        self.h, self.w = height, width
        self.skip_images = skip_images
        rng = np.random.RandomState(seed if train else seed + 1)
        phase = 0.0 if train else 0.37

        ts = np.linspace(0, 2 * np.pi, n_frames, endpoint=False) + phase
        t = np.stack(
            [2.0 * np.cos(ts), 2.0 * np.sin(ts), 0.3 * np.sin(3 * ts)], axis=1
        )
        yaw = ts + 0.2 * np.sin(2 * ts)

        raw = np.zeros((n_frames, 12))
        for i in range(n_frames):
            R = euler2mat(0.0, 0.0, yaw[i])
            raw[i] = np.concatenate([R, t[i][:, None]], axis=1).reshape(-1)

        if real:
            # smooth drift emulating integrated VO
            drift = np.cumsum(rng.randn(n_frames, 3) * 0.01, axis=0)
            raw[:, [3, 7, 11]] += drift

        mean_t = np.zeros(3) if mean_t is None else mean_t
        std_t = np.ones(3) if std_t is None else std_t
        self.poses = process_poses(
            raw, mean_t, std_t, np.eye(3), np.zeros(3), 1
        ).astype(np.float32)
        self.gt_idx = np.arange(n_frames)
        self._t = t
        self._yaw = yaw

        yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
        self._grid = (xx / width, yy / height)

    def get_image(self, index: int) -> np.ndarray | None:
        """Render frame ``index`` as a float32 (H, W, 3) array in [-1, 1]."""
        if self.skip_images:
            return None
        xn, yn = self._grid
        t = self._t[index]
        yaw = self._yaw[index]

        # blob whose position encodes (x, y) translation
        cx = 0.5 + 0.2 * t[0] / 2.0
        cy = 0.5 + 0.2 * t[1] / 2.0
        blob = np.exp(-(((xn - cx) ** 2 + (yn - cy) ** 2) / 0.02))

        # oriented gradient encoding heading + a z-dependent intensity
        grad = xn * np.cos(yaw) + yn * np.sin(yaw)
        z = 0.5 + t[2]

        img = np.stack([blob, 0.5 * (grad + 1.0) - 0.5, z * blob], axis=-1)
        return np.clip(img, -1.0, 1.0).astype(np.float32)

    def __len__(self) -> int:
        return len(self.poses)

    def __getitem__(self, index: int):
        return self.get_image(index), self.poses[index]
