"""Pixel statistics: ``stats.txt`` -> (mean, std), and host normalize.

The numpy part of :mod:`geomapnet_tpu.data.transforms` that the raw-Bayer
eval needs. The reference stores per-channel *variance* in ``stats.txt`` and
takes the sqrt at setup (upstream scripts/train.py:127); :class:`Normalize`
takes (mean, std) directly and :func:`std_from_stats` does the sqrt.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["Normalize", "std_from_stats"]


def std_from_stats(stats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split a (2, 3) ``stats.txt`` array into (mean, std=sqrt(variance))."""
    stats = np.asarray(stats)
    return stats[0], np.sqrt(stats[1])


@dataclasses.dataclass
class Normalize:
    """Per-channel (x - mean) / std on [0, 1]-scaled images."""

    mean: Sequence[float]
    std: Sequence[float]

    def __call__(self, img: np.ndarray) -> np.ndarray:
        mean = np.asarray(self.mean, dtype=np.float32)
        std = np.asarray(self.std, dtype=np.float32)
        return (img - mean) / std
