"""Pose-error metrics on the host (numpy).

The numpy half of :mod:`geomapnet_tpu.geometry.metrics`; the port computes
errors after the single readback at the end of an eval, so it needs no
device variants. Reference parity: ``quaternion_angular_error``
(upstream common/pose_utils.py:358-371), which works on one pair at a time;
these accept arbitrary batch shapes.
"""

from __future__ import annotations

import numpy as np

__all__ = ["translation_error", "quaternion_angular_error"]


def translation_error(t_pred: np.ndarray, t_gt: np.ndarray) -> np.ndarray:
    """Euclidean distance per pose. (..., 3) x (..., 3) -> (...)."""
    return np.linalg.norm(np.asarray(t_pred) - np.asarray(t_gt), axis=-1)


def quaternion_angular_error(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Angular error in degrees between unit quaternions. (..., 4) -> (...)."""
    d = np.abs(np.sum(np.asarray(q1) * np.asarray(q2), axis=-1))
    d = np.clip(d, -1.0, 1.0)
    return 2.0 * np.degrees(np.arccos(d))
