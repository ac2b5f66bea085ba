"""Visual-odometry (relative pose) sequence ops over the T axis, in torch.

The PyTorch counterpart of :mod:`geomapnet_tpu.geometry.vo`: each variant is
one sliced or gathered expression over the whole ``(..., T, D)`` block
(upstream common/pose_utils.py:234-304 loops over frames). Consecutive
variants return ``(..., T-1, D)``, fully-connected ones
``(..., T*(T-1)//2, D)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .se3 import relative_pose_logq

__all__ = [
    "vos_simple",
    "vos_logq",
    "vos_logq_fc",
    "pair_indices_fc",
]


def vos_simple(poses: torch.Tensor) -> torch.Tensor:
    """Frame-to-frame subtraction of pose vectors. (..., T, D) ->
    (..., T-1, D); upstream ``calc_vos_simple`` (pose_utils.py:234-246)."""
    return poses[..., 1:, :] - poses[..., :-1, :]


def vos_logq(poses: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """SE(3) relative poses between consecutive frames, in the earlier
    frame. (..., T, 6) -> (..., T-1, 6); upstream ``calc_vos`` (clamped) /
    ``calc_vos_safe`` (exact), pose_utils.py:248-288."""
    return relative_pose_logq(poses[..., :-1, :], poses[..., 1:, :],
                              exact=exact)


def pair_indices_fc(T: int) -> tuple[np.ndarray, np.ndarray]:
    """(i, j) index arrays of all pairs i < j, in the reference's row-major
    order (0,1),(0,2),...,(1,2),... (upstream pose_utils.py:290-304)."""
    i, j = np.triu_indices(T, k=1)
    return i, j


def vos_logq_fc(poses: torch.Tensor, exact: bool = True) -> torch.Tensor:
    """Fully-connected relative poses over all frame pairs i < j.
    (..., T, 6) -> (..., T*(T-1)//2, 6); upstream ``calc_vos_safe_fc``
    (pose_utils.py:290-304), used by RobotCar PGO."""
    i, j = (torch.from_numpy(a).to(poses.device)
            for a in pair_indices_fc(poses.shape[-2]))
    return relative_pose_logq(poses.index_select(-2, i),
                              poses.index_select(-2, j), exact=exact)
