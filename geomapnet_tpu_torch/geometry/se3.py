"""SE(3) poses as translation + quaternion, torch functions on tensors.

The PyTorch counterpart of :mod:`geomapnet_tpu.geometry.se3`. Poses are
``(..., 7)`` = ``[t(3), q(4)]`` or ``(..., 6)`` = ``[t(3), logq(3)]``; every
function works on the trailing axis and broadcasts over the rest. Upstream:
common/pose_utils.py:134-232.
"""

from __future__ import annotations

import torch

from .quaternion import (
    qexp,
    qexp_exact,
    qinv,
    qlog,
    qlog_exact,
    qmult,
    rotate_vec_by_q,
)

__all__ = [
    "compose",
    "invert",
    "relative_pose",
    "relative_pose_logq",
    "world_relative_pose",
    "world_relative_pose_logq",
]


def compose(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Compose two poses: apply ``p2`` in the frame of ``p1``. (..., 7)."""
    t1, q1 = p1[..., :3], p1[..., 3:]
    t2, q2 = p2[..., :3], p2[..., 3:]
    q = qmult(q1, q2)
    t = t1 + rotate_vec_by_q(t2, q1)
    return torch.cat([t, q], dim=-1)


def invert(p: torch.Tensor) -> torch.Tensor:
    """Invert a pose. (..., 7) -> (..., 7)."""
    t, q = p[..., :3], p[..., 3:]
    q_inv = qinv(q)
    return torch.cat([-rotate_vec_by_q(t, q_inv), q_inv], dim=-1)


def relative_pose(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Relative pose of ``p1`` in the frame of ``p0`` (t+q form); upstream
    ``calc_vo`` (pose_utils.py:159-165)."""
    return compose(invert(p0), p1)


def _log_pair(p0: torch.Tensor, p1: torch.Tensor, exact: bool):
    exp = qexp_exact if exact else qexp
    return (torch.cat([p0[..., :3], exp(p0[..., 3:])], dim=-1),
            torch.cat([p1[..., :3], exp(p1[..., 3:])], dim=-1),
            qlog_exact if exact else qlog)


def relative_pose_logq(p0: torch.Tensor, p1: torch.Tensor,
                       exact: bool = False) -> torch.Tensor:
    """Relative pose in the p0 frame, log-quaternion in and out. (..., 6).

    Upstream ``calc_vo_logq`` (clamped maps) / ``calc_vo_logq_safe`` (exact
    maps), pose_utils.py:167-179, 219-232.
    """
    a, b, log = _log_pair(p0, p1, exact)
    vo = relative_pose(a, b)
    return torch.cat([vo[..., :3], log(vo[..., 3:])], dim=-1)


def world_relative_pose(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Relative pose with the translation left in the world frame. (..., 7).
    Upstream ``calc_vo_relative`` (pose_utils.py:181-189)."""
    t = p1[..., :3] - p0[..., :3]
    q = qmult(qinv(p0[..., 3:]), p1[..., 3:])
    return torch.cat([t, q], dim=-1)


def world_relative_pose_logq(p0: torch.Tensor, p1: torch.Tensor,
                             exact: bool = False) -> torch.Tensor:
    """World-frame relative pose, log-quaternion in and out. (..., 6).
    Upstream ``calc_vo_relative_logq(_safe)`` (pose_utils.py:191-217)."""
    a, b, log = _log_pair(p0, p1, exact)
    vo = world_relative_pose(a, b)
    return torch.cat([vo[..., :3], log(vo[..., 3:])], dim=-1)
