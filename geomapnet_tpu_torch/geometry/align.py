"""Closed-form Horn similarity-transform alignment (host-side numpy).

A copy of :mod:`geomapnet_tpu.geometry.align` (that package cannot be
imported without jax); tests/test_torch_import_isolation.py pins the copy
to the original.

Solves for ``s, R, t`` such that ``s * R @ (x1 - t) = x2``, optionally with
rotation constraints from camera orientations. Used to align raw VO/INS
trajectories to the GT world frame before training.

Reference parity: the ``align_*`` family
(upstream common/pose_utils.py:806-1071), which accumulates the
correlation matrix in Python loops; here it is one einsum.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "align_pts",
    "align_3d_pts",
    "align_2d_pts",
    "align_3d_pts_noscale",
    "align_2d_pts_noscale",
    "align_camera_poses",
]


def _procrustes(W: np.ndarray, d: int) -> np.ndarray:
    """Nearest rotation to W via SVD with the det>0 sign fix."""
    U, _, Vh = np.linalg.svd(W)
    S = np.eye(d)
    if np.linalg.det(U @ Vh) < 0:
        S[d - 1, d - 1] = -1
    return U @ S @ Vh


def align_pts(x1: np.ndarray, x2: np.ndarray, with_scale: bool = True):
    """Horn alignment of two point sets.

    :param x1: (d, n) source points
    :param x2: (d, n) target points
    :param with_scale: solve for scale (else s = 1)
    :return: (R (d,d), t (d,1), s) with ``s * R @ (x1 - t) ~= x2``
    """
    x1 = np.asarray(x1, dtype=np.float64)
    x2 = np.asarray(x2, dtype=np.float64)
    d = x1.shape[0]
    x1c = x1.mean(axis=1, keepdims=True)
    x2c = x2.mean(axis=1, keepdims=True)
    a = x1 - x1c
    b = x2 - x2c

    W = b @ a.T
    s = float(np.sqrt(np.sum(b * b) / np.sum(a * a))) if with_scale else 1.0
    R = _procrustes(W, d)
    t = x1c - (1.0 / s) * (R.T @ x2c)
    return R, t, s


def align_3d_pts(x1, x2):
    """(3, n) point alignment with scale (pose_utils.py:806-852)."""
    return align_pts(x1, x2, with_scale=True)


def align_2d_pts(x1, x2):
    """(2, n) point alignment with scale (pose_utils.py:854-900)."""
    return align_pts(x1, x2, with_scale=True)


def align_3d_pts_noscale(x1, x2):
    """(3, n) point alignment, s fixed to 1 (pose_utils.py:902-948)."""
    return align_pts(x1, x2, with_scale=False)


def align_2d_pts_noscale(x1, x2):
    """(2, n) point alignment, s fixed to 1 (pose_utils.py:950-997)."""
    return align_pts(x1, x2, with_scale=False)


def align_camera_poses(
    o1: np.ndarray,
    o2: np.ndarray,
    R1: np.ndarray,
    R2: np.ndarray,
    use_rotation_constraint: bool = True,
):
    """Align camera trajectories using centers and (optionally) orientations.

    :param o1: (3, n) camera centers, source
    :param o2: (3, n) camera centers, target
    :param R1: (n, 3, 3) camera-to-world rotations, source
    :param R2: (n, 3, 3) camera-to-world rotations, target
    :return: (R, t, s) with ``s * R @ (o1 - t) ~= o2`` and ``R @ R1 ~= R2``

    Reference parity: pose_utils.py:999-1071 — the rotation constraints add
    the column outer products of R1/R2 to the correlation matrix before SVD.
    """
    if not use_rotation_constraint:
        return align_pts(o1, o2, with_scale=True)

    o1 = np.asarray(o1, dtype=np.float64)
    o2 = np.asarray(o2, dtype=np.float64)
    o1c = o1.mean(axis=1, keepdims=True)
    o2c = o2.mean(axis=1, keepdims=True)
    a = o1 - o1c
    b = o2 - o2c

    W = b @ a.T
    s = float(np.sqrt(np.sum(b * b) / np.sum(a * a)))

    # rotation constraints: sum over frames and columns of R2[:,c] R1[:,c]^T
    W = W + np.einsum("nij,nkj->ik", np.asarray(R2), np.asarray(R1))

    R = _procrustes(W, 3)
    t = o1c - (1.0 / s) * (R.T @ o2c)
    return R, t, s
