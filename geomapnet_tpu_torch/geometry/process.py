"""Dataset pose preprocessing (host-side numpy, vectorized).

Converts raw N x 12 flattened ``[R | t]`` world-from-camera rows into the
N x 6 ``[t, logq]`` training targets, applying the per-sequence VO->GT
similarity alignment and the dataset translation normalization.

Reference parity: ``process_poses``
(upstream common/pose_utils.py:329-356), which loops per pose; here the
whole sequence is processed with batched linear algebra.

A numpy copy of :mod:`geomapnet_tpu.geometry.process` (that package cannot be
imported without jax); tests/test_torch_import_isolation.py pins the
copy to the original.
"""

from __future__ import annotations

import numpy as np

from .rotations import mat2quat_batch, qlog_np

__all__ = ["process_poses"]


def process_poses(
    poses_in: np.ndarray,
    mean_t: np.ndarray,
    std_t: np.ndarray,
    align_R: np.ndarray,
    align_t: np.ndarray,
    align_s: float,
) -> np.ndarray:
    """Align and normalize raw poses.

    :param poses_in: (N, 12) flattened 3x4 ``[R | t]`` rows
    :param mean_t: (3,) translation mean for normalization
    :param std_t: (3,) translation std for normalization
    :param align_R: (3, 3) alignment rotation
    :param align_t: (3,) alignment translation
    :param align_s: scalar alignment scale
    :return: (N, 6) ``[t_normalized, logq]`` poses
    """
    poses_in = np.asarray(poses_in, dtype=np.float64).reshape(-1, 12)
    N = len(poses_in)
    out = np.zeros((N, 6))

    # rotations: R -> align_R @ R -> quaternion (w >= 0 hemisphere) -> log map
    R = poses_in.reshape(N, 3, 4)[:, :3, :3]
    # hemisphere-constrain: the reference multiplies by sign(w)
    # (upstream common/pose_utils.py:347) which zeroes the quaternion
    # when w == 0 exactly (a 180-degree rotation); negating only when w < 0 is
    # identical everywhere else and keeps 180-degree rotations intact.
    q = mat2quat_batch(np.einsum("ij,njk->nik", np.asarray(align_R), R))
    q = np.where(q[:, :1] < 0, -q, q)
    out[:, 3:] = qlog_np(q)

    # translations: similarity-align then mean/std normalize
    t = poses_in[:, [3, 7, 11]] - np.asarray(align_t)
    out[:, :3] = align_s * t @ np.asarray(align_R).T
    out[:, :3] = (out[:, :3] - np.asarray(mean_t)) / np.asarray(std_t)
    return out
