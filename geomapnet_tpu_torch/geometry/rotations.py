"""Host-side (numpy) rotation conversions and quaternion helpers.

The reference depends on the external ``transforms3d`` package for
matrix<->quaternion<->euler conversions (upstream common/
pose_utils.py:13-14); this project does not depend on it, so the needed
subset is implemented from the standard published formulas:

- ``mat2quat`` uses the Bar-Itzhack/Shepperd symmetric-K eigenvector method
  (numerically robust for all rotations), returning w >= 0;
- ``quat2mat`` is the standard unit-quaternion rotation matrix;
- ``euler2mat``/``mat2euler`` use the static-xyz convention
  (R = Rz(az) @ Ry(ay) @ Rx(ax)), matching ``transforms3d.euler`` defaults.

These run in dataset construction and tooling (host prep), not on device.
Vectorized variants accept leading batch dimensions where noted.

A numpy copy of :mod:`geomapnet_tpu.geometry.rotations` (that package cannot be
imported without jax); tests/test_torch_import_isolation.py pins the
copy to the original.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "mat2quat",
    "mat2quat_batch",
    "quat2mat",
    "euler2mat",
    "mat2euler",
    "qmult_np",
    "qinv_np",
    "qexp_np",
    "qlog_np",
    "rotate_vector_np",
]


def _kmatrix(M: np.ndarray) -> np.ndarray:
    """Symmetric 4x4 K matrix whose principal eigenvector is the quaternion.

    Accepts (..., 3, 3); returns (..., 4, 4). Quaternion layout inside K is
    [x, y, z, w] (rearranged to scalar-first by the callers).
    """
    Qxx, Qyx, Qzx = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Qxy, Qyy, Qzy = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Qxz, Qyz, Qzz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    K = np.stack(
        [
            np.stack([Qxx - Qyy - Qzz, Qyx + Qxy, Qzx + Qxz, Qyz - Qzy], axis=-1),
            np.stack([Qyx + Qxy, Qyy - Qxx - Qzz, Qzy + Qyz, Qzx - Qxz], axis=-1),
            np.stack([Qzx + Qxz, Qzy + Qyz, Qzz - Qxx - Qyy, Qxy - Qyx], axis=-1),
            np.stack([Qyz - Qzy, Qzx - Qxz, Qxy - Qyx, Qxx + Qyy + Qzz], axis=-1),
        ],
        axis=-2,
    ) / 3.0
    return K


def mat2quat(M: np.ndarray) -> np.ndarray:
    """(3, 3) rotation matrix -> (4,) unit quaternion [w, x, y, z], w >= 0."""
    return mat2quat_batch(np.asarray(M)[None])[0]


def mat2quat_batch(M: np.ndarray) -> np.ndarray:
    """(..., 3, 3) rotation matrices -> (..., 4) unit quaternions, w >= 0."""
    K = _kmatrix(np.asarray(M, dtype=np.float64))
    vals, vecs = np.linalg.eigh(K)
    # principal eigenvector (largest eigenvalue is last in eigh's ordering)
    v = vecs[..., :, -1]  # (..., 4) in [x, y, z, w] order
    q = np.concatenate([v[..., 3:4], v[..., 0:3]], axis=-1)
    return np.where(q[..., :1] < 0, -q, q)


def quat2mat(q: np.ndarray) -> np.ndarray:
    """(..., 4) quaternion [w, x, y, z] -> (..., 3, 3) rotation matrix."""
    q = np.asarray(q, dtype=np.float64)
    n = np.sum(q * q, axis=-1, keepdims=True)
    q = q * np.sqrt(2.0 / np.where(n > 0, n, 1.0))
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.stack(
        [
            np.stack([1 - y * y - z * z, x * y - z * w, x * z + y * w], axis=-1),
            np.stack([x * y + z * w, 1 - x * x - z * z, y * z - x * w], axis=-1),
            np.stack([x * z - y * w, y * z + x * w, 1 - x * x - y * y], axis=-1),
        ],
        axis=-2,
    )
    return R


def _axis_rot(angle: float, axis: int) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    R = np.eye(3)
    a, b = [(1, 2), (0, 2), (0, 1)][axis]
    R[a, a] = c
    R[b, b] = c
    if axis == 1:
        R[a, b] = s
        R[b, a] = -s
    else:
        R[a, b] = -s
        R[b, a] = s
    return R


def euler2mat(ax: float, ay: float, az: float) -> np.ndarray:
    """Static-xyz euler angles -> rotation matrix: Rz(az) @ Ry(ay) @ Rx(ax)."""
    return _axis_rot(az, 2) @ _axis_rot(ay, 1) @ _axis_rot(ax, 0)


def mat2euler(M: np.ndarray) -> tuple[float, float, float]:
    """Rotation matrix -> static-xyz euler angles (inverse of euler2mat)."""
    M = np.asarray(M)
    cy = np.hypot(M[0, 0], M[1, 0])
    if cy > 1e-8:
        ax = np.arctan2(M[2, 1], M[2, 2])
        ay = np.arctan2(-M[2, 0], cy)
        az = np.arctan2(M[1, 0], M[0, 0])
    else:
        ax = np.arctan2(-M[1, 2], M[1, 1])
        ay = np.arctan2(-M[2, 0], cy)
        az = 0.0
    return float(ax), float(ay), float(az)


def qmult_np(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Hamilton product (..., 4) x (..., 4) -> (..., 4), not normalized."""
    w1, v1 = q1[..., :1], q1[..., 1:]
    w2, v2 = q2[..., :1], q2[..., 1:]
    w = w1 * w2 - np.sum(v1 * v2, axis=-1, keepdims=True)
    v = w2 * v1 + w1 * v2 + np.cross(v1, v2)
    return np.concatenate([w, v], axis=-1)


def qinv_np(q: np.ndarray) -> np.ndarray:
    """Conjugate of a unit quaternion."""
    return np.concatenate([q[..., :1], -q[..., 1:]], axis=-1)


def qexp_np(logq: np.ndarray) -> np.ndarray:
    """Exponential map, exact sinc form. (..., 3) -> (..., 4).

    Matches the reference's numpy ``qexp``
    (upstream common/pose_utils.py:319-327).
    """
    logq = np.asarray(logq)
    n = np.linalg.norm(logq, axis=-1, keepdims=True)
    return np.concatenate([np.cos(n), np.sinc(n / np.pi) * logq], axis=-1)


def qlog_np(q: np.ndarray) -> np.ndarray:
    """Log map, exactly zero at identity. (..., 4) -> (..., 3).

    Matches the reference's numpy ``qlog``
    (upstream common/pose_utils.py:307-317).
    """
    q = np.asarray(q)
    v = q[..., 1:]
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    angle = np.arccos(np.clip(q[..., :1], -1.0, 1.0))
    scale = np.where(n > 0, angle / np.where(n > 0, n, 1.0), 0.0)
    return v * scale


def rotate_vector_np(t: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Rotate vectors (..., 3) by unit quaternions (..., 4)."""
    w, v = q[..., :1], q[..., 1:]
    b = np.cross(v, t)
    return t + 2.0 * w * b + 2.0 * np.cross(v, b)
