"""Host-side (numpy) VO functions for the data path.

The data loaders attach measured/derived VOs to pose targets on the host
(upstream dataset_loaders/composite.py:89-95 uses the torch "safe"
functions); doing this in numpy avoids per-sample device dispatch. Semantics
match the exact (unclamped) quaternion maps.

A numpy copy of :mod:`geomapnet_tpu.data.vo_np` (that package cannot be
imported without jax); tests/test_torch_import_isolation.py pins the
copy to the original.
"""

from __future__ import annotations

import numpy as np

from ..geometry.rotations import (
    qexp_np,
    qinv_np,
    qlog_np,
    qmult_np,
    rotate_vector_np,
)

__all__ = ["vos_simple_np", "vos_logq_np", "vos_logq_fc_np"]


def vos_simple_np(poses: np.ndarray) -> np.ndarray:
    """(T, 6) -> (T-1, 6) naive subtraction (calc_vos_simple)."""
    return poses[1:] - poses[:-1]


def _relative_logq(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    q0 = qexp_np(p0[..., 3:])
    q1 = qexp_np(p1[..., 3:])
    dt = rotate_vector_np(p1[..., :3] - p0[..., :3], qinv_np(q0))
    q = qmult_np(qinv_np(q0), q1)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([dt, qlog_np(q)], axis=-1)


def vos_logq_np(poses: np.ndarray) -> np.ndarray:
    """(T, 6) -> (T-1, 6) SE(3) relative poses in the earlier frame
    (calc_vos_safe, upstream common/pose_utils.py:276-288)."""
    return _relative_logq(poses[:-1], poses[1:])


def vos_logq_fc_np(poses: np.ndarray) -> np.ndarray:
    """(T, 6) -> (T*(T-1)//2, 6) all-pairs relative poses
    (calc_vos_safe_fc, upstream common/pose_utils.py:290-304)."""
    T = len(poses)
    i, j = np.triu_indices(T, k=1)
    return _relative_logq(poses[i], poses[j])
