"""Geometry: quaternion / SE(3) / VO ops on torch tensors
(:mod:`quaternion`, :mod:`se3`, :mod:`vo`) and the host-side numpy
rotations, pose processing and metrics (:mod:`rotations`, :mod:`process`,
:mod:`metrics`)."""

from .metrics import quaternion_angular_error, translation_error
from .process import process_poses
from .quaternion import (
    hemisphere,
    normalize,
    qexp,
    qexp_exact,
    qinv,
    qlog,
    qlog_exact,
    qmult,
    qmult_raw,
    rotate_vec_by_q,
    vdot,
)
from .rotations import (
    euler2mat,
    mat2euler,
    mat2quat,
    mat2quat_batch,
    qexp_np,
    qinv_np,
    qlog_np,
    qmult_np,
    quat2mat,
    rotate_vector_np,
)
from .se3 import (
    compose,
    invert,
    relative_pose,
    relative_pose_logq,
    world_relative_pose,
    world_relative_pose_logq,
)
from .vo import pair_indices_fc, vos_logq, vos_logq_fc, vos_simple
