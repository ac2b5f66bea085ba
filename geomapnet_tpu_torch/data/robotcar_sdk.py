"""Oxford RobotCar INS and VO pose interpolation (host-side numpy).

The pose part of :mod:`geomapnet_tpu.data.robotcar_sdk`, copied so the port
needs no jax (tests/test_torch_import_isolation.py pins it to the
original). ``gps/ins.csv`` (and ``gps/gps_ins.csv``) hold absolute INS
solutions in the UTM frame (timestamp, northing, easting, down, roll,
pitch, yaw); ``vo/vo.csv`` holds the relative motion between consecutive
stereo frames (source_timestamp, destination_timestamp, x, y, z, roll,
pitch, yaw), integrated into a trajectory first. SE(3) poses are sampled at
the image timestamps by SLERP (rotation) + linear (translation) between the
bracketing measurements, expressed relative to the pose at
``origin_timestamp``, as the robotcar-dataset-sdk does. The euler convention
is R = Rz(yaw) @ Ry(pitch) @ Rx(roll).
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from ..geometry.rotations import euler2mat, mat2quat_batch, quat2mat

__all__ = ["interpolate_ins_poses", "interpolate_vo_poses"]


def _se3(xyz: np.ndarray, rpy: np.ndarray) -> np.ndarray:
    """(..., 3) translation + (..., 3) roll/pitch/yaw -> (..., 4, 4)."""
    xyz = np.atleast_2d(xyz)
    rpy = np.atleast_2d(rpy)
    n = len(xyz)
    out = np.tile(np.eye(4), (n, 1, 1))
    for k in range(n):
        out[k, :3, :3] = euler2mat(rpy[k, 0], rpy[k, 1], rpy[k, 2])
    out[:, :3, 3] = xyz
    return out


def _slerp(q0: np.ndarray, q1: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Batch SLERP between unit quaternions with shortest-path sign fix.

    q0, q1: (N, 4); f: (N,) fractions in [0, 1].
    """
    d = np.sum(q0 * q1, axis=1)
    q1 = np.where(d[:, None] < 0, -q1, q1)
    d = np.abs(np.clip(d, -1.0, 1.0))

    theta = np.arccos(d)
    sin_theta = np.sin(theta)
    small = sin_theta < 1e-6
    w0 = np.where(small, 1.0 - f, np.sin((1.0 - f) * theta) / np.where(small, 1, sin_theta))
    w1 = np.where(small, f, np.sin(f * theta) / np.where(small, 1, sin_theta))
    q = w0[:, None] * q0 + w1[:, None] * q1
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _interpolate_se3(
    ts: np.ndarray,
    poses: np.ndarray,
    requested: np.ndarray,
    origin_timestamp: int,
) -> np.ndarray:
    """Sample SE(3) poses at ``requested`` timestamps, relative to origin.

    :param ts: (M,) sorted measurement timestamps
    :param poses: (M, 4, 4) absolute poses
    :param requested: (K,) query timestamps
    :return: (K, 4, 4) poses with origin's pose as identity
    """
    req = np.concatenate([[origin_timestamp], np.asarray(requested)])
    u = np.clip(np.searchsorted(ts, req), 1, len(ts) - 1)
    l = u - 1
    denom = (ts[u] - ts[l]).astype(np.float64)
    f = np.clip((req - ts[l]) / np.where(denom == 0, 1, denom), 0.0, 1.0)

    q = mat2quat_batch(poses[:, :3, :3])
    q_i = _slerp(q[l], q[u], f)
    t_i = (1 - f)[:, None] * poses[l, :3, 3] + f[:, None] * poses[u, :3, 3]

    out = np.tile(np.eye(4), (len(req), 1, 1))
    out[:, :3, :3] = quat2mat(q_i)
    out[:, :3, 3] = t_i

    origin_inv = np.linalg.inv(out[0])
    return np.einsum("ij,njk->nik", origin_inv, out)[1:]


def interpolate_ins_poses(
    ins_path: str | Path,
    pose_timestamps: list[int],
    origin_timestamp: int,
) -> list[np.ndarray]:
    """Absolute INS poses sampled at image timestamps (SDK-compatible).

    Builds UTM-frame SE(3) poses from (northing, easting, down, roll, pitch,
    yaw) and interpolates.
    """
    ts, xyz, rpy = [], [], []
    with open(ins_path) as f:
        reader = csv.DictReader(f)
        for row in reader:
            ts.append(int(row["timestamp"]))
            xyz.append([float(row["northing"]), float(row["easting"]),
                        float(row["down"])])
            rpy.append([float(row["roll"]), float(row["pitch"]),
                        float(row["yaw"])])
    ts = np.asarray(ts)
    order = np.argsort(ts)
    poses = _se3(np.asarray(xyz)[order], np.asarray(rpy)[order])
    out = _interpolate_se3(ts[order], poses,
                           np.asarray(pose_timestamps), origin_timestamp)
    return list(out)


def interpolate_vo_poses(
    vo_path: str | Path,
    pose_timestamps: list[int],
    origin_timestamp: int,
) -> list[np.ndarray]:
    """Integrated relative VO sampled at image timestamps (SDK-compatible).

    Each vo.csv row carries the relative motion of the ``source_timestamp``
    frame (the later one); chaining rows in file order integrates the
    trajectory. As in the SDK, the integrated poses are keyed by source
    timestamp, with an identity pose at a leading dummy timestamp 0.
    """
    ts = [0]
    abs_poses = [np.eye(4)]
    with open(vo_path) as f:
        reader = csv.DictReader(f)
        for row in reader:
            rel = _se3(
                np.asarray([[float(row[k]) for k in ("x", "y", "z")]]),
                np.asarray([[float(row[k]) for k in ("roll", "pitch",
                                                     "yaw")]]),
            )[0]
            ts.append(int(row["source_timestamp"]))
            abs_poses.append(abs_poses[-1] @ rel)
    ts = np.asarray(ts)
    poses = np.stack(abs_poses)
    return list(
        _interpolate_se3(ts, poses, np.asarray(pose_timestamps),
                         origin_timestamp)
    )
