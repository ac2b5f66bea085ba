"""Pose-graph optimization: batched Gauss-Newton (chain and fully
connected) in torch."""

from .pose_graph import (
    chain_pairs,
    gauss_newton_pgo,
    optimize_poses,
    optimize_poses_batch,
)
