"""Pose-regression training criteria (``losses/criterion.py``)."""

from .criterion import (
    MapNetCriterion,
    MapNetOnlineCriterion,
    PoseNetCriterion,
    l1_loss,
    quaternion_loss,
)

__all__ = ["l1_loss", "quaternion_loss", "PoseNetCriterion",
           "MapNetCriterion", "MapNetOnlineCriterion"]
