"""Pose-regression training criteria (``losses/criterion.py``)."""
