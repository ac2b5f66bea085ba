"""Host-side geometry (numpy): rotations, pose processing, metrics."""
