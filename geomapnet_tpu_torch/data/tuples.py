"""Tuple (multi-frame) index sampling — the MapNet "MF" logic as pure math.

Separating the index arithmetic from I/O makes it property-testable and lets
the loader turn tuple sampling into a gather over a fixed index matrix
(TPU-friendly: the batch has a static (N, T) shape regardless of clamping).

Reference parity: ``MF.get_indices`` / ``MF.__len__``
(upstream dataset_loaders/composite.py:60-74, 99-103), including:
- centered offsets (subtract the middle element of the cumsum),
- ``variable_skip`` drawing per-gap skips uniformly from [1, skip],
- ``no_duplicates`` shifting right by ``steps//2 * skip`` and shortening the
  sampler length so clamping never duplicates frames,
- clamping into [0, len-1].

A numpy copy of :mod:`geomapnet_tpu.data.tuples` (that package cannot be
imported without jax); tests/test_torch_import_isolation.py pins the
copy to the original.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TupleSampler"]


@dataclasses.dataclass(frozen=True)
class TupleSampler:
    """Maps a center index to the ``steps`` frame indices of its tuple.

    :param dataset_len: length of the underlying frame dataset
    :param steps: frames per tuple (T)
    :param skip: gap between consecutive frames
    :param variable_skip: draw each gap uniformly from [1, skip]
    :param no_duplicates: shift + shorten so tuples never clamp-duplicate
    """

    dataset_len: int
    steps: int = 2
    skip: int = 1
    variable_skip: bool = False
    no_duplicates: bool = False

    def __len__(self) -> int:
        if self.no_duplicates:
            return self.dataset_len - (self.steps - 1) * self.skip
        return self.dataset_len

    def indices(self, index: int, rng: np.random.RandomState | None = None
                ) -> np.ndarray:
        """Frame indices (steps,) for the tuple centered at ``index``."""
        if self.variable_skip:
            if rng is None:
                rng = np.random
            skips = rng.randint(1, high=self.skip + 1, size=self.steps - 1)
        else:
            skips = self.skip * np.ones(self.steps - 1)
        offsets = np.insert(skips, 0, 0).cumsum()
        offsets -= offsets[len(offsets) // 2]
        if self.no_duplicates:
            offsets += (self.steps // 2) * self.skip
        idx = index + offsets.astype(np.int64)
        return np.clip(idx, 0, self.dataset_len - 1)

    def index_matrix(self, rng: np.random.RandomState | None = None
                     ) -> np.ndarray:
        """All tuples at once: (len(self), steps) frame-index matrix.

        With fixed skip this is fully vectorized; with ``variable_skip`` each
        row draws its own gaps (matching per-__getitem__ randomness).
        """
        n = len(self)
        if not self.variable_skip:
            offsets = np.insert(
                self.skip * np.ones(self.steps - 1), 0, 0
            ).cumsum()
            offsets -= offsets[len(offsets) // 2]
            if self.no_duplicates:
                offsets += (self.steps // 2) * self.skip
            idx = np.arange(n)[:, None] + offsets[None, :].astype(np.int64)
            return np.clip(idx, 0, self.dataset_len - 1)
        return np.stack([self.indices(i, rng) for i in range(n)])
