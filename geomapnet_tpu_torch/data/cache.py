"""Decoded-frame cache: pay PNG decode once, serve every later pass from RAM.

A copy of :class:`geomapnet_tpu.data.cache.CachedScene` (that package cannot
be imported without jax); tests/test_torch_import_isolation.py pins the copy
to the original. :class:`CachedScene` wraps a scene dataset (SevenScenes /
RobotCar) and memoizes per-frame results up to a byte budget (``--cache_frames
GB`` on the eval CLI), so repeated passes run at memory speed. Disk formats
are untouched.

- **Pin-first, no eviction.** Epoch access is uniform over all frames, the
  pathological case for LRU. Pinning whichever frames arrive first until the
  budget is full serves fraction ``f`` of requests from RAM for a budget
  covering fraction ``f`` of the dataset.
- **Post-transform entries.** With the device-side pipeline, entries are
  resized uint8 (a 256x341 frame is 262 KB). Caching after the transform is
  only correct when the transform is deterministic, so the wrapper REFUSES
  stochastic host jitter (``color_jitter_strength > 0``).
- Entries are frozen (numpy ``writeable=False``) so an accidental in-place
  edit by a consumer raises instead of corrupting later passes.
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["CachedScene"]


def _nbytes(sample) -> int:
    if sample is None:
        return 0
    if isinstance(sample, (list, tuple)):
        return sum(_nbytes(s) for s in sample)
    return sample.nbytes


def _freeze(sample):
    if isinstance(sample, (list, tuple)):
        return [_freeze(s) for s in sample]
    if isinstance(sample, np.ndarray):
        sample.setflags(write=False)
    return sample


class CachedScene:
    """Wrap a scene dataset, memoizing ``get_image``/``get_images`` by index.

    Everything else (``poses``, ``gt_idx``, stats attributes, …) delegates to
    the wrapped dataset, so composites (MF) and the Loader see an identical
    surface.

    :param dataset: scene dataset exposing ``get_image`` (and optionally
        ``get_images``), e.g. :class:`~geomapnet_tpu_torch.data.sevenscenes.
        SevenScenes`
    :param max_bytes: cache budget; once full, further frames pass through
    """

    def __init__(self, dataset, max_bytes: int):
        jitter = getattr(
            getattr(dataset, "transform", None), "color_jitter_strength", 0)
        if jitter:
            raise ValueError(
                "CachedScene caches post-transform frames and the wrapped "
                f"dataset jitters (color_jitter_strength={jitter}): a cached "
                "frame would repeat one jitter draw every epoch. Disable the "
                "cache or the jitter."
            )
        self.dataset = dataset
        self.max_bytes = int(max_bytes)
        self._entries: dict[int, object] = {}
        self._bytes = 0
        self._full = False
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    # -- stats ---------------------------------------------------------
    @property
    def cached_frames(self) -> int:
        return len(self._entries)

    @property
    def cached_bytes(self) -> int:
        return self._bytes

    # -- dataset surface -------------------------------------------------
    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def __len__(self) -> int:
        return len(self.dataset)

    def get_image(self, index: int):
        return self.get_images([index], num_workers=1)[0]

    def get_images(self, indices, num_workers: int = 4) -> list:
        indices = [int(i) for i in indices]
        with self._lock:
            found = {i: self._entries[i] for i in set(indices)
                     if i in self._entries}
        missing = sorted(set(indices) - set(found))
        self.hits += len(indices) - sum(i in missing for i in indices)
        self.misses += sum(i in missing for i in indices)
        if missing:
            if hasattr(self.dataset, "get_images"):
                fresh = self.dataset.get_images(missing,
                                                num_workers=num_workers)
            else:
                fresh = [self.dataset.get_image(i) for i in missing]
            with self._lock:
                for i, sample in zip(missing, fresh):
                    found[i] = sample
                    # never cache failed decodes: the file may be replaced
                    if sample is None or self._full:
                        continue
                    size = _nbytes(sample)
                    if self._bytes + size > self.max_bytes:
                        self._full = True
                        continue
                    self._entries[i] = _freeze(sample)
                    self._bytes += size
        return [found[i] for i in indices]

    def __getitem__(self, index: int):
        # mirrors the scene datasets' __getitem__ (image + transformed pose)
        # so Loader paths that bypass composites also hit the cache
        pose = self.dataset.poses[index]
        tt = getattr(self.dataset, "target_transform", None)
        if tt is not None:
            pose = tt(pose)
        return self.get_image(index), pose
