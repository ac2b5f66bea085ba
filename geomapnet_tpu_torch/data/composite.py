"""Multi-frame tuple dataset (MapNet's "MF").

A numpy copy of :class:`geomapnet_tpu.data.composite.MF` (that package
cannot be imported without jax); tests/test_torch_import_isolation.py pins
the copy to the original. Reference parity: upstream
dataset_loaders/composite.py. Datasets here are plain Python objects
yielding numpy arrays; batching lives in
:mod:`geomapnet_tpu_torch.data.loader`.

A frame dataset must provide:
- ``__len__``
- ``poses``: (N, 6) float array of [t, logq] targets
- ``get_image(i)`` -> numpy image array or None (corrupt frame)
- ``gt_idx``: (N,) mapping into the matching GT dataset (real/VO datasets)
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .tuples import TupleSampler
from .vo_np import vos_simple_np

__all__ = ["MF"]


class MF:
    """Multi-frame tuple dataset: images (T, H, W, 3) + poses (T, 6).

    With ``include_vos`` the VOs are appended to the pose block, and with
    ``real`` the absolute poses are swapped for GT via ``gt_idx``
    (upstream dataset_loaders/composite.py:76-97).
    """

    def __init__(
        self,
        dataset,
        steps: int = 2,
        skip: int = 1,
        variable_skip: bool = False,
        include_vos: bool = False,
        no_duplicates: bool = False,
        real: bool = False,
        gt_dataset=None,
        vo_func: Callable = vos_simple_np,
        seed: int = 7,
        deterministic_indices: bool = False,
    ):
        self.dset = dataset
        self.gt_dset = gt_dataset
        self.include_vos = include_vos
        self.real = real
        self.vo_func = vo_func
        self.seed = seed
        # deterministic_indices makes get_indices(i) a pure function of i
        # (per-index seeded RNG for variable_skip) so a later caller — e.g.
        # eval's middle-frame scatter — reconstructs exactly the tuple the
        # loader fetched. Training keeps the shared-RNG behavior (fresh
        # random skips every epoch, like the reference).
        self.deterministic_indices = deterministic_indices
        self.rng = np.random.RandomState(seed)
        self.sampler = TupleSampler(
            dataset_len=len(dataset),
            steps=steps,
            skip=skip,
            variable_skip=variable_skip,
            no_duplicates=no_duplicates,
        )
        if include_vos and real and gt_dataset is None:
            raise ValueError("real VO tuples need a gt_dataset for abs poses")

    @property
    def steps(self) -> int:
        return self.sampler.steps

    def get_indices(self, index: int) -> np.ndarray:
        rng = (
            np.random.RandomState((self.seed * 1000003 + index) % (2**31))
            if self.deterministic_indices else self.rng
        )
        return self.sampler.indices(index, rng)

    def _poses_for(self, idx: np.ndarray) -> np.ndarray:
        poses = self.dset.poses[idx].astype(np.float32)
        if self.include_vos:
            vos = self.vo_func(poses).astype(np.float32)
            if self.real:  # absolute poses must come from GT
                gt = self.dset.gt_idx[idx]
                poses = self.gt_dset.poses[gt].astype(np.float32)
            poses = np.concatenate([poses, vos], axis=0)
        return poses

    def __getitem__(self, index: int):
        idx = self.get_indices(index)
        imgs = [self.dset.get_image(i) for i in idx]
        imgs = None if any(im is None for im in imgs) else np.stack(imgs)
        return imgs, self._poses_for(idx)

    def fetch_many(self, indices, num_workers: int = 4) -> list:
        """Batched fetch: frame images for ALL requested tuples resolve in
        one ``get_images`` call on the base dataset when it has one.

        Frame indices are DEDUPLICATED before decoding: consecutive tuples
        overlap (each frame belongs to up to ``steps`` tuples), so a batch of
        B tuples touches ~B + (steps-1)*skip unique frames but B*steps tuple
        slots; decoding unique frames once cuts host decode work by up to
        ``steps``x."""
        tuple_idx = [self.get_indices(i) for i in indices]
        flat = np.concatenate(tuple_idx) if tuple_idx else np.empty(0, int)
        uniq, inverse = np.unique(flat, return_inverse=True)
        if hasattr(self.dset, "get_images"):
            uniq_imgs = self.dset.get_images(uniq, num_workers=num_workers)
        else:
            uniq_imgs = [self.dset.get_image(i) for i in uniq]
        flat_imgs = [uniq_imgs[j] for j in inverse]
        out, k = [], 0
        for idx in tuple_idx:
            imgs = flat_imgs[k:k + len(idx)]
            k += len(idx)
            imgs = None if any(im is None for im in imgs) else np.stack(imgs)
            out.append((imgs, self._poses_for(idx)))
        return out

    def __len__(self) -> int:
        return len(self.sampler)
