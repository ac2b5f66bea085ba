"""Multi-frame tuple datasets: MapNet's "MF", MapNet++'s ``MFOnline``.

Numpy copies of :mod:`geomapnet_tpu.data.composite`'s ``MF``, ``MFOnline``
and ``OnlyPoses`` (that package cannot be imported without jax);
tests/test_torch_import_isolation.py pins the copies to the originals.
Reference parity: upstream dataset_loaders/composite.py. Datasets here are
plain Python objects yielding numpy arrays; batching lives in
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

__all__ = ["MF", "MFOnline", "OnlyPoses"]


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


class MFOnline:
    """MapNet++ semi-supervised item: a labeled tuple ++ an unlabeled one.

    Concatenates a train-split tuple (ground-truth absolute poses) with a
    tuple of the unlabeled split whose targets are measured VOs (or its GPS
    absolute positions in ``gps_mode``). Upstream
    dataset_loaders/composite.py:105-129.

    :param train_mf: MF over the labeled train split (include_vos=False)
    :param val_mf: MF over the unlabeled split, built with ``real=True``
        (VO mode), ``include_vos=not gps_mode``, ``no_duplicates=True`` and
        ``vo_func=vos_logq_np``
    """

    def __init__(self, train_mf: MF, val_mf: MF, gps_mode: bool = False):
        self.train_set = train_mf
        self.val_set = val_mf
        self.gps_mode = gps_mode

    @property
    def frame_sources(self) -> tuple:
        """Both splits' base frame datasets, train first; the device frame
        cache concatenates them into one stack, the unlabeled frames offset
        by ``len(train frames)`` (as :meth:`get_indices` counts)."""
        return (self.train_set.dset, self.val_set.dset)

    def get_indices(self, index: int) -> np.ndarray:
        """Frame rows into the concatenated [train frames ++ unlabeled
        frames] stack: the labeled tuple's indices as they are, the
        unlabeled tuple's shifted past the train split."""
        t_idx = self.train_set.get_indices(index % len(self.train_set))
        v_idx = self.val_set.get_indices(index % len(self.val_set))
        return np.concatenate(
            [t_idx, v_idx + len(self.train_set.dset)]).astype(np.int64)

    def _poses_for(self, idx: np.ndarray) -> np.ndarray:
        """The pose block of a :meth:`get_indices` row, assembled as
        ``__getitem__`` does (labeled absolute poses ++ the VO block, or the
        GPS targets)."""
        k = self.train_set.steps
        t_poses = self.train_set._poses_for(np.asarray(idx[:k]))
        v_poses = self.val_set._poses_for(
            np.asarray(idx[k:]) - len(self.train_set.dset))
        if not self.gps_mode:
            v_poses = v_poses[self.val_set.steps:]  # keep only the VO block
        return np.concatenate([t_poses, v_poses], axis=0)

    def __getitem__(self, index: int):
        t_imgs, t_poses = self.train_set[index % len(self.train_set)]
        v_imgs, v_poses = self.val_set[index % len(self.val_set)]
        if not self.gps_mode:
            v_poses = v_poses[self.val_set.steps:]  # keep only the VO block
        if t_imgs is None or v_imgs is None:
            return None, None
        return (
            np.concatenate([t_imgs, v_imgs], axis=0),
            np.concatenate([t_poses, v_poses], axis=0),
        )

    def __len__(self) -> int:
        return len(self.val_set)


class OnlyPoses:
    """Aligned (real, ground-truth) pose pairs, for diagnostics and plots
    (upstream dataset_loaders/composite.py:131-159)."""

    def __init__(self, real_dataset, gt_dataset):
        self.real_dset = real_dataset
        self.gt_dset = gt_dataset

    def __getitem__(self, index: int):
        real = self.real_dset.poses[index].astype(np.float32)
        gt = self.gt_dset.poses[self.real_dset.gt_idx[index]].astype(
            np.float32)
        return real, gt

    def __len__(self) -> int:
        return len(self.real_dset)
