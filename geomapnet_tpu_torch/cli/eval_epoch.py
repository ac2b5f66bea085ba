"""The device-cache eval epoch: which frames each forward reads, and how the
per-window poses become per-tuple poses.

The PyTorch counterpart of the device-cache branch of
:func:`geomapnet_tpu.cli.eval._evaluate` (its lines 368-463 and 552-610).
The scene's frames are one tensor on the device
(:func:`geomapnet_tpu_torch.data.device_cache.upload_frames`), and an epoch
is a Python loop of windows of ``B*T`` frames, each preprocessed and run
through the per-frame PoseNet. Three kinds of epoch:

- **tuple**: window ``k`` is batch ``k``'s ``(B, T)`` index rows folded to
  ``B*T`` indices, read with ``index_select``. The last batch's pad rows
  repeat the last tuple. Every tuple slot is computed.
- **dedup**: tuples share frames (``(T-1)*skip`` apart), so a per-frame
  model computes each UNIQUE frame once. ``np.unique`` of the index matrix,
  padded with its last index to ``kf*B*T`` and read in ``kf`` windows; the
  per-tuple poses are a host gather of the ``(U, 6)`` pose table through
  the ``np.unique`` inverse.
- **slice**: a dedup epoch whose unique frames are one consecutive range of
  at least ``B*T`` frames reads each window with ``narrow`` (no gather).
  Windows step ``B*T``; the last one shifts back to end at the range's end
  and re-covers an overlap, whose rows the pose table takes from that last
  window.

VidLoc's clips run the tuple epoch: a frame's pose depends on its whole
clip, so no frame is shared between clips, and the step runs the trunk
over the window's frames and the recurrence over each clip.

Dedup (and so slice) runs only for a per-frame tuple model (MapNet): by
default when it saves windows, always with ``dedup_frames=True`` (which
PoseNet refuses), never with ``dedup_frames=False``. Dynamic-scale int8
(``--quantize`` without ``--calibrate``) is not per-frame: each site
quantizes at its batch's absmax.

The int8 serving eval's prequantized row cache is a 2-D int8 tensor, one
row per frame (:func:`geomapnet_tpu_torch.data.device_cache.quantize_rows`);
its windows are the same ``narrow`` / ``index_select`` of rows, viewed as
``(B*T,) + frame_shape``.

With eval-time dropout (``--eval_dropout``) the epoch is always the tuple
epoch, whose window ``k`` is the loader path's batch ``k``: both draw the
window's keep-mask from :func:`window_generator` of ``(seed, k)``, so the
two paths give the same draws for a seed (the JAX package folds ``k`` into
its eval key for both, cli/eval.py:399-403 and 651-653; the streams
themselves differ from ``jax.random``).

Data parallel (a :class:`geomapnet_tpu_torch.parallel.DataParallel` of
``W`` ranks): every rank plans the same epoch and computes rows ``[r *
B*T/W, (r + 1) * B*T/W)`` of every window, read from its replica of the
cache (``narrow`` / ``index_select``) or, from the frame-sharded cache,
by the sharded gather's reduce-scatter over the window's full index list
(:func:`geomapnet_tpu_torch.data.device_cache.make_sharded_gather`; a
slice window is its consecutive indices). The rank's trunk features are
all-gathered (one ``all_gather_into_tensor`` a window) and every rank
runs the heads on the whole window, so the heads see the one-rank batch
(a cuBLAS GEMM's result for a row may change with the rows beside it)
and dropout draws the whole window's mask from the window's generator:
the poses do not depend on ``W`` beyond the trunk's float rounding.

There is no cache of captured programs and no CUDA graph here: every epoch
runs the modules it is given eagerly, so nothing can be reused across
calls with stale batch sizes or frame shapes (the JAX package's compiled
epoch cache keys on neither, ROADMAP.md Queue 3, fault R1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..data.composite import MF
from ..models.vidloc import VidLoc

__all__ = ["EpochPlan", "plan_epoch", "make_step", "run_epoch",
           "gather_windows", "tuple_outputs", "tuple_index_matrix",
           "window_generator"]


@dataclasses.dataclass
class EpochPlan:
    """What every forward of an epoch reads.

    :param idx_mat: (S, T) frame indices of the tuples
    :param batch_size: tuples per window (B)
    :param mode: "tuple", "dedup" or "slice"
    :param windows: (k, B*T) frame indices of each window, or for "slice"
        the (k,) first frame of each window
    :param uniq: sorted unique frame indices (dedup and slice)
    :param inverse: position of each ``idx_mat`` entry in ``uniq``
    """

    idx_mat: np.ndarray
    batch_size: int
    mode: str
    windows: np.ndarray
    uniq: np.ndarray | None = None
    inverse: np.ndarray | None = None

    @property
    def steps(self) -> int:
        return self.idx_mat.shape[1]

    @property
    def window_frames(self) -> int:
        return self.batch_size * self.steps

    @property
    def frames_computed(self) -> int:
        """Forwards the epoch runs, pad frames included."""
        return len(self.windows) * self.window_frames


def tuple_index_matrix(dataset, is_tuple: bool) -> np.ndarray:
    """(S, T) frame indices of every sample: the MF tuples, or (S, 1) for a
    plain frame dataset."""
    if (is_tuple and not dataset.sampler.variable_skip
            and type(dataset).get_indices is MF.get_indices):
        # MF's own tuples with fixed gaps: every one in one pass
        return dataset.sampler.index_matrix().astype(np.int64)
    if is_tuple:
        return np.stack([dataset.get_indices(i)
                         for i in range(len(dataset))]).astype(np.int64)
    return np.arange(len(dataset), dtype=np.int64)[:, None]


def plan_epoch(idx_mat: np.ndarray, batch_size: int, per_frame: bool,
               dedup_frames: bool | None = None) -> EpochPlan:
    """Pick the epoch for an (S, T) index matrix.

    :param per_frame: the model's pose for a frame does not depend on the
        rest of its tuple or batch (MapNet at eval), so dedup is exact
    :param dedup_frames: None = dedup when it saves windows, True = always
        (needs ``per_frame``), False = never
    """
    if dedup_frames and not per_frame:
        raise ValueError(
            "dedup_frames needs a per-frame (MapNet-style) tuple model")
    S, T = idx_mat.shape
    nb_flat = batch_size * T
    n_batches = -(-S // batch_size)
    if per_frame and dedup_frames is not False:
        uniq, inverse = np.unique(idx_mat, return_inverse=True)
        U = len(uniq)
        kf = -(-U // nb_flat)
        if dedup_frames or kf < n_batches:
            if U >= nb_flat and int(uniq[-1]) - int(uniq[0]) == U - 1:
                starts = (np.minimum(np.arange(kf) * nb_flat, U - nb_flat)
                          + int(uniq[0]))
                return EpochPlan(idx_mat, batch_size, "slice", starts,
                                 uniq, inverse)
            fidx = np.concatenate(
                [uniq, np.full(kf * nb_flat - U, uniq[-1])])
            return EpochPlan(idx_mat, batch_size, "dedup",
                             fidx.reshape(kf, nb_flat), uniq, inverse)
    pad_rows = n_batches * batch_size - S
    idx_all = np.concatenate(
        [idx_mat, np.repeat(idx_mat[-1:], pad_rows, axis=0)])
    return EpochPlan(idx_mat, batch_size, "tuple",
                     idx_all.reshape(n_batches, nb_flat))


def window_generator(seed: int, index: int,
                     device: torch.device) -> torch.Generator:
    """The dropout generator of window (or loader batch) ``index`` of an
    eval seeded with ``seed``, on ``device``."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + index) % 2 ** 63)


def make_step(model: torch.nn.Module, preprocess: Callable | None,
              steps: int, mesh=None) -> Callable[..., torch.Tensor]:
    """``step(frames, generator=None) -> poses``: (B*T, H, W, C) frames of
    B tuples through ``preprocess`` and the per-frame PoseNet (MapNet's
    shared one, or a :class:`~geomapnet_tpu_torch.models.quant.
    QuantizedPoseNet`) to (B, T, 6) poses; with a ``generator`` the
    PoseNet's dropout is active. int8 frames are the prequantized row
    cache's: they skip ``preprocess``.

    ``mesh`` (a data-parallel group of ``W`` > 1 ranks): ``frames`` are
    this rank's ``B*T/W`` rows of the window, rank-major; their trunk
    features are all-gathered and the heads run on the whole window, whose
    (B, T, 6) poses every rank returns.

    A :class:`~geomapnet_tpu_torch.models.vidloc.VidLoc` runs its trunk
    over the frames and its head (dropout, recurrence, ``fc_pose``) over
    the B clips of T."""
    posenet = getattr(model, "posenet", model)
    gather = mesh is not None and mesh.world_size > 1
    if isinstance(posenet, VidLoc):
        def clip_step(frames: torch.Tensor,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
            if preprocess is not None:
                frames = preprocess(frames)
            feats = posenet.features(frames)
            if gather:
                feats = mesh.all_gather(feats)
            return posenet.head(feats.reshape(-1, steps, feats.shape[-1]),
                                generator)

        return clip_step

    def step(frames: torch.Tensor,
             generator: torch.Generator | None = None) -> torch.Tensor:
        if preprocess is not None and frames.dtype != torch.int8:
            frames = preprocess(frames)
        feats = posenet.features(frames)
        if gather:
            feats = mesh.all_gather(feats)
        out = (posenet.head(feats) if generator is None
               else posenet.head(feats, generator))
        return out.reshape(-1, steps, 6)

    return step


def gather_windows(outs: torch.Tensor, mesh) -> torch.Tensor:
    """(k, B/W, ...) per-window rows of every rank -> the (k, B, ...)
    windows on every rank (one all-gather; ranks' rows in rank order)."""
    if mesh is None:
        return outs
    W = mesh.world_size
    full = mesh.all_gather(outs)
    return full.view((W,) + tuple(outs.shape)).transpose(0, 1).reshape(
        (outs.shape[0], W * outs.shape[1]) + tuple(outs.shape[2:]))


def run_epoch(plan: EpochPlan, frames: torch.Tensor,
              step: Callable[..., torch.Tensor],
              frame_shape: tuple | None = None,
              dropout_seed: int | None = None, mesh=None,
              sharded_gather: Callable | None = None) -> torch.Tensor:
    """Run every window of ``plan`` over the device frame stack ``frames``;
    returns the (k, B, T, 6) poses on the device (no host sync).

    ``frame_shape``: ``frames`` is a 2-D row cache; each window's rows are
    viewed as ``(B*T,) + frame_shape``. ``dropout_seed``: window ``k`` runs
    with dropout drawn from ``window_generator(dropout_seed, k)`` (tuple
    epochs only). ``mesh``: a data-parallel group; this rank reads its
    rows of every window, and ``step`` (:func:`make_step` with the same
    ``mesh``) returns the whole window. ``sharded_gather``: ``frames`` is
    this rank's shard of a frame-sharded cache, read through this gather.
    """
    if dropout_seed is not None and plan.mode != "tuple":
        raise ValueError("eval-time dropout runs the tuple epoch only")
    n = plan.window_frames
    W, rank = (1, 0) if mesh is None else (mesh.world_size, mesh.rank)
    per = n // W
    lo, hi = rank * per, (rank + 1) * per
    dev = frames.device

    def view(rows: torch.Tensor) -> torch.Tensor:
        return rows if frame_shape is None else rows.view(
            (-1,) + tuple(frame_shape))

    def read(window: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a window given by its (n,) indices."""
        if sharded_gather is not None:
            return sharded_gather(frames, window)
        return frames.index_select(0, window[lo:hi])

    outs = []
    with torch.inference_mode():
        if plan.mode == "slice":
            for start in plan.windows.tolist():
                if sharded_gather is None:
                    rows = frames.narrow(0, start + lo, per)
                else:
                    rows = read(torch.arange(start, start + n, device=dev))
                outs.append(step(view(rows)))
        else:
            idx = torch.from_numpy(plan.windows).to(dev)
            for k, row in enumerate(idx):
                gen = None if dropout_seed is None else window_generator(
                    dropout_seed, k, dev)
                outs.append(step(view(read(row)), gen))
        return torch.stack(outs)


def tuple_outputs(plan: EpochPlan, outs: np.ndarray) -> np.ndarray:
    """(k, B, T, d) window outputs -> (S, T, d) outputs per tuple."""
    S, T = plan.idx_mat.shape
    d = outs.shape[-1]
    fp = outs.reshape(-1, d)
    if plan.mode == "tuple":
        return fp.reshape(-1, T, d)[:S]
    U = len(plan.uniq)
    if plan.mode == "slice":
        # frame uniq[r] sits at flat slot r up to the last window, which
        # re-covers [U - B*T, U): those rows come from the last window
        nb_flat = plan.window_frames
        head = (len(plan.windows) - 1) * nb_flat
        table = np.empty((U, d), fp.dtype)
        table[:head] = fp[:head]
        table[U - nb_flat:] = fp[head:]
    else:
        table = fp[:U]
    return table[plan.inverse].reshape(S, T, d)
