"""The train and eval steps.

The PyTorch counterpart of :mod:`geomapnet_tpu.train.state` (upstream
``step_feedfwd``, common/train.py:322-363). The JAX package's train state is
one immutable pytree; here it lives where PyTorch keeps it: parameters and
BatchNorm statistics in the model, loss weights in the criterion, moments
and the update count in the :class:`~geomapnet_tpu_torch.train.optim.
Optimizer`. A step runs forward, loss, backward, clip, update and the
BatchNorm running-statistics update, and returns the loss as a device
tensor (no host sync).

Dropout keep-masks are a counter-based hash of (seed, update count,
microbatch, element) computed on the device from the optimizer's
``step_t`` (:func:`step_keep_mask`): the counterpart of JAX's
``fold_in(rng, step)`` and ``fold_in(., k)``, the same on every device and
inside a CUDA graph, where a host-seeded generator could not be captured.
The stream differs from ``jax.random`` (ROADMAP.md Queue 3), so parity with
JAX injects the keep-masks.

With a device frame cache the step takes frame indices and the cache
(``frames``) and gathers each microbatch's frames on the device before the
preprocess (:func:`gather_frames`). ``remat=True`` recomputes the model's
forward in the backward (``torch.utils.checkpoint``); the recompute runs
BatchNorm on the same batch statistics without moving its running
statistics a second time (:func:`geomapnet_tpu_torch.models.resnet.
recomputing_batch_norm`).

Data parallel (``mesh``, :func:`geomapnet_tpu_torch.parallel.shard_step`):
each rank runs its share of every global microbatch (BatchNorm synced over
the group), and after the microbatch sum and the division by the
microbatch count the gradients and the loss are all-reduced and averaged in
one flat bucket, before the clip and the update: the update of JAX's
global-batch step. The dropout hash runs over the GLOBAL element indices
of each microbatch (this rank's rows offset by its position), so a W-rank
step draws the masks of the 1-rank step on the same global batch.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..models.resnet import recomputing_batch_norm
from ..parallel.mesh import GradientBucket, shard_step
from ..parallel.multihost import global_row_offset
from .optim import Optimizer

__all__ = ["step_keep_mask", "gather_frames", "TrainStep",
           "make_train_step", "make_eval_step"]

_M31 = 0x7FFFFFFF
_MUL = 0x45D9F3B
_ODD = 0x4F1BBCDD


def _mix(x):
    """A 31-bit integer hash (two multiply-xorshift rounds); ``x`` is an
    int64 tensor or a Python int in [0, 2^31), and every product stays
    below 2^63."""
    x = ((x ^ (x >> 16)) * _MUL) & _M31
    x = ((x ^ (x >> 16)) * _MUL) & _M31
    return x ^ (x >> 16)


def step_keep_mask(seed: int, step: torch.Tensor, micro: int, shape,
                   droprate: float, offset: int = 0,
                   columns: tuple[int, int] | None = None) -> torch.Tensor:
    """The boolean dropout keep-mask of microbatch ``micro`` of the update
    after ``step`` earlier ones (an int64 tensor, read on its device) in a
    run seeded with ``seed``: each entry kept with probability
    ``1 - droprate``, from a hash of (seed, step, micro, element index).
    ``offset``: the global index of the mask's first element (a rank's rows
    start past the rows of the ranks before it). ``columns`` = (first
    column, full width): the (rows, cols) ``shape`` is that block of
    columns of a row-major mask ``width`` wide (a tensor-parallel rank's
    share of the features)."""
    base = _mix((seed * 1_000_003 + micro * 7_919) & _M31)
    key = _mix((step & _M31) ^ base)
    if columns is None:
        idx = torch.arange(offset, offset + math.prod(shape),
                           dtype=torch.int64, device=step.device)
    else:
        first, width = columns
        rows = torch.arange(shape[0], dtype=torch.int64, device=step.device)
        cols = torch.arange(first, first + shape[1], dtype=torch.int64,
                            device=step.device)
        idx = (offset + rows[:, None] * width + cols[None, :]).reshape(-1)
    x = _mix(_mix((idx * _ODD + key) & _M31) ^ key)
    keep = round((1.0 - droprate) * (1 << 24))
    return ((x & 0xFFFFFF) < keep).view(shape)


def gather_frames(frames: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``frames[idx]``: the cached frames an index batch names, (B[, T])
    indices -> (B[, T], *frame) on the cache's device."""
    out = frames.index_select(0, idx.reshape(-1))
    return out.view(tuple(idx.shape) + tuple(frames.shape[1:]))


def _remat_contexts():
    return contextlib.nullcontext(), recomputing_batch_norm()


class TrainStep:
    """``step(images, targets, seed=0, keep_masks=None, frames=None) ->
    loss``.

    :param preprocess: device-side image function (the uint8 normalize, the
        raw-Bayer pipeline) applied per microbatch without gradient, so with
        accumulation the full batch stays in its raw transfer form
    :param accum_steps: split each batch into this many microbatches, run
        forward and backward on each (BatchNorm advancing per microbatch),
        sum the gradients and divide them by ``accum_steps``, average the
        losses, and make one update; the batch must divide evenly
    :param remat: recompute the forward in the backward instead of keeping
        its activations
    :param mesh: a data-parallel group (see the module docstring); the
        batch is then this rank's rows of the global batch, microbatch
        major (:func:`geomapnet_tpu_torch.parallel.microbatch_rows`)
    :param gather: ``gather(frames, idx)`` reads a device-cache batch
        (default :func:`gather_frames`; the frame-sharded cache's gather
        under ``--device_cache shard``)

    With ``frames`` (a device frame cache), ``images`` are int frame
    indices (B[, T]) into it. ``keep_masks`` (one boolean (rows, feat_dim)
    mask per microbatch, rows = the microbatch's frames) replaces the
    dropout draws of :func:`step_keep_mask`. The step makes no host sync,
    so K of them can be captured in one CUDA graph.
    """

    def __init__(self, model: nn.Module, criterion: nn.Module,
                 optimizer: Optimizer, preprocess: Callable | None = None,
                 accum_steps: int = 1, remat: bool = False,
                 gather: Callable = gather_frames):
        self.model = model
        self.criterion = criterion
        self.optimizer = optimizer
        self.preprocess = preprocess
        self.accum_steps = int(accum_steps)
        self.remat = remat
        posenet = getattr(model, "posenet", model)
        self.droprate = float(getattr(posenet, "droprate", 0.0))
        # the width of the features the dropout masks: PoseNet's fc_feat
        # output, or VidLoc's trunk features (it has no fc_feat)
        self.feat_dim = (posenet.fc_feat.out_features
                         if hasattr(posenet, "fc_feat")
                         else posenet.feature_extractor.out_features)
        self.gather = gather
        self.mesh = None
        # (first column, full width) of this rank's dropout features under
        # tensor parallelism (shard_step_tp)
        self.mask_columns = None
        self._bucket = GradientBucket()

    def _loss(self, images: torch.Tensor, targets: torch.Tensor,
              frames: torch.Tensor | None, keep_mask: torch.Tensor | None,
              seed: int, micro: int) -> torch.Tensor:
        with torch.no_grad():
            if frames is not None:
                images = self.gather(frames, images)
            if self.preprocess is not None:
                images = self.preprocess(images)
        if keep_mask is None and self.droprate > 0:
            # one row per forwarded frame: (B[, T], H, W, C) model input;
            # this rank's rows follow the lower ranks' in the microbatch
            shape = (math.prod(images.shape[:-3]), self.feat_dim)
            row = global_row_offset(self.mesh, shape[0])
            width = (self.feat_dim if self.mask_columns is None
                     else self.mask_columns[1])
            keep_mask = step_keep_mask(
                seed, self.optimizer.step_t, micro, shape, self.droprate,
                offset=row * width, columns=self.mask_columns)
        if self.remat:
            out = checkpoint(self.model, images, None, keep_mask,
                             use_reentrant=False, preserve_rng_state=False,
                             context_fn=_remat_contexts)
        else:
            out = self.model(images, None, keep_mask)
        return self.criterion(out, targets)

    def __call__(self, images: torch.Tensor, targets: torch.Tensor,
                 seed: int = 0,
                 keep_masks: Sequence[torch.Tensor] | None = None,
                 frames: torch.Tensor | None = None) -> torch.Tensor:
        A = self.accum_steps
        batch = images.shape[0]
        if batch % A:
            raise ValueError(f"batch {batch} is not divisible into {A} "
                             f"accumulation microbatches")
        micro = batch // A
        self.model.train()
        self.optimizer.zero_grad()
        total = None
        for k, (im, tg) in enumerate(zip(images.split(micro),
                                         targets.split(micro))):
            mask = keep_masks[k] if keep_masks is not None else None
            loss = self._loss(im, tg, frames, mask, seed, k)
            loss.backward()
            loss = loss.detach()
            total = loss if total is None else total + loss
        grads = [p.grad for group in self.optimizer.optimizer.param_groups
                 for p in group["params"] if p.grad is not None]
        if A > 1:
            torch._foreach_div_(grads, float(A))
            total = total / A
        if self.mesh is not None:
            # the global-batch gradient and loss: the ranks' mean, in one
            # all-reduce over a static bucket (capturable in a CUDA graph)
            self._bucket.all_reduce_mean_(grads + [total.reshape(1)],
                                          self.mesh)
        self.optimizer.step()
        return total


def make_train_step(model: nn.Module, criterion: nn.Module,
                    optimizer: Optimizer, preprocess: Callable | None = None,
                    accum_steps: int = 1, remat: bool = False, mesh=None,
                    gather: Callable = gather_frames) -> TrainStep:
    """The train step of ``model`` under ``criterion`` (see
    :class:`TrainStep`), data-parallel over ``mesh`` when given
    (:func:`geomapnet_tpu_torch.parallel.shard_step`)."""
    step = TrainStep(model, criterion, optimizer, preprocess, accum_steps,
                     remat, gather)
    return step if mesh is None else shard_step(step, mesh)


def make_eval_step(model: nn.Module, criterion: nn.Module | None = None,
                   preprocess: Callable | None = None,
                   gather: Callable = gather_frames) -> Callable:
    """``eval_step(images, targets=None, frames=None) -> (loss, outputs)``
    with the model in eval mode (BatchNorm on its running statistics, no
    dropout) and no gradient; the loss is a zero when there is no criterion
    or target. With ``frames``, ``images`` are frame indices into it, read
    by ``gather``."""

    def eval_step(images: torch.Tensor, targets: torch.Tensor | None = None,
                  frames: torch.Tensor | None = None):
        model.eval()
        with torch.no_grad():
            if frames is not None:
                images = gather(frames, images)
            if preprocess is not None:
                images = preprocess(images)
            out = model(images)
            if criterion is None or targets is None:
                return torch.zeros((), device=out.device), out
            return criterion(out, targets), out

    return eval_step
