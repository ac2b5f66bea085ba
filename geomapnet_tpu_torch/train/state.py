"""The train and eval steps.

The PyTorch counterpart of :mod:`geomapnet_tpu.train.state` (upstream
``step_feedfwd``, common/train.py:322-363). The JAX package's train state is
one immutable pytree; here it lives where PyTorch keeps it: parameters and
BatchNorm statistics in the model, loss weights in the criterion, moments
and the update count in the :class:`~geomapnet_tpu_torch.train.optim.
Optimizer`. A step runs forward, loss, backward, clip, update and the
BatchNorm running-statistics update, and returns the loss as a device
tensor (no host sync).

Dropout draws come from explicit generators seeded by (seed, step,
microbatch), the counterpart of JAX's ``fold_in(rng, step)`` and
``fold_in(., k)``; the streams differ from ``jax.random`` (ROADMAP.md
Queue 3), so parity with JAX injects the keep-masks.

``remat`` (recompute the forward in the backward) is not ported: it waits
for ROADMAP.md item 12c, with its trap (``torch.utils.checkpoint`` reruns the
forward, which would move the BatchNorm running statistics twice).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from .optim import Optimizer

__all__ = ["dropout_generator", "TrainStep", "make_train_step",
           "make_eval_step"]


def dropout_generator(seed: int, step: int, micro: int,
                      device: torch.device) -> torch.Generator:
    """The dropout generator of microbatch ``micro`` of update ``step`` in a
    run seeded with ``seed``, on ``device``."""
    return torch.Generator(device=device).manual_seed(
        ((seed * 1_000_003 + step) * 1_009 + micro) % 2 ** 63)


class TrainStep:
    """``step(images, targets, seed=0, keep_masks=None) -> loss``.

    :param preprocess: device-side image function (the uint8 normalize, the
        raw-Bayer pipeline) applied per microbatch without gradient, so with
        accumulation the full batch stays in its raw transfer form
    :param accum_steps: split each batch into this many microbatches, run
        forward and backward on each (BatchNorm advancing per microbatch),
        sum the gradients and divide them by ``accum_steps``, average the
        losses, and make one update; the batch must divide evenly

    ``keep_masks`` (one boolean (rows, feat_dim) mask per microbatch, rows =
    the microbatch's frames) replaces the dropout draws.
    """

    def __init__(self, model: nn.Module, criterion: nn.Module,
                 optimizer: Optimizer, preprocess: Callable | None = None,
                 accum_steps: int = 1):
        self.model = model
        self.criterion = criterion
        self.optimizer = optimizer
        self.preprocess = preprocess
        self.accum_steps = int(accum_steps)
        posenet = getattr(model, "posenet", model)
        self.droprate = float(getattr(posenet, "droprate", 0.0))

    def _loss(self, images: torch.Tensor, targets: torch.Tensor,
              generator: torch.Generator | None,
              keep_mask: torch.Tensor | None) -> torch.Tensor:
        if self.preprocess is not None:
            with torch.no_grad():
                images = self.preprocess(images)
        out = self.model(images, generator, keep_mask)
        return self.criterion(out, targets)

    def __call__(self, images: torch.Tensor, targets: torch.Tensor,
                 seed: int = 0,
                 keep_masks: Sequence[torch.Tensor] | None = None
                 ) -> torch.Tensor:
        A = self.accum_steps
        batch = images.shape[0]
        if batch % A:
            raise ValueError(f"batch {batch} is not divisible into {A} "
                             f"accumulation microbatches")
        micro = batch // A
        self.model.train()
        self.optimizer.zero_grad()
        step = self.optimizer.count
        total = None
        for k, (im, tg) in enumerate(zip(images.split(micro),
                                         targets.split(micro))):
            mask = keep_masks[k] if keep_masks is not None else None
            gen = (dropout_generator(seed, step, k, images.device)
                   if mask is None and self.droprate > 0 else None)
            loss = self._loss(im, tg, gen, mask)
            loss.backward()
            loss = loss.detach()
            total = loss if total is None else total + loss
        if A > 1:
            grads = [p.grad for group in self.optimizer.optimizer.param_groups
                     for p in group["params"] if p.grad is not None]
            torch._foreach_div_(grads, float(A))
            total = total / A
        self.optimizer.step()
        return total


def make_train_step(model: nn.Module, criterion: nn.Module,
                    optimizer: Optimizer, preprocess: Callable | None = None,
                    accum_steps: int = 1) -> TrainStep:
    """The train step of ``model`` under ``criterion`` (see
    :class:`TrainStep`)."""
    return TrainStep(model, criterion, optimizer, preprocess, accum_steps)


def make_eval_step(model: nn.Module, criterion: nn.Module | None = None,
                   preprocess: Callable | None = None) -> Callable:
    """``eval_step(images, targets=None) -> (loss, outputs)`` with the model
    in eval mode (BatchNorm on its running statistics, no dropout) and no
    gradient; the loss is a zero when there is no criterion or target."""

    def eval_step(images: torch.Tensor, targets: torch.Tensor | None = None):
        model.eval()
        with torch.no_grad():
            if preprocess is not None:
                images = preprocess(images)
            out = model(images)
            if criterion is None or targets is None:
                return torch.zeros((), device=out.device), out
            return criterion(out, targets), out

    return eval_step
