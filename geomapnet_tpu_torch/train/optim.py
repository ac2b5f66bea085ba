"""Optimizer factory: ``torch.optim`` with the JAX package's schedule, clip
and weight-decay placement.

The PyTorch counterpart of :mod:`geomapnet_tpu.train.optim` (upstream
common/optimizer.py):

- weight decay is *coupled* (added to the gradient before the moment
  estimates), which is what ``torch.optim`` Adam, SGD and RMSprop do and
  what the JAX chain's ``add_decayed_weights`` ahead of the scaling does;
- SGD's multi-step decay (upstream ``adjust_lr`` per epoch) is a per-step
  piecewise-constant schedule built from ``steps_per_epoch`` and indexed by
  the number of updates made before the current one (optax's count);
- the global-norm clip covers the *model* parameters only, never the
  criterion's loss weights (upstream common/train.py:357-358), with optax's
  ``clip_by_global_norm`` rule;
- the learnable criterion weights are optimized (and decayed) beside the
  model's, as upstream's scripts/train.py:104-112 does; frozen ones are not
  handed to the optimizer at all, so they never move. (The JAX Trainer
  decays every criterion leaf, learnable or not: ROADMAP.md Queue 3, R3.)
- RMSprop divides by ``sqrt(v) + eps`` (upstream's ``torch.optim.RMSprop``;
  the JAX chain's ``scale_by_rms`` puts eps inside the square root, R4).

On a card the optimizer can run inside a CUDA graph (``steps_per_launch``):
the update count that seeds dropout lives on the device too (``step_t``),
the learning rate is a device tensor that the step sets from ``step_t``
through the schedule's table (so a replay that crosses an SGD boundary
decays it where an eager run would), Adam and RMSprop run with
``capturable=True`` and SGD with its fused kernel, which take that tensor
as their rate. On the CPU the rate is a Python float set before each
update, as before.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

__all__ = ["make_lr_schedule", "make_optimizer", "Optimizer"]


class LrSchedule:
    """``schedule(count)``: the learning rate of the update made after
    ``count`` earlier updates, ``base_lr`` scaled at each boundary passed.
    ``bounds`` and ``rates`` tabulate it: ``rates[i]`` holds after the
    first ``i`` boundaries."""

    def __init__(self, base_lr: float, boundaries: dict[int, float]):
        self.bounds = list(boundaries)
        self.rates = [base_lr]
        for scale in boundaries.values():
            self.rates.append(self.rates[-1] * scale)

    def __call__(self, count: int) -> float:
        return self.rates[sum(count >= b for b in self.bounds)]


def make_lr_schedule(
    method: str,
    base_lr: float,
    steps_per_epoch: int,
    lr_decay: float | None = None,
    lr_stepvalues: Sequence[int] | None = None,
) -> LrSchedule:
    """Learning rate of the update made after ``count`` earlier updates.

    Only SGD decays (multi-step, per-epoch boundaries); adam/rmsprop hold the
    base lr constant, matching upstream ``Optimizer.adjust_lr``
    (common/optimizer.py:28-43) and optax's ``piecewise_constant_schedule``.
    """
    if method != "sgd" or not lr_stepvalues or not lr_decay:
        return LrSchedule(base_lr, {})
    return LrSchedule(base_lr, {
        int(e) * steps_per_epoch: lr_decay for e in sorted(lr_stepvalues)
    })


class Optimizer:
    """A ``torch.optim`` optimizer with its lr schedule and the model-only
    global-norm clip; ``count`` is the number of updates made (optax's
    count), and ``step_t`` the same count as an int64 tensor on the
    parameters' device (the step index of the train step's dropout draws,
    which a CUDA graph reads and advances on the card).

    :param optimizer: over the model's parameters and the learnable
        criterion weights; its groups' rate is ``lr_t`` when given
    :param schedule: ``count -> lr``, set on every group before an update
    :param clip_params: the parameters whose gradients the clip covers
    :param max_grad_norm: clip threshold (0 = no clip)
    :param lr_t: the rate as a float32 tensor on the card, which each
        update sets from ``step_t`` (None: a Python float per update)
    """

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: LrSchedule,
                 clip_params: Sequence[torch.Tensor],
                 max_grad_norm: float = 0.0,
                 lr_t: torch.Tensor | None = None):
        self.optimizer = optimizer
        self.schedule = schedule
        self.clip_params = list(clip_params)
        self.max_grad_norm = float(max_grad_norm or 0.0)
        self.count = 0
        self._sharded: set = set()
        self._shard_mesh = None
        self.step_t = torch.zeros((), dtype=torch.int64,
                                  device=self.clip_params[0].device)
        self.lr_t = lr_t
        if lr_t is not None:
            for group in optimizer.param_groups:
                group["lr"] = lr_t
        if lr_t is not None and len(schedule.bounds):
            dev = lr_t.device
            self._rates = torch.tensor(schedule.rates, dtype=torch.float32,
                                       device=dev)
            self._bounds = torch.tensor(schedule.bounds, dtype=torch.int64,
                                        device=dev)
        else:
            self._rates = self._bounds = None

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def shard_clip(self, params, mesh) -> None:
        """Mark ``params`` as blocks of logical tensors split over ``mesh``
        (tensor parallelism): the clip's global norm then sums their
        squared norms over the group and counts the other parameters
        once."""
        self._sharded = {id(p) for p in params}
        self._shard_mesh = mesh

    def clip(self) -> None:
        """optax's ``clip_by_global_norm`` over ``clip_params``: gradients
        scaled by ``max_norm / norm`` when their global norm reaches
        ``max_norm``, all on the device (no host sync)."""
        grads = [p.grad for p in self.clip_params if p.grad is not None]
        if not grads:
            return
        if self._shard_mesh is not None:
            def sq(gs):
                return sum(torch.linalg.vector_norm(g).square() for g in gs)

            held = [p.grad for p in self.clip_params
                    if p.grad is not None and id(p) in self._sharded]
            rest = [p.grad for p in self.clip_params
                    if p.grad is not None and id(p) not in self._sharded]
            blocks = self._shard_mesh.all_reduce_(
                sq(held).reshape(1) if held else grads[0].new_zeros(1))
            norm = torch.sqrt(sq(rest) + blocks[0])
        else:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < self.max_grad_norm,
                            torch.ones_like(norm), self.max_grad_norm / norm)
        torch._foreach_mul_(grads, scale)

    def _set_rate(self) -> None:
        """The scheduled rate of the coming update on every group: a
        Python float, or ``lr_t`` looked up from ``step_t`` on the card."""
        if self.lr_t is None:
            lr = self.schedule(self.count)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        elif self._rates is not None:
            passed = (self.step_t >= self._bounds).sum().view(1)
            self.lr_t.copy_(self._rates.index_select(0, passed)[0])

    def step(self) -> None:
        """One update at the scheduled rate, after the clip."""
        self._set_rate()
        if self.max_grad_norm > 0:
            self.clip()
        self.optimizer.step()
        self.count += 1
        self.step_t.add_(1)

    def state_dict(self) -> dict:
        state = self.optimizer.state_dict()
        for group in state["param_groups"]:
            group["lr"] = float(group["lr"])
        return {"optimizer": state, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])
        self.step_t.fill_(self.count)
        if self.lr_t is not None:
            self.lr_t.fill_(self.schedule(self.count))
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr_t


def make_optimizer(
    method: str,
    base_lr: float,
    model: nn.Module,
    criterion: nn.Module | None = None,
    weight_decay: float = 0.0,
    steps_per_epoch: int = 1,
    max_grad_norm: float = 0.0,
    momentum: float = 0.0,
    lr_decay: float | None = None,
    lr_stepvalues: Sequence[int] | None = None,
    **unused,
) -> Optimizer:
    """The optimizer of ``model``'s parameters and ``criterion``'s learnable
    weights.

    :param method: 'sgd' (momentum, dampening 0, no Nesterov: optax's
        ``trace``) | 'adam' (betas 0.9/0.999, eps 1e-8) | 'rmsprop' (alpha
        0.99, eps 1e-8 outside the square root)

    Parameters on a card get the graph-safe optimizer (see the module
    docstring); on the CPU, torch's default implementations.
    """
    schedule = make_lr_schedule(method, base_lr, steps_per_epoch, lr_decay,
                                lr_stepvalues)
    model_params = [p for p in model.parameters() if p.requires_grad]
    groups = [{"params": model_params}]
    if criterion is not None:
        learnable = [p for p in criterion.parameters() if p.requires_grad]
        if learnable:
            groups.append({"params": learnable})
    device = model_params[0].device
    on_card = device.type == "cuda"
    lr_t = (torch.tensor(schedule(0), dtype=torch.float32, device=device)
            if on_card else None)
    kw = dict(lr=schedule(0) if lr_t is None else lr_t,
              weight_decay=weight_decay)
    if method == "sgd":
        opt = torch.optim.SGD(groups, momentum=momentum, dampening=0.0,
                              nesterov=False, fused=on_card or None, **kw)
    elif method == "adam":
        opt = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8,
                               capturable=on_card, **kw)
    elif method == "rmsprop":
        opt = torch.optim.RMSprop(groups, alpha=0.99, eps=1e-8,
                                  capturable=on_card, **kw)
    else:
        raise ValueError(f"unknown optimizer method: {method}")
    return Optimizer(opt, schedule, model_params, max_grad_norm, lr_t)
