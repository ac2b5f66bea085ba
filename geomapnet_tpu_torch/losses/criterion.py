"""Uncertainty-weighted pose-regression criteria as ``nn.Module``s.

The PyTorch counterpart of :mod:`geomapnet_tpu.losses.criterion` (upstream
common/criterion.py). The homoscedastic-uncertainty weights (sax/saq
"beta", srx/srq "gamma") are ``nn.Parameter``s of the criterion, learnable
when ``learn_beta`` / ``learn_gamma`` ask for it (``requires_grad``), as
upstream's are; the optimizer is handed only the learnable ones
(:func:`geomapnet_tpu_torch.train.optim.make_optimizer`). All tensor math
is vectorized over (N, T).

:class:`MapNetOnlineCriterion` is MapNet++'s semi-supervised loss: a
labeled tuple's absolute poses plus an unlabeled tuple's relative poses
(the SE(3) log map of consecutive predictions, ``vos_logq``) against
measured VOs, or its x-y positions against GPS in ``gps_mode``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..geometry.vo import vos_logq, vos_simple

__all__ = ["l1_loss", "quaternion_loss", "PoseNetCriterion",
           "MapNetCriterion", "MapNetOnlineCriterion"]


def l1_loss(pred: torch.Tensor, targ: torch.Tensor) -> torch.Tensor:
    """Mean absolute error over all elements (torch nn.L1Loss default)."""
    return torch.mean(torch.abs(pred - targ))


def quaternion_loss(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Huynh quaternion distance ``1 - <q1, q2>^2``, averaged (upstream
    QuaternionLoss, common/criterion.py:15-31)."""
    return torch.mean(1.0 - torch.sum(q1 * q2, dim=-1) ** 2)


def _weighted_pair(s_t: torch.Tensor, s_q: torch.Tensor, pred: torch.Tensor,
                   targ: torch.Tensor, t_loss_fn: Callable,
                   q_loss_fn: Callable, t_dims: int = 3) -> torch.Tensor:
    """exp(-s_t)*L_t + s_t + exp(-s_q)*L_q + s_q over a (..., 6) pose block."""
    lt = t_loss_fn(pred[..., :t_dims], targ[..., :t_dims])
    lq = q_loss_fn(pred[..., 3:], targ[..., 3:])
    return torch.exp(-s_t) * lt + s_t + torch.exp(-s_q) * lq + s_q


def _weight(value: float, learn: bool) -> nn.Parameter:
    return nn.Parameter(torch.tensor(float(value), dtype=torch.float32),
                        requires_grad=learn)


class PoseNetCriterion(nn.Module):
    """Single-frame absolute pose loss with learnable beta (upstream
    common/criterion.py:33-52). ``forward(pred, targ)``: (N, 6) -> scalar."""

    def __init__(self, sax: float = 0.0, saq: float = 0.0,
                 learn_beta: bool = False, t_loss_fn: Callable = l1_loss,
                 q_loss_fn: Callable = l1_loss):
        super().__init__()
        self.learn_beta = learn_beta
        self.t_loss_fn, self.q_loss_fn = t_loss_fn, q_loss_fn
        self.sax = _weight(sax, learn_beta)
        self.saq = _weight(saq, learn_beta)

    def forward(self, pred: torch.Tensor, targ: torch.Tensor) -> torch.Tensor:
        return _weighted_pair(self.sax, self.saq, pred, targ,
                              self.t_loss_fn, self.q_loss_fn)


class MapNetCriterion(nn.Module):
    """Absolute + relative (VO) tuple loss, Eq. 2 of the MapNet paper
    (upstream common/criterion.py:54-109); the VO term subtracts pose
    vectors (``calc_vos_simple``). ``forward(pred, targ)``: (N, T, 6) ->
    scalar."""

    def __init__(self, sax: float = 0.0, saq: float = 0.0, srx: float = 0.0,
                 srq: float = 0.0, learn_beta: bool = False,
                 learn_gamma: bool = False, t_loss_fn: Callable = l1_loss,
                 q_loss_fn: Callable = l1_loss):
        super().__init__()
        self.learn_beta, self.learn_gamma = learn_beta, learn_gamma
        self.t_loss_fn, self.q_loss_fn = t_loss_fn, q_loss_fn
        self.sax = _weight(sax, learn_beta)
        self.saq = _weight(saq, learn_beta)
        self.srx = _weight(srx, learn_gamma)
        self.srq = _weight(srq, learn_gamma)

    def forward(self, pred: torch.Tensor, targ: torch.Tensor) -> torch.Tensor:
        abs_loss = _weighted_pair(self.sax, self.saq, pred, targ,
                                  self.t_loss_fn, self.q_loss_fn)
        vo_loss = _weighted_pair(self.srx, self.srq, vos_simple(pred),
                                 vos_simple(targ), self.t_loss_fn,
                                 self.q_loss_fn)
        return abs_loss + vo_loss


class MapNetOnlineCriterion(nn.Module):
    """Semi-supervised MapNet++ loss, Eq. 4 of the paper (upstream
    common/criterion.py:111-184). ``forward(pred, targ)``: predictions
    (N, 2T, 6), a labeled tuple's T frames then an unlabeled tuple's T;
    targets (N, 2T-1, 6), the T absolute poses then T-1 measured VOs, or
    (N, 2T, 6) in ``gps_mode``, the T absolute poses then T GPS positions
    (x, y compared). The unlabeled predictions turn into relative poses
    through the SE(3) log map (:func:`vos_logq`, clamped). In ``gps_mode``
    ``srq`` takes no part in the loss, so it gets no gradient and an
    optimizer leaves it where it started, as upstream's does."""

    def __init__(self, sax: float = 0.0, saq: float = 0.0, srx: float = 0.0,
                 srq: float = 0.0, learn_beta: bool = False,
                 learn_gamma: bool = False, gps_mode: bool = False,
                 t_loss_fn: Callable = l1_loss,
                 q_loss_fn: Callable = l1_loss):
        super().__init__()
        self.learn_beta, self.learn_gamma = learn_beta, learn_gamma
        self.gps_mode = gps_mode
        self.t_loss_fn, self.q_loss_fn = t_loss_fn, q_loss_fn
        self.sax = _weight(sax, learn_beta)
        self.saq = _weight(saq, learn_beta)
        self.srx = _weight(srx, learn_gamma)
        self.srq = _weight(srq, learn_gamma)

    def forward(self, pred: torch.Tensor, targ: torch.Tensor) -> torch.Tensor:
        t = pred.shape[1] // 2
        pred_abs, pred_unlab = pred[:, :t], pred[:, t:]
        targ_abs, targ_rel = targ[:, :t], targ[:, t:]
        abs_loss = _weighted_pair(self.sax, self.saq, pred_abs, targ_abs,
                                  self.t_loss_fn, self.q_loss_fn)
        if self.gps_mode:
            rel_loss = (torch.exp(-self.srx)
                        * self.t_loss_fn(pred_unlab[..., :2],
                                         targ_rel[..., :2]) + self.srx)
        else:
            rel_loss = _weighted_pair(self.srx, self.srq,
                                      vos_logq(pred_unlab), targ_rel,
                                      self.t_loss_fn, self.q_loss_fn)
        return abs_loss + rel_loss
