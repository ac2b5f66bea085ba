"""Plain float32 MapNet training steps: the raw-Bayer preprocess, the MapNet
loss (absolute and relative poses under learned homoscedastic weights,
Brahmbhatt et al. 2018, Eq. 2-3), autograd, and Adam with coupled weight
decay (Kingma and Ba 2015), written out here.

The dropout keep-mask is the counter-based hash of (seed, update count,
microbatch, element) that MapNet's dropout draws from in the measured
trainer, copied here so that both sides drop the same features.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .mapnet import forward

__all__ = ["keep_mask", "bayer_to_input", "mapnet_loss", "follow_steps"]

_M31 = 0x7FFFFFFF
_MUL = 0x45D9F3B
_ODD = 0x4F1BBCDD


def _mix(x):
    x = ((x ^ (x >> 16)) * _MUL) & _M31
    x = ((x ^ (x >> 16)) * _MUL) & _M31
    return x ^ (x >> 16)


def keep_mask(seed: int, step: int, micro: int, shape, droprate: float,
              device) -> torch.Tensor:
    """The boolean keep-mask of microbatch ``micro`` of the update after
    ``step`` earlier ones."""
    base = _mix((seed * 1_000_003 + micro * 7_919) & _M31)
    key = _mix((step & _M31) ^ base)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    x = _mix(_mix((idx * _ODD + key) & _M31) ^ key)
    return ((x & 0xFFFFFF) < round((1.0 - droprate) * (1 << 24))).view(shape)


def bayer_to_input(raw: torch.Tensor, mean, std, out_hw) -> torch.Tensor:
    """(N, H, W) GBRG uint8 mosaics -> (N, 3, out_h, out_w) float32: each
    2x2 quad (G B / R G) gives one RGB pixel (red, mean of the greens,
    blue), scaled to [0, 1], normalized per channel, then resized by
    bilinear interpolation at half-pixel centres."""
    x = raw.float()
    rgb = torch.stack([x[:, 1::2, 0::2],
                       (x[:, 0::2, 0::2] + x[:, 1::2, 1::2]) * 0.5,
                       x[:, 0::2, 1::2]], dim=1) / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    rgb = (rgb - m.view(1, 3, 1, 1)) / s.view(1, 3, 1, 1)
    return F.interpolate(rgb, size=tuple(out_hw), mode="bilinear",
                         align_corners=False, antialias=False)


def _pair(s_t, s_q, pred, targ):
    lt = torch.mean(torch.abs(pred[..., :3] - targ[..., :3]))
    lq = torch.mean(torch.abs(pred[..., 3:] - targ[..., 3:]))
    return torch.exp(-s_t) * lt + s_t + torch.exp(-s_q) * lq + s_q


def mapnet_loss(w: dict, pred: torch.Tensor, targ: torch.Tensor
                ) -> torch.Tensor:
    """(N, T, 6) predictions and targets -> the MapNet loss: the absolute
    term under (sax, saq) plus the term of consecutive differences under
    (srx, srq)."""
    return (_pair(w["sax"], w["saq"], pred, targ)
            + _pair(w["srx"], w["srq"], pred[:, 1:] - pred[:, :-1],
                    targ[:, 1:] - targ[:, :-1]))


def follow_steps(params: dict, loss_weights: dict, batches, *, seed: int,
                 lr: float, weight_decay: float, droprate: float,
                 stage_sizes, mean, std, out_hw, betas=(0.9, 0.999),
                 eps: float = 1e-8, moments: tuple | None = None,
                 start_step: int = 0) -> dict:
    """Run ``len(batches)`` Adam steps of MapNet from ``params`` (float32
    tensors; BatchNorm statistics among them) and ``loss_weights`` (sax,
    saq, srx, srq). Each batch is ((B, T, H, W) uint8 mosaics, (B, T, 6)
    targets) on the parameters' device. ``moments``: Adam's (first, second)
    moments of each trainable leaf after ``start_step`` earlier updates
    (None: zeros after none).

    Returns ``losses`` (one float a step), ``grad0`` (each trainable leaf's
    first gradient with the decay term added, as Adam takes it) and
    ``params`` (every trainable leaf after the last step)."""
    dev = next(iter(params.values())).device
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()
              if not (k.endswith("running_mean") or k.endswith("running_var")
                      or k.endswith("num_batches_tracked"))}
    leaves.update({k: torch.tensor(float(v), device=dev, requires_grad=True)
                   for k, v in loss_weights.items()})
    stats = {k: v.detach().clone() for k, v in params.items()
             if k not in leaves}
    if moments is None:
        m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    else:
        m, v2 = ({k: mk[k].detach().clone() for k in leaves}
                 for mk in moments)
    losses, grad0 = [], None
    for t, (raw, targ) in enumerate(batches, start=start_step + 1):
        b, n = raw.shape[:2]
        x = bayer_to_input(raw.reshape((b * n,) + tuple(raw.shape[2:])),
                           mean, std, out_hw)
        feat_dim = leaves["fc_feat.weight"].shape[0]
        mask = keep_mask(seed, t - 1, 0, (b * n, feat_dim), droprate, dev)
        pred = forward(leaves, x, stage_sizes, train=True, keep_mask=mask,
                       droprate=droprate, stats=stats).view(b, n, 6)
        loss = mapnet_loss(leaves, pred, targ.float())
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {k: gk + weight_decay * leaves[k]
                 for k, gk in zip(leaves, grads)}
            if grad0 is None:
                grad0 = {k: gk.clone() for k, gk in g.items()}
            c1, c2 = 1 - betas[0] ** t, 1 - betas[1] ** t
            for k, p in leaves.items():
                m[k].mul_(betas[0]).add_(g[k], alpha=1 - betas[0])
                v2[k].mul_(betas[1]).addcmul_(g[k], g[k], value=1 - betas[1])
                denom = (v2[k] / c2).sqrt() + eps
                p.sub_(lr * (m[k] / c1) / denom)
    return dict(losses=losses, grad0=grad0,
                params={k: p.detach() for k, p in leaves.items()})
