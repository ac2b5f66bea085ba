"""PoseNet and MapNet pose-regression heads.

The PyTorch counterpart of :mod:`geomapnet_tpu.models.posenet`
(upstream models/posenet.py):

- :class:`PoseNet`: trunk features -> fc(feat_dim) -> relu -> dropout ->
  two heads (xyz, log-q) concatenated to a 6-vector;
- :class:`MapNet`: a shared-weight PoseNet applied to every frame of an
  (N, T, H, W, C) tuple, with the T axis folded into the batch.

``dtype`` places the heads' compute dtype as Flax's ``nn.Dense(dtype=...)``
does: input, kernel and bias cast to ``dtype``, and the concatenated pose
cast to float32. Dense kernels start from ``kaiming_normal`` and biases from
zero, as the Flax heads do. With ``filter_nans`` (MapNet++ fine-tuning) the
log-q head's output passes through :func:`nan_grad_guard`, which zeroes NaN
and infinite cotangents in the backward (upstream ``filter_hook``,
scripts/train.py:77-78; JAX ``models/posenet.py:51-64``).

Dropout (Flax's placement and scaling: ``fc_feat -> relu -> dropout``, kept
features divided by ``1 - droprate``) is active in train mode, and at
inference when the caller asks for it: ``forward(x, generator=g)`` keeps it
on with BatchNorm still in inference mode, as the reference's ungated
``F.dropout`` does (upstream models/posenet.py:68-69, ``stochastic=True`` in
the JAX package). The keep-mask is drawn from the explicit
``torch.Generator`` ``g`` (train mode without one draws from torch's default
generator); ``keep_mask=`` injects an (N, feat_dim) mask instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import ResNet, kaiming_normal_, resnet34

__all__ = ["PoseNet", "MapNet", "Linear", "dropout_keep_mask",
           "nan_grad_guard"]


class Linear(nn.Linear):
    """``nn.Linear`` that casts its input, float32 kernel and bias to
    ``compute_dtype`` at use, as Flax's ``nn.Dense(dtype=...)`` does: the
    matmul's output and the bias add are in ``compute_dtype``. The kernel
    starts from ``kaiming_normal``, the bias from zero."""

    def __init__(self, cin: int, cout: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout)
        self.compute_dtype = compute_dtype

    def reset_parameters(self) -> None:
        kaiming_normal_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class _NanGradGuard(torch.autograd.Function):
    """Identity whose backward replaces NaN and infinite cotangents with
    zero."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)


def nan_grad_guard(x: torch.Tensor) -> torch.Tensor:
    """``x`` unchanged; in the backward, NaN and +-inf entries of the
    incoming gradient become zero (the others pass as they are)."""
    return _NanGradGuard.apply(x)


class PoseNet(nn.Module):
    """Single-image 6-DoF pose regressor.

    :param feature_extractor: trunk mapping (N, H, W, 3) -> (N, F); a
        ResNet-34 when None
    :param droprate: dropout probability after the feature fc (applied in
        train mode, or when ``forward`` gets a generator or a keep-mask)
    :param feat_dim: width of the feature fc (reference: 2048)
    :param filter_nans: guard the log-q head against NaN gradients
        (:func:`nan_grad_guard`; MapNet++ fine-tuning)
    :param dtype: compute dtype of the heads
    """

    def __init__(self, feature_extractor: ResNet | None = None,
                 droprate: float = 0.5, feat_dim: int = 2048,
                 dtype: torch.dtype = torch.float32,
                 filter_nans: bool = False):
        super().__init__()
        self.filter_nans = filter_nans
        self.feature_extractor = feature_extractor or resnet34(dtype)
        self.fc_feat = Linear(self.feature_extractor.out_features, feat_dim,
                              dtype)
        self.droprate = droprate
        self.fc_xyz = Linear(feat_dim, 3, dtype)
        self.fc_wpqr = Linear(feat_dim, 3, dtype)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                keep_mask: torch.Tensor | None = None) -> torch.Tensor:
        """(N, H, W, 3) -> (N, 6) ``[xyz, log-q]`` poses, float32.

        In train mode, or with ``generator`` (on ``x``'s device) or an
        (N, feat_dim) boolean ``keep_mask``, the dropout after ``fc_feat``
        is active."""
        return self.head(self.features(x), generator, keep_mask)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> (N, F) trunk features (:meth:`head`'s input)."""
        return self.feature_extractor(x)

    def head(self, feats: torch.Tensor,
             generator: torch.Generator | None = None,
             keep_mask: torch.Tensor | None = None) -> torch.Tensor:
        """Trunk features (N, F) -> (N, 6) poses: ``fc_feat -> relu ->
        [dropout] -> fc_xyz / fc_wpqr``."""
        feats = torch.relu(self.fc_feat(feats))
        if keep_mask is None and self.droprate > 0 and (
                generator is not None or self.training):
            keep_mask = dropout_keep_mask(feats.shape, self.droprate,
                                          generator, feats.device)
        if keep_mask is not None:
            keep = 1.0 - self.droprate
            feats = torch.where(keep_mask, feats / keep,
                                torch.zeros((), dtype=feats.dtype,
                                            device=feats.device))
        wpqr = self.fc_wpqr(feats)
        if self.filter_nans:
            wpqr = nan_grad_guard(wpqr)
        return torch.cat([self.fc_xyz(feats), wpqr], dim=-1).float()


def dropout_keep_mask(shape, droprate: float,
                      generator: torch.Generator | None,
                      device: torch.device) -> torch.Tensor:
    """A boolean keep-mask of ``shape``: each entry kept with probability
    ``1 - droprate``, drawn from ``generator`` (which lives on ``device``;
    None draws from torch's default generator)."""
    return torch.rand(shape, generator=generator, device=device) \
        < 1.0 - droprate


class MapNet(nn.Module):
    """Shared-weight PoseNet applied per frame of an image tuple."""

    def __init__(self, posenet: PoseNet):
        super().__init__()
        self.posenet = posenet

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                keep_mask: torch.Tensor | None = None) -> torch.Tensor:
        """(N, T, H, W, C) -> (N, T, 6); ``generator`` and an (N*T,
        feat_dim) ``keep_mask`` pass on to :meth:`PoseNet.forward`."""
        n, t = x.shape[0], x.shape[1]
        poses = self.posenet(x.reshape((n * t,) + tuple(x.shape[2:])),
                             generator, keep_mask)
        return poses.reshape(n, t, -1)
