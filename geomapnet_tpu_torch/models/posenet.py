"""PoseNet and MapNet pose-regression heads, for inference.

The PyTorch counterpart of :mod:`geomapnet_tpu.models.posenet`
(upstream models/posenet.py):

- :class:`PoseNet`: trunk features -> fc(feat_dim) -> relu -> dropout ->
  two heads (xyz, log-q) concatenated to a 6-vector;
- :class:`MapNet`: a shared-weight PoseNet applied to every frame of an
  (N, T, H, W, C) tuple, with the T axis folded into the batch.

``dtype`` places the heads' compute dtype as Flax's ``nn.Dense(dtype=...)``
does: input, kernel and bias cast to ``dtype``, and the concatenated pose
cast to float32. The NaN-gradient guard of MapNet++ training is not ported
yet.

Dropout is off unless the caller asks for it: ``forward(x, generator=g)``
keeps it active at inference (BatchNorm still in inference mode), as the
reference's ungated ``F.dropout`` does (upstream models/posenet.py:68-69,
``stochastic=True`` in the JAX package), drawing the keep-mask from the
explicit ``torch.Generator`` ``g``; ``keep_mask=`` injects an (N, feat_dim)
mask instead. Flax's placement and scaling: ``fc_feat -> relu -> dropout``,
kept features divided by ``1 - droprate``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import ResNet, resnet34

__all__ = ["PoseNet", "MapNet", "Linear", "dropout_keep_mask"]


class Linear(nn.Linear):
    """``nn.Linear`` that casts its input, float32 kernel and bias to
    ``compute_dtype`` at use, as Flax's ``nn.Dense(dtype=...)`` does: the
    matmul's output and the bias add are in ``compute_dtype``."""

    def __init__(self, cin: int, cout: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class PoseNet(nn.Module):
    """Single-image 6-DoF pose regressor.

    :param feature_extractor: trunk mapping (N, H, W, 3) -> (N, F); a
        ResNet-34 when None
    :param droprate: dropout probability after the feature fc (applied only
        when ``forward`` gets a generator or a keep-mask)
    :param feat_dim: width of the feature fc (reference: 2048)
    :param dtype: compute dtype of the heads
    """

    def __init__(self, feature_extractor: ResNet | None = None,
                 droprate: float = 0.5, feat_dim: int = 2048,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
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

        With ``generator`` (on ``x``'s device) or an (N, feat_dim) boolean
        ``keep_mask`` the dropout after ``fc_feat`` is active."""
        return self.head(self.feature_extractor(x), generator, keep_mask)

    def head(self, feats: torch.Tensor,
             generator: torch.Generator | None = None,
             keep_mask: torch.Tensor | None = None) -> torch.Tensor:
        """Trunk features (N, F) -> (N, 6) poses: ``fc_feat -> relu ->
        [dropout] -> fc_xyz / fc_wpqr``."""
        feats = torch.relu(self.fc_feat(feats))
        if keep_mask is None and generator is not None and self.droprate > 0:
            keep_mask = dropout_keep_mask(feats.shape, self.droprate,
                                          generator, feats.device)
        if keep_mask is not None:
            keep = 1.0 - self.droprate
            feats = torch.where(keep_mask, feats / keep,
                                torch.zeros((), dtype=feats.dtype,
                                            device=feats.device))
        return torch.cat([self.fc_xyz(feats), self.fc_wpqr(feats)],
                         dim=-1).float()


def dropout_keep_mask(shape, droprate: float, generator: torch.Generator,
                      device: torch.device) -> torch.Tensor:
    """A boolean keep-mask of ``shape``: each entry kept with probability
    ``1 - droprate``, drawn from ``generator`` (which lives on ``device``)."""
    return torch.rand(shape, generator=generator, device=device) \
        < 1.0 - droprate


class MapNet(nn.Module):
    """Shared-weight PoseNet applied per frame of an image tuple."""

    def __init__(self, posenet: PoseNet):
        super().__init__()
        self.posenet = posenet

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, T, H, W, C) -> (N, T, 6)."""
        n, t = x.shape[0], x.shape[1]
        poses = self.posenet(x.reshape((n * t,) + tuple(x.shape[2:])))
        return poses.reshape(n, t, -1)
