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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import ResNet, resnet34

__all__ = ["PoseNet", "MapNet", "Linear"]


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
    :param droprate: dropout probability after the feature fc (identity in
        ``eval()`` mode)
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
        self.dropout = nn.Dropout(droprate)
        self.fc_xyz = Linear(feat_dim, 3, dtype)
        self.fc_wpqr = Linear(feat_dim, 3, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> (N, 6) ``[xyz, log-q]`` poses, float32."""
        feats = torch.relu(self.fc_feat(self.feature_extractor(x)))
        feats = self.dropout(feats)
        return torch.cat([self.fc_xyz(feats), self.fc_wpqr(feats)],
                         dim=-1).float()


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
