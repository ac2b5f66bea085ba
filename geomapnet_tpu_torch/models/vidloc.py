"""VidLoc: the bidirectional-LSTM video relocalization baseline (CVPR'17).

The PyTorch counterpart of :mod:`geomapnet_tpu.models.vidloc` (upstream
models/vidloc.py): a ResNet trunk encodes each frame, a bidirectional LSTM
smooths the per-frame features over the sequence, and a linear head
regresses each frame's 6-DoF pose. The port's CLIs reach it as ``--model
vidloc`` (:mod:`geomapnet_tpu_torch.cli.builders`): it trains under a
``PoseNetCriterion`` on (N, T, 6) targets, evaluates on (N, T) clips, and
exports as a streaming artifact (:mod:`geomapnet_tpu_torch.serving`) that
runs :meth:`VidLoc.features` once a frame and :meth:`VidLoc.head` over a
window of them.

The trunk runs over the N*T frames as one batch. The recurrence is one
``nn.LSTM`` (cuDNN on a card) from a zero state, as Flax's ``nn.RNN``
starts: its forward direction is the Flax cell ``lstm_fwd``, its
``_reverse`` direction the cell ``lstm_bwd`` run with ``reverse=True,
keep_order=True``, and each step's output is ``[forward, backward]``
(:mod:`geomapnet_tpu_torch.models.flax_import` carries the weights).

``dtype`` places bfloat16 where the Flax module does: the trunk at its
placement, the features cast to ``dtype`` (the dropout runs there), the
recurrence in float32 (Flax's ``OptimizedLSTMCell`` has float32 parameters
and no dtype, so it promotes the bfloat16 features), ``fc_pose`` in
``dtype``, and the poses in float32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .posenet import Linear, dropout_keep_mask
from .resnet import ResNet, resnet34

__all__ = ["VidLoc"]

# jax.nn.initializers.lecun_normal: a normal truncated at two standard
# deviations, scaled so the truncated distribution has variance 1 / fan_in
_TRUNCATED_STD = 0.87962566103423978


def _flax_lstm_init_(lstm: nn.LSTM) -> None:
    """Flax ``OptimizedLSTMCell``'s initializers, gate by gate: input
    kernels lecun-normal, recurrent kernels orthogonal, biases zero."""
    hidden = lstm.hidden_size
    with torch.no_grad():
        for name, p in lstm.named_parameters():
            if name.startswith("bias"):
                p.zero_()
                continue
            for gate in p.split(hidden):
                if name.startswith("weight_ih"):
                    std = math.sqrt(1.0 / gate.shape[1]) / _TRUNCATED_STD
                    nn.init.trunc_normal_(gate, std=std, a=-2 * std,
                                          b=2 * std)
                else:
                    nn.init.orthogonal_(gate)


class VidLoc(nn.Module):
    """(N, T, H, W, 3) video -> (N, T, 6) poses.

    :param feature_extractor: per-frame trunk -> (n, F) features; a
        ResNet-34 when None
    :param hidden_size: LSTM hidden width per direction
    :param bidirectional: run the forward and backward passes and
        concatenate them
    :param droprate: dropout on the trunk features (in train mode, or when
        ``forward`` gets a generator or a keep-mask)
    :param dtype: compute dtype of the trunk and ``fc_pose``
    """

    def __init__(self, feature_extractor: ResNet | None = None,
                 hidden_size: int = 512, bidirectional: bool = True,
                 droprate: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.feature_extractor = feature_extractor or resnet34(dtype)
        self.droprate = droprate
        self.dtype = dtype
        self.lstm = nn.LSTM(self.feature_extractor.out_features, hidden_size,
                            batch_first=True, bidirectional=bidirectional)
        _flax_lstm_init_(self.lstm)
        self.fc_pose = Linear(hidden_size * (2 if bidirectional else 1), 6,
                              dtype)

    def features(self, frames: torch.Tensor) -> torch.Tensor:
        """(n, H, W, 3) frames -> (n, F) trunk features in ``dtype``: the
        per-frame half of the forward, which a streaming session runs once
        per frame (:mod:`geomapnet_tpu_torch.serving`)."""
        return self.feature_extractor(frames).to(self.dtype)

    def head(self, feats: torch.Tensor,
             generator: torch.Generator | None = None,
             keep_mask: torch.Tensor | None = None) -> torch.Tensor:
        """(N, T, F) trunk features -> (N, T, 6) poses, float32: the
        dropout (as :meth:`forward` decides it, ``keep_mask`` (N*T, F)),
        the recurrence over T from a zero state, and ``fc_pose``."""
        n, t = feats.shape[0], feats.shape[1]
        feats = feats.reshape(n * t, -1)
        if keep_mask is None and self.droprate > 0 and (
                generator is not None or self.training):
            keep_mask = dropout_keep_mask(feats.shape, self.droprate,
                                          generator, feats.device)
        if keep_mask is not None:
            feats = torch.where(keep_mask, feats / (1.0 - self.droprate),
                                torch.zeros((), dtype=feats.dtype,
                                            device=feats.device))
        h, _ = self.lstm(feats.reshape(n, t, -1).float())
        return self.fc_pose(h).float()

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                keep_mask: torch.Tensor | None = None) -> torch.Tensor:
        """(N, T, H, W, 3) -> (N, T, 6) ``[xyz, log-q]`` poses, float32.

        In train mode, or with ``generator`` (on ``x``'s device) or an
        (N*T, F) boolean ``keep_mask``, the dropout on the trunk features
        is active."""
        n, t = x.shape[0], x.shape[1]
        feats = self.features(x.reshape((n * t,) + tuple(x.shape[2:])))
        return self.head(feats.reshape(n, t, -1), generator, keep_mask)
