"""Plain float32 VidLoc: per-frame ResNet features, a bidirectional LSTM
written as its gate equations, and a linear pose head.

VidLoc (Clark, Wang, Markham, Trigoni, Wen, "VidLoc: A Deep Spatio-Temporal
Model for 6-DoF Video-Clip Relocalization", CVPR 2017, arXiv:1702.06521)
encodes each frame of a clip with a CNN, runs a bidirectional LSTM over the
clip's features and regresses every frame's 6-DoF pose from the two
directions' outputs. Departures from the paper, as the benchmark's
configuration runs it:

- the CNN is upstream geomapnet's ResNet-34 trunk (global average pool, 512
  features; :func:`benchmark.reference.mapnet.trunk`), not the paper's
  GoogLeNet-based encoder;
- the pose is ``[xyz, log q]`` (geomapnet's parametrization), not the
  paper's translation and quaternion;
- one LSTM layer of 512 units a direction, the default of geomapnet's
  VidLoc, and no dropout (inference);
- the recurrence runs online over the last T frames of a stream, from a
  zero state at every step, where the paper runs it over a whole clip.

The LSTM is torch's ``nn.LSTM`` arithmetic without calling it: gates in
the order i, f, g, o, ``c' = f * c + i * g``, ``h' = o * tanh(c')``, a zero
initial state; the backward direction runs over the reversed window and
its outputs are put back in time order; each frame's output is
``[forward, backward]``, then ``fc_pose``. Parameters are one flat dict of
tensors keyed as the port's ``VidLoc`` state dict: the trunk's
``feature_extractor.*`` (the naming :mod:`benchmark.reference.mapnet`
reads), ``lstm.weight_ih_l0`` (4H, F), ``lstm.weight_hh_l0`` (4H, H),
``lstm.bias_ih_l0``, ``lstm.bias_hh_l0``, the same with ``_reverse``, and
``fc_pose.weight`` (6, 2H), ``fc_pose.bias``. Everything is float32 and
:func:`precision` states whether matmuls and convolutions may run TF32.
Nothing here imports the measured program.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from .mapnet import normalize_rgb, trunk

__all__ = ["DIRECTIONS", "precision", "lstm_direction", "direction",
           "recurrence", "head", "frame_features", "window_poses"]

# the parameter suffix of each direction
DIRECTIONS = ("l0", "l0_reverse")


@contextlib.contextmanager
def precision(tf32: bool):
    """cuDNN convolutions and CUDA matmuls in TF32 (``tf32``) or float32
    inside the block; the settings before it are restored after."""
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


def lstm_direction(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                   b_ih: torch.Tensor, b_hh: torch.Tensor,
                   state: tuple | None = None) -> tuple:
    """One LSTM direction over (N, T, F) inputs in their given order, from
    ``state`` ((h, c), each (N, H); zero when None). Returns the (N, T, H)
    outputs and the last (h, c)."""
    n, t, _ = x.shape
    hidden = w_hh.shape[1]
    # every step's input projection in one matmul
    xp = x @ w_ih.t() + (b_ih + b_hh)
    if state is None:
        h = x.new_zeros((n, hidden))
        c = x.new_zeros((n, hidden))
    else:
        h, c = state
    outs = []
    for s in range(t):
        gates = xp[:, s] + h @ w_hh.t()
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, dim=1), (h, c)


def direction(p: dict, x: torch.Tensor, suffix: str,
              state: tuple | None = None) -> tuple:
    """:func:`lstm_direction` with the parameters of the direction whose
    suffix (:data:`DIRECTIONS`) is ``suffix``."""
    return lstm_direction(x, p[f"lstm.weight_ih_{suffix}"],
                          p[f"lstm.weight_hh_{suffix}"],
                          p[f"lstm.bias_ih_{suffix}"],
                          p[f"lstm.bias_hh_{suffix}"], state)


def recurrence(p: dict, feats: torch.Tensor) -> torch.Tensor:
    """(N, T, F) features -> (N, T, 2H) ``[forward, backward]`` outputs,
    both directions from a zero state."""
    fwd, _ = direction(p, feats, DIRECTIONS[0])
    bwd, _ = direction(p, feats.flip(1), DIRECTIONS[1])
    return torch.cat([fwd, bwd.flip(1)], dim=-1)


def head(p: dict, feats: torch.Tensor) -> torch.Tensor:
    """(N, T, F) trunk features -> (N, T, 6) ``[xyz, log q]`` poses."""
    return F.linear(recurrence(p, feats), p["fc_pose.weight"],
                    p["fc_pose.bias"])


def frame_features(frames: torch.Tensor, idx, p: dict, stage_sizes,
                   pixel_stats, block: int = 64) -> torch.Tensor:
    """(len(idx), F) trunk features of ``frames[idx]`` ((N, H, W, 3) uint8),
    computed in blocks of frames; ``pixel_stats`` is the (mean row,
    variance row)."""
    mean = list(pixel_stats[0])
    std = list(np.sqrt(pixel_stats[1]))
    idx = np.asarray(idx).reshape(-1)
    out = []
    with torch.no_grad():
        for s in range(0, len(idx), block):
            sel = torch.as_tensor(idx[s:s + block], device=frames.device)
            x = normalize_rgb(frames.index_select(0, sel), mean, std)
            out.append(trunk(p, x, stage_sizes))
    return torch.cat(out)


def window_poses(p: dict, feats: torch.Tensor, windows,
                 block: int = 256) -> np.ndarray:
    """(W, T, 6) float64 poses of each window: ``windows`` (W, T) rows of
    ``feats`` ((U, F) trunk features), oldest frame first; the windows run
    through :func:`head` together, ``block`` at a time."""
    windows = torch.as_tensor(np.asarray(windows), device=feats.device)
    out = []
    with torch.no_grad():
        for s in range(0, len(windows), block):
            w = windows[s:s + block]
            out.append(head(p, feats[w]).double().cpu())
    return torch.cat(out).numpy()
