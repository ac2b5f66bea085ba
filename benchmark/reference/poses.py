"""The reference's poses of cached uint8 frames, computed in blocks of
frames so that it fits beside whatever else the card holds, and the
fake-quantized control calibrated on given frames."""

from __future__ import annotations

import numpy as np
import torch

from .mapnet import FakeQuant, forward, normalize_rgb

__all__ = ["tuple_rows", "frame_poses", "calibrated"]


def tuple_rows(n_tuples: int, steps: int, skip: int, n_frames: int
               ) -> np.ndarray:
    """(n_tuples, steps) frame indices of the first tuples: centred on
    their index, ``skip`` apart, clamped to the scene."""
    offsets = (np.arange(steps) - steps // 2) * skip
    return np.clip(np.arange(n_tuples)[:, None] + offsets, 0, n_frames - 1)


def frame_poses(frames: torch.Tensor, idx, state: dict, stage_sizes,
                pixel_stats, quant: FakeQuant | None = None,
                block: int = 64) -> np.ndarray:
    """(len(idx), 6) float64 poses of ``frames[idx]`` ((N, H, W, 3) uint8)
    under ``state``; ``pixel_stats`` is the (mean row, variance row)."""
    mean = list(pixel_stats[0])
    std = list(np.sqrt(pixel_stats[1]))
    idx = np.asarray(idx).reshape(-1)
    out = []
    with torch.no_grad():
        for s in range(0, len(idx), block):
            sel = torch.as_tensor(idx[s:s + block], device=frames.device)
            x = normalize_rgb(frames.index_select(0, sel), mean, std)
            out.append(forward(state, x, stage_sizes,
                               quant=quant).double().cpu())
    return torch.cat(out).numpy()


def calibrated(frames: torch.Tensor, rows, state: dict, stage_sizes,
               pixel_stats, bits: int) -> FakeQuant:
    """A ``bits`` fake-quantizer whose activation scales are the absmax of
    each site's input over ``frames[rows]``."""
    q = FakeQuant(bits, observe=True)
    frame_poses(frames, rows, state, stage_sizes, pixel_stats, quant=q)
    q.observe = False
    return q
