"""The numbers that decide ``correct``: each is a gap between what the
measured program produced and what the plain reference computes from the
same inputs, compared against its limit in the workload file."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["qexp", "pose_gaps", "leaf_norm_gap", "train_gaps"]


def qexp(logq: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) of a log-quaternion: ``(cos |v|,
    sin |v| v / |v|)``."""
    logq = np.asarray(logq, np.float64)
    n = np.linalg.norm(logq, axis=-1, keepdims=True)
    return np.concatenate([np.cos(n), np.sinc(n / np.pi) * logq], axis=-1)


def pose_gaps(t: np.ndarray, q: np.ndarray, t_ref: np.ndarray,
              logq_ref: np.ndarray) -> dict:
    """``t_gap``: the largest distance between a served translation and the
    reference's, over the reference translations' spread across the frames
    (the root mean square distance from their mean), so that a translation
    that ignores its frame (all zero, or another frame's) reads about 1 or
    more; ``q_gap_deg``: the largest angle between a served unit quaternion
    ``q`` and the reference's, in degrees."""
    t_ref = np.asarray(t_ref, np.float64)
    spread = np.sqrt(np.mean(np.sum((t_ref - t_ref.mean(0)) ** 2, axis=-1)))
    t_gap = float(np.linalg.norm(np.asarray(t, np.float64) - t_ref,
                                 axis=-1).max() / max(spread, 1e-12))
    q_ref = qexp(logq_ref)
    dots = np.abs(np.sum(np.asarray(q, np.float64) * q_ref, axis=-1))
    q_gap = float(np.degrees(2 * np.arccos(np.clip(dots, 0.0, 1.0))).max())
    return {"t_gap": t_gap, "q_gap_deg": q_gap}


def leaf_norm_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's;
    ``keep`` names the leaves compared (default: all)."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    med = float(np.median(list(rn.values())))
    worst = 0.0
    for k in names:
        pn = float(torch.linalg.vector_norm(prog[k].double()))
        worst = max(worst, abs(pn - rn[k]) / max(rn[k], med, 1e-30))
    return worst


def train_gaps(prog_losses, ref_losses, prog_grad0: dict, ref_grad0: dict,
               prog_change: dict, ref_change: dict) -> dict:
    """``loss_gap``: the worst step's relative loss difference,
    ``loss1_gap``: the first step's; ``grad_gap``: :func:`leaf_norm_gap`
    of the first gradients;
    ``change_gap``: of the parameters' change over the steps, over the
    leaves whose reference gradient is at least a thousandth of the median
    leaf's (below that, Adam moves a leaf by its rounding alone)."""
    steps = [abs(a - b) / max(abs(b), 1e-30)
             for a, b in zip(prog_losses, ref_losses)]
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in ref_grad0.items()}
    med = float(np.median(list(norms.values())))
    moved = {k for k, n in norms.items() if n >= 1e-3 * med}
    return {"loss_gap": float(max(steps)), "loss1_gap": float(steps[0]),
            "loss_gaps": [float(x) for x in steps],
            "grad_gap": leaf_norm_gap(prog_grad0, ref_grad0),
            "change_gap": leaf_norm_gap(prog_change, ref_change, moved)}
