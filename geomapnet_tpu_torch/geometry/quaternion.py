"""Quaternion algebra as torch functions on tensors.

The PyTorch counterpart of :mod:`geomapnet_tpu.geometry.quaternion`. All
functions work on the trailing axis, so any batch shape works: ``q`` is
``(..., 4)`` (scalar-first ``[w, x, y, z]``, Hamilton convention) and
log-quaternions are ``(..., 3)``. No data-dependent control flow: the
singularities (zero rotation, the acos domain) are handled with clamps and
``torch.where``, so the functions compose with ``torch.func`` transforms
(``vmap``, ``jacfwd``) and autograd.

Two epsilon regimes, as in the JAX package: the *clamped* maps (``qexp`` /
``qlog`` with ``eps=1e-8``, upstream common/pose_utils.py:73-96, the
differentiable torch path) and the *exact* maps (``qexp_exact`` /
``qlog_exact``, upstream pose_utils.py:307-327, the numpy "safe" path that
dataset preprocessing and PGO use).
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "vdot",
    "normalize",
    "qmult",
    "qmult_raw",
    "qinv",
    "qexp",
    "qlog",
    "qexp_exact",
    "qlog_exact",
    "rotate_vec_by_q",
    "hemisphere",
]


def vdot(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Dot product along the trailing axis. (..., d) x (..., d) -> (...)."""
    return torch.sum(v1 * v2, dim=-1)


def normalize(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """L2-normalize along the trailing axis."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    if eps:
        n = torch.clamp(n, min=eps)
    return x / n


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def qmult_raw(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product without re-normalization. (..., 4) x (..., 4) ->
    (..., 4)."""
    w1, v1 = q1[..., :1], q1[..., 1:]
    w2, v2 = q2[..., :1], q2[..., 1:]
    w = w1 * w2 - vdot(v1, v2)[..., None]
    v = w2 * v1 + w1 * v2 + _cross(v1, v2)
    return torch.cat([w, v], dim=-1)


def qmult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, re-normalized to unit norm (upstream
    pose_utils.py:44-62)."""
    return normalize(qmult_raw(q1, q2))


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion (its inverse). (..., 4) -> (..., 4)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qexp(logq: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Exponential map: (..., 3) log-quaternion -> (..., 4) unit quaternion,
    with the norm clamped to ``eps`` so the gradient at the origin is finite
    (upstream pose_utils.py:73-84)."""
    n = torch.clamp(torch.linalg.vector_norm(logq, dim=-1, keepdim=True),
                    min=eps)
    return torch.cat([torch.cos(n), torch.sin(n) / n * logq], dim=-1)


def qlog(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Log map: (..., 4) unit quaternion -> (..., 3) log-quaternion, the norm
    clamped to ``eps`` (upstream pose_utils.py:86-96)."""
    n = torch.clamp(torch.linalg.vector_norm(q[..., 1:], dim=-1,
                                             keepdim=True), min=eps)
    angle = torch.arccos(torch.clamp(q[..., :1], -1.0, 1.0))
    return q[..., 1:] * angle / n


def qexp_exact(logq: torch.Tensor) -> torch.Tensor:
    """Exponential map via the sinc form, exact at the origin (upstream
    numpy ``qexp``, pose_utils.py:319-327): ``[cos(n), sinc(n/pi) * v]``."""
    n = torch.linalg.vector_norm(logq, dim=-1, keepdim=True)
    return torch.cat([torch.cos(n), torch.sinc(n / math.pi) * logq], dim=-1)


def qlog_exact(q: torch.Tensor) -> torch.Tensor:
    """Log map that returns exactly zero for the identity quaternion
    (upstream numpy ``qlog``, pose_utils.py:307-317)."""
    v = q[..., 1:]
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    angle = torch.arccos(torch.clamp(q[..., :1], -1.0, 1.0))
    pos = n > 0
    scale = torch.where(pos, angle / torch.where(pos, n, torch.ones_like(n)),
                        torch.zeros_like(n))
    return v * scale


def rotate_vec_by_q(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``t`` (..., 3) by unit quaternions ``q`` (..., 4):
    ``t + 2w (v x t) + 2 v x (v x t)`` (upstream pose_utils.py:120-132)."""
    w, v = q[..., :1], q[..., 1:]
    b = _cross(v, t)
    c = 2.0 * _cross(v, b)
    return t + 2.0 * w * b + c


def hemisphere(q: torch.Tensor) -> torch.Tensor:
    """Constrain quaternions to the w >= 0 hemisphere (negate when w < 0);
    unchanged when w == 0 exactly, as in the JAX package."""
    return torch.where(q[..., :1] < 0, -q, q)
