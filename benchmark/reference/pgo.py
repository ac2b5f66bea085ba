"""Plain pose-graph optimization (PGO) of MapNet+PGO (Brahmbhatt et al.,
CVPR 2018, Section 3.4), written from the paper's equations in float64
torch, with its Jacobian written out by hand. Nothing here imports the
measured program.

A window holds N absolute poses ``[t, q]`` (translation, unit quaternion
(w, x, y, z), Hamilton product) and the relative poses (VOs) of its
constraint pairs (i, j): the chain (i, i+1), or all pairs i < j. Its
weighted residuals are

- a unary term per pose k: ``w_at (t_k - t_abs_k)``, ``w_aq (q_k - q_abs_k)``;
- a pairwise term per pair (i, j):
  ``w_rt (R(q_i)^T (t_j - t_i) - t_vo)``, ``w_rq (q_i^-1 q_j - q_vo)``;

with ``w = 1 / sqrt(s)`` of the variances ``s_abs_trans``, ``s_abs_rot``,
``s_rel_trans``, ``s_rel_rot``. Gauss-Newton runs on the manifold: each
pose's increment is ``[dt, dtheta]``, t is additive and q is
right-multiplied by ``exp(dtheta) = (cos |dtheta|, sin |dtheta| dtheta /
|dtheta|)``; the normal equations ``J^T J x = -J^T r`` are solved by LU.

The one departure from the paper's equations is upstream's
(NVlabs/geomapnet ``common/pose_utils.py:491-494``): the derivative of the
pairwise translation residual with respect to the base rotation q_i is
left out of the Jacobian (``truncated=True``); ``truncated=False`` keeps
it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["qmul", "qconj", "qexp", "qlog", "rotation", "pairs",
           "relative", "residuals", "jacobian", "optimize"]


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, (..., 4) x (..., 4)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def qconj(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def qexp(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 4): ``(cos |v|, sin |v| v / |v|)``, the identity at
    v = 0."""
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    scale = torch.where(n > 0, torch.sin(n) / torch.where(n > 0, n, 1.0),
                        torch.ones_like(n))
    return torch.cat([torch.cos(n), scale * v], dim=-1)


def qlog(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternion -> (..., 3), the inverse of :func:`qexp`."""
    v = q[..., 1:]
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    angle = torch.atan2(n, q[..., :1])
    return torch.where(n > 0, v * angle / torch.where(n > 0, n, 1.0),
                       torch.zeros_like(v))


def rotation(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternion -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1)], dim=-2)


def _left(q: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) with ``q p = _left(q) @ p``."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([torch.stack([w, -x, -y, -z], -1),
                        torch.stack([x, w, -z, y], -1),
                        torch.stack([y, z, w, -x], -1),
                        torch.stack([z, -y, x, w], -1)], dim=-2)


def _right(p: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) with ``q p = _right(p) @ q``."""
    w, x, y, z = p.unbind(-1)
    return torch.stack([torch.stack([w, -x, -y, -z], -1),
                        torch.stack([x, w, z, -y], -1),
                        torch.stack([y, -z, w, x], -1),
                        torch.stack([z, y, -x, w], -1)], dim=-2)


def _cross_matrix(u: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) with ``_cross_matrix(u) @ v = u x v``."""
    x, y, z = u.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], dim=-2)


def pairs(n: int, fc: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """The constraint pairs of an n-pose window: (i, i+1), or every i < j
    in row-major order."""
    if fc:
        return np.triu_indices(n, k=1)
    i = np.arange(n - 1)
    return i, i + 1


def relative(poses: torch.Tensor, fc: bool = False) -> torch.Tensor:
    """(..., N, 7) -> (..., P, 7) VOs of the window's pairs:
    ``[R(q_i)^T (t_j - t_i), q_i^-1 q_j / |q_i^-1 q_j|]``."""
    i, j = (torch.as_tensor(a, device=poses.device)
            for a in pairs(poses.shape[-2], fc))
    pi, pj = poses[..., i, :], poses[..., j, :]
    rot_t = rotation(pi[..., 3:]).transpose(-1, -2)
    t = (rot_t @ (pj[..., :3] - pi[..., :3]).unsqueeze(-1)).squeeze(-1)
    q = qmul(qconj(pi[..., 3:]), pj[..., 3:])
    return torch.cat([t, q / torch.linalg.vector_norm(q, dim=-1,
                                                      keepdim=True)], -1)


def _weights(variances, like: torch.Tensor) -> list:
    return [like.new_tensor(1.0 / np.sqrt(float(s))) for s in variances]


def residuals(z: torch.Tensor, poses: torch.Tensor, vos: torch.Tensor,
              variances=(1.0, 1.0, 1.0, 1.0), fc: bool = False
              ) -> torch.Tensor:
    """(B, R) weighted residuals at the current poses ``z`` (B, N, 7) of
    the absolute poses ``poses`` (B, N, 7) and VOs ``vos`` (B, P, 7): the
    unary rows [t (3), q (4)] of every pose, then the pairwise rows [t (3),
    q (4)] of every pair."""
    w_at, w_aq, w_rt, w_rq = _weights(variances, z)
    i, j = (torch.as_tensor(a, device=z.device)
            for a in pairs(z.shape[1], fc))
    zi, zj = z[:, i], z[:, j]
    rot_t = rotation(zi[..., 3:]).transpose(-1, -2)
    rt = (rot_t @ (zj[..., :3] - zi[..., :3]).unsqueeze(-1)).squeeze(-1)
    rq = qmul(qconj(zi[..., 3:]), zj[..., 3:])
    unary = torch.cat([w_at * (z[..., :3] - poses[..., :3]),
                       w_aq * (z[..., 3:] - poses[..., 3:])], dim=-1)
    pairwise = torch.cat([w_rt * (rt - vos[..., :3]),
                          w_rq * (rq - vos[..., 3:])], dim=-1)
    B = z.shape[0]
    return torch.cat([unary.reshape(B, -1), pairwise.reshape(B, -1)], 1)


def jacobian(z: torch.Tensor, variances=(1.0, 1.0, 1.0, 1.0),
             fc: bool = False, truncated: bool = True) -> torch.Tensor:
    """(B, R, 6N) derivative of :func:`residuals` with respect to every
    pose's increment ``[dt, dtheta]`` at zero (columns ``6k .. 6k+5`` for
    pose k). At zero, ``q exp(dtheta) = q + _left(q)[:, 1:] dtheta`` and
    ``exp(dtheta)^-1 p = p - _right(p)[:, 1:] dtheta`` to first order, and
    ``R(q exp(dtheta))^T u = R(q)^T u + 2 [R(q)^T u]_x dtheta``."""
    B, n = z.shape[:2]
    w_at, w_aq, w_rt, w_rq = _weights(variances, z)
    i, j = pairs(n, fc)
    P = len(i)
    J = z.new_zeros((B, 7 * n + 7 * P, 6 * n))
    eye = torch.eye(3, dtype=z.dtype, device=z.device)
    left_q = _left(z[..., 3:])[..., 1:]                   # (B, N, 4, 3)
    for k in range(n):
        J[:, 7 * k:7 * k + 3, 6 * k:6 * k + 3] = w_at * eye
        J[:, 7 * k + 3:7 * k + 7, 6 * k + 3:6 * k + 6] = w_aq * left_q[:, k]
    for p, (a, b) in enumerate(zip(i.tolist(), j.tolist())):
        row = 7 * n + 7 * p
        rot_t = rotation(z[:, a, 3:]).transpose(-1, -2)     # (B, 3, 3)
        J[:, row:row + 3, 6 * b:6 * b + 3] = w_rt * rot_t
        J[:, row:row + 3, 6 * a:6 * a + 3] = -w_rt * rot_t
        if not truncated:
            u = (rot_t @ (z[:, b, :3] - z[:, a, :3]).unsqueeze(-1))[..., 0]
            J[:, row:row + 3, 6 * a + 3:6 * a + 6] = (
                2.0 * w_rt * _cross_matrix(u))
        rel = qmul(qconj(z[:, a, 3:]), z[:, b, 3:])
        J[:, row + 3:row + 7, 6 * b + 3:6 * b + 6] = (
            w_rq * _left(rel)[..., 1:])
        J[:, row + 3:row + 7, 6 * a + 3:6 * a + 6] = (
            -w_rq * _right(rel)[..., 1:])
    return J


def optimize(poses: torch.Tensor, vos: torch.Tensor,
             variances=(1.0, 1.0, 1.0, 1.0), n_iters: int = 10,
             fc: bool = False, truncated: bool = True,
             dtype: torch.dtype = torch.float64, block: int = 1024
             ) -> torch.Tensor:
    """Gauss-Newton PGO of windows: poses (B, N, 7), VOs (B, P, 7) ->
    (B, N, 7) in ``dtype``, on the inputs' device, ``block`` windows at a
    time."""
    poses = torch.as_tensor(poses).to(dtype)
    vos = torch.as_tensor(vos).to(device=poses.device, dtype=dtype)
    out = []
    for s in range(0, poses.shape[0], block):
        p, v = poses[s:s + block], vos[s:s + block]
        z = p.clone()
        B, n = z.shape[:2]
        for _ in range(n_iters):
            r = residuals(z, p, v, variances, fc)
            J = jacobian(z, variances, fc, truncated)
            Jt = J.transpose(1, 2)
            x = torch.linalg.solve(Jt @ J, -(Jt @ r.unsqueeze(-1)))
            x = x.reshape(B, n, 6)
            z = torch.cat([z[..., :3] + x[..., :3],
                           qmul(z[..., 3:], qexp(x[..., 3:]))], dim=-1)
        out.append(z)
    return torch.cat(out)
