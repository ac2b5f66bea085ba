"""Pose-graph optimization (PGO): batched Gauss-Newton on SE(3), in torch.

The PyTorch counterpart of :mod:`geomapnet_tpu.pgo.pose_graph`. It fuses
network-predicted absolute poses with measured relative poses (VOs) at
inference, the "MapNet+PGO" configuration. Upstream: ``PoseGraph`` /
``PoseGraphFC`` / ``optimize_poses`` (common/pose_utils.py:458-804), which
run a scipy Gauss-Newton per window on the host with hand-derived
Jacobians.

Design, as in the JAX package:

- The Jacobian is ``torch.func.jacfwd`` of the residual vector with respect
  to the manifold increment at zero. The reference's analytic Jacobian
  leaves out the pairwise translation residual's dependence on the base
  rotation (commented out at pose_utils.py:491-494); ``detach()`` of that
  rotation reproduces the truncation (its tangent is dropped, also under
  ``vmap``).
- The information matrices' Cholesky factors ``chol(I/s)`` are multiples of
  the identity, so the weighting is four scalars ``1/sqrt(s)``.
- Every window of a batch is solved at once: ``vmap`` over windows of the
  residuals and their Jacobian, ``H = JᵀJ`` and ``b = Jᵀr`` as batched
  products, a batched ``torch.linalg.cholesky_ex`` and ``cholesky_solve``
  (<= 6N x 6N, N = 7 -> 42x42). Ten iterations run as a Python loop of
  eager launches with no host sync inside: the factorizations' ``info``
  is read once, after the last iteration, and a window whose system was
  not positive definite raises ``ValueError`` (the JAX package returns
  NaNs there).

Each iteration runs under the spans ``pgo.linearize`` (the batched
Jacobian and residuals) and ``pgo.solve`` (the normal equations, the
factorization, the solve and the manifold update), and the one ``info``
readback, the solve's only sync, under ``pgo.check``
(:mod:`geomapnet_tpu_torch.utils.trace`; the spans add none). ``solves``
counts the batched solves run, their windows and their iterations.

The dtype follows the input, promoted to at least float32. The entry
points take a ``device``: tensors stay on theirs when it is None, and numpy
arrays then go to the card.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..geometry.quaternion import qinv, qmult_raw, rotate_vec_by_q
from ..geometry.rotations import qinv_np, qmult_np
from ..geometry.vo import pair_indices_fc
from ..utils.trace import span

__all__ = [
    "gauss_newton_pgo",
    "optimize_poses",
    "optimize_poses_batch",
    "chain_pairs",
    "solves",
]

# batched solves run in this process: calls, the windows they solved and
# the Gauss-Newton iterations they ran
solves = {"calls": 0, "windows": 0, "iterations": 0}


def chain_pairs(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Consecutive (i, i+1) constraint pairs for an n-pose chain."""
    i = np.arange(n - 1)
    return i, i + 1


def _qexp_gn(x: torch.Tensor) -> torch.Tensor:
    """Exp map with a norm that is smooth at 0, so that its ``jacfwd`` at
    x = 0 is [[0], [I]] (the reference's ``m_rot``, pose_utils.py:445-456)."""
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-24)
    return torch.cat([torch.cos(n), torch.sin(n) / n * x], dim=-1)


def _residuals(x, z, poses, vos, i, j, weights):
    """Weighted residual vector of one window at manifold increment ``x``
    (N, 6) around the current poses ``z`` (N, 7).

    Row order as in the reference: unary [t(3), q(4)] per pose, then
    pairwise [t(3), q(4)] per constraint ``(i[k], j[k])``.
    """
    wax, waq, wrx, wrq = weights
    t = z[:, :3] + x[:, :3]
    q = qmult_raw(z[:, 3:], _qexp_gn(x[:, 3:]))

    ru_t = wax * (t - poses[:, :3])
    ru_q = waq * (q - poses[:, 3:])

    qi = q.index_select(0, i)
    t_ij = t.index_select(0, j) - t.index_select(0, i)
    # the reference drops d(rt)/d(q_i) (pose_utils.py:491-494)
    rt = wrx * (rotate_vec_by_q(t_ij, qinv(qi.detach())) - vos[:, :3])
    rq = wrq * (qmult_raw(qinv(qi), q.index_select(0, j)) - vos[:, 3:])

    unary = torch.cat([ru_t, ru_q], dim=1).reshape(-1)
    pairwise = torch.cat([rt, rq], dim=1).reshape(-1)
    return torch.cat([unary, pairwise])


def _as_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    return torch.as_tensor(np.asarray(a),
                           device="cuda" if device is None else device)


def optimize_poses_batch(
    poses,
    vos,
    sax: float = 1.0,
    saq: float = 1.0,
    srx: float = 1.0,
    srq: float = 1.0,
    n_iters: int = 10,
    fc: bool = False,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """PGO of a batch of windows: poses (B, N, 7), VOs (B, P, 7) ->
    (B, N, 7), on ``device``.

    ``fc=False``: chain constraints (P = N-1, 7Scenes); ``fc=True``: all
    pairs i < j (P = N(N-1)/2, RobotCar). Raises ``ValueError`` naming the
    windows whose normal equations were not positive definite.
    """
    poses = _as_tensor(poses, device)
    vos = _as_tensor(vos, poses.device)
    B, n = poses.shape[0], poses.shape[1]
    pairs = pair_indices_fc(n) if fc else chain_pairs(n)
    if poses.shape[2:] != (7,) or vos.shape != (B, len(pairs[0]), 7):
        raise ValueError(
            f"poses {tuple(poses.shape)} and VOs {tuple(vos.shape)} are not "
            f"(B, N, 7) and (B, {len(pairs[0])}, 7) "
            f"({'fully connected' if fc else 'chain'} constraints)")
    dtype = torch.promote_types(poses.dtype, torch.float32)
    # forward-mode AD needs normal tensors: under a caller's inference mode
    # torch.func cannot batch the dual of an inference tensor (torch 2.11)
    with torch.inference_mode(False):
        poses = poses.to(dtype)
        vos = vos.to(dtype)
        if poses.is_inference() or vos.is_inference():
            poses, vos = poses.clone(), vos.clone()
        return _gauss_newton(poses, vos, pairs, (sax, saq, srx, srq),
                             n_iters)


def _gauss_newton(poses, vos, pairs, variances, n_iters):
    """The batched solve of :func:`optimize_poses_batch`."""
    B, n = poses.shape[0], poses.shape[1]
    dtype, dev = poses.dtype, poses.device
    weights = tuple(1.0 / torch.sqrt(torch.tensor(float(s), dtype=dtype,
                                                  device=dev))
                    for s in variances)
    i, j = (torch.from_numpy(np.asarray(p, np.int64)).to(dev) for p in pairs)

    def residuals_twice(x, z, p, v):
        r = _residuals(x, z, p, v, i, j, weights)
        return r, r

    # (J, r) of every window: J (B, R, N, 6), r (B, R)
    jac = vmap(jacfwd(residuals_twice, has_aux=True), in_dims=(None, 0, 0, 0))
    x0 = torch.zeros((n, 6), dtype=dtype, device=dev)
    z = poses
    failed = torch.zeros(B, dtype=torch.bool, device=dev)
    solves["calls"] += 1
    solves["windows"] += B
    for _ in range(n_iters):
        with span("pgo.linearize"):
            J, r = jac(x0, z, poses, vos)
        with span("pgo.solve"):
            J = J.reshape(B, r.shape[1], n * 6)
            Jt = J.transpose(1, 2)
            L, info = torch.linalg.cholesky_ex(Jt @ J)
            failed |= info != 0
            x = torch.cholesky_solve(-(Jt @ r.unsqueeze(-1)), L).reshape(
                B, n, 6)
            # manifold update (pose_utils.py:550-573): t additive, q
            # right-multiplied by the exponential of the increment
            z = torch.cat([z[..., :3] + x[..., :3],
                           qmult_raw(z[..., 3:], _qexp_gn(x[..., 3:]))],
                          dim=-1)
        solves["iterations"] += 1
    with span("pgo.check"):
        bad = torch.nonzero(failed).flatten().tolist()
    if bad:
        raise ValueError(
            f"PGO: the normal equations of windows {bad[:20]}"
            f"{' ...' if len(bad) > 20 else ''} ({len(bad)} of {B}) are not "
            f"positive definite")
    return z


def gauss_newton_pgo(
    poses,
    vos,
    sax: float = 1.0,
    saq: float = 1.0,
    srx: float = 1.0,
    srq: float = 1.0,
    n_iters: int = 10,
    fc: bool = False,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """PGO of one N-pose graph: poses (N, 7), VOs (P, 7) -> (N, 7)."""
    poses = _as_tensor(poses, device)
    vos = _as_tensor(vos, poses.device)
    return optimize_poses_batch(poses[None], vos[None], sax=sax, saq=saq,
                                srx=srx, srq=srq, n_iters=n_iters, fc=fc)[0]


def optimize_poses(
    pred_poses: np.ndarray,
    vos: np.ndarray | None = None,
    fc_vos: bool = False,
    target_poses: np.ndarray | None = None,
    sax: float = 1.0,
    saq: float = 1.0,
    srx: float = 1.0,
    srq: float = 1.0,
    n_iters: int = 10,
    device: torch.device | str | None = None,
) -> np.ndarray:
    """Numpy in and out, as the reference's ``optimize_poses``
    (pose_utils.py:773-804), solved on ``device`` (the card when None).

    Without ``vos`` they are derived from ``target_poses`` as world-frame
    translation differences and relative quaternions of consecutive poses
    (the reference's fallback, with its world-frame translation).
    """
    if vos is None:
        if target_poses is None:
            raise ValueError("specify either vos or target_poses")
        t = np.asarray(target_poses)
        vos = np.concatenate(
            [t[1:, :3] - t[:-1, :3], qmult_np(qinv_np(t[:-1, 3:]), t[1:, 3:])],
            axis=1)
    out = gauss_newton_pgo(np.asarray(pred_poses), np.asarray(vos), sax=sax,
                           saq=saq, srx=srx, srq=srq, n_iters=n_iters,
                           fc=fc_vos, device=device)
    return out.cpu().numpy()
