"""The port's pose-graph optimization against the benchmark's plain
reference (``benchmark/reference/pgo.py``: float64 torch, a Jacobian
written out by hand, LU solves; it imports neither the port nor JAX).

- The reference's residuals and truncated Jacobian equal the port's
  ``_residuals`` and its ``jacfwd`` at x = 0 in float64 within 1e-12; its
  full Jacobian equals central differences of its residuals on the
  manifold.
- ``optimize_poses_batch`` equals ``optimize`` on seeded random windows,
  chain and all pairs, T in {2, 7}: float64 within 1e-9; float32 within
  2e-5, the bound of tests/test_torch_pgo.py against JAX (ten iterations
  of float32 solves: each one's increment carries a few ulps of the
  normal matrix's rounding, and the poses are of order 1, where an ulp is
  1.2e-7).
- The truncation is real: the full Jacobian's solution differs from the
  port's, so the reference keeps upstream's truncated one.
- Windows whose VOs agree with their poses are a fixed point; the VOs of
  ``relative`` are those of the port's ``vos_logq_np``.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.func import jacfwd

from benchmark.reference import pgo as ref
from geomapnet_tpu_torch.data.vo_np import vos_logq_np
from geomapnet_tpu_torch.pgo import optimize_poses_batch
from geomapnet_tpu_torch.pgo import pose_graph as TP
# an autouse fixture: one torch thread while this module runs
from test_torch_train_step import one_torch_thread  # noqa: F401

F64_TOL = 1e-9
F32_TOL = 2e-5
VARIANCES = (0.8, 1.5, 0.3, 2.0)


def windows(n_windows, n, fc=False, seed=0, noise=0.3):
    """Absolute poses (B, n, 7) scattered around smooth paths, and the
    paths' own VOs (B, P, 7), float64: the two disagree, as a network's
    poses and visual odometry do."""
    g = torch.Generator().manual_seed(seed)
    steps = torch.randn(n_windows, n, 3, generator=g, dtype=torch.float64)
    t = torch.cumsum(0.5 * steps, dim=1)
    rot = 0.3 * torch.randn(n_windows, 1, 3, generator=g,
                            dtype=torch.float64) + 0.1 * torch.cumsum(
        torch.randn(n_windows, n, 3, generator=g, dtype=torch.float64), 1)
    path = torch.cat([t, ref.qexp(rot)], -1)
    vos = ref.relative(path, fc)
    moved = ref.qmul(path[..., 3:], ref.qexp(noise * 0.5 * torch.randn(
        n_windows, n, 3, generator=g, dtype=torch.float64)))
    poses = torch.cat([t + noise * torch.randn(
        n_windows, n, 3, generator=g, dtype=torch.float64), moved], -1)
    return poses, vos


def _port_jacobian(z, poses, vos, fc):
    n = z.shape[0]
    i, j = (torch.from_numpy(np.asarray(a, np.int64))
            for a in ref.pairs(n, fc))
    w = tuple(torch.tensor(1.0 / np.sqrt(s), dtype=torch.float64)
              for s in VARIANCES)
    x0 = torch.zeros((n, 6), dtype=torch.float64)
    r = TP._residuals(x0, z, poses, vos, i, j, w)
    J = jacfwd(TP._residuals)(x0, z, poses, vos, i, j, w)
    return r, J.reshape(r.shape[0], 6 * n)


def _moved(poses, seed=5):
    """Poses away from the priors, so that every block of the Jacobian is
    exercised."""
    g = torch.Generator().manual_seed(seed)
    d = 0.2 * torch.randn(poses.shape[:-1] + (6,), generator=g,
                          dtype=torch.float64)
    return torch.cat([poses[..., :3] + d[..., :3],
                      ref.qmul(poses[..., 3:], ref.qexp(d[..., 3:]))], -1)


@pytest.mark.parametrize("fc", [False, True], ids=["chain", "fc"])
@pytest.mark.parametrize("n", [2, 7])
def test_residuals_and_jacobian_match_port(fc, n):
    poses, vos = windows(3, n, fc, seed=n)
    z = _moved(poses)
    got_r = ref.residuals(z, poses, vos, VARIANCES, fc)
    got_J = ref.jacobian(z, VARIANCES, fc)
    for b in range(3):
        want_r, want_J = _port_jacobian(z[b], poses[b], vos[b], fc)
        torch.testing.assert_close(got_r[b], want_r, rtol=0, atol=1e-12)
        torch.testing.assert_close(got_J[b], want_J, rtol=0, atol=1e-12)


def _retract(z, x):
    """The manifold update of poses ``z`` (B, N, 7) by ``x`` (B, N, 6)."""
    return torch.cat([z[..., :3] + x[..., :3],
                      ref.qmul(z[..., 3:], ref.qexp(x[..., 3:]))], -1)


@pytest.mark.parametrize("fc", [False, True], ids=["chain", "fc"])
def test_full_jacobian_is_the_derivative(fc):
    """Central differences of the residuals along each increment equal the
    full Jacobian; the truncated one differs from it only in the pairwise
    translation rows' base-rotation columns."""
    n, eps = 4, 1e-6
    poses, vos = windows(2, n, fc, seed=11)
    z = _moved(poses)
    full = ref.jacobian(z, VARIANCES, fc, truncated=False)
    num = torch.empty_like(full)
    for c in range(6 * n):
        x = torch.zeros(2, n * 6, dtype=torch.float64)
        x[:, c] = eps
        up = ref.residuals(_retract(z, x.view(2, n, 6)), poses, vos,
                           VARIANCES, fc)
        down = ref.residuals(_retract(z, -x.view(2, n, 6)), poses, vos,
                             VARIANCES, fc)
        num[:, :, c] = (up - down) / (2 * eps)
    torch.testing.assert_close(full, num, rtol=0, atol=1e-7)
    trunc = ref.jacobian(z, VARIANCES, fc, truncated=True)
    diff = (trunc - full).abs().amax(0)
    i, _ = ref.pairs(n, fc)
    blocks = torch.zeros_like(diff, dtype=torch.bool)
    for p, a in enumerate(i.tolist()):
        row = 7 * n + 7 * p
        blocks[row:row + 3, 6 * a + 3:6 * a + 6] = True
        assert diff[row:row + 3, 6 * a + 3:6 * a + 6].max() > 1e-2
    assert diff[~blocks].max() == 0


@pytest.mark.parametrize("fc", [False, True], ids=["chain", "fc"])
@pytest.mark.parametrize("n", [2, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_port_matches_reference(fc, n, dtype):
    poses, vos = windows(32, n, fc, seed=100 + n)
    want = ref.optimize(poses, vos, VARIANCES, fc=fc)
    got = optimize_poses_batch(poses.to(dtype), vos.to(dtype), *VARIANCES,
                               fc=fc, device="cpu")
    assert got.dtype == dtype and got.shape == poses.shape
    torch.testing.assert_close(
        got.double(), want, rtol=0,
        atol=F64_TOL if dtype == torch.float64 else F32_TOL)
    assert (want - poses).abs().max() > 0.05          # the solve moved them


@pytest.mark.parametrize("fc", [False, True], ids=["chain", "fc"])
def test_truncation_is_kept(fc):
    """With the full Jacobian the solution moves well away from the port's,
    and the truncated reference stays on it."""
    poses, vos = windows(16, 7, fc, seed=7)
    port = optimize_poses_batch(poses, vos, *VARIANCES, fc=fc, device="cpu")
    trunc = ref.optimize(poses, vos, VARIANCES, fc=fc)
    full = ref.optimize(poses, vos, VARIANCES, fc=fc, truncated=False)
    torch.testing.assert_close(port, trunc, rtol=0, atol=F64_TOL)
    assert (full - port).abs().max() > 1e-2


@pytest.mark.parametrize("fc", [False, True], ids=["chain", "fc"])
def test_consistent_windows_are_a_fixed_point(fc):
    poses, _ = windows(4, 7, fc, seed=3)
    vos = ref.relative(poses, fc)
    torch.testing.assert_close(ref.optimize(poses, vos, VARIANCES, fc=fc),
                               poses, rtol=0, atol=1e-12)
    torch.testing.assert_close(
        optimize_poses_batch(poses, vos, *VARIANCES, fc=fc, device="cpu"),
        poses, rtol=0, atol=1e-12)


def test_relative_matches_the_port_vos():
    """The reference's chain VOs of [t, log q] poses are the port's
    ``vos_logq_np`` (there as [t, log q]) up to float64 rounding."""
    poses, _ = windows(5, 7, seed=9)
    logq = ref.qlog(poses[..., 3:])
    for b in range(5):
        p6 = torch.cat([poses[b, :, :3], logq[b]], -1).numpy()
        want = vos_logq_np(p6)
        got = ref.relative(torch.cat([poses[b, :, :3], ref.qexp(logq[b])],
                                     -1))
        np.testing.assert_allclose(got[:, :3].numpy(), want[:, :3],
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(ref.qlog(got[:, 3:]).numpy(), want[:, 3:],
                                   rtol=0, atol=1e-12)


def test_reference_imports_neither_port_nor_jax():
    """The reference's own imports: numpy and torch only."""
    tree = ast.parse(Path(ref.__file__).read_text())
    names = {a.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)}
    assert names == {"__future__", "numpy", "torch"}
