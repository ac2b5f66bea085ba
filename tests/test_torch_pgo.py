"""The port's pose-graph optimization against the JAX package and the
executed upstream reference.

- The Jacobian of ``_residuals`` at x = 0 equals JAX's ``jax.jacfwd`` in
  float64 within 1e-14 (a few entries differ by an ulp of rounding), chain
  and fully connected, the ``detach()`` of the base rotation included.
- ``gauss_newton_pgo`` equals JAX's: float64 within 1e-10, float32 within
  2e-5 (ten iterations of float32 solves in two libraries).
- The upstream goldens ``pgo_chain_out``, ``pgo_chain_w_out`` and
  ``pgo_fc_out`` (tests/golden_reference.py, scipy float64): from float32
  inputs within 2e-3, the bound of tests/test_golden_parity.py, and in
  float64 within 1e-6.
- Batched equals single, ``optimize_poses`` derives its VOs from targets as
  JAX does, the refusals, and the fixed-point / denoising cases of
  tests/test_pgo.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from geomapnet_tpu.data.vo_np import vos_logq_fc_np
from geomapnet_tpu.geometry import euler2mat, mat2quat, qlog_np
from geomapnet_tpu.geometry.rotations import (
    qexp_np,
    qinv_np,
    qmult_np,
    rotate_vector_np,
)
from geomapnet_tpu.pgo import gauss_newton_pgo as jax_gn
from geomapnet_tpu.pgo import optimize_poses as jax_optimize_poses
from geomapnet_tpu.pgo import optimize_poses_batch as jax_gn_batch
from geomapnet_tpu.pgo import pose_graph as JP
from geomapnet_tpu_torch.pgo import (
    chain_pairs,
    gauss_newton_pgo,
    optimize_poses,
    optimize_poses_batch,
)
from geomapnet_tpu_torch.pgo import pose_graph as TP
from golden_reference import GOLDEN

CPU = torch.device("cpu")
GOLDEN_TOL = 2e-3        # tests/test_golden_parity.py::TestPGO
F32_TOL = 2e-5
F64_TOL = 1e-10


def noisy_windows(n_windows, n=7, fc=False, seed=0, noise=0.1):
    """Noisy predicted poses around smooth ground-truth trajectories, and
    VOs consistent with the ground truth: (W, n, 7), (W, P, 7), float64."""
    rng = np.random.RandomState(seed)
    pairs = JP.pair_indices_fc(n) if fc else JP.chain_pairs(n)
    poses, vos = [], []
    for _ in range(n_windows):
        yaw = rng.uniform(-np.pi, np.pi) + 0.15 * np.arange(n)
        gt = np.zeros((n, 7))
        for k in range(n):
            gt[k, 3:] = mat2quat(euler2mat(rng.randn() * 0.05,
                                           rng.randn() * 0.05, yaw[k]))
        gt[:, :3] = np.cumsum(rng.randn(n, 3) * 0.3, axis=0)
        vos.append(consistent_vos(gt, pairs))
        noisy = gt.copy()
        noisy[:, :3] += rng.randn(n, 3) * noise
        q = noisy[:, 3:] + rng.randn(n, 4) * noise * 0.2
        noisy[:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
        poses.append(noisy)
    return np.stack(poses), np.stack(vos)


def consistent_vos(poses7, pairs):
    """VOs exactly consistent with the poses (p0-frame convention)."""
    i, j = pairs
    dt = rotate_vector_np(poses7[j, :3] - poses7[i, :3],
                          qinv_np(poses7[i, 3:]))
    q = qmult_np(qinv_np(poses7[i, 3:]), poses7[j, 3:])
    return np.concatenate([dt, q], axis=1)


def diag_poses(n=3, yaw_deg=45.0):
    """The reference's pgo_test_poses1 trajectory (tests/test_pgo.py)."""
    q = mat2quat(euler2mat(0, 0, np.deg2rad(yaw_deg)))
    poses = np.zeros((n, 7))
    poses[:, 3:] = q
    for i in range(n):
        poses[i, :3] = [i, i, 0.0]
    return poses


@pytest.mark.parametrize("fc", [False, True], ids=["chain", "fc"])
@pytest.mark.parametrize("seed", [0, 1])
def test_jacobian_matches_jax_jacfwd(fc, seed):
    """At x = 0 around perturbed poses z (not the priors), so every block
    of the Jacobian, the truncated d(rt)/d(q_i) included, is exercised."""
    poses, vos = noisy_windows(1, n=5, fc=fc, seed=seed)
    poses, vos = poses[0], vos[0]
    z = poses.copy()
    z[:, :3] += 0.3
    z[:, 3:] = qmult_np(z[:, 3:], qexp_np(np.full((5, 3), 0.1)))
    pairs = JP.pair_indices_fc(5) if fc else JP.chain_pairs(5)
    w = (0.7, 1.3, 0.4, 2.0)
    with jax.enable_x64(True):
        want = np.asarray(jax.jacfwd(JP._residuals)(
            jnp.zeros((5, 6)), jnp.asarray(z), jnp.asarray(poses),
            jnp.asarray(vos), tuple(jnp.asarray(p) for p in pairs),
            tuple(jnp.asarray(v) for v in w)))
    t = [torch.from_numpy(a) for a in (z, poses, vos)]
    got = jacfwd(TP._residuals)(
        torch.zeros((5, 6), dtype=torch.float64), *t,
        *(torch.from_numpy(p) for p in pairs),
        tuple(torch.tensor(v, dtype=torch.float64) for v in w)).numpy()
    assert got.shape == want.shape == ((5 + len(pairs[0])) * 7, 5, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    # the truncation is real: dropping detach() would change the rt rows
    rows = 5 * 7 + np.arange(len(pairs[0]))[:, None] * 7 + np.arange(3)
    assert np.abs(got[rows.ravel()]).max() > 0


@pytest.mark.parametrize("fc", [False, True], ids=["chain", "fc"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_gauss_newton_matches_jax(fc, dtype):
    poses, vos = noisy_windows(3, fc=fc, seed=4)
    kw = dict(sax=0.8, saq=1.5, srx=0.3, srq=2.0, fc=fc)
    for p, v in zip(poses.astype(dtype), vos.astype(dtype)):
        got = gauss_newton_pgo(torch.from_numpy(p), torch.from_numpy(v),
                               **kw)
        assert got.dtype == torch.from_numpy(p).dtype
        with jax.enable_x64(dtype == np.float64):
            want = np.asarray(jax_gn(jnp.asarray(p), jnp.asarray(v), **kw))
        assert want.dtype == dtype
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=F64_TOL if dtype == np.float64 else F32_TOL)
        assert np.abs(got.numpy() - p).max() > 1e-3   # it did move


@pytest.mark.parametrize("name,vos_key,kw", [
    ("pgo_chain_out", "pgo_vos", {}),
    ("pgo_chain_w_out", "pgo_vos", dict(sax=0.5, saq=0.5, srx=10.0,
                                        srq=10.0)),
    ("pgo_fc_out", "pgo_fc_vos", dict(fc=True)),
])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_goldens(name, vos_key, kw, dtype):
    """The reference's chain topology reads only the first N-1 VO rows of
    ``pgo_test_poses1`` (tests/test_golden_parity.py::TestPGO)."""
    vos = GOLDEN[vos_key] if kw.get("fc") else GOLDEN[vos_key][:2]
    out = gauss_newton_pgo(GOLDEN["pgo_poses"].astype(dtype),
                           vos.astype(dtype), device=CPU, **kw)
    np.testing.assert_allclose(
        out.numpy(), GOLDEN[name], rtol=0,
        atol=GOLDEN_TOL if dtype == np.float32 else 1e-6)


@pytest.mark.parametrize("fc", [False, True], ids=["chain", "fc"])
def test_batched_equals_single_and_jax_batch(fc):
    poses, vos = noisy_windows(6, fc=fc, seed=2)
    p32, v32 = poses.astype(np.float32), vos.astype(np.float32)
    batched = optimize_poses_batch(torch.from_numpy(p32),
                                   torch.from_numpy(v32), fc=fc, srx=0.5)
    assert batched.shape == (6, 7, 7)
    for b in range(6):
        single = gauss_newton_pgo(torch.from_numpy(p32[b]),
                                  torch.from_numpy(v32[b]), fc=fc, srx=0.5)
        np.testing.assert_allclose(batched[b].numpy(), single.numpy(),
                                   rtol=0, atol=1e-6)
    want = np.asarray(jax_gn_batch(jnp.asarray(p32), jnp.asarray(v32),
                                   fc=fc, srx=0.5))
    np.testing.assert_allclose(batched.numpy(), want, rtol=0, atol=F32_TOL)


def test_denoises_toward_ground_truth():
    """Noisy predictions plus exact VOs end closer to the ground truth
    (tests/test_pgo.py::test_pgo_denoises_predictions, over 20 windows)."""
    poses, vos = noisy_windows(20, seed=5, noise=0.2)
    gt_poses, _ = noisy_windows(20, seed=5, noise=0.0)
    out = optimize_poses_batch(torch.from_numpy(poses),
                               torch.from_numpy(vos), srx=0.05,
                               srq=0.05).numpy()
    before = np.linalg.norm(poses[..., :3] - gt_poses[..., :3], axis=-1)
    after = np.linalg.norm(out[..., :3] - gt_poses[..., :3], axis=-1)
    assert after.mean() < 0.7 * before.mean()


def test_consistent_graph_is_fixed_point():
    poses = diag_poses()
    vos = consistent_vos(poses, chain_pairs(3))
    out = gauss_newton_pgo(poses.astype(np.float32), vos.astype(np.float32),
                           device=CPU).numpy()
    np.testing.assert_allclose(out[:, :3], poses[:, :3], atol=1e-4)
    dot = np.abs(np.sum(out[:, 3:] * poses[:, 3:], axis=1))
    np.testing.assert_allclose(dot, 1.0, atol=1e-5)


def test_reference_perturbed_scenario():
    """pgo_test_poses1 + test_pgo of the reference (tests/test_pgo.py): the
    perturbed VOs pull the poses, the unary terms anchor them, the total
    residual drops, and the port equals JAX."""
    poses = diag_poses()
    pt = np.concatenate([poses[:, :3], qlog_np(poses[:, 3:])], 1)
    vost = vos_logq_fc_np(pt)
    vos = np.concatenate([vost[:, :3], qexp_np(vost[:, 3:])], 1)
    vos[0, 0] = vos[1, 0] = np.sqrt(2) - 0.5
    out = gauss_newton_pgo(poses.astype(np.float32), vos.astype(np.float32),
                           fc=True, device=CPU).numpy()
    np.testing.assert_allclose(np.linalg.norm(out[:, 3:], axis=1), 1.0,
                               atol=1e-4)
    assert not np.allclose(out[:, :3], poses[:, :3], atol=1e-3)
    pairs = JP.pair_indices_fc(3)

    def total_residual(z):
        return (np.sum((consistent_vos(z, pairs) - vos) ** 2)
                + np.sum((z - poses) ** 2))

    assert total_residual(out) < total_residual(poses)
    want = np.asarray(jax_gn(jnp.asarray(poses, jnp.float32),
                             jnp.asarray(vos, jnp.float32), fc=True))
    np.testing.assert_allclose(out, want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("fc", [False, True], ids=["targets", "fc_vos"])
def test_optimize_poses_matches_jax(fc):
    """From ``target_poses`` (world-frame translation differences, relative
    quaternions) or from all-pairs VOs, numpy in and out, in float64 here
    as JAX under x64."""
    poses = diag_poses(4)
    noisy = poses.copy()
    noisy[:, :3] += np.random.RandomState(3).randn(4, 3) * 0.1
    kw = dict(sax=1.0, saq=1.0, srx=20.0, srq=20.0)
    if fc:
        pt = np.concatenate([poses[:, :3], qlog_np(poses[:, 3:])], 1)
        v = vos_logq_fc_np(pt)
        kw.update(vos=np.concatenate([v[:, :3], qexp_np(v[:, 3:])], 1),
                  fc_vos=True)
    else:
        kw.update(target_poses=poses)
    got = optimize_poses(noisy, device="cpu", **kw)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    with jax.enable_x64(True):
        want = jax_optimize_poses(noisy, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_TOL)


def test_refusals():
    with pytest.raises(ValueError, match="vos or target_poses"):
        optimize_poses(diag_poses(), device="cpu")
    p = torch.from_numpy(diag_poses(4))
    with pytest.raises(ValueError, match=r"\(B, 3, 7\)"):
        gauss_newton_pgo(p, p[:2])                 # chain needs N-1 rows
    with pytest.raises(ValueError, match=r"\(B, 6, 7\)"):
        gauss_newton_pgo(p, p[:3], fc=True)        # fc needs N(N-1)/2


def test_singular_windows_are_named():
    """Without a translation prior (sax = inf) the graph has a free
    translation: the window's normal equations are singular and the solve
    raises, naming the window, after the last iteration."""
    poses, vos = noisy_windows(3, seed=1)
    with pytest.raises(ValueError, match=r"windows \[0, 1, 2\] \(3 of 3\)"):
        optimize_poses_batch(torch.from_numpy(poses), torch.from_numpy(vos),
                             sax=float("inf"))
