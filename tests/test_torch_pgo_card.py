"""PGO on the card against PGO on the CPU, without JAX.

The H100 machine has no JAX, so this file imports none; run it there with

    python -m pytest --noconftest tests/test_torch_pgo_card.py -q

The windows are noisy predictions around random smooth trajectories, with
VOs exact for the trajectories (``chip_smoke.py::pgo_windows`` at a small
size). On the CPU: exact predictions are a fixed point of the solve and
noisy ones move toward the trajectories. On the card: float32 results
within 1e-4 of the CPU's (ten Gauss-Newton iterations whose products and
factorizations sum in another order; chip_smoke.py's ``PGO_TOL``).
"""

import numpy as np
import pytest
import torch

from geomapnet_tpu_torch.geometry import (
    pair_indices_fc,
    qexp_np,
    qinv_np,
    qmult_np,
    rotate_vector_np,
)
from geomapnet_tpu_torch.pgo import chain_pairs, optimize_poses_batch

CARD_TOL = 1e-4


def windows(n_windows, n=7, fc=False, seed=0, noise=0.1):
    """(predictions (W, n, 7), VOs (W, P, 7), trajectories (W, n, 7)),
    float64."""
    rng = np.random.RandomState(seed)
    half_yaw = (rng.uniform(-np.pi, np.pi, (n_windows, 1))
                + 0.15 * np.arange(n)) / 2
    zero = np.zeros_like(half_yaw)
    q = np.stack([np.cos(half_yaw), zero, zero, np.sin(half_yaw)], -1)
    q = qmult_np(q, qexp_np(rng.randn(n_windows, n, 3) * 0.03))
    t = np.cumsum(rng.randn(n_windows, n, 3) * 0.3, axis=1)
    i, j = pair_indices_fc(n) if fc else chain_pairs(n)
    qi_inv = qinv_np(q[:, i])
    vos = np.concatenate([rotate_vector_np(t[:, j] - t[:, i], qi_inv),
                          qmult_np(qi_inv, q[:, j])], -1)
    noisy_q = q + rng.randn(*q.shape) * noise * 0.2
    noisy_q /= np.linalg.norm(noisy_q, axis=-1, keepdims=True)
    noisy = np.concatenate([t + rng.randn(*t.shape) * noise, noisy_q], -1)
    return noisy, vos, np.concatenate([t, q], -1)


@pytest.mark.parametrize("fc", [False, True], ids=["chain", "fc"])
def test_cpu_fixed_point_and_denoising(fc):
    _, vos, truth = windows(16, fc=fc, seed=1)
    exact = optimize_poses_batch(torch.from_numpy(truth),
                                 torch.from_numpy(vos), fc=fc, device="cpu")
    np.testing.assert_allclose(exact.numpy(), truth, rtol=0, atol=1e-9)
    noisy, vos, truth = windows(16, fc=fc, seed=2)
    out = optimize_poses_batch(torch.from_numpy(noisy), torch.from_numpy(vos),
                               fc=fc, srx=0.05, srq=0.05, device="cpu")
    err = np.linalg.norm(out.numpy()[..., :3] - truth[..., :3], axis=-1)
    before = np.linalg.norm(noisy[..., :3] - truth[..., :3], axis=-1)
    assert err.mean() < 0.7 * before.mean()


def test_inside_inference_mode():
    """Called under ``torch.inference_mode`` with inference tensors (a
    model's outputs there), the solve still runs, on normal tensors, with
    the same result."""
    noisy, vos, _ = windows(4, seed=3)
    want = optimize_poses_batch(torch.from_numpy(noisy),
                                torch.from_numpy(vos), device="cpu")
    with torch.inference_mode():
        p, v = torch.from_numpy(noisy) * 1, torch.from_numpy(vos) * 1
        assert p.is_inference()
        got = optimize_poses_batch(p, v, device="cpu")
    assert not got.is_inference()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("fc", [False, True], ids=["chain", "fc"])
def test_card_matches_cpu(fc):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    noisy, vos, _ = windows(64, fc=fc, seed=9)
    p, v = (torch.from_numpy(a.astype(np.float32)) for a in (noisy, vos))
    cpu = optimize_poses_batch(p, v, fc=fc, device="cpu")
    card = optimize_poses_batch(p, v, fc=fc, device="cuda")
    assert card.device.type == "cuda" and card.dtype == torch.float32
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=0,
                               atol=CARD_TOL)
    with torch.inference_mode():
        again = optimize_poses_batch(p.cuda() * 1, v.cuda() * 1, fc=fc)
    assert torch.equal(again, card)
