"""The port's torch geometry (quaternion, SE(3), VO) against the JAX package.

Every function of ``geomapnet_tpu_torch.geometry.{quaternion,se3,vo}`` runs
beside its ``geomapnet_tpu.geometry`` counterpart on the same numpy-seeded
inputs, in float32 and in float64 (JAX under ``jax.enable_x64``). The
inputs carry the probes that caught bugs before: 180-degree rotations
(w == 0, the hemisphere edge), the identity rotation through the log and
exp maps, and the smallest tuple (T = 2).

Tolerances: float64 within 1e-12; float32 within 1e-5 relative plus 1e-6
absolute (the two libraries' transcendental functions may round an ulp
apart, and acos near |w| = 1 magnifies that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomapnet_tpu.geometry import quaternion as jq
from geomapnet_tpu.geometry import se3 as jse3
from geomapnet_tpu.geometry import vo as jvo
from geomapnet_tpu_torch import geometry
from geomapnet_tpu_torch.geometry import quaternion as tq
from geomapnet_tpu_torch.geometry import se3 as tse3
from geomapnet_tpu_torch.geometry import vo as tvo

TOL = {np.float32: dict(rtol=1e-5, atol=1e-6),
       np.float64: dict(rtol=1e-12, atol=1e-12)}


def _unit_q(n, rng):
    """n random unit quaternions with, at the front, the identity, two
    180-degree rotations (w == 0) and a w < 0 one."""
    q = rng.randn(n, 4)
    q[0] = [1, 0, 0, 0]
    q[1] = [0, 1, 0, 0]
    q[2] = [0, 0.6, 0, 0.8]
    q[3, 0] = -abs(q[3, 0])
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    q = _unit_q(12, rng)
    q2 = _unit_q(12, rng)[::-1].copy()
    logq = rng.randn(12, 3) * 0.7
    logq[0] = 0.0                          # identity through qexp
    logq[1] = [np.pi / 2, 0, 0]            # 180 degrees: w = cos(pi/2)
    v = rng.randn(12, 3)
    p7 = np.concatenate([rng.randn(12, 3), q], axis=1)
    p7b = np.concatenate([rng.randn(12, 3), q2], axis=1)
    p6 = np.concatenate([rng.randn(12, 3), logq], axis=1)
    p6b = np.concatenate([rng.randn(12, 3), logq[::-1]], axis=1)
    seq2 = np.concatenate([rng.randn(4, 2, 3), rng.randn(4, 2, 3) * 0.5],
                          axis=-1)                         # T = 2
    seq5 = np.concatenate([rng.randn(3, 5, 3), rng.randn(3, 5, 3) * 0.5],
                          axis=-1)
    seq5[:, 2, 3:] = 0.0                   # identity frames in a tuple
    return dict(q=q, q2=q2, logq=logq, v=v, p7=p7, p7b=p7b, p6=p6, p6b=p6b,
                seq2=seq2, seq5=seq5)


# (module pair, function, argument names, keyword arguments)
CASES = [
    ("q", "vdot", ("q", "q2"), {}),
    ("q", "normalize", ("v",), {}),
    ("q", "normalize", ("v",), dict(eps=2.0)),
    ("q", "qmult_raw", ("q", "q2"), {}),
    ("q", "qmult", ("q", "q2"), {}),
    ("q", "qinv", ("q",), {}),
    ("q", "qexp", ("logq",), {}),
    ("q", "qlog", ("q",), {}),
    ("q", "qexp_exact", ("logq",), {}),
    ("q", "qlog_exact", ("q",), {}),
    ("q", "rotate_vec_by_q", ("v", "q"), {}),
    ("q", "hemisphere", ("q",), {}),
    ("se3", "compose", ("p7", "p7b"), {}),
    ("se3", "invert", ("p7",), {}),
    ("se3", "relative_pose", ("p7", "p7b"), {}),
    ("se3", "relative_pose_logq", ("p6", "p6b"), {}),
    ("se3", "relative_pose_logq", ("p6", "p6b"), dict(exact=True)),
    ("se3", "world_relative_pose", ("p7", "p7b"), {}),
    ("se3", "world_relative_pose_logq", ("p6", "p6b"), {}),
    ("se3", "world_relative_pose_logq", ("p6", "p6b"), dict(exact=True)),
    ("vo", "vos_simple", ("seq5",), {}),
    ("vo", "vos_logq", ("seq2",), {}),
    ("vo", "vos_logq", ("seq5",), dict(exact=True)),
    ("vo", "vos_logq_fc", ("seq2",), {}),
    ("vo", "vos_logq_fc", ("seq5",), {}),
    ("vo", "vos_logq_fc", ("seq5",), dict(exact=False)),
]
MODULES = {"q": (tq, jq), "se3": (tse3, jse3), "vo": (tvo, jvo)}


def _case_id(case):
    mod, fn, args, kw = case
    return "-".join([fn, *args, *(f"{k}={v}" for k, v in kw.items())])


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_matches_jax(case, dtype):
    mod, fn, names, kw = case
    ours, theirs = (getattr(m, fn) for m in MODULES[mod])
    arrays = [_inputs()[n].astype(dtype) for n in names]
    got = ours(*(torch.from_numpy(a) for a in arrays), **kw)
    assert got.dtype == torch.from_numpy(arrays[0]).dtype
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(theirs(*(jnp.asarray(a) for a in arrays), **kw))
    assert want.dtype == dtype
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


def test_probes_exact_values():
    """Identity in, identity out; a 180-degree log-quaternion maps to w = 0
    and back; the hemisphere leaves w == 0 alone and flips w < 0."""
    zero = torch.zeros(2, 3, dtype=torch.float64)
    ident = torch.tensor([[1.0, 0, 0, 0]] * 2, dtype=torch.float64)
    for exp in (tq.qexp, tq.qexp_exact):
        assert torch.equal(exp(zero), ident)
    for log in (tq.qlog, tq.qlog_exact):
        assert torch.equal(log(ident), zero)
    half_turn = tq.qexp_exact(torch.tensor([[0.0, np.pi / 2, 0]],
                                           dtype=torch.float64))
    np.testing.assert_allclose(half_turn.numpy(), [[0, 0, 1, 0]], atol=1e-15)
    np.testing.assert_allclose(tq.qlog_exact(half_turn).numpy(),
                               [[0, np.pi / 2, 0]], atol=1e-15)
    q = torch.tensor([[0.0, 0, 1, 0], [-0.6, 0.8, 0, 0]],
                     dtype=torch.float64)
    np.testing.assert_array_equal(tq.hemisphere(q).numpy(),
                                  [[0, 0, 1, 0], [0.6, -0.8, 0, 0]])


def test_pair_indices_and_exports():
    """The all-pairs order is the reference's row-major one, in numpy; the
    package exports the torch functions beside the numpy ones."""
    for T in (2, 3, 7):
        for a, b in zip(tvo.pair_indices_fc(T), jvo.pair_indices_fc(T)):
            assert isinstance(a, np.ndarray)
            np.testing.assert_array_equal(a, b)
    i, j = tvo.pair_indices_fc(4)
    assert list(zip(i.tolist(), j.tolist())) == [
        (0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    for name in (tq.__all__ + tse3.__all__ + tvo.__all__
                 + ["qexp_np", "process_poses", "translation_error"]):
        assert hasattr(geometry, name), name


def test_batch_broadcast_and_autograd():
    """Trailing-axis functions broadcast over leading axes, and the clamped
    maps have finite gradients at the origin (the losses' contract)."""
    x = torch.zeros(2, 3, 3, dtype=torch.float64, requires_grad=True)
    tq.qlog(tq.qexp(x)).sum().backward()
    assert torch.isfinite(x.grad).all()
    p = torch.from_numpy(_inputs()["seq5"])
    assert tvo.vos_logq_fc(p[None]).shape == (1, 3, 10, 6)
    np.testing.assert_allclose(tvo.vos_logq_fc(p[None])[0].numpy(),
                               tvo.vos_logq_fc(p).numpy(), rtol=0, atol=0)
