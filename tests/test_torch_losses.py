"""The port's criteria against the JAX package's.

``l1_loss``, ``quaternion_loss``, ``PoseNetCriterion`` and
``MapNetCriterion`` on the same seeded predictions and targets (float32):
values within 1e-6 relative, gradients with respect to the predictions and
to the loss weights within 1e-6 of each tensor's max-abs (sums in another
order). Weights that do not learn take no gradient in the port
(``requires_grad`` off) and a zero one in JAX (``stop_gradient``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from geomapnet_tpu.losses import criterion as jc
from geomapnet_tpu_torch.losses import criterion as tc

WEIGHTS = dict(sax=0.3, saq=-3.0, srx=-0.2, srq=-2.5)


def _data(shape, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape).astype(np.float32),
            rs.randn(*shape).astype(np.float32))


def _compare(jax_crit, port_crit, pred, targ, names):
    cp = {k: jnp.float32(WEIGHTS[k]) for k in names}

    def f(cp, p):
        return jax_crit(cp, p, jnp.asarray(targ))

    want, (gc, gp) = jax.value_and_grad(f, argnums=(0, 1))(
        cp, jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = port_crit(p, torch.from_numpy(targ))
    got.backward()
    npt.assert_allclose(float(got), float(want), rtol=1e-6)
    gp = np.asarray(gp)
    assert np.abs(p.grad.numpy() - gp).max() <= 1e-6 * np.abs(gp).max()
    for k in names:
        param = getattr(port_crit, k)
        if param.requires_grad:
            npt.assert_allclose(float(param.grad), float(gc[k]), rtol=1e-6,
                                atol=1e-7, err_msg=k)
        else:
            assert param.grad is None and float(gc[k]) == 0.0, k


@pytest.mark.parametrize("learn_beta", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_posenet_criterion(learn_beta, seed):
    pred, targ = _data((8, 6), seed)
    kw = dict(sax=WEIGHTS["sax"], saq=WEIGHTS["saq"], learn_beta=learn_beta)
    _compare(jc.PoseNetCriterion(**kw), tc.PoseNetCriterion(**kw), pred,
             targ, ("sax", "saq"))


@pytest.mark.parametrize("learn", [(False, False), (True, False),
                                   (False, True), (True, True)])
@pytest.mark.parametrize("steps", [2, 5])
def test_mapnet_criterion(learn, steps):
    pred, targ = _data((4, steps, 6), steps)
    kw = dict(WEIGHTS, learn_beta=learn[0], learn_gamma=learn[1])
    _compare(jc.MapNetCriterion(**kw), tc.MapNetCriterion(**kw), pred, targ,
             ("sax", "saq", "srx", "srq"))


def test_mapnet_criterion_with_quaternion_loss():
    """A criterion with another rotation loss (the Huynh distance)."""
    pred, targ = _data((3, 3, 6), 7)
    kw = dict(WEIGHTS, learn_beta=True, learn_gamma=True)
    _compare(jc.MapNetCriterion(q_loss_fn=jc.quaternion_loss, **kw),
             tc.MapNetCriterion(q_loss_fn=tc.quaternion_loss, **kw), pred,
             targ, ("sax", "saq", "srx", "srq"))


def test_loss_functions():
    a, b = _data((5, 4), 3)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    for name in ("l1_loss", "quaternion_loss"):
        want = getattr(jc, name)(jnp.asarray(a), jnp.asarray(b))
        got = getattr(tc, name)(torch.from_numpy(a), torch.from_numpy(b))
        npt.assert_allclose(float(got), float(want), rtol=1e-6, err_msg=name)


def test_weights_are_parameters():
    """The loss weights are the criterion's parameters (what the optimizer
    and the checkpoint see), learnable as the flags say."""
    crit = tc.MapNetCriterion(saq=-3.0, srq=-2.0, learn_beta=True)
    params = dict(crit.named_parameters())
    assert list(params) == ["sax", "saq", "srx", "srq"]
    assert [p.requires_grad for p in params.values()] == [True, True, False,
                                                          False]
    assert float(params["srq"]) == -2.0
    assert set(crit.state_dict()) == set(params)
