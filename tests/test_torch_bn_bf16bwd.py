"""The bfloat16 BatchNorm backward (``bn_bf16_bwd``) against the default
BatchNorm and against the JAX package's ``bn_train_norm_bf16bwd``.

- Forward and running statistics: bit-identical to the port's default
  train-mode BatchNorm (float32 and bf16 trunks, two forwards each, so the
  second reads statistics the first moved).
- One BatchNorm layer: the port's ``BatchNormBf16Backward`` against JAX's
  ``bn_train_norm_bf16bwd`` on the same float32 input and cotangent: the
  output within 1e-5 (the two packages sum their statistics in another
  order), the input, scale and bias gradients within 2e-2 of each
  tensor's max-abs (bf16 rounding of the elementwise terms).
- Trunk gradients of ``sum(features^2)`` (ResNet-18, train mode) within
  the bound of tests/test_models.py (``TestBnBf16Backward``): for every
  parameter, the max gap below 8e-2 and the mean gap below 2e-2 of the
  reference gradient's max-abs. Across packages on a float32 trunk with
  ``bn_bf16_bwd`` in both, from the same variables (the BatchNorm backward
  is then the only bf16 math); on a bf16 trunk, the port's bf16 backward
  against its default one, the comparison JAX's test makes within its
  package. (Across packages a bf16 trunk's gradients differ at bf16
  rounding already with the default backward: the convs' bf16 backward
  sums in another order.)
- ``build_model(bn_bf16_bwd=True)`` gives every BatchNorm of PoseNet and
  MapNet the bf16 backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomapnet_tpu.models import resnet18 as jax_resnet18
from geomapnet_tpu.models.resnet import bn_train_norm_bf16bwd
from geomapnet_tpu_torch.cli.builders import build_model
from geomapnet_tpu_torch.cli.config import ExperimentConfig
from geomapnet_tpu_torch.models.flax_import import variables_to_state_dict
from geomapnet_tpu_torch.models.resnet import (
    BatchNorm2d,
    BatchNormBf16Backward,
    resnet18,
)
# an autouse fixture: one torch thread while this module runs
from test_torch_train_step import one_torch_thread  # noqa: E402,F401


def _pair(dtype, seed=0):
    torch.manual_seed(seed)
    a = resnet18(dtype)
    b = resnet18(dtype, bn_bf16_bwd=True)
    b.load_state_dict(a.state_dict())
    return a.train(), b.train()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
def test_forward_and_statistics_bit_identical(dtype, channels_last):
    a, b = _pair(dtype)
    if channels_last:
        a, b = (m.to(memory_format=torch.channels_last) for m in (a, b))
    x = torch.from_numpy(np.random.RandomState(1).randn(
        4, 32, 48, 3).astype(np.float32))
    for _ in range(2):
        ya, yb = a(x), b(x)
        assert torch.equal(ya, yb)
    for (k, u), v in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(u, v), k
    assert b.layer2_0.bn1.num_batches_tracked.item() == 2


def test_layer_matches_jax():
    rs = np.random.RandomState(2)
    x = (rs.randn(6, 16, 9, 11) * 2 + 0.5).astype(np.float32)   # NCHW
    g = rs.randn(*x.shape).astype(np.float32)
    scale = rs.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = (rs.randn(16) * 0.1).astype(np.float32)

    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    rm, rv = torch.zeros(16), torch.ones(16)
    y = BatchNormBf16Backward.apply(xt, st, bt, rm, rv, 0.1, 1e-5)
    y.backward(torch.from_numpy(g))

    def f(x, s, b):
        return bn_train_norm_bf16bwd(x, s, b, 1e-5)[0]

    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    yj, vjp = jax.vjp(f, xj, jnp.asarray(scale), jnp.asarray(bias))
    dx, ds, db = vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(yj).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-5)
    for ours, theirs in ((xt.grad.numpy(),
                          np.asarray(dx).transpose(0, 3, 1, 2)),
                         (st.grad.numpy(), np.asarray(ds)),
                         (bt.grad.numpy(), np.asarray(db))):
        scale_ = np.abs(theirs).max()
        assert np.abs(ours - theirs).max() <= 2e-2 * scale_
    # the running statistics moved as the default BatchNorm moves them
    ref = BatchNorm2d(16)
    ref.train()(torch.from_numpy(x))
    assert torch.equal(rm, ref.running_mean)
    assert torch.equal(rv, ref.running_var)


def _within_bound(want: dict, got: dict) -> None:
    assert got.keys() == want.keys()
    for k, t in want.items():
        a, b = t.double().numpy(), got[k].double().numpy()
        denom = np.abs(a).max() + 1e-12
        assert np.abs(a - b).max() / denom < 8e-2, k
        assert np.abs(a - b).mean() / denom < 2e-2, k


def _trunk_grads(trunk, x: np.ndarray) -> dict:
    trunk.train()
    feats = trunk(torch.from_numpy(x))
    (feats.float() ** 2).sum().backward()
    return {k: p.grad for k, p in trunk.named_parameters()}


X = np.random.RandomState(3).randn(4, 32, 48, 3).astype(np.float32)


def test_trunk_gradients_match_jax():
    """float32 ResNet-18 with the bf16 BatchNorm backward in both
    packages."""
    model = jax_resnet18(bn_bf16_bwd=True)
    xj = jnp.asarray(X)
    variables = jax.jit(lambda r, v: model.init(r, v, train=True))(
        jax.random.PRNGKey(1), xj)

    def loss(params):
        feats, _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            xj, train=True, mutable=["batch_stats"])
        return jnp.sum(jnp.square(feats))

    want = jax.jit(jax.grad(loss))(variables["params"])
    trunk = resnet18(bn_bf16_bwd=True)
    trunk.load_state_dict(variables_to_state_dict(
        jax.tree.map(np.asarray, dict(variables))))
    _within_bound(
        variables_to_state_dict({"params": jax.tree.map(np.asarray, want)}),
        _trunk_grads(trunk, X))


def test_bf16_trunk_gradients_near_the_default():
    default, bwd = _pair(torch.bfloat16)
    _within_bound(_trunk_grads(default, X), _trunk_grads(bwd, X))


def test_build_model_threads_the_flag():
    cfg = ExperimentConfig()
    for name in ("posenet", "mapnet"):
        for flag in (False, True):
            model, _ = build_model(name, cfg, trunk="resnet18",
                                   bn_bf16_bwd=flag)
            bns = [m for m in model.modules()
                   if isinstance(m, BatchNorm2d)]
            assert len(bns) == 20
            assert all(m.bf16_backward == flag for m in bns)
