"""The port's step-1 gradients against JAX's, the bf16 step, and the
upstream goldens.

- Full-batch gradients at JAX's initial variables (ResNet-18, feat_dim 32,
  the 2x3x32x48 batch of tests/test_torch_train_step.py), plain, with an
  injected dropout mask and with frozen criterion weights (no gradient on
  either side): within 1e-4 of each tensor's max-abs, the criterion's
  scalars within 1e-4 relative, the loss within 1e-5 relative; their norm
  is far above the clip of that file's "clip" case.
- The bf16 step at Flax's placement against JAX's bf16 step, held to bf16
  rounding.
- The upstream goldens (tests/golden_train.py: upstream's MapNet +
  MapNetCriterion + torch Adam, 4 steps, ResNet-34 at 64x96) under the
  bounds of tests/test_train_golden.py:122-151, and the SGD goldens.
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from geomapnet_tpu.models.torchvision_layout import (
    synthetic_posenet_state_dict,
)
from geomapnet_tpu.train import make_train_step as jax_make_train_step
from geomapnet_tpu_torch.losses.criterion import MapNetCriterion
from geomapnet_tpu_torch.models.flax_import import (
    state_dict_to_variables,
    variables_to_state_dict,
)
from geomapnet_tpu_torch.models.posenet import MapNet, PoseNet
from geomapnet_tpu_torch.models.resnet import resnet34
from geomapnet_tpu_torch.models.torch_import import (
    convert_state_dict,
    merge_variables,
)
from geomapnet_tpu_torch.train.optim import make_optimizer
from geomapnet_tpu_torch.train.state import make_eval_step, make_train_step
from test_torch_train_step import (  # noqa: F401 (autouse fixture)
    Cfg,
    _batch,
    _jax_tx,
    _models,
    _tree_pairs,
    one_torch_thread,
    step1_grads,
)

sys.path.insert(0, os.path.dirname(__file__))
import golden_train as G  # noqa: E402


# the gradients depend on the batch, the dropout mask and which criterion
# weights learn, not on the optimizer
GRAD_CFGS = {"plain": Cfg(), "dropout": Cfg(dropout=True),
             "frozen_criterion": Cfg(learn=False)}
# the clip of tests/test_torch_train_step.py's "clip" case
CLIP = 1.0


@pytest.mark.parametrize("name", sorted(GRAD_CFGS))
def test_step1_loss_and_gradients(name):
    pair = step1_grads(GRAD_CFGS[name])
    cfg = pair["cfg"]
    npt.assert_allclose(pair["loss_port"], pair["loss_jax"], rtol=1e-5)
    for name, want, got in _tree_pairs(
            jax.tree.map(np.asarray, pair["grads_jax"]["model"]["posenet"]),
            pair["grads_port"]):
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= 1e-4 * scale, name
    norm = np.sqrt(sum(float((g ** 2).sum()) for _, g, _ in _tree_pairs(
        pair["grads_port"], pair["grads_port"])))
    assert norm > 10 * CLIP    # the "clip" trajectory's clip bites
    jc = pair["grads_jax"]["criterion"]
    if cfg.learn:
        assert set(pair["cgrads_port"]) == {"sax", "saq", "srx", "srq"}
        for k, g in pair["cgrads_port"].items():
            npt.assert_allclose(float(g), float(jc[k]), rtol=1e-4, err_msg=k)
    else:
        # frozen weights take no gradient on either side
        assert pair["cgrads_port"] == {}
        assert all(float(v) == 0.0 for v in jc.values())


def test_bf16_step():
    """Two steps of the bf16 trunk at Flax's placement: the first loss
    within bf16 rounding (1e-2 relative) of JAX's bf16 step, the second
    within 5e-2 (a step moves by bf16-rounded gradients); float32
    parameters and BatchNorm statistics on both sides."""
    cfg = Cfg(bf16=True)
    jmodel, jcrit, state, tmodel, tcrit = _models(cfg)
    x, y = _batch()
    step = jax.jit(jax_make_train_step(jmodel, jcrit, _jax_tx(cfg)))
    opt = make_optimizer("adam", cfg.lr, tmodel, tcrit,
                         weight_decay=cfg.weight_decay)
    tstep = make_train_step(tmodel, tcrit, opt)
    for rtol in (1e-2, 5e-2):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y),
                           jax.random.PRNGKey(0))
        tloss = tstep(torch.from_numpy(x), torch.from_numpy(y))
        assert tloss.dtype == torch.float32
        npt.assert_allclose(float(tloss), float(loss), rtol=rtol)
    for p in tmodel.parameters():
        assert p.dtype == torch.float32
    bn = tmodel.posenet.feature_extractor.layer4_1.bn2
    assert bn.running_var.dtype == torch.float32
    want = np.asarray(state.batch_stats["posenet"]["feature_extractor"][
        "layer4_1"]["bn2"]["mean"])
    npt.assert_allclose(bn.running_mean.numpy(), want,
                        atol=5e-2 * np.abs(want).max())


# --------------------------------------------------------------------------
# upstream goldens (tests/golden_train.py), under tests/test_train_golden.py's
# bounds


def _fixed_input(shape, phase=0.5):
    n = int(np.prod(shape))
    return (np.sin(np.arange(n, dtype=np.float64) * 0.31 + phase) * 0.8
            ).reshape(shape).astype(np.float32)


def _golden_model():
    model = MapNet(PoseNet(resnet34(), feat_dim=G.FEAT_DIM, droprate=0.0))
    imported = convert_state_dict(
        synthetic_posenet_state_dict(feat_dim=G.FEAT_DIM,
                                     torch_tensors=False), strict=True)
    current = state_dict_to_variables(model.posenet.state_dict())
    model.posenet.load_state_dict(variables_to_state_dict(
        merge_variables(current, imported)))
    x = _fixed_input((2, 3, 3, 64, 96), phase=0.9).transpose(0, 1, 3, 4, 2)
    targ = (_fixed_input((2, 3, 6), phase=2.5) * 0.1).astype(np.float32)
    return model, torch.from_numpy(np.ascontiguousarray(x)), \
        torch.from_numpy(targ)


def test_adam_trajectory_meets_upstream_goldens():
    model, x, targ = _golden_model()
    crit = MapNetCriterion(sax=0.0, saq=-3.0, srx=0.0, srq=-3.0,
                           learn_beta=True, learn_gamma=True)

    # step-1 gradients, on copies
    m1, c1 = copy.deepcopy(model), copy.deepcopy(crit)
    m1.train()
    c1(m1(x), targ).backward()
    pn = m1.posenet
    got = {
        "crit.sax": c1.sax.grad, "crit.saq": c1.saq.grad,
        "crit.srx": c1.srx.grad, "crit.srq": c1.srq.grad,
        "mapnet.fc_xyz.weight": pn.fc_xyz.weight.grad,
        "mapnet.fc_xyz.bias": pn.fc_xyz.bias.grad,
        "mapnet.fc_wpqr.weight": pn.fc_wpqr.weight.grad,
        "mapnet.fc_wpqr.bias": pn.fc_wpqr.bias.grad,
        "mapnet.feature_extractor.fc.bias": pn.fc_feat.bias.grad,
    }
    for name, want in G.STEP1_GRADS.items():
        g = got[name].numpy().reshape(np.asarray(want).shape)
        atol = 1e-5 if name.startswith("crit.") else 5e-4
        npt.assert_allclose(g, np.asarray(want), atol=atol, rtol=1e-3,
                            err_msg=name)

    opt = make_optimizer("adam", G.LR, model, crit,
                         weight_decay=G.WEIGHT_DECAY)
    step = make_train_step(model, crit, opt)
    losses = [float(step(x, targ)) for _ in range(G.N_STEPS)]
    npt.assert_allclose(losses[0], G.TRAIN_LOSSES[0], atol=2e-4)
    npt.assert_allclose(losses, G.TRAIN_LOSSES, rtol=2e-3, atol=5e-3)
    for name, want in G.CRIT_FINAL.items():
        npt.assert_allclose(float(getattr(crit, name)), want, atol=5e-5,
                            err_msg=name)
    _, out = make_eval_step(model)(x)
    npt.assert_allclose(out.numpy(), G.EVAL_OUT_AFTER, atol=2e-3)


def test_sgd_trajectory_meets_upstream_goldens():
    model, x, targ = _golden_model()
    crit = MapNetCriterion(sax=0.0, saq=-3.0, srx=0.0, srq=-3.0,
                           learn_beta=True, learn_gamma=True)
    opt = make_optimizer("sgd", G.SGD_LR, model, crit,
                         weight_decay=G.WEIGHT_DECAY, momentum=G.SGD_MOMENTUM)
    step = make_train_step(model, crit, opt)
    losses = [float(step(x, targ)) for _ in range(G.N_STEPS)]
    npt.assert_allclose(losses[0], G.SGD_LOSSES[0], atol=2e-4)
    npt.assert_allclose(losses[:2], G.SGD_LOSSES[:2], atol=3e-3)
    npt.assert_allclose(losses, G.SGD_LOSSES, rtol=5e-2, atol=5e-2)
    for name, want in G.SGD_CRIT_FINAL.items():
        npt.assert_allclose(float(getattr(crit, name)), want, atol=2e-3,
                            err_msg=name)
