"""The port's VidLoc against the Flax module, and its LSTM against the
upstream goldens, on the CPU.

- ``nn.LSTM`` loaded straight from the torch-named weights of
  tests/test_lstm_golden.py gives the observed upstream outputs
  (tests/golden_lstm.py) within 1e-6;
- Flax -> state_dict -> Flax is exact for VidLoc's whole tree (trunk,
  ``lstm_fwd`` / ``lstm_bwd``, ``fc_pose``), and ``convert_lstm_weights``
  inverts the bridge's LSTM layout exactly;
- VidLoc (ResNet-18 trunk, hidden 16, 2 sequences of 4 frames at 32x32) on
  numpy-seeded variables: float32 within 1e-5 of Flax, bf16 within the
  port's bf16 bound (``BF16_TOL`` of the float32 output's scale, as the
  PoseNet bf16 tests), each module's output dtype pinned to Flax's;
- one Adam train step through the port's ``make_train_step`` against JAX's
  with the same injected keep-mask, within tests/test_torch_train_step.py's
  bounds.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomapnet_tpu.losses import PoseNetCriterion as JaxPoseNetCriterion
from geomapnet_tpu.models import VidLoc as FlaxVidLoc
from geomapnet_tpu.models import resnet18 as flax_resnet18
from geomapnet_tpu.models.torch_import import (
    convert_lstm_weights as jax_convert_lstm_weights,
)
from geomapnet_tpu.train import TrainState
from geomapnet_tpu.train import make_optimizer as jax_make_optimizer
from geomapnet_tpu.train import make_train_step as jax_make_train_step
from geomapnet_tpu_torch.losses.criterion import PoseNetCriterion
from geomapnet_tpu_torch.models import VidLoc, convert_lstm_weights
from geomapnet_tpu_torch.models.flax_import import (
    state_dict_to_variables,
    variables_to_state_dict,
)
from geomapnet_tpu_torch.models.resnet import resnet18
from geomapnet_tpu_torch.train.optim import make_optimizer
from geomapnet_tpu_torch.train.state import make_train_step, step_keep_mask
from test_lstm_golden import _fixed_input, _torch_named_weights
from test_torch_models import seeded_variables
from test_torch_sevenscenes import BF16_TOL
from test_torch_train_step import _interceptor, _tree_pairs

sys.path.insert(0, os.path.dirname(__file__))
from golden_lstm import BI_OUT, HIDDEN, IN, UNI_OUT  # noqa: E402

N, T, H, W = 2, 4, 32, 32
LSTM_H = 16
P = 0.5
LR = 1e-5
# The LSTM's input kernels are scaled by this so that its gates'
# pre-activations are O(1) on the random trunk's features (up to ~100 with
# random BatchNorm statistics): the cell's working range. With He-scaled
# input kernels they reach O(10), where the bf16 rounding of the features
# is amplified: Flax's own bf16 poses then differ 13% from its float32 ones.
LSTM_INPUT_SCALE = 0.03


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread (the lane's six workers share the cores; it also
    fixes the CPU's float32 sum orders)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("bidirectional", [False, True],
                         ids=["uni", "bi"])
def test_lstm_matches_upstream_goldens(bidirectional):
    """``nn.LSTM`` with upstream's own weights (no conversion) reproduces
    the observed upstream outputs."""
    lstm = torch.nn.LSTM(IN, HIDDEN, batch_first=True,
                         bidirectional=bidirectional)
    lstm.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                          _torch_named_weights(bidirectional).items()},
                         strict=True)
    with torch.inference_mode():
        out, _ = lstm(torch.from_numpy(_fixed_input()))
    want = BI_OUT if bidirectional else UNI_OUT
    np.testing.assert_allclose(out.numpy(), want, atol=1e-6)


def _flax(dtype=jnp.float32, droprate=0.0):
    return FlaxVidLoc(feature_extractor=flax_resnet18(dtype=dtype),
                      hidden_size=LSTM_H, droprate=droprate, dtype=dtype)


def _port(variables, dtype=torch.float32, droprate=0.0):
    model = VidLoc(resnet18(dtype), hidden_size=LSTM_H, droprate=droprate,
                   dtype=dtype)
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return model


def _variables(seed=0):
    """Numpy-seeded VidLoc variables (tests/test_torch_models.py's
    generator), the LSTM's input kernels scaled by ``LSTM_INPUT_SCALE``."""
    template = jax.eval_shape(_flax().init, jax.random.PRNGKey(0),
                              jnp.zeros((1, T, H, W, 3)))
    variables = seeded_variables(template, seed)
    for cell in ("lstm_fwd", "lstm_bwd"):
        for gate in "ifgo":
            leaf = variables["params"][cell][f"i{gate}"]
            leaf["kernel"] = (leaf["kernel"] * LSTM_INPUT_SCALE).astype(
                np.float32)
    return variables


def _video(seed=1, n=N):
    return np.random.RandomState(seed).randn(n, T, H, W, 3).astype(
        np.float32)


def _assert_trees_equal(a, b, path=""):
    assert sorted(a) == sorted(b), path
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, path
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{path}/{k}")


def test_weight_bridge_round_trips_exactly():
    """Flax -> state_dict -> Flax gives back every array of VidLoc's tree,
    the state_dict fills every tensor of the port's module, and the LSTM
    tensors are the layout that ``convert_lstm_weights`` (both packages')
    inverts."""
    variables = _variables(seed=2)
    sd = variables_to_state_dict(variables)
    model = VidLoc(resnet18(), hidden_size=LSTM_H)
    model.load_state_dict(sd, strict=True)
    _assert_trees_equal(state_dict_to_variables(model.state_dict()),
                        variables)
    lstm = {k[len("lstm."):]: v.numpy() for k, v in sd.items()
            if k.startswith("lstm.")}
    assert not lstm["bias_hh_l0"].any()
    assert not lstm["bias_hh_l0_reverse"].any()
    for reverse, cell in ((False, "lstm_fwd"), (True, "lstm_bwd")):
        for convert in (convert_lstm_weights, jax_convert_lstm_weights):
            _assert_trees_equal(convert(lstm, reverse=reverse),
                                variables["params"][cell])


def test_forward_matches_flax():
    """float32 poses within 1e-5 of Flax's: the LSTM and the pose head
    are a few hundred multiply-adds deep, and the trunk's features differ
    only in their sums' order."""
    variables = _variables()
    x = _video()
    want = np.asarray(jax.jit(_flax().apply)(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = _port(variables).eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (N, T, 6)
    assert np.abs(want).max() > 1e-2     # not a saturated, vanishing output
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _dtypes_of(model, x):
    got = {}
    for name in ("feature_extractor", "lstm", "fc_pose"):
        getattr(model, name).register_forward_hook(
            lambda m, i, o, name=name: got.__setitem__(
                name, str((o[0] if isinstance(o, tuple) else o).dtype)))
    with torch.inference_mode():
        out = model(x)
    return out, got


def test_bf16_forward_and_casts_match_flax():
    """bf16 at Flax's placement: the trunk's features come out float32,
    are cast to bf16 (where the dropout runs), the recurrence runs in
    float32 on them (Flax's cell promotes bf16 with its float32
    parameters), ``fc_pose`` in bf16, the poses float32; the poses within
    ``BF16_TOL`` of the float32 output's scale of Flax's bf16 output."""
    variables = _variables(seed=3)
    x = _video(seed=4)
    flax = _flax(jnp.bfloat16, droprate=P)
    want, state = flax.apply(variables, jnp.asarray(x),
                             capture_intermediates=True,
                             mutable=["intermediates"])
    inter = state["intermediates"]
    flax_dtypes = {k: str(jax.tree.leaves(inter[k]["__call__"])[0].dtype)
                   for k in ("feature_extractor", "Dropout_0", "RNN_0",
                             "RNN_1", "fc_pose")}
    assert flax_dtypes == {"feature_extractor": "float32",
                           "Dropout_0": "bfloat16", "RNN_0": "float32",
                           "RNN_1": "float32", "fc_pose": "bfloat16"}
    port = _port(variables, torch.bfloat16, droprate=P).eval()
    got, port_dtypes = _dtypes_of(port, torch.from_numpy(x))
    assert port_dtypes == {"feature_extractor": "torch.float32",
                           "lstm": "torch.float32",
                           "fc_pose": "torch.bfloat16"}
    got = got.numpy()
    with torch.inference_mode():
        f32 = _port(variables).eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == np.asarray(want).dtype == np.float32
    scale = np.abs(f32).max()
    assert np.abs(got - np.asarray(want)).max() <= BF16_TOL * scale
    assert 0 < np.abs(got - f32).max() <= BF16_TOL * scale   # bf16 ran


def test_bidirectional_uses_future_frames():
    """A change in the last frame must affect the first frame's pose."""
    torch.manual_seed(0)
    model = VidLoc(resnet18(), hidden_size=LSTM_H, droprate=0.0).eval()
    x = torch.from_numpy(np.random.RandomState(0).rand(
        1, T, H, W, 3).astype(np.float32))
    x2 = x.clone()
    x2[:, -1] += 1.0
    with torch.inference_mode():
        base, out2 = model(x), model(x2)
    assert base.shape == (1, T, 6) and base.dtype == torch.float32
    assert not np.allclose(base[0, 0].numpy(), out2[0, 0].numpy())


def test_train_step_matches_jax():
    """One Adam step (weight decay, learned beta) of VidLoc under a
    PoseNetCriterion on (N, T, 6) targets, both packages from the same
    variables and batch, dropout on the trunk features through the same
    injected keep-mask: the loss within 1e-5 relative, BatchNorm
    statistics within 1e-4 of each tensor's max-abs, the criterion's
    weights within 1e-5, every parameter within 2 lr (a near-zero
    gradient whose sign the packages' sums flip moves a full step the
    other way)."""
    variables = _variables(seed=5)
    rs = np.random.RandomState(6)
    x = rs.randn(N, T, H, W, 3).astype(np.float32)
    y = (rs.randn(N, T, 6) * 0.1).astype(np.float32)
    mask = rs.rand(N, T, resnet18().out_features) >= P

    jmodel = _flax(droprate=P)
    jcrit = JaxPoseNetCriterion(saq=-3.0, learn_beta=True)
    tx = jax_make_optimizer("adam", LR, 5e-4, steps_per_epoch=1)
    params = jax.tree.map(jnp.asarray, {"model": variables["params"],
                                        "criterion": jcrit.init_params()})
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray,
                                                variables["batch_stats"]),
                       opt_state=jax.jit(tx.init)(params))
    step = jax.jit(jax_make_train_step(jmodel, jcrit, tx))
    with _interceptor(jnp.asarray(mask)):
        state, jloss = step(state, jnp.asarray(x), jnp.asarray(y),
                            jax.random.PRNGKey(0))

    tmodel = _port(variables, droprate=P)
    tcrit = PoseNetCriterion(saq=-3.0, learn_beta=True)
    opt = make_optimizer("adam", LR, tmodel, tcrit, weight_decay=5e-4,
                         steps_per_epoch=1)
    tstep = make_train_step(tmodel, tcrit, opt)
    tloss = tstep(torch.from_numpy(x), torch.from_numpy(y),
                  keep_masks=[torch.from_numpy(mask.reshape(N * T, -1))])

    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k in ("sax", "saq"):
        np.testing.assert_allclose(getattr(tcrit, k).item(),
                                   float(state.params["criterion"][k]),
                                   atol=1e-5, err_msg=k)
    got = state_dict_to_variables(tmodel.state_dict())
    for name, want, have in _tree_pairs(
            jax.tree.map(np.asarray, state.batch_stats), got["batch_stats"]):
        assert np.abs(have - want).max() <= 1e-4 * np.abs(want).max(), name
    for name, want, have in _tree_pairs(
            jax.tree.map(np.asarray, state.params["model"]), got["params"]):
        assert np.abs(have - want).max() <= 2 * LR, name
    before = dict((n, w) for n, w, _ in _tree_pairs(variables["params"],
                                                    variables["params"]))
    lstm = [n for n, w, _ in _tree_pairs(
        jax.tree.map(np.asarray, state.params["model"]), got["params"])
        if n.startswith("lstm_bwd/") and not np.array_equal(w, before[n])]
    assert lstm and opt.count == 1    # the recurrence was trained too


def test_trains_with_hashed_dropout_masks():
    """Without injected masks the step draws VidLoc's keep-mask over its
    trunk features from ``step_keep_mask`` (the same step with that mask
    injected is bit-equal); and, as JAX's
    ``TestVidLoc::test_trains_with_standard_step`` asks (dropout off), five
    Adam steps at lr 1e-3 lower the loss."""
    def setup(droprate):
        torch.manual_seed(0)
        model = VidLoc(resnet18(), hidden_size=LSTM_H, droprate=droprate)
        crit = PoseNetCriterion()
        opt = make_optimizer("adam", 1e-3, model, crit, steps_per_epoch=1)
        return model, opt, make_train_step(model, crit, opt)

    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(N, 3, H, W, 3).astype(np.float32))
    y = torch.zeros(N, 3, 6)
    model, opt, step = setup(P)
    mask = step_keep_mask(0, opt.step_t, 0, (N * 3, model.lstm.input_size),
                          P)
    hashed = float(step(x, y))
    assert float(setup(P)[2](x, y, keep_masks=[mask])) == hashed
    step = setup(0.0)[2]
    losses = [float(step(x, y)) for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
