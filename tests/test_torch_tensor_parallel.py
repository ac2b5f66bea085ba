"""Tensor parallelism and spatial partitioning on four gloo ranks on the
CPU, against the JAX package (tests/test_tensor_parallel.py's bars).

One group of four ranks (:mod:`grid_ranks`) runs every case of this file:

- the tensor-parallel train step of a ResNet-18 MapNet (feat_dim 32,
  8 tuples of 3 frames at 32x32, Adam 1e-3 with weight decay 5e-4) on a
  2x2 ``('data', 'model')`` grid: loss and gradients against the JAX
  package's one-device ``value_and_grad`` (loss within 1e-5 relative,
  every gradient within 1e-2 relative norm: JAX's bars; the port meets
  1e-6 and 5e-3, its worst leaves BatchNorm biases), and the updated state
  (:func:`gather_head`) against the JAX package's own tensor-parallel step
  on a 2x2 mesh (Adam's first update within lr / 100 wherever the
  gradient, weight decay included, is 1e-2 of its leaf's norm and past
  1e-5: no gap the gradients may have flips its sign; within 2 lr
  elsewhere; BatchNorm statistics within 1e-4 of their max-abs);
- the same step with hashed dropout and a global-norm clip that bites,
  against the port's one-rank step (the ranks draw their columns of the
  full-width mask; the clip sums the head's blocks over ``model``);
- each step's updated parameters against the port's one-rank step on the
  same batch, within 1e-6 wherever the effective gradient passes 1e-5
  (1e3 times Adam's eps), also for a model whose optimizer stepped before
  its head was sharded (Adam's moments sliced with the head);
- every rank's gradients and state bit-equal to rank 0's;
- a model trained so loads its gathered state on one process and gives the
  tensor-parallel model's eval forward;
- the spatially partitioned eval over a 1x4 grid (32 rows in 4 bands: half
  a row a band by layer 3) and a 2x2 grid, against JAX's one-device eval
  step (atol and rtol 1e-4, JAX's bar; the port meets 1e-5);
- the grid's and the layout's errors, word for word where JAX has them.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JaxP

from geomapnet_tpu.losses import MapNetCriterion as JaxMapNetCriterion
from geomapnet_tpu.models import MapNet as JaxMapNet
from geomapnet_tpu.models import PoseNet as JaxPoseNet
from geomapnet_tpu.models import resnet18 as jax_resnet18
from geomapnet_tpu.parallel import make_mesh as jax_make_mesh
from geomapnet_tpu.parallel import shard_batch as jax_shard_batch
from geomapnet_tpu.parallel import shard_step_tp as jax_shard_step_tp
from geomapnet_tpu.parallel import tp_state_shardings as jax_tp_shardings
from geomapnet_tpu.train import create_train_state
from geomapnet_tpu.train import make_eval_step as jax_make_eval_step
from geomapnet_tpu.train import make_optimizer as jax_make_optimizer
from geomapnet_tpu.train import make_train_step as jax_make_train_step
from geomapnet_tpu_torch.models.flax_import import (
    state_dict_to_variables,
    variables_to_state_dict,
)
from dp_ranks import run_group
from grid_ranks import digest, train_step_case

FEAT = 32
LR = 1e-3
WD = 5e-4
SHAPES = ((1, 4), (2, 2))


def _jax_model(droprate=0.0):
    return JaxMapNet(posenet=JaxPoseNet(feature_extractor=jax_resnet18(),
                                        feat_dim=FEAT, droprate=droprate))


def _jax_criterion():
    return JaxMapNetCriterion(saq=-3.0, srq=-3.0, learn_beta=True,
                              learn_gamma=True)


@pytest.fixture(scope="module")
def setup():
    model, crit = _jax_model(), _jax_criterion()
    tx = jax_make_optimizer("adam", LR, weight_decay=WD)
    state = create_train_state(model, crit, tx, jax.random.PRNGKey(0),
                               jnp.zeros((2, 3, 32, 32, 3)))
    torch_state = variables_to_state_dict({
        "params": jax.tree.map(np.asarray, state.params["model"]["posenet"]),
        "batch_stats": jax.tree.map(np.asarray,
                                    state.batch_stats["posenet"])})
    rs = np.random.RandomState(5)
    x = rs.randn(8, 3, 32, 32, 3).astype(np.float32)
    y = (rs.randn(8, 3, 6) * 0.1).astype(np.float32)
    images = rs.randn(2, 3, 32, 32, 3).astype(np.float32)
    return dict(model=model, crit=crit, tx=tx, state=state,
                torch_state=torch_state, x=x, y=y, images=images)


CASES = ("plain", "dropout_clip", "stepped_before")


def _cases(setup):
    common = dict(feat=FEAT, state=setup["torch_state"], lr=LR,
                  weight_decay=WD, x=setup["x"], y=setup["y"])
    return [dict(common, droprate=0.0, max_grad_norm=0.0, seed=0,
                 images=setup["images"]),
            dict(common, droprate=0.5, max_grad_norm=1.0, seed=3),
            dict(common, droprate=0.0, max_grad_norm=0.0, seed=5,
                 pre_steps=1)]


@pytest.fixture(scope="module")
def ranks(setup):
    """The four ranks' results; the group runs while the parent computes
    JAX's references."""
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(run_group, "grid_ranks:tp", 4, cases=_cases(setup),
                        spatial=dict(feat=FEAT, state=setup["torch_state"],
                                     images=setup["images"]))


@pytest.fixture(scope="module")
def jax_grads(setup):
    """JAX's unsharded ``value_and_grad`` of the first case's step."""
    model, crit, state = setup["model"], setup["crit"], setup["state"]

    def loss_fn(params, images, targets):
        out, _ = model.apply(
            {"params": params["model"], "batch_stats": state.batch_stats},
            images, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(7)})
        return crit(params["criterion"], out, targets)

    return jax.jit(jax.value_and_grad(loss_fn))(
        state.params, jnp.asarray(setup["x"]), jnp.asarray(setup["y"]))


def _rank0_and_digests(results: list, case: int, key: str) -> dict:
    """Rank 0's arrays of ``key``, after every other rank's digest is
    found equal to them (bit-equal ranks)."""
    arrays = results[0]["cases"][case][key]
    want = digest(arrays)
    for rank, r in enumerate(results[1:], 1):
        assert r["cases"][case][key] == want, (rank, key)
    return arrays


def _flax_grads(grads: dict) -> dict:
    return state_dict_to_variables({
        k.removeprefix("posenet."): torch.from_numpy(v)
        for k, v in grads.items()})["params"]


def _pairs(a, b, path=()):
    for k in a:
        if isinstance(a[k], dict):
            yield from _pairs(a[k], b[k], path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(a[k], np.float64), \
                np.asarray(b[k], np.float64)


def _relnorm(got, want):
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-9)


def test_tp_step_matches_jax_one_device(ranks, jax_grads):
    """Loss and gradients of one dp(2) x tp(2) step against JAX's
    unsharded ``value_and_grad`` (JAX's own test's reference)."""
    ref_loss, ref_grads = jax_grads
    results = ranks.result()
    for r in results:
        got = r["cases"][0]
        np.testing.assert_allclose(got["loss"], float(ref_loss), rtol=1e-5)
        np.testing.assert_allclose(got["loss"], float(ref_loss), rtol=1e-6)
        for k, v in got["crit"].items():
            np.testing.assert_allclose(
                v, float(ref_grads["criterion"][k]), rtol=1e-4, atol=1e-6,
                err_msg=k)
    grads = _flax_grads(_rank0_and_digests(results, 0, "grads"))
    for path, want, g in _pairs(jax.tree.map(
            np.asarray, ref_grads["model"]["posenet"]), grads):
        err = _relnorm(g, want)
        assert err < 1e-2, (path, err)       # JAX's bar
        assert err < 5e-3, (path, err)      # the port's, worst on BN


def test_gathered_state_matches_jax_tp_step(setup, ranks, jax_grads):
    """:func:`gather_head` after the step gives the logical head on every
    rank, equal to the JAX package's tensor-parallel step's (2x2 mesh).
    Adam's first update is lr times the sign of the gradient (weight decay
    included) wherever that is far from eps: it is held within lr / 100
    where the gradient is past 1e-2 of its leaf's norm (the gradients
    agree within 5e-3 relative norm, so none of these flips its sign), and
    within 2 lr everywhere."""
    model, crit, tx, state = (setup[k] for k in ("model", "crit", "tx",
                                                 "state"))
    mesh = jax_make_mesh(jax.devices()[:4], ("data", "model"), (2, 2))
    sharding = jax_tp_shardings(state, mesh)
    step = jax_shard_step_tp(jax_make_train_step(model, crit, tx), mesh,
                             sharding, n_batch_args=2, n_replicated_args=1,
                             donate_state=False)
    batch = jax_shard_batch((jnp.asarray(setup["x"]),
                             jnp.asarray(setup["y"])), mesh)
    new, _ = step(jax.device_put(state, sharding), *batch,
                  jax.random.PRNGKey(1))
    want = {"params": jax.tree.map(np.asarray,
                                   new.params["model"]["posenet"]),
            "batch_stats": jax.tree.map(np.asarray,
                                        new.batch_stats["posenet"])}
    states = _rank0_and_digests(ranks.result(), 0, "state")
    got = state_dict_to_variables({k: torch.from_numpy(v)
                                   for k, v in states.items()})
    head = ("fc_feat", "fc_xyz", "fc_wpqr")
    assert {k: got["params"][k]["kernel"].shape for k in head} == {
        k: want["params"][k]["kernel"].shape for k in head}
    before = dict((path, p) for path, p, _ in _pairs(
        jax.tree.map(np.asarray, state.params["model"]["posenet"]),
        want["params"]))
    grads = dict((path, g) for path, g, _ in _pairs(
        jax.tree.map(np.asarray, jax_grads[1]["model"]["posenet"]),
        want["params"]))
    for path, w, g in _pairs(want["params"], got["params"]):
        eff = np.abs(grads[path] + WD * before[path])
        firm = (eff > 1e-2 * np.linalg.norm(grads[path])) & (eff > 1e-5)
        assert np.abs(g - w).max() <= 2 * LR + 1e-6, path
        assert firm.any(), path         # every leaf is held somewhere
        assert np.abs(g - w)[firm].max() <= LR / 100, path
    for path, w, g in _pairs(want["batch_stats"], got["batch_stats"]):
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), path


def _one_rank_update(case: dict, got: dict) -> dict:
    """The port's one-rank optimizer (Adam, weight decay) stepped from the
    tensor-parallel step's starting state and optimizer state with its
    gathered gradients: the state that step must reach."""
    from geomapnet_tpu_torch.losses.criterion import MapNetCriterion
    from geomapnet_tpu_torch.train.optim import make_optimizer
    from grid_ranks import _tiny_mapnet

    model = _tiny_mapnet(case["feat"], case["droprate"])
    model.posenet.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in got["before"].items()})
    crit = MapNetCriterion(saq=-3.0, srq=-3.0, learn_beta=True,
                           learn_gamma=True)
    opt = make_optimizer("adam", case["lr"], model, crit,
                         weight_decay=case["weight_decay"])
    for k, p in model.posenet.named_parameters():
        p.grad = torch.from_numpy(got["grads"][f"posenet.{k}"])
        if k in got["moments"]:
            opt.optimizer.state[p] = {
                m: torch.from_numpy(v) for m, v in got["moments"][k].items()}
    opt.optimizer.step()
    return {k: v.numpy() for k, v in model.posenet.state_dict().items()}


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASES)
def test_tp_update_matches_one_rank(setup, ranks, case):
    """The gathered parameters after the step equal the port's one-rank
    optimizer's update from the same starting state with the same
    (gathered) gradients, within 1e-6 of each leaf's largest entry: the
    sharded blocks are stepped, by Adam's rule, with their own moments. The third case's optimizer stepped once before the head was
    sharded: its moments were sliced with the head (a wrong block moves
    the second update by lr's order). The update is held apart from the
    gradients, which the tests above hold to JAX's and to the one-rank
    step's: on the CPU a few leaves' gradients move with the thread
    count, and flip Adam's first update where they are small."""
    results = ranks.result()
    got = dict(results[0]["cases"][case])
    got["grads"] = _rank0_and_digests(results, case, "grads")
    state = _rank0_and_digests(results, case, "state")
    want = _one_rank_update(_cases(setup)[case], got)
    assert bool(got["moments"]) == (CASES[case] == "stepped_before")
    params = [k.removeprefix("posenet.") for k in got["grads"]]
    for k in params:
        w, g = want[k], state[k]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                   err_msg=k)
        # the update happened: Adam moves each leaf by about lr somewhere
        assert np.abs(g - got["before"][k]).max() > 0.5 * LR, k


def test_gathered_state_loads_on_one_process(ranks):
    """The gathered state loads into a one-process model, whose eval
    forward equals the tensor-parallel model's."""
    for r in ranks.result():
        tp = r["cases"][0]["forward"]
        np.testing.assert_allclose(r["gathered_forward"], tp, rtol=1e-5,
                                   atol=1e-5 * np.abs(tp).max())


def test_tp_dropout_and_clip_match_one_rank(setup, ranks):
    """With hashed dropout and a clip that scales the gradients, the step
    equals the port's one-rank step on the same global batch: each rank's
    keep-mask is its columns of the full-width mask, and the clip's norm
    sums the head's blocks over ``model``."""
    want = train_step_case(_cases(setup)[1])
    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                       for g in want["grads"].values()))
    assert abs(norm - 1.0) < 1e-4   # the clip scaled them to its bound
    results = ranks.result()
    for r in results:
        np.testing.assert_allclose(r["cases"][1]["loss"], want["loss"],
                                   rtol=1e-5)
    grads = _rank0_and_digests(results, 1, "grads")
    for k, w in want["grads"].items():
        assert _relnorm(grads[k], w) < 1e-4, k


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_spatial_eval_matches_jax(setup, ranks, shape):
    """Height-banded eval over ``model`` (batch over ``data``) against
    JAX's one-device eval step."""
    _, want = jax.jit(jax_make_eval_step(setup["model"]))(
        setup["state"], jnp.asarray(setup["images"]))
    want = np.asarray(want)
    d, m = shape
    for rank, r in enumerate(ranks.result()):
        sp = r["spatial"][shape]
        assert sp["spec"] == ("data", None, "model", None, None)
        assert sp["block"] == (2 // d, 3, 32 // m, 32, 3)
        np.testing.assert_allclose(sp["out"], want, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(sp["out"], want, atol=1e-5, rtol=1e-5)
    assert ranks.result()[0]["spec4"] == ("data", "model", None, None)


def test_grid_errors_match_jax(ranks):
    """The 2-D grid's errors are JAX's ``make_mesh``'s, word for word, and a
    -1 extent is inferred."""
    devices = jax.devices()[:4]
    want = {}
    for key, kw in (("{'shape': (3, 2)}", dict(shape=(3, 2))),
                    ("{}", dict()), ("{'shape': (2,)}", dict(shape=(2,)))):
        with pytest.raises(ValueError) as e:
            jax_make_mesh(devices, ("data", "model"), **kw)
        want[key] = str(e.value)
    r = ranks.result()[0]
    for key, msg in want.items():
        assert r["errors"][key] == msg
    assert r["inferred"] == {"data": 2, "model": 2}
    assert r["grid"] == dict(shape={"data": 2, "model": 2}, coords=(0, 0),
                             data=2, model=2)


def test_tp_layout_matches_jax(setup, ranks):
    """The head's layout: the leaves JAX shards over 'model' are the ones
    the port shards (a torch weight is a Flax kernel transposed), and an
    indivisible feat_dim raises JAX's message."""
    mesh = jax_make_mesh(jax.devices()[:4], ("data", "model"), (1, 4))
    specs = jax_tp_shardings(setup["state"], mesh).params["model"]["posenet"]
    flax_dim = {JaxP(None, "model"): 1, JaxP("model", None): 0,
                JaxP("model"): 0}
    want = {}
    for mod in ("fc_feat", "fc_xyz", "fc_wpqr"):
        for leaf, name in (("kernel", "weight"), ("bias", "bias")):
            spec = specs[mod][leaf].spec
            if spec != JaxP():
                d = flax_dim[spec]
                want[f"posenet.{mod}.{name}"] = 1 - d if leaf == "kernel" \
                    else d
    dims = ranks.result()[0]["dims"]
    assert {k: v for k, v in dims.items() if v is not None} == want
    msg = ranks.result()[0]["errors"]["indivisible"]
    assert msg == (
        "tensor-parallel dim 0 of posenet/fc_feat/weight has size 30, not "
        "divisible by the 4-device 'model' mesh axis (feat_dim must be a "
        "multiple of the model-parallel degree 4)")
