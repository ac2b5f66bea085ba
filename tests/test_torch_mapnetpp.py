"""MapNet++ fine-tuning in the port against the JAX package and upstream.

- ``nan_grad_guard``: the identity forward and the backward that zeroes
  NaN and infinite cotangents (and nothing else), equal to JAX's exactly.
- ``MapNetOnlineCriterion`` in VO and GPS modes against JAX's, on random
  predictions and on a batch whose consecutive unlabeled predictions are
  equal (the relative quaternion's w is exactly 1, where ``arccos`` has an
  infinite derivative): the value within 1e-5 relative, the gradients with
  respect to the predictions and the four weights within 1e-5 of each
  tensor's max-abs, with the same NaN pattern; through the guard, no NaN
  and the same gradients.
- The upstream goldens (tests/golden_train.py ``ONLINE_*`` and ``GPS_*``:
  upstream's MapNet with ``filter_hook``, MapNetOnlineCriterion and torch
  Adam, 4 steps, ResNet-34 at 48x64) under tests/test_train_golden.py's
  bounds; ``srq`` exactly -3.0 in GPS mode, as upstream leaves it.
- The datasets: ``cli.builders.build_datasets("mapnet++", ...)`` against
  JAX's on the synthetic scene (VO and GPS), a 7Scenes scene with DSO VOs
  and a RobotCar raw-Bayer scene with stereo VO and GPS: every
  ``MFOnline`` item, ``get_indices`` row and ``_poses_for`` block equal.
- The train step: 4 MapNet++ steps against JAX's ``make_train_step``
  (ResNet-18, feat_dim 32, 2 items of 2x3 frames at 32x48), VO and GPS, and
  a VO batch with two equal unlabeled frames (NaN cotangents at every
  step); the bounds of tests/test_torch_train_step.py for step 1, the tail
  enveloped at 1e-3 (the SE(3) log on near-identity relative poses
  amplifies float32 noise, the shape of tests/test_train_golden.py's
  bound). In GPS mode JAX's weight decay moves the unused ``srq`` (ROADMAP.md
  Queue 3, R5): it is left out of the comparison and the port's must stay
  exactly at its init.
- The Trainer against JAX's over 2 epochs from a MapNet checkpoint, on the
  loader and from the device frame cache (lr 1e-6), and the port's
  ``ingest_overlap`` run (two recorders) equal to its serial cache run.
- The CLI: ``cli.train`` MapNet, then MapNet++ from its checkpoint with
  configs/synth_mapnetpp.ini (and its GPS variant), then ``cli.eval
  --model mapnet++ --weights ... --pose_graph``.
"""

import copy
import functools
import os
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from geomapnet_tpu.cli import builders as jax_builders
from geomapnet_tpu.cli.config import ExperimentConfig
from geomapnet_tpu.losses import MapNetOnlineCriterion as JaxOnline
from geomapnet_tpu.models import MapNet as JaxMapNet
from geomapnet_tpu.models import PoseNet as JaxPoseNet
from geomapnet_tpu.models import resnet18 as jax_resnet18
from geomapnet_tpu.models.posenet import nan_grad_guard as jax_guard
from geomapnet_tpu.models.torchvision_layout import (
    synthetic_posenet_state_dict,
)
from geomapnet_tpu.train import TrainState
from geomapnet_tpu.train import make_train_step as jax_make_train_step
from geomapnet_tpu.train.loop import Trainer as JaxTrainer
from geomapnet_tpu_torch.cli import builders
from geomapnet_tpu_torch.cli import eval as cli_eval
from geomapnet_tpu_torch.cli import train as cli_train
from geomapnet_tpu_torch.cli.config import ExperimentConfig as PortConfig
from geomapnet_tpu_torch.data import MFOnline
from geomapnet_tpu_torch.losses import MapNetOnlineCriterion
from geomapnet_tpu_torch.models.flax_import import (
    state_dict_to_variables,
    variables_to_state_dict,
)
from geomapnet_tpu_torch.models.posenet import MapNet, PoseNet, nan_grad_guard
from geomapnet_tpu_torch.models.resnet import resnet18, resnet34
from geomapnet_tpu_torch.models.torch_import import (
    convert_state_dict,
    merge_variables,
)
from geomapnet_tpu_torch.train.checkpoint import save_checkpoint
from geomapnet_tpu_torch.train.loop import Trainer
from geomapnet_tpu_torch.train.optim import make_optimizer
from geomapnet_tpu_torch.train.state import make_train_step
from test_torch_eval import _make_verify_fixture, write_bayer_scene
from test_torch_eval_pgo import write_dso_vo, write_stereo_vo
# an autouse fixture: one torch thread while this module runs
from test_torch_train_step import (  # noqa: F401
    Cfg,
    _jax_tx,
    _tree_pairs,
    one_torch_thread,
)
from test_torch_trainer import _records

sys.path.insert(0, os.path.dirname(__file__))
import golden_train as G  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
T = 3
FEAT = 32
WEIGHTS = dict(sax=0.3, saq=-3.0, srx=-0.2, srq=-2.5)
NAMES = ("sax", "saq", "srx", "srq")


# --------------------------------------------------------------------------
# the guard and the criterion


def test_nan_grad_guard_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(4, 3).astype(np.float32)
    g = rs.randn(4, 3).astype(np.float32)
    g[0, 1], g[2, 0], g[3, 2] = np.nan, np.inf, -np.inf
    _, vjp = jax.vjp(jax_guard, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    y = nan_grad_guard(xt)
    assert torch.equal(y, xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    finite = np.isfinite(g)
    np.testing.assert_array_equal(want[finite], g[finite])
    assert (want[~finite] == 0).all()


def _online_data(gps: bool, equal: bool, seed: int):
    """Predictions (3, 2T, 6) and targets (3, 2T-1 or 2T, 6); with
    ``equal`` the first two unlabeled predictions of every item are the
    same."""
    rs = np.random.RandomState(seed)
    pred = (rs.randn(3, 2 * T, 6) * 0.5).astype(np.float32)
    if equal:
        pred[:, T + 1] = pred[:, T]
    targ = (rs.randn(3, 2 * T if gps else 2 * T - 1, 6) * 0.5).astype(
        np.float32)
    return pred, targ


def _jax_online(gps, learn, pred, targ, guard):
    crit = JaxOnline(learn_beta=learn, learn_gamma=learn, gps_mode=gps)
    cp = {k: jnp.float32(WEIGHTS[k]) for k in NAMES}

    def f(cp, p):
        if guard:
            p = jnp.concatenate([p[..., :3], jax_guard(p[..., 3:])], -1)
        return crit(cp, p, jnp.asarray(targ))

    loss, (gc, gp) = jax.value_and_grad(f, argnums=(0, 1))(
        cp, jnp.asarray(pred))
    return float(loss), np.asarray(gp), {k: float(v) for k, v in gc.items()}


def _port_online(gps, learn, pred, targ, guard):
    crit = MapNetOnlineCriterion(**WEIGHTS, learn_beta=learn,
                                 learn_gamma=learn, gps_mode=gps)
    p = torch.from_numpy(pred).requires_grad_(True)
    q = torch.cat([p[..., :3], nan_grad_guard(p[..., 3:])], -1) if guard \
        else p
    loss = crit(q, torch.from_numpy(targ))
    loss.backward()
    grads = {k: (None if getattr(crit, k).grad is None
                 else float(getattr(crit, k).grad)) for k in NAMES}
    return float(loss.detach()), p.grad.numpy(), grads


@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("equal", [False, True])
@pytest.mark.parametrize("gps", [False, True])
def test_online_criterion_matches_jax(gps, equal, guard):
    pred, targ = _online_data(gps, equal, seed=3)
    lj, gpj, gcj = _jax_online(gps, True, pred, targ, guard)
    lt, gpt, gct = _port_online(gps, True, pred, targ, guard)
    npt.assert_allclose(lt, lj, rtol=1e-5)
    nan = np.isnan(gpj)
    np.testing.assert_array_equal(np.isnan(gpt), nan)
    # the NaN case is real: equal unlabeled predictions give NaN log-q
    # cotangents (all three lanes of both frames of the pair) in VO mode
    # without the guard, and none anywhere else
    assert nan.any() == (equal and not gps and not guard)
    if nan.any():
        assert nan[..., 3:].any(axis=-1).sum() == 2 * len(pred)
        assert not nan[..., :3].any()
    scale = np.abs(gpj[~nan]).max()
    assert np.abs(gpt[~nan] - gpj[~nan]).max() <= 1e-5 * scale
    for k in NAMES:
        if gps and k == "srq":
            # unused in GPS mode: no gradient in the port (upstream's None),
            # a zero one in JAX
            assert gct[k] is None and gcj[k] == 0.0
        else:
            npt.assert_allclose(gct[k], gcj[k], rtol=1e-5, atol=1e-6,
                                err_msg=k)


def test_frozen_online_weights_take_no_gradient():
    pred, targ = _online_data(False, False, seed=4)
    lj, gpj, gcj = _jax_online(False, False, pred, targ, False)
    lt, gpt, gct = _port_online(False, False, pred, targ, False)
    npt.assert_allclose(lt, lj, rtol=1e-5)
    assert np.abs(gpt - gpj).max() <= 1e-5 * np.abs(gpj).max()
    assert all(gct[k] is None and gcj[k] == 0.0 for k in NAMES)


def test_build_criteria_and_model_for_mapnetpp():
    for vo_lib, gps in (("stereo", False), ("gps", True)):
        cfg = PortConfig(vo_lib=vo_lib, beta=-3.0, gamma=-2.0)
        train, val = builders.build_criteria("mapnet++", cfg, True, False)
        assert isinstance(train, MapNetOnlineCriterion)
        assert train.gps_mode == val.gps_mode == gps
        assert float(train.saq) == -3.0 and float(train.srq) == -2.0
        assert train.saq.requires_grad and not train.srq.requires_grad
        assert not any(p.requires_grad for p in val.parameters())
    model, is_tuple = builders.build_model("mapnet++", PortConfig(),
                                           trunk="resnet18")
    assert is_tuple and model.posenet.filter_nans
    mapnet, _ = builders.build_model("mapnet", PortConfig(), trunk="resnet18")
    assert not mapnet.posenet.filter_nans
    # the guard adds no parameter: MapNet and MapNet++ checkpoints agree
    assert model.state_dict().keys() == mapnet.state_dict().keys()


# --------------------------------------------------------------------------
# upstream goldens, under tests/test_train_golden.py's bounds


def _fixed_input(shape, phase=0.5):
    n = int(np.prod(shape))
    return (np.sin(np.arange(n, dtype=np.float64) * 0.31 + phase) * 0.8
            ).reshape(shape).astype(np.float32)


def _golden_model():
    model = MapNet(PoseNet(resnet34(), feat_dim=G.FEAT_DIM, droprate=0.0,
                           filter_nans=True))
    imported = convert_state_dict(
        synthetic_posenet_state_dict(feat_dim=G.FEAT_DIM,
                                     torch_tensors=False), strict=True)
    current = state_dict_to_variables(model.posenet.state_dict())
    model.posenet.load_state_dict(variables_to_state_dict(
        merge_variables(current, imported)))
    x = _fixed_input((1, 4, 3, 48, 64), phase=0.3).transpose(0, 1, 3, 4, 2)
    return model, torch.from_numpy(np.ascontiguousarray(x))


def _golden_run(gps: bool):
    model, x = _golden_model()
    crit = MapNetOnlineCriterion(sax=0.0, saq=-3.0, srx=0.0, srq=-3.0,
                                 learn_beta=True, learn_gamma=True,
                                 gps_mode=gps)
    shape, phase = ((1, 4, 6), 1.7) if gps else ((1, 3, 6), 1.1)
    targ = torch.from_numpy((_fixed_input(shape, phase=phase) * 0.1
                             ).astype(np.float32))
    m1, c1 = copy.deepcopy(model), copy.deepcopy(crit)
    m1.train()
    c1(m1(x), targ).backward()
    grads = {f"crit.{k}": getattr(c1, k).grad for k in NAMES}
    grads["mapnet.fc_wpqr.weight"] = m1.posenet.fc_wpqr.weight.grad
    opt = make_optimizer("adam", G.LR, model, crit,
                         weight_decay=G.WEIGHT_DECAY)
    step = make_train_step(model, crit, opt)
    losses = [float(step(x, targ)) for _ in range(G.N_STEPS)]
    return grads, losses, crit


def test_online_vo_trajectory_meets_upstream_goldens():
    grads, losses, crit = _golden_run(gps=False)
    for name, want in G.ONLINE_STEP1_GRADS.items():
        got = grads[name].numpy().reshape(np.asarray(want).shape)
        atol = 1e-5 if name.startswith("crit.") else 5e-4
        npt.assert_allclose(got, np.asarray(want), atol=atol, rtol=1e-3,
                            err_msg=name)
    npt.assert_allclose(losses[0], G.ONLINE_LOSSES[0], atol=2e-4)
    npt.assert_allclose(losses[:2], G.ONLINE_LOSSES[:2], atol=1e-3)
    npt.assert_allclose(losses, G.ONLINE_LOSSES, rtol=1e-2, atol=1e-2)
    for name, want in G.ONLINE_CRIT_FINAL.items():
        npt.assert_allclose(getattr(crit, name).item(), want, atol=2e-4,
                            err_msg=name)


def test_online_gps_trajectory_meets_upstream_goldens():
    grads, losses, crit = _golden_run(gps=True)
    for name, want in G.GPS_STEP1_GRADS.items():
        npt.assert_allclose(float(grads[name]), float(np.asarray(want)[0]),
                            atol=1e-5, rtol=1e-3, err_msg=name)
    assert grads["crit.srq"] is None          # no rotation VO term
    npt.assert_allclose(losses[0], G.GPS_LOSSES[0], atol=2e-4)
    npt.assert_allclose(losses[:2], G.GPS_LOSSES[:2], atol=1e-3)
    npt.assert_allclose(losses, G.GPS_LOSSES, rtol=1e-2, atol=1e-2)
    for name, want in G.GPS_CRIT_FINAL.items():
        if name != "srq":
            npt.assert_allclose(getattr(crit, name).item(), want, atol=5e-4,
                                err_msg=name)
    # upstream's torch Adam skips a parameter whose gradient is None, and
    # so does the port's: srq stays exactly at its init
    assert float(crit.srq) == G.GPS_CRIT_FINAL["srq"] == -3.0


# --------------------------------------------------------------------------
# the datasets


def _gps_files(raw, assets, seq):
    """``gps/gps_ins.csv`` (every other INS row, the same schema) and the
    sequence's ``gps_vo_stats.pkl`` alignment."""
    from geomapnet_tpu.geometry import euler2mat

    ins = (raw / "loop" / seq / "gps" / "ins.csv").read_text().splitlines()
    (raw / "loop" / seq / "gps" / "gps_ins.csv").write_text(
        "\n".join(ins[:1] + ins[1::2]) + "\n")
    (assets / "RobotCar" / "loop" / seq).mkdir(parents=True, exist_ok=True)
    with open(assets / "RobotCar" / "loop" / seq / "gps_vo_stats.pkl",
              "wb") as f:
        pickle.dump({"R": euler2mat(0.1, 0, 0.3), "t": np.array([1.0, 2, 3]),
                     "s": 1.2}, f)


def _scene_args(kind, root):
    """(dataset, scene, data_path, asset_root, raw_bayer) of a fixture."""
    if kind == "synth":
        return "synth", "synth", "", "data", False
    if kind == "7Scenes":
        return ("7Scenes", "heads", str(root / "deepslam" / "7Scenes"),
                str(root / "assets"), False)
    return "RobotCar", "loop", str(root / "raw" / "RobotCar"), \
        str(root / "assets"), True


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The on-disk fixtures: a 7Scenes scene with DSO VOs for its test
    split, and a RobotCar raw-Bayer scene with stereo VO and GPS."""
    from test_torch_eval import SEQ

    root7 = _make_verify_fixture().build(tmp_path_factory.mktemp("7s"),
                                         n_frames=12, h=24, w=32)
    write_dso_vo(root7, 12)
    rc = tmp_path_factory.mktemp("rc")
    # the builders read mosaics at the camera's native size
    raw, assets = write_bayer_scene(rc, n=12, h=960, w=1280)
    write_stereo_vo(raw, assets, n=12)
    _gps_files(raw, assets, SEQ)
    (rc / "raw" / "RobotCar").mkdir()
    (raw / "loop").rename(rc / "raw" / "RobotCar" / "loop")
    return {"7Scenes": root7, "RobotCar": rc, "synth": None}


def _build_pair(kind, root, vo_lib):
    dataset, scene, data_path, asset_root, raw_bayer = _scene_args(kind,
                                                                   root)
    cfg = dict(steps=3, skip=2, seed=7, vo_lib=vo_lib, real=True,
               color_jitter=0.0)
    kw = dict(asset_root=asset_root, keep_uint8=True, raw_bayer=raw_bayer)
    if kind == "RobotCar":
        kw["raw_bayer"] = True
    ours = builders.build_datasets("mapnet++", dataset, scene, data_path,
                                   PortConfig(**cfg), **kw)
    theirs = jax_builders.build_datasets("mapnet++", dataset, scene,
                                         data_path, ExperimentConfig(**cfg),
                                         **kw)
    return ours, theirs


@pytest.mark.parametrize("kind,vo_lib", [
    ("synth", "dso"), ("synth", "gps"), ("7Scenes", "dso"),
    ("RobotCar", "stereo"), ("RobotCar", "gps")])
def test_mapnetpp_datasets_match_jax(scenes, kind, vo_lib):
    (ours, none), (theirs, jnone) = _build_pair(kind, scenes[kind], vo_lib)
    assert none is None and jnone is None
    assert isinstance(ours, MFOnline) and ours.gps_mode == (vo_lib == "gps")
    assert len(ours) == len(theirs) > 0
    assert len(ours.frame_sources) == 2
    n_train = len(ours.train_set.dset)
    assert n_train == len(theirs.train_set.dset)
    for i in range(len(ours)):
        idx = ours.get_indices(i)
        np.testing.assert_array_equal(idx, theirs.get_indices(i))
        assert idx[T:].min() >= n_train      # unlabeled rows past the train
        block = ours._poses_for(idx)
        np.testing.assert_array_equal(block, theirs._poses_for(idx))
        (im, poses), (jim, jposes) = ours[i], theirs[i]
        np.testing.assert_array_equal(im, jim)
        np.testing.assert_array_equal(poses, jposes)
        np.testing.assert_array_equal(poses, block)
        assert poses.shape == (2 * T if vo_lib == "gps" else 2 * T - 1, 6)
        assert im.shape[0] == 2 * T and im.dtype == jim.dtype


# --------------------------------------------------------------------------
# the train step


def _step_batch(gps: bool, dup: bool, seed: int):
    """2 items of 2x3 frames at 32x48 and their pose blocks; with ``dup``
    the first two unlabeled frames of each item are the same image (equal
    predictions: NaN log-q cotangents at every step)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 2 * T, 32, 48, 3).astype(np.float32)
    if dup:
        x[:, T + 1] = x[:, T]
    y = (rs.randn(2, 2 * T if gps else 2 * T - 1, 6) * 0.1).astype(
        np.float32)
    return x, y


@functools.lru_cache(maxsize=None)
def _jax_step(gps: bool):
    """JAX's MapNet++ (filter_nans), criterion, Adam chain (lr 1e-5, weight
    decay 5e-4 on every learnable weight) and jitted train step, made once
    per mode (the VO cases share one compile)."""
    jmodel = JaxMapNet(posenet=JaxPoseNet(
        feature_extractor=jax_resnet18(), feat_dim=FEAT, droprate=0.0,
        filter_nans=True))
    jcrit = JaxOnline(saq=-3.0, srq=-3.0, learn_beta=True, learn_gamma=True,
                      gps_mode=gps)
    tx = _jax_tx(Cfg())
    init = jax.jit(lambda r, x: jmodel.init(r, x, train=False))
    return (jmodel, jcrit, tx, jax.jit(jax_make_train_step(jmodel, jcrit, tx)),
            init, jax.jit(tx.init))


def _step_models(gps: bool, seed: int):
    """JAX's MapNet++ with its initial state under ``seed``, and the port's
    from the same variables."""
    cfg = Cfg(seed=seed)
    jmodel, jcrit, tx, _, init, tx_init = _jax_step(gps)
    x, _ = _step_batch(gps, False, seed)
    v = init(jax.random.PRNGKey(seed), jnp.asarray(x[:1]))
    variables = {k: jax.tree.map(np.asarray, v[k]["posenet"])
                 for k in ("params", "batch_stats")}
    params = {"model": {"posenet": v["params"]["posenet"]},
              "criterion": jcrit.init_params()}
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats={"posenet": v["batch_stats"]["posenet"]},
                       opt_state=tx_init(params))
    tmodel = MapNet(PoseNet(resnet18(), droprate=0.0, feat_dim=FEAT,
                            filter_nans=True))
    tmodel.posenet.load_state_dict(variables_to_state_dict(variables))
    tcrit = MapNetOnlineCriterion(saq=-3.0, srq=-3.0, learn_beta=True,
                                  learn_gamma=True, gps_mode=gps)
    topt = make_optimizer("adam", cfg.lr, tmodel, tcrit,
                          weight_decay=cfg.weight_decay)
    return (jmodel, jcrit, tx, state), (tmodel, tcrit, topt), cfg


# each case's seed keeps its 4-step trajectory 10x inside the bounds on the
# CPU with one torch thread (tests/test_torch_train_step.py)
STEP_CASES = {"vo": (False, False, 0), "gps": (True, False, 0),
              "vo_equal_frames": (False, True, 1)}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case):
    gps, dup, seed = STEP_CASES[case]
    (jmodel, jcrit, tx, state), (tmodel, tcrit, topt), cfg = \
        _step_models(gps, seed)
    x, y = _step_batch(gps, dup, seed)
    if dup:
        # the batch hits the NaN case: the criterion's cotangent on the
        # predictions is NaN in the log-q lanes of the equal pair
        m = copy.deepcopy(tmodel).train()
        with torch.no_grad():
            out = m(torch.from_numpy(x))
        out.requires_grad_(True)
        copy.deepcopy(tcrit)(out, torch.from_numpy(y)).backward()
        assert torch.isnan(out.grad[:, T:T + 2, 3:]).all()
    step = _jax_step(gps)[3]
    tstep = make_train_step(tmodel, tcrit, topt)
    jl, tl = [], []
    for _ in range(4):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y),
                           jax.random.PRNGKey(0))
        jl.append(float(loss))
        tl.append(float(tstep(torch.from_numpy(x), torch.from_numpy(y))))
    jl, tl = np.array(jl), np.array(tl)
    print(f"{case}: port {tl}, jax {jl}, rel {np.abs(tl - jl) / np.abs(jl)}")
    npt.assert_allclose(tl[0], jl[0], rtol=1e-5)
    npt.assert_allclose(tl[:2], jl[:2], rtol=1e-4)
    npt.assert_allclose(tl, jl, rtol=1e-3)
    for k in NAMES:
        got = getattr(tcrit, k).item()
        if gps and k == "srq":
            # R5: JAX's weight decay moves the unused srq; upstream and the
            # port leave it
            assert got == -3.0
            assert float(state.params["criterion"][k]) != -3.0
        else:
            npt.assert_allclose(got, float(state.params["criterion"][k]),
                                atol=1e-5, err_msg=k)
    variables = state_dict_to_variables(tmodel.posenet.state_dict())
    for name, want, got in _tree_pairs(
            jax.tree.map(np.asarray, state.batch_stats["posenet"]),
            variables["batch_stats"]):
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name
    for name, want, got in _tree_pairs(
            jax.tree.map(np.asarray, state.params["model"]["posenet"]),
            variables["params"]):
        assert np.isfinite(got).all(), name
        assert np.abs(got - want).max() <= 2 * cfg.lr * 4, name


# --------------------------------------------------------------------------
# the Trainer and the CLI

TRAINER_CFG = dict(n_epochs=2, batch_size=4, do_val=False, seed=7,
                   snapshot=10, val_freq=1, print_freq=1, opt="adam",
                   lr=1e-6, num_workers=1)


def _online(pkg, gps=False):
    """MFOnline over synthetic splits as the builders wire them."""
    if pkg == "jax":
        from geomapnet_tpu.data import MF as mf, MFOnline as online, \
            SyntheticScene as scene
        from geomapnet_tpu.data import vo_np
    else:
        from geomapnet_tpu_torch.data import MF as mf, MFOnline as online
        from geomapnet_tpu_torch.data import vo_np
        from geomapnet_tpu_torch.data.synthetic import SyntheticScene as scene
    kw = dict(steps=T, skip=2, seed=7)
    size = dict(n_frames=16, height=32, width=48)
    unlab = scene(train=False, real=True, **size)
    gt = None if gps else scene(train=False, skip_images=True, **size)
    return online(mf(scene(**size), **kw),
                  mf(unlab, include_vos=not gps, real=not gps,
                     no_duplicates=True, gt_dataset=gt,
                     vo_func=vo_np.vos_logq_np, **kw), gps_mode=gps)


def _mapnet_checkpoint(variables, logdir: Path) -> Path:
    """A MapNet (no guard) checkpoint of ``variables`` in the port's
    layout, as ``cli.train --model mapnet`` writes it."""
    model = MapNet(PoseNet(resnet18(), feat_dim=FEAT, droprate=0.0))
    model.posenet.load_state_dict(variables_to_state_dict(variables))
    crit = MapNetOnlineCriterion()
    logdir.mkdir(parents=True, exist_ok=True)
    return save_checkpoint(logdir, 300, model, crit,
                           make_optimizer("adam", 1e-4, model, crit))


def _port_online_trainer(tmp_path, name, ckpt=None, seed=1, **kw):
    torch.manual_seed(seed)       # a fresh init, replaced by the checkpoint
    model = MapNet(PoseNet(resnet18(), feat_dim=FEAT, droprate=0.0,
                           filter_nans=True))
    return Trainer(
        model, MapNetOnlineCriterion(saq=-3.0, srq=-3.0, learn_beta=True,
                                     learn_gamma=True),
        PortConfig(**TRAINER_CFG), name, _online("port"), None,
        checkpoint=None if ckpt is None else str(ckpt),
        logdir_root=str(tmp_path), device="cpu", **kw)


@pytest.mark.parametrize("device_cache", [False, True])
def test_trainer_matches_jax_trainer(tmp_path, device_cache):
    jtrainer = JaxTrainer(
        JaxMapNet(posenet=JaxPoseNet(feature_extractor=jax_resnet18(),
                                     feat_dim=FEAT, droprate=0.0,
                                     filter_nans=True)),
        JaxOnline(saq=-3.0, srq=-3.0, learn_beta=True, learn_gamma=True),
        ExperimentConfig(**TRAINER_CFG), "jax", _online("jax"), None,
        logdir_root=str(tmp_path), use_mesh=False, device_cache=device_cache)
    variables = {
        "params": jax.tree.map(np.asarray,
                               jtrainer.state.params["model"]["posenet"]),
        "batch_stats": jax.tree.map(np.asarray,
                                    jtrainer.state.batch_stats["posenet"]),
    }
    ckpt = _mapnet_checkpoint(variables, tmp_path / "mapnet")
    trainer = _port_online_trainer(tmp_path, "port", ckpt,
                                   device_cache=device_cache)
    assert trainer.val_loader is None and trainer.start_epoch == 0
    if device_cache:
        # both splits in one stack, the unlabeled frames after the train's
        np.testing.assert_array_equal(trainer._train_frames.numpy(),
                                      np.asarray(jtrainer._train_frames))
        assert trainer._train_frames.shape[0] == 32
    jtrainer.train_val()
    trainer.train_val()
    ours = _records(tmp_path / "port", "train")
    theirs = _records(tmp_path / "jax", "train")
    assert len(ours) == len(theirs) == 2 * len(trainer.train_loader)
    assert [r["step"] for r in ours] == [r["step"] for r in theirs]
    npt.assert_allclose([r["loss"] for r in ours],
                        [r["loss"] for r in theirs], rtol=1e-4)
    for k in ("lr",) + NAMES:
        npt.assert_allclose([r[k] for r in ours], [r[k] for r in theirs],
                            atol=1e-6, err_msg=k)
    # every forwarded frame counts: 2T per item
    st = trainer.epoch_stats[0]
    assert st["images"] == st["steps"] * TRAINER_CFG["batch_size"] * 2 * T


def test_ingest_overlap_matches_serial_cache(tmp_path):
    serial = _port_online_trainer(tmp_path, "serial", device_cache=True)
    warm = _port_online_trainer(tmp_path, "warm", device_cache=True,
                                ingest_overlap=True)
    assert len(warm._recorders) == 2 and warm._train_frames is None
    serial.train_val()
    warm.train_val()
    assert torch.equal(warm._train_frames, serial._train_frames)
    for a, b in zip(serial.model.state_dict().values(),
                    warm.model.state_dict().values(), strict=True):
        assert torch.equal(a, b)
    la = [r["loss"] for r in _records(tmp_path / "serial", "train")]
    lb = [r["loss"] for r in _records(tmp_path / "warm", "train")]
    assert la == lb and len(la) == 2 * len(serial.train_loader)


def _ini(tmp_path: Path, src: Path, name: str, **values) -> Path:
    text = src.read_text()
    for key, value in values.items():
        text = "\n".join(f"{key} = {value}" if ln.startswith(f"{key} =")
                         else ln for ln in text.split("\n"))
    path = tmp_path / f"{name}.ini"
    path.write_text(text)
    return path


def test_cli_mapnet_then_mapnetpp_then_pgo_eval(tmp_path):
    """``cli.train --model mapnet++`` from a MapNet checkpoint (the layout
    ``cli.train --model mapnet`` writes) with configs/synth_mapnetpp.ini
    and with its GPS variant, then ``cli.eval --model mapnet++
    --pose_graph`` on the fine-tuned weights."""
    mapnet_ini = _ini(tmp_path, REPO / "configs" / "mapnet.ini", "mapnet",
                      batch_size=16, num_workers=1)
    # configs/synth_mapnetpp.ini for one epoch, and its GPS variant
    vo_ini = _ini(tmp_path, REPO / "configs" / "synth_mapnetpp.ini",
                  "synth_mapnetpp", n_epochs=1)
    gps_ini = _ini(tmp_path, REPO / "configs" / "synth_mapnetpp.ini",
                   "synth_gps", vo_lib="gps", n_epochs=1)
    base = ["--dataset", "synth", "--trunk", "resnet18", "--device", "cpu",
            "--learn_beta", "--learn_gamma"]
    torch.manual_seed(0)
    mapnet, _ = builders.build_model("mapnet", PortConfig(), trunk="resnet18")
    crit = MapNetOnlineCriterion()
    ckpt = save_checkpoint(tmp_path, 300, mapnet, crit,
                           make_optimizer("adam", 1e-4, mapnet, crit))
    cwd = Path.cwd()
    os.chdir(tmp_path)
    try:
        runs = {}
        for name, ini in (("vo", vo_ini), ("gps", gps_ini)):
            runs[name] = cli_train.main(base + [
                "--model", "mapnet++", "--config_file", str(ini),
                "--checkpoint", str(ckpt)])
        vo, gps = runs["vo"], runs["gps"]
        assert isinstance(vo.train_criterion, MapNetOnlineCriterion)
        assert not vo.train_criterion.gps_mode and gps.train_criterion.gps_mode
        assert vo.model.posenet.filter_nans and vo.val_loader is None
        for run in (vo, gps):
            losses = [r["loss"] for r in _records(run.logdir, "train")]
            assert losses and np.isfinite(losses).all()
        assert gps.train_criterion.srq.item() == -3.0
        # the fine-tuning started from the MapNet weights
        first = torch.load(vo.logdir / "epoch_000.pth.tar",
                           weights_only=False)["model_state_dict"]
        assert all(torch.equal(v, first[k])
                   for k, v in mapnet.state_dict().items())
        final = vo.logdir / "epoch_001.pth.tar"
        res = cli_eval.main([
            "--dataset", "synth", "--model", "mapnet++", "--trunk",
            "resnet18", "--device", "cpu", "--val", "--pose_graph",
            "--config_file", str(mapnet_ini), "--weights", str(final),
            "--batch_size", "4"])
    finally:
        os.chdir(cwd)
    assert np.isfinite([res[k] for k in ("median_t", "mean_t", "median_q",
                                         "mean_q")]).all()
