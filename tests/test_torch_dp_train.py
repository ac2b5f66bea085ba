"""Data-parallel training on two gloo ranks on the CPU, against the JAX
package and against the port's own one-rank step.

The train step (ResNet-18, feat_dim 32, a 4x3x32x48 float32 global batch,
4 Adam steps at lr 1e-5 from JAX's initial variables): rank ``r`` runs its
rows ``microbatch_rows(r, 2, 4, A)`` of the global batch, with BatchNorm
synced over both ranks and the gradient all-reduced.

- Against JAX's ``shard_step`` over a 2-device mesh fed the global batch,
  for ``accum_steps`` 1 and 2, with the dropout keep-masks injected (each
  rank its rows of the global microbatch's mask): the bounds of
  tests/test_torch_train_step.py (step-1 loss within 1e-5 relative, losses
  within 1e-4 relative, BatchNorm statistics within 1e-4 of each tensor's
  max-abs, criterion weights within 1e-5, parameters within 2 lr N).
- Against the port's one-rank step on the same global batch, with the
  hashed dropout left on (the ranks hash global element indices, so they
  draw the one-rank step's masks), ``accum_steps`` 2: the same bounds.
- Both ranks end with bit-equal parameters.

The Trainer (the synthetic MapNet of tests/test_torch_trainer.py, batch 8,
2 epochs, lr 1e-6): two ranks of 4 rows each, from the loader, from
``device_cache="shard"`` with two steps per launch, and from the
replicated cache with ``ingest_overlap`` (each rank stages its range of
the frames; the finalize all-gathers them), against the JAX
Trainer on one device: every train and validation loss within 1e-4
relative (the global batches hold the same samples), BatchNorm statistics
within 1e-4 of their max-abs. Rank 1 starts from other weights and
``replicated`` gives it rank 0's. Only rank 0 writes ``log.txt`` and
``metrics.jsonl``; both ranks resume from the shared logdir's checkpoint.

As in the one-rank step tests, each seed is one whose trajectory stays
10x inside its bounds (BatchNorm over a few frames at random init is
chaotic, tests/test_torch_train_step.py).
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from geomapnet_tpu.cli.config import ExperimentConfig
from geomapnet_tpu.data import MF as JaxMF
from geomapnet_tpu.data import SyntheticScene as JaxSyntheticScene
from geomapnet_tpu.losses import MapNetCriterion as JaxMapNetCriterion
from geomapnet_tpu.models import MapNet as JaxMapNet
from geomapnet_tpu.models import PoseNet as JaxPoseNet
from geomapnet_tpu.models import resnet18 as jax_resnet18
from geomapnet_tpu.parallel import make_mesh as jax_make_mesh
from geomapnet_tpu.parallel import shard_step as jax_shard_step
from geomapnet_tpu.train import make_train_step as jax_make_train_step
from geomapnet_tpu.train.loop import Trainer as JaxTrainer
from geomapnet_tpu_torch.models.flax_import import (
    state_dict_to_variables,
    variables_to_state_dict,
)
from geomapnet_tpu_torch.train.optim import make_optimizer
from geomapnet_tpu_torch.train.state import make_train_step
from dp_ranks import run_group
# an autouse fixture: one torch thread while this module runs
from test_torch_train_step import (  # noqa: F401
    FEAT,
    N_STEPS,
    P,
    Cfg,
    _initial_variables,
    _interceptor,
    _jax_tx,
    _models,
    _tree_pairs,
    one_torch_thread,
)
from test_torch_trainer import CFG, _datasets, _records

WORLD = 2
# each case: its configuration (accum_steps, masks, seed) and reference
CASES = {
    "jax_accum1": (Cfg(dropout=True, seed=2), "jax"),
    "jax_accum2": (Cfg(accum=2, dropout=True, seed=2), "jax"),
    "hashed_accum2": (Cfg(accum=2, dropout=True, seed=2), "port"),
}


def _global_batch(seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(4, 3, 32, 48, 3).astype(np.float32)
    y = (rs.randn(4, 3, 6) * 0.1).astype(np.float32)
    return x, y


def _global_mask(cfg):
    """The keep-mask of one global microbatch's frames, (rows, FEAT)."""
    rows = 4 * 3 // cfg.accum
    return np.random.RandomState(cfg.seed + 100).rand(rows, FEAT) >= P


def _jax_run(cfg):
    jmodel, jcrit, state, _, _ = _models(cfg)
    x, y = _global_batch(cfg.seed)
    mesh = jax_make_mesh(jax.devices()[:WORLD])
    step = jax_shard_step(
        jax_make_train_step(jmodel, jcrit, _jax_tx(cfg),
                            accum_steps=cfg.accum),
        mesh, n_batch_args=2, n_replicated_args=1, donate_state=False)
    losses = []
    with _interceptor(jnp.asarray(_global_mask(cfg))):
        for _ in range(N_STEPS):
            state, loss = step(state, jnp.asarray(x), jnp.asarray(y),
                               jax.random.PRNGKey(0))
            losses.append(float(loss))
    return dict(
        losses=np.array(losses),
        params=jax.tree.map(np.asarray, state.params["model"]["posenet"]),
        stats=jax.tree.map(np.asarray, state.batch_stats["posenet"]),
        crit={k: float(v) for k, v in state.params["criterion"].items()})


def _port_one_rank(cfg):
    _, _, _, tmodel, tcrit = _models(cfg)
    x, y = _global_batch(cfg.seed)
    opt = make_optimizer("adam", cfg.lr, tmodel, tcrit,
                         weight_decay=cfg.weight_decay, steps_per_epoch=1)
    step = make_train_step(tmodel, tcrit, opt, accum_steps=cfg.accum)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y), seed=11))
              for _ in range(N_STEPS)]
    v = state_dict_to_variables(tmodel.posenet.state_dict())
    return dict(losses=np.array(losses), params=v["params"],
                stats=v["batch_stats"],
                crit={k: float(p) for k, p in tcrit.named_parameters()})


@pytest.fixture(scope="module")
def pool():
    """The groups run in threads of the parent, so the ranks compute while
    the parent runs JAX."""
    with ThreadPoolExecutor(2) as ex:
        yield ex


@pytest.fixture(scope="module")
def step_runs(pool):
    cases = []
    for name, (cfg, ref) in CASES.items():
        x, y = _global_batch(cfg.seed)
        cases.append(dict(
            state=variables_to_state_dict(_initial_variables(False,
                                                             cfg.seed)),
            x=x, y=y, accum=cfg.accum, lr=cfg.lr, feat=FEAT, droprate=P,
            weight_decay=cfg.weight_decay, n_steps=N_STEPS, seed=11,
            mask=_global_mask(cfg) if ref == "jax" else None))
    return pool.submit(run_group, "train_step", WORLD, cases=cases)


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_matches_reference(step_runs, name):
    cfg, ref = CASES[name]
    want = _jax_run(cfg) if ref == "jax" else _port_one_rank(cfg)
    ranks = [r[list(CASES).index(name)] for r in step_runs.result()]
    for k, v in ranks[0]["state"].items():   # replicated: bit-equal ranks
        np.testing.assert_array_equal(v, ranks[1]["state"][k], err_msg=k)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    got = ranks[0]
    npt.assert_allclose(got["losses"][0], want["losses"][0], rtol=1e-5)
    npt.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    for k in ("sax", "saq", "srx", "srq"):
        npt.assert_allclose(got["crit"][k], want["crit"][k], atol=1e-5,
                            err_msg=k)
    variables = state_dict_to_variables(
        {k: torch.from_numpy(v) for k, v in got["state"].items()})
    for path, w, g in _tree_pairs(want["stats"], variables["batch_stats"]):
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), path
    for path, w, g in _tree_pairs(want["params"], variables["params"]):
        assert np.abs(g - w).max() <= 2 * cfg.lr * N_STEPS, path
    assert got["count"] == N_STEPS


def _jax_trainer(tmp_path):
    return JaxTrainer(
        JaxMapNet(posenet=JaxPoseNet(feature_extractor=jax_resnet18(),
                                     feat_dim=32, droprate=0.0)),
        JaxMapNetCriterion(saq=-3.0, srq=-3.0, learn_beta=True,
                           learn_gamma=True),
        ExperimentConfig(**CFG), "jax", *_datasets(JaxMF, JaxSyntheticScene),
        logdir_root=str(tmp_path), use_mesh=False)


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory, pool):
    tmp = tmp_path_factory.mktemp("dp_trainer")
    jtrainer = _jax_trainer(tmp)
    init = variables_to_state_dict({
        k: jax.tree.map(np.asarray, v["posenet"]) for k, v in (
            ("params", jtrainer.state.params["model"]),
            ("batch_stats", jtrainer.state.batch_stats))})
    common = dict(state=init, feat=32, n_train=32, n_val=16, cfg=CFG,
                  logdir=str(tmp), only_rank0_init=True)
    runs = [dict(common, name="loader"),
            dict(common, name="shard", resume=True,
                 kwargs=dict(device_cache="shard", steps_per_launch=2)),
            dict(common, name="overlap",
                 kwargs=dict(device_cache=True, ingest_overlap=True))]
    group = pool.submit(run_group, "trainer", WORLD, runs=runs)
    jtrainer.train_val()
    ranks = group.result()
    return tmp, jtrainer, {r["name"]: [res[i] for res in ranks]
                           for i, r in enumerate(runs)}


@pytest.mark.parametrize("name", ["loader", "shard", "overlap"])
def test_trainer_matches_jax_trainer(trainer_runs, name):
    tmp, jtrainer, runs = trainer_runs
    ranks = runs[name]
    for kind in ("train", "val"):
        ours = _records(tmp / name, kind)
        theirs = _records(tmp / "jax", kind)
        if name == "shard":
            ours = ours[:len(theirs)]     # before the resumed epoch
        assert len(ours) == len(theirs) == (8 if kind == "train" else 2)
        assert [r["step"] for r in ours] == [r["step"] for r in theirs]
        npt.assert_allclose([r["loss"] for r in ours],
                            [r["loss"] for r in theirs], rtol=1e-4)
    for k, v in ranks[0]["state"].items():
        np.testing.assert_array_equal(v, ranks[1]["state"][k], err_msg=k)
    stats = state_dict_to_variables(
        {k: torch.from_numpy(v) for k, v in ranks[0]["state"].items()}
    )["batch_stats"]
    for path, w, g in _tree_pairs(
            jax.tree.map(np.asarray, jtrainer.state.batch_stats["posenet"]),
            stats):
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), path
    log = (tmp / name / "log.txt").read_text()
    assert "Process 0/2 (gloo), local batch 4" in log
    assert "Process 1/2" not in log           # rank 0 writes the logs
    assert (tmp / name / "epoch_000.pth.tar").exists()
    assert (tmp / name / "epoch_002.pth.tar").exists()
    assert all(r["count"] == 8 for r in ranks)


def test_trainer_resumes_on_every_rank(trainer_runs):
    tmp, _, runs = trainer_runs
    ranks = runs["shard"]
    for r in ranks:
        assert (r["resumed_at"], r["resumed_count"], r["final_count"]) == \
            (2, 8, 12)
        # the K=2 launches ran (eagerly on the CPU): 2 per epoch
        assert r["per_replay"]["train"]["replays"] == 0
    for k, v in ranks[0]["final_state"].items():
        np.testing.assert_array_equal(v, ranks[1]["final_state"][k],
                                      err_msg=k)
    records = [json.loads(x) for x in open(tmp / "shard" / "metrics.jsonl")]
    steps = [r["step"] for r in records if r["kind"] == "train"]
    assert steps == list(range(1, 13))        # one writer, no duplicates
    assert (tmp / "shard" / "epoch_003.pth.tar").exists()
