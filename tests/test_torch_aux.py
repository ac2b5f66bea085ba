"""The port's aux modules against the JAX package's, on the CPU.

- ``utils/vis.py``: the figures are written (matplotlib; the numpy
  functions are pinned to JAX's in tests/test_torch_import_isolation.py);
- ``utils/dashboard.py``: tests/test_dashboard.py's four cases on the
  ``metrics.jsonl`` that the port's Trainer wrote (``cli.train
  --tensorboard`` on the synthetic scene);
- TensorBoard: ``MetricsWriter(tensorboard=True)`` writes the scalars
  (tags, steps, values) the JAX writer writes on the same records, the
  Trainer's event file holds its metrics, and without the package the
  writer fails naming it;
- the trajectory figure: ``plot_trajectories`` draws JAX's figure, the eval
  CLI writes it beside the ``.pkl`` and ``_metrics.json``, and without
  matplotlib writes those two and prints that the figure was skipped;
- orbax: a JAX ``save_checkpoint`` directory is refused by every reader
  with the conversion named; converted as the message says, the ``.npz``
  evaluates to JAX's poses.
"""

import json
import os
import shutil
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from geomapnet_tpu.cli import builders as jax_builders
from geomapnet_tpu.cli import eval as jax_eval
from geomapnet_tpu.cli.config import ExperimentConfig as JaxConfig
from geomapnet_tpu.models import save_npz as jax_save_npz
from geomapnet_tpu.train.checkpoint import restore_checkpoint, \
    save_checkpoint
from geomapnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from geomapnet_tpu.train.state import create_train_state
from geomapnet_tpu.utils import dashboard as jax_dashboard
from geomapnet_tpu.utils import logger as jax_logger
from geomapnet_tpu_torch.cli import builders
from geomapnet_tpu_torch.cli import eval as cli_eval
from geomapnet_tpu_torch.cli import plot_activations
from geomapnet_tpu_torch.cli import train as cli_train
from geomapnet_tpu_torch.cli.config import ExperimentConfig
from geomapnet_tpu_torch.train.checkpoint import load_weights
from geomapnet_tpu_torch.utils import dashboard, logger, vis
from test_torch_train_step import one_torch_thread  # noqa: F401
from test_torch_trainer import SYNTH, _synth_ini

REPO = Path(__file__).resolve().parent.parent


# --- utils/vis.py ----------------------------------------------------------

def test_figures_are_written(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.RandomState(3)
    images = rng.rand(4, 8, 8, 3).astype(np.float32)
    vis.show_batch(images, path=str(tmp_path / "batch.png"))
    vis.show_stereo_batch(images, images[::-1],
                          path=str(tmp_path / "stereo.png"))
    emb = vis.vis_tsne(rng.randn(10, 4), images=rng.rand(10, 8, 8, 3),
                       path=str(tmp_path / "tsne.png"))
    assert emb.shape == (10, 2)
    for name in ("batch", "stereo", "tsne"):
        with Image.open(tmp_path / f"{name}.png") as im:
            assert im.size[0] > 0 and im.size[1] > 0


# --- the Trainer's metrics: dashboard and TensorBoard ----------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of ``cli.train --tensorboard`` on the synthetic scene;
    returns its logdir."""
    pytest.importorskip("tensorboard")
    work = tmp_path_factory.mktemp("aux_train")
    ini = _synth_ini(work, 1)
    cwd = Path.cwd()
    try:
        os.chdir(work)
        trainer = cli_train.main(SYNTH + ["--config_file", str(ini),
                                          "--tensorboard"])
    finally:
        os.chdir(cwd)
    return work / trainer.logdir


def _rows(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def test_dashboard_reads_the_trainers_log_skipping_a_torn_tail(trained,
                                                               tmp_path):
    rows = _rows(trained / "metrics.jsonl")
    assert {r["kind"] for r in rows} == {"train", "val"}
    p = tmp_path / "metrics.jsonl"
    shutil.copy(trained / "metrics.jsonl", p)
    with open(p, "a") as f:
        f.write('{"kind": "train", "step": 99, "loss"')   # mid-write tail
    got = dashboard.read_metrics(p)
    assert got == rows == jax_dashboard.read_metrics(p)


def test_dashboard_thins_per_kind_keeping_ends(trained, tmp_path):
    rows = _rows(trained / "metrics.jsonl")
    train = next(r for r in rows if r["kind"] == "train")
    val = next(r for r in rows if r["kind"] == "val")
    p = tmp_path / "metrics.jsonl"
    with open(p, "w") as f:
        for i in range(500):
            f.write(json.dumps(dict(train, step=i)) + "\n")
        f.write(json.dumps(val) + "\n")
    got = dashboard.read_metrics(p, limit=100)
    assert got == jax_dashboard.read_metrics(p, limit=100)
    kept = [r for r in got if r["kind"] == "train"]
    assert len(kept) <= 100
    assert kept[0]["step"] == 0 and kept[-1]["step"] == 499
    assert sum(r["kind"] == "val" for r in got) == 1
    assert dashboard.read_metrics(tmp_path / "absent.jsonl") == []


def test_dashboard_lists_experiments_in_both_layouts(trained, tmp_path):
    root = tmp_path / "logs"
    shutil.copytree(trained, root / "exp_a")
    shutil.copytree(trained, root / "exp_b")
    found = dashboard.list_experiments(root)
    assert list(found) == ["exp_a", "exp_b"]
    assert found == jax_dashboard.list_experiments(root)
    assert list(dashboard.list_experiments(root / "exp_a")) == ["exp_a"]


def test_dashboard_serves_the_trainers_rows_live(trained, tmp_path):
    root = tmp_path / "logs"
    shutil.copytree(trained, root / "run1")
    mpath = root / "run1" / "metrics.jsonl"
    rows = _rows(mpath)
    srv = dashboard.make_server(root, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        page = urllib.request.urlopen(f"{base}/").read().decode()
        assert "geomapnet_tpu training" in page
        assert "--s1" in page and "Criterion parameters" in page
        data = json.loads(urllib.request.urlopen(f"{base}/data").read())
        assert data["exp"] == "run1" and data["rows"] == rows
        with open(mpath, "a") as f:   # a row the live Trainer appends
            f.write(json.dumps(dict(rows[0], step=10 ** 6)) + "\n")
        data2 = json.loads(
            urllib.request.urlopen(f"{base}/data?exp=run1").read())
        assert data2["rows"][-1]["step"] == 10 ** 6
        assert len(data2["rows"]) == len(rows) + 1
        data3 = json.loads(
            urllib.request.urlopen(f"{base}/data?exp=nope").read())
        assert data3["exp"] == "run1"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/bogus")
        assert e.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def _scalars(logdir: Path) -> dict:
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(str(logdir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_tensorboard_scalars_equal_jax(tmp_path):
    pytest.importorskip("tensorboard")
    records = [dict(kind="train", step=1, epoch=0, loss=0.25, lr=1e-4,
                    sax=0.0, note="text"),
               dict(kind="val", epoch=0, step=4, loss=1.5),
               dict(kind="train", step=5, loss=0.125, t=7.0),
               dict(loss=2.0)]
    for name, mod in (("port", logger), ("jax", jax_logger)):
        w = mod.MetricsWriter(tmp_path / name / "metrics.jsonl",
                              tensorboard=True)
        for r in records:
            w.write(**r)
        w.close()
    got = _scalars(tmp_path / "port" / "tb")
    assert got == _scalars(tmp_path / "jax" / "tb")
    assert got["train/loss"] == [(1, 0.25), (5, 0.125)]
    assert got["val/loss"] == [(4, 1.5)] and got["metrics/loss"] == [(4, 2.0)]


def test_trainer_writes_its_metrics_to_tensorboard(trained):
    rows = _rows(trained / "metrics.jsonl")
    tb = _scalars(trained / "tb")
    for kind in ("train", "val"):
        want = [(r["step"], r["loss"]) for r in rows if r["kind"] == kind]
        got = tb[f"{kind}/loss"]
        assert [s for s, _ in got] == [s for s, _ in want]
        np.testing.assert_allclose([v for _, v in got],
                                   [v for _, v in want], rtol=1e-6)


def test_tensorboard_writer_names_the_missing_package(tmp_path,
                                                      monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="needs the tensorboard package"):
        logger.MetricsWriter(tmp_path / "metrics.jsonl", tensorboard=True)


# --- the trajectory figure --------------------------------------------------

@pytest.mark.parametrize("dataset", ["7Scenes", "RobotCar"])
def test_plot_trajectories_draws_jaxs_figure(tmp_path, dataset):
    pytest.importorskip("matplotlib")
    rng = np.random.RandomState(4)
    pred, targ = rng.randn(30, 7), rng.randn(30, 7)
    cli_eval.plot_trajectories(pred, targ, dataset, tmp_path / "port.png")
    jax_eval.plot_trajectories(pred, targ, dataset, tmp_path / "jax.png")
    with Image.open(tmp_path / "port.png") as a, \
            Image.open(tmp_path / "jax.png") as b:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- orbax checkpoints ------------------------------------------------------

@pytest.fixture(scope="module")
def orbax_dir(tmp_path_factory):
    """A JAX ``save_checkpoint`` directory of a PoseNet (ResNet-18) and the
    state it was made from."""
    tmp = tmp_path_factory.mktemp("orbax")
    config = JaxConfig()
    model, _ = jax_builders.build_model("posenet", config, trunk="resnet18")
    criterion, _ = jax_builders.build_criteria("posenet", config, False,
                                               False)
    state = create_train_state(
        model, criterion, jax_make_optimizer(config.opt, config.lr),
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)))
    return save_checkpoint(tmp / "jax_logs", 0, state), state


def _eval_argv(weights, out):
    return ["--dataset", "synth", "--model", "posenet", "--trunk",
            "resnet18", "--config_file", str(REPO / "configs" /
                                            "posenet.ini"),
            "--val", "--batch_size", "16", "--weights", str(weights),
            "--output_dir", str(out)]


def test_orbax_directory_is_refused_with_the_conversion(orbax_dir, tmp_path,
                                                        capsys):
    path, _ = orbax_dir
    model, _ = builders.build_model("posenet", ExperimentConfig(),
                                    trunk="resnet18")
    with pytest.raises(ValueError, match="restore_checkpoint") as e:
        load_weights(path, model)
    assert "save_npz" in str(e.value) and "orbax" in str(e.value)
    for main, argv in (
            (cli_eval.main, _eval_argv(path, tmp_path) + ["--device",
                                                           "cpu"]),
            (plot_activations.main,
             ["--dataset", "synth", "--model", "posenet", "--config_file",
              str(REPO / "configs" / "posenet.ini"), "--weights", str(path),
              "--output_dir", str(tmp_path), "--device", "cpu"]),
            (cli_train.main, SYNTH + ["--config_file",
                                      str(_synth_ini(tmp_path, 1)),
                                      "--checkpoint", str(path)])):
        with pytest.raises(SystemExit) as exit_:
            main(argv)
        assert exit_.value.code == 2
        err = capsys.readouterr().err
        assert "orbax" in err and "restore_checkpoint" in err, err


def test_converted_orbax_weights_evaluate_to_jaxs_poses(orbax_dir,
                                                        tmp_path, capsys,
                                                        monkeypatch):
    """The conversion the message names, then both eval CLIs on the
    ``.npz``: the poses within 1e-5 (float32 sums in another order, on
    the JAX init's well-conditioned statistics); the port's ``--output_dir``
    holds the ``.pkl``, ``_metrics.json`` and trajectory ``.png`` JAX
    writes, and without matplotlib the first two and the skip line."""
    pytest.importorskip("matplotlib")
    path, template = orbax_dir
    _, state = restore_checkpoint(path, template)
    npz = tmp_path / "w.npz"
    jax_save_npz(str(npz), {"params": state.params["model"],
                            "batch_stats": state.batch_stats})
    want = jax_eval.main(_eval_argv(npz, tmp_path / "jax"))
    got = cli_eval.main(_eval_argv(npz, tmp_path / "port")
                        + ["--device", "cpu"])
    np.testing.assert_array_equal(got["targ_poses"], want["targ_poses"])
    assert np.abs(want["pred_poses"]).max() > 1e-2
    np.testing.assert_allclose(got["pred_poses"], want["pred_poses"],
                               rtol=1e-5, atol=1e-5)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["synth_synth_posenet.pkl", "synth_synth_posenet.png",
                     "synth_synth_posenet_metrics.json"]
    assert "synth_synth_posenet.png saved" in capsys.readouterr().out

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cli_eval.main(_eval_argv(npz, tmp_path / "bare") + ["--device", "cpu"])
    assert "synth_synth_posenet.png skipped: the trajectory plot needs " \
        "matplotlib" in capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "bare").iterdir()) == [
        "synth_synth_posenet.pkl", "synth_synth_posenet_metrics.json"]


def test_load_weights_reads_a_mapnet_rooted_npz(tmp_path):
    """The conversion of a MapNet checkpoint saves MapNet-rooted trees
    (``{"params": {"posenet": ...}}``): ``--weights`` reads them as the
    PoseNet-rooted ones."""
    from test_torch_eval import seeded_npz
    from geomapnet_tpu_torch.models.torch_import import load_npz, save_npz

    flat = tmp_path / "posenet.npz"
    seeded_npz(flat, "mapnet", ExperimentConfig(), "resnet18")
    nested = tmp_path / "mapnet.npz"
    save_npz(str(nested), {k: {"posenet": v}
                           for k, v in load_npz(str(flat)).items()})
    models = []
    for path in (flat, nested):
        model, _ = builders.build_model("mapnet", ExperimentConfig(),
                                        trunk="resnet18")
        assert load_weights(path, model) == "npz"
        models.append(model.state_dict())
    for k, v in models[0].items():
        assert torch.equal(v, models[1][k]), k
