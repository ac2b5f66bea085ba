"""The port's Trainer and train CLI.

- The port's :class:`Trainer` against the JAX package's over 2 epochs on
  the synthetic MapNet (``MF(SyntheticScene(32, 32x48))``, ResNet-18,
  feat_dim 32, batch 8, Adam with weight decay, no dropout), from the same
  initial variables: the same batches (the copied Loader's seeded shuffle),
  every per-step loss within 1e-4 relative, the validation losses too.
  lr is 1e-6: at random init, with BatchNorm over 24 smooth synthetic
  frames, float32 noise grows past 1e-4 within 8 steps at 1e-5
  (tests/test_torch_train_step.py).
- ``cli.train.main --device cpu`` on ``synth``: ``log.txt``,
  ``metrics.jsonl`` (the JAX Trainer's keys) and ``epoch_*.pth.tar``;
  ``--auto_resume`` restarts at the saved epoch with the weights, loss
  weights and update count restored bit for bit; the refused flags (the
  device-cache flags run: tests/test_torch_train_cache.py; ``--model
  mapnet++`` and ``--camera_models_dir`` too: tests/test_torch_mapnetpp.py,
  tests/test_torch_robotcar_rgb.py).
- ``cli.eval --weights`` on a port checkpoint and on an upstream
  ``.pth.tar``; ``load_weights`` of trunk-only imports.
"""

import json
import os
from pathlib import Path

import jax
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
from geomapnet_tpu.models.torch_import import (
    convert_state_dict as jax_convert_state_dict,
)
from geomapnet_tpu.models.torchvision_layout import (
    resnet34_state_shapes,
    synthetic_posenet_state_dict,
)
from geomapnet_tpu.train.loop import Trainer as JaxTrainer
from geomapnet_tpu_torch.cli import eval as cli_eval
from geomapnet_tpu_torch.cli import train as cli_train
from geomapnet_tpu_torch.cli.builders import build_model
from geomapnet_tpu_torch.cli.config import ExperimentConfig as PortConfig
from geomapnet_tpu_torch.data.composite import MF
from geomapnet_tpu_torch.data.synthetic import SyntheticScene
from geomapnet_tpu_torch.losses.criterion import MapNetCriterion
from geomapnet_tpu_torch.models.flax_import import (
    state_dict_to_variables,
    variables_to_state_dict,
)
from geomapnet_tpu_torch.models.posenet import MapNet, PoseNet
from geomapnet_tpu_torch.models.resnet import resnet18
from geomapnet_tpu_torch.train.checkpoint import load_weights
from geomapnet_tpu_torch.train.loop import Trainer
# an autouse fixture: one torch thread while this module runs
from test_torch_train_step import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
CFG = dict(n_epochs=2, batch_size=8, do_val=True, seed=7, snapshot=10,
           val_freq=1, print_freq=1, opt="adam", lr=1e-6, num_workers=1)


def _datasets(mf, scene):
    return (mf(scene(n_frames=32, height=32, width=48), steps=3, skip=2),
            mf(scene(n_frames=16, height=32, width=48, train=False),
               steps=3, skip=2))


def _records(logdir: Path, kind: str) -> list:
    with open(logdir / "metrics.jsonl") as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def test_trainer_matches_jax_trainer(tmp_path):
    jtrainer = JaxTrainer(
        JaxMapNet(posenet=JaxPoseNet(feature_extractor=jax_resnet18(),
                                     feat_dim=32, droprate=0.0)),
        JaxMapNetCriterion(saq=-3.0, srq=-3.0, learn_beta=True,
                           learn_gamma=True),
        ExperimentConfig(**CFG), "jax", *_datasets(JaxMF, JaxSyntheticScene),
        logdir_root=str(tmp_path), use_mesh=False)
    variables = {
        "params": jax.tree.map(np.asarray,
                               jtrainer.state.params["model"]["posenet"]),
        "batch_stats": jax.tree.map(np.asarray,
                                    jtrainer.state.batch_stats["posenet"]),
    }
    model = MapNet(PoseNet(resnet18(), feat_dim=32, droprate=0.0))
    model.posenet.load_state_dict(variables_to_state_dict(variables))
    trainer = Trainer(
        model, MapNetCriterion(saq=-3.0, srq=-3.0, learn_beta=True,
                               learn_gamma=True),
        PortConfig(**CFG), "port", *_datasets(MF, SyntheticScene),
        logdir_root=str(tmp_path), device="cpu")
    jtrainer.train_val()
    trainer.train_val()

    for kind in ("train", "val"):
        ours = _records(tmp_path / "port", kind)
        theirs = _records(tmp_path / "jax", kind)
        assert len(ours) == len(theirs) == (8 if kind == "train" else 2)
        assert [r["step"] for r in ours] == [r["step"] for r in theirs]
        npt.assert_allclose([r["loss"] for r in ours],
                            [r["loss"] for r in theirs], rtol=1e-4)
        if kind == "train":
            # the JAX Trainer's record keys, the same learning rates, the
            # learnable loss weights on the same path
            assert ours[0].keys() == theirs[0].keys()
            for k in ("lr", "sax", "saq", "srx", "srq"):
                npt.assert_allclose([r[k] for r in ours],
                                    [r[k] for r in theirs], atol=1e-6,
                                    err_msg=k)
    bn = trainer.model.posenet.feature_extractor.layer4_1.bn2.running_var
    want = np.asarray(jtrainer.state.batch_stats["posenet"][
        "feature_extractor"]["layer4_1"]["bn2"]["var"])
    npt.assert_allclose(bn.numpy(), want, atol=1e-4 * np.abs(want).max())
    assert (tmp_path / "port" / "epoch_000.pth.tar").exists()
    assert (tmp_path / "port" / "epoch_002.pth.tar").exists()


def _synth_ini(tmp_path: Path, n_epochs: int, name: str = "tiny") -> Path:
    text = (REPO / "configs" / "mapnet.ini").read_text()
    for old, new in (("n_epochs = 300", f"n_epochs = {n_epochs}"),
                     ("snapshot = 50", "snapshot = 1"),
                     ("val_freq = 50", "val_freq = 1"),
                     ("print_freq = 20", "print_freq = 2"),
                     ("batch_size = 20", "batch_size = 16"),
                     ("num_workers = 5", "num_workers = 2")):
        assert old in text
        text = text.replace(old, new)
    path = tmp_path / f"{name}.ini"
    path.write_text(text)
    return path


SYNTH = ["--dataset", "synth", "--model", "mapnet", "--trunk", "resnet18",
         "--device", "cpu", "--learn_beta", "--learn_gamma"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2-epoch ``cli.train`` run on the synthetic scene (the Trainer,
    its logdir and working directory)."""
    work = tmp_path_factory.mktemp("train")
    ini = _synth_ini(work, 2)
    cwd = Path.cwd()
    try:
        os.chdir(work)
        trainer = cli_train.main(SYNTH + ["--config_file", str(ini)])
    finally:
        os.chdir(cwd)
    return trainer, work / trainer.logdir, work, ini


def test_cli_writes_logs_metrics_and_checkpoints(trained):
    trainer, logdir, _, _ = trained
    assert logdir.name == "synth_synth_mapnet_tiny_learn_beta_learn_gamma"
    assert sorted(p.name for p in logdir.glob("epoch_*")) == [
        f"epoch_{e:03d}.pth.tar" for e in range(3)]
    log = (logdir / "log.txt").read_text()
    assert "Epoch 2 checkpoint saved" in log and "val_loss" in log
    train = _records(logdir, "train")
    assert {"kind", "loss", "lr", "data_time", "batch_time", "sax", "saq",
            "srx", "srq", "step", "epoch", "batch", "t"} == set(train[0])
    assert all(np.isfinite(r["loss"]) for r in train)
    assert len(_records(logdir, "val")) == 2
    ckpt = torch.load(logdir / "epoch_002.pth.tar", weights_only=False)
    assert set(ckpt) == {"epoch", "step", "model_state_dict",
                         "optim_state_dict", "criterion_state_dict"}
    assert ckpt["epoch"] == 2 and ckpt["step"] == trainer.optimizer.count
    # dropout (0.5 in configs/mapnet.ini) ran: the train loss is not the
    # eval-mode loss of the same weights
    assert trainer.model.posenet.droprate == 0.5


def test_auto_resume_restores_bit_for_bit(trained):
    trainer, logdir, work, _ = trained
    cwd = Path.cwd()
    try:
        os.chdir(work)
        ini3 = _synth_ini(work, 3, name="tiny")   # same experiment name
        # after a restored checkpoint --pretrained_npz is ignored (the file
        # is never opened)
        resumed = cli_train.main(SYNTH + ["--config_file", str(ini3),
                                          "--auto_resume", "--pretrained_npz",
                                          str(work / "absent.npz")])
    finally:
        os.chdir(cwd)
    assert resumed.start_epoch == 2
    saved = torch.load(logdir / "epoch_002.pth.tar", weights_only=False)
    # one more epoch ran from the restored state
    assert (logdir / "epoch_003.pth.tar").exists()
    assert resumed.optimizer.count == saved["step"] + len(
        resumed.train_loader)
    # restore alone, bit for bit
    model = MapNet(PoseNet(resnet18(), droprate=0.5))
    crit = MapNetCriterion(learn_beta=True, learn_gamma=True)
    again = Trainer(model, crit, resumed.config, "again",
                    *resumed_datasets(), logdir_root=str(work),
                    device="cpu", checkpoint=str(logdir / "epoch_002.pth.tar"),
                    resume_optim=True)
    again.tee.uninstall()
    assert again.start_epoch == 2 and again.optimizer.count == saved["step"]
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, saved["model_state_dict"][k]), k
    for k, v in crit.state_dict().items():
        assert torch.equal(v, saved["criterion_state_dict"][k]), k
    state = again.optimizer.optimizer.state_dict()["state"]
    want = saved["optim_state_dict"]["optimizer"]["state"]
    assert state.keys() == want.keys()
    for i in state:
        for k in state[i]:
            assert torch.equal(state[i][k], want[i][k]), (i, k)


def resumed_datasets():
    return (MF(SyntheticScene(n_frames=16), steps=3, skip=10),
            MF(SyntheticScene(n_frames=16, train=False), steps=3, skip=10))


@pytest.mark.parametrize("extra,message", [
    (["--device_cache", "shard"], "item 17"),
    (["--native_loader", "--distributed"], "item 17"),
    (["--distributed"], "item 17"),
    (["--tensorboard"], "item 18"),
])
def test_cli_refuses_unported_flags(tmp_path, capsys, extra, message):
    ini = _synth_ini(tmp_path, 1)
    with pytest.raises(SystemExit) as exc:
        cli_train.main(SYNTH + ["--config_file", str(ini)] + extra)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and message in err


def test_cli_refuses_visdom_and_needs_a_card(tmp_path, capsys, monkeypatch):
    ini = _synth_ini(tmp_path, 1)
    vis = tmp_path / "vis.ini"
    vis.write_text(ini.read_text().replace("visdom = no", "visdom = yes"))
    with pytest.raises(SystemExit):
        cli_train.main(SYNTH + ["--config_file", str(vis)])
    assert "item 18" in capsys.readouterr().err
    # without --device the run goes to the card, and fails without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in SYNTH if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_train.main(argv + ["--config_file", str(ini)])


def test_eval_on_port_checkpoint(trained):
    """``cli.eval --weights epoch_002.pth.tar`` loads the trained weights
    (BatchNorm statistics included) and gives finite errors."""
    trainer, logdir, _, ini = trained
    res = cli_eval.main(["--dataset", "synth", "--model", "mapnet",
                         "--trunk", "resnet18", "--device", "cpu",
                         "--config_file", str(ini), "--val",
                         "--batch_size", "8",
                         "--weights", str(logdir / "epoch_002.pth.tar")])
    assert np.isfinite([res["median_t"], res["median_q"]]).all()
    model, _ = build_model("mapnet", PortConfig(), trunk="resnet18")
    assert load_weights(logdir / "epoch_002.pth.tar", model) == "port"
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, trainer.model.state_dict()[k],
                                   rtol=0, atol=0)


def test_eval_on_upstream_checkpoint(tmp_path):
    """An upstream MapNet ``.pth.tar`` (``mapnet.``-prefixed keys) loads as
    JAX's ``convert_state_dict`` maps it, and evaluates."""
    sd = synthetic_posenet_state_dict(feat_dim=2048)
    path = tmp_path / "upstream.pth.tar"
    torch.save({"epoch": 3, "model_state_dict": {
        f"mapnet.{k}": v for k, v in sd.items()}}, path)
    model, _ = build_model("mapnet", PortConfig(), trunk="resnet34")
    assert load_weights(path, model) == "torch"
    want = variables_to_state_dict(jax_convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}))
    got = model.posenet.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    ini = _synth_ini(tmp_path, 1)
    res = cli_eval.main(["--dataset", "synth", "--model", "mapnet",
                         "--trunk", "resnet34", "--device", "cpu",
                         "--config_file", str(ini), "--val",
                         "--batch_size", "16", "--weights", str(path)])
    assert np.isfinite([res["median_t"], res["median_q"]]).all()


def test_trunk_only_imports_keep_the_heads(tmp_path):
    """A torchvision trunk state dict (its 1000-way ``fc`` dropped) and a
    trunk-only Flax ``.npz`` replace the trunk and leave the heads as they
    were (upstream's pretrained-trunk + fresh-heads start)."""
    from geomapnet_tpu.models.torch_import import save_npz

    rng = np.random.RandomState(3)
    trunk = {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
             for k, s in resnet34_state_shapes(include_fc=True).items()
             if not k.endswith("num_batches_tracked")}
    model = PoseNet(feat_dim=64)
    heads = {k: v.clone() for k, v in model.state_dict().items()
             if k.startswith("fc_")}
    path = tmp_path / "resnet34.pth"
    torch.save(trunk, path)
    assert load_weights(path, model) == "torch"
    got = model.state_dict()
    assert torch.equal(got["feature_extractor.layer3_2.conv1.weight"],
                       trunk["layer3.2.conv1.weight"])
    assert torch.equal(got["feature_extractor.bn1.running_var"],
                       trunk["bn1.running_var"])
    for k, v in heads.items():
        assert torch.equal(got[k], v), k

    other = PoseNet(feat_dim=64)
    variables = state_dict_to_variables(other.state_dict())
    npz = tmp_path / "trunk.npz"
    save_npz(str(npz), {c: {"feature_extractor": t["feature_extractor"]}
                        for c, t in variables.items()})
    assert load_weights(npz, model) == "npz"
    got = model.state_dict()
    for k, v in other.state_dict().items():
        if k.startswith("feature_extractor.") and "num_batches" not in k:
            assert torch.equal(got[k], v), k
    for k, v in heads.items():
        assert torch.equal(got[k], v), k


def test_debug_nans_stops_on_a_nan(tmp_path):
    """``debug_nans``: a NaN target makes the anomaly-checked backward (or
    the finite-loss check at the print point) raise instead of training
    on."""
    class NanPoses:
        def __init__(self, ds):
            self.ds = ds

        def __len__(self):
            return len(self.ds)

        def __getitem__(self, i):
            img, pose = self.ds[i]
            return img, np.full_like(pose, np.nan)

    train, val = _datasets(MF, SyntheticScene)
    trainer = Trainer(
        MapNet(PoseNet(resnet18(), feat_dim=32, droprate=0.0)),
        MapNetCriterion(), PortConfig(**dict(CFG, n_epochs=1)), "nan",
        NanPoses(train), None, logdir_root=str(tmp_path), device="cpu",
        debug_nans=True)
    with pytest.raises((RuntimeError, FloatingPointError)):
        trainer.train_val()


def test_cli_pretrained_npz_merges_a_trunk(tmp_path, monkeypatch):
    """``--pretrained_npz`` with a trunk-only Flax ``.npz``: the trunk takes
    its values, the heads keep their init (0 epochs: the import alone)."""
    from geomapnet_tpu.models.torch_import import save_npz

    donor, _ = build_model("mapnet", PortConfig(), trunk="resnet18")
    variables = state_dict_to_variables(donor.posenet.state_dict())
    npz = tmp_path / "trunk.npz"
    save_npz(str(npz), {c: {"feature_extractor": t["feature_extractor"]}
                        for c, t in variables.items()})
    monkeypatch.chdir(tmp_path)
    trainer = cli_train.main(SYNTH + ["--config_file",
                                      str(_synth_ini(tmp_path, 0)),
                                      "--pretrained_npz", str(npz)])
    got = trainer.model.posenet.state_dict()
    want = donor.posenet.state_dict()
    for k, v in want.items():
        if "num_batches" in k or k.startswith("fc_") and k.endswith("bias"):
            continue    # both heads' biases start at zero
        same = torch.equal(got[k], v)
        assert same == k.startswith("feature_extractor."), k
