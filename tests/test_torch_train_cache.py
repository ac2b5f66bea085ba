"""Training from the device frame cache, K-step launches, ingest overlap and
remat, against the JAX package and against the port's loader path.

- ``IndexLoader`` batches (frame indices, poses, padding) equal JAX's for
  the same seed, on an MF dataset and on a plain frame dataset, shuffled
  and padded. ``upload_dataset_frames`` and a ``FrameRecorder`` finalized
  after a partial epoch give JAX's stacks exactly.
- The ``device_cache`` Trainer against JAX's over 2 epochs (the synthetic
  MapNet of tests/test_torch_trainer.py, lr 1e-6): every logged loss within
  1e-4 relative, the same steps, learning rates and loss weights within
  1e-6.
- On the CPU, from the same initial weights and with dropout on: a cache
  step equals the loader step bit for bit (loss, parameters, statistics);
  ``ingest_overlap`` trains exactly as the serial cache run (the same
  frames, epoch 2's batches, every loss and weight bit for bit), with its
  own validation split and with one shared with the train split;
  ``steps_per_launch=3`` (K eager steps per launch on the CPU, with an
  epoch tail and validation launches) equals single steps bit for bit.
- ``remat=True``: the loss and every gradient within 1e-6 of the step
  without it, the BatchNorm running statistics and batch counts exactly
  equal (with the default and the bf16 BatchNorm backward).
- A jittering train transform turns the cache off with JAX's message and
  trains from the image loader; the CLI accepts the cache flags.
- The dropout keep-masks of ``step_keep_mask``; the device rate table of
  the optimizer across SGD's schedule boundaries.
"""

import copy
import types

import jax
import numpy as np
import numpy.testing as npt
import pytest
import torch

from geomapnet_tpu.cli.config import ExperimentConfig
from geomapnet_tpu.data import MF as JaxMF
from geomapnet_tpu.data import SyntheticScene as JaxSyntheticScene
from geomapnet_tpu.data import device_cache as jax_dc
from geomapnet_tpu.losses import MapNetCriterion as JaxMapNetCriterion
from geomapnet_tpu.models import MapNet as JaxMapNet
from geomapnet_tpu.models import PoseNet as JaxPoseNet
from geomapnet_tpu.models import resnet18 as jax_resnet18
from geomapnet_tpu.train.loop import Trainer as JaxTrainer
from geomapnet_tpu_torch.cli import train as cli_train
from geomapnet_tpu_torch.cli.config import ExperimentConfig as PortConfig
from geomapnet_tpu_torch.data import device_cache as dc
from geomapnet_tpu_torch.data.composite import MF
from geomapnet_tpu_torch.data.loader import Loader
from geomapnet_tpu_torch.data.synthetic import SyntheticScene
from geomapnet_tpu_torch.losses.criterion import MapNetCriterion
from geomapnet_tpu_torch.models.flax_import import variables_to_state_dict
from geomapnet_tpu_torch.models.posenet import MapNet, PoseNet
from geomapnet_tpu_torch.models.resnet import resnet18
from geomapnet_tpu_torch.train.loop import KLaunch, Trainer
from geomapnet_tpu_torch.train.optim import (
    Optimizer,
    make_lr_schedule,
    make_optimizer,
)
from geomapnet_tpu_torch.train.state import make_train_step, step_keep_mask
# an autouse fixture: one torch thread while this module runs
from test_torch_train_step import one_torch_thread  # noqa: E402,F401
from test_torch_trainer import SYNTH, _records, _synth_ini

CFG = dict(n_epochs=2, batch_size=8, do_val=True, seed=7, snapshot=10,
           val_freq=1, print_freq=1, opt="adam", lr=1e-6, num_workers=1)


def _scenes(mf, scene, shared_val=False, n_val=16):
    train = scene(n_frames=32, height=32, width=48)
    val = train if shared_val else scene(n_frames=n_val, height=32,
                                         width=48, train=False)
    return mf(train, steps=3, skip=2), mf(val, steps=3, skip=2)


def _assert_batches_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs, strict=True):
        assert a[0].dtype == b[0].dtype == np.int32
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("tuples", [True, False])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_index_loader_matches_jax(tuples, shuffle, drop_last):
    port = SyntheticScene(n_frames=23, height=8, width=12)
    jax_ = JaxSyntheticScene(n_frames=23, height=8, width=12)
    if tuples:
        port, jax_ = MF(port, steps=3, skip=2), JaxMF(jax_, steps=3, skip=2)
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=11)
    ours = dc.IndexLoader(port, 5, **kw)
    theirs = jax_dc.IndexLoader(jax_, 5, **kw)
    for _ in range(2):   # two epochs: the shuffle advances alike
        _assert_batches_equal(list(ours), list(theirs))


def test_upload_and_recorder_match_jax():
    """The composite-aware upload, and a recorder finalized after part of
    an epoch's reads, give JAX's stacks; the recorder puts the dataset's
    own methods back."""
    port, jax_ = _scenes(MF, SyntheticScene)[0], \
        _scenes(JaxMF, JaxSyntheticScene)[0]
    want = np.asarray(jax_dc.upload_dataset_frames(jax_))
    got = dc.upload_dataset_frames(port, torch.device("cpu"), chunk=7)
    np.testing.assert_array_equal(got.numpy(), want)
    assert dc.frame_sources(port) == (port.dset,)

    rec = dc.FrameRecorder(port.dset).install()
    jrec = jax_dc.FrameRecorder(jax_.dset).install()
    for ds in (port, jax_):     # part of an epoch: single and batched reads
        for i in (0, 5, 9):
            ds[i]
        ds.fetch_many([12, 13], num_workers=2)
    np.testing.assert_array_equal(rec.seen, jrec.seen)
    assert 1 < rec.seen.sum() < len(rec.seen)
    stack = rec.finalize(num_workers=2)
    np.testing.assert_array_equal(stack, jrec.finalize(num_workers=2))
    np.testing.assert_array_equal(stack, want)
    assert port.dset.get_image.__func__ is SyntheticScene.get_image


def _jax_trainer(tmp_path, **kw):
    return JaxTrainer(
        JaxMapNet(posenet=JaxPoseNet(feature_extractor=jax_resnet18(),
                                     feat_dim=32, droprate=0.0)),
        JaxMapNetCriterion(saq=-3.0, srq=-3.0, learn_beta=True,
                           learn_gamma=True),
        ExperimentConfig(**CFG), "jax", *_scenes(JaxMF, JaxSyntheticScene),
        logdir_root=str(tmp_path), use_mesh=False, **kw)


def test_device_cache_trainer_matches_jax(tmp_path):
    jtrainer = _jax_trainer(tmp_path, device_cache=True)
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
        PortConfig(**CFG), "port", *_scenes(MF, SyntheticScene),
        logdir_root=str(tmp_path), device="cpu", device_cache=True)
    assert isinstance(trainer.train_loader, dc.IndexLoader)
    np.testing.assert_array_equal(trainer._train_frames.numpy(),
                                  np.asarray(jtrainer._train_frames))
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
            for k in ("lr", "sax", "saq", "srx", "srq"):
                npt.assert_allclose([r[k] for r in ours],
                                    [r[k] for r in theirs], atol=1e-6,
                                    err_msg=k)


def _port_trainer(tmp_path, name, n_epochs=2, shared_val=False, lr=1e-4,
                  opt="adam", n_val=16, **kw):
    """A synthetic MapNet Trainer on the CPU, dropout 0.5, the same initial
    weights for every ``name``."""
    torch.manual_seed(0)
    model = MapNet(PoseNet(resnet18(), feat_dim=32, droprate=0.5))
    cfg = PortConfig(**dict(CFG, n_epochs=n_epochs, lr=lr, opt=opt,
                            print_freq=1, dropout=0.5))
    return Trainer(
        model, MapNetCriterion(saq=-3.0, srq=-3.0, learn_beta=True,
                               learn_gamma=True),
        cfg, name, *_scenes(MF, SyntheticScene, shared_val, n_val),
        logdir_root=str(tmp_path), device="cpu", **kw)


def _state(trainer) -> list:
    return ([t.detach().clone() for t in trainer.model.state_dict().values()]
            + [p.detach().clone()
               for p in trainer.train_criterion.parameters()])


def _same_run(tmp_path, a, b) -> None:
    """Bit-identical weights and every logged loss of two finished runs."""
    for x, y in zip(_state(a), _state(b), strict=True):
        assert torch.equal(x, y)
    for kind in ("train", "val"):
        la = [r["loss"] for r in _records(tmp_path / a.experiment, kind)]
        lb = [r["loss"] for r in _records(tmp_path / b.experiment, kind)]
        assert la == lb and la
    assert a.optimizer.count == b.optimizer.count


def test_cache_step_equals_loader_step(tmp_path):
    t_img = _port_trainer(tmp_path, "img")
    t_dc = _port_trainer(tmp_path, "dc", device_cache=True)
    imgs, poses, _ = next(iter(t_img.train_loader))
    idx, poses_dc, _ = next(iter(t_dc.train_loader))
    np.testing.assert_array_equal(poses, poses_dc)
    np.testing.assert_array_equal(t_dc._train_frames.numpy()[idx], imgs)
    loss_img = t_img.train_step(*t_img._put(imgs, poses), seed=7)
    loss_dc = t_dc.train_step(torch.from_numpy(idx),
                              torch.from_numpy(poses_dc), seed=7,
                              frames=t_dc._train_frames)
    assert torch.equal(loss_img, loss_dc)
    for x, y in zip(_state(t_img), _state(t_dc), strict=True):
        assert torch.equal(x, y)
    for t in (t_img, t_dc):
        t.tee.uninstall()


@pytest.mark.parametrize("shared_val", [False, True])
def test_ingest_overlap_matches_serial_cache(tmp_path, shared_val):
    serial = _port_trainer(tmp_path, "serial", 3, shared_val,
                           device_cache=True)
    warm = _port_trainer(tmp_path, "warm", 3, shared_val,
                         device_cache=True, ingest_overlap=True)
    assert warm._warmup_pending and warm._train_frames is None
    assert (warm._val_frames is None) == shared_val
    serial.train_val()
    warm.train_val()
    assert not warm._warmup_pending
    assert torch.equal(warm._train_frames, serial._train_frames)
    if shared_val:
        assert warm._val_frames is warm._train_frames
    # epochs 2 and 3 drew the serial run's batches: every loss equal
    _same_run(tmp_path, serial, warm)


def test_steps_per_launch_matches_single_steps(tmp_path):
    one = _port_trainer(tmp_path, "k1", opt="sgd", n_val=24,
                        device_cache=True)
    k3 = _port_trainer(tmp_path, "k3", opt="sgd", n_val=24,
                       device_cache=True, steps_per_launch=3)
    assert isinstance(k3._train_launch, KLaunch)
    assert len(k3.train_loader) % 3 != 0    # an epoch tail of single steps
    assert len(k3.val_loader) >= 3          # and a validation launch
    one.train_val()
    k3.train_val()
    _same_run(tmp_path, one, k3)
    # the CPU runs the launches eagerly: no graph, no replay
    assert k3.graph_launches() == {
        "train": dict(replays=0, per_replay={}),
        "val": dict(replays=0, per_replay={})}


def test_klaunch_takes_k_batches():
    launch = KLaunch(lambda i, p, f: (f[i.long()].sum() + p.sum()), 2,
                     torch.device("cpu"))
    frames = torch.arange(10.0)
    out = launch(np.array([[1, 2], [3, 4]], np.int32),
                 np.ones((2, 2, 6), np.float32), frames)
    assert out.tolist() == [15.0, 19.0]
    with pytest.raises(ValueError, match="takes 2 batches"):
        launch(np.zeros((3, 2), np.int32), np.zeros((3, 2, 6), np.float32),
               frames)


@pytest.mark.parametrize("bn_bf16_bwd", [False, True])
def test_remat_matches_without(bn_bf16_bwd):
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(2, 3, 32, 48, 3).astype(np.float32))
    y = torch.from_numpy((rs.randn(2, 3, 6) * 0.1).astype(np.float32))
    runs = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = MapNet(PoseNet(resnet18(bn_bf16_bwd=bn_bf16_bwd),
                               feat_dim=32, droprate=0.5))
        crit = MapNetCriterion(saq=-3.0, srq=-3.0, learn_beta=True,
                               learn_gamma=True)
        step = make_train_step(model, crit, make_optimizer(
            "adam", 1e-4, model, crit), remat=remat)
        loss = step(x, y, seed=3)
        runs.append((float(loss), {k: p.grad.clone() for k, p in
                                   model.named_parameters()},
                     copy.deepcopy(model.state_dict())))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert abs(l0 - l1) <= 1e-6 * abs(l0)
    for k, g in g0.items():
        assert (g1[k] - g).abs().max() <= 1e-6 * max(g.abs().max(), 1e-30), k
    for k, v in s0.items():
        if "running" in k or "num_batches" in k:
            assert torch.equal(v, s1[k]), k
    assert s1["posenet.feature_extractor.bn1.num_batches_tracked"] == 1


def test_jitter_turns_the_cache_off(tmp_path, capsys):
    train, val = _scenes(MF, SyntheticScene)
    train.dset.transform = types.SimpleNamespace(color_jitter_strength=0.7)
    torch.manual_seed(0)
    trainer = Trainer(
        MapNet(PoseNet(resnet18(), feat_dim=32, droprate=0.0)),
        MapNetCriterion(), PortConfig(**dict(CFG, n_epochs=1)), "jitter",
        train, val, logdir_root=str(tmp_path), device="cpu",
        device_cache=True, steps_per_launch=2)
    out = capsys.readouterr().out
    # the JAX Trainer's two lines (geomapnet_tpu/train/loop.py:181-189)
    assert ("trainer: device_cache disabled — the train transform jitters "
            "(color_jitter_strength=0.7)") in out
    assert ("trainer: steps_per_launch needs device_cache (the batches must "
            "already live on device); ignoring") in out
    assert not trainer.device_cache and trainer.steps_per_launch == 1
    assert type(trainer.train_loader) is Loader
    trainer.train_val()
    assert trainer.epoch_stats[0]["steps"] == len(trainer.train_loader)
    assert trainer._train_frames is None


def test_cli_runs_the_cache_flags(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    ini = _synth_ini(tmp_path, 1)
    trainer = cli_train.main(SYNTH + [
        "--config_file", str(ini), "--device_cache", "--ingest_overlap",
        "--steps_per_launch", "2", "--bn_bf16_bwd"])
    assert trainer.device_cache and trainer.steps_per_launch == 2
    assert trainer._train_frames is not None    # finalized after epoch 0
    assert all(m.bf16_backward for m in trainer.model.modules()
               if hasattr(m, "bf16_backward"))
    assert (tmp_path / trainer.logdir / "epoch_001.pth.tar").exists()
    assert "device cache finalized from warmup epoch" in \
        capsys.readouterr().out
    plain = cli_train.main(SYNTH + ["--config_file", str(ini),
                                    "--steps_per_launch", "2",
                                    "--suffix", "_k"])
    assert not plain.device_cache and plain.steps_per_launch == 1
    assert "steps_per_launch needs device_cache" in capsys.readouterr().out


def test_step_keep_mask():
    step = torch.tensor(5)
    a = step_keep_mask(7, step, 0, (60, 2048), 0.5)
    assert a.shape == (60, 2048) and a.dtype == torch.bool
    assert abs(a.float().mean().item() - 0.5) < 0.01
    assert torch.equal(a, step_keep_mask(7, torch.tensor(5), 0, (60, 2048),
                                         0.5))
    for other in (step_keep_mask(7, step + 1, 0, (60, 2048), 0.5),
                  step_keep_mask(7, step, 1, (60, 2048), 0.5),
                  step_keep_mask(8, step, 0, (60, 2048), 0.5)):
        assert abs((a == other).float().mean().item() - 0.5) < 0.01
    assert step_keep_mask(7, step, 0, (4, 8), 0.0).all()
    keep = step_keep_mask(7, step, 0, (100_000,), 0.9).float().mean()
    assert abs(keep.item() - 0.1) < 0.005


def test_train_step_draws_its_masks_from_the_count():
    """The step's own dropout draw is ``step_keep_mask`` of the update
    count: injecting that mask gives the same step bit for bit."""
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(2, 3, 32, 48, 3).astype(np.float32))
    y = torch.from_numpy((rs.randn(2, 3, 6) * 0.1).astype(np.float32))
    losses = []
    for inject in (False, True):
        torch.manual_seed(0)
        model = MapNet(PoseNet(resnet18(), feat_dim=32, droprate=0.5))
        crit = MapNetCriterion()
        opt = make_optimizer("adam", 1e-4, model, crit)
        step = make_train_step(model, crit, opt)
        for _ in range(2):
            masks = ([step_keep_mask(3, opt.step_t, 0, (6, 32), 0.5)]
                     if inject else None)
            losses.append(float(step(x, y, seed=3, keep_masks=masks)))
    assert losses[:2] == losses[2:]
    assert int(opt.step_t) == opt.count == 2


def test_device_rate_table_follows_the_schedule():
    """The rate tensor the card's optimizer reads is set from ``step_t``
    through the schedule's table: each update's rate equals the schedule's
    at the count before it, across SGD's boundaries, and a restored count
    restores it."""
    w = torch.nn.Parameter(torch.ones(3))
    sched = make_lr_schedule("sgd", 0.1, 2, 0.1, [1, 2])
    lr_t = torch.tensor(sched(0), dtype=torch.float32)
    opt = Optimizer(torch.optim.SGD([w], lr=lr_t, foreach=False), sched,
                    [w], lr_t=lr_t)
    rates = []
    for _ in range(6):
        w.grad = torch.ones(3)
        opt.step()
        rates.append(float(lr_t))
    want = [float(np.float32(sched(c))) for c in range(6)]
    assert rates == want and len(set(want)) == 3
    state = opt.state_dict()
    assert isinstance(state["optimizer"]["param_groups"][0]["lr"], float)
    opt.load_state_dict(dict(state, count=1))
    assert int(opt.step_t) == 1 and float(lr_t) == want[1]
    assert opt.optimizer.param_groups[0]["lr"] is lr_t
