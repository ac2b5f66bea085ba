"""``--model vidloc`` through the port's CLIs on the synthetic scene, on the
CPU: ``cli.train`` trains an epoch and writes a checkpoint, ``cli.eval``
reads it back and keeps the clips' T axis (its poses are the module's own
forward over the same clips, on the loader path and from the device
cache), ``tools export_model`` makes a streaming artifact whose session
gives the module's poses, and the options that VidLoc cannot take are
refused with their reason."""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from geomapnet_tpu_torch import serving
from geomapnet_tpu_torch.cli import eval as cli_eval
from geomapnet_tpu_torch.cli import tools
from geomapnet_tpu_torch.cli import train as cli_train
from geomapnet_tpu_torch.cli.builders import (
    build_frame_dataset,
    build_model,
    clip_kwargs,
)
from geomapnet_tpu_torch.cli.config import parse_ini
from geomapnet_tpu_torch.data.composite import MF
from geomapnet_tpu_torch.models import VidLoc
from geomapnet_tpu_torch.train.checkpoint import load_weights

REPO = Path(__file__).resolve().parent.parent
COMMON = ["--dataset", "synth", "--model", "vidloc", "--trunk", "resnet18"]


def _ini(tmp_path: Path, steps: int = 3) -> Path:
    """configs/mapnet.ini cut to one epoch of 8 clips of ``steps`` a
    batch."""
    text = (REPO / "configs" / "mapnet.ini").read_text()
    for old, new in (("n_epochs = 300", "n_epochs = 1"),
                     ("steps = 3", f"steps = {steps}"),
                     ("snapshot = 50", "snapshot = 1"),
                     ("val_freq = 50", "val_freq = 1"),
                     ("print_freq = 20", "print_freq = 2"),
                     ("batch_size = 20", "batch_size = 8"),
                     ("num_workers = 5", "num_workers = 1")):
        assert old in text
        text = text.replace(old, new)
    path = tmp_path / "vidloc.ini"
    path.write_text(text)
    return path


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of ``cli.train --model vidloc``: (checkpoint, ini)."""
    work = tmp_path_factory.mktemp("vidloc_train")
    ini = _ini(work)
    cwd = Path.cwd()
    try:
        os.chdir(work)
        trainer = cli_train.main(COMMON + ["--device", "cpu",
                                           "--config_file", str(ini)])
    finally:
        os.chdir(cwd)
    assert isinstance(trainer.model, VidLoc)
    ckpts = sorted((work / trainer.logdir).glob("epoch_*.pth.tar"))
    assert ckpts
    return ckpts[-1], ini


def _module(ckpt: Path, ini: Path) -> VidLoc:
    model, is_clip = build_model("vidloc", parse_ini(str(ini)),
                                 trunk="resnet18")
    assert is_clip
    assert load_weights(ckpt, model) == "port"
    return model.eval()


def _val_clips(ini: Path) -> MF:
    config = parse_ini(str(ini))
    frames = build_frame_dataset("synth", "synth", "", False, config)
    return MF(frames, **clip_kwargs(config))


def test_train_writes_a_vidloc_checkpoint(trained):
    ckpt, _ = trained
    state = torch.load(ckpt, map_location="cpu",
                       weights_only=False)["model_state_dict"]
    assert "lstm.weight_hh_l0_reverse" in state and "fc_pose.weight" in state
    assert all(torch.isfinite(v.float()).all() for v in state.values())


@pytest.mark.parametrize("extra", [[], ["--device_cache"]])
def test_eval_keeps_the_clip_axis(trained, extra):
    ckpt, ini = trained
    out = cli_eval.main(COMMON + ["--device", "cpu", "--config_file",
                                  str(ini), "--weights", str(ckpt), "--val",
                                  "--batch_size", "4"] + extra)
    clips = _val_clips(ini)
    T = parse_ini(str(ini)).steps
    assert out["outputs"].shape == (len(clips), T, 6)
    x = torch.from_numpy(np.stack([clips[i][0] for i in range(len(clips))]))
    with torch.inference_mode():
        want = _module(ckpt, ini)(x).double().numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(out["outputs"], want, rtol=0,
                               atol=1e-5 * scale)
    assert np.isfinite(out["median_t"]) and np.isfinite(out["median_q"])
    if extra:
        # the tuple epoch: every clip's frames computed, no frame dedup
        assert out["frames_computed"] >= len(clips) * T
        assert not out["dedup_slice"]


def test_export_model_streams_the_module(trained, tmp_path):
    ckpt, ini = trained
    out = tmp_path / "vidloc.pt2"
    # a window longer than the clips it was trained on: the config's steps
    window = 5
    tools.main(["export_model"] + COMMON + [
        "--config_file", str(_ini(tmp_path, window)), "--weights", str(ckpt),
        "--output", str(out), "--height", "64", "--width", "96",
        "--platforms", "cpu"])
    stream = serving.load_inference(out, "cpu")
    assert isinstance(stream, serving.Stream) and stream.window == window
    frames = torch.from_numpy(np.stack(
        [_val_clips(ini).dset[i][0] for i in range(12)]))
    session = stream.session()
    session.open(frames[:2])
    model = _module(ckpt, ini)
    for i in range(2, len(frames)):
        got = session.step(frames[i])
        lo = max(0, i - window + 1)
        with torch.inference_mode():
            want = model(frames[lo:i + 1][None])[0]
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("extra,reason", [
    (["--quantize", "int8"], "PoseNet's"),
    (["--fold_bn"], "PoseNet's"),
    (["--quantize", "int8", "--calibrate", "1", "--quantize_heads",
      "--fuse_requant"], "PoseNet's"),
    (["--pose_graph"], "VOs"),
])
def test_eval_refuses_what_vidloc_cannot_take(trained, extra, reason):
    ckpt, ini = trained
    with pytest.raises(ValueError, match=reason):
        cli_eval.main(COMMON + ["--device", "cpu", "--config_file",
                                str(ini), "--weights", str(ckpt), "--val"]
                      + extra)


def test_export_refuses_int8_vidloc(trained, tmp_path):
    ckpt, ini = trained
    with pytest.raises(ValueError, match="PoseNet's"):
        tools.main(["export_model"] + COMMON + [
            "--config_file", str(ini), "--weights", str(ckpt), "--output",
            str(tmp_path / "q.pt2"), "--platforms", "cpu", "--quantize",
            "int8"])
    assert not (tmp_path / "q.pt2").exists()
