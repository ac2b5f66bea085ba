"""The saliency tool (geomapnet_tpu_torch.cli.plot_activations) against the
JAX package's, on the CPU.

- ``saliency_fn``: one MapNet (ResNet-18, feat_dim 32) on numpy-seeded
  variables and the same 2x3 frames through both packages, within 1e-5 of
  the largest saliency value (the backward of a float32 ResNet, summed in
  another order);
- ``_jet``: equal to JAX's;
- ``main`` on the synthetic scene: the port (``--weights`` an npz) and JAX
  (an orbax checkpoint of the same weights) write the same frames, each the
  blend of the port's ``saliency_fn`` on its batch; JAX's agree within one
  grey level on at least 90% of each frame's pixels. The rest lie where
  the scene's smooth, partly flat frames make a max-pool window's largest
  inputs tie: XLA and PyTorch route a tied maximum's gradient to
  different inputs (both valid subgradients), and a 1e-3 perturbation of
  the frames brings the two saliencies within 2e-6 of their largest
  value (measured on the CPU).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from geomapnet_tpu.cli import plot_activations as jax_pa
from geomapnet_tpu.cli.config import parse_ini as jax_parse_ini
from geomapnet_tpu.models import MapNet as FlaxMapNet
from geomapnet_tpu_torch.cli import plot_activations as pa
from geomapnet_tpu_torch.cli.builders import build_datasets, build_model
from geomapnet_tpu_torch.cli.config import ExperimentConfig, parse_ini
from geomapnet_tpu_torch.models.posenet import MapNet
from geomapnet_tpu_torch.train.checkpoint import load_weights
from test_torch_eval import seeded_npz
from test_torch_models import _images, flax_posenet, port_posenet, \
    posenet_variables
from test_torch_tools import _jax_checkpoint
from test_torch_train_step import one_torch_thread  # noqa: F401

REPO_INI = "configs/mapnet.ini"


def test_saliency_matches_jax():
    variables = posenet_variables("resnet18", seed=2)
    x = _images((2, 3, 32, 48, 3), seed=3)
    state = types.SimpleNamespace(
        params={"model": {"posenet": variables["params"]}},
        batch_stats={"posenet": variables["batch_stats"]})
    want = np.asarray(jax_pa.saliency_fn(
        FlaxMapNet(posenet=flax_posenet("resnet18")), state)(
            jnp.asarray(x)))
    model = MapNet(port_posenet("resnet18", variables))
    got = pa.saliency_fn(model)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3, 32, 48)
    assert got.dtype == np.float32
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert not any(p.grad is not None for p in model.parameters())


def test_jet_matches_jax():
    x = np.linspace(0.0, 1.0, 257, dtype=np.float32).reshape(1, 257)
    np.testing.assert_array_equal(pa._jet(x), jax_pa._jet(x))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The same seeded MapNet weights as an npz (the port's ``--weights``)
    and as an orbax checkpoint (the JAX tool's)."""
    tmp = tmp_path_factory.mktemp("w")
    npz = tmp / "w.npz"
    seeded_npz(npz, "mapnet", ExperimentConfig(), "resnet18")
    return npz, _jax_checkpoint(npz, jax_parse_ini(REPO_INI), tmp)


def test_main_writes_the_frames_jax_writes(weights, tmp_path, capsys):
    npz, ckpt = weights
    argv = ["--dataset", "synth", "--model", "mapnet", "--trunk",
            "resnet18", "--config_file", REPO_INI, "--frames", "5",
            "--batch_size", "2"]
    written = pa.main(argv + ["--weights", str(npz), "--device", "cpu",
                              "--output_dir", str(tmp_path / "port")])
    jax_pa.main(argv + ["--weights", str(ckpt),
                        "--output_dir", str(tmp_path / "jax")])
    assert "5 saliency frames" in capsys.readouterr().out
    names = [f"saliency_{i:04d}.png" for i in range(5)]
    assert [p.name for p in written] == names
    assert sorted(p.name for p in (tmp_path / "jax").iterdir()) == names
    # the port's frames: its saliency on the first batches' middle frames
    model, _ = build_model("mapnet", parse_ini(REPO_INI), trunk="resnet18")
    load_weights(npz, model)
    train_set, _ = build_datasets("mapnet", "synth", "synth", "unused",
                                  parse_ini(REPO_INI))
    x = np.stack([train_set[i][0] for i in range(6)])
    sal = np.concatenate([pa.saliency_fn(model)(torch.from_numpy(b)).numpy()
                          for b in np.split(x, 3)])
    for i, name in enumerate(names):
        got = np.asarray(Image.open(tmp_path / "port" / name), np.int16)
        want = np.asarray(Image.open(tmp_path / "jax" / name), np.int16)
        assert got.shape == want.shape == (64, 96, 3)
        np.testing.assert_array_equal(got, pa._blend(x[i, 1], sal[i, 1]))
        close = (np.abs(got - want) <= 1).all(axis=-1).mean()
        assert close >= 0.9, (name, close)
