"""Eval-time dropout (``--eval_dropout``, ``stochastic=True``).

- The port's head with an injected (N, feat_dim) keep-mask equals the Flax
  PoseNet's head with the same mask put in its Dropout (through
  ``nn.intercept_methods``) on the same trunk features, and equals it under
  Flax's own draw once that draw's mask is read back: the placement
  (``fc_feat -> relu -> dropout``) and the inverted scaling ``1/(1-p)`` are
  the same. Tolerance 1e-5 relative (float32 dense layers summed in
  another order); the whole forward from images 1e-4.
- ``p = 0`` stochastic equals deterministic, bit for bit.
- On the CPU, the loader path and the device cache's tuple epoch give the
  same draws for a seed, bit for bit; another seed gives other draws.
- Dedup, int8 and fold_bn are refused with eval-time dropout, with JAX's
  messages.

The draws themselves differ from ``jax.random`` (ROADMAP.md Queue 3, "RNG
streams differ"); parity with JAX goes through injected masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from geomapnet_tpu.cli import builders as jax_builders
from geomapnet_tpu.cli.config import ExperimentConfig
from geomapnet_tpu.models.torch_import import load_npz as jax_load_npz
from geomapnet_tpu_torch.cli import builders
from geomapnet_tpu_torch.cli import eval as port_eval
from geomapnet_tpu_torch.cli.eval_epoch import window_generator
from geomapnet_tpu_torch.data.sevenscenes import SevenScenes
from geomapnet_tpu_torch.models.flax_import import (
    load_npz,
    variables_to_state_dict,
)
from geomapnet_tpu_torch.models.posenet import dropout_keep_mask
from test_torch_device_cache import N_FRAMES, _jax_run, _port_run
from test_torch_eval import _make_verify_fixture, seeded_npz

CPU = torch.device("cpu")
P = 0.5


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The verify fixture of tests/test_torch_device_cache.py."""
    root = _make_verify_fixture().build(tmp_path_factory.mktemp("7s"),
                                        n_frames=N_FRAMES)
    SevenScenes("heads", str(root / "deepslam" / "7Scenes"), train=True,
                asset_dir=str(root / "assets" / "7Scenes"))
    return root


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    out = {}
    for name in ("mapnet", "posenet"):
        out[name] = tmp_path_factory.mktemp("w") / f"{name}.npz"
        seeded_npz(out[name], name, ExperimentConfig(), "resnet18")
    return out


def _flax_stochastic(npz, x, mask=None, key=0):
    """The Flax PoseNet (ResNet-18) with dropout active on ``x``; with
    ``mask`` its Dropout returns ``where(mask, h/(1-p), 0)``. Returns
    (poses, trunk features, the Dropout's input and output)."""
    model, _ = jax_builders.build_model("posenet", ExperimentConfig(
        dropout=P), trunk="resnet18")
    seen = {}

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, nn.Dropout) and mask is not None:
            out = jnp.where(mask, args[0] / (1.0 - P), 0.0)
        else:
            out = next_fun(*args, **kwargs)
        if mod.name == "feature_extractor":
            seen["feats"] = out
        if isinstance(mod, nn.Dropout):
            seen["in"], seen["out"] = args[0], out
        return out

    with nn.intercept_methods(interceptor):
        y = model.apply(jax_load_npz(str(npz)), jnp.asarray(x), train=False,
                        stochastic=True,
                        rngs={"dropout": jax.random.PRNGKey(key)})
    return (np.asarray(y),) + tuple(np.asarray(seen[k])
                                    for k in ("feats", "in", "out"))


def _port_posenet(npz, droprate=P):
    net, _ = builders.build_model("posenet", ExperimentConfig(
        dropout=droprate), trunk="resnet18")
    net.load_state_dict(variables_to_state_dict(load_npz(str(npz))))
    return net.eval()


def _images(n=4, seed=0):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def test_injected_mask_matches_flax_head(weights):
    x = _images()
    mask = np.random.RandomState(1).rand(4, 2048) < 1 - P
    want, feats, _, _ = _flax_stochastic(weights["posenet"], x, mask)
    net = _port_posenet(weights["posenet"])
    with torch.inference_mode():
        head = net.head(torch.from_numpy(feats),
                        keep_mask=torch.from_numpy(mask)).numpy()
        whole = net(torch.from_numpy(x),
                    keep_mask=torch.from_numpy(mask)).numpy()
        plain = net(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(head, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(whole, want, rtol=1e-4, atol=1e-4)
    assert np.abs(plain - want).max() > 1e-2    # the mask matters


def test_flax_own_draw_read_back(weights):
    """Flax's own Bernoulli draw, read back from its Dropout's output, is a
    keep-mask the port's head turns into Flax's poses."""
    x = _images(seed=2)
    want, feats, h, dropped = _flax_stochastic(weights["posenet"], x, key=3)
    mask = dropped != 0
    kept = mask[h > 0]
    assert 0.3 < kept.mean() < 0.7                  # p = 0.5 draws
    np.testing.assert_allclose(dropped[mask], h[mask] / (1 - P), rtol=1e-6)
    net = _port_posenet(weights["posenet"])
    with torch.inference_mode():
        got = net.head(torch.from_numpy(feats),
                       keep_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_generator_draws():
    """Masks come from the generator alone: equal seeds, equal masks; the
    keep share is 1-p; p = 0 keeps everything."""
    gen = window_generator(7, 3, CPU)
    a = dropout_keep_mask((64, 2048), P, gen, CPU)
    b = dropout_keep_mask((64, 2048), P,
                          window_generator(7, 3, CPU), CPU)
    c = dropout_keep_mask((64, 2048), P,
                          window_generator(7, 4, CPU), CPU)
    assert a.dtype == torch.bool and torch.equal(a, b)
    assert not torch.equal(a, c)
    assert abs(a.float().mean().item() - (1 - P)) < 0.01
    assert dropout_keep_mask((4, 8), 0.0, gen, CPU).all()


def test_p0_stochastic_equals_deterministic(weights):
    x = torch.from_numpy(_images())
    net0 = _port_posenet(weights["posenet"], droprate=0.0)
    net = _port_posenet(weights["posenet"])
    with torch.inference_mode():
        det = net0(x)
        assert torch.equal(net0(x, window_generator(7, 0, CPU)), det)
        assert torch.equal(net(x), det)     # no generator: no dropout
        assert not torch.equal(net(x, window_generator(7, 0, CPU)), det)


def test_loader_and_tuple_epoch_same_draws(scene, weights):
    """The loader path's batch k and the tuple epoch's window k draw from
    the same generator: bit-identical poses for a seed, the same again on a
    rerun, other poses for another seed and for the deterministic run."""
    run = dict(stochastic=True, seed=11)
    loader = _port_run(scene, weights, **run)
    cached = _port_run(scene, weights, device_cache=True, **run)
    assert cached["dedup_slice"] is False
    assert cached["frames_computed"] == 42   # the tuple epoch: 7 x 2 x 3
    np.testing.assert_array_equal(loader["pred_poses"], cached["pred_poses"])
    again = _port_run(scene, weights, device_cache=True, **run)
    np.testing.assert_array_equal(again["pred_poses"], cached["pred_poses"])
    other = _port_run(scene, weights, device_cache=True, stochastic=True,
                      seed=12)
    assert np.abs(other["pred_poses"] - cached["pred_poses"]).max() > 1e-3
    det = _port_run(scene, weights, device_cache=True, dedup_frames=False)
    assert np.abs(det["pred_poses"] - cached["pred_poses"]).max() > 1e-3
    np.testing.assert_array_equal(det["targ_poses"], cached["targ_poses"])


@pytest.mark.parametrize("kw,match", [
    (dict(device_cache=True, dedup_frames=True), "no --eval_dropout"),
    (dict(quantize=True, calib_batches=2), "incompatible with --eval_dropout"),
    (dict(fold_bn=True), "incompatible with --eval_dropout"),
    (dict(device_cache=True, quantize=True, calib_batches=2,
          quantize_heads=True, fuse_requant=True),
     "incompatible with --eval_dropout"),
], ids=["dedup", "int8", "fold_bn", "int8_serving"])
def test_refusals_match_jax(scene, weights, kw, match):
    with pytest.raises(ValueError, match=match) as got:
        _port_run(scene, weights, stochastic=True, **kw)
    with pytest.raises(ValueError, match=match) as want:
        _jax_run(scene, weights, stochastic=True, **kw)
    assert str(got.value) == str(want.value)


def test_cli_eval_dropout(scene, weights):
    """``main()`` with ``--eval_dropout`` on the fixture's test split at
    256x341: the device cache runs the tuple epoch and equals the loader
    path bit for bit."""
    argv = [
        "--dataset", "7Scenes", "--scene", "heads", "--model", "mapnet",
        "--trunk", "resnet18", "--device", "cpu",
        "--weights", str(weights["mapnet"]),
        "--config_file", str(scene / "tiny.ini"), "--batch_size", "4",
        "--val", "--data_path", str(scene / "deepslam"),
        "--asset_root", str(scene / "assets"), "--eval_dropout",
    ]
    cached = port_eval.main(argv + ["--device_cache"])
    loader = port_eval.main(argv)
    assert not cached["dedup_slice"] and cached["frames_computed"] == 48
    assert np.isfinite(cached["pred_poses"]).all()
    np.testing.assert_array_equal(cached["pred_poses"], loader["pred_poses"])
