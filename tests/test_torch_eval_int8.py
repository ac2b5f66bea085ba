"""The int8 serving eval (slice 4) as a whole, against the JAX package.

Both packages' ``evaluate()`` run the same 7Scenes scene
(tools/make_verify_fixture.py, 14 frames per sequence resized to 32x43: an
odd width, so the space-to-depth row cache pads) with the same npz, under
``quantize`` / ``calib_batches`` / ``quantize_heads`` / ``fuse_requant`` /
``fold_bn``: the calibrated scales equal JAX's bit for bit (the port
gathers its calibration batches from the uploaded frames, JAX decodes them
through a loader), the epochs are the same, and the poses agree within the
bf16 heads' tolerance. Then the port's CLI on the fixture at 256x341: the
serving configuration over the prequantized row cache equals the loader
path bit for bit.

The JAX package caches its compiled epoch under a key that leaves out the
batch size and frame shape (ROADMAP.md Queue 3, fault R1), so every JAX
call here starts from an empty cache.
"""

import numpy as np
import pytest
import torch

import geomapnet_tpu.models.quant as JQ
from geomapnet_tpu.cli.config import ExperimentConfig
from geomapnet_tpu_torch.cli import eval as port_eval
from geomapnet_tpu_torch.data.sevenscenes import SevenScenes
from geomapnet_tpu_torch.ops import cuda_quant
from test_torch_device_cache import (
    N_FRAMES,
    _jax_run,
    _port_run,
)
from test_torch_eval import _make_verify_fixture, seeded_npz

# the heads run in bf16, which XLA and PyTorch round at other places: a
# few bf16 ulp of the pose scale (0.12% measured); the folded float32 trunk
# sums its convs in another order
INT8_POSE_TOL = 0.01
F32_TOL = 1e-4
SERVING = dict(quantize=True, calib_batches=2, quantize_heads=True,
               fuse_requant=True)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
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


def _scales(tree) -> list:
    sites = list(JQ._iter_sites(tree)) + [tree["heads"]["fc_feat"]]
    return [np.asarray(s["x_scale"]) for s in sites if "x_scale" in s]


def _capture(monkeypatch, module, name, store, key):
    """Record what ``module.name`` returns under ``store[key]``."""
    orig = getattr(module, name)

    def wrapped(*a, **kw):
        store[key] = orig(*a, **kw)
        return store[key]

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("model_name,kw", [
    ("mapnet", dict(device_cache=True, **SERVING)),
    ("mapnet", dict(SERVING)),
    ("mapnet", dict(device_cache=True, quantize=True, calib_batches=2)),
    ("mapnet", dict(device_cache=True, quantize=True)),
    ("mapnet", dict(device_cache=True, fold_bn=True)),
    ("posenet", dict(device_cache=True, **SERVING)),
], ids=["e_cache_fused", "f_loader_fused", "g_cache_static",
        "cache_dynamic", "h_cache_folded", "posenet_cache_fused"])
def test_evaluate_matches_jax(scene, weights, monkeypatch, model_name, kw):
    trees = {}
    _capture(monkeypatch, JQ, "calibrate_activation_scales", trees, "jax")
    _capture(monkeypatch, port_eval, "calibrate_activation_scales", trees,
             "port")
    got = _port_run(scene, weights, model_name, **kw)
    want = _jax_run(scene, weights, model_name, **kw)
    np.testing.assert_array_equal(got["targ_poses"], want["targ_poses"])
    for k in ("frames_computed", "dedup_slice"):
        assert got.get(k) == want.get(k), k
    scale = np.abs(want["pred_poses"][:, :3]).max()
    assert scale > 1
    tol = F32_TOL if kw.get("fold_bn") else INT8_POSE_TOL
    np.testing.assert_allclose(got["pred_poses"][:, :3],
                               want["pred_poses"][:, :3], rtol=0,
                               atol=tol * scale)
    if kw.get("calib_batches"):
        got_s, want_s = _scales(trees["port"]), _scales(trees["jax"])
        assert len(got_s) == len(want_s) == 20 + kw.get("quantize_heads", 0)
        for a, b in zip(got_s, want_s):
            np.testing.assert_array_equal(a, b)
    else:
        assert not trees
    if kw.get("device_cache") and kw.get("fuse_requant"):
        # the prequantized S2D row cache: 32x43 frames -> 16x22x12 rows
        assert got["device_frames"].dtype == torch.int8
        assert tuple(got["device_frames"].shape) == (N_FRAMES, 16 * 22 * 12)
    elif kw.get("device_cache"):
        assert got["device_frames"].dtype == torch.uint8
    if kw == dict(device_cache=True, quantize=True):
        assert not got["dedup_slice"]     # dynamic scales couple batchmates


def test_row_cache_reused(scene, weights):
    """The returned int8 rows are reused as they are (frame geometry from
    one probe decode, calibration from a loader): the same poses, no
    upload."""
    first = _port_run(scene, weights, device_cache=True, **SERVING)
    again = _port_run(scene, weights, device_cache=first["device_frames"],
                      **SERVING)
    assert again["device_frames"] is first["device_frames"]
    np.testing.assert_array_equal(again["pred_poses"], first["pred_poses"])
    assert again["upload_secs"] < 1.0
    with pytest.raises(ValueError, match="needs fuse_requant"):
        _port_run(scene, weights, device_cache=first["device_frames"],
                  quantize=True, calib_batches=2)


@pytest.mark.parametrize("kw,match", [
    (dict(quantize=True, fold_bn=True), "implied by --quantize"),
    (dict(quantize=True, fuse_requant=True), "needs --quantize int8 with"),
    (dict(fuse_requant=True), "needs --quantize int8 with"),
    (dict(device_cache=True, quantize=True, dedup_frames=True),
     "no dynamic-scale int8"),
], ids=["quantize_and_fold", "fused_dynamic", "fused_float",
        "dedup_dynamic"])
def test_refusals_match_jax(scene, weights, kw, match):
    with pytest.raises(ValueError, match=match) as got:
        _port_run(scene, weights, **kw)
    if kw.get("quantize"):   # JAX ignores --fuse_requant without it
        with pytest.raises(ValueError, match=match) as want:
            _jax_run(scene, weights, **kw)
        assert str(got.value) == str(want.value)


def test_cli_serving_matches_loader(scene, weights):
    """``main()`` on the fixture's test split at 256x341, as the README's
    drive: the serving configuration over the prequantized row cache (S2D
    stem, 128x171x12 rows) equals the loader path (7x7 stem) bit for bit;
    on CPU tensors no kernel launches. The BN-folded bf16 trunk stays
    within 3% of float32."""
    argv = [
        "--dataset", "7Scenes", "--scene", "heads", "--model", "mapnet",
        "--trunk", "resnet18", "--device", "cpu",
        "--weights", str(weights["mapnet"]),
        "--config_file", str(scene / "tiny.ini"), "--batch_size", "4",
        "--val", "--data_path", str(scene / "deepslam"),
        "--asset_root", str(scene / "assets"),
    ]
    serving = ["--quantize", "int8", "--calibrate", "1", "--quantize_heads",
               "--fuse_requant"]
    before = dict(cuda_quant.launches)
    cached = port_eval.main(argv + ["--device_cache"] + serving)
    loader = port_eval.main(argv + serving)
    assert cuda_quant.launches == before
    assert tuple(cached["device_frames"].shape) == (N_FRAMES,
                                                    128 * 171 * 12)
    assert cached["dedup_slice"] and cached["frames_computed"] == 24
    assert np.isfinite(cached["pred_poses"]).all()
    np.testing.assert_array_equal(cached["pred_poses"], loader["pred_poses"])
    f32 = port_eval.main(argv + ["--device_cache"])
    folded = port_eval.main(argv + ["--device_cache", "--fold_bn", "--bf16"])
    t, t16 = f32["pred_poses"][:, :3], folded["pred_poses"][:, :3]
    assert 0 < np.abs(t16 - t).max() <= 0.03 * np.abs(t).max()
