"""The 7Scenes slice: data copies, the RGB device normalize, the bf16
forward, and the CLI on the loader path.

Each copy runs beside the JAX package's original on a scene written by
tools/make_verify_fixture.py (48x64 frames) and must give the same arrays
exactly. The bf16 forward is held to the Flax modules at ``jnp.bfloat16``.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomapnet_tpu.cli import builders as jax_builders
from geomapnet_tpu.cli.config import ExperimentConfig
from geomapnet_tpu.data.cache import CachedScene as JaxCachedScene
from geomapnet_tpu.data.sevenscenes import SevenScenes as JaxSevenScenes
from geomapnet_tpu.data.transforms import ImageTransform as JaxImageTransform
from geomapnet_tpu.data.transforms import Normalize as JaxNormalize
from geomapnet_tpu.models import MapNet as FlaxMapNet
from geomapnet_tpu.models import PoseNet as FlaxPoseNet
from geomapnet_tpu.ops.image import make_device_pipeline as jax_pipeline
from geomapnet_tpu_torch.cli import builders
from geomapnet_tpu_torch.cli import eval as port_eval
from geomapnet_tpu_torch.data.cache import CachedScene
from geomapnet_tpu_torch.data.sevenscenes import SevenScenes
from geomapnet_tpu_torch.data.transforms import ImageTransform, Normalize
from geomapnet_tpu_torch.models.flax_import import variables_to_state_dict
from geomapnet_tpu_torch.models.posenet import MapNet, PoseNet
from geomapnet_tpu_torch.ops.image import make_device_pipeline
from test_torch_eval import _make_verify_fixture, seeded_npz
from test_torch_models import (
    FEAT_DIM,
    TRUNKS,
    H,
    W,
    _images,
    posenet_variables,
)

STATS = np.array([[0.45, 0.45, 0.46], [0.078, 0.077, 0.072]])
MEAN = tuple(float(v) for v in STATS[0])
STD = tuple(float(v) for v in np.sqrt(STATS[1]))
N_FRAMES = 10
# bf16 tolerance, relative to the largest |value| of the reference output:
# each implementation rounds every conv and dense output to bf16 with its
# own summation order, so they differ by a few output ulps. Measured on the
# CPU: port vs Flax (both bf16) <= 1.9% on every pose output, bf16 vs f32
# <= 2.4%; chip_smoke.py holds its bf16 eval's translations to the f32
# eval's with the same bound.
BF16_TOL = 0.03


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The verify fixture (two 10-frame sequences, 48x64) plus orbslam and
    libviso2 VO assets for the test split; the train split is built once so
    that pose_stats.txt exists, as training leaves it."""
    root = _make_verify_fixture().build(tmp_path_factory.mktemp("7s"),
                                        n_frames=N_FRAMES)
    assets = root / "assets" / "7Scenes" / "heads"
    rng = np.random.RandomState(3)
    for lib, first in (("orbslam", 0), ("libviso2", 1)):
        frames = np.arange(first, first + N_FRAMES - 2)
        Rs = [np.linalg.qr(rng.randn(3, 3))[0] for _ in frames]
        Rs = [R * np.sign(np.linalg.det(R)) for R in Rs]
        table = np.stack([
            np.concatenate([[f], np.concatenate(
                [R, rng.randn(3, 1)], axis=1).ravel()])
            for f, R in zip(frames, Rs)])
        (assets / f"{lib}_poses").mkdir()
        np.savetxt(assets / f"{lib}_poses" / "seq-02.txt", table)
        (assets / "seq-02").mkdir(exist_ok=True)
        with open(assets / "seq-02" / f"{lib}_vo_stats.pkl", "wb") as f:
            pickle.dump({"R": Rs[0], "t": rng.randn(3), "s": 1.3}, f)
    data = str(root / "deepslam" / "7Scenes")
    SevenScenes("heads", data, train=True,
                asset_dir=str(root / "assets" / "7Scenes"))
    return root


def _pair(scene, transform_kw=None, **kw):
    """(port, JAX) SevenScenes of the fixture with equal transforms."""
    data = str(scene / "deepslam" / "7Scenes")
    assets = str(scene / "assets" / "7Scenes")
    out = []
    for cls, tf, norm in ((SevenScenes, ImageTransform, Normalize),
                          (JaxSevenScenes, JaxImageTransform, JaxNormalize)):
        t = None
        if transform_kw is not None:
            t_kw = dict(transform_kw)
            if t_kw.pop("normalize", False):
                t_kw["normalize"] = norm(STATS[0], np.sqrt(STATS[1]))
            t = tf(**t_kw)
        out.append(cls("heads", data, transform=t, asset_dir=assets, **kw))
    return out


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("transform_kw", [
    None,
    dict(resize=32, keep_uint8=True),
    dict(resize=32, normalize=True),
    dict(resize=256, keep_uint8=True),
], ids=["raw", "uint8", "host_normalized", "uint8_256"])
def test_sevenscenes_copy(scene, train, transform_kw):
    ours, theirs = _pair(scene, transform_kw, train=train)
    np.testing.assert_array_equal(ours.poses, theirs.poses)
    np.testing.assert_array_equal(ours.gt_idx, theirs.gt_idx)
    assert ours.c_imgs == theirs.c_imgs
    assert len(ours) == len(theirs) == N_FRAMES
    for i in (0, 3, N_FRAMES - 1):
        a, b = ours.get_image(i), theirs.get_image(i)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours[4][1], theirs[4][1])


def test_pose_stats_written_then_read(scene):
    """The train split writes identity pose stats, byte for byte as JAX's
    copy writes them; the val split reads the file back."""
    data = str(scene / "deepslam" / "7Scenes")
    assets = str(scene / "assets" / "7Scenes")
    stats = scene / "assets" / "7Scenes" / "heads" / "pose_stats.txt"
    JaxSevenScenes("heads", data, train=True, asset_dir=assets)
    written_by_jax = stats.read_bytes()
    stats.unlink()
    SevenScenes("heads", data, train=True, asset_dir=assets)
    assert stats.read_bytes() == written_by_jax
    identity_val, _ = _pair(scene, train=False)
    stats.write_text("1 2 3\n2 4 8\n")
    try:
        ours, theirs = _pair(scene, train=False)
    finally:
        stats.write_bytes(written_by_jax)
    np.testing.assert_array_equal(ours.poses, theirs.poses)
    np.testing.assert_allclose(ours.poses[:, :3] * [2, 4, 8] + [1, 2, 3],
                               identity_val.poses[:, :3], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("vo_lib", ["orbslam", "libviso2"])
def test_sevenscenes_vo_copy(scene, vo_lib):
    ours, theirs = _pair(scene, train=False, real=True, vo_lib=vo_lib)
    np.testing.assert_array_equal(ours.poses, theirs.poses)
    np.testing.assert_array_equal(ours.gt_idx, theirs.gt_idx)
    assert ours.c_imgs == theirs.c_imgs
    # libviso2 numbers frames from 1: both map them to GT frames 0..7
    np.testing.assert_array_equal(ours.gt_idx, np.arange(N_FRAMES - 2))


def test_skip_images_copy(scene):
    ours, theirs = _pair(scene, train=False, skip_images=True)
    assert ours.get_image(2) is theirs.get_image(2) is None
    assert ours.get_images([0, 1]) == theirs.get_images([0, 1]) == [None] * 2
    np.testing.assert_array_equal(ours.poses, theirs.poses)


def test_corrupt_frame_is_none(tmp_path):
    root = _make_verify_fixture().build(tmp_path / "c", n_frames=3)
    seq = root / "deepslam" / "7Scenes" / "heads" / "seq-01"
    (seq / "frame-000001.color.png").write_bytes(b"not a png")
    for cls in (SevenScenes, JaxSevenScenes):
        ds = cls("heads", str(root / "deepslam" / "7Scenes"), train=True,
                 transform=ImageTransform(resize=32, keep_uint8=True),
                 asset_dir=str(root / "assets" / "7Scenes"))
        assert ds.get_image(1) is None
        assert ds.get_images([0, 1, 2])[1] is None
        assert ds.get_image(0).shape == (32, 43, 3)


def test_cached_scene_copy(scene):
    """CachedScene over the fixture: same frames, hit/miss counts and
    budget cut-off as JAX's, and the same refusal of a jittering scene."""
    ours, theirs = _pair(scene, dict(resize=32, keep_uint8=True),
                         train=True)
    frame_bytes = ours.get_image(0).nbytes
    a = CachedScene(ours, max_bytes=3 * frame_bytes)
    b = JaxCachedScene(theirs, max_bytes=3 * frame_bytes)
    for idx in ([0, 1], [1, 2, 3, 4], [0, 4, 4]):
        for x, y in zip(a.get_images(idx), b.get_images(idx), strict=True):
            np.testing.assert_array_equal(x, y)
    assert (a.hits, a.misses, a.cached_frames, a.cached_bytes) == (
        b.hits, b.misses, b.cached_frames, b.cached_bytes)
    assert a.cached_frames == 3
    np.testing.assert_array_equal(a[2][1], b[2][1])
    assert a.gt_idx is ours.gt_idx   # delegated
    jit_ours, jit_theirs = _pair(scene, dict(resize=32,
                                             color_jitter_strength=0.5),
                                 train=True)
    for cls, ds in ((CachedScene, jit_ours), (JaxCachedScene, jit_theirs)):
        with pytest.raises(ValueError, match="jitter"):
            cls(ds, max_bytes=1 << 20)


@pytest.mark.parametrize("resize_to", [None, (12, 20), (10, 15), (48, 70)])
@pytest.mark.parametrize("tuples", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rgb_device_pipeline_matches_jax(resize_to, tuples, dtype):
    """The RGB branch (float32, optional resize, normalize) within 1e-6 of
    JAX's in float32; in bf16 the two round the same float32 values."""
    rng = np.random.RandomState(7)
    shape = (2, 3, 24, 40, 3) if tuples else (3, 24, 40, 3)
    raw = rng.randint(0, 256, shape).astype(np.uint8)
    want = np.asarray(jax_pipeline(
        MEAN, STD, resize_to=resize_to, dtype=getattr(jnp, dtype))(
        jnp.asarray(raw)).astype(jnp.float32))
    got = make_device_pipeline(MEAN, STD, resize_to=resize_to,
                               dtype=getattr(torch, dtype))(
        torch.from_numpy(raw))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_device_preprocess_matches_jax(scene, dtype):
    assets = str(scene / "assets")
    raw = np.random.RandomState(8).randint(
        0, 256, (2, 3, 16, 20, 3)).astype(np.uint8)
    want = jax_builders.build_device_preprocess(
        "7Scenes", "heads", assets, dtype=getattr(jnp, dtype))(
        jnp.asarray(raw))
    got = builders.build_device_preprocess(
        "7Scenes", "heads", assets, dtype=getattr(torch, dtype))(
        torch.from_numpy(raw))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-6, atol=1e-6)
    assert builders.build_device_preprocess("synth", "x", assets) is None


def _bf16_pair(trunk):
    variables = posenet_variables(trunk)
    flax = FlaxPoseNet(feature_extractor=TRUNKS[trunk][0](dtype=jnp.bfloat16),
                       droprate=0.5, feat_dim=FEAT_DIM, dtype=jnp.bfloat16)
    port = PoseNet(TRUNKS[trunk][1](torch.bfloat16), droprate=0.5,
                   feat_dim=FEAT_DIM, dtype=torch.bfloat16)
    port.load_state_dict(variables_to_state_dict(variables))
    return variables, flax, port.eval()


@pytest.mark.parametrize("trunk", ["resnet18", "resnet34", "resnet50"])
def test_bf16_forward_matches_flax(trunk):
    """bf16 PoseNet against Flax at jnp.bfloat16, within BF16_TOL of the
    output's scale; the float32 output of the same weights is the scale."""
    variables, flax, port = _bf16_pair(trunk)
    x = _images((4, H, W, 3))
    want = np.asarray(jax.jit(flax.apply, static_argnames=("train",))(
        variables, jnp.asarray(x), train=False))
    port32 = PoseNet(TRUNKS[trunk][1](), droprate=0.5, feat_dim=FEAT_DIM)
    port32.load_state_dict(variables_to_state_dict(variables))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
        f32 = port32.eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (4, 6)
    scale = np.abs(f32).max()
    assert np.abs(got - want).max() <= BF16_TOL * scale
    assert np.abs(got - f32).max() <= BF16_TOL * scale
    assert np.abs(got - f32).max() > 0   # bf16 really ran


def test_bf16_mapnet_matches_flax():
    variables, flax, port = _bf16_pair("resnet18")
    x = _images((2, 3, H, W, 3), seed=4)
    want = np.asarray(FlaxMapNet(posenet=flax).apply(
        {k: {"posenet": v} for k, v in variables.items()},
        jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = MapNet(port)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3, 6)
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


@pytest.mark.parametrize("trunk", ["resnet18", "resnet50"])
def test_bf16_casts_placed_as_flax(trunk):
    """Every module's output dtype equals that of the Flax module of the
    same name (Flax's captured intermediates): convs and dense layers
    bf16, BatchNorm, blocks, trunk and the pose float32."""
    variables, flax, port = _bf16_pair(trunk)
    x = _images((1, H, W, 3))
    _, state = flax.apply(variables, jnp.asarray(x), train=False,
                          capture_intermediates=True,
                          mutable=["intermediates"])
    want = {}

    def walk(tree, path):
        for k, v in tree.items():
            if k == "__call__":
                want[".".join(path)] = str(v[0].dtype)
            elif isinstance(v, dict):
                walk(v, path + [k])

    walk(state["intermediates"], [])
    got = {}
    for name, mod in port.named_modules():
        mod.register_forward_hook(
            lambda m, i, o, name=name: got.__setitem__(
                name, str(o.dtype).replace("torch.", "")))
    with torch.inference_mode():
        port(torch.from_numpy(x))
    shared = sorted(set(want) & set(got))
    assert len(shared) >= len(want) - 1   # all but Flax's Dropout_0
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert got["feature_extractor.layer1_0.conv1"] == "bfloat16"
    assert got["feature_extractor.layer1_0.bn1"] == "float32"


def _cli(scene, npz, *extra):
    return port_eval.main([
        "--dataset", "7Scenes", "--scene", "heads", "--model", "mapnet",
        "--trunk", "resnet18", "--device", "cpu", "--weights", str(npz),
        "--config_file", str(scene / "tiny.ini"), "--batch_size", "4",
        "--val", "--data_path", str(scene / "deepslam"),
        "--asset_root", str(scene / "assets"), *extra,
    ])


@pytest.fixture(scope="module")
def mapnet_npz(tmp_path_factory):
    npz = tmp_path_factory.mktemp("w") / "w.npz"
    seeded_npz(npz, "mapnet", ExperimentConfig(), "resnet18")
    return npz


def test_cli_main_7scenes_loader(scene, mapnet_npz, tmp_path):
    """``main()`` end to end on the fixture's test split (frames resized to
    256x341 on the host, normalized on the device), f32 and bf16."""
    res = _cli(scene, mapnet_npz, "--output_dir", str(tmp_path))
    assert res["pred_poses"].shape == res["targ_poses"].shape == (N_FRAMES, 7)
    assert np.isfinite(res["pred_poses"]).all()
    assert "frames_computed" not in res
    assert (tmp_path / "7Scenes_heads_mapnet_metrics.json").exists()
    bf16 = _cli(scene, mapnet_npz, "--bf16")
    t, t16 = res["pred_poses"][:, :3], bf16["pred_poses"][:, :3]
    assert 0 < np.abs(t16 - t).max() <= BF16_TOL * np.abs(t).max()
    host = _cli(scene, mapnet_npz, "--host_normalize")
    np.testing.assert_allclose(host["pred_poses"], res["pred_poses"],
                               rtol=1e-4, atol=1e-4)


def test_cli_main_synth(tmp_path):
    npz = tmp_path / "w.npz"
    seeded_npz(npz, "posenet", ExperimentConfig(), "resnet18")
    ini = _make_verify_fixture().build(tmp_path / "s", n_frames=1) / "tiny.ini"
    res = port_eval.main([
        "--dataset", "synth", "--model", "posenet", "--trunk", "resnet18",
        "--device", "cpu", "--weights", str(npz), "--config_file", str(ini),
        "--batch_size", "16", "--val",
    ])
    assert res["pred_poses"].shape == (64, 7)
    assert np.isfinite([res["median_t"], res["mean_t"]]).all()


@pytest.mark.parametrize("flag", [
    ["--pose_graph", "--device_cache", "shard"],
    ["--quantize", "int8", "--device_cache", "shard"],
    ["--fold_bn", "--eval_dropout", "--device_cache", "shard"],
    ["--calibrate", "2", "--device_cache", "shard"],
    ["--quantize_heads", "--pose_graph", "--device_cache", "shard"],
    ["--fuse_requant", "--eval_dropout", "--device_cache", "shard"],
    ["--native_loader", "--device_cache", "shard"],
    ["--device_cache", "shard"],
])
def test_cli_refuses_unported_flags(scene, mapnet_npz, flag, capsys,
                                    monkeypatch):
    """``--device_cache shard`` (the frame-sharded cache over the ranks of
    a launch, ported in slice 11) is refused in a process that no launcher
    started, naming the launch it needs, alone or beside the flags that
    slices 4-10 ported (tests/test_torch_dp_eval.py runs it over two
    ranks)."""
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit):
        _cli(scene, mapnet_npz, *flag)
    err = capsys.readouterr().err
    assert "needs a data-parallel group" in err and "torchrun" in err
