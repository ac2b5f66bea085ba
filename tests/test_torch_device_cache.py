"""The device frame cache and the device-cache eval epoch.

``upload_frames`` and the epoch planner on their own, then the port's
``evaluate(device_cache=True)`` against the JAX package's on the same
7Scenes scene (tools/make_verify_fixture.py, 14 frames per sequence resized
to 32x43) and weights, for the slice, gather and tuple epochs and the
loader path. 14 frames are not a multiple of a window's B*T = 6, so the
slice epoch's last window overlaps the one before it.

The JAX package caches its compiled epoch under a key that leaves out the
batch size and frame shape (ROADMAP.md Queue 3, fault R1), so every JAX
call here starts from an empty cache.
"""

import jax.numpy as jnp  # noqa: F401  (keeps JAX on the CPU, conftest)
import numpy as np
import pytest
import torch

import geomapnet_tpu.cli.eval as jax_eval_module
from geomapnet_tpu.cli import builders as jax_builders
from geomapnet_tpu.cli.config import ExperimentConfig
from geomapnet_tpu.data import MF as JaxMF
from geomapnet_tpu.data.sevenscenes import SevenScenes as JaxSevenScenes
from geomapnet_tpu.data.transforms import ImageTransform as JaxImageTransform
from geomapnet_tpu_torch.cli import builders
from geomapnet_tpu_torch.cli import eval as port_eval
from geomapnet_tpu_torch.cli.eval_epoch import plan_epoch, tuple_outputs
from geomapnet_tpu_torch.data.composite import MF
from geomapnet_tpu_torch.data.device_cache import upload_frames
from geomapnet_tpu_torch.data.sevenscenes import SevenScenes
from geomapnet_tpu_torch.data.transforms import ImageTransform
from geomapnet_tpu_torch.models.flax_import import (
    load_npz,
    variables_to_state_dict,
)
from test_torch_eval import _make_verify_fixture, jax_state, seeded_npz

N_FRAMES = 14
BATCH = 2
STEPS, SKIP = 3, 2
CPU = torch.device("cpu")


class _Frames:
    """In-memory frame dataset: frame i is a (2, 3, 3) image filled with i;
    frames in ``bad`` fail to decode."""

    def __init__(self, n=10, bad=(), dtype=np.uint8):
        self.n, self.bad, self.dtype = n, set(bad), dtype
        self.calls = []

    def __len__(self):
        return self.n

    def get_image(self, i):
        return None if i in self.bad else np.full((2, 3, 3), i, self.dtype)

    def get_images(self, idx, num_workers=1):
        self.calls.append(list(idx))
        return [self.get_image(i) for i in idx]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_upload_frames_in_chunks(dtype):
    frames = _Frames(10, dtype=dtype)
    buf = upload_frames(frames, CPU, chunk=4)
    assert buf.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    assert buf.device == CPU and tuple(buf.shape) == (10, 2, 3, 3)
    np.testing.assert_array_equal(buf[:, 0, 0, 0].numpy(), np.arange(10))
    assert frames.calls == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]


def test_upload_substitutes_corrupt_frames(capsys):
    buf = upload_frames(_Frames(7, bad=(3, 4)), CPU, chunk=4)
    np.testing.assert_array_equal(buf[:, 0, 0, 0].numpy(),
                                  [0, 1, 2, 2, 2, 5, 6])
    assert "2/7 frames failed" in capsys.readouterr().out


def test_upload_refusals():
    with pytest.raises(ValueError, match="max_bytes"):
        upload_frames(_Frames(10), CPU, max_bytes=10 * 18 - 1)
    with pytest.raises(ValueError, match="fixed-shape array"):
        upload_frames(_Frames(3, bad=(0,)), CPU)
    with pytest.raises(ValueError, match="empty"):
        upload_frames(_Frames(0), CPU)


def _idx_mat(n, steps=STEPS, skip=SKIP, even=False):
    ds = _EvenMF(_Frames(n), steps=steps, skip=skip) if even else MF(
        _Frames(n), steps=steps, skip=skip)
    return np.stack([ds.get_indices(i) for i in range(len(ds))])


@pytest.mark.parametrize("n,even,dedup,mode,k", [
    (14, False, None, "slice", 3),    # U=14, windows of 6: starts 0, 6, 8
    (12, False, None, "slice", 2),    # U a multiple of B*T: no overlap
    (14, True, None, "dedup", 2),     # even frames + the clamped 13
    (14, False, False, "tuple", 7),
    (4, False, True, "dedup", 1),     # U=4 < B*T: gather, forced
])
def test_plan_and_tuple_outputs(n, even, dedup, mode, k):
    """Every epoch's per-tuple outputs are the tuples' own frames: a fake
    forward that returns each frame's index, through the planned windows
    and back through ``tuple_outputs``, gives the index matrix back."""
    idx_mat = _idx_mat(n, even=even)
    plan = plan_epoch(idx_mat, BATCH, per_frame=True, dedup_frames=dedup)
    assert (plan.mode, len(plan.windows)) == (mode, k)
    assert plan.frames_computed == k * BATCH * STEPS
    if mode == "slice":
        read = plan.windows[:, None] + np.arange(BATCH * STEPS)
        assert read.max() == plan.uniq[-1]
    else:
        read = plan.windows
    outs = np.repeat(read.reshape(k, BATCH, STEPS, 1).astype(float), 6, -1)
    np.testing.assert_array_equal(tuple_outputs(plan, outs)[..., 0],
                                  idx_mat)


def test_plan_slice_starts_shift_back():
    plan = plan_epoch(_idx_mat(14), BATCH, per_frame=True)
    np.testing.assert_array_equal(plan.windows, [0, 6, 8])


def test_plan_refuses_dedup_without_per_frame_model():
    idx_mat = np.arange(10)[:, None]
    assert plan_epoch(idx_mat, 4, per_frame=False).mode == "tuple"
    with pytest.raises(ValueError, match="per-frame"):
        plan_epoch(idx_mat, 4, per_frame=False, dedup_frames=True)


class _EvenMF(MF):
    """Tuples centred on the even frames only: with an even skip their
    unique frames are not consecutive, so the dedup epoch gathers."""

    def __len__(self):
        return (len(self.sampler) + 1) // 2

    def get_indices(self, index):
        return super().get_indices(2 * index)


class _JaxEvenMF(JaxMF):
    __len__ = _EvenMF.__len__

    def get_indices(self, index):
        return super().get_indices(2 * index)


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


def _frames(scene, cls, tf):
    return cls("heads", str(scene / "deepslam" / "7Scenes"), train=False,
               transform=tf(resize=32, keep_uint8=True),
               asset_dir=str(scene / "assets" / "7Scenes"))


def _pose_stats(scene):
    return tuple(np.loadtxt(scene / "assets" / "7Scenes" / "heads"
                            / "pose_stats.txt"))


def _port_run(scene, weights, model_name="mapnet", even=False, **kw):
    frames = _frames(scene, SevenScenes, ImageTransform)
    is_tuple = model_name == "mapnet"
    ds = ((_EvenMF if even else MF)(frames, steps=STEPS, skip=SKIP)
          if is_tuple else frames)
    model, _ = builders.build_model(model_name, ExperimentConfig(),
                                    trunk="resnet18")
    (model.posenet if is_tuple else model).load_state_dict(
        variables_to_state_dict(load_npz(str(weights[model_name]))))
    pre = builders.build_device_preprocess("7Scenes", "heads",
                                           str(scene / "assets"))
    return port_eval.evaluate(model, ds, CPU, batch_size=BATCH,
                              pose_stats=_pose_stats(scene), progress=False,
                              preprocess=pre, **kw)


def _jax_run(scene, weights, model_name="mapnet", even=False, **kw):
    frames = _frames(scene, JaxSevenScenes, JaxImageTransform)
    is_tuple = model_name == "mapnet"
    ds = ((_JaxEvenMF if even else JaxMF)(frames, steps=STEPS, skip=SKIP)
          if is_tuple else frames)
    model, _ = jax_builders.build_model(model_name, ExperimentConfig(),
                                        trunk="resnet18")
    pre = jax_builders.build_device_preprocess("7Scenes", "heads",
                                               str(scene / "assets"))
    jax_eval_module._SCAN_CACHE.clear()   # fault R1: no stale program
    return jax_eval_module.evaluate(
        model, jax_state(weights[model_name], is_tuple), ds,
        batch_size=BATCH, pose_stats=_pose_stats(scene), progress=False,
        preprocess=pre, use_mesh=False, **kw)


@pytest.mark.parametrize("model_name,even,kw", [
    ("mapnet", False, dict(device_cache=True)),                 # slice
    ("mapnet", True, dict(device_cache=True)),                  # gather
    ("mapnet", False, dict(device_cache=True, dedup_frames=False)),
    ("mapnet", False, dict()),                                  # loader
    ("posenet", False, dict(device_cache=True)),
], ids=["slice", "gather", "tuple", "loader", "posenet_cache"])
def test_evaluate_matches_jax(scene, weights, model_name, even, kw):
    """Same scene, weights and epoch through both evaluate()s: targets
    exactly, predictions within 1e-4 relative (the f32 network sums in
    another order, tests/test_torch_models.py), and the same epoch."""
    got = _port_run(scene, weights, model_name, even, **kw)
    want = _jax_run(scene, weights, model_name, even, **kw)
    np.testing.assert_array_equal(got["targ_poses"], want["targ_poses"])
    assert np.abs(got["pred_poses"]).max() > 0.1
    np.testing.assert_allclose(got["pred_poses"], want["pred_poses"],
                               rtol=1e-4, atol=1e-5)
    for k in ("frames_computed", "dedup_slice"):
        assert got.get(k) == want.get(k), k
    if kw:
        assert got["device_frames"].dtype == torch.uint8
        assert tuple(got["device_frames"].shape) == (N_FRAMES, 32, 43, 3)


def test_epochs_agree(scene, weights):
    """Slice, gather and tuple epochs and the loader path give the same
    poses (1e-5) on a U that is not a multiple of B*T; the dedup epochs
    compute about a third of the tuple epoch's frames."""
    slice_ = _port_run(scene, weights, device_cache=True)
    tuple_ = _port_run(scene, weights, device_cache=True,
                       dedup_frames=False)
    loader = _port_run(scene, weights)
    assert slice_["dedup_slice"] and not tuple_["dedup_slice"]
    assert slice_["frames_computed"] == 18     # ceil(14 / 6) * 6
    assert tuple_["frames_computed"] == 42     # ceil(14 / 2) * 2 * 3
    for other in (tuple_, loader):
        np.testing.assert_allclose(slice_["pred_poses"],
                                   other["pred_poses"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(slice_["targ_poses"],
                                      other["targ_poses"])
    even = _port_run(scene, weights, even=True, device_cache=True)
    even_tuple = _port_run(scene, weights, even=True, device_cache=True,
                           dedup_frames=False)
    assert not even["dedup_slice"] and even["frames_computed"] == 12
    np.testing.assert_allclose(even["pred_poses"], even_tuple["pred_poses"],
                               rtol=1e-5, atol=1e-5)


def test_device_frames_reused(scene, weights):
    first = _port_run(scene, weights, device_cache=True)
    again = _port_run(scene, weights, device_cache=first["device_frames"])
    assert again["device_frames"] is first["device_frames"]
    np.testing.assert_array_equal(again["pred_poses"], first["pred_poses"])
    assert again["upload_secs"] < 1.0


def test_dedup_refusals(scene, weights):
    with pytest.raises(ValueError, match="requires device_cache"):
        _port_run(scene, weights, dedup_frames=True)
    with pytest.raises(ValueError, match="per-frame"):
        _port_run(scene, weights, "posenet", device_cache=True,
                  dedup_frames=True)


@pytest.mark.parametrize("extra", [
    ["--device_cache"],
    ["--device_cache", "--no_frame_dedup", "--cache_frames", "0.1"],
    ["--device_cache", "--bf16"],
], ids=["dedup", "tuple_cached", "bf16"])
def test_cli_main_device_cache(scene, weights, extra):
    """``main()`` with --device_cache on the fixture's test split (256x341
    frames on the host, as the CLI resizes them) equals the loader path."""
    argv = [
        "--dataset", "7Scenes", "--scene", "heads", "--model", "mapnet",
        "--trunk", "resnet18", "--device", "cpu",
        "--weights", str(weights["mapnet"]),
        "--config_file", str(scene / "tiny.ini"), "--batch_size", "4",
        "--val", "--data_path", str(scene / "deepslam"),
        "--asset_root", str(scene / "assets"),
    ]
    res = port_eval.main(argv + extra)
    assert tuple(res["device_frames"].shape) == (N_FRAMES, 256, 341, 3)
    dedup = "--no_frame_dedup" not in extra
    assert res["dedup_slice"] is dedup
    assert res["frames_computed"] == (24 if dedup else 48)
    if "--bf16" not in extra:
        loader = port_eval.main(argv)
        np.testing.assert_allclose(res["pred_poses"], loader["pred_poses"],
                                   rtol=1e-5, atol=1e-5)


def test_cli_main_synth_device_cache(tmp_path, weights):
    ini = _make_verify_fixture().build(tmp_path / "s", n_frames=1) / "tiny.ini"
    res = port_eval.main([
        "--dataset", "synth", "--model", "mapnet", "--trunk", "resnet18",
        "--device", "cpu", "--weights", str(weights["mapnet"]),
        "--config_file", str(ini), "--batch_size", "8", "--val",
        "--device_cache",
    ])
    assert res["pred_poses"].shape == (64, 7)
    assert res["device_frames"].dtype == torch.float32   # host floats
    assert res["dedup_slice"] and res["frames_computed"] == 72


def test_cli_main_matches_jax_main(scene, weights):
    """Both CLIs with --device_cache on the fixture's test split at their
    own host transform (256x341 uint8), the same npz: targets
    exactly, translations within 1e-4 relative, the same epoch. At this
    size the random network's log-q outputs have norms of O(100), so the
    few 1e-6 of relative difference that the f32 sums leave move a unit
    quaternion by up to ~1e-4: quaternions are held within 1e-3."""
    argv = [
        "--dataset", "7Scenes", "--scene", "heads", "--model", "mapnet",
        "--trunk", "resnet18", "--weights", str(weights["mapnet"]),
        "--config_file", str(scene / "tiny.ini"), "--batch_size", "4",
        "--val", "--data_path", str(scene / "deepslam"),
        "--asset_root", str(scene / "assets"), "--device_cache",
    ]
    got = port_eval.main(argv + ["--device", "cpu"])
    jax_eval_module._SCAN_CACHE.clear()   # fault R1: no stale program
    want = jax_eval_module.main(argv)
    np.testing.assert_array_equal(got["targ_poses"], want["targ_poses"])
    np.testing.assert_allclose(got["pred_poses"][:, :3],
                               want["pred_poses"][:, :3], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["pred_poses"][:, 3:],
                               want["pred_poses"][:, 3:], atol=1e-3)
    np.testing.assert_allclose(got["median_t"], want["median_t"], rtol=1e-5)
    for k in ("frames_computed", "dedup_slice"):
        assert got.get(k) == want.get(k), k
