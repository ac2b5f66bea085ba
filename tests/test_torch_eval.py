"""The slice as a whole: RobotCar raw-Bayer MapNet / PoseNet eval.

Both packages' ``evaluate()`` run over the same on-disk RobotCar scene of raw
mosaics with the same npz weights, and the port's CLI runs end to end on a
scene at the camera's native 960x1280.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomapnet_tpu.cli import builders as jax_builders
from geomapnet_tpu.cli.config import ExperimentConfig
from geomapnet_tpu.cli.eval import evaluate as jax_evaluate
from geomapnet_tpu.data import MF as JaxMF
from geomapnet_tpu.data.robotcar import RobotCar as JaxRobotCar
from geomapnet_tpu.models.torch_import import save_npz
from geomapnet_tpu.train.state import TrainState
from geomapnet_tpu_torch.cli import builders
from geomapnet_tpu_torch.cli import eval as port_eval
from geomapnet_tpu_torch.data.composite import MF
from geomapnet_tpu_torch.data.robotcar import RobotCar
from geomapnet_tpu_torch.models.flax_import import (
    load_npz,
    variables_to_state_dict,
)
from geomapnet_tpu_torch.ops import cuda_image

REPO = Path(__file__).resolve().parent.parent
SEQ = "2014-06-26-08-53-56"
INS_HEADER = ("timestamp,ins_status,latitude,longitude,altitude,northing,"
              "easting,down,utm_zone,velocity_north,velocity_east,"
              "velocity_down,roll,pitch,yaw")


def write_bayer_scene(root: Path, n: int, h: int, w: int) -> tuple[Path, Path]:
    """One RobotCar sequence of ``n`` raw (h, w) mosaics in the disk format
    of tests/test_robotcar.py (INS csv, stereo timestamps, grayscale PNGs);
    returns (data root, assets root)."""
    from PIL import Image

    scene = root / "raw" / "loop"
    seq = scene / SEQ
    (seq / "gps").mkdir(parents=True)
    (seq / "stereo" / "centre").mkdir(parents=True)
    ts = [1000 * (i + 1) for i in range(n)]
    (seq / "stereo.timestamps").write_text(
        "".join(f"{t} {i}\n" for i, t in enumerate(ts)))
    with open(seq / "gps" / "ins.csv", "w") as f:
        f.write(INS_HEADER + "\n")
        for i, t in enumerate(ts):
            f.write(f"{t},INS_SOLUTION_GOOD,0,0,0,{5e6 + i * 1.0},"
                    f"{6e5 + i * 0.5 + 0.3 * np.sin(i)},{-1.0 - 0.1 * i},30U,"
                    f"0,0,0,0,0,{0.05 * i}\n")
    rng = np.random.RandomState(1)
    for t in ts:
        Image.fromarray(rng.randint(0, 256, (h, w), dtype=np.uint8),
                        mode="L").save(seq / "stereo" / "centre" / f"{t}.png")
    (scene / "train_split.txt").write_text(SEQ + "\n")
    (scene / "test_split.txt").write_text(SEQ + "\n")
    assets = root / "assets"
    (assets / "RobotCar" / "loop").mkdir(parents=True)
    np.savetxt(assets / "RobotCar" / "loop" / "stats.txt",
               np.array([[0.45, 0.45, 0.46], [0.078, 0.077, 0.072]]))
    return root / "raw", assets


def seeded_npz(path: Path, model_name: str, config, trunk: str) -> None:
    """PoseNet-rooted Flax variables from a numpy seed (BN statistics
    included), written with the JAX package's ``save_npz``."""
    model, is_tuple = jax_builders.build_model(model_name, config,
                                               trunk=trunk)
    x = jnp.zeros((1, 1, 16, 16, 3) if is_tuple else (1, 16, 16, 3))
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    if is_tuple:
        variables = {k: v["posenet"] for k, v in variables.items()}
    rng = np.random.RandomState(0)

    def fill(p, leaf):
        name = p[-1].key
        if name == "kernel":
            v = rng.randn(*leaf.shape) * np.sqrt(
                2.0 / np.prod(leaf.shape[:-1]))
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            v = rng.randn(*leaf.shape) * 0.1
        return np.asarray(v, np.float32)

    save_npz(str(path), jax.tree_util.tree_map_with_path(fill, variables))


def jax_state(npz: Path, is_tuple: bool) -> TrainState:
    from geomapnet_tpu.models.torch_import import load_npz as jax_load_npz

    v = jax_load_npz(str(npz))
    if is_tuple:
        v = {k: {"posenet": t} for k, t in v.items()}
    return TrainState(step=jnp.zeros((), jnp.int32),
                      params={"model": v["params"]},
                      batch_stats=v["batch_stats"], opt_state=None)


def jax_tpu_branch_preprocess(monkeypatch, assets, raw_size, resize):
    """JAX's own ``build_raw_device_preprocess`` on its TPU branch (Pallas
    kernel, interpret mode here, then the matmul resize): the backend query
    reads "tpu" only while the pipeline is built."""
    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        return jax_builders.build_raw_device_preprocess(
            "loop", str(assets), dtype=jnp.float32, raw_size=raw_size,
            resize=resize)


@pytest.mark.parametrize("model_name", ["mapnet", "posenet"])
def test_evaluate_matches_jax(tmp_path, monkeypatch, model_name):
    """Same scene, weights and batches through both evaluate()s. Targets are
    the same numpy arithmetic, so they agree exactly. Predictions agree
    within 1e-4 relative (plus 1e-5 absolute): the f32 network sums in
    another order (tests/test_torch_models.py) and the demosaic kernel may
    differ by 1 ulp (tests/test_torch_ops_image.py). Rotation medians are
    not compared: on untrained weights they are ill-conditioned."""
    raw, assets = write_bayer_scene(tmp_path, n=10, h=32, w=48)
    config = ExperimentConfig(steps=3, skip=2, dropout=0.5)
    npz = tmp_path / "w.npz"
    seeded_npz(npz, model_name, config, "resnet18")
    is_tuple = model_name == "mapnet"

    jax_frames = JaxRobotCar("loop", str(raw), train=True,
                             asset_dir=str(assets / "RobotCar"),
                             raw_bayer=True, raw_size=(32, 48))
    jax_ds = JaxMF(jax_frames, steps=3, skip=2) if is_tuple else jax_frames
    jax_model, _ = jax_builders.build_model(model_name, config,
                                            trunk="resnet18")
    pose_stats = tuple(np.loadtxt(assets / "RobotCar" / "loop"
                                  / "pose_stats.txt"))
    want = jax_evaluate(
        jax_model, jax_state(npz, is_tuple), jax_ds, batch_size=4,
        pose_stats=pose_stats, progress=False, use_mesh=False,
        preprocess=jax_tpu_branch_preprocess(monkeypatch, assets, (32, 48),
                                             8))

    frames = RobotCar("loop", str(raw), train=True,
                      asset_dir=str(assets / "RobotCar"), raw_bayer=True,
                      raw_size=(32, 48))
    ds = MF(frames, steps=3, skip=2) if is_tuple else frames
    model, _ = builders.build_model(model_name, config, trunk="resnet18")
    (model.posenet if is_tuple else model).load_state_dict(
        variables_to_state_dict(load_npz(str(npz))))
    got = port_eval.evaluate(
        model, ds, torch.device("cpu"), batch_size=4, pose_stats=pose_stats,
        progress=False,
        preprocess=builders.build_raw_device_preprocess(
            "loop", str(assets), raw_size=(32, 48), resize=8))

    np.testing.assert_array_equal(got["targ_poses"], want["targ_poses"])
    assert np.abs(got["pred_poses"]).max() > 0.1   # not a degenerate output
    np.testing.assert_allclose(got["pred_poses"], want["pred_poses"],
                               rtol=1e-4, atol=1e-5)
    for k in ("median_t", "mean_t"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5)


def _make_verify_fixture():
    spec = importlib.util.spec_from_file_location(
        "make_verify_fixture", REPO / "tools" / "make_verify_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_main_native_resolution(tmp_path):
    """``cli.eval.main()`` end to end on the verify fixture's RobotCar scene
    (native 960x1280 mosaics), ResNet-18 MapNet on the CPU: every frame
    evaluated, finite errors, outputs written."""
    root = _make_verify_fixture().build_robotcar(tmp_path / "rc", n_frames=4)
    npz = tmp_path / "w.npz"
    seeded_npz(npz, "mapnet", ExperimentConfig(), "resnet18")
    before = cuda_image.launches
    res = port_eval.main([
        "--dataset", "RobotCar", "--scene", "loop", "--model", "mapnet",
        "--trunk", "resnet18", "--raw_bayer", "--device", "cpu",
        "--weights", str(npz), "--config_file", str(root / "tiny.ini"),
        "--batch_size", "4", "--data_path", str(root / "deepslam"),
        "--asset_root", str(root / "assets"),
        "--output_dir", str(tmp_path / "out"),
    ])
    assert res["pred_poses"].shape == res["targ_poses"].shape == (4, 7)
    assert np.isfinite(res["pred_poses"]).all()
    assert np.isfinite([res["median_t"], res["mean_t"]]).all()
    np.testing.assert_allclose(
        np.linalg.norm(res["pred_poses"][:, 3:], axis=1), 1.0, atol=1e-6)
    assert cuda_image.launches == before  # CPU tensors: plain version
    saved = json.loads(
        (tmp_path / "out" / "RobotCar_loop_mapnet_metrics.json").read_text())
    assert saved["median_t"] == res["median_t"]


def test_cli_refuses_silent_cpu(tmp_path, monkeypatch):
    """Without a card and without --device cpu the CLI stops."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        port_eval.main([
            "--dataset", "RobotCar", "--scene", "loop", "--model", "mapnet",
            "--raw_bayer", "--weights", str(tmp_path / "w.npz"),
            "--config_file", str(REPO / "configs" / "mapnet.ini"),
        ])


def test_unported_datasets_raise(tmp_path, monkeypatch):
    """Every dataset input is ported. The native decoder raises only where
    it cannot be built, with the compiler's message (here made to fail);
    tests/test_torch_native.py holds it to JAX's. RobotCar's processed RGB
    frames: the builders make the RGB dataset (tests/test_torch_robotcar_
    rgb.py holds it to JAX's), also for VO ("real") poses; a pose-only
    RobotCar dataset (the ground truth of a PGO run) needs no input type."""
    from geomapnet_tpu_torch import native
    from geomapnet_tpu_torch.data.sevenscenes import SevenScenes
    from test_torch_eval_pgo import write_stereo_vo

    with monkeypatch.context() as m:
        m.setattr(native, "_TRIED", True)
        m.setattr(native, "_LIB", None)
        m.setattr(native, "_ERROR", "g++: png.h: No such file or directory")
        with pytest.raises(RuntimeError, match="png.h"):
            SevenScenes("heads", str(tmp_path), True, use_native=True)
    raw, assets = write_bayer_scene(tmp_path, n=3, h=8, w=12)
    write_stereo_vo(raw, assets, n=3)
    for real in (False, True):
        rgb = builders.build_frame_dataset(
            "RobotCar", "loop", str(raw), True, real=real,
            asset_root=str(assets), raw_bayer=False)
        assert not rgb.raw_bayer and rgb.get_image(0).shape == (8, 12)
    gt = builders.build_frame_dataset("RobotCar", "loop", str(raw), True,
                                      skip_images=True,
                                      asset_root=str(assets))
    assert len(gt) == 3 and gt.get_image(0) is None
