"""The tools CLI (geomapnet_tpu_torch.cli.tools) against the JAX package's.

Each ported subcommand runs through both CLIs on the same fixture (the
7Scenes verify fixture, a RobotCar sequence of tests/test_torch_eval.py),
each package writing into its own copy of the asset root, and the files
they write must be equal: ``pose_stats.txt``, ``stats.txt``, the
``*_vo_stats.pkl`` alignments (7Scenes DSO, RobotCar stereo VO),
``gps_ins.csv``, the processed RobotCar images and the reversed VO file.
``export_model`` writes artifacts that agree through both packages'
loaders; ``time_imload`` times every stage on the CPU; ``plot_vo_poses``
prints JAX's errors and writes its figure, and refuses ``--output`` at
once where matplotlib is missing.
"""

import pickle
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from geomapnet_tpu.cli import builders as jax_builders
from geomapnet_tpu.cli import tools as jax_tools
from geomapnet_tpu.cli.config import ExperimentConfig
from geomapnet_tpu.cli.config import parse_ini as jax_parse_ini
from geomapnet_tpu.models.torch_import import load_npz as jax_load_npz
from geomapnet_tpu.serving import load_inference as jax_load
from geomapnet_tpu.train.checkpoint import save_checkpoint
from geomapnet_tpu.train.optim import make_optimizer
from geomapnet_tpu.train.state import create_train_state
from geomapnet_tpu_torch import serving
from geomapnet_tpu_torch.cli import tools
from test_torch_eval import SEQ, _make_verify_fixture, seeded_npz, \
    write_bayer_scene
from test_torch_eval_pgo import write_stereo_vo
from test_torch_robotcar_rgb import write_camera_models
from test_torch_train_step import one_torch_thread  # noqa: F401

N = 6


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = _make_verify_fixture().build(tmp_path_factory.mktemp("7s"),
                                        n_frames=N)
    rng = np.random.RandomState(4)
    table = []
    for i in range(1, N):   # DSO poses of seq-01's frames 1..N-1
        pose = np.loadtxt(root / "deepslam" / "7Scenes" / "heads" / "seq-01"
                          / f"frame-{i:06d}.pose.txt")[:3]
        pose[:, 3] = 0.8 * pose[:, 3] + rng.randn(3) * 0.01 + [0.3, 0, -0.1]
        table.append(np.concatenate([[i], pose.ravel()]))
    dso = root / "assets" / "7Scenes" / "heads" / "dso_poses"
    dso.mkdir()
    np.savetxt(dso / "seq-01.txt", np.asarray(table))
    return root


def _both(tmp_path, assets, argv):
    """Run ``argv`` through both CLIs, each on its own copy of ``assets``;
    returns the two asset roots (port, JAX)."""
    roots = []
    for name, cli in (("port", tools), ("jax", jax_tools)):
        dst = tmp_path / name
        shutil.copytree(assets, dst)
        cli.main(argv + ["--asset_root", str(dst)])
        roots.append(dst)
    return roots


def _seven_argv(scene, cmd):
    return [cmd, "--dataset", "7Scenes", "--scene", "heads",
            "--data_path", str(scene / "deepslam" / "7Scenes")]


@pytest.mark.parametrize("cmd,out", [
    ("calc_pose_stats", "7Scenes/heads/pose_stats.txt"),
    ("dataset_mean", "7Scenes/heads/stats.txt"),
])
def test_scene_statistics_equal_jax(scene, tmp_path, cmd, out):
    port, jax_root = _both(tmp_path, scene / "assets", _seven_argv(scene, cmd))
    assert (port / out).read_bytes() == (jax_root / out).read_bytes()
    if cmd == "dataset_mean":
        assert (port / out).read_bytes() != \
            (scene / "assets" / out).read_bytes()


def _assert_pickles_equal(a, b):
    with open(a, "rb") as f:
        got = pickle.load(f)
    with open(b, "rb") as f:
        want = pickle.load(f)
    assert got.keys() == want.keys() == {"R", "t", "s"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_align_vo_poses_7scenes_equal_jax(scene, tmp_path):
    port, jax_root = _both(tmp_path, scene / "assets",
                           _seven_argv(scene, "align_vo_poses")
                           + ["--seq", "1", "--vo_lib", "dso"])
    rel = "7Scenes/heads/seq-01/dso_vo_stats.pkl"
    _assert_pickles_equal(port / rel, jax_root / rel)


def _robotcar(tmp_path, n=6):
    raw, assets = write_bayer_scene(tmp_path / "rc", n=n, h=8, w=12)
    write_stereo_vo(raw, assets, n=n)
    with open(raw / "loop" / SEQ / "gps" / "gps.csv", "w") as f:
        f.write("timestamp,latitude,longitude,altitude,northing,easting,"
                "down,utm_zone\n")
        for i in range(n):
            f.write(f"{1000 * (i + 1)},51.7,-1.2,{100 + i},"
                    f"{5e6 + i * 0.9},{6e5 + i * 0.4},{-1.0 - 0.1 * i},30U\n")
    return raw, assets


def test_robotcar_tools_equal_jax(tmp_path):
    """process_robotcar_gps, then align_vo_poses on the stereo VO and on
    the GPS the first wrote."""
    raw, assets = _robotcar(tmp_path)
    outs = []
    for cli in (tools, jax_tools):
        cli.main(["process_robotcar_gps", "--dataset", "RobotCar", "--scene",
                  "loop", "--data_path", str(raw), "--seq", SEQ])
        gps_ins = raw / "loop" / SEQ / "gps" / "gps_ins.csv"
        outs.append(gps_ins.read_bytes())
        gps_ins.unlink()
    assert outs[0] == outs[1] and outs[0].count(b"\n") == 7
    tools.main(["process_robotcar_gps", "--dataset", "RobotCar", "--scene",
                "loop", "--data_path", str(raw), "--seq", SEQ])
    for vo_lib in ("stereo", "gps"):
        port, jax_root = _both(
            tmp_path / vo_lib, assets,
            ["align_vo_poses", "--dataset", "RobotCar", "--scene", "loop",
             "--data_path", str(raw), "--seq", SEQ, "--vo_lib", vo_lib])
        rel = f"RobotCar/loop/{SEQ}/{vo_lib}_vo_stats.pkl"
        _assert_pickles_equal(port / rel, jax_root / rel)


def test_process_robotcar_images_equal_jax(tmp_path):
    raw, _ = write_bayer_scene(tmp_path / "rc", n=3, h=16, w=24)
    models = write_camera_models(tmp_path / "models", 16, 24)
    out_dir = raw / "loop" / SEQ / "stereo" / "centre_processed"
    written = []
    for cli in (tools, jax_tools):
        cli.main(["process_robotcar_images", "--dataset", "RobotCar",
                  "--scene", "loop", "--data_path", str(raw), "--seq", SEQ,
                  "--camera_models", str(models)])
        files = sorted(out_dir.glob("*.png"))
        written.append([np.asarray(Image.open(p)) for p in files])
        shutil.rmtree(out_dir)
    assert len(written[0]) == len(written[1]) == 3
    for a, b in zip(*written):
        assert a.shape == (256, 384, 3)
        np.testing.assert_array_equal(a, b)


def test_reverse_vo_poses_equal_jax(tmp_path):
    rng = np.random.RandomState(5)
    rows = []
    for i in range(7):
        R = np.linalg.qr(rng.randn(3, 3))[0]
        R *= np.sign(np.linalg.det(R))
        rows.append(np.concatenate([[i + 3], np.concatenate(
            [R, rng.randn(3, 1)], axis=1).ravel()]))
    np.savetxt(tmp_path / "vo.txt", np.asarray(rows))
    for name, cli in (("port", tools), ("jax", jax_tools)):
        cli.main(["reverse_vo_poses", "--input", str(tmp_path / "vo.txt"),
                  "--output", str(tmp_path / f"{name}.txt")])
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()


def test_time_imload_on_the_cpu(tmp_path, capsys):
    """Every stage is timed; the device pipeline on the CPU here takes the
    demosaic kernel's plain version (the image's half fits 256)."""
    Image.fromarray(np.random.RandomState(6).randint(
        0, 256, (600, 800), dtype=np.uint8), mode="L").save(tmp_path / "m.png")
    tools.main(["time_imload", "--image", str(tmp_path / "m.png"),
                "--number", "4", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    for line in ("native decoder: built, batch-read backend",
                 "native decode (B=2, 4 threads)", "plain decode:",
                 "host demosaic:",
                 "device pipeline (B=2, 600x800 -> 256x341, cpu)"):
        assert line in out, out


def test_plot_vo_poses_is_refused(capsys, monkeypatch, tmp_path):
    """``--output`` without matplotlib is refused before any work, naming
    the package (the user asked for that file)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit) as exc:
        tools.main(["plot_vo_poses", "--dataset", "7Scenes", "--scene",
                    "heads", "--data_path", str(tmp_path / "absent"),
                    "--output", str(tmp_path / "vo.png")])
    assert exc.value.code == 2
    assert "needs matplotlib" in capsys.readouterr().err
    assert not (tmp_path / "vo.png").exists()


def test_plot_vo_poses_equals_jax(scene, tmp_path, capsys):
    """The aligned DSO poses against the ground truth: the port prints the
    JAX tool's error lines, and both write their figure."""
    pytest.importorskip("matplotlib")
    out = {}
    for name, cli in (("port", tools), ("jax", jax_tools)):
        root = tmp_path / name
        shutil.copytree(scene / "assets", root)
        for argv in (_seven_argv(scene, "calc_pose_stats"),
                     _seven_argv(scene, "align_vo_poses")
                     + ["--seq", "1", "--vo_lib", "dso"]):
            cli.main(argv + ["--asset_root", str(root)])
        capsys.readouterr()
        cli.main(_seven_argv(scene, "plot_vo_poses")
                 + ["--vo_lib", "dso", "--asset_root", str(root),
                    "--output", str(tmp_path / f"{name}.png")])
        out[name] = capsys.readouterr().out
        with Image.open(tmp_path / f"{name}.png") as im:
            assert im.size[0] > 0
    lines = [ln for ln in out["port"].splitlines() if "error:" in ln]
    assert len(lines) == 2
    assert lines == [ln for ln in out["jax"].splitlines() if "error:" in ln]


def _jax_checkpoint(npz, config, tmp_path):
    """The npz's weights as an orbax checkpoint of a JAX TrainState (what
    the JAX CLI's ``--weights`` reads)."""
    model, _ = jax_builders.build_model("mapnet", config, trunk="resnet18")
    criterion, _ = jax_builders.build_criteria("mapnet", config, False, False)
    state = create_train_state(
        model, criterion, make_optimizer(config.opt, config.lr),
        jax.random.PRNGKey(0), jnp.zeros((1, config.steps, 32, 32, 3)))
    v = jax_load_npz(str(npz))
    params = dict(state.params)
    params["model"] = {"posenet": v["params"]}
    state = state.replace(params=params,
                          batch_stats={"posenet": v["batch_stats"]})
    return save_checkpoint(tmp_path / "jax_logs", 0, state)


def test_export_model_equals_jax(scene, tmp_path):
    """``export_model`` of the same MapNet weights (the port from the npz,
    JAX from an orbax checkpoint of them), uint8 normalize fused: the two
    artifacts agree within 1e-4 through their own loaders, at batch 1 and
    3; ``--quantize int8`` exports too."""
    config = ExperimentConfig()
    npz = tmp_path / "w.npz"
    seeded_npz(npz, "mapnet", config, "resnet18")
    ini = scene / "tiny.ini"
    common = ["export_model", "--dataset", "7Scenes", "--scene", "heads",
              "--asset_root", str(scene / "assets"), "--model", "mapnet",
              "--trunk", "resnet18", "--config_file", str(ini),
              "--height", "32", "--width", "43", "--platforms", "cpu"]
    tools.main(common + ["--weights", str(npz),
                         "--output", str(tmp_path / "port.pt2")])
    ckpt = _jax_checkpoint(npz, jax_parse_ini(str(ini)), tmp_path)
    jax_tools.main(common + ["--weights", str(ckpt),
                             "--output", str(tmp_path / "jax.shlo")])
    port = serving.load_inference(tmp_path / "port.pt2", "cpu")
    want_fn = jax_load(tmp_path / "jax.shlo")
    steps = jax_parse_ini(str(ini)).steps
    for b in (1, 3):
        u8 = np.random.RandomState(b).randint(
            0, 256, (b, steps, 32, 43, 3)).astype(np.uint8)
        import torch

        got = port(torch.from_numpy(u8)).numpy()
        want = np.asarray(want_fn(u8))
        assert got.shape == want.shape == (b, steps, 6)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    tools.main(common + ["--weights", str(npz), "--quantize", "int8",
                         "--output", str(tmp_path / "int8.pt2")])
    q = serving.load_inference(tmp_path / "int8.pt2", "cpu")
    assert q(torch.from_numpy(u8)).shape == (3, steps, 6)
