"""The MapNet+PGO eval (``pose_graph=True``) against the JAX package.

Both packages' ``evaluate()`` run the same scenes with the same npz weights
and PGO weights:

- 7Scenes: the verify fixture (tools/make_verify_fixture.py, 14 frames per
  sequence resized to 32x43) plus DSO VO poses and their alignment, which
  :func:`write_dso_vo` writes (``real``: frames and VOs from the DSO poses,
  absolute targets from the ground truth; chain VOs). On the loader path,
  the slice epoch and the int8 fused serving configuration (JAX without
  its mesh, its compiled-epoch cache cleared: ROADMAP.md Queue 3, R1).
- RobotCar raw-Bayer with ``real``, ``vo_lib = stereo``: a ``vo/vo.csv`` and
  ``stereo_vo_stats.pkl`` that :func:`write_stereo_vo` writes, all-pairs
  VOs.

Tolerances: targets exactly (the same numpy arithmetic); float32
translations within 1e-4 relative plus 1e-5 absolute (the f32 networks sum
in another order, and PGO is a well-conditioned float32 solve on top);
quaternions within 1e-3 (random weights give log-q outputs of norm O(100),
where 1e-6 relative moves a unit quaternion by ~1e-4); the int8 run within
1% of the largest translation, the bound of tests/test_torch_eval_int8.py
(its int8 activations are bit-equal to JAX's, its bf16 heads are not).
"""

import json
import pickle

import jax.numpy as jnp  # noqa: F401  (keeps JAX on the CPU, conftest)
import numpy as np
import pytest
import torch

import geomapnet_tpu.cli.eval as jax_eval_module
from geomapnet_tpu.cli import builders as jax_builders
from geomapnet_tpu.cli.config import ExperimentConfig
from geomapnet_tpu.data import MF as JaxMF
from geomapnet_tpu.data import vo_np as jax_vo_np
from geomapnet_tpu.data.robotcar import RobotCar as JaxRobotCar
from geomapnet_tpu.data.sevenscenes import SevenScenes as JaxSevenScenes
from geomapnet_tpu.data.transforms import ImageTransform as JaxImageTransform
from geomapnet_tpu.geometry import euler2mat
from geomapnet_tpu_torch.cli import builders
from geomapnet_tpu_torch.cli import eval as port_eval
from geomapnet_tpu_torch.data import vo_np
from geomapnet_tpu_torch.data.composite import MF
from geomapnet_tpu_torch.data.robotcar import RobotCar
from geomapnet_tpu_torch.data.sevenscenes import SevenScenes
from geomapnet_tpu_torch.data.transforms import ImageTransform
from geomapnet_tpu_torch.models.flax_import import (
    load_npz,
    variables_to_state_dict,
)
from test_torch_eval import (
    SEQ,
    _make_verify_fixture,
    jax_state,
    jax_tpu_branch_preprocess,
    seeded_npz,
    write_bayer_scene,
)

N_FRAMES = 14
STEPS, SKIP, BATCH = 5, 1, 2
PGO_W = dict(sax=1.0, saq=1.0, srx=2.0, srq=2.0)
SERVING = dict(quantize=True, calib_batches=2, quantize_heads=True,
               fuse_requant=True)
CPU = torch.device("cpu")
PGO_INI = """\
[training]
batch_size = 4
seed = 7
num_workers = 2

[hyperparameters]
dropout = 0.5
skip = 1
variable_skip = no
real = yes
steps = 5
vo_lib = dso
s_abs_trans = 1
s_abs_rot = 1
s_rel_trans = 2
s_rel_rot = 2
"""


def write_dso_vo(root, n, seq=2, seed=0):
    """DSO "real" poses for 7Scenes sequence ``seq`` under the asset root:
    ``dso_poses/seq-XX.txt`` (frame number, then the 3x4 [R|t] of each
    ground-truth pose perturbed by noise and mapped by the inverse of the
    alignment) and ``seq-XX/dso_vo_stats.pkl`` (the alignment)."""
    rng = np.random.RandomState(seed)
    gt_dir = root / "deepslam" / "7Scenes" / "heads" / f"seq-{seq:02d}"
    assets = root / "assets" / "7Scenes" / "heads"
    align = {"R": euler2mat(0, 0, 0.1), "t": np.array([0.05, -0.02, 0.01]),
             "s": 1.1}
    rows = []
    for i in range(n):
        pose = np.loadtxt(gt_dir / f"frame-{i:06d}.pose.txt")
        R = pose[:3, :3] @ euler2mat(*(rng.randn(3) * 0.02))
        t = (pose[:3, 3] + rng.randn(3) * 0.02 - align["t"]) / align["s"]
        rows.append(np.concatenate([[i], np.concatenate(
            [align["R"].T @ R, (align["R"].T @ t)[:, None]], 1).ravel()]))
    (assets / "dso_poses").mkdir(parents=True, exist_ok=True)
    np.savetxt(assets / "dso_poses" / f"seq-{seq:02d}.txt", np.stack(rows))
    (assets / f"seq-{seq:02d}").mkdir(exist_ok=True)
    with open(assets / f"seq-{seq:02d}" / "dso_vo_stats.pkl", "wb") as f:
        pickle.dump(align, f)


def write_stereo_vo(raw, assets, n, seed=0):
    """A RobotCar ``vo/vo.csv`` for the ``write_bayer_scene`` sequence (one
    relative motion per frame, keyed by the later frame's timestamp) and its
    ``stereo_vo_stats.pkl`` alignment."""
    rng = np.random.RandomState(seed)
    seq = raw / "loop" / SEQ
    (seq / "vo").mkdir()
    with open(seq / "vo" / "vo.csv", "w") as f:
        f.write("source_timestamp,destination_timestamp,x,y,z,roll,pitch,"
                "yaw\n")
        for i in range(n):
            motion = [1.0, 0.5, -0.1, 0, 0, 0] + rng.randn(6) * [
                0.05, 0.05, 0.01, 0.01, 0.01, 0.05]
            f.write(f"{1000 * (i + 1)},{1000 * i},"
                    + ",".join(str(v) for v in motion) + "\n")
    (assets / "RobotCar" / "loop" / SEQ).mkdir(parents=True)
    with open(assets / "RobotCar" / "loop" / SEQ / "stereo_vo_stats.pkl",
              "wb") as f:
        pickle.dump({"R": euler2mat(0, 0, 0.2), "t": np.array([3.0, -1, 0]),
                     "s": 0.9}, f)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = _make_verify_fixture().build(tmp_path_factory.mktemp("7s"),
                                        n_frames=N_FRAMES)
    write_dso_vo(root, N_FRAMES)
    SevenScenes("heads", str(root / "deepslam" / "7Scenes"), train=True,
                asset_dir=str(root / "assets" / "7Scenes"))
    (root / "pgo.ini").write_text(PGO_INI)
    return root


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "mapnet.npz"
    seeded_npz(path, "mapnet", ExperimentConfig(), "resnet18")
    return path


def _pose_stats(root, dataset="7Scenes", scene="heads"):
    return tuple(np.loadtxt(root / "assets" / dataset / scene
                            / "pose_stats.txt"))


def _7scenes_mf(scene, pkg):
    """The port's (pkg "port") or JAX's real DSO tuple dataset with VOs."""
    cls, tf_cls, mf_cls, vo = (
        (SevenScenes, ImageTransform, MF, vo_np) if pkg == "port"
        else (JaxSevenScenes, JaxImageTransform, JaxMF, jax_vo_np))
    data = str(scene / "deepslam" / "7Scenes")
    assets = str(scene / "assets" / "7Scenes")
    frames = cls("heads", data, train=False, real=True, vo_lib="dso",
                 transform=tf_cls(resize=32, keep_uint8=True),
                 asset_dir=assets)
    gt = cls("heads", data, train=False, skip_images=True, asset_dir=assets)
    return mf_cls(frames, steps=STEPS, skip=SKIP, include_vos=True, real=True,
                  gt_dataset=gt, vo_func=vo.vos_logq_np)


def _port_model(npz):
    model, _ = builders.build_model("mapnet", ExperimentConfig(),
                                    trunk="resnet18")
    model.posenet.load_state_dict(variables_to_state_dict(load_npz(str(npz))))
    return model


def _port_7scenes(scene, npz, **kw):
    pre = builders.build_device_preprocess("7Scenes", "heads",
                                           str(scene / "assets"))
    kw = {"pose_graph": True, "pgo_weights": PGO_W, **kw}
    return port_eval.evaluate(
        _port_model(npz), _7scenes_mf(scene, "port"), CPU, batch_size=BATCH,
        pose_stats=_pose_stats(scene), progress=False, preprocess=pre, **kw)


def _jax_7scenes(scene, npz, **kw):
    model, _ = jax_builders.build_model("mapnet", ExperimentConfig(),
                                        trunk="resnet18")
    pre = jax_builders.build_device_preprocess("7Scenes", "heads",
                                               str(scene / "assets"))
    jax_eval_module._SCAN_CACHE.clear()   # fault R1: no stale program
    return jax_eval_module.evaluate(
        model, jax_state(npz, True), _7scenes_mf(scene, "jax"),
        batch_size=BATCH, pose_stats=_pose_stats(scene), progress=False,
        preprocess=pre, use_mesh=False, pose_graph=True, pgo_weights=PGO_W,
        **kw)


def _assert_pgo_matches(got, want, int8=False):
    np.testing.assert_array_equal(got["targ_poses"], want["targ_poses"])
    t_got, t_want = got["pred_poses"][:, :3], want["pred_poses"][:, :3]
    scale = np.abs(t_want).max()
    assert scale > 0.1 and np.isfinite(got["pred_poses"]).all()
    if int8:
        np.testing.assert_allclose(t_got, t_want, rtol=0, atol=0.01 * scale)
        return
    np.testing.assert_allclose(t_got, t_want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["pred_poses"][:, 3:],
                               want["pred_poses"][:, 3:], rtol=0, atol=1e-3)
    for k in ("median_t", "mean_t"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(device_cache=True),
    dict(device_cache=True, **SERVING),
], ids=["loader", "slice", "int8_fused"])
def test_7scenes_pgo_matches_jax(scene, npz, kw):
    got = _port_7scenes(scene, npz, **kw)
    want = _jax_7scenes(scene, npz, **kw)
    assert got["pgo_secs"] > 0
    for k in ("frames_computed", "dedup_slice"):
        assert got.get(k) == want.get(k), k
    if kw.get("device_cache"):
        assert got["dedup_slice"]     # U = 14 >= B*T = 10: the slice epoch
    _assert_pgo_matches(got, want, int8="quantize" in kw)


def test_pgo_moves_the_poses(scene, npz):
    """The same eval without PGO: the same targets, and PGO moves every
    predicted translation."""
    pgo = _port_7scenes(scene, npz)
    plain = _port_7scenes(scene, npz, pose_graph=False)
    np.testing.assert_array_equal(pgo["targ_poses"], plain["targ_poses"])
    assert (np.abs(pgo["pred_poses"][:, :3] - plain["pred_poses"][:, :3])
            .max(axis=1) > 1e-6).all()
    assert "pgo_secs" not in plain


def test_pose_graph_needs_vos(scene, npz):
    ds = _7scenes_mf(scene, "port")
    ds.include_vos = False
    with pytest.raises(ValueError, match="include_vos"):
        port_eval.evaluate(_port_model(npz), ds, CPU, batch_size=BATCH,
                           progress=False, pose_graph=True)


def test_robotcar_stereo_vo_pgo_matches_jax(tmp_path, monkeypatch, npz):
    """RobotCar raw Bayer, ``real`` stereo VO (integrated ``vo.csv``,
    aligned by its pickle), all-pairs VOs, the RobotCar config's weights;
    the ground-truth dataset is pose-only."""
    raw, assets = write_bayer_scene(tmp_path, n=10, h=32, w=48)
    write_stereo_vo(raw, assets, n=10)
    rc = str(assets / "RobotCar")
    RobotCar("loop", str(raw), train=True, asset_dir=rc, raw_size=(32, 48))
    weights = dict(sax=1.0, saq=1.0, srx=20.0, srq=20.0)
    stats = tuple(np.loadtxt(assets / "RobotCar" / "loop"
                             / "pose_stats.txt"))

    frames = RobotCar("loop", str(raw), train=False, asset_dir=rc,
                      raw_size=(32, 48), real=True, vo_lib="stereo")
    gt = builders.build_frame_dataset(
        "RobotCar", "loop", str(raw), False, skip_images=True,
        asset_root=str(assets))
    assert gt.get_image(0) is None
    ds = MF(frames, steps=3, skip=2, include_vos=True, real=True,
            gt_dataset=gt, vo_func=vo_np.vos_logq_fc_np)
    got = port_eval.evaluate(
        _port_model(npz), ds, CPU, batch_size=4, pose_stats=stats,
        progress=False, pose_graph=True, fc_vos=True, pgo_weights=weights,
        preprocess=builders.build_raw_device_preprocess(
            "loop", str(assets), raw_size=(32, 48), resize=8))

    jframes = JaxRobotCar("loop", str(raw), train=False, asset_dir=rc,
                          raw_bayer=True, raw_size=(32, 48), real=True,
                          vo_lib="stereo")
    jgt = JaxRobotCar("loop", str(raw), train=False, asset_dir=rc,
                      skip_images=True)
    np.testing.assert_array_equal(frames.poses, jframes.poses)
    jds = JaxMF(jframes, steps=3, skip=2, include_vos=True, real=True,
                gt_dataset=jgt, vo_func=jax_vo_np.vos_logq_fc_np)
    jmodel, _ = jax_builders.build_model("mapnet", ExperimentConfig(),
                                         trunk="resnet18")
    want = jax_eval_module.evaluate(
        jmodel, jax_state(npz, True), jds, batch_size=4, pose_stats=stats,
        progress=False, use_mesh=False, pose_graph=True, fc_vos=True,
        pgo_weights=weights,
        preprocess=jax_tpu_branch_preprocess(monkeypatch, assets, (32, 48),
                                             8))
    assert ds[0][1].shape == (3 + 3, 6)     # 3 absolute poses + 3 pairs
    _assert_pgo_matches(got, want)


def test_cli_pose_graph_matches_jax_main(scene, npz, tmp_path):
    """``main()`` with ``--pose_graph`` (``--model mapnet++``, which
    evaluates as MapNet) on the fixture's test split at 256x341 with a PGO
    config (real DSO poses, steps 5, s_rel 2), from the device cache, on
    the CPU: the same results as the JAX CLI, outputs named ``_pgo``."""
    argv = [
        "--dataset", "7Scenes", "--scene", "heads", "--model", "mapnet++",
        "--trunk", "resnet18", "--weights", str(npz),
        "--config_file", str(scene / "pgo.ini"), "--batch_size", "4",
        "--val", "--data_path", str(scene / "deepslam"),
        "--asset_root", str(scene / "assets"), "--pose_graph",
        "--device_cache",
    ]
    got = port_eval.main(argv + ["--device", "cpu",
                                 "--output_dir", str(tmp_path)])
    saved = json.loads((tmp_path / "7Scenes_heads_mapnet++_pgo_metrics.json")
                       .read_text())
    assert saved["median_t"] == got["median_t"]
    assert got["pred_poses"].shape == (N_FRAMES, 7)
    jax_eval_module._SCAN_CACHE.clear()   # fault R1: no stale program
    want = jax_eval_module.main(argv)
    _assert_pgo_matches(got, want)
