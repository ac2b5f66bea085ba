"""RobotCar's processed-RGB input, the full demosaic and the undistortion,
in the port against the JAX package.

- ``ops.image.demosaic`` (the full-resolution bilinear GBRG demosaic),
  ``precompute_undistort_maps`` and ``undistort`` against JAX's on random
  mosaics and a synthetic camera LUT (smooth distortion, some source points
  past the image edge): the maps exactly, the images within 1e-5 of 255.
- ``make_device_pipeline``'s branches that do not run the demosaic kernel,
  against JAX's (which takes the same branch on every backend): mosaics
  with undistortion maps (``demosaic -> undistort -> resize_bilinear ->
  normalize``), a full-resolution mosaic (no resize), a target larger than
  half the mosaic, and RGB with maps; within 1e-5 on the normalized
  output. With maps the demosaic kernel is never called.
- ``cli.builders.build_raw_device_preprocess(camera_models_dir=...)``
  against JAX's on the written camera models.
- ``RobotCar`` items against JAX's: the processed RGB frames through the
  host transform (and a target transform), with ground-truth and
  stereo-VO poses; mosaics demosaiced and undistorted on the host
  (``undistort=True``); and the RGB frame datasets the builders make.
- The CLIs: ``cli.train`` and ``cli.eval`` on RobotCar RGB frames, and
  with ``--raw_bayer --camera_models_dir`` at the camera's native size.
"""

import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomapnet_tpu.cli import builders as jax_builders
from geomapnet_tpu.cli.config import ExperimentConfig
from geomapnet_tpu.data.robotcar import RobotCar as JaxRobotCar
from geomapnet_tpu.data.transforms import ImageTransform as JaxImageTransform
from geomapnet_tpu.data.transforms import Normalize as JaxNormalize
from geomapnet_tpu.ops import image as jax_image
from geomapnet_tpu_torch.cli import builders
from geomapnet_tpu_torch.cli import eval as cli_eval
from geomapnet_tpu_torch.cli import train as cli_train
from geomapnet_tpu_torch.cli.config import ExperimentConfig as PortConfig
from geomapnet_tpu_torch.data.robotcar import RobotCar
from geomapnet_tpu_torch.data.transforms import ImageTransform, Normalize
from geomapnet_tpu_torch.ops import cuda_image
from geomapnet_tpu_torch.ops import image as port_image
from test_torch_eval import SEQ, write_bayer_scene
from test_torch_eval_pgo import write_stereo_vo
# an autouse fixture: one torch thread while this module runs
from test_torch_train_step import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
MEAN, STD = (0.45, 0.45, 0.46), (0.28, 0.28, 0.27)


def camera_lut(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A (2, h*w) float64 LUT of source coordinates: a smooth radial
    distortion plus a little noise, reaching past the image's edges."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = (h - 1) / 2, (w - 1) / 2
    r2 = ((yy - cy) / h) ** 2 + ((xx - cx) / w) ** 2
    k = 1.0 + 0.3 * r2
    lx = cx + (xx - cx) * k + rs.uniform(-0.3, 0.3, (h, w))
    ly = cy + (yy - cy) * k + rs.uniform(-0.3, 0.3, (h, w))
    return np.stack([lx.ravel(), ly.ravel()])


def write_camera_models(d: Path, h: int, w: int) -> Path:
    """The SDK's model files of the stereo centre camera: intrinsics and
    the distortion LUT."""
    d.mkdir(parents=True, exist_ok=True)
    np.savetxt(d / "stereo_narrow_left.txt",
               np.asarray([[400.0, 400.0, w / 2, h / 2]]))
    camera_lut(h, w).tofile(d / "stereo_narrow_left_distortion_lut.bin")
    return d


def _mosaics(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)


# --------------------------------------------------------------------------
# the ops


@pytest.mark.parametrize("shape", [(2, 8, 12), (1, 16, 24), (3, 6, 10)])
def test_demosaic_matches_jax(shape):
    raw = _mosaics(shape, seed=sum(shape))
    want = np.asarray(jax_image.demosaic(jnp.asarray(raw)))
    got = port_image.demosaic(torch.from_numpy(raw)).numpy()
    assert got.shape == want.shape == shape + (3,)
    assert np.abs(got - want).max() <= 1e-5 * 255


def test_undistort_matches_jax():
    h, w = 16, 24
    lut = camera_lut(h, w)
    want_maps = jax_image.precompute_undistort_maps(lut, h, w)
    maps = port_image.precompute_undistort_maps(lut, h, w)
    for a, b in zip(maps, want_maps, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    img = np.random.RandomState(1).uniform(0, 255, (2, h, w, 3)).astype(
        np.float32)
    want = np.asarray(jax_image.undistort(jnp.asarray(img), *want_maps))
    got = port_image.undistort(torch.from_numpy(img), *maps).numpy()
    assert np.abs(got - want).max() <= 1e-5 * 255
    # the maps as tensors give the same images
    tmaps = [torch.from_numpy(np.asarray(m)) for m in maps]
    assert torch.equal(port_image.undistort(torch.from_numpy(img), *tmaps),
                       torch.from_numpy(got))


PIPELINES = {
    "bayer_undistort": dict(bayer=True, resize_to=(8, 12), maps=True),
    "bayer_undistort_tuples": dict(bayer=True, resize_to=(8, 12), maps=True,
                                   tuples=True),
    "bayer_full_resolution": dict(bayer=True, resize_to=None, maps=False),
    "bayer_upsampling": dict(bayer=True, resize_to=(10, 14), maps=False),
    "rgb_undistort": dict(bayer=False, resize_to=(8, 12), maps=True),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_pipeline_branches_match_jax(name, monkeypatch):
    case = PIPELINES[name]
    h, w = 16, 24
    maps = (jax_image.precompute_undistort_maps(camera_lut(h, w), h, w)
            if case["maps"] else None)
    shape = (2, h, w) if case["bayer"] else (2, h, w, 3)
    if case.get("tuples"):
        shape = (2, 3) + shape[1:]
    raw = _mosaics(shape, seed=5)
    kw = dict(resize_to=case["resize_to"], undistort_maps=maps,
              bayer=case["bayer"])
    want = np.asarray(jax_image.make_device_pipeline(
        MEAN, STD, dtype=jnp.float32, **kw)(jnp.asarray(raw)))

    def no_kernel(*args, **kwargs):
        raise AssertionError("the demosaic kernel ran")

    # none of these branches runs the half-resolution demosaic kernel
    monkeypatch.setattr(cuda_image, "demosaic_half_normalize", no_kernel)
    got = port_image.make_device_pipeline(
        MEAN, STD, dtype=torch.float32, **kw)(torch.from_numpy(raw)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5


def test_raw_device_preprocess_with_camera_models(tmp_path):
    h, w = 16, 24
    models = write_camera_models(tmp_path / "models", h, w)
    _, assets = write_bayer_scene(tmp_path, n=2, h=h, w=w)
    kw = dict(raw_size=(h, w), resize=8, camera_models_dir=str(models))
    want = jax_builders.build_raw_device_preprocess(
        "loop", str(assets), dtype=jnp.float32, **kw)
    got = builders.build_raw_device_preprocess("loop", str(assets), **kw)
    raw = _mosaics((2, 3, h, w), seed=6)
    a = np.asarray(want(jnp.asarray(raw)))
    b = got(torch.from_numpy(raw)).numpy()
    assert a.shape == b.shape == (2, 3, 8, 12, 3)
    assert np.abs(a - b).max() <= 1e-5


# --------------------------------------------------------------------------
# the datasets


def write_rgb_scene(root: Path, n: int, h: int, w: int):
    """A RobotCar scene of ``n`` processed RGB frames (3-channel PNGs in
    ``stereo/centre``), with ground truth and stereo VO; returns (data
    root, assets root)."""
    from PIL import Image

    raw, assets = write_bayer_scene(root, n=n, h=h, w=w)
    rng = np.random.RandomState(3)
    for png in sorted((raw / "loop" / SEQ / "stereo" / "centre").glob(
            "*.png")):
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(png)
    write_stereo_vo(raw, assets, n=n)
    return raw, assets


def _transforms(train: bool):
    mean, std = np.asarray(MEAN), np.asarray(STD)
    kw = dict(resize=12, color_jitter_strength=0.4 if train else 0.0)
    return (ImageTransform(normalize=Normalize(mean, std),
                           rng=np.random.RandomState(7), **kw),
            JaxImageTransform(normalize=JaxNormalize(mean, std),
                              rng=np.random.RandomState(7), **kw))


@pytest.mark.parametrize("train,real", [(True, False), (False, True)])
def test_robotcar_rgb_items_match_jax(tmp_path, train, real):
    raw, assets = write_rgb_scene(tmp_path, n=6, h=16, w=24)
    rc = str(assets / "RobotCar")
    if not train:   # the ground-truth train split writes pose_stats.txt
        RobotCar("loop", str(raw), train=True, asset_dir=rc)
    tf, jtf = _transforms(train)
    kw = dict(real=real, asset_dir=rc, target_transform=lambda p: 2 * p)
    ours = RobotCar("loop", str(raw), train=train, transform=tf, **kw)
    theirs = JaxRobotCar("loop", str(raw), train=train, transform=jtf, **kw)
    assert len(ours) == len(theirs) == 6
    for i in range(len(ours)):
        (im, pose), (jim, jpose) = ours[i], theirs[i]
        assert im.shape == (12, 18, 3) and im.dtype == jim.dtype
        np.testing.assert_array_equal(im, jim)
        np.testing.assert_array_equal(pose, jpose)
        np.testing.assert_array_equal(pose, 2 * ours.poses[i])
    # no transform: the decoded image as it is
    plain = RobotCar("loop", str(raw), train=train, asset_dir=rc, real=real)
    assert plain.get_image(0).shape == (16, 24, 3)
    assert plain.get_images([0, 1], num_workers=2)[1].dtype == np.uint8


def test_robotcar_host_undistort_matches_jax(tmp_path):
    h, w = 16, 24
    raw, assets = write_bayer_scene(tmp_path, n=4, h=h, w=w)
    models = write_camera_models(tmp_path / "models", h, w)
    kw = dict(asset_dir=str(assets / "RobotCar"), undistort=True,
              camera_models_dir=str(models))
    ours = RobotCar("loop", str(raw), train=True, **kw)
    theirs = JaxRobotCar("loop", str(raw), train=True, **kw)
    for i in range(len(ours)):
        a, b = ours.get_image(i), theirs.get_image(i)
        assert a.shape == (h, w, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.poses, theirs.poses)


def test_builders_make_the_rgb_datasets(tmp_path):
    """``build_datasets`` for RobotCar without ``--raw_bayer``: the host
    transform (resize to 256, colour jitter on the train split, uint8 for
    the device normalize) and MF tuples, item for item JAX's."""
    raw, assets = write_rgb_scene(tmp_path, n=6, h=16, w=24)
    cfg = dict(steps=3, skip=1, seed=7, color_jitter=0.7)
    kw = dict(asset_root=str(assets), keep_uint8=True)
    ours = builders.build_datasets("mapnet", "RobotCar", "loop", str(raw),
                                   PortConfig(**cfg), **kw)
    theirs = jax_builders.build_datasets("mapnet", "RobotCar", "loop",
                                         str(raw), ExperimentConfig(**cfg),
                                         **kw)
    for a, b in zip(ours, theirs, strict=True):
        assert len(a) == len(b) == 6
        for i in range(len(a)):
            (im, p), (jim, jp) = a[i], b[i]
            assert im.shape == (3, 256, 384, 3) and im.dtype == np.uint8
            np.testing.assert_array_equal(im, jim)
            np.testing.assert_array_equal(p, jp)


# --------------------------------------------------------------------------
# the CLIs


def _ini(tmp_path: Path) -> Path:
    text = (REPO / "configs" / "mapnet.ini").read_text()
    for key, value in (("n_epochs", 1), ("snapshot", 1), ("batch_size", 2),
                       ("skip", 1), ("num_workers", 1), ("val_freq", 1),
                       ("color_jitter", 0), ("do_val", "no")):
        text = "\n".join(f"{key} = {value}" if ln.startswith(f"{key} =")
                         else ln for ln in text.split("\n"))
    path = tmp_path / "rc.ini"
    path.write_text(text)
    return path


@pytest.mark.parametrize("mode", ["rgb", "raw_bayer_camera_models"])
def test_cli_train_and_eval(tmp_path, mode, monkeypatch):
    n = 4 if mode == "rgb" else 2
    if mode == "rgb":
        raw, assets = write_rgb_scene(tmp_path, n=n, h=16, w=24)
        extra = []
    else:
        raw, assets = write_bayer_scene(tmp_path, n=n, h=960, w=1280)
        models = write_camera_models(tmp_path / "models", 960, 1280)
        extra = ["--raw_bayer", "--camera_models_dir", str(models)]

        def no_kernel(*args, **kwargs):
            raise AssertionError("the demosaic kernel ran")

        monkeypatch.setattr(cuda_image, "demosaic_half_normalize", no_kernel)
    data = tmp_path / "deepslam"
    (data / "RobotCar").mkdir(parents=True)
    (raw / "loop").rename(data / "RobotCar" / "loop")
    ini = _ini(tmp_path)
    base = ["--dataset", "RobotCar", "--scene", "loop", "--model", "mapnet",
            "--trunk", "resnet18", "--device", "cpu", "--config_file",
            str(ini), "--data_path", str(data), "--asset_root", str(assets)]
    cwd = Path.cwd()
    os.chdir(tmp_path)
    try:
        trainer = cli_train.main(base + extra)
        losses = [json.loads(ln)["loss"] for ln in
                  (trainer.logdir / "metrics.jsonl").read_text().splitlines()]
        assert losses and np.isfinite(losses).all()
        res = cli_eval.main(base + extra + [
            "--val", "--batch_size", "2",
            "--weights", str(trainer.logdir / "epoch_001.pth.tar")])
    finally:
        os.chdir(cwd)
    assert res["pred_poses"].shape == (n, 7)
    assert np.isfinite(res["pred_poses"]).all()
