"""Experiment assembly for the port: model, transforms, device pipeline,
frame dataset.

The PyTorch counterpart of the eval parts of :mod:`geomapnet_tpu.cli.builders`:
7Scenes, the synthetic scene and RobotCar raw mosaics, each with its
ground-truth or VO ("real") poses. RobotCar's processed RGB frames are not
ported yet and raise ``NotImplementedError`` naming ROADMAP.md.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..data.transforms import ImageTransform, Normalize, std_from_stats
from ..models.posenet import MapNet, PoseNet
from ..models.resnet import resnet18, resnet34, resnet50
from .config import ExperimentConfig

__all__ = [
    "build_model",
    "build_transform",
    "build_device_preprocess",
    "build_raw_device_preprocess",
    "build_frame_dataset",
]

TRUNKS = {"resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50}


def build_model(model_name: str, config: ExperimentConfig,
                trunk: str = "resnet34", dtype: torch.dtype = torch.float32
                ) -> tuple[torch.nn.Module, bool]:
    """Returns (module, is_tuple_model): a PoseNet, or a MapNet around one,
    with the ``trunk`` feature extractor, ``config.dropout`` and compute
    ``dtype`` (float32 parameters either way)."""
    if trunk not in TRUNKS:
        raise ValueError(
            f"unknown trunk {trunk!r}; pick from {sorted(TRUNKS)}")
    posenet = PoseNet(feature_extractor=TRUNKS[trunk](dtype),
                      droprate=config.dropout, dtype=dtype)
    if model_name == "posenet":
        return posenet, False
    if model_name in ("mapnet", "mapnet++"):
        # MapNet++ differs from MapNet in training only
        return MapNet(posenet), True
    raise ValueError(f"unknown model {model_name!r}")


def build_transform(dataset: str, scene: str, config: ExperimentConfig,
                    asset_root: str = "data", train: bool = True,
                    seed: int = 7, keep_uint8: bool = False) -> ImageTransform:
    """Resize(256) [+ColorJitter] + Normalize(mean, sqrt(var)) pipeline
    (upstream scripts/train.py:114-128).

    With ``keep_uint8`` the host emits resized uint8 and normalization moves
    to the device (pair with :func:`build_device_preprocess`): 4x less
    host->device transfer per batch.
    """
    if dataset == "synth":
        return ImageTransform(resize=None, normalize=None)
    stats = np.loadtxt(Path(asset_root) / dataset / scene / "stats.txt")
    mean, std = std_from_stats(stats)
    return ImageTransform(
        resize=256,
        normalize=Normalize(mean, std),
        color_jitter_strength=config.color_jitter if train else 0.0,
        rng=np.random.RandomState(seed),
        keep_uint8=keep_uint8,
    )


def build_device_preprocess(dataset: str, scene: str,
                            asset_root: str = "data",
                            dtype: torch.dtype = torch.float32):
    """Device-side normalize for the uint8 host path (or None for synth).

    The returned function is closed over the scene's pixel stats: the host
    ships resized uint8 and ``(x/255 - mean)/std`` + the ``dtype`` cast run
    on the device, on whatever device the batch lives.
    """
    if dataset == "synth":
        return None
    from ..ops.image import normalize

    stats = np.loadtxt(Path(asset_root) / dataset / scene / "stats.txt")
    mean, std = std_from_stats(stats)
    mean = tuple(float(m) for m in mean)
    std = tuple(float(s) for s in std)

    def preprocess(images: torch.Tensor) -> torch.Tensor:
        return normalize(images, mean, std, dtype=dtype)

    return preprocess


def build_raw_device_preprocess(
    scene: str,
    asset_root: str = "data",
    dtype=torch.float32,
    raw_size: tuple[int, int] = (960, 1280),
    resize: int = 256,
):
    """RobotCar raw-mosaic pipeline: the host ships untouched Bayer uint8 and
    demosaic -> resize -> normalize run on the device
    (:func:`geomapnet_tpu_torch.ops.image.make_device_pipeline`, through the
    CUDA demosaic kernel on a card). Pair with
    :class:`geomapnet_tpu_torch.data.robotcar.RobotCar`."""
    from ..ops.image import make_device_pipeline, resize_shorter_side_shape

    stats = np.loadtxt(Path(asset_root) / "RobotCar" / scene / "stats.txt")
    mean, std = std_from_stats(stats)
    return make_device_pipeline(
        mean=tuple(float(m) for m in mean),
        std=tuple(float(s) for s in std),
        resize_to=resize_shorter_side_shape(*raw_size, resize),
        bayer=True,
        dtype=dtype,
    )


def build_frame_dataset(
    dataset: str,
    scene: str,
    data_path: str,
    train: bool,
    config: ExperimentConfig | None = None,
    transform=None,
    real: bool = False,
    skip_images: bool = False,
    asset_root: str = "data",
    vo_lib: str | None = None,
    raw_bayer: bool = False,
    cache_gb: float = 0.0,
):
    """Construct one frame dataset by name.

    ``real`` loads the VO poses of ``vo_lib`` (7Scenes: ``config.vo_lib``
    when None; RobotCar: "stereo" when None); ``skip_images`` builds a
    pose-only dataset (the ground truth of a real PGO run), whose RobotCar
    input type does not matter. ``cache_gb`` wraps the on-disk datasets in a
    decoded-frame RAM cache
    (:class:`~geomapnet_tpu_torch.data.cache.CachedScene`): image decode is
    paid once per process. Skipped with a message when the transform
    jitters (caching would freeze one draw).
    """
    config = config or ExperimentConfig()
    built = _build_frame_dataset(
        dataset, scene, data_path, train, config, transform, real,
        skip_images, asset_root, vo_lib, raw_bayer,
    )
    if cache_gb > 0 and dataset != "synth" and not skip_images:
        from ..data.cache import CachedScene

        try:
            built = CachedScene(built, max_bytes=int(cache_gb * 1024 ** 3))
        except ValueError as e:
            print(f"frame cache disabled for this split: {e}")
    return built


def _build_frame_dataset(
    dataset, scene, data_path, train, config, transform, real, skip_images,
    asset_root, vo_lib, raw_bayer,
):
    if dataset == "synth":
        from ..data.synthetic import SyntheticScene

        return SyntheticScene(
            n_frames=64, height=64, width=96, train=train, real=real,
            skip_images=skip_images, seed=config.seed,
        )
    if dataset == "7Scenes":
        from ..data.sevenscenes import SevenScenes

        return SevenScenes(
            scene=scene, data_path=data_path, train=train,
            transform=transform, seed=config.seed, real=real,
            skip_images=skip_images, vo_lib=vo_lib or config.vo_lib,
            asset_dir=str(Path(asset_root) / "7Scenes"),
        )
    if dataset == "RobotCar":
        if not (raw_bayer or skip_images):
            raise NotImplementedError(
                "RobotCar's processed-RGB frames are not ported yet "
                "(ROADMAP.md, Queue 1); use the raw Bayer mosaics")
        from ..data.robotcar import RobotCar

        return RobotCar(
            scene=scene, data_path=data_path, train=train,
            asset_dir=str(Path(asset_root) / "RobotCar"), real=real,
            skip_images=skip_images, vo_lib=vo_lib or "stereo",
        )
    raise ValueError(f"unknown dataset {dataset}")
