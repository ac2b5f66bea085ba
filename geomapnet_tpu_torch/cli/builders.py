"""Experiment assembly for the port: model, criteria, transforms, device
pipeline, datasets, experiment name, device.

The PyTorch counterpart of :mod:`geomapnet_tpu.cli.builders`: 7Scenes, the
synthetic scene and RobotCar (processed RGB frames, or raw mosaics with the
device demosaic and, given camera models, the device undistortion), each
with its ground-truth or VO ("real") poses, for PoseNet, MapNet and
MapNet++.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..data.composite import MF, MFOnline
from ..data.transforms import ImageTransform, Normalize, std_from_stats
from ..data.vo_np import vos_logq_np
from ..losses.criterion import (
    MapNetCriterion,
    MapNetOnlineCriterion,
    PoseNetCriterion,
)
from ..models.posenet import MapNet, PoseNet
from ..models.resnet import resnet18, resnet34, resnet50
from .config import ExperimentConfig

__all__ = [
    "build_model",
    "build_criteria",
    "build_transform",
    "build_device_preprocess",
    "build_raw_device_preprocess",
    "build_frame_dataset",
    "build_datasets",
    "experiment_name",
    "pick_device",
]

TRUNKS = {"resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50}


def build_model(model_name: str, config: ExperimentConfig,
                trunk: str = "resnet34", dtype: torch.dtype = torch.float32,
                bn_bf16_bwd: bool = False) -> tuple[torch.nn.Module, bool]:
    """Returns (module, is_tuple_model): a PoseNet, or a MapNet around one,
    with the ``trunk`` feature extractor, ``config.dropout`` and compute
    ``dtype`` (float32 parameters either way); ``bn_bf16_bwd`` gives the
    trunk's BatchNorms the bfloat16 backward (forward unchanged). MapNet++
    guards its log-q head against NaN gradients (``filter_nans``)."""
    if trunk not in TRUNKS:
        raise ValueError(
            f"unknown trunk {trunk!r}; pick from {sorted(TRUNKS)}")
    posenet = PoseNet(
        feature_extractor=TRUNKS[trunk](dtype, bn_bf16_bwd=bn_bf16_bwd),
        droprate=config.dropout, dtype=dtype,
        filter_nans=model_name == "mapnet++")
    if model_name == "posenet":
        return posenet, False
    if model_name in ("mapnet", "mapnet++"):
        # MapNet++ differs from MapNet in training only
        return MapNet(posenet), True
    raise ValueError(f"unknown model {model_name!r}")


def build_criteria(model_name: str, config: ExperimentConfig,
                   learn_beta: bool, learn_gamma: bool):
    """(train_criterion, val_criterion) as upstream scripts/train.py:86-101
    builds them: sax/srx start at 0, beta/gamma seed saq/srq."""
    if model_name == "posenet":
        return (PoseNetCriterion(sax=0.0, saq=config.beta,
                                 learn_beta=learn_beta),
                PoseNetCriterion())
    if model_name == "mapnet":
        return (MapNetCriterion(sax=0.0, saq=config.beta, srx=0.0,
                                srq=config.gamma, learn_beta=learn_beta,
                                learn_gamma=learn_gamma),
                MapNetCriterion())
    if model_name == "mapnet++":
        gps = config.vo_lib == "gps"
        return (MapNetOnlineCriterion(sax=0.0, saq=config.beta, srx=0.0,
                                      srq=config.gamma, learn_beta=learn_beta,
                                      learn_gamma=learn_gamma, gps_mode=gps),
                MapNetOnlineCriterion(gps_mode=gps))
    raise ValueError(f"unknown model {model_name}")


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
    camera_models_dir: str | None = None,
):
    """RobotCar raw-mosaic pipeline: the host ships untouched Bayer uint8 and
    demosaic -> [undistort] -> resize -> normalize run on the device
    (:func:`geomapnet_tpu_torch.ops.image.make_device_pipeline`). Without
    camera models a mosaic goes through the CUDA demosaic kernel on a card;
    with ``camera_models_dir`` (the stereo centre camera's LUT) the full
    demosaic and the LUT undistortion run as torch ops. Pair with
    :class:`geomapnet_tpu_torch.data.robotcar.RobotCar` (``raw_bayer``)."""
    from ..ops.image import (
        make_device_pipeline,
        precompute_undistort_maps,
        resize_shorter_side_shape,
    )

    stats = np.loadtxt(Path(asset_root) / "RobotCar" / scene / "stats.txt")
    mean, std = std_from_stats(stats)
    maps = None
    if camera_models_dir:
        from ..data.robotcar_sdk import CameraModel

        cam = CameraModel(camera_models_dir, Path("stereo") / "centre")
        maps = precompute_undistort_maps(cam.lut, *raw_size)
    return make_device_pipeline(
        mean=tuple(float(m) for m in mean),
        std=tuple(float(s) for s in std),
        resize_to=resize_shorter_side_shape(*raw_size, resize),
        undistort_maps=maps,
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
        from ..data.robotcar import RobotCar

        return RobotCar(
            scene=scene, data_path=data_path, train=train,
            transform=None if raw_bayer else transform, seed=config.seed,
            real=real, skip_images=skip_images, vo_lib=vo_lib or "stereo",
            asset_dir=str(Path(asset_root) / "RobotCar"),
            raw_bayer=raw_bayer,
        )
    raise ValueError(f"unknown dataset {dataset}")


def build_datasets(
    model_name: str,
    dataset: str,
    scene: str,
    data_path: str,
    config: ExperimentConfig,
    asset_root: str = "data",
    keep_uint8: bool = False,
    raw_bayer: bool = False,
    cache_gb: float = 0.0,
):
    """(train_set, val_set) for a model family (upstream
    scripts/train.py:131-156); ``cache_gb`` is a per-split decoded-frame RAM
    budget (see :func:`build_frame_dataset`).

    MapNet++ trains on :class:`~geomapnet_tpu_torch.data.composite.MFOnline`
    items and validates on nothing (``val_set`` None): the labeled train
    split, and the test split as the unlabeled one, built with the *train*
    transform and its ``config.vo_lib`` poses (VOs, or GPS positions when
    ``vo_lib`` is "gps"), whose absolute targets come from the ground truth
    of the same split in VO mode."""
    if model_name not in ("posenet", "mapnet", "mapnet++"):
        raise ValueError(f"unknown model {model_name}")
    tf_train = build_transform(dataset, scene, config, asset_root, train=True,
                               seed=config.seed, keep_uint8=keep_uint8)
    tf_val = build_transform(dataset, scene, config, asset_root, train=False,
                             seed=config.seed, keep_uint8=keep_uint8)

    def frames(train, transform, real=False, skip_images=False, vo_lib=None):
        return build_frame_dataset(
            dataset, scene, data_path, train, config, transform=transform,
            real=real, skip_images=skip_images, asset_root=asset_root,
            vo_lib=vo_lib, raw_bayer=raw_bayer, cache_gb=cache_gb,
        )

    if model_name == "posenet":
        return frames(True, tf_train), frames(False, tf_val)
    mf_kwargs = dict(steps=config.steps, skip=config.skip,
                     variable_skip=config.variable_skip, seed=config.seed)
    if model_name == "mapnet":
        return (MF(frames(True, tf_train, real=config.real), **mf_kwargs),
                MF(frames(False, tf_val, real=config.real), **mf_kwargs))
    gps = config.vo_lib == "gps"
    train_mf = MF(frames(True, tf_train), **mf_kwargs)
    unlab = frames(False, tf_train, real=True, vo_lib=config.vo_lib)
    gt_for_unlab = None if gps else frames(False, tf_val, skip_images=True)
    val_mf = MF(unlab, include_vos=not gps, real=not gps, no_duplicates=True,
                gt_dataset=gt_for_unlab, vo_func=vos_logq_np, **mf_kwargs)
    return MFOnline(train_mf, val_mf, gps_mode=gps), None


def experiment_name(dataset, scene, model, config_file, learn_beta,
                    learn_gamma, suffix="") -> str:
    """`{dataset}_{scene}_{model}_{config}[_learn_beta][_learn_gamma]{suffix}`
    (upstream scripts/train.py:159-167)."""
    config_name = Path(config_file).stem
    name = f"{dataset}_{scene}_{model}_{config_name}"
    if learn_beta:
        name += "_learn_beta"
    if learn_gamma:
        name += "_learn_gamma"
    return name + suffix


def pick_device(name: str | None) -> torch.device:
    """The card unless ``--device`` names another device; no silent CPU."""
    if name is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device is visible; pass --device cpu "
                             "to run on the CPU")
        return torch.device("cuda")
    return torch.device(name)
