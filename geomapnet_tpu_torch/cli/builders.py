"""Experiment assembly for the port: model, device pipeline, frame dataset.

The PyTorch counterpart of the parts of :mod:`geomapnet_tpu.cli.builders`
that the RobotCar raw-Bayer eval runs. Other datasets and pipelines are not
ported yet and raise ``NotImplementedError`` naming ROADMAP.md.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..data.transforms import std_from_stats
from ..models.posenet import MapNet, PoseNet
from ..models.resnet import resnet18, resnet34, resnet50
from .config import ExperimentConfig

__all__ = ["build_model", "build_raw_device_preprocess", "build_frame_dataset"]

TRUNKS = {"resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50}


def build_model(model_name: str, config: ExperimentConfig,
                trunk: str = "resnet34") -> tuple[torch.nn.Module, bool]:
    """Returns (module, is_tuple_model): a PoseNet, or a MapNet around one,
    with the ``trunk`` feature extractor and ``config.dropout``."""
    if trunk not in TRUNKS:
        raise ValueError(
            f"unknown trunk {trunk!r}; pick from {sorted(TRUNKS)}")
    posenet = PoseNet(feature_extractor=TRUNKS[trunk](),
                      droprate=config.dropout)
    if model_name == "posenet":
        return posenet, False
    if model_name == "mapnet":
        return MapNet(posenet), True
    raise ValueError(f"unknown model {model_name!r}")


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
    real: bool = False,
    asset_root: str = "data",
    raw_bayer: bool = False,
):
    """Construct one frame dataset by name (RobotCar raw mosaics with
    ground-truth poses only, so far)."""
    if dataset != "RobotCar":
        raise NotImplementedError(
            f"dataset {dataset!r} is not ported yet (ROADMAP.md, Queue 1)")
    if not raw_bayer:
        raise NotImplementedError(
            "RobotCar's processed-RGB frames are not ported yet (ROADMAP.md, "
            "Queue 1); use the raw Bayer mosaics")
    if real:
        raise NotImplementedError(
            "RobotCar VO/GPS poses (real=True) are not ported yet "
            "(ROADMAP.md, Queue 1: PGO)")
    from ..data.robotcar import RobotCar

    return RobotCar(
        scene=scene, data_path=data_path, train=train,
        asset_dir=str(Path(asset_root) / "RobotCar"),
    )
