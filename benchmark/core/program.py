"""The measured program's side of a run: ``geomapnet_tpu_torch`` objects
built from a configuration file and the seeded inputs, as its CLIs build
them. Only the drivers import this module; the reference never does."""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

__all__ = ["experiment_config", "asset_root", "mapnet", "launches",
           "reset_launches"]


def experiment_config(cfg: dict, seed: int):
    """The port's :class:`ExperimentConfig` with the configuration file's
    ``experiment`` values; ``seed`` (the run's, cut to 31 bits) seeds its
    shuffles and dropout."""
    from geomapnet_tpu_torch.cli.config import ExperimentConfig

    conf = ExperimentConfig()
    for k, v in cfg["experiment"].items():
        if not hasattr(conf, k):
            raise KeyError(f"ExperimentConfig has no field {k!r}")
        setattr(conf, k, v)
    conf.seed = int(seed) % (2 ** 31 - 1)
    return conf


def asset_root(cfg: dict) -> tempfile.TemporaryDirectory:
    """A temporary asset root holding the scene's pixel statistics (mean
    row, variance row) as ``<dataset>/<scene>/stats.txt``, where the port's
    preprocess builders read them."""
    tmp = tempfile.TemporaryDirectory(prefix="bench_assets_")
    d = Path(tmp.name) / cfg["dataset"] / cfg["scene_name"]
    d.mkdir(parents=True)
    np.savetxt(d / "stats.txt", np.asarray(cfg["pixel_stats"], np.float64))
    return tmp


def mapnet(cfg: dict, state: dict, device, dtype=torch.float32):
    """MapNet (a shared-weight PoseNet over a ResNet trunk of the
    configuration's stage sizes) with ``state`` loaded, on ``device``."""
    from geomapnet_tpu_torch.models.posenet import MapNet, PoseNet
    from geomapnet_tpu_torch.models.resnet import ResNet

    with torch.device(device):
        posenet = PoseNet(ResNet(tuple(cfg["stage_sizes"]), dtype=dtype),
                          droprate=cfg["experiment"]["dropout"],
                          feat_dim=cfg["feat_dim"], dtype=dtype)
    posenet.load_state_dict(state)
    return MapNet(posenet).to(device)


def launches() -> dict:
    """The hand-written kernels' launch counters (K1, K2 and K4)."""
    from geomapnet_tpu_torch.ops import cuda_image, cuda_quant

    return {**{f"K1/K2 {k}": v for k, v in cuda_quant.launches.items()},
            "K4 demosaic_half_normalize": cuda_image.launches}


def reset_launches() -> None:
    from geomapnet_tpu_torch.ops import cuda_image, cuda_quant

    for k in cuda_quant.launches:
        cuda_quant.launches[k] = 0
    cuda_image.launches = 0
