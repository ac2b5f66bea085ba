"""The plain reference agrees with the port on the CPU at a tiny size (this
test imports both; the reference imports nothing of the port)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.core import inputs, program
from benchmark.core import manifest as mf
from benchmark.reference import mapnet as ref
from benchmark.reference import poses
from benchmark.reference.train import bayer_to_input, follow_steps, keep_mask
from benchmark.tests.conftest import TINY_CONFIG


def _cfg(name):
    return {**mf.config(name), **TINY_CONFIG[name]}


@pytest.mark.parametrize("seed", [1, 2])
def test_eval_forward_matches_port(seed):
    cfg = _cfg("mapnet-r34-7scenes")
    state = inputs.seeded_states(seed, 1, "cpu", cfg["stage_sizes"],
                                 cfg["feat_dim"])[0]
    frames = inputs.panorama_frames(seed, 1, 8, *cfg["frame"], "cpu")
    want = poses.frame_poses(frames, np.arange(8), state, cfg["stage_sizes"],
                             cfg["pixel_stats"])
    from geomapnet_tpu_torch.ops.image import normalize
    model = program.mapnet(cfg, state, "cpu").eval()
    mean = cfg["pixel_stats"][0]
    std = list(np.sqrt(cfg["pixel_stats"][1]))
    with torch.no_grad():
        got = model(normalize(frames, mean, std)[None])[0].double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(
        want).max())


def test_keep_mask_matches_port():
    from geomapnet_tpu_torch.train.state import step_keep_mask
    for step in (0, 1, 7):
        a = step_keep_mask(12345, torch.tensor(step), 0, (60, 32), 0.5)
        assert torch.equal(a, keep_mask(12345, step, 0, (60, 32), 0.5,
                                        "cpu"))


def test_bayer_preprocess_matches_port(tmp_path):
    cfg = _cfg("mapnet-r34-robotcar-bayer")
    scene = inputs.MosaicScene(3, 1, 4, *cfg["raw_frame"])
    raw = torch.from_numpy(np.stack([scene[i] for i in range(4)]))
    assets = program.asset_root(cfg)
    try:
        from geomapnet_tpu_torch.cli.builders import \
            build_raw_device_preprocess
        pp = build_raw_device_preprocess(
            cfg["scene_name"], assets.name, dtype=torch.float32,
            raw_size=tuple(cfg["raw_frame"]), resize=cfg["frame"][0])
        got = pp(raw).permute(0, 3, 1, 2)
    finally:
        assets.cleanup()
    want = bayer_to_input(raw, cfg["pixel_stats"][0],
                          list(np.sqrt(cfg["pixel_stats"][1])),
                          cfg["frame"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_train_steps_match_port():
    """Three Adam steps of the port's train step against the reference's
    from the same weights, batches and dropout draws: the first loss to
    rounding; the later ones within 1% (the gradients of a random tiny
    ResNet move by ~0.5% under input rounding, measured in float64)."""
    from geomapnet_tpu_torch.cli.builders import (
        build_criteria, build_raw_device_preprocess)
    from geomapnet_tpu_torch.train.optim import make_optimizer
    from geomapnet_tpu_torch.train.state import make_train_step

    cfg = _cfg("mapnet-r34-robotcar-bayer")
    conf = program.experiment_config(cfg, 99)
    state = inputs.seeded_states(4, 1, "cpu", cfg["stage_sizes"],
                                 cfg["feat_dim"])[0]
    scene = inputs.MosaicScene(5, 1, 40, *cfg["raw_frame"])
    frames = torch.from_numpy(np.stack([scene[i] for i in range(40)]))
    rng = np.random.default_rng(0)
    batches = [(torch.from_numpy(rng.integers(0, 40, (4, 3)).astype(
        np.int32)), torch.from_numpy(rng.normal(size=(4, 3, 6)).astype(
            np.float32))) for _ in range(3)]
    assets = program.asset_root(cfg)
    try:
        pp = build_raw_device_preprocess(
            cfg["scene_name"], assets.name, dtype=torch.float32,
            raw_size=tuple(cfg["raw_frame"]), resize=cfg["frame"][0])
        model = program.mapnet(cfg, state, "cpu")
        crit, _ = build_criteria("mapnet", conf, True, True)
        opt = make_optimizer("adam", conf.lr, model, crit, conf.weight_decay)
        step = make_train_step(model, crit, opt, preprocess=pp)
        got = [float(step(i, p, seed=conf.seed, frames=frames))
               for i, p in batches]
    finally:
        assets.cleanup()
    want = follow_steps(
        state, dict(sax=0.0, saq=-3.0, srx=0.0, srq=-3.0),
        [(frames[i.long()], p) for i, p in batches], seed=conf.seed,
        lr=conf.lr, weight_decay=conf.weight_decay, droprate=conf.dropout,
        stage_sizes=cfg["stage_sizes"], mean=cfg["pixel_stats"][0],
        std=list(np.sqrt(cfg["pixel_stats"][1])), out_hw=cfg["frame"])
    assert got[0] == pytest.approx(want["losses"][0], rel=1e-5)
    assert got == pytest.approx(want["losses"], rel=1e-2)
