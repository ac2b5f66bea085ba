"""A loaded serving artifact on the card replays one CUDA graph per input
shape (``serving.Inference``), against the same artifact run eagerly.

On the serving configuration (int8, 2 calibration batches, int8 heads,
fused requant: the export options of the benchmark's tuple-serving cell)
and on a float32 artifact, both with the uint8 normalize fused in front,
and on a float32 artifact of raw-Bayer mosaics (the demosaic kernel, K4,
fused in front), each a ResNet-18 MapNet on 64x96 frames; and on the
serving configuration at the tuple-serving cell's size (ResNet-34,
feat_dim 2048, 3 frames of 256x341):

- graphed calls are bit-equal to the loaded module run eagerly, at batch 1
  and batch 2 of 3-frame tuples;
- each shape captures its own graph once: ``serving.inference_graphs``
  counts one capture per shape and one replay per call;
- poses a call returned are unchanged by the next call (no aliasing of the
  graph's static output);
- a replay launches no kernel from the host: the hand kernels' launch
  counters stay where the capture left them.

This file imports no JAX, so it runs on a machine that has a card and no
JAX: ``python -m pytest --noconftest tests/test_torch_serving_card.py -m
cuda``. Skips without a card.
"""

import numpy as np
import pytest
import torch

from geomapnet_tpu_torch import serving
from geomapnet_tpu_torch.cli.builders import build_raw_device_preprocess
from geomapnet_tpu_torch.models.posenet import MapNet, PoseNet
from geomapnet_tpu_torch.models.resnet import resnet18, resnet34
from geomapnet_tpu_torch.ops import cuda_image, cuda_quant
from geomapnet_tpu_torch.ops.image import normalize

T, H, W = 3, 64, 96
MEAN, STD = (0.5, 0.45, 0.4), (0.25, 0.22, 0.2)
SERVE = dict(quantize=True, quantize_heads=True, fuse_requant=True)
# kind -> (export options, trunk, feat_dim, frame (H, W))
KINDS = {
    "int8": (SERVE, resnet18, 64, (H, W)),
    "f32": ({}, resnet18, 64, (H, W)),
    "raw_bayer": ({}, resnet18, 64, (H, W)),
    "int8_r34_256x341": (SERVE, resnet34, 2048, (256, 341)),
}


def preprocess(frames: torch.Tensor) -> torch.Tensor:
    return normalize(frames, MEAN, STD, dtype=torch.float32)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs capture there")
    return torch.device("cuda")


def _mapnet(dev: torch.device, trunk, feat_dim: int) -> MapNet:
    """A seeded MapNet, its BatchNorm affines and statistics drawn away
    from their initial values."""
    torch.manual_seed(5)
    net = PoseNet(trunk(), feat_dim=feat_dim, droprate=0.0)
    with torch.no_grad():
        for key, t in net.state_dict().items():
            mod, leaf = key.rsplit(".", 1)
            if not mod.rsplit(".", 1)[-1].split("_")[-1].startswith("bn"):
                continue
            if leaf in ("weight", "running_var"):
                t.uniform_(0.5, 1.5)
            elif leaf in ("bias", "running_mean"):
                t.normal_(0.0, 0.1)
    return MapNet(net).to(dev).eval()


def _tuples(n: int, frame: tuple, dev: torch.device,
            seed: int) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, 256, (n, T) + frame).astype(
        np.uint8)).to(dev)


@pytest.fixture(scope="module", params=sorted(KINDS))
def artifact(request, tmp_path_factory):
    """(the artifact's bytes, a function of (n, seed) giving n card tuples
    of its input frames)."""
    dev = _card()
    options, trunk, feat_dim, (h, w) = KINDS[request.param]
    frame, pre = (h, w, 3), preprocess
    if request.param == "raw_bayer":
        root = tmp_path_factory.mktemp("assets")
        (root / "RobotCar" / "loop").mkdir(parents=True)
        np.savetxt(root / "RobotCar" / "loop" / "stats.txt",
                   np.array([[0.45, 0.45, 0.46], [0.078, 0.077, 0.072]]))
        frame = (2 * h, 2 * w)
        pre = build_raw_device_preprocess("loop", str(root), raw_size=frame,
                                          resize=h)
    calib = ([pre(_tuples(2, frame, dev, seed=20 + i)) for i in range(2)]
             if options else None)
    blob = serving.export_inference(
        _mapnet(dev, trunk, feat_dim), None, frame_shape=(T,) + frame,
        dtype=torch.uint8, preprocess=pre, calib_data=calib, **options)
    return blob, lambda n, seed: _tuples(n, frame, dev, seed)


@pytest.mark.cuda
def test_graphed_calls_equal_eager_ones_per_shape(artifact):
    dev = _card()
    blob, tuples = artifact
    graphed = serving.load_inference(blob, dev)
    start = dict(serving.inference_graphs)
    calls = 0
    for shape, batch in enumerate((1, 2)):
        for seed in range(3):
            x = tuples(batch, seed=10 * batch + seed)
            got = graphed(x)
            with torch.inference_mode():
                want = graphed.module(x)
            calls += 1
            assert got.shape == (batch, T, 6)
            assert torch.equal(got, want), (batch, seed)
            assert serving.inference_graphs == {
                "captured": start["captured"] + shape + 1,
                "replayed": start["replayed"] + calls}
    assert len(graphed._graphs) == 2


@pytest.mark.cuda
def test_returned_poses_outlive_the_next_call(artifact):
    blob, tuples = artifact
    infer = serving.load_inference(blob, _card())
    first = infer(tuples(2, seed=1))
    kept = first.clone()
    second = infer(tuples(2, seed=2))
    assert torch.equal(first, kept)
    assert not torch.equal(first, second)


def _launches() -> dict:
    return {**cuda_quant.launches, "demosaic": cuda_image.launches}


@pytest.mark.cuda
def test_a_replay_launches_nothing_from_the_host(artifact):
    blob, tuples = artifact
    infer = serving.load_inference(blob, _card())
    before = _launches()
    infer(tuples(1, seed=3))                  # warm-up and capture
    captured = _launches()
    infer(tuples(1, seed=4))                  # a replay
    assert _launches() == captured
    ops = [n.target for n in infer.module.graph.nodes]
    # the warm-up and the capture each ran the forward from the host
    for key, op in (("int8_conv", torch.ops.geomapnet.int8_conv.default),
                    ("demosaic",
                     torch.ops.geomapnet.demosaic_half_normalize.default)):
        assert captured[key] - before[key] == 2 * ops.count(op), key
