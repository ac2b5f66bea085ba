"""The serving trees built on the card, against the same trees built on the
CPU, and the int8 eval that builds them there.

The trees built on the CPU are held to the JAX package's bit for bit by
``tests/test_torch_quant.py``; this file imports no JAX, so it runs on a
machine that has a card and no JAX:
``python -m pytest --noconftest tests/test_torch_quant_card.py -m cuda``.
Skips without a card.
"""

import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from geomapnet_tpu_torch.cli.eval import evaluate
from geomapnet_tpu_torch.data.composite import MF
from geomapnet_tpu_torch.models import quant as PQ
from geomapnet_tpu_torch.models.flax_import import state_dict_tensors
from geomapnet_tpu_torch.models.posenet import MapNet, PoseNet
from geomapnet_tpu_torch.models.resnet import Bottleneck, ResNet
from geomapnet_tpu_torch.ops.image import normalize

KINDS = ["int8", "int8_heads", "folded", "s2d"]


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the tree is built there")
    return torch.device("cuda")


def _posenet(bottleneck: bool = False) -> PoseNet:
    """A seeded PoseNet (ResNet-18's basic blocks, or a 1-1-1-1 bottleneck
    trunk), its BatchNorm affines and statistics drawn away from their
    initial values."""
    torch.manual_seed(3 if bottleneck else 2)
    stages, block = (((1, 1, 1, 1), dict(block_cls=Bottleneck)) if bottleneck
                     else ((2, 2, 2, 2), {}))
    net = PoseNet(ResNet(stages, **block), feat_dim=64)
    with torch.no_grad():
        for key, t in net.state_dict().items():
            mod, leaf = key.rsplit(".", 1)
            if not mod.rsplit(".", 1)[-1].split("_")[-1].startswith("bn"):
                continue
            if leaf in ("weight", "running_var"):
                t.uniform_(0.5, 1.5)
            elif leaf in ("bias", "running_mean"):
                t.normal_(0.0, 0.1)
    return net


def _tree(variables, kind: str, stages) -> dict:
    if kind == "folded":
        return PQ.fold_posenet_variables(variables, stages)
    tree = PQ.quantize_posenet_variables(variables, stages,
                                         kind == "int8_heads")
    return PQ.convert_stem_s2d(tree) if kind == "s2d" else tree


def _leaves(tree: dict, path: str = ""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", tree[k]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("trunk", ["basic", "bottleneck"])
@pytest.mark.parametrize("kind", KINDS)
def test_tree_on_card_matches_cpu(kind, trunk):
    """Every leaf of the tree built from the card's ``state_dict`` is on
    the card and bit-equal to the tree built from the same weights on the
    CPU; so are the served net's buffers, the CPU-built net moved to the
    card. One build counted on the device."""
    card = _card()
    net = _posenet(trunk == "bottleneck")
    stages = net.feature_extractor.stage_sizes
    want = _tree(state_dict_tensors(net.state_dict()), kind, stages)
    card_net = copy.deepcopy(net).to(card)
    before = dict(PQ.tree_builds)
    got = _tree(state_dict_tensors(card_net.state_dict()), kind, stages)
    assert PQ.tree_builds == {"device": before["device"] + 1,
                              "host": before["host"]}
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for path, g in got_leaves.items():
        w = want_leaves[path]
        assert g.device.type == "cuda", path
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(_bits(g), _bits(w)), path
    served = PQ.QuantizedPoseNet(got).state_dict()
    moved = PQ.QuantizedPoseNet(want).to(card).state_dict()
    assert served.keys() == moved.keys()
    for k, t in served.items():
        assert t.device.type == "cuda", k
        assert torch.equal(_bits(t), _bits(moved[k])), k


class _Frames:
    """Poses of frames that live on the card only."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        self.poses = np.concatenate(
            [rng.normal(size=(n, 3)), rng.normal(scale=0.1, size=(n, 3))],
            axis=1).astype(np.float32)
        self.gt_idx = np.arange(n)

    def __len__(self):
        return len(self.poses)

    def get_image(self, i):
        return None


def _preprocess(x: torch.Tensor) -> torch.Tensor:
    return normalize(x, (0.45, 0.45, 0.4), (0.25, 0.25, 0.3))


@pytest.mark.cuda
def test_int8_eval_builds_its_tree_on_card():
    """The serving configuration of ``evaluate()`` over a uint8 frame stack
    on the card: a model on the card builds its tree there (one device
    build a call) and gives the poses of the same model's tree built on
    the CPU and moved to the card, bit for bit. Building the calibrated
    tree and its net copies nothing to the card, and reads back only the
    calibration's absmax values."""
    card = _card()
    posenet = _posenet()
    dataset = MF(_Frames(40, 1), steps=3, skip=1)
    gen = torch.Generator(device=card).manual_seed(4)
    frames = torch.randint(0, 256, (40, 64, 96, 3), dtype=torch.uint8,
                           device=card, generator=gen)
    kw = dict(quantize=True, calib_batches=2, quantize_heads=True,
              fuse_requant=True, batch_size=4, preprocess=_preprocess,
              device_cache=frames, progress=False)
    on_card = MapNet(copy.deepcopy(posenet).to(card))
    before = dict(PQ.tree_builds)
    got = evaluate(on_card, dataset, card, **kw)
    assert PQ.tree_builds == {"device": before["device"] + 1,
                              "host": before["host"]}
    want = evaluate(MapNet(posenet), dataset, card, **kw)
    assert PQ.tree_builds == {"device": before["device"] + 1,
                              "host": before["host"] + 1}
    assert np.isfinite(got["pred_poses"]).all()
    assert np.abs(got["pred_poses"]).max() > 0
    np.testing.assert_array_equal(got["pred_poses"], want["pred_poses"])

    batches = [_preprocess(frames[i * 12:(i + 1) * 12]) for i in range(2)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        PQ.serving_net(on_card.posenet, card, quantize=True,
                       quantize_heads=True, calib_batches=iter(batches),
                       fuse_requant=True, s2d_stem=True)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert sum("Memcpy DtoH" in n for n in names) == 1, sorted(set(names))
    assert sum("Memcpy HtoD" in n for n in names) == 0, sorted(set(names))
