"""Tensor parallelism, spatial partitioning and the pipeline on the card,
without JAX.

The card's machine has no JAX, so this file imports none; run it there with

    python -m pytest --noconftest tests/test_torch_grid_card.py -q

Two ranks (spawned, :mod:`dp_ranks`) join an NCCL group, one card each,
where the machine has two cards, else a gloo group on card 0 (gloo's
collectives take CUDA tensors; its point-to-point does not, and the
port's exchanges go through an all-gather there). Against the same
computations on one process on card 0: the tensor-parallel step of a
ResNet-18 MapNet on a 1x2 grid (loss within 1e-5 relative, gradients
within 1e-4 relative norm), the spatially partitioned eval (1e-4 absolute
plus relative) and the pipelined PoseNet split with packed weights
(forward within 1e-5 of the largest output, each row's gradient within
1e-4 relative norm). On NCCL also three ``KLaunch`` launches of two
tensor-parallel steps (the second and third CUDA-graph replays, the
Megatron all-reduces and the clip's inside) against the same steps run
eagerly, under deterministic cuDNN: the losses bit-equal. Skips without a
card.
"""

import numpy as np
import pytest
import torch

from dp_ranks import run_group


def _inputs():
    from geomapnet_tpu_torch.models.posenet import PoseNet
    from geomapnet_tpu_torch.models.resnet import ResNet
    from grid_ranks import _tiny_mapnet

    torch.manual_seed(0)
    state = _tiny_mapnet(32).posenet.state_dict()
    net = PoseNet(ResNet(stage_sizes=(1, 1)), feat_dim=16)
    rs = np.random.RandomState(5)
    case = dict(feat=32, droprate=0.5, state=state, lr=1e-4,
                weight_decay=5e-4, max_grad_norm=1.0, seed=3,
                x=rs.randn(4, 3, 32, 32, 3).astype(np.float32),
                y=(rs.randn(4, 3, 6) * 0.1).astype(np.float32))
    spatial = dict(feat=32, state=state,
                   images=rs.randn(2, 3, 32, 32, 3).astype(np.float32))
    split = dict(feat=16, state=net.state_dict(),
                 x=rs.randn(4, 32, 32, 3).astype(np.float32))
    return case, spatial, split, net


@pytest.mark.cuda
def test_grid_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from geomapnet_tpu_torch.dryrun import posenet_stages, stage_params
    from geomapnet_tpu_torch.parallel import (
        pack_stage_params,
        unpack_stage_params,
    )
    from grid_ranks import _tiny_mapnet, train_step_case

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    case, spatial, split, net = _inputs()
    nccl = torch.cuda.device_count() >= 2
    ranks = run_group("grid_ranks:card_grid", 2, timeout=300,
                      backend="nccl" if nccl else "gloo",
                      device="cuda:{rank}" if nccl else "cuda:0",
                      case=case, spatial=spatial, split=split)
    dev = torch.device("cuda", 0)
    want = train_step_case(case, device=dev)
    model = _tiny_mapnet(32).to(dev)
    model.posenet.load_state_dict(spatial["state"])
    model.eval()
    with torch.no_grad():
        fwd = model(torch.from_numpy(spatial["images"]).to(dev)).cpu().numpy()
    net.to(dev).eval()
    buf, meta = pack_stage_params(stage_params(net))
    buf = buf.detach().requires_grad_(True)
    fns = posenet_stages(net)
    p0, p1 = unpack_stage_params(buf, meta)
    seq = fns[1](p1, fns[0](p0, torch.from_numpy(split["x"]).to(dev)))
    (seq ** 2).mean().backward()
    seq = seq.detach().cpu().numpy()
    for r in ranks:
        assert r["backend"] == ("nccl" if nccl else "gloo")
        tp = r["tp"]
        np.testing.assert_allclose(tp["loss"], want["loss"], rtol=1e-5)
        for k, w in want["grads"].items():
            g = tp["grads"][k]
            assert np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-9) < 1e-4, k
        np.testing.assert_allclose(r["spatial"], fwd, atol=1e-4, rtol=1e-4)
        pp = r["pipeline"]
        assert np.abs(pp["forward"] - seq).max() <= 1e-5 * np.abs(seq).max()
        g, w = pp["grad"][0], buf.grad[pp["stage"]].cpu().numpy()
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-4
        if nccl:
            assert r["replays"] == 2
            assert r["losses"]["graph"] == r["losses"]["eager"]
            assert np.isfinite(r["losses"]["graph"]).all()
