"""Data-parallel ``evaluate()`` on two gloo ranks on the CPU, against the
JAX package's ``evaluate()`` over its 8 CPU devices.

The 7Scenes fixture of tests/test_torch_device_cache.py (14 test frames
at 32x43, MF tuples of 3 with skip 2) and its seeded ResNet-18 weights.
Each rank computes its rows of every batch or window and the poses are
all-gathered, so both ranks return the same result; held to JAX's with
its own tolerance:

- float32 within 1e-4 relative (1e-5 absolute), targets exactly, and the
  same ``frames_computed``: the loader path, the tuple epoch, the dedup
  epoch (batch 8: 14 unique frames < 24 a window) and the slice epoch
  (batch 4; JAX's 8 devices do not divide 4, so it runs it on one device),
  from the replicated cache (uploaded by an all-gather) and from the
  frame-sharded cache (``device_cache="shard"``, its reduce-scatter
  gather, against JAX's ``psum_scatter`` one at batch 8);
- the int8 serving configuration (``quantize``, ``calib_batches=2``,
  ``quantize_heads``, ``fuse_requant``) from the frame-sharded S2D int8
  row cache: every prediction bit-equal to the port's one-rank eval (the
  int8 trunk is exact; the calibration batches are read whole on every
  rank, so the scales are the same), and within the bf16 heads' tolerance
  of JAX's (tests/test_torch_eval_int8.py's ``INT8_POSE_TOL``);
- a batch of 3, which two ranks do not divide: JAX's message, and the
  full batch on every rank (equal to the one-rank eval bit for bit);
- eval-time dropout on the loader path and the tuple epoch: each rank
  cuts its rows from the window's whole keep-mask, so the draws are the
  one-rank eval's (poses within the float32 bound of it, and away from
  the deterministic eval's).
"""

import jax.numpy as jnp  # noqa: F401  (keeps JAX on the CPU, conftest)
import numpy as np
import pytest
import torch

import geomapnet_tpu.cli.eval as jax_eval_module
from geomapnet_tpu.cli import builders as jax_builders
from geomapnet_tpu.cli.config import ExperimentConfig
from geomapnet_tpu.data import MF as JaxMF
from geomapnet_tpu.data.sevenscenes import SevenScenes as JaxSevenScenes
from geomapnet_tpu.data.transforms import ImageTransform as JaxImageTransform
from geomapnet_tpu_torch.cli import builders
from geomapnet_tpu_torch.cli import eval as port_eval
from geomapnet_tpu_torch.data.composite import MF
from geomapnet_tpu_torch.data.sevenscenes import SevenScenes
from geomapnet_tpu_torch.data.transforms import ImageTransform
from geomapnet_tpu_torch.models.flax_import import (
    load_npz,
    variables_to_state_dict,
)
from dp_ranks import run_group
from test_torch_device_cache import (  # noqa: F401  (module fixtures)
    CPU,
    N_FRAMES,
    _frames,
    _pose_stats,
    scene,
    weights,
)
from test_torch_eval import jax_state
from test_torch_eval_int8 import INT8_POSE_TOL, SERVING

F32 = dict(rtol=1e-4, atol=1e-5)
# name: (port keywords, the JAX call's keywords or None for the port's
# one-rank eval)
CALLS = {
    "loader": (dict(batch_size=8), dict(batch_size=8)),
    "tuple": (dict(batch_size=8, device_cache=True, dedup_frames=False),
              dict(batch_size=8, device_cache=True, dedup_frames=False)),
    "dedup": (dict(batch_size=8, device_cache=True),
              dict(batch_size=8, device_cache=True)),
    "slice": (dict(batch_size=4, device_cache=True),
              dict(batch_size=4, device_cache=True)),
    "shard_dedup": (dict(batch_size=8, device_cache="shard"),
                    dict(batch_size=8, device_cache="shard")),
    "shard_slice": (dict(batch_size=4, device_cache="shard"),
                    dict(batch_size=4, device_cache=True)),
    "shard_int8": (dict(batch_size=8, device_cache="shard", **SERVING),
                   dict(batch_size=8, device_cache="shard", **SERVING)),
    "odd_batch": (dict(batch_size=3, device_cache=True), None),
    "dropout_loader": (dict(batch_size=4, stochastic=True), None),
    "dropout_tuple": (dict(batch_size=4, device_cache=True,
                           stochastic=True), None),
}


def _jax(scene, weights, **kw):
    frames = _frames(scene, JaxSevenScenes, JaxImageTransform)
    ds = JaxMF(frames, steps=3, skip=2)
    model, _ = jax_builders.build_model("mapnet", ExperimentConfig(),
                                        trunk="resnet18")
    pre = jax_builders.build_device_preprocess("7Scenes", "heads",
                                               str(scene / "assets"))
    jax_eval_module._SCAN_CACHE.clear()   # fault R1: no stale program
    return jax_eval_module.evaluate(
        model, jax_state(weights["mapnet"], True), ds,
        pose_stats=_pose_stats(scene), progress=False, preprocess=pre,
        use_mesh=True, **kw)


def _port_one_rank(scene, weights, **kw):
    frames = _frames(scene, SevenScenes, ImageTransform)
    model, _ = builders.build_model("mapnet", ExperimentConfig(),
                                    trunk="resnet18")
    model.posenet.load_state_dict(
        variables_to_state_dict(load_npz(str(weights["mapnet"]))))
    pre = builders.build_device_preprocess("7Scenes", "heads",
                                           str(scene / "assets"))
    return port_eval.evaluate(model, MF(frames, steps=3, skip=2), CPU,
                              pose_stats=_pose_stats(scene), progress=False,
                              preprocess=pre, **kw)


@pytest.fixture(scope="module")
def ranks(scene, weights):
    calls = [kw for kw, _ in CALLS.values()]
    results = run_group("evaluate", 2, scene=str(scene),
                        weights={k: str(v) for k, v in weights.items()},
                        calls=calls, n_frames=N_FRAMES)
    return {name: [r[i] for r in results] for i, name in enumerate(CALLS)}


@pytest.mark.parametrize("name", list(CALLS))
def test_two_rank_evaluate(ranks, scene, weights, name):
    ours, jax_kw = CALLS[name]
    a, b = ranks[name]
    for k in ("pred_poses", "targ_poses"):
        np.testing.assert_array_equal(a[k], b[k])   # every rank alike
    assert a.get("frames_computed") == b.get("frames_computed")
    if jax_kw is None:
        want = _port_one_rank(scene, weights, **ours)
        if ours.get("stochastic"):
            # each rank cuts its rows from the window's whole mask: the
            # one-rank draws, on fewer rows a forward
            np.testing.assert_allclose(a["pred_poses"], want["pred_poses"],
                                       **F32)
            plain = ranks["slice"][0]["pred_poses"]
            assert np.abs(a["pred_poses"][:, :3] - plain[:, :3]).max() > 1
        else:
            np.testing.assert_array_equal(a["pred_poses"],
                                          want["pred_poses"])
        for k in ("frames_computed", "dedup_slice"):
            assert a.get(k) == want.get(k), k
        return
    want = _jax(scene, weights, **jax_kw)
    np.testing.assert_array_equal(a["targ_poses"], want["targ_poses"])
    assert a.get("frames_computed") == want.get("frames_computed")
    if ours.get("quantize"):
        one_rank = _port_one_rank(scene, weights,
                                  **ours | dict(device_cache=True))
        np.testing.assert_array_equal(a["pred_poses"],
                                      one_rank["pred_poses"])
        scale = np.abs(want["pred_poses"][:, :3]).max()
        np.testing.assert_allclose(a["pred_poses"][:, :3],
                                   want["pred_poses"][:, :3], rtol=0,
                                   atol=INT8_POSE_TOL * scale)
    else:
        assert np.abs(a["pred_poses"]).max() > 0.1
        np.testing.assert_allclose(a["pred_poses"], want["pred_poses"],
                                   **F32)
    if ours.get("device_cache") == "shard":
        per = -(-N_FRAMES // 2)      # each rank holds ceil(N / W) frames
        rows = (per, 16 * 22 * 12) if ours.get("quantize") else \
            (per, 32, 43, 3)
        assert a["device_frames_shape"] == rows
        assert a["device_frames_dtype"] == ("torch.int8" if ours.get(
            "quantize") else "torch.uint8")
    elif ours.get("device_cache"):
        assert a["device_frames_shape"] == (N_FRAMES, 32, 43, 3)
    assert a.get("dedup_slice") == want.get("dedup_slice")


def test_shard_needs_a_group(scene, weights):
    with pytest.raises(ValueError, match="needs a data-parallel group"):
        _port_one_rank(scene, weights, batch_size=4, device_cache="shard")
