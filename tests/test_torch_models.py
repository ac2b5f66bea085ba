"""The port's PoseNet / MapNet against the Flax modules, on the CPU.

Both packages get the same numpy-seeded variables (random BatchNorm running
statistics included) through the weight bridge, and the same images.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomapnet_tpu.models import MapNet as FlaxMapNet
from geomapnet_tpu.models import PoseNet as FlaxPoseNet
from geomapnet_tpu.models import resnet18 as flax_resnet18
from geomapnet_tpu.models import resnet34 as flax_resnet34
from geomapnet_tpu.models import resnet50 as flax_resnet50
from geomapnet_tpu.models.torch_import import convert_state_dict, save_npz
from geomapnet_tpu_torch.models.flax_import import (
    load_npz,
    variables_to_state_dict,
)
from geomapnet_tpu_torch.models.posenet import MapNet, PoseNet
from geomapnet_tpu_torch.models.resnet import resnet18, resnet34, resnet50

TRUNKS = {
    "resnet18": (flax_resnet18, resnet18),
    "resnet34": (flax_resnet34, resnet34),
    "resnet50": (flax_resnet50, resnet50),
}
FEAT_DIM = 32
H, W = 32, 48


def seeded_variables(template, seed: int = 0) -> dict:
    """Numpy-seeded values in the shapes of a Flax variables tree (arrays or
    shape structs): He-scaled
    conv / dense kernels, small biases, BN scale and running variance in
    [0.5, 1.5], running means around 0."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = rng.randn(*shape) * 0.1
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, template)


def flax_posenet(trunk: str):
    return FlaxPoseNet(feature_extractor=TRUNKS[trunk][0](), droprate=0.5,
                       feat_dim=FEAT_DIM)


def posenet_variables(trunk: str, seed: int = 0) -> dict:
    template = jax.eval_shape(flax_posenet(trunk).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, H, W, 3)))
    return seeded_variables(template, seed)


def port_posenet(trunk: str, variables: dict) -> PoseNet:
    model = PoseNet(TRUNKS[trunk][1](), droprate=0.5, feat_dim=FEAT_DIM)
    model.load_state_dict(variables_to_state_dict(variables))
    return model.eval()


def _images(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("trunk", ["resnet18", "resnet34", "resnet50"])
def test_posenet_forward_matches_flax(trunk):
    """float32 poses within 1e-4 relative (plus 1e-4 absolute near zero).
    Random BN statistics let the poses grow to O(1e3) through the residual
    stacks, and XLA and PyTorch's CPU kernels take the convolution sums in
    another order: the two differ by a few 1e-6 of the pose's size."""
    variables = posenet_variables(trunk)
    x = _images((2, H, W, 3))
    want = np.asarray(jax.jit(flax_posenet(trunk).apply, static_argnames=(
        "train",))(variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = port_posenet(trunk, variables)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_mapnet_forward_matches_flax():
    """A T=3 MapNet folds its tuples into the PoseNet batch; the same
    tolerance as the PoseNet forward, for the same reason."""
    pn_vars = posenet_variables("resnet18", seed=3)
    mapnet_vars = {k: {"posenet": v} for k, v in pn_vars.items()}
    x = _images((2, 3, H, W, 3), seed=4)
    want = np.asarray(FlaxMapNet(posenet=flax_posenet("resnet18")).apply(
        mapnet_vars, jnp.asarray(x), train=False))
    model = MapNet(port_posenet("resnet18", pn_vars)).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3, 6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _reference_names(key: str) -> str:
    """The port's state_dict key -> the reference checkpoint's name, which
    the JAX package's importer reads."""
    key = re.sub(r"layer(\d+)_(\d+)\.", r"layer\1.\2.", key)
    key = key.replace("downsample_conv", "downsample.0")
    key = key.replace("downsample_bn", "downsample.1")
    return key.replace("fc_feat.", "feature_extractor.fc.")


def _assert_trees_equal(a, b, path=""):
    assert sorted(a) == sorted(b), path
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            assert a[k].shape == b[k].shape, f"{path}/{k}"
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{path}/{k}")


@pytest.mark.parametrize("trunk", ["resnet18", "resnet50"])
def test_state_dict_round_trips_exactly(trunk):
    """Flax -> state_dict -> (reference names) -> the JAX package's own
    torch importer gives back the very same arrays, and the state_dict fills
    every parameter and buffer of the port's module."""
    variables = posenet_variables(trunk, seed=5)
    sd = variables_to_state_dict(variables)
    model = PoseNet(TRUNKS[trunk][1](), feat_dim=FEAT_DIM)
    model.load_state_dict(sd, strict=True)
    back = convert_state_dict(
        {_reference_names(k): v.numpy() for k, v in sd.items()}, strict=True)
    _assert_trees_equal(back, variables)


def test_load_npz_reads_save_npz(tmp_path):
    variables = posenet_variables("resnet18", seed=6)
    save_npz(str(tmp_path / "w.npz"), variables)
    _assert_trees_equal(load_npz(str(tmp_path / "w.npz")), variables)


def test_unknown_flax_leaf_raises():
    variables = posenet_variables("resnet18")
    variables["params"]["fc_xyz"]["gain"] = np.ones(3, np.float32)
    with pytest.raises(KeyError, match="gain"):
        variables_to_state_dict(variables)


def test_float64_copy_is_a_float64_reference():
    """A PoseNet built with ``dtype=torch.float64`` and converted by
    ``.double()`` computes every conv, BatchNorm and block in float64 (the
    pose comes out float32, as always) and gives the float32 model's poses
    within its float32 rounding (1e-5 of their scale); its saliency is the
    reference that chip_smoke.py holds the card's to."""
    variables = posenet_variables("resnet18", seed=7)
    x = torch.from_numpy(_images((2, H, W, 3), seed=8))
    ref = PoseNet(resnet18(torch.float64), droprate=0.5, feat_dim=FEAT_DIM,
                  dtype=torch.float64)
    ref.load_state_dict(variables_to_state_dict(variables))
    ref = ref.double().eval()
    dtypes = set()
    for name, mod in ref.named_modules():
        if name.startswith("feature_extractor."):
            mod.register_forward_hook(
                lambda m, i, o: dtypes.add(o.dtype))
    with torch.inference_mode():
        got = ref(x.double())
        want = port_posenet("resnet18", variables)(x)
    assert dtypes == {torch.float64} and got.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
