"""The int8 and BN-folded serving trunks against the JAX package.

The same numpy-seeded variables (a 2-2-2-2 basic-block trunk, feat_dim 64)
and images go through :mod:`geomapnet_tpu.models.quant` and
:mod:`geomapnet_tpu_torch.models.quant`:

- the prepared trees and the calibrated scales equal JAX's bit for bit;
- the plain versions of the int8 conv (K1) and max-pool (K2) kernels equal
  ``lax.conv_general_dilated(..., preferred_element_type=int32)`` and
  ``lax.reduce_window`` exactly, with JAX's epilogues jitted with their
  scales passed as arguments (XLA on the CPU contracts the dequant into one
  FMA, and would turn a division by a closed-over scale into a multiply);
- every int8 activation of the fused trunk equals JAX's;
- poses agree within a stated bf16 tolerance (the heads run in bf16, and
  XLA's and PyTorch's bf16 products round at other places).

On these CPU tensors the wrappers take the plain versions; the kernels
themselves are held against the plain versions on the card by
``chip_smoke.py`` and by the ``cuda``-marked test below.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import geomapnet_tpu.models.quant as JQ
from geomapnet_tpu.models.posenet import PoseNet as JaxPoseNet
from geomapnet_tpu.models.resnet import Bottleneck as JaxBottleneck
from geomapnet_tpu.models.resnet import ResNet as JaxResNet
from geomapnet_tpu.models.resnet import resnet18 as jax_resnet18
from geomapnet_tpu_torch.data.device_cache import quantize_rows
from geomapnet_tpu_torch.models import quant as PQ
from geomapnet_tpu_torch.models.flax_import import (
    state_dict_to_variables,
    variables_to_state_dict,
)
from geomapnet_tpu_torch.ops import cuda_quant as CQ

STAGES = (2, 2, 2, 2)
# poses: bf16 heads round at other places in XLA and PyTorch, so the int8
# paths agree within a few bf16 ulp of the pose scale (0.14% measured);
# the folded bf16 trunk also sums its convs in another order (0.6%)
INT8_POSE_TOL = 0.01
BF16_TRUNK_TOL = 0.03


def _seeded_variables(model, shape, seed=0) -> dict:
    """numpy-seeded Flax variables of ``model`` (He-scaled kernels, BN
    scale and variance in [0.5, 1.5])."""
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                               jnp.zeros(shape))
    rng = np.random.RandomState(seed)

    def fill(p, leaf):
        name = p[-1].key
        if name == "kernel":
            v = rng.randn(*leaf.shape) * np.sqrt(
                2.0 / np.prod(leaf.shape[:-1]))
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            v = rng.randn(*leaf.shape) * 0.1
        return np.asarray(v, np.float32)

    return jax.tree.map(np.asarray,
                        jax.tree_util.tree_map_with_path(fill, variables))


@pytest.fixture(scope="module")
def variables():
    return _seeded_variables(JaxPoseNet(feature_extractor=jax_resnet18(),
                                        feat_dim=64), (1, 32, 32, 3))


def _images(n, h=64, w=96, seed=3):
    return np.random.RandomState(seed).randn(n, h, w, 3).astype(np.float32)


@pytest.fixture(scope="module")
def calibrated(variables):
    """(JAX's tree, the port's tree) calibrated on the same two batches,
    for even and odd widths."""
    q = JQ.quantize_posenet_variables(variables, STAGES, quantize_heads=True)
    out = {}
    for w in (96, 97):
        batches = [_images(4, w=w, seed=10 + i) for i in range(2)]
        out[w] = (JQ.calibrate_activation_scales(q, batches),
                  PQ.calibrate_activation_scales(q, batches))
    return out


def assert_tree_equal(got, want, path="") -> None:
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        else:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (path, k)
            np.testing.assert_array_equal(a, b, err_msg=f"{path}/{k}")


# ------------------------------------------------------------------- trees


@pytest.mark.parametrize("kind", ["int8", "int8_heads", "folded", "s2d"])
def test_trees_match_jax(variables, kind):
    """qkernel, m, b, the folded kernels and the S2D stem kernel equal the
    JAX package's bit for bit."""
    if kind == "folded":
        got = PQ.fold_posenet_variables(variables, STAGES)
        want = JQ.fold_posenet_variables(variables, STAGES)
    else:
        heads = kind == "int8_heads"
        got = PQ.quantize_posenet_variables(variables, STAGES, heads)
        want = JQ.quantize_posenet_variables(variables, STAGES, heads)
        if kind == "s2d":
            got, want = PQ.convert_stem_s2d(got), JQ.convert_stem_s2d(want)
            assert got["trunk"]["conv1"]["qkernel"].shape == (4, 4, 12, 64)
    assert_tree_equal(got, want)


def test_mapnet_nesting_and_weight_bridge(variables):
    """A MapNet-nested tree prepares as the PoseNet's, and the port's
    state_dict carries every value back to the Flax layout exactly."""
    nested = {k: {"posenet": v} for k, v in variables.items()}
    assert_tree_equal(PQ.quantize_posenet_variables(nested, STAGES),
                      JQ.quantize_posenet_variables(variables, STAGES))
    back = state_dict_to_variables(variables_to_state_dict(variables))
    assert_tree_equal(back, variables)


@pytest.mark.parametrize("width", [96, 97])
def test_calibrated_scales_match_jax(calibrated, width):
    """The dynamic-scale observer walk gives every site's and the head's
    ``x_scale`` bit for bit, and the S2D conversion keeps them."""
    want, got = calibrated[width]
    assert_tree_equal(got, want)
    assert "x_scale" in got["heads"]["fc_feat"]
    assert_tree_equal(PQ.convert_stem_s2d(got), JQ.convert_stem_s2d(want))


# ------------------------------------------------ plain K1 and K2 versus lax

# (input NHWC, O, ksize, stride, pad): the geometries of the ResNet-34 path,
# at a few frames and narrow spatial sizes
GEOMETRIES = {
    "stem_s2d_4x4": ((2, 16, 22, 12), 64, (4, 4), (1, 1), ((2, 1), (2, 1))),
    "stem_7x7_s2": ((2, 32, 43, 3), 64, (7, 7), (2, 2), ((3, 3), (3, 3))),
    "3x3_s1": ((2, 8, 11, 64), 64, (3, 3), (1, 1), ((1, 1), (1, 1))),
    "3x3_s2": ((2, 8, 11, 64), 128, (3, 3), (2, 2), ((1, 1), (1, 1))),
    "1x1_s2": ((2, 8, 11, 64), 128, (1, 1), (2, 2), ((0, 0), (0, 0))),
    "3x3_s1_deep": ((2, 3, 4, 512), 32, (3, 3), (1, 1), ((1, 1), (1, 1))),
    "1x1_s1": ((2, 8, 11, 64), 96, (1, 1), (1, 1), ((0, 0), (0, 0))),
}


def _conv_operands(shape, o, ksize, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(-127, 128, shape).astype(np.int8)
    k = rng.randint(-127, 128, ksize + (shape[3], o)).astype(np.int8)
    depth = ksize[0] * ksize[1] * shape[3]
    m = (rng.uniform(0.5, 1.5, o) / (5376.0 * depth ** 0.5)).astype(
        np.float32)
    b = (rng.randn(o) * 0.1).astype(np.float32)
    return x, k, m, b


def _jax_acc(x, k, stride, pad):
    return JQ._conv_acc(jnp.asarray(x), {"qkernel": jnp.asarray(k)}, stride,
                        list(pad))


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_plain_conv_matches_lax(name):
    """Every epilogue of the plain K1 against JAX's ``_conv_acc`` /
    ``_deq`` / relu / ``_q8`` chain, jitted with the scales as arguments:
    int32 and int8 outputs exactly, float32 exactly, bf16 exactly."""
    shape, o, ksize, stride, pad = GEOMETRIES[name]
    x, k, m, b = _conv_operands(shape, o, ksize)
    oh, ow = CQ.conv_out_hw(shape[1], shape[2], ksize, stride, pad)
    rng = np.random.RandomState(1)
    res_f = rng.randn(shape[0], oh, ow, o).astype(np.float32)
    res_q = rng.randint(-127, 128, (shape[0], oh, ow, o)).astype(np.int8)
    s_in, s_out, s_res = (np.float32(v) for v in (1.0, 3 / 127, 1 / 40))
    site = {"m": m, "b": b}

    @jax.jit
    def want(x, k, site, s_in, s_out, s_res, res_f, res_q):
        acc = _jax_acc(x, k, stride, pad)
        y = JQ._deq(acc, site, s_in)
        return dict(
            acc=acc, deq_f32=y, deq_bf16=y.astype(jnp.bfloat16),
            relu_q=JQ._q8(jax.nn.relu(y), s_out),
            res_f32=JQ._q8(jax.nn.relu(y + res_f), s_out),
            res_i8=JQ._q8(jax.nn.relu(y + res_q.astype(jnp.float32) * s_res),
                          s_out),
            res_i8_f32=jax.nn.relu(y + res_q.astype(jnp.float32) * s_res))

    ref = {key: np.asarray(v, np.float32 if v.dtype == jnp.bfloat16 else None)
           for key, v in want(x, k, site, s_in, s_out, s_res, res_f,
                              res_q).items()}
    w = CQ.pack_conv_weight(torch.from_numpy(k))
    args = (torch.from_numpy(x), w, torch.from_numpy(m), torch.from_numpy(b),
            float(s_in))
    geo = dict(ksize=ksize, stride=stride, pad=pad)
    rf, rq = torch.from_numpy(res_f), torch.from_numpy(res_q)
    got = dict(
        acc=CQ.int8_conv(*args, mode="acc", **geo),
        deq_f32=CQ.int8_conv(*args, mode="deq", **geo),
        deq_bf16=CQ.int8_conv(*args, mode="deq", out_dtype=torch.bfloat16,
                              **geo),
        relu_q=CQ.int8_conv(*args, mode="relu_q", s_out=float(s_out), **geo),
        res_f32=CQ.int8_conv(*args, mode="residual", residual=rf,
                             s_out=float(s_out), **geo),
        res_i8=CQ.int8_conv(*args, mode="residual", residual=rq,
                            res_scale=float(s_res), s_out=float(s_out),
                            **geo),
        res_i8_f32=CQ.int8_conv(*args, mode="residual", residual=rq,
                                res_scale=float(s_res), **geo))
    assert got["acc"].dtype == torch.int32
    assert got["relu_q"].dtype == got["res_i8"].dtype == torch.int8
    assert got["res_i8_f32"].dtype == torch.float32
    assert len(np.unique(ref["relu_q"])) > 50    # the requant spans int8
    for key, v in got.items():
        np.testing.assert_array_equal(v.float().numpy() if v.dtype ==
                                      torch.bfloat16 else v.numpy(),
                                      ref[key], err_msg=key)


@pytest.mark.parametrize("shape", [(2, 16, 22, 64), (1, 9, 7, 32)])
def test_plain_maxpool_matches_reduce_window(shape):
    x = np.random.RandomState(4).randint(-127, 128, shape).astype(np.int8)
    want = np.asarray(lax.reduce_window(
        jnp.asarray(x), jnp.asarray(-127, jnp.int8), lax.max, (1, 3, 3, 1),
        (1, 2, 2, 1), [(0, 0), (1, 1), (1, 1), (0, 0)]))
    got = CQ.int8_maxpool3x3s2(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fma_f32_is_one_rounding():
    """``fma_f32`` rounds the exact ``a*b + c`` once: against exact
    rational arithmetic, on values that put the sum near float32 ties."""
    rng = np.random.RandomState(5)
    a = rng.randint(-2 ** 20, 2 ** 20, 400).astype(np.float32)
    b = (rng.rand(400) * 1e-3).astype(np.float32)
    c = (rng.randn(400) * 10).astype(np.float32)
    got = CQ.fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for ai, bi, ci, g in zip(a, b, c, got):
        exact = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(float(ci))
        # round to nearest float32: compare neighbours exactly
        cands = [np.float32(g), np.nextafter(g, np.float32(np.inf)),
                 np.nextafter(g, np.float32(-np.inf))]
        errs = [abs(Fraction(float(v)) - exact) for v in cands]
        assert errs[0] <= min(errs[1:]), (ai, bi, ci)
    two_roundings = (a * b + c).astype(np.float32)
    assert (got != two_roundings).any()   # the test can tell them apart


def test_wrappers_check_operands():
    x = torch.zeros((1, 4, 4, 16), dtype=torch.int8)
    w = CQ.pack_conv_weight(torch.zeros((3, 3, 16, 8), dtype=torch.int8))
    m, b = torch.ones(8), torch.zeros(8)
    geo = dict(ksize=(3, 3), stride=(1, 1), pad=((1, 1), (1, 1)))
    with pytest.raises(ValueError, match="int8 activation"):
        CQ.int8_conv(x.float(), w, m, b, 1.0, mode="deq", **geo)
    with pytest.raises(ValueError, match="packed"):
        CQ.int8_conv(x, w[:, :100], m, b, 1.0, mode="deq", **geo)
    with pytest.raises(ValueError, match="s_out"):
        CQ.int8_conv(x, w, m, b, 1.0, mode="relu_q", **geo)
    with pytest.raises(ValueError, match="residual"):
        CQ.int8_conv(x, w, m, b, 1.0, mode="residual", **geo)
    with pytest.raises(ValueError, match="mode"):
        CQ.int8_conv(x, w, m, b, 1.0, mode="bogus", **geo)
    with pytest.raises(ValueError, match="int8 activation"):
        CQ.int8_maxpool3x3s2(x.float())
    assert w.shape == (8, 192) and CQ.K_ALIGN == 64


# ------------------------------------------------------------ fused trunk


def _jit(fn):
    """JAX's function jitted with every tree and scale as an argument."""
    return jax.jit(fn)


@pytest.mark.parametrize("width", [96, 97])
def test_fused_trunk_activations_match_jax(calibrated, width):
    """The stem's int8 output, the pooled stem, every block's int8 output
    and the last block's float32 output equal JAX's (each block fed JAX's
    previous output); the S2D stem equals the 7x7 one; the f32 features
    agree within 1e-6 relative (the mean sums in another order)."""
    jc, pc = calibrated[width]
    x = _images(4, w=width)
    net = PQ.QuantizedPoseNet(pc, fused=True)
    s1 = "layer1_0"

    def jax_stem(q, x, s2d):
        c1 = q["trunk"]["conv1"]
        s_in = JQ._site_scale(c1)
        qx = JQ._q8(x, s_in)
        if s2d:
            qx = JQ.space_to_depth_input(qx)
            acc = JQ._conv_acc(qx, c1, (1, 1), [(2, 1), (2, 1)])
        else:
            acc = JQ._conv_acc(qx, c1, (2, 2), [(3, 3), (3, 3)])
        qy = JQ._q8(jax.nn.relu(JQ._deq(acc, c1, s_in)),
                    JQ._site_scale(q["trunk"][s1]["conv1"]))
        return qy, lax.reduce_window(
            qy, jnp.asarray(-127, jnp.int8), lax.max, (1, 3, 3, 1),
            (1, 2, 2, 1), [(0, 0), (1, 1), (1, 1), (0, 0)])

    want_q, want_p = (np.asarray(v) for v in _jit(
        lambda q, x: jax_stem(q, x, False))(jc, x))
    s2d_q, _ = _jit(lambda q, x: jax_stem(q, x, True))(
        JQ.convert_stem_s2d(jc), x)
    np.testing.assert_array_equal(np.asarray(s2d_q), want_q)
    c1 = net.trunk["conv1"]
    got_q = CQ.int8_conv(PQ._q8(torch.from_numpy(x), c1.x_scale), c1.w,
                         c1.m, c1.b, c1.x_scale, ksize=(7, 7), stride=(2, 2),
                         pad=((3, 3), (3, 3)), mode="relu_q",
                         s_out=net.trunk[s1]["conv1"].x_scale)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(CQ.int8_maxpool3x3s2(got_q).numpy(),
                                  want_p)

    names = [f"layer{s + 1}_{b}" for s in range(4) for b in range(2)]
    cur = want_p
    for i, name in enumerate(names):
        stride = (2, 2) if (i % 2 == 0 and i > 0) else (1, 1)
        qj = jc["trunk"][name]
        nxt = names[i + 1] if i + 1 < len(names) else None
        s_out = jc["trunk"][nxt]["conv1"]["x_scale"] if nxt else None
        want = np.asarray(_jit(
            lambda qx, s_in, q, s_out: JQ._fused_basic_block(
                qx, s_in, q, stride, s_out))(cur, qj["conv1"]["x_scale"], qj,
                                              s_out))
        got = PQ._fused_basic_block(
            torch.from_numpy(cur.copy()), net.trunk[name]["conv1"].x_scale,
            net.trunk[name], stride,
            net.trunk[nxt]["conv1"].x_scale if nxt else None).numpy()
        assert got.dtype == want.dtype == (np.int8 if nxt else np.float32)
        np.testing.assert_array_equal(got, want, err_msg=name)
        cur = want

    want_f = np.asarray(_jit(lambda q, x: JQ._trunk_forward_fused(
        q, x, jnp.float32))(jc, x))
    got_f = PQ._trunk_forward_fused(net, torch.from_numpy(x),
                                    torch.float32).numpy()
    np.testing.assert_allclose(got_f, want_f, rtol=1e-6,
                               atol=1e-6 * np.abs(want_f).max())


def test_prequantized_s2d_input(calibrated):
    """``quantize_input_int8`` + ``space_to_depth_input`` equal JAX's (odd
    width padded high), the row cache holds them frame by frame, and the
    fused S2D trunk on those rows equals the 7x7 trunk on the images."""
    jc, pc = calibrated[97]
    x = _images(5, w=97)
    net = PQ.QuantizedPoseNet(PQ.convert_stem_s2d(pc), fused=True)
    want = np.asarray(_jit(lambda q, x: JQ.space_to_depth_input(
        JQ.quantize_input_int8(q, x)))(jc, x))
    got = PQ.space_to_depth_input(PQ.quantize_input_int8(
        net, torch.from_numpy(x)))
    assert got.dtype == torch.int8 and tuple(got.shape) == (5, 32, 49, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    rows = quantize_rows(torch.from_numpy(x), net, chunk=2)
    assert tuple(rows.shape) == (5, 32 * 49 * 12)
    np.testing.assert_array_equal(rows.view(got.shape).numpy(), want)
    feat_rows = PQ._trunk_forward_fused(net, rows.view(got.shape),
                                        torch.float32)
    feat_img = PQ._trunk_forward_fused(PQ.QuantizedPoseNet(pc, fused=True),
                                       torch.from_numpy(x), torch.float32)
    np.testing.assert_array_equal(feat_rows.numpy(), feat_img.numpy())


# ------------------------------------------------------------------ poses


@pytest.fixture(scope="module")
def bottleneck_variables():
    """A 1-1-1-1 bottleneck trunk (ResNet-50's block: 1x1 stride-1 convs
    and a projection at stride 1)."""
    return _seeded_variables(
        JaxPoseNet(feature_extractor=JaxResNet(stage_sizes=(1, 1, 1, 1),
                                               block_cls=JaxBottleneck),
                   feat_dim=64), (1, 32, 32, 3), seed=1)


@pytest.mark.parametrize("mode", [
    "fused", "fused_s2d", "static", "dynamic", "folded_f32", "folded_bf16",
    "bottleneck_dynamic"])
def test_posenet_apply_matches_jax(variables, bottleneck_variables,
                                   calibrated, mode):
    """``posenet_apply_int8`` (and the folded alias) on the same trees and
    images: poses within INT8_POSE_TOL (BF16_TRUNK_TOL for the bf16 folded
    trunk) of the largest |pose|, or 1e-5 for the float32 folded trunk."""
    jc, pc = calibrated[97]
    x = _images(3, w=97, seed=7)
    dtype = (jnp.bfloat16, torch.bfloat16)
    fused, tol = False, INT8_POSE_TOL
    if mode.startswith("fused"):
        want_t, got_t, fused = jc, pc, True
        if mode == "fused_s2d":
            want_t, got_t = JQ.convert_stem_s2d(jc), PQ.convert_stem_s2d(pc)
    elif mode == "static":
        want_t, got_t = jc, pc
    elif mode == "dynamic":
        want_t = got_t = JQ.quantize_posenet_variables(variables, STAGES,
                                                       quantize_heads=True)
    elif mode.startswith("folded"):
        want_t = JQ.fold_posenet_variables(variables, STAGES)
        got_t = PQ.fold_posenet_variables(variables, STAGES)
        if mode == "folded_f32":
            dtype, tol = (jnp.float32, torch.float32), 1e-5
        else:
            tol = BF16_TRUNK_TOL
    else:
        x = _images(2, h=32, w=33, seed=8)
        want_t = got_t = JQ.quantize_posenet_variables(
            bottleneck_variables, (1, 1, 1, 1))
    apply = JQ.posenet_apply_folded if mode.startswith("folded") else \
        JQ.posenet_apply_int8
    want = np.asarray(jax.jit(lambda q, x: apply(q, x, dtype[0], fused))(
        want_t, x), np.float64)
    net = PQ.QuantizedPoseNet(got_t, dtype[1], fused=fused)
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).double().numpy()
        alias = (PQ.posenet_apply_folded if mode.startswith("folded")
                 else PQ.posenet_apply_int8)
        np.testing.assert_array_equal(
            alias(net, torch.from_numpy(x), dtype[1], fused).double().numpy(),
            got)
    assert got.shape == (len(x), 6) and np.abs(want).max() > 1
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_mapnet_apply_folds_tuples(calibrated):
    _, pc = calibrated[96]
    x = _images(6, seed=9)
    net = PQ.QuantizedPoseNet(pc, fused=True)
    with torch.inference_mode():
        out = PQ.mapnet_apply_int8(net, torch.from_numpy(
            x.reshape(2, 3, 64, 96, 3)), fused=True)
        flat = net(torch.from_numpy(x))
    assert tuple(out.shape) == (2, 3, 6)
    np.testing.assert_array_equal(out.reshape(6, 6).numpy(), flat.numpy())


def test_int_mm_pads_few_rows():
    rng = np.random.RandomState(6)
    a = torch.from_numpy(rng.randint(-127, 128, (5, 64)).astype(np.int8))
    b = torch.from_numpy(rng.randint(-127, 128, (64, 24)).astype(np.int8))
    np.testing.assert_array_equal(PQ._int_mm(a, b).numpy(),
                                  a.numpy().astype(np.int64)
                                  @ b.numpy().astype(np.int64))


# ------------------------------------------------------------ error contracts


def _raises_like_jax(jax_call, port_call):
    """Both calls raise ValueError with the same message."""
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_error_contracts_match_jax(variables, bottleneck_variables,
                                   calibrated):
    jc, pc = calibrated[96]
    dyn = JQ.quantize_posenet_variables(variables, STAGES)
    folded = JQ.fold_posenet_variables(variables, STAGES)
    x = _images(1)
    xt = torch.from_numpy(x)
    # fused without static scales
    _raises_like_jax(
        lambda: JQ.posenet_apply_int8(dyn, x, fused=True),
        lambda: PQ.posenet_apply_int8(PQ.QuantizedPoseNet(dyn), xt,
                                      fused=True))
    # fused over a bottleneck trunk (scales given to every site)
    bq = JQ.quantize_posenet_variables(bottleneck_variables, (1, 1, 1, 1))
    for site in JQ._iter_sites(bq):
        site["x_scale"] = np.float32(0.05)
    _raises_like_jax(
        lambda: JQ.posenet_apply_int8(bq, x, fused=True),
        lambda: PQ.posenet_apply_int8(PQ.QuantizedPoseNet(bq), xt,
                                      fused=True))
    # prequantized int8 input without fused
    qx = JQ.quantize_input_int8(jc, x)
    net = PQ.QuantizedPoseNet(pc)
    _raises_like_jax(
        lambda: JQ.posenet_apply_int8(jc, qx, fused=False),
        lambda: PQ.posenet_apply_int8(net, PQ.quantize_input_int8(net, xt),
                                      fused=False))
    # an S2D tree unfused
    _raises_like_jax(
        lambda: JQ.posenet_apply_int8(JQ.convert_stem_s2d(jc), x),
        lambda: PQ.posenet_apply_int8(
            PQ.QuantizedPoseNet(PQ.convert_stem_s2d(pc)), xt))
    # calibrate after S2D
    _raises_like_jax(
        lambda: JQ.calibrate_activation_scales(JQ.convert_stem_s2d(jc), [x]),
        lambda: PQ.calibrate_activation_scales(PQ.convert_stem_s2d(pc), [x]))
    # calibrate without a batch, S2D of a folded tree, quantize without
    # static scales
    _raises_like_jax(lambda: JQ.calibrate_activation_scales(dyn, []),
                     lambda: PQ.calibrate_activation_scales(dyn, []))
    _raises_like_jax(lambda: JQ.convert_stem_s2d(folded),
                     lambda: PQ.convert_stem_s2d(folded))
    _raises_like_jax(
        lambda: JQ.quantize_input_int8(dyn, x),
        lambda: PQ.quantize_input_int8(PQ.QuantizedPoseNet(dyn), xt))
    with pytest.raises(ValueError, match="static scales"):
        PQ.QuantizedPoseNet(dyn, fused=True)
    s2d = PQ.convert_stem_s2d(pc)
    assert PQ.convert_stem_s2d(s2d)["trunk"]["conv1"]["qkernel"] is \
        s2d["trunk"]["conv1"]["qkernel"]


# ------------------------------------------------------------- on the card


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K1 in every epilogue, through its route for each geometry and
    through the simple route, and K2 equal their plain versions on the card
    (run by ``python -m pytest tests/test_torch_quant.py -m cuda`` there),
    each route counting its own launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels build and run only "
                    "there")
    from test_torch_k1 import EPILOGUES, assert_k1_matches_plain_on_card

    got = assert_k1_matches_plain_on_card(GEOMETRIES)
    routes = [CQ.conv_route(v[0][3]) for v in GEOMETRIES.values()]
    assert set(routes) == set(CQ.ROUTES)
    for route in CQ.ROUTES:
        assert got[f"int8_conv.{route}"] == len(EPILOGUES) * (
            routes.count(route) + (len(routes) if route == "simple" else 0))
    assert got["int8_conv"] == 2 * len(EPILOGUES) * len(GEOMETRIES)
    before = dict(CQ.launches)
    x = torch.randint(-127, 128, (2, 33, 47, 64), dtype=torch.int8,
                      device="cuda")
    assert torch.equal(CQ.int8_maxpool3x3s2(x),
                       CQ.int8_maxpool3x3s2_reference(x))
    assert CQ.launches["int8_maxpool3x3s2"] - before["int8_maxpool3x3s2"] \
        == 1
