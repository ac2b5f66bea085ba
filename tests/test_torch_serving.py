"""Serving artifacts (geomapnet_tpu_torch.serving, torch.export) against the
port's eager model and the JAX package's jax.export artifacts.

The six cases of tests/test_serving.py, on the same model (MapNet or
PoseNet, ResNet-18, feat_dim 32) with the same numpy-seeded Flax weights in
both packages (the port's through ``flax_import``):

- round trip: the float32 artifact equals the port's eager forward and
  agrees with JAX's artifact within 1e-4;
- batches 1, 3 and 5 through one artifact (a symbolic batch);
- the uint8 normalize fused in front of the model;
- the int8 artifact (dynamic scales) tracks the float one, equals the
  in-process ``QuantizedPoseNet`` and agrees with JAX's int8 artifact;
- the ``fuse_requant`` artifact: bit-equal to the in-process fused
  forward, every int8 activation of its graph equal to JAX's fused chain
  (jitted with the tree and scales as arguments, so XLA contracts the
  dequant into one FMA as the plain kernels emulate), its poses within the
  bf16 heads' tolerance of JAX's artifact;
- the error contract of ``fuse_requant``.

Beyond them: a bf16 artifact keeps the port's bf16 placement; a raw-Bayer
artifact holds the demosaic kernel (K4) as an operator; ``platforms`` is
enforced at load; the loaded module's ``.to()`` moves every tensor; an
export leaves the eager paths' caches untouched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geomapnet_tpu.models.quant as JQ
from geomapnet_tpu.models import MapNet as JaxMapNet
from geomapnet_tpu.models import PoseNet as JaxPoseNet
from geomapnet_tpu.models import resnet18 as jax_resnet18
from geomapnet_tpu.ops.image import normalize as jax_normalize
from geomapnet_tpu.serving import export_inference as jax_export
from geomapnet_tpu.serving import load_inference as jax_load
from geomapnet_tpu.train.state import TrainState
from geomapnet_tpu_torch import serving
from geomapnet_tpu_torch.models import quant as PQ
from geomapnet_tpu_torch.models.flax_import import variables_to_state_dict
from geomapnet_tpu_torch.models.posenet import MapNet, PoseNet
from geomapnet_tpu_torch.models.resnet import resnet18
from geomapnet_tpu_torch.ops import image as port_image
from geomapnet_tpu_torch.ops import library
from test_torch_train_step import one_torch_thread  # noqa: F401

FEAT = 32
F32_TOL = 1e-4
# int8 heads run in bf16, rounded at other places by XLA and PyTorch (as
# tests/test_torch_quant.py's INT8_POSE_TOL)
INT8_POSE_TOL = 0.01
MEAN, STD = (0.5,) * 3, (0.25,) * 3


def _seeded(model, shape, seed=0) -> dict:
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
def weights():
    """PoseNet-rooted Flax variables, seeded."""
    return _seeded(JaxPoseNet(feature_extractor=jax_resnet18(),
                              feat_dim=FEAT, droprate=0.0), (1, 32, 32, 3))


def _jax_model_state(variables, tuple_model: bool):
    posenet = JaxPoseNet(feature_extractor=jax_resnet18(), feat_dim=FEAT,
                         droprate=0.0)
    if tuple_model:
        v = {k: {"posenet": t} for k, t in variables.items()}
        model = JaxMapNet(posenet=posenet)
    else:
        v, model = variables, posenet
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params={"model": v["params"]},
                       batch_stats=v["batch_stats"], opt_state=None)
    return model, state


def _port_model(variables, tuple_model: bool, dtype=torch.float32):
    posenet = PoseNet(feature_extractor=resnet18(dtype), droprate=0.0,
                      feat_dim=FEAT, dtype=dtype)
    posenet.load_state_dict(variables_to_state_dict(variables))
    model = MapNet(posenet) if tuple_model else posenet
    return model.eval()


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _eager(model, x):
    with torch.inference_mode():
        return model(x)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), \
        np.abs(got - want).max() / np.abs(want).max()


def test_export_roundtrip_matches_eager_and_jax(weights, tmp_path):
    model = _port_model(weights, True)
    blob = serving.export_inference(model, None, (3, 32, 32, 3),
                                    dtype=torch.float32)
    path = tmp_path / "mapnet.pt2"
    path.write_bytes(blob)
    infer = serving.load_inference(path, device="cpu")
    x = _x((2, 3, 32, 32, 3))
    got = infer(torch.from_numpy(x))
    assert got.shape == (2, 3, 6) and got.dtype == torch.float32
    assert torch.equal(got, _eager(model, torch.from_numpy(x)))

    jmodel, jstate = _jax_model_state(weights, True)
    want = jax_load(jax_export(jmodel, jstate, (3, 32, 32, 3),
                               dtype=jnp.float32))(x)
    _close(got.numpy(), want, F32_TOL)


def test_batch_polymorphism(weights):
    model = _port_model(weights, True)
    infer = serving.load_inference(
        serving.export_inference(model, None, (3, 32, 32, 3),
                                 dtype=torch.float32), device="cpu")
    for b in (1, 3, 5):
        x = torch.from_numpy(_x((b, 3, 32, 32, 3), seed=b))
        out = infer(x)
        assert out.shape == (b, 3, 6)
        assert torch.equal(out, _eager(model, x))


def test_export_with_fused_preprocess(weights):
    """A uint8 artifact: the device normalize runs inside it."""
    model = _port_model(weights, True)

    def preprocess(u8):
        return port_image.normalize(u8, MEAN, STD)

    infer = serving.load_inference(serving.export_inference(
        model, None, (3, 32, 32, 3), dtype=torch.uint8,
        preprocess=preprocess), device="cpu")
    u8 = np.random.RandomState(0).randint(0, 256, (2, 3, 32, 32, 3)
                                          ).astype(np.uint8)
    got = infer(torch.from_numpy(u8))
    assert torch.equal(got, _eager(model, preprocess(torch.from_numpy(u8))))

    jmodel, jstate = _jax_model_state(weights, True)
    want = jax_load(jax_export(
        jmodel, jstate, (3, 32, 32, 3), dtype=jnp.uint8,
        preprocess=lambda x: jax_normalize(x, MEAN, STD)))(u8)
    _close(got.numpy(), want, F32_TOL)


def test_quantized_export_roundtrip(weights):
    """int8 with dynamic scales: tracks the float artifact (JAX's bound),
    equals the in-process int8 forward, agrees with JAX's int8 artifact."""
    model = _port_model(weights, False)
    fblob = serving.export_inference(model, None, (32, 48, 3),
                                     dtype=torch.float32)
    qblob = serving.export_inference(model, None, (32, 48, 3),
                                     dtype=torch.float32, quantize=True)
    x = _x((3, 32, 48, 3))
    ref = serving.load_inference(fblob, "cpu")(torch.from_numpy(x)).numpy()
    got = serving.load_inference(qblob, "cpu")(torch.from_numpy(x))
    assert got.shape == ref.shape == (3, 6)
    assert np.abs(got.numpy() - ref).max() / (np.abs(ref).mean() + 1e-9) \
        < 0.1
    qtree = PQ.quantize_posenet_variables(weights, (2, 2, 2, 2))
    net = PQ.QuantizedPoseNet(qtree, torch.bfloat16)
    assert torch.equal(got, _eager(net, torch.from_numpy(x)))

    jmodel, jstate = _jax_model_state(weights, False)
    want = jax_load(jax_export(jmodel, jstate, (32, 48, 3),
                               dtype=jnp.float32, quantize=True))(x)
    _close(got.numpy(), want, INT8_POSE_TOL)


def _int8_activations(infer, x):
    """The int8 outputs of the artifact's K1 / K2 nodes, in graph order:
    the stem, the pooled stem, each block's residual conv."""
    acts = []

    class Capture(torch.fx.Interpreter):
        def call_function(self, target, args, kwargs):
            out = super().call_function(target, args, kwargs)
            if target is torch.ops.geomapnet.int8_maxpool3x3s2.default:
                acts.append(("pool", out))
            elif target is torch.ops.geomapnet.int8_conv.default:
                mode = args[8]
                if mode == "residual" or not acts:
                    acts.append((mode, out))
            return out

    with torch.inference_mode():
        poses = Capture(infer.module).run(x)
    return poses, acts


def test_fused_requant_export_matches_in_process(weights, tmp_path):
    """The serving configuration (int8, calibrated scales, int8 heads,
    fused requant): the artifact reproduces the in-process fused forward
    exactly; each int8 activation equals JAX's; poses agree with JAX's
    artifact within the bf16 heads' tolerance."""
    model = _port_model(weights, True)
    calib = [_x((2, 3, 32, 32, 3), seed=9)]
    blob = serving.export_inference(
        model, None, (3, 32, 32, 3), dtype=torch.float32, quantize=True,
        calib_data=calib, quantize_heads=True, fuse_requant=True)
    path = tmp_path / "mapnet_int8_fused.pt2"
    path.write_bytes(blob)
    infer = serving.load_inference(path, "cpu")

    qtree = PQ.calibrate_activation_scales(
        PQ.quantize_posenet_variables(weights, (2, 2, 2, 2),
                                      quantize_heads=True), calib)
    net = PQ.QuantizedPoseNet(qtree, torch.bfloat16, fused=True)
    x = _x((2, 3, 32, 32, 3))
    got, acts = _int8_activations(infer, torch.from_numpy(x))
    assert got.shape == (2, 3, 6)
    assert torch.equal(got, _eager(
        lambda v: PQ.mapnet_apply_int8(net, v, fused=True),
        torch.from_numpy(x)))

    jq = JQ.calibrate_activation_scales(
        JQ.quantize_posenet_variables(weights, (2, 2, 2, 2),
                                      quantize_heads=True), calib)
    flat = x.reshape(6, 32, 32, 3)

    def stem(q, x):
        c1 = q["trunk"]["conv1"]
        s_in = JQ._site_scale(c1)
        acc = JQ._conv_acc(JQ._q8(x, s_in), c1, (2, 2), [(3, 3), (3, 3)])
        qy = JQ._q8(jax.nn.relu(JQ._deq(acc, c1, s_in)),
                    JQ._site_scale(q["trunk"]["layer1_0"]["conv1"]))
        return qy, jax.lax.reduce_window(
            qy, jnp.asarray(-127, jnp.int8), jax.lax.max, (1, 3, 3, 1),
            (1, 2, 2, 1), [(0, 0), (1, 1), (1, 1), (0, 0)])

    want = [np.asarray(v) for v in jax.jit(stem)(jq, flat)]
    names = [f"layer{s + 1}_{b}" for s in range(4) for b in range(2)]
    cur = want[1]
    for i, name in enumerate(names):
        stride = (2, 2) if (i % 2 == 0 and i > 0) else (1, 1)
        nxt = names[i + 1] if i + 1 < len(names) else None
        s_out = jq["trunk"][nxt]["conv1"]["x_scale"] if nxt else None
        cur = np.asarray(jax.jit(
            lambda qx, s_in, q, s_out: JQ._fused_basic_block(
                qx, s_in, q, stride, s_out))(
            cur, jq["trunk"][name]["conv1"]["x_scale"], jq["trunk"][name],
            s_out))
        want.append(cur)
    assert [k for k, _ in acts] == ["relu_q", "pool"] + ["residual"] * 8
    for (kind, a), w in zip(acts, want):
        assert a.dtype == (torch.int8 if w.dtype == np.int8
                           else torch.float32)
        np.testing.assert_array_equal(a.numpy(), w, err_msg=kind)

    jmodel, jstate = _jax_model_state(weights, True)
    jblob = jax_export(jmodel, jstate, (3, 32, 32, 3), dtype=jnp.float32,
                       quantize=True, calib_data=calib, quantize_heads=True,
                       fuse_requant=True)
    _close(got.numpy(), jax_load(jblob)(x), INT8_POSE_TOL)


def test_fused_requant_export_error_contract(weights):
    """fuse_requant demands quantize + calib_data (JAX's contract and
    messages), and a fusable (basic-block) trunk."""
    model = _port_model(weights, True)
    with pytest.raises(ValueError, match="calib_data"):
        serving.export_inference(model, None, (3, 32, 32, 3), quantize=True,
                                 fuse_requant=True)
    with pytest.raises(ValueError, match="calib_data"):
        serving.export_inference(model, None, (3, 32, 32, 3), fold_bn=True,
                                 fuse_requant=True)
    jmodel, jstate = _jax_model_state(weights, True)
    for kw in (dict(quantize=True), dict(fold_bn=True)):
        with pytest.raises(ValueError, match="calib_data"):
            jax_export(jmodel, jstate, (3, 32, 32, 3), fuse_requant=True,
                       **kw)


def test_bf16_artifact_keeps_the_placement(weights):
    """A bf16 model exports with Flax's placement (convs and dense layers
    in bf16, BatchNorm and the residual in float32) and equals its eager
    forward; the BN-folded artifact equals the in-process folded forward."""
    model = _port_model(weights, True, torch.bfloat16)
    blob = serving.export_inference(model, None, (3, 32, 32, 3),
                                    dtype=torch.float32)
    x = torch.from_numpy(_x((2, 3, 32, 32, 3)))
    assert torch.equal(serving.load_inference(blob, "cpu")(x),
                       _eager(model, x))
    import io

    program = torch.export.load(io.BytesIO(blob))
    kinds = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and ("conv" in name
                                           or "batch_norm" in name):
            val = node.meta["val"]
            val = val[0] if isinstance(val, (tuple, list)) else val
            kinds.setdefault("conv" if "conv" in name else "bn",
                             set()).add(val.dtype)
    assert kinds == {"conv": {torch.bfloat16}, "bn": {torch.float32}}

    folded = serving.export_inference(model, None, (3, 32, 32, 3),
                                      dtype=torch.float32, fold_bn=True)
    net = PQ.QuantizedPoseNet(PQ.fold_posenet_variables(weights, (2, 2, 2, 2)),
                              torch.bfloat16)
    assert torch.equal(serving.load_inference(folded, "cpu")(x), _eager(
        lambda v: PQ.mapnet_apply_folded(net, v), x))


def test_raw_bayer_artifact_holds_the_demosaic_op(weights, tmp_path):
    """The raw-Bayer pipeline as ``preprocess``: K4 is an operator node of
    the graph, and the artifact equals the eager pipeline + model."""
    from geomapnet_tpu_torch.cli.builders import build_raw_device_preprocess

    (tmp_path / "RobotCar" / "loop").mkdir(parents=True)
    np.savetxt(tmp_path / "RobotCar" / "loop" / "stats.txt",
               np.array([[0.45, 0.45, 0.46], [0.078, 0.077, 0.072]]))
    pre = build_raw_device_preprocess("loop", str(tmp_path),
                                      raw_size=(32, 48), resize=16)
    model = _port_model(weights, True)
    infer = serving.load_inference(serving.export_inference(
        model, None, (3, 32, 48), dtype=torch.uint8, preprocess=pre), "cpu")
    ops = [n.target for n in infer.module.graph.nodes
           if n.op == "call_function"]
    assert ops.count(torch.ops.geomapnet.demosaic_half_normalize.default) == 1
    raw = torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, (2, 3, 32, 48)).astype(np.uint8))
    assert torch.equal(infer(raw), _eager(model, pre(raw)))


def test_platforms_and_moving_the_loaded_module(weights):
    model = _port_model(weights, False)
    with pytest.raises(ValueError, match="platforms"):
        serving.export_inference(model, None, (32, 32, 3),
                                 platforms=("tpu",))
    blob = serving.export_inference(
        model, None, (32, 32, 3), dtype=torch.uint8,
        preprocess=lambda u: port_image.normalize(u, MEAN, STD),
        platforms=("cpu",))
    with pytest.raises(ValueError, match="exported for"):
        serving.load_inference(blob, "cuda")
    infer = serving.load_inference(blob, "cpu")
    assert infer.platforms == ("cpu",)
    # the normalize constants are buffers now: .to() moves every tensor
    module = infer.module.to("meta")
    tensors = list(module.parameters()) + list(module.buffers())
    assert tensors and all(t.device.type == "meta" for t in tensors)
    assert not [k for m in module.modules() for k, v in vars(m).items()
                if isinstance(v, torch.Tensor)]


def test_export_leaves_eager_caches_alone(weights):
    """Tensors made while tracing belong to the trace: the normalize and
    resize caches of the eager paths do not keep them, and ``tracing()`` is
    off again after the export."""
    port_image._float32_constant.cache_clear()
    port_image._resize_weights.cache_clear()
    model = _port_model(weights, False)
    serving.export_inference(
        model, None, (32, 32, 3), dtype=torch.uint8,
        preprocess=lambda u: port_image.normalize(u, MEAN, STD))
    assert port_image._float32_constant.cache_info().currsize == 0
    assert port_image._resize_weights.cache_info().currsize == 0
    assert not library.tracing()
    u8 = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, (2, 32, 32, 3)).astype(np.uint8))
    out = port_image.normalize(u8, MEAN, STD)
    assert type(out) is torch.Tensor and torch.isfinite(out).all()
    assert model.training is False
