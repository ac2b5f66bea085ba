"""GPipe over gloo ranks on the CPU against the JAX package's
``pipeline_apply`` (tests/test_pipeline.py's cases and bars).

One group of four ranks (:mod:`grid_ranks`) runs every pipelined case;
the parent runs the JAX package on its virtual CPU devices:

- dense+tanh chains with other activation shapes at each boundary:
  forward at 4 stages for 1, 3, 6 and 12 microbatches, one stage, the
  gradients of the replicated ``stage_params`` and of the packed buffer's
  rows at 3 stages, and dp2 x pp2 on a 2x2 ``('data', 'stage')`` grid:
  outputs, losses and gradients within 1e-6 of JAX's (its bar);
- the uint8 transport bit-exact and bf16 within bf16 resolution;
- the PoseNet trunk | head split (the dry run's 2-stage ResNet, feat_dim
  16, 32x32) with the
  weights packed one stage a rank, at S = 2 and at dp2 x pp2: the output
  within 1e-5 of JAX's largest, the loss within 1e-5 relative, the packed
  row's gradient, unpacked and laid out as Flax's, within 1e-3 relative
  norm per leaf (the two packages' conv backward sum in other orders);
- every validation error word for word; the packed buffer byte-equal to
  JAX's for the same pytrees, in JAX's flatten order.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomapnet_tpu.models import PoseNet as JaxPoseNet
from geomapnet_tpu.models import posenet_head_apply as jax_head_apply
from geomapnet_tpu.models.resnet import ResNet as JaxResNet
from geomapnet_tpu.parallel import make_mesh as jax_make_mesh
from geomapnet_tpu.parallel import pipeline as jax_pp
from geomapnet_tpu_torch.models.flax_import import (
    state_dict_to_variables,
    variables_to_state_dict,
)
from geomapnet_tpu_torch.parallel import (
    pack_stage_params,
    stage_shapes,
    unpack_stage_params,
)
import grid_ranks
from dp_ranks import run_group


def _weights(rs, dims):
    return [(rs.randn(a, b) / np.sqrt(a)).astype(np.float32)
            for a, b in zip(dims[:-1], dims[1:])]


def _mlp():
    rs = np.random.RandomState(0)
    return dict(
        w4=_weights(rs, (12, 32, 20, 8, 5)), w1=_weights(rs, (6, 4)),
        w3=_weights(rs, (10, 8, 6, 4)), w2=_weights(rs, (10, 8, 5)),
        x12=rs.randn(12, 12).astype(np.float32),
        x4=rs.randn(4, 6).astype(np.float32),
        x6=rs.randn(6, 10).astype(np.float32),
        targ6=rs.randn(6, 4).astype(np.float32),
        x8=rs.randn(8, 10).astype(np.float32),
        targ8=rs.randn(8, 5).astype(np.float32),
        u8=rs.randint(0, 250, (4, 8)).astype(np.uint8))


@pytest.fixture(scope="module")
def posenet():
    """JAX's PoseNet (feat_dim 16) variables, and the same weights in the
    port's layout."""
    model = JaxPoseNet(feature_extractor=JaxResNet(stage_sizes=(1, 1)),
                       feat_dim=16, droprate=0.5)
    x = np.random.RandomState(2).randn(4, 32, 32, 3).astype(np.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree.map(np.asarray, variables)
    return dict(model=model, variables=variables, x=x,
                torch_state=variables_to_state_dict(variables))


@pytest.fixture(scope="module")
def ranks(posenet):
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(run_group, "grid_ranks:pipeline", 4, mlp=_mlp(),
                        posenet=dict(feat=16, state=posenet["torch_state"],
                                     x=posenet["x"]))


def _tanh(w, a):
    return jnp.tanh(a @ w)


def _closures(ws):
    return [lambda a, w=jnp.asarray(w): jnp.tanh(a @ w) for w in ws]


@pytest.mark.parametrize("m", (1, 3, 6, 12))
def test_forward_matches_jax(ranks, m):
    mlp = _mlp()
    mesh = jax_make_mesh(jax.devices()[:4], ("stage",), (4,))
    want = np.asarray(jax_pp.pipeline_apply(
        _closures(mlp["w4"]), mesh, jnp.asarray(mlp["x12"]), m))
    for r in ranks.result():
        np.testing.assert_allclose(r["forward"][m], want, atol=1e-6)


def test_single_stage_matches_jax(ranks):
    mlp = _mlp()
    mesh = jax_make_mesh(jax.devices()[:1], ("stage",), (1,))
    want = np.asarray(jax_pp.pipeline_apply(
        _closures(mlp["w1"]), mesh, jnp.asarray(mlp["x4"]), 2))
    np.testing.assert_allclose(ranks.result()[0]["single"], want, atol=1e-6)


def test_stage_params_grads_match_jax(ranks):
    """Replicated ``stage_params``: loss and every stage's gradient on
    every stage rank."""
    mlp = _mlp()
    mesh = jax_make_mesh(jax.devices()[:3], ("stage",), (3,))

    def loss(ws):
        out = jax_pp.pipeline_apply([_tanh] * 3, mesh, jnp.asarray(mlp["x6"]),
                                    3, stage_params=ws)
        return jnp.mean((out - mlp["targ6"]) ** 2)

    lval, grads = jax.jit(jax.value_and_grad(loss))([jnp.asarray(w)
                                                     for w in mlp["w3"]])
    for r in ranks.result()[:3]:
        got = r["stage_params"]
        np.testing.assert_allclose(got["loss"], float(lval), rtol=1e-6)
        for g, w in zip(got["grads"], grads):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-6)


def test_packed_grads_match_jax(ranks):
    """The packed buffer, one row a rank: forward, loss and each row's
    gradient (the rank's only weights) equal JAX's sharded buffer's."""
    mlp = _mlp()
    mesh = jax_make_mesh(jax.devices()[:3], ("stage",), (3,))
    buf, meta = jax_pp.shard_stage_params([jnp.asarray(w)
                                           for w in mlp["w3"]], mesh)

    def run(b):
        return jax_pp.pipeline_apply([_tanh] * 3, mesh,
                                     jnp.asarray(mlp["x6"]), 3,
                                     packed_params=b, params_meta=meta)

    def loss(b):
        return jnp.mean((run(b) - mlp["targ6"]) ** 2)

    lval, grads = jax.jit(jax.value_and_grad(loss))(buf)
    grads, fwd = np.asarray(grads), np.asarray(jax.jit(run)(buf))
    for s, r in enumerate(ranks.result()[:3]):
        got = r["packed"]
        assert got["row"].shape == (1, meta.max_size) == (1, 80)
        np.testing.assert_array_equal(got["row"][0], np.asarray(buf)[s])
        np.testing.assert_allclose(got["forward"], fwd, atol=1e-6)
        np.testing.assert_allclose(got["loss"], float(lval), rtol=1e-6)
        np.testing.assert_allclose(got["grad"][0], grads[s], atol=1e-6)


def test_dp_pp_matches_jax(ranks):
    """dp2 x pp2: each data rank pipelines its rows of every microbatch;
    the output is the whole batch and the row's gradient the whole
    batch's, on every rank."""
    mlp = _mlp()
    mesh = jax_make_mesh(jax.devices()[:4], ("data", "stage"), (2, 2))
    buf, meta = jax_pp.shard_stage_params([jnp.asarray(w)
                                           for w in mlp["w2"]], mesh)

    def run(b):
        return jax_pp.pipeline_apply([_tanh] * 2, mesh,
                                     jnp.asarray(mlp["x8"]), 2,
                                     packed_params=b, params_meta=meta,
                                     data_axis="data")

    lval, grads = jax.jit(jax.value_and_grad(
        lambda b: jnp.mean((run(b) - mlp["targ8"]) ** 2)))(buf)
    grads, fwd = np.asarray(grads), np.asarray(jax.jit(run)(buf))
    for r in ranks.result():
        got = r["dpp"]
        np.testing.assert_allclose(got["forward"], fwd, atol=1e-6)
        np.testing.assert_allclose(got["loss"], float(lval), rtol=1e-6)
        np.testing.assert_allclose(got["grad"][0], grads[got["coords"][1]],
                                   atol=1e-6)


def test_transport_matches_jax(ranks):
    """Stage boundaries travel as float32: uint8 exactly, bf16 within its
    resolution (JAX's bar)."""
    mlp = _mlp()
    x = mlp["u8"]
    mesh = jax_make_mesh(jax.devices()[:2], ("stage",), (2,))
    got = ranks.result()[0]["transport"]
    want = np.asarray(jax_pp.pipeline_apply(
        [lambda a: a + 1, lambda a: a.astype(jnp.float32) / 255.0], mesh,
        jnp.asarray(x), 2))
    np.testing.assert_allclose(got["u8"], want, atol=1e-6)
    np.testing.assert_array_equal(got["u8"], (x + 1).astype(np.float32)
                                  / np.float32(255.0))
    want = np.asarray(jax_pp.pipeline_apply(
        [lambda a: (a.astype(jnp.bfloat16) / 255.0) * 2 - 1,
         lambda a: (a * a).astype(jnp.float32)], mesh, jnp.asarray(x), 2))
    np.testing.assert_allclose(got["bf16"], want, atol=1 / 64)


def test_validation_errors_match_jax(ranks):
    """Every validation error of ``pipeline_apply``, word for word."""
    m4 = jax_make_mesh(jax.devices()[:4], ("stage",), (4,))
    m2 = jax_make_mesh(jax.devices()[:2], ("stage",), (2,))
    eye = [lambda a: a] * 2
    add = [lambda w, a: a + w] * 2
    buf, meta = jax_pp.pack_stage_params([jnp.zeros(()), jnp.zeros(())])
    calls = {
        "stage_fns": lambda: jax_pp.pipeline_apply(eye, m4,
                                                   jnp.zeros((4, 6)), 2),
        "microbatches": lambda: jax_pp.pipeline_apply(
            eye, m2, jnp.zeros((5, 6)), 2),
        "meta": lambda: jax_pp.pipeline_apply(add, m2, jnp.zeros((2, 3)), 1,
                                              packed_params=buf),
        "both": lambda: jax_pp.pipeline_apply(
            add, m2, jnp.zeros((2, 3)), 1, packed_params=buf,
            params_meta=meta, stage_params=[jnp.zeros(())] * 2),
        "stage_params": lambda: jax_pp.pipeline_apply(
            add, m2, jnp.zeros((2, 3)), 1, stage_params=[jnp.zeros(())]),
    }
    got = ranks.result()[0]["errors"]
    for name, call in calls.items():
        with pytest.raises(ValueError) as e:
            call()
        assert got[name] == str(e.value), name
    assert tuple(ranks.result()[0]["pack_rows"]) == (2, 6)


def test_data_axis_error_matches_jax():
    """The dp x pp divisibility error (raised before any collective)."""
    from geomapnet_tpu_torch.parallel import Grid, pipeline_apply
    from geomapnet_tpu_torch.parallel.mesh import DataParallel

    one = DataParallel(1, 0, torch.device("cpu"))
    grid = Grid(("data", "stage"), (2, 4), (0, 0), (one, one),
                torch.device("cpu"))
    mesh = jax_make_mesh(jax.devices()[:8], ("data", "stage"), (2, 4))
    with pytest.raises(ValueError) as want:
        jax_pp.pipeline_apply([lambda a: a] * 4, mesh, jnp.zeros((6, 4)), 2,
                              data_axis="data")
    with pytest.raises(ValueError) as got:
        pipeline_apply([lambda a: a] * 4, grid, torch.zeros(6, 4), 2,
                       data_axis="data")
    assert str(got.value) == str(want.value)


def _stage_pytrees():
    rs = np.random.RandomState(3)
    return [
        {"w": rs.randn(2, 3).astype(np.float32),
         "b": {"z": rs.randn(3).astype(np.float32),
               "a": [rs.randn(2).astype(np.float32),
                     np.arange(4, dtype=np.int32)]}},
        {"k": rs.randn(4, 1).astype(np.float32)},
        {},
    ]


def test_pack_is_byte_equal_to_jax():
    """The same pytrees pack into the same float32 buffer, byte for byte:
    JAX's flatten order (dict keys sorted), zero padding, empty stages."""
    trees = _stage_pytrees()
    want, jmeta = jax_pp.pack_stage_params(jax.tree.map(jnp.asarray, trees))
    got, meta = pack_stage_params(jax.tree.map(torch.from_numpy, trees))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    assert meta.sizes == jmeta.sizes and meta.max_size == jmeta.max_size
    # bf16 leaves: the widening is exact in both
    bf = [{"w": jnp.asarray(trees[0]["w"], jnp.bfloat16)}]
    want, _ = jax_pp.pack_stage_params(bf)
    got, _ = pack_stage_params([{"w": torch.from_numpy(trees[0]["w"]).to(
        torch.bfloat16)}])
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


def test_pack_unpack_roundtrip():
    """JAX's round-trip case: dtypes and values come back, rows pad to
    the largest stage."""
    params = [{"w": torch.arange(6.0).reshape(2, 3),
               "b": torch.ones(3, dtype=torch.bfloat16)},
              {"w": torch.full((4, 1), 2.0)}]
    buf, meta = pack_stage_params(params)
    assert tuple(buf.shape) == (2, 9)
    for p, q in zip(params, unpack_stage_params(buf, meta)):
        assert sorted(p) == sorted(q)
        for k in p:
            assert q[k].dtype == p[k].dtype
            assert torch.equal(q[k], p[k])


def test_stage_shapes_match_jax():
    stages = [lambda a: torch.tanh(a @ torch.zeros(6, 4)),
              lambda a: torch.tanh(a @ torch.zeros(4, 3))]
    shapes = stage_shapes(stages, torch.empty(2, 6))
    want = jax_pp.stage_shapes(
        [lambda a: jnp.tanh(a @ jnp.zeros((6, 4))),
         lambda a: jnp.tanh(a @ jnp.zeros((4, 3)))],
        jax.ShapeDtypeStruct((2, 6), jnp.float32))
    assert [tuple(s.shape) for _, s in shapes] == \
        [tuple(s.shape) for _, s in want] == [(2, 4), (2, 3)]


@pytest.mark.parametrize("leg", ("pp2", "dp2xpp2"))
def test_posenet_split_matches_jax(posenet, ranks, leg):
    """The trunk | head split with packed weights: forward, loss and the
    packed row's gradient against JAX's ``pipeline_apply`` under
    ``jax.value_and_grad``."""
    model, v = posenet["model"], posenet["variables"]
    trunk = model.feature_extractor
    tvars = {"params": v["params"]["feature_extractor"],
             "batch_stats": v["batch_stats"]["feature_extractor"]}
    head = {k: v["params"][k] for k in ("fc_feat", "fc_xyz", "fc_wpqr")}
    shape, axes = ((2,), ("stage",)) if leg == "pp2" else \
        ((2, 2), ("data", "stage"))
    mesh = jax_make_mesh(jax.devices()[:int(np.prod(shape))], axes, shape)
    buf, meta = jax_pp.shard_stage_params([tvars, head], mesh)
    fns = [lambda p, a: trunk.apply(p, a, train=False),
           lambda p, a: jax_head_apply(p, a)]
    data = "data" if leg == "dp2xpp2" else None

    def run(b):
        return jax_pp.pipeline_apply(fns, mesh, jnp.asarray(posenet["x"]), 2,
                                     packed_params=b, params_meta=meta,
                                     data_axis=data)

    lval, grads = jax.jit(jax.value_and_grad(
        lambda b: jnp.mean(run(b) ** 2)))(buf)
    out = np.asarray(jax.jit(run)(buf))
    jtrunk, jhead = jax_pp.unpack_stage_params(grads, meta)

    from geomapnet_tpu_torch.dryrun import stage_params
    from geomapnet_tpu_torch.models.posenet import PoseNet
    from geomapnet_tpu_torch.models.resnet import ResNet

    net = PoseNet(ResNet(stage_sizes=(1, 1)), feat_dim=16)
    net.load_state_dict(posenet["torch_state"])
    _, tmeta = pack_stage_params(stage_params(net))
    held = [r["posenet"][leg] for r in ranks.result() if leg in r["posenet"]]
    assert len(held) == int(np.prod(shape))     # the grid's ranks
    for got in held:
        assert np.abs(got["forward"] - out).max() <= 1e-5 * np.abs(out).max()
        np.testing.assert_allclose(got["loss"], float(lval), rtol=1e-5)
        s = got["stage"]
        rows = torch.zeros(2, tmeta.max_size)
        rows[s] = torch.from_numpy(got["grad"][0])
        part = unpack_stage_params(rows, tmeta)[s]
        if s == 0:
            pairs = _trunk_pairs(part, jtrunk)
        else:
            pairs = [(f"{k}/{n}", part[k][t].numpy().T if n == "kernel"
                      else part[k][t].numpy(), np.asarray(jhead[k][n]))
                     for k in part for t, n in (("weight", "kernel"),
                                                ("bias", "bias"))]
        for name, g, w in pairs:
            err = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-9)
            assert err < 1e-3, (leg, name, err)


def _trunk_pairs(part: dict, jtrunk: dict) -> list:
    """(name, port gradient, JAX gradient) of every trunk parameter and
    BatchNorm statistic (eval mode reads them: both packages differentiate
    them), the port's laid out as Flax's."""
    flax = state_dict_to_variables(part)
    out = []

    def walk(a, b, path):
        for k in b:
            if isinstance(b[k], dict):
                walk(a[k], b[k], path + (k,))
            else:
                out.append(("/".join(path + (k,)), a[k], np.asarray(b[k])))

    for coll in ("params", "batch_stats"):
        walk(flax[coll], jtrunk[coll], (coll,))
    return out


def test_exchange_through_all_gather_matches_p2p():
    """A gloo group on cards exchanges rows and activations through one
    all-gather of fixed-size slots (its point-to-point sends host memory
    only): forced on the CPU, the spatial eval and a 4-stage packed
    pipeline give the point-to-point results, bit for bit."""
    mlp = _mlp()
    rs = np.random.RandomState(7)
    torch.manual_seed(0)
    state = grid_ranks._tiny_mapnet(32).posenet.state_dict()
    ranks = run_group(
        "grid_ranks:all_gather_exchange", 4,
        spatial=dict(feat=32, state=state,
                     images=rs.randn(1, 3, 32, 32, 3).astype(np.float32)),
        mlp=mlp)
    for r in ranks:
        for k in ("spatial", "forward", "grad"):
            np.testing.assert_array_equal(r["all_gather"][k], r["p2p"][k],
                                          err_msg=k)
