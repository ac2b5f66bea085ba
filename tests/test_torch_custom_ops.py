"""K1, K2 and K4 as ``torch.library`` operators (geomapnet_tpu_torch.ops.library).

``torch.library.opcheck`` holds each operator's schema, fake (meta)
implementation and dispatch to its real one, in every K1 epilogue and both
K4 layouts and types; on CPU tensors the operator equals the kernel's plain
version bit for bit. A model routes through the operators only while it is
traced (:func:`~geomapnet_tpu_torch.ops.library.tracing`); the eager paths
keep their prepared ctypes launches. No JAX here: the plain versions are
held to JAX in tests/test_torch_quant.py and tests/test_torch_ops_image.py.
"""

import numpy as np
import pytest
import torch

from geomapnet_tpu_torch.ops import cuda_image
from geomapnet_tpu_torch.ops import cuda_quant as CQ
from geomapnet_tpu_torch.ops import library

MEAN, STD = (0.45, 0.45, 0.46), (0.28, 0.27, 0.26)


def _conv_case(mode, residual=None, s_out=True, out_dtype=torch.float32,
               seed=0, n=2):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(-127, 128, (n, 9, 11, 16))
                         .astype(np.int8))
    qk = rng.randint(-127, 128, (3, 3, 16, 32)).astype(np.int8)
    w = CQ.pack_conv_weight(qk)
    m = torch.from_numpy(rng.uniform(1e-3, 2e-3, 32).astype(np.float32))
    b = torch.from_numpy(rng.randn(32).astype(np.float32))
    scale = torch.tensor(0.02, dtype=torch.float32)
    kw = dict(ksize=(3, 3), stride=(2, 2), pad=((1, 1), (1, 1)), mode=mode,
              s_out=torch.tensor(0.05, dtype=torch.float32)
              if s_out and mode in ("relu_q", "residual") else None,
              out_dtype=out_dtype)
    if residual == "float":
        kw["residual"] = torch.from_numpy(
            rng.randn(n, 5, 6, 32).astype(np.float32))
    elif residual == "int8":
        kw["residual"] = torch.from_numpy(
            rng.randint(-127, 128, (n, 5, 6, 32)).astype(np.int8))
        kw["res_scale"] = torch.tensor(0.03, dtype=torch.float32)
    return (x, w, m, b, scale), kw


CONV_CASES = {
    "acc": dict(mode="acc"),
    "deq_f32": dict(mode="deq"),
    "deq_bf16": dict(mode="deq", out_dtype=torch.bfloat16),
    "relu_q": dict(mode="relu_q"),
    "residual_float_f32_out": dict(mode="residual", residual="float",
                                   s_out=False),
    "residual_int8_q": dict(mode="residual", residual="int8"),
}


def _op_args(args, kw):
    x, w, m, b, s_in = args
    (pt, pb), (pl, pr) = kw["pad"]
    return (x, w, m, b, s_in, list(kw["ksize"]), list(kw["stride"]),
            [pt, pb, pl, pr], kw["mode"], kw["s_out"], kw.get("residual"),
            kw.get("res_scale"), kw["out_dtype"])


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_int8_conv_op(case):
    args, kw = _conv_case(**CONV_CASES[case])
    torch.library.opcheck(library._int8_conv_op, _op_args(args, kw))
    got = library.int8_conv(*args, **kw)
    want = CQ.int8_conv_reference(*args, **kw)
    assert got.dtype == want.dtype and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(2, 9, 11, 16), (1, 8, 8, 32)])
def test_int8_maxpool_op(shape):
    x = torch.from_numpy(np.random.RandomState(1).randint(
        -127, 128, shape).astype(np.int8))
    torch.library.opcheck(library.int8_maxpool3x3s2, (x,))
    assert torch.equal(library.int8_maxpool3x3s2(x),
                       CQ.int8_maxpool3x3s2_reference(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("planar", [False, True])
def test_demosaic_op(dtype, planar):
    raw = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (3, 8, 12)).astype(np.uint8))
    torch.library.opcheck(library._demosaic_op,
                          (raw, list(MEAN), list(STD), dtype, planar))
    got = library.demosaic_half_normalize(raw, MEAN, STD, dtype, planar)
    want = cuda_image.demosaic_half_normalize_reference(raw, MEAN, STD, dtype,
                                                        planar)
    assert got.dtype == dtype and torch.equal(got, want)


def test_fake_implementations_give_symbolic_batch_shapes():
    """Under a fake-tensor mode the operators give the real outputs' shapes
    and dtypes without running anything."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cases = [(_conv_case(**c), c) for c in CONV_CASES.values()]
    real = [CQ.int8_conv_reference(*a, **kw) for (a, kw), _ in cases]
    raw = torch.zeros((4, 8, 12), dtype=torch.uint8)
    with FakeTensorMode() as mode:
        for ((args, kw), _), want in zip(cases, real):
            fake_args = [mode.from_tensor(t) for t in args]
            fake_kw = {k: mode.from_tensor(v) if isinstance(v, torch.Tensor)
                       else v for k, v in kw.items()}
            out = library.int8_conv(*fake_args, **fake_kw)
            assert out.shape == want.shape and out.dtype == want.dtype
        pool = library.int8_maxpool3x3s2(mode.from_tensor(
            torch.zeros((2, 9, 11, 16), dtype=torch.int8)))
        assert pool.shape == (2, 5, 6, 16) and pool.dtype == torch.int8
        img = library.demosaic_half_normalize(mode.from_tensor(raw), MEAN,
                                              STD, torch.float32, True)
        assert img.shape == (4, 3, 4, 6) and img.dtype == torch.float32


def test_tracing_only_under_export():
    """``tracing()`` is off on the eager paths and on while torch.export
    traces a module."""
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen.append(library.tracing())
            return x * 2

    assert not library.tracing()
    torch.export.export(Probe(), (torch.zeros(2, 3),))
    assert seen and all(seen)
    assert not library.tracing()


def test_eager_sites_keep_their_prepared_launches(monkeypatch):
    """Outside a trace a quantized site launches through its
    ``PreparedConv``, never through the operator."""
    from geomapnet_tpu_torch.models import quant as PQ

    args, kw = _conv_case(mode="relu_q")
    calls = []
    monkeypatch.setattr(library, "_int8_conv_op",
                        lambda *a: calls.append(a))
    x, w, m, b, s_in = args
    prepared = CQ.PreparedConv(w, m, b, (3, 3))
    site = PQ._Site.__new__(PQ._Site)
    torch.nn.Module.__init__(site)
    site.w, site.m, site.b, site.ksize, site._k1 = w, m, b, (3, 3), None
    out = site.conv(x, s_in, stride=kw["stride"], pad=kw["pad"],
                    mode="relu_q", s_out=kw["s_out"])
    assert not calls and isinstance(site._k1, CQ.PreparedConv)
    assert torch.equal(out, prepared(x, s_in, stride=kw["stride"],
                                     pad=kw["pad"], mode="relu_q",
                                     s_out=kw["s_out"]))
    monkeypatch.setattr(library, "tracing", lambda: True)
    site.conv(x, s_in, stride=kw["stride"], pad=kw["pad"], mode="relu_q",
              s_out=kw["s_out"])
    assert len(calls) == 1


@pytest.mark.cuda
def test_ops_launch_the_kernels_on_card():
    """On the card each operator launches its kernel (counted by the
    wrapper) and equals the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels build and run only "
                    "there")
    args, kw = _conv_case(mode="residual", residual="int8")
    dev = [t.cuda() for t in args]
    dkw = {k: v.cuda() if isinstance(v, torch.Tensor) else v
           for k, v in kw.items()}
    before = dict(CQ.launches)
    got = library.int8_conv(*dev, **dkw)
    assert torch.equal(got.cpu(), CQ.int8_conv_reference(*args, **kw))
    assert CQ.launches["int8_conv"] == before["int8_conv"] + 1
    x = dev[0]
    assert torch.equal(library.int8_maxpool3x3s2(x).cpu(),
                       CQ.int8_maxpool3x3s2_reference(args[0]))
    assert CQ.launches["int8_maxpool3x3s2"] == \
        before["int8_maxpool3x3s2"] + 1
    raw = torch.randint(0, 256, (2, 8, 12), dtype=torch.uint8)
    k4 = cuda_image.launches
    got = library.demosaic_half_normalize(raw.cuda(), MEAN, STD,
                                          torch.float32, True)
    assert torch.equal(got.cpu(), cuda_image.demosaic_half_normalize_reference(
        raw, MEAN, STD, torch.float32, True))
    assert cuda_image.launches == k4 + 1
