"""The persistent LSTM kernel (``geomapnet_tpu_torch/csrc/lstm_persistent.cu``)
behind the ``geomapnet::lstm`` operator, and its plain step loop
(:func:`geomapnet_tpu_torch.ops.cuda_rnn.lstm_reference`).

On the CPU: the plain loop, which the operator runs there, equals
``torch.lstm`` from a zero state; the operator passes
``torch.library.opcheck`` and its CPU outputs have the shapes its fake
implementation gives; the launch plan (units a CTA) and the shapes the
kernel refuses.

On a card (``-m cuda``): the kernel against the plain loop on the card and
against ``torch.lstm`` (cuDNN) at the stream's width (whose window of 200
already needs more than the default 48 KB of shared memory a CTA), at a
ResNet-50 trunk's 2048 features, at the longest window that fits, and at
a small width; two calls and a CUDA-graph replay give the same bits as an
eager call; the wrapper counts a launch a sequence at a capture and none
at a replay; a window over the shared-memory limit and a hidden size over
the register slice raise. No JAX here: the LSTM is held to the Flax cell
in tests/test_torch_vidloc.py.

The weights are drawn as the stream cell draws them: input kernels at a
standard deviation of 1 / sqrt(F) on unit-size inputs, orthogonal
recurrent kernels a gate, biases of 0.1, so the gates' pre-activations are
of unit size.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from geomapnet_tpu_torch.ops import cuda_rnn, library
from geomapnet_tpu_torch.utils.cuda_graph import capture

# float32 rounding alone separates the plain loop from torch.lstm on the
# CPU (the same equations; the gates' matmuls may sum in another order):
# h lies in (-1, 1)
CPU_TOL = 1e-6
# on the card the kernel's dot products sum in its own order (a lane's
# 16 products, then a butterfly), the plain loop's in cuBLAS's and cuDNN's
# in its own, compounded over up to 200 dependent steps
CARD_TOL = 1e-5
H100_SMS = 132


def _params(hidden: int, features: int, bidirectional: bool, seed: int,
            device="cpu") -> list[torch.Tensor]:
    gen = torch.Generator().manual_seed(seed)
    params = []
    for _ in range(2 if bidirectional else 1):
        w_ih = torch.randn((4 * hidden, features), generator=gen)
        q, r = torch.linalg.qr(torch.randn((4, hidden, hidden),
                                           generator=gen))
        q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
        params += [w_ih / features ** 0.5, q.reshape(4 * hidden, hidden),
                   0.1 * torch.randn(4 * hidden, generator=gen),
                   0.1 * torch.randn(4 * hidden, generator=gen)]
    return [p.to(device) for p in params]


def _inputs(batch: int, n: int, features: int, seed: int, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((batch, n, features), generator=gen).to(device)


def _torch_lstm(x, params, bidirectional):
    d = 2 if bidirectional else 1
    h0 = x.new_zeros((d, x.shape[0], params[1].shape[1]))
    return torch.lstm(x, (h0, h0), params, True, 1, 0.0, False,
                      bidirectional, True)[0]


@pytest.mark.parametrize("width", [(32, 24), (512, 512)],
                         ids=["h32_f24", "h512_f512"])
@pytest.mark.parametrize("bidirectional", [False, True],
                         ids=["one_way", "both_ways"])
@pytest.mark.parametrize("n", [1, 2, 37, 200])
def test_plain_loop_equals_torch_lstm(width, bidirectional, n):
    hidden, features = width
    params = _params(hidden, features, bidirectional, seed=n)
    x = _inputs(2, n, features, seed=n + 1)
    got = cuda_rnn.lstm_reference(x, params, bidirectional)
    want = _torch_lstm(x, params, bidirectional)
    assert got.shape == want.shape == (2, n, (1 + bidirectional) * hidden)
    torch.testing.assert_close(got, want, rtol=0, atol=CPU_TOL)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_operator_on_cpu_runs_the_plain_loop_with_the_fake_shapes(
        bidirectional):
    params = _params(20, 12, bidirectional, seed=4)
    x = _inputs(3, 9, 12, seed=5)
    torch.library.opcheck(library.lstm, (x, params, bidirectional))
    got = library.lstm(x, params, bidirectional)
    assert torch.equal(got, cuda_rnn.lstm_reference(x, params,
                                                    bidirectional))
    with FakeTensorMode() as mode:
        fake = library.lstm(mode.from_tensor(x),
                            [mode.from_tensor(p) for p in params],
                            bidirectional)
    assert (fake.shape, fake.dtype) == (got.shape, got.dtype)
    empty = library.lstm(x[:, :0], params, bidirectional)
    assert empty.shape == (3, 0, (1 + bidirectional) * 20)


def test_plan_fills_the_card_and_refuses_what_does_not_fit():
    # the stream's LSTM: 2 x 64 CTAs of 8 units; a ResNet-50 trunk's 2048
    # features fit as well
    for features in (512, 2048):
        assert cuda_rnn.plan(512, features, 200, 2, H100_SMS) == 8
    assert cuda_rnn.plan(512, 512, 200, 1, H100_SMS) == 4
    assert cuda_rnn.plan(20, 12, 37, 2, H100_SMS) == 1
    # 4 x (1024 + 64 T) bytes at 8 units: T = 892 fits, 893 does not
    assert cuda_rnn.plan(512, 512, 892, 2, H100_SMS) == 8
    with pytest.raises(ValueError, match="shared memory"):
        cuda_rnn.plan(512, 512, 893, 2, H100_SMS)
    with pytest.raises(ValueError, match="co-resident"):
        cuda_rnn.plan(512, 512, 200, 3, H100_SMS)
    with pytest.raises(ValueError, match="registers"):
        cuda_rnn.plan(1024, 512, 200, 2, H100_SMS)
    with pytest.raises(ValueError, match="multiples of 4"):
        cuda_rnn.plan(30, 12, 37, 2, H100_SMS)


def test_operator_refuses_weights_that_do_not_fit():
    params = _params(16, 8, True, seed=6)
    x = _inputs(1, 4, 8, seed=7)
    with pytest.raises(ValueError, match="expected 8 tensors"):
        cuda_rnn.lstm(x, params[:4], True)
    with pytest.raises(ValueError, match="do not fit"):
        cuda_rnn.lstm(_inputs(1, 4, 12, seed=7), params, True)
    with pytest.raises(ValueError, match="float32"):
        cuda_rnn.lstm(x.double(), params, True)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel builds and runs only "
                    "there")
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = before


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (512, 512, True, 1, 1), (512, 512, True, 1, 2), (512, 512, True, 1, 199),
    (512, 512, True, 1, 200), (512, 512, False, 1, 200),
    (512, 2048, True, 1, 200), (512, 512, True, 1, 892),
    (20, 12, True, 2, 37), (20, 12, False, 1, 37)],
    ids=lambda c: "h{}_f{}_{}_b{}_n{}".format(
        c[0], c[1], "both" if c[2] else "one", c[3], c[4]))
def test_kernel_matches_the_plain_loop_and_cudnn_on_card(card, case):
    hidden, features, bidirectional, batch, n = case
    params = _params(hidden, features, bidirectional, seed=n, device=card)
    x = _inputs(batch, n, features, seed=n + 1, device=card)
    launched = cuda_rnn.launches
    got = library.lstm(x, params, bidirectional)
    torch.cuda.synchronize()
    assert cuda_rnn.launches == launched + batch
    plain = cuda_rnn.lstm_reference(x, params, bidirectional)
    cudnn = _torch_lstm(x, params, bidirectional)
    torch.testing.assert_close(got, plain, rtol=0, atol=CARD_TOL)
    torch.testing.assert_close(got, cudnn, rtol=0, atol=CARD_TOL)


@pytest.mark.cuda
def test_kernel_is_deterministic_and_replays_from_a_graph(card):
    params = _params(512, 512, True, seed=8, device=card)
    x = _inputs(1, 200, 512, seed=9, device=card)
    first = library.lstm(x, params, True)
    assert torch.equal(library.lstm(x, params, True), first)
    launched = cuda_rnn.launches
    graph, out = capture(lambda: library.lstm(x, params, True), card)
    assert cuda_rnn.launches == launched + 2     # the warm-up, the capture
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert cuda_rnn.launches == launched + 2     # a replay launches nothing
    assert torch.equal(out, first)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1024, 512, 4, "registers"),
                                  (512, 512, 893, "shared memory")],
                         ids=["hidden_1024", "window_893"])
def test_shape_over_the_kernel_limits_raises_on_card(card, case):
    hidden, features, n, match = case
    params = _params(hidden, features, True, seed=10, device=card)
    x = _inputs(1, n, features, seed=11, device=card)
    launched = cuda_rnn.launches
    with pytest.raises(ValueError, match=match):
        library.lstm(x, params, True)
    assert cuda_rnn.launches == launched
