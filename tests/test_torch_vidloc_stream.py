"""The VidLoc streaming artifact and its session against the plain
reference (``benchmark/reference/vidloc.py``: the ResNet trunk of
``benchmark/reference/mapnet.py`` and the LSTM written as its gate
equations), on the CPU at a small size: a ResNet-18 trunk, 16 hidden units
a direction, a window of T = 7, 64x80 uint8 frames normalized inside the
trunk program.

- export, load and a session's steps round-trip on the CPU; the session's
  poses match the reference's full forward over the same frames for a
  window that grows after ``open``, a full window, and a ring that has
  wrapped twice;
- a stale ring slot (the window one frame behind), a dropped backward
  direction and a state carried from one window to the next each miss the
  reference by more than the tolerance;
- ``serving.stream_frames`` counts each frame through the trunk once and
  each window's frames through the recurrence;
- on a card (``-m cuda``), a session that replays CUDA graphs for its full
  windows gives the eager session's poses; and a session of a ResNet-50
  trunk (2048 features into an LSTM of 512 a direction, as ``cli.tools
  export_model --model vidloc --trunk resnet50`` builds it) gives the
  poses of the model's own forward, whose ``nn.LSTM`` runs on cuDNN.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import vidloc as ref
from geomapnet_tpu_torch import serving
from geomapnet_tpu_torch.models import VidLoc
from geomapnet_tpu_torch.models.posenet import MapNet, PoseNet
from geomapnet_tpu_torch.models.resnet import resnet18, resnet50
from geomapnet_tpu_torch.ops.image import normalize

T, H, W, HIDDEN = 7, 64, 80, 16
MEAN, STD = (0.5, 0.45, 0.4), (0.25, 0.22, 0.2)
# float32 rounding alone separates the two: the port's trunk runs NHWC and
# the reference's NCHW (sums in another order), the reference takes the
# std as the root of the variance, and aten's LSTM and the gate equations
# group the gates' matmuls differently. Measured at 4.3e-6 of the poses'
# scale here; 1e-4 leaves twenty times that, and the planted faults below
# move the poses by about half their scale
TOL = 1e-4


def preprocess(frames: torch.Tensor) -> torch.Tensor:
    return normalize(frames, MEAN, STD, dtype=torch.float32)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(3)
    m = VidLoc(resnet18(), hidden_size=HIDDEN).eval()
    # BatchNorm statistics of a trained trunk, not the identity
    with torch.no_grad():
        for name, buf in m.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.1)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    return m


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(5)
    return torch.from_numpy(rng.integers(0, 256, (40, H, W, 3), np.uint8))


@pytest.fixture(scope="module")
def stream(model):
    blob = serving.export_inference(model, None, frame_shape=(H, W, 3),
                                    dtype=torch.uint8, preprocess=preprocess,
                                    window=T)
    return serving.load_inference(blob, "cpu")


@pytest.fixture(scope="module")
def reference(model, frames):
    """Every frame's reference trunk features, and the reference poses of
    the window of frames ``lo..hi``."""
    state = {k: v.detach() for k, v in model.state_dict().items()}
    stats = (MEAN, tuple(s * s for s in STD))
    feats = ref.frame_features(frames, np.arange(len(frames)), state,
                               (2, 2, 2, 2), stats)

    def poses(lo: int, hi: int) -> np.ndarray:
        return ref.window_poses(state, feats, np.arange(lo, hi + 1)[None])[0]

    return state, feats, poses


def _gap(got: torch.Tensor, want: np.ndarray) -> float:
    """The largest difference over the poses' scale."""
    got = got.double().numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _steps(session, frames, first: int, last: int) -> list:
    return [session.step(frames[i]) for i in range(first, last + 1)]


def test_stream_matches_the_reference_growing_full_and_wrapped(
        stream, frames, reference):
    """Primed with 3 frames, then 37 steps: windows of 4-6 frames, then
    full ones, the ring wrapped more than twice (40 frames > 2 x 2T)."""
    _, _, poses = reference
    session = stream.session()
    session.open(frames[:3])
    outs = _steps(session, frames, 3, len(frames) - 1)
    for i, got in zip(range(3, len(frames)), outs):
        lo = max(0, i - T + 1)
        assert got.shape == (i - lo + 1, 6) and got.dtype == torch.float32
        assert _gap(got, poses(lo, i)) <= TOL, i
    assert session.count == len(frames)


def test_session_keeps_tf32_as_it_is(stream, frames):
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    session = stream.session()
    session.open(frames[:T - 1])
    session.step(frames[T - 1])
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before


def test_each_frame_through_the_trunk_once(stream, frames):
    trunk0, window0 = (serving.stream_frames["trunk"],
                       serving.stream_frames["window"])
    session = stream.session()
    session.open(frames[:2])
    _steps(session, frames, 2, 19)
    assert serving.stream_frames["trunk"] - trunk0 == 20
    # windows of 3, 4, 5, 6, then 14 of T
    assert serving.stream_frames["window"] - window0 == 3 + 4 + 5 + 6 + 14 * T


def _direction_state_fault(state):
    """A recurrence that starts each window's forward direction from the
    previous window's last state, as a session that kept its LSTM state
    across requests would."""
    carried = {}

    def recurrence(win):
        fwd, last = ref.direction(state, win, ref.DIRECTIONS[0],
                                   carried.get("state"))
        carried["state"] = last
        bwd, _ = ref.direction(state, win.flip(1), ref.DIRECTIONS[1])
        h = torch.cat([fwd, bwd.flip(1)], dim=-1)
        return F.linear(h, state["fc_pose.weight"], state["fc_pose.bias"])

    return recurrence


def _no_backward_fault(state):
    """A recurrence whose backward direction is left out (its half of
    ``fc_pose``'s input zero)."""

    def recurrence(win):
        fwd, _ = ref.direction(state, win, ref.DIRECTIONS[0])
        h = torch.cat([fwd, torch.zeros_like(fwd)], dim=-1)
        return F.linear(h, state["fc_pose.weight"], state["fc_pose.bias"])

    return recurrence


def _stale_slot_fault(real):
    """The window one frame behind: each step reads the ring as the
    previous step left it (the new frame's slot not yet in the view)."""
    prev = {}

    def recurrence(win):
        out = real(prev.get("win", win))
        prev["win"] = win.clone()
        return out

    return recurrence


@pytest.mark.parametrize("fault", ["stale_slot", "no_backward",
                                   "carried_state"])
def test_planted_faults_exceed_the_tolerance(stream, frames, reference,
                                             fault):
    state, _, poses = reference
    session = stream.session()
    session.recurrence = {
        "stale_slot": lambda: _stale_slot_fault(stream.recurrence),
        "no_backward": lambda: _no_backward_fault(state),
        "carried_state": lambda: _direction_state_fault(state),
    }[fault]()
    session.open(frames[:T - 1])
    outs = _steps(session, frames, T - 1, 3 * T)
    gaps = [_gap(got, poses(i - T + 1, i))
            for i, got in zip(range(T - 1, 3 * T + 1), outs)]
    assert max(gaps) > 10 * TOL, gaps


def test_artifact_refusals(model, stream, frames):
    with pytest.raises(ValueError, match="PoseNet's"):
        serving.export_inference(model, None, frame_shape=(H, W, 3),
                                 dtype=torch.uint8, preprocess=preprocess,
                                 window=T, quantize=True)
    with pytest.raises(ValueError, match="window >= 1"):
        serving.export_inference(model, None, frame_shape=(H, W, 3),
                                 dtype=torch.uint8, preprocess=preprocess)
    with pytest.raises(ValueError, match="one frame at a time"):
        serving.export_inference(model, None, frame_shape=(3, H, W, 3),
                                 dtype=torch.uint8, preprocess=preprocess,
                                 window=T)
    mapnet = MapNet(PoseNet(resnet18(), feat_dim=32))
    with pytest.raises(ValueError, match="VidLoc stream's"):
        serving.export_inference(mapnet, None, frame_shape=(3, H, W, 3),
                                 window=T)
    session = stream.session()
    assert not session.graphs
    with pytest.raises(ValueError, match="at most T - 1"):
        session.open(frames[:T])
    with pytest.raises(ValueError, match="one frame"):
        session.step(frames[:2])


def test_stream_artifact_keeps_its_platforms(model):
    blob = serving.export_inference(model, None, frame_shape=(H, W, 3),
                                    dtype=torch.uint8, preprocess=preprocess,
                                    window=T, platforms=("cuda",))
    with pytest.raises(ValueError, match="exported for"):
        serving.load_inference(blob, "cpu")


@pytest.mark.cuda
def test_graphed_steps_equal_the_eager_ones_on_card(model, frames,
                                                    reference):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs capture there")
    _, _, poses = reference
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dev = torch.device("cuda")
        blob = serving.export_inference(
            copy.deepcopy(model).to(dev), None, frame_shape=(H, W, 3),
            dtype=torch.uint8, preprocess=preprocess, window=T)
        stream = serving.load_inference(blob, dev)
        eager, graphed = stream.session(), stream.session()
        assert graphed.graphs
        eager.graphs = False
        on_card = frames.to(dev)
        for session in (eager, graphed):
            session.open(on_card[:3])
        for i in range(3, len(frames)):
            want, got = eager.step(on_card[i]), graphed.step(on_card[i])
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(
                want.abs().max()))
            assert _gap(got.cpu(), poses(max(0, i - T + 1), i)) <= TOL, i
        assert graphed._graphs is not None
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


@pytest.mark.cuda
def test_resnet50_stream_matches_the_model_on_card(frames):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the recurrence kernel runs there")
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dev = torch.device("cuda")
        torch.manual_seed(4)
        model = VidLoc(resnet50()).eval().to(dev)
        assert (model.feature_extractor.out_features,
                model.lstm.hidden_size) == (2048, 512)
        blob = serving.export_inference(
            copy.deepcopy(model), None, frame_shape=(H, W, 3),
            dtype=torch.uint8, preprocess=preprocess, window=T)
        session = serving.load_inference(blob, dev).session()
        on_card = frames.to(dev)
        session.open(on_card[:3])
        with torch.inference_mode():
            for i in range(3, 3 * T):
                got = session.step(on_card[i])
                lo = max(0, i - T + 1)
                want = model(preprocess(on_card[lo:i + 1])[None])[0]
                assert _gap(got.cpu(), want.double().cpu().numpy()) <= TOL, i
        assert session._graphs is not None
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before
