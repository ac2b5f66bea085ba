"""Model export for serving: ahead-of-time artifacts via ``torch.export``.

The PyTorch counterpart of :mod:`geomapnet_tpu.serving`. The inference path
(an optional device preprocess fused in front of the model forward) exports
to a ``torch.export`` program with the weights baked in:

- batch-polymorphic: the batch dimension is symbolic (at least 1), so one
  artifact serves any batch size;
- the float model, or with ``quantize`` / ``fold_bn`` the int8 / BN-folded
  :class:`~geomapnet_tpu_torch.models.quant.QuantizedPoseNet`, under the JAX
  package's contract (the same ``ValueError``\\ s);
- the hand-written kernels are in the graph as operators
  (:mod:`geomapnet_tpu_torch.ops.library`): the int8 conv (K1), the int8
  max-pool (K2) and the demosaic (K4) launch on the card, their plain
  versions run on the CPU.

What differs from the JAX package's StableHLO artifact: the loading process
needs no model code, but it does need this package's operators
(:func:`load_inference` imports them before it loads), since a custom
operator is stored by name. ``platforms`` lists the devices (``"cuda"``,
``"cpu"``) the artifact may be loaded on. Its weights are stored on the CPU
and moved at load. Tensors that the forward makes (a preprocess's
constants) are stored beside the weights, and the loaded module holds all
of them as buffers, so its ``.to(device)`` moves everything.

A VidLoc model exports as a streaming artifact instead (``window`` T): two
programs in one file, each with its weights. The trunk, with the
preprocess fused in front, maps (b, H, W, 3) frames to (b, F) float32
features; the recurrence (the bidirectional LSTM through the
``geomapnet::lstm`` operator, then ``fc_pose``) maps a (1, n, F) window to
its (1, n, 6) poses for any 1 <= n <= T. :func:`load_inference` then gives a
:class:`Stream`, whose :meth:`Stream.session` keeps a stream's last T
features in a ring on the card and runs the trunk once per frame
(:class:`StreamSession`).

On a card, an :class:`Inference` replays its module as one CUDA graph per
input shape, and a :class:`StreamSession` each full-window step as two
(one thread at a time; see there). On the CPU the modules run as they are.

Typical flow::

    blob = export_inference(model, None, frame_shape=(3, 256, 341, 3),
                            dtype=torch.uint8, preprocess=preprocess)
    Path("mapnet.pt2").write_bytes(blob)
    # ... in the serving process:
    infer = load_inference("mapnet.pt2")
    poses = infer(images)          # any batch size, on the card

    # a VidLoc stream, one frame a request
    blob = export_inference(vidloc, None, frame_shape=(256, 341, 3),
                            dtype=torch.uint8, preprocess=preprocess,
                            window=200)
    session = load_inference(blob).session()
    session.open(first_frames)     # up to T - 1 frames, one trunk batch
    poses = session.step(frame)    # the window's (min(n, T), 6) poses
"""

from __future__ import annotations

import io
import json
import warnings
import zipfile
from pathlib import Path
from typing import Callable

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from .models.quant import serving_net
from .models.resnet import Bottleneck
from .models.vidloc import VidLoc
from .ops import library  # registers the kernels' operators
from .utils.cuda_graph import capture
from .utils.trace import span

__all__ = ["export_inference", "load_inference", "Inference", "Stream",
           "StreamSession", "inference_graphs", "stream_frames"]

PLATFORMS = ("cuda", "cpu")
_PLATFORMS_FILE = "platforms"
# the members of a streaming artifact (a zip of two torch.export archives)
_STREAM_FILE = "stream.json"
_TRUNK_FILE = "trunk.pt2"
_RECURRENCE_FILE = "recurrence.pt2"

# frames through a streaming session's trunk and frame-steps through its
# recurrence, over every session of the process
stream_frames = {"trunk": 0, "window": 0}
# CUDA graphs captured and replayed by every Inference of the process
inference_graphs = {"captured": 0, "replayed": 0}


class _Artifact(nn.Module):
    """What is exported: ``preprocess`` (if any), then the model."""

    def __init__(self, core: nn.Module, preprocess: Callable | None,
                 quantized: bool):
        super().__init__()
        self.core = core
        self.preprocess = preprocess   # a module's buffers are exported too
        self.quantized = quantized

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if self.preprocess is not None:
            images = self.preprocess(images)
        if not self.quantized or images.dim() == 4:
            return self.core(images)
        n, t = images.shape[:2]
        poses = self.core(images.reshape((n * t,) + tuple(images.shape[2:])))
        return poses.reshape(n, t, -1)


class _StreamTrunk(nn.Module):
    """A streaming artifact's per-frame program: ``preprocess`` (if any),
    the VidLoc trunk, float32 features."""

    def __init__(self, feature_extractor: nn.Module,
                 preprocess: Callable | None):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.preprocess = preprocess

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        if self.preprocess is not None:
            frames = self.preprocess(frames)
        return self.feature_extractor(frames).float()


class _StreamRecurrence(nn.Module):
    """A streaming artifact's window program: VidLoc's head in eval mode
    (no dropout), its LSTM through the ``geomapnet::lstm`` operator, so
    that the window's length stays symbolic."""

    def __init__(self, lstm: nn.LSTM, fc_pose: nn.Module):
        super().__init__()
        self.lstm = lstm
        self.fc_pose = fc_pose

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        lstm = self.lstm
        params = [getattr(lstm, k) for k in lstm._flat_weights_names]
        h = library.lstm(feats.float(), params, lstm.bidirectional)
        return self.fc_pose(h).float()


def export_inference(
    model: nn.Module,
    state=None,
    frame_shape: tuple[int, ...] = (),
    dtype: torch.dtype = torch.bfloat16,
    preprocess: Callable | None = None,
    platforms: tuple[str, ...] | None = None,
    quantize: bool = False,
    fold_bn: bool = False,
    calib_data=None,
    quantize_heads: bool = False,
    fuse_requant: bool = False,
    window: int | None = None,
) -> bytes:
    """Serialize the inference function (weights baked in).

    :param model: a PoseNet, MapNet or VidLoc module; it is traced on the
        device its weights are on
    :param state: None (the model's own weights) or a ``state_dict`` of
        the model, loaded into it first
    :param frame_shape: per-sample shape WITHOUT the batch dim, e.g.
        ``(T, H, W, 3)`` for MapNet tuples or ``(H, W, 3)`` for PoseNet
        and for a VidLoc stream
    :param dtype: input dtype the artifact accepts (uint8 when
        ``preprocess`` normalizes on the device)
    :param preprocess: optional device pipeline fused in front of the model
        (e.g. :func:`geomapnet_tpu_torch.cli.builders.
        build_device_preprocess` or ``build_raw_device_preprocess``)
    :param platforms: the devices the artifact may be loaded on, from
        ``"cuda"`` and ``"cpu"`` (default: the model's device type)
    :param quantize: bake an int8-PTQ trunk into the artifact
        (:mod:`geomapnet_tpu_torch.models.quant`)
    :param fold_bn: bake a BN-folded float trunk instead (implied by
        ``quantize``)
    :param calib_data: with ``quantize``, an iterable of preprocessed image
        batches used to bake static activation scales
    :param quantize_heads: with ``quantize``, run the fc_feat matmul int8
    :param fuse_requant: with ``quantize`` + ``calib_data``, bake the int8
        dataflow trunk (requantization fused into each conv's epilogue, the
        eval CLI's ``--fuse_requant``); needs static scales on every site
        and a basic-block trunk
    :param window: a VidLoc model's streaming window T, the frames a
        session keeps (needed for VidLoc, refused for the others)
    :returns: serialized artifact bytes (``torch.export.save``; for VidLoc
        a zip of the trunk's and the recurrence's)
    """
    if isinstance(model, VidLoc):
        if quantize or fold_bn or calib_data is not None or quantize_heads \
                or fuse_requant:
            raise ValueError(
                "a VidLoc artifact serves its float model: the int8 and "
                "BN-folded serving trees (quantize, fold_bn, calib_data, "
                "quantize_heads, fuse_requant) are PoseNet's")
        if state is not None:
            model.load_state_dict(state)
        return _export_stream(model, frame_shape, dtype, preprocess,
                              platforms, window)
    if window is not None:
        raise ValueError("window is a VidLoc stream's; a PoseNet or MapNet "
                         "artifact maps whole inputs to poses")
    if fuse_requant and not (quantize and calib_data is not None):
        raise ValueError(
            "fuse_requant needs quantize=True with calib_data "
            "(static scales on every site)")
    if fuse_requant and any(isinstance(m, Bottleneck)
                            for m in model.modules()):
        raise ValueError(
            "fuse_requant needs calibrated static scales on every "
            "site and a basic-block (resnet18/34) trunk")
    if state is not None:
        model.load_state_dict(state)
    device = next(model.parameters()).device
    platforms = _platforms(device, platforms)
    quantized = quantize or fold_bn
    core = model
    if quantized:
        # the JAX package's serving forwards compute in bfloat16
        core = serving_net(getattr(model, "posenet", model), device,
                           quantize=quantize, quantize_heads=quantize_heads,
                           calib_batches=calib_data if quantize else None,
                           fuse_requant=fuse_requant, dtype=torch.bfloat16)
    artifact = _Artifact(core, preprocess, quantized)
    was_training = model.training
    model.eval()
    artifact.eval()
    # batch 2 in the example: torch.export specializes a dimension it sees
    # as 0 or 1. The batch is left to Dim.AUTO: a card's 32-bit indexing
    # bounds it from above, which a Dim with a fixed range would have to
    # name; batch 1 runs all the same (the tests and chip_smoke.py run it)
    sample = torch.zeros((2, *frame_shape), dtype=dtype, device=device)
    batch = torch.export.Dim.AUTO
    try:
        program = torch.export.export(artifact, (sample,),
                                      dynamic_shapes=({0: batch},))
    finally:
        model.train(was_training)
    return _save(program, {_PLATFORMS_FILE: ",".join(platforms)})


def _platforms(device: torch.device, platforms) -> tuple[str, ...]:
    platforms = tuple(platforms) if platforms else (device.type,)
    unknown = set(platforms) - set(PLATFORMS)
    if unknown:
        raise ValueError(f"unknown platforms {sorted(unknown)}; pick from "
                         f"{PLATFORMS}")
    return platforms


def _save(program, extra_files: dict | None = None) -> bytes:
    """``program`` with its weights moved to the CPU, serialized."""
    program = move_to_device_pass(program, "cpu")
    buf = io.BytesIO()
    with warnings.catch_warnings():
        # a channels-last weight does not start its storage's layout, so
        # the writer takes the storage's whole byte range: right for
        # weights on the CPU, which is where they are stored
        warnings.filterwarnings("ignore", "No complete tensor found")
        torch.export.save(program, buf, extra_files=extra_files)
    return buf.getvalue()


def _export_stream(model: VidLoc, frame_shape: tuple[int, ...],
                   dtype: torch.dtype, preprocess: Callable | None,
                   platforms, window: int | None) -> bytes:
    """A VidLoc streaming artifact: the trunk program (any batch of
    ``frame_shape`` frames) and the recurrence program (a (1, n, F)
    window, 1 <= n <= ``window``) in one zip, with the window and the
    platforms."""
    if window is None or int(window) < 1:
        raise ValueError("a VidLoc artifact needs window >= 1: the frames "
                         "a streaming session keeps")
    window = int(window)
    if len(frame_shape) != 3:
        raise ValueError(f"a VidLoc stream takes one frame at a time: "
                         f"frame_shape is (H, W, 3), not {frame_shape}")
    device = next(model.parameters()).device
    platforms = _platforms(device, platforms)
    feat = model.feature_extractor.out_features
    trunk = _StreamTrunk(model.feature_extractor, preprocess).eval()
    recurrence = _StreamRecurrence(model.lstm, model.fc_pose).eval()
    was_training = model.training
    model.eval()
    try:
        frames = torch.zeros((2, *frame_shape), dtype=dtype, device=device)
        p_trunk = torch.export.export(
            trunk, (frames,), dynamic_shapes=({0: torch.export.Dim.AUTO},))
        # a window of 2 in the example: 0 and 1 would be specialized
        feats = torch.zeros((1, min(2, window), feat), device=device)
        n = (torch.export.Dim("window", min=1, max=window) if window > 1
             else None)
        p_recurrence = torch.export.export(
            recurrence, (feats,), dynamic_shapes=({1: n},))
    finally:
        model.train(was_training)
    meta = {"window": window, "features": feat,
            "frame_shape": list(frame_shape),
            "dtype": str(dtype).replace("torch.", "")}
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        z.writestr(_STREAM_FILE, json.dumps(meta))
        z.writestr(_PLATFORMS_FILE, ",".join(platforms))
        z.writestr(_TRUNK_FILE, _save(p_trunk))
        z.writestr(_RECURRENCE_FILE, _save(p_recurrence))
    return buf.getvalue()


class Inference:
    """A loaded artifact: ``infer(images) -> poses`` under
    ``torch.inference_mode``; ``module`` is the loaded ``nn.Module``.

    A call on card images replays a CUDA graph of ``module``, one per
    input (shape, dtype, device), captured at the first call of it
    (:func:`~geomapnet_tpu_torch.utils.cuda_graph.capture`). A call copies
    the images into the graph's static input, replays it on the current
    stream and returns a clone of its static output, so the poses stay
    valid past the next call. The graphs share
    one memory pool and a replay reuses its buffers: an ``Inference``
    serves one thread at a time. A graph holds the addresses of
    ``module``'s weights and buffers, so on a card ``module`` is neither
    moved (``.to()``) nor changed after its first call. Without the graphs
    the module would enqueue its operators one by one, and the host, not
    the card, would set the pace of a request. A failed capture raises.
    Images on the CPU run through the module as it is.

    Spans (:mod:`geomapnet_tpu_torch.utils.trace`): ``serve.call`` around a
    call, ``serve.capture`` around a capture inside it. The module's
    :data:`inference_graphs` counts captures and replays."""

    def __init__(self, module: nn.Module, platforms: tuple[str, ...]):
        self.module = module
        self.platforms = platforms
        # (shape, dtype, device) -> (graph, static input, static output)
        self._graphs: dict = {}
        self._pool = None

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        with span("serve.call"), torch.inference_mode():
            if not images.is_cuda:
                return self.module(images)
            key = (tuple(images.shape), images.dtype, images.device)
            entry = self._graphs.get(key)
            if entry is None:
                with span("serve.capture"):
                    entry = self._graphs[key] = self._capture(images)
            graph, static_in, static_out = entry
            static_in.copy_(images)
            graph.replay()
            inference_graphs["replayed"] += 1
            return static_out.clone()

    def _capture(self, images: torch.Tensor) -> tuple:
        static_in = images.clone(memory_format=torch.contiguous_format)
        graph, static_out = capture(lambda: self.module(static_in),
                                    images.device, pool=self._pool)
        if self._pool is None:
            self._pool = graph.pool()
        inference_graphs["captured"] += 1
        return graph, static_in, static_out


def _buffers_for_constants(module: nn.Module) -> None:
    """Register every plain tensor attribute of ``module`` and its children
    (the constants ``torch.export`` lifted out of the forward) as a
    non-persistent buffer, so ``.to()`` moves them with the weights."""
    for mod in module.modules():
        plain = [k for k, v in vars(mod).items()
                 if isinstance(v, torch.Tensor) and not k.startswith("_")]
        for name in plain:
            value = vars(mod).pop(name)
            mod.register_buffer(name, value, persistent=False)


def load_inference(path_or_bytes, device=None) -> "Inference | Stream":
    """Load an artifact of :func:`export_inference` onto ``device`` (default:
    the card): an :class:`Inference` (``infer(images) -> poses`` for any
    batch size), or for a VidLoc artifact a :class:`Stream`, whose
    ``session()`` serves one frame at a time.

    Raises ``ValueError`` when the artifact was not exported for the
    device's type (``platforms``)."""
    blob = (bytes(path_or_bytes)
            if isinstance(path_or_bytes, (bytes, bytearray))
            else Path(path_or_bytes).read_bytes())
    device = torch.device(device if device is not None else "cuda")
    stream = _stream_members(blob)
    if stream is not None:
        _check_platforms(stream[_PLATFORMS_FILE].decode(), device)
        meta = json.loads(stream[_STREAM_FILE])
        return Stream(_module(_read(stream[_TRUNK_FILE]), device),
                      _module(_read(stream[_RECURRENCE_FILE]), device),
                      int(meta["window"]), int(meta["features"]), device)
    extra = {_PLATFORMS_FILE: ""}
    program = _read(blob, extra)
    platforms = _check_platforms(extra[_PLATFORMS_FILE], device)
    return Inference(_module(program, device), platforms)


def _check_platforms(listed: str, device: torch.device) -> tuple[str, ...]:
    platforms = tuple(p for p in listed.split(",") if p)
    if device.type not in platforms:
        raise ValueError(f"the artifact was exported for {platforms}, not "
                         f"{device.type}")
    return platforms


def _read(blob: bytes, extra_files: dict | None = None):
    """One ``torch.export`` archive's program (its weights on the CPU)."""
    with warnings.catch_warnings():
        # the reader wraps the archive's bytes without a copy; inference
        # never writes to its weights
        warnings.filterwarnings("ignore", "The given buffer is not writable")
        return torch.export.load(io.BytesIO(blob), extra_files=extra_files)


def _module(program, device: torch.device) -> nn.Module:
    """``program`` as a module on ``device``, its constants registered as
    buffers."""
    module = move_to_device_pass(program, device).module()
    _buffers_for_constants(module)
    return module


def _stream_members(blob: bytes) -> dict | None:
    """The members of a streaming artifact, or None for a plain one (a
    ``torch.export`` archive, a zip without :data:`_STREAM_FILE`)."""
    buf = io.BytesIO(blob)
    if not zipfile.is_zipfile(buf):
        return None
    with zipfile.ZipFile(buf) as z:
        if _STREAM_FILE not in z.namelist():
            return None
        return {name: z.read(name) for name in (
            _STREAM_FILE, _PLATFORMS_FILE, _TRUNK_FILE, _RECURRENCE_FILE)}


class Stream:
    """A loaded VidLoc streaming artifact on ``device``: ``trunk`` maps (b,
    H, W, 3) frames to (b, F) float32 features, ``recurrence`` a (1, n, F)
    window (n <= ``window``) to its (1, n, 6) poses; :meth:`session` opens
    a stream."""

    def __init__(self, trunk: nn.Module, recurrence: nn.Module, window: int,
                 features: int, device: torch.device):
        self.trunk = trunk
        self.recurrence = recurrence
        self.window = window
        self.features = features
        self.device = device

    def session(self) -> "StreamSession":
        return StreamSession(self)


class _Graphs:
    """The trunk on one frame and the recurrence on a full window, each
    captured in a CUDA graph over static buffers
    (:func:`~geomapnet_tpu_torch.utils.cuda_graph.capture`, with its
    warm-up), the recurrence's in the trunk's memory pool. A replay
    launches each program whole: the host no longer enqueues the trunk's
    kernels one by one, nor the recurrence's (a memset, the persistent LSTM
    kernel, ``fc_pose``)."""

    def __init__(self, trunk: nn.Module, recurrence: nn.Module,
                 frame: torch.Tensor, window: int, features: int):
        dev = frame.device
        self.frame = torch.empty(frame.shape, dtype=frame.dtype, device=dev)
        self.frame.copy_(frame)
        self.window = torch.zeros((1, window, features), dtype=torch.float32,
                                  device=dev)
        self.trunk_graph, self.feat = capture(lambda: trunk(self.frame), dev)
        self.recurrence_graph, self.poses = capture(
            lambda: recurrence(self.window), dev,
            pool=self.trunk_graph.pool())

    def trunk(self, frame: torch.Tensor) -> torch.Tensor:
        """(1, F) features of ``frame``, valid until the next replay."""
        self.frame.copy_(frame)
        self.trunk_graph.replay()
        return self.feat

    def recurrence(self, window: torch.Tensor) -> torch.Tensor:
        """(T, 6) poses of a (T, F) window."""
        self.window[0].copy_(window)
        self.recurrence_graph.replay()
        return self.poses[0].clone()


class StreamSession:
    """One stream of frames through a :class:`Stream`: the last T trunk
    features live in a ring on the device, so each frame's trunk runs once.

    The ring holds every slot twice (slot ``s`` and ``s + T``), so the
    window of the last T frames, oldest first, is always one contiguous
    view of it, whatever slot the newest frame took. Each :meth:`step` runs
    the recurrence over the whole window from a zero state: VidLoc's full
    forward over the window's frames, with each frame's trunk computed when
    it arrived.

    On a CUDA device (``graphs``) every step of a full window is two
    CUDA-graph replays, the trunk's and the recurrence's, captured at the
    first such step (:class:`_Graphs`): one step enqueues about a thousand
    kernels otherwise, and the host, not the card, would set the pace. A
    window that is still growing, or a session on the CPU, runs the
    programs as they are.

    Spans (:mod:`geomapnet_tpu_torch.utils.trace`): ``serve.stream`` around
    a step, inside it ``serve.trunk``, ``serve.ring`` (the slot write and
    the window's view) and ``serve.recurrence``; ``serve.open`` around
    :meth:`open`. The module's :data:`stream_frames` counts frames through
    the trunk and frame-steps through the recurrence."""

    def __init__(self, stream: Stream):
        self.trunk = stream.trunk
        self.recurrence = stream.recurrence
        self.window = stream.window
        self.graphs = stream.device.type == "cuda"
        self._graphs = None
        with torch.inference_mode():
            self.ring = torch.zeros((2 * stream.window, stream.features),
                                    dtype=torch.float32, device=stream.device)
        self.count = 0

    def open(self, frames: torch.Tensor | None = None) -> None:
        """Start the stream anew, primed with ``frames`` ((n, H, W, 3), n <
        T, the oldest first) in one trunk batch."""
        T = self.window
        n = 0 if frames is None else int(frames.shape[0])
        if n > T - 1:
            raise ValueError(f"open takes at most T - 1 = {T - 1} frames, "
                             f"not {n}: the next step makes the window")
        self.count = 0
        if not n:
            return
        with span("serve.open"), torch.inference_mode():
            feats = self.trunk(frames)
            self.ring.view(2, T, -1)[:, :n] = feats
        self.count = n
        stream_frames["trunk"] += n

    def step(self, frame: torch.Tensor) -> torch.Tensor:
        """One frame ((H, W, 3) or (1, H, W, 3)) in; the window's
        (min(n, T), 6) poses out, oldest frame first, on the device."""
        T = self.window
        x = frame if frame.dim() == 4 else frame[None]
        if x.shape[0] != 1:
            raise ValueError(f"step takes one frame, not {x.shape[0]}")
        slot = self.count % T
        n = min(self.count + 1, T)
        with span("serve.stream"), torch.inference_mode():
            graphs = self._full_window_graphs(x) if n == T else None
            with span("serve.trunk"):
                feat = self.trunk(x) if graphs is None else graphs.trunk(x)
            with span("serve.ring"):
                self.ring.view(2, T, -1)[:, slot] = feat
                # the newest frame sits at slot and slot + T: the window
                # ends at whichever makes it n long
                win = self.ring.narrow(0, slot + 1 if self.count >= T else 0,
                                       n)
            with span("serve.recurrence"):
                poses = (self.recurrence(win[None])[0] if graphs is None
                         else graphs.recurrence(win))
        self.count += 1
        stream_frames["trunk"] += 1
        stream_frames["window"] += n
        return poses

    def _full_window_graphs(self, frame: torch.Tensor) -> _Graphs | None:
        if not self.graphs:
            return None
        if self._graphs is None:
            self._graphs = _Graphs(self.trunk, self.recurrence, frame,
                                   self.window, self.ring.shape[1])
        return self._graphs
