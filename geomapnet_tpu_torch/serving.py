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

Typical flow::

    blob = export_inference(model, None, frame_shape=(3, 256, 341, 3),
                            dtype=torch.uint8, preprocess=preprocess)
    Path("mapnet.pt2").write_bytes(blob)
    # ... in the serving process:
    infer = load_inference("mapnet.pt2")
    poses = infer(images)          # any batch size, on the card
"""

from __future__ import annotations

import io
import warnings
from pathlib import Path
from typing import Callable

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from .ops import library  # noqa: F401  (registers the kernels' operators)

__all__ = ["export_inference", "load_inference", "Inference"]

PLATFORMS = ("cuda", "cpu")
_PLATFORMS_FILE = "platforms"


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


def _serving_core(model, quantize, fold_bn, calib_data, quantize_heads,
                  fuse_requant, device) -> nn.Module:
    from .models.flax_import import state_dict_to_variables
    from .models.quant import (
        QuantizedPoseNet,
        _is_fusable,
        calibrate_activation_scales,
        fold_posenet_variables,
        quantize_posenet_variables,
    )

    posenet = getattr(model, "posenet", model)
    variables = state_dict_to_variables(posenet.state_dict())
    stage_sizes = tuple(posenet.feature_extractor.stage_sizes)
    if quantize:
        qtree = quantize_posenet_variables(variables, stage_sizes,
                                           quantize_heads=quantize_heads)
        if calib_data is not None:
            qtree = calibrate_activation_scales(qtree, calib_data,
                                                device=device)
    else:
        qtree = fold_posenet_variables(variables, stage_sizes)
    if fuse_requant and not _is_fusable(qtree):
        raise ValueError(
            "fuse_requant needs calibrated static scales on every "
            "site and a basic-block (resnet18/34) trunk")
    # the JAX package's serving forwards compute in bfloat16
    return QuantizedPoseNet(qtree, torch.bfloat16,
                            fused=fuse_requant).to(device)


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
) -> bytes:
    """Serialize the inference function (weights baked in).

    :param model: a PoseNet or MapNet module; it is traced on the device
        its weights are on
    :param state: None (the model's own weights) or a ``state_dict`` of
        the model, loaded into it first
    :param frame_shape: per-sample shape WITHOUT the batch dim, e.g.
        ``(T, H, W, 3)`` for MapNet tuples or ``(H, W, 3)`` for PoseNet
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
    :returns: serialized artifact bytes (``torch.export.save``)
    """
    if fuse_requant and not (quantize and calib_data is not None):
        raise ValueError(
            "fuse_requant needs quantize=True with calib_data "
            "(static scales on every site)")
    if state is not None:
        model.load_state_dict(state)
    device = next(model.parameters()).device
    platforms = tuple(platforms) if platforms else (device.type,)
    unknown = set(platforms) - set(PLATFORMS)
    if unknown:
        raise ValueError(f"unknown platforms {sorted(unknown)}; pick from "
                         f"{PLATFORMS}")
    quantized = quantize or fold_bn
    if quantized:
        core = _serving_core(model, quantize, fold_bn, calib_data,
                             quantize_heads, fuse_requant, device)
    else:
        core = model
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
    program = move_to_device_pass(program, "cpu")
    buf = io.BytesIO()
    with warnings.catch_warnings():
        # a channels-last weight does not start its storage's layout, so
        # the writer takes the storage's whole byte range: right for
        # weights on the CPU, which is where they are stored
        warnings.filterwarnings("ignore", "No complete tensor found")
        torch.export.save(program, buf,
                          extra_files={_PLATFORMS_FILE: ",".join(platforms)})
    return buf.getvalue()


class Inference:
    """A loaded artifact: ``infer(images) -> poses`` under
    ``torch.inference_mode``; ``module`` is the loaded ``nn.Module``."""

    def __init__(self, module: nn.Module, platforms: tuple[str, ...]):
        self.module = module
        self.platforms = platforms

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.module(images)


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


def load_inference(path_or_bytes, device=None) -> Inference:
    """Load an artifact of :func:`export_inference` onto ``device`` (default:
    the card); returns ``infer(images) -> poses`` for any batch size.

    Raises ``ValueError`` when the artifact was not exported for the
    device's type (``platforms``)."""
    blob = (bytes(path_or_bytes)
            if isinstance(path_or_bytes, (bytes, bytearray))
            else Path(path_or_bytes).read_bytes())
    device = torch.device(device if device is not None else "cuda")
    extra = {_PLATFORMS_FILE: ""}
    with warnings.catch_warnings():
        # the reader wraps the archive's bytes without a copy; inference
        # never writes to its weights
        warnings.filterwarnings("ignore", "The given buffer is not writable")
        program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    platforms = tuple(p for p in extra[_PLATFORMS_FILE].split(",") if p)
    if device.type not in platforms:
        raise ValueError(f"the artifact was exported for {platforms}, not "
                         f"{device.type}")
    module = move_to_device_pass(program, device).module()
    _buffers_for_constants(module)
    return Inference(module, platforms)
