"""The hand-written kernels as ``torch.library`` custom operators.

K1 (``int8_conv``), K2 (``int8_maxpool3x3s2``) and K4
(``demosaic_half_normalize``) are bound with ctypes
(:mod:`~geomapnet_tpu_torch.ops.cuda_quant`,
:mod:`~geomapnet_tpu_torch.ops.cuda_image`). ``torch.export`` cannot trace a
ctypes call, nor :class:`~geomapnet_tpu_torch.ops.cuda_quant.PreparedConv`'s
cache keyed on the input's shape (a symbolic shape while tracing). So each
kernel is also an operator of the ``geomapnet`` namespace
(``torch.ops.geomapnet.*``): a traced graph holds it as one opaque node, and
its fake implementation gives the output's shape and dtype from the
input's, with a symbolic batch.

The operator's implementation is the wrapper the eager paths call: on a
CUDA tensor it launches the kernel (and counts the launch in the wrapper's
``launches``), on a CPU tensor it runs the plain PyTorch version. The eager
paths keep their prepared ctypes launches: a model routes through these
operators only while it is traced (:func:`tracing`), as
:mod:`geomapnet_tpu_torch.serving` traces it. A process that loads an exported
artifact imports this module first, which registers the operators.

``geomapnet::lstm`` is a one-layer batch-first LSTM from a zero state
(:func:`~geomapnet_tpu_torch.ops.cuda_rnn.lstm`: the persistent recurrence
kernel on a card, its plain step loop on the CPU). ``torch.export`` would
trace ``aten::lstm`` through its time loop and fix the sequence length; as
an opaque operator the window of a streaming artifact
(:mod:`geomapnet_tpu_torch.serving`) keeps a symbolic length.
"""

from __future__ import annotations

import torch

from . import cuda_image, cuda_quant, cuda_rnn

__all__ = [
    "NAMESPACE",
    "demosaic_half_normalize",
    "int8_conv",
    "int8_maxpool3x3s2",
    "lstm",
    "tracing",
]

NAMESPACE = "geomapnet"


def tracing() -> bool:
    """True while ``torch.export`` (or ``torch.compile``) traces the
    caller: the kernels must then be called as operators, not through
    ctypes."""
    return torch.compiler.is_compiling()


def _conv_out_dtype(mode: str, s_out, out_dtype: torch.dtype) -> torch.dtype:
    if mode == "acc":
        return torch.int32
    if mode == "deq":
        return out_dtype
    if mode == "relu_q" or s_out is not None:
        return torch.int8
    return torch.float32


@torch.library.custom_op(f"{NAMESPACE}::int8_conv", mutates_args=())
def _int8_conv_op(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor,
                  b: torch.Tensor, s_in: torch.Tensor | None,
                  ksize: list[int], stride: list[int], pad: list[int],
                  mode: str, s_out: torch.Tensor | None,
                  residual: torch.Tensor | None,
                  res_scale: torch.Tensor | None,
                  out_dtype: torch.dtype) -> torch.Tensor:
    pt, pb, pl, pr = pad
    out = cuda_quant.int8_conv(
        x, w, m, b, s_in, ksize=tuple(ksize), stride=tuple(stride),
        pad=((pt, pb), (pl, pr)), mode=mode, s_out=s_out, residual=residual,
        res_scale=res_scale, out_dtype=out_dtype)
    # the plain version computes in a permuted layout; the kernel and the
    # fake implementation give a contiguous NHWC tensor
    return out.contiguous()


@_int8_conv_op.register_fake
def _(x, w, m, b, s_in, ksize, stride, pad, mode, s_out, residual,
      res_scale, out_dtype):
    n, h, wd, _ = x.shape
    oh = (h + pad[0] + pad[1] - ksize[0]) // stride[0] + 1
    ow = (wd + pad[2] + pad[3] - ksize[1]) // stride[1] + 1
    return x.new_empty((n, oh, ow, w.shape[0]),
                       dtype=_conv_out_dtype(mode, s_out, out_dtype))


@torch.library.custom_op(f"{NAMESPACE}::int8_maxpool3x3s2", mutates_args=())
def int8_maxpool3x3s2(x: torch.Tensor) -> torch.Tensor:
    """:func:`~geomapnet_tpu_torch.ops.cuda_quant.int8_maxpool3x3s2` as the
    ``geomapnet::int8_maxpool3x3s2`` operator."""
    return cuda_quant.int8_maxpool3x3s2(x)


@int8_maxpool3x3s2.register_fake
def _(x):
    n, h, w, c = x.shape
    return x.new_empty((n, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c))


@torch.library.custom_op(f"{NAMESPACE}::demosaic_half_normalize",
                         mutates_args=())
def _demosaic_op(raw: torch.Tensor, mean: list[float], std: list[float],
                 dtype: torch.dtype, planar: bool) -> torch.Tensor:
    return cuda_image.demosaic_half_normalize(
        raw, tuple(mean), tuple(std), dtype=dtype, planar=planar).contiguous()


@_demosaic_op.register_fake
def _(raw, mean, std, dtype, planar):
    n, h, w = raw.shape
    shape = (n, 3, h // 2, w // 2) if planar else (n, h // 2, w // 2, 3)
    return raw.new_empty(shape, dtype=dtype)


def int8_conv(x, w, m, b, s_in=None, *, ksize, stride, pad, mode,
              s_out=None, residual=None, res_scale=None,
              out_dtype=torch.float32) -> torch.Tensor:
    """:func:`~geomapnet_tpu_torch.ops.cuda_quant.int8_conv` (same
    arguments) through the ``geomapnet::int8_conv`` operator. Scales must be
    tensors."""
    (pt, pb), (pl, pr) = pad
    return _int8_conv_op(x, w, m, b, s_in, list(ksize), list(stride),
                         [pt, pb, pl, pr], mode, s_out, residual, res_scale,
                         out_dtype)


def demosaic_half_normalize(raw: torch.Tensor, mean, std,
                            dtype: torch.dtype = torch.bfloat16,
                            planar: bool = False) -> torch.Tensor:
    """:func:`~geomapnet_tpu_torch.ops.cuda_image.demosaic_half_normalize`
    through the ``geomapnet::demosaic_half_normalize`` operator."""
    return _demosaic_op(raw, [float(v) for v in mean],
                        [float(v) for v in std], dtype, planar)


@torch.library.custom_op(f"{NAMESPACE}::lstm", mutates_args=())
def lstm(x: torch.Tensor, params: list[torch.Tensor],
         bidirectional: bool) -> torch.Tensor:
    """(N, T, F) float32 -> (N, T, D*H) outputs of a one-layer batch-first
    ``nn.LSTM`` from a zero state, ``params`` its ``_flat_weights`` (each
    direction's ``weight_ih``, ``weight_hh``, ``bias_ih``, ``bias_hh``),
    the backward direction's outputs in time order after the forward's:
    :func:`~geomapnet_tpu_torch.ops.cuda_rnn.lstm`."""
    return cuda_rnn.lstm(x, params, bidirectional)


@lstm.register_fake
def _(x, params, bidirectional):
    d = 2 if bidirectional else 1
    return x.new_empty((x.shape[0], x.shape[1], d * params[1].shape[1]))
