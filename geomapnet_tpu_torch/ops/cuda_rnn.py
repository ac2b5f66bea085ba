"""A one-layer LSTM over a whole window as one persistent CUDA kernel.

The body of the ``geomapnet::lstm`` operator
(:mod:`~geomapnet_tpu_torch.ops.library`), which a VidLoc streaming
session's recurrence runs every step (:mod:`geomapnet_tpu_torch.serving`).
The kernel lives in ``geomapnet_tpu_torch/csrc/lstm_persistent.cu``: both
directions of the whole window in one cooperative launch, each CTA's rows
of ``weight_hh`` in registers for every step, its rows of the window's
input projection computed first into shared memory, and one exchange of h
between a direction's CTAs a step (the source says why and how). It is
compiled with ``nvcc`` the first time a CUDA tensor reaches :func:`lstm`
and bound with ctypes (:mod:`geomapnet_tpu_torch.ops._nvcc`).

:func:`lstm_reference` is the plain PyTorch version: the same cell
equations as a step loop. The wrapper uses it for CPU tensors only; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _nvcc

__all__ = ["SOURCE", "launches", "lstm", "lstm_reference", "plan"]

# kernel launches made by lstm (one a sequence); a CUDA-graph replay
# launches nothing from the host
launches = 0

SOURCE = "lstm_persistent.cu"
# units a CTA (one warp each): the kernel's launch bounds allow 8 warps
MAX_UNITS = 8
# a lane holds 16 floats of each of its unit's rows of weight_hh in
# registers
MAX_HIDDEN = 512
# dynamic shared memory a CTA may opt in to on an H100 (227 KB): h_{t-1} by
# parity (2 x 512 floats), the input projection (T x 4 units floats) and
# x's columns that the prologue stages (T x 32 floats)
MAX_SHARED_BYTES = 232448


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.gm_lstm_persistent
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _split(params, bidirectional: bool) -> list[tuple]:
    """Each direction's (weight_ih, weight_hh, bias_ih, bias_hh)."""
    d = 2 if bidirectional else 1
    if len(params) != 4 * d:
        raise ValueError(f"expected {4 * d} tensors (weight_ih, weight_hh, "
                         f"bias_ih, bias_hh a direction), got {len(params)}")
    return [tuple(params[4 * k:4 * k + 4]) for k in range(d)]


def lstm_reference(x: torch.Tensor, params, bidirectional: bool
                   ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: (N, T, F) ->
    (N, T, D*H), a zero initial state, each step PyTorch's cell
    ``gates = (h W_hh^T + b_hh) + (x W_ih^T + b_ih)``, gates i, f, g, o,
    ``c = f c + i g``, ``h = o tanh(c)``; the backward direction runs from
    t = T - 1 down and its outputs stay in time order, after the
    forward's."""
    n, t_len, _ = x.shape
    outs = []
    for k, (w_ih, w_hh, b_ih, b_hh) in enumerate(_split(params,
                                                         bidirectional)):
        xw = F.linear(x, w_ih, b_ih)
        h = x.new_zeros((n, w_hh.shape[1]))
        c = torch.zeros_like(h)
        hs = [h] * t_len
        for t in (range(t_len) if k == 0 else reversed(range(t_len))):
            i, f, g, o = (F.linear(h, w_hh, b_hh) + xw[:, t]).chunk(4, 1)
            c = f.sigmoid() * c + i.sigmoid() * g.tanh()
            h = o.sigmoid() * c.tanh()
            hs[t] = h
        outs.append(torch.stack(hs, 1) if t_len else
                    x.new_empty((n, 0, w_hh.shape[1])))
    return torch.cat(outs, 2)


def plan(hidden: int, features: int, window: int, directions: int,
         sms: int) -> int:
    """Units a CTA: the fewest that divide ``hidden`` and keep the grid,
    ``directions * hidden / units`` CTAs, within ``sms`` (every CTA
    resident). Raises where none does, where a lane cannot hold its part
    of the rows of ``weight_hh`` in registers, or where a CTA's shared
    memory for a window of ``window`` steps exceeds the card's. Any
    number of ``features`` (a multiple of 4) fits."""
    if hidden % 4 or features % 4:
        raise ValueError(f"the kernel reads float4s: hidden ({hidden}) and "
                         f"features ({features}) must be multiples of 4")
    if hidden > MAX_HIDDEN:
        raise ValueError(f"a lane holds 16 floats of each row of weight_hh "
                         f"in registers: hidden {hidden} must be at most "
                         f"{MAX_HIDDEN}")
    units = next((u for u in range(1, MAX_UNITS + 1)
                  if hidden % u == 0 and directions * hidden // u <= sms),
                 None)
    if units is None:
        raise ValueError(
            f"hidden {hidden} x {directions} directions needs more than "
            f"{sms} CTAs of at most {MAX_UNITS} units: no co-resident grid")
    shared = 4 * (2 * MAX_HIDDEN + (4 * units + 32) * window)
    if shared > MAX_SHARED_BYTES:
        raise ValueError(
            f"a window of {window} steps needs {shared} bytes of shared "
            f"memory a CTA ({units} units), over the {MAX_SHARED_BYTES} an "
            f"H100 allows")
    return units


def lstm(x: torch.Tensor, params, bidirectional: bool) -> torch.Tensor:
    """(N, T, F) float32 -> (N, T, D*H): a one-layer batch-first LSTM from
    a zero state, ``params`` each direction's ``weight_ih`` (4H, F),
    ``weight_hh`` (4H, H), ``bias_ih`` and ``bias_hh`` (4H) (``nn.LSTM``'s
    ``_flat_weights``), the backward direction's outputs in time order
    after the forward's. A CUDA tensor runs the persistent kernel on the
    current stream, one launch a sequence; a CPU tensor runs
    :func:`lstm_reference`."""
    global launches
    weights = _split(params, bidirectional)
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"expected (N, T, F) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    four_h, hidden = weights[0][1].shape
    for w in weights:
        shapes = [tuple(p.shape) for p in w]
        if shapes != [(four_h, x.shape[2]), (four_h, hidden), (four_h,),
                      (four_h,)] or four_h != 4 * hidden:
            raise ValueError(f"LSTM weights of shapes {shapes} do not fit "
                             f"{x.shape[2]} features")
    if x.device.type == "cpu":
        return lstm_reference(x, params, bidirectional)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    weights = [tuple(p.contiguous() for p in w) for w in weights]
    for p in (x, *(p for w in weights for p in w)):
        if p.device != x.device or p.dtype != torch.float32:
            raise ValueError("the LSTM's input and weights must be float32 "
                             "on one device")
        if p.data_ptr() % 16:
            raise ValueError("the kernel reads float4s: the LSTM's input and "
                             "weights must be 16-byte aligned")
    n, t_len, feats = x.shape
    d = len(weights)
    out = torch.empty((n, t_len, d * hidden), dtype=torch.float32,
                      device=x.device)
    if not out.numel():
        return out
    units = plan(hidden, feats, t_len, d, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    lib = _nvcc.load(SOURCE, _bind)
    # the exchange words of each sequence, zeroed (a memset in a graph)
    xch = torch.zeros((n, d, 2, hidden), dtype=torch.int64, device=x.device)
    # a one-way LSTM passes its direction twice; the kernel reads one
    ptrs = [p.data_ptr() for w in (weights * 2)[:2] for p in w]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for s in range(n):
            err = lib.gm_lstm_persistent(
                x[s].data_ptr(), *ptrs, out[s].data_ptr(), xch[s].data_ptr(),
                t_len, feats, hidden, d, units, stream)
            if err != 0:
                raise RuntimeError(f"lstm_persistent kernel launch failed: "
                                   f"cudaError_t {err}")
            launches += 1
    return out
