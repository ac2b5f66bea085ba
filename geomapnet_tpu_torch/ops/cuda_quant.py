"""int8 convolution and int8 max-pool: hand-written CUDA kernels for Hopper.

The JAX package's int8 serving trunk (:mod:`geomapnet_tpu.models.quant`)
leaves its int8 convs (``lax.conv_general_dilated`` with
``preferred_element_type=int32``) and its int8 stem max-pool
(``lax.reduce_window``) to XLA. PyTorch has no int8 convolution on CUDA, so
the port writes both:

- **K1** :func:`int8_conv` (``csrc/int8_conv.cu``): NHWC int8 activation x
  packed int8 weight -> exact int32 accumulator, with the float32 epilogue
  of ``_deq`` / relu / residual / ``_q8`` in XLA's operation order;
- **K2** :func:`int8_maxpool3x3s2` (``csrc/int8_maxpool.cu``): 3x3 stride-2
  max over int8, padded with -127.

Each is compiled with ``nvcc`` for ``sm_90a`` the first time a CUDA tensor
reaches it (:mod:`geomapnet_tpu_torch.ops._nvcc`) and counts its launches in
:data:`launches`. Beside each is its plain PyTorch version
(:func:`int8_conv_reference`, :func:`int8_maxpool3x3s2_reference`): the
wrappers take it for CPU tensors only; a CUDA tensor launches the kernel or
raises.

Scales (``s_in``, ``s_out``, ``res_scale``) are float32 values held as
0-dim tensors on the activation's device (Python floats are converted), so
a dynamic scale never leaves the card. Division by a scale is always by a
tensor: PyTorch's CUDA ``tensor / python_float`` multiplies by the
reciprocal instead, which is not the same rounding.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import _nvcc

__all__ = [
    "int8_conv",
    "int8_conv_reference",
    "int8_maxpool3x3s2",
    "int8_maxpool3x3s2_reference",
    "pack_conv_weight",
    "fma_f32",
    "conv_out_hw",
    "launches",
    "K_ALIGN",
]

# kernel launches made by each wrapper (a run shows with them that its main
# path went through the kernels)
launches = {"int8_conv": 0, "int8_maxpool3x3s2": 0}

CONV_SOURCE = "int8_conv.cu"
POOL_SOURCE = "int8_maxpool.cu"
# the packed weight's depth is padded to the kernel's shared-memory step
K_ALIGN = 64

MODES = ("acc", "deq", "relu_q", "residual")
_OUT_KIND = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2,
             torch.int8: 3}


def _bind_conv(lib: ctypes.CDLL) -> None:
    fn = lib.gm_int8_conv
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 18 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _bind_pool(lib: ctypes.CDLL) -> None:
    fn = lib.gm_int8_maxpool3x3s2
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


def pack_conv_weight(qkernel) -> torch.Tensor:
    """HWIO int8 kernel (KH, KW, I, O) -> (O, Kpad) int8, depth in
    (kh, kw, i) order, zero-padded to a multiple of :data:`K_ALIGN`."""
    k = torch.as_tensor(np.asarray(qkernel)) if not isinstance(
        qkernel, torch.Tensor) else qkernel
    if k.dtype != torch.int8 or k.dim() != 4:
        raise ValueError(f"expected an HWIO int8 kernel, got "
                         f"{tuple(k.shape)} {k.dtype}")
    kh, kw, ci, co = k.shape
    depth = kh * kw * ci
    kpad = -(-depth // K_ALIGN) * K_ALIGN
    out = torch.zeros((co, kpad), dtype=torch.int8, device=k.device)
    out[:, :depth] = k.permute(3, 0, 1, 2).reshape(co, depth)
    return out


def conv_out_hw(h: int, w: int, ksize, stride, pad) -> tuple[int, int]:
    """Output height and width of a conv with JAX-style ``pad`` pairs."""
    (pt, pb), (pl, pr) = pad
    return ((h + pt + pb - ksize[0]) // stride[0] + 1,
            (w + pl + pr - ksize[1]) // stride[1] + 1)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``fmaf(a, b, c)`` for float32 tensors: one rounding of the exact
    ``a*b + c`` to float32, on any device, as CUDA's ``__fmaf_rn`` and XLA's
    contracted multiply-add compute it.

    The product of two float32 values is exact in float64. The sum is
    rounded to float64 in round-to-odd (round to nearest, then, when the
    TwoSum error is not zero and the result's last bit is even, one step
    toward the error), and round-to-odd at 53 bits followed by rounding to
    24 bits is the correctly rounded result.
    """
    p = a.to(torch.float64) * b.to(torch.float64)
    cd = c.to(torch.float64)
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _scale(v, device) -> torch.Tensor | None:
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        if v.numel() != 1 or v.dtype != torch.float32 or v.device != device:
            raise ValueError(f"a scale must be one float32 value on {device}, "
                             f"got {tuple(v.shape)} {v.dtype} {v.device}")
        return v.reshape(())
    return torch.tensor(float(np.float32(v)), dtype=torch.float32,
                        device=device)


def _check_conv(x, w, m, b, ksize, stride, pad, mode, s_out, residual,
                res_scale, out_dtype):
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"expected an NHWC int8 activation, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, h, wd, c = x.shape
    kh, kw = ksize
    if w.dtype != torch.int8 or w.dim() != 2 or w.shape[1] % K_ALIGN or (
            w.shape[1] < kh * kw * c):
        raise ValueError(f"expected a packed (O, Kpad) int8 weight for depth "
                         f"{kh * kw * c}, got {tuple(w.shape)} {w.dtype}")
    o = w.shape[0]
    for name, v in (("m", m), ("b", b)):
        if v.dtype != torch.float32 or tuple(v.shape) != (o,):
            raise ValueError(f"{name} must be ({o},) float32, got "
                             f"{tuple(v.shape)} {v.dtype}")
    for t in (w, m, b):
        if t.device != x.device:
            raise ValueError("all operands must be on the activation's "
                             "device")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    oh, ow = conv_out_hw(h, wd, ksize, stride, pad)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"empty output for input {h}x{wd}")
    if mode == "acc":
        out = torch.int32
    elif mode == "deq":
        if out_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("deq writes float32 or bfloat16")
        out = out_dtype
    elif mode == "relu_q":
        if s_out is None:
            raise ValueError("relu_q needs s_out")
        out = torch.int8
    else:
        if residual is None:
            raise ValueError("mode 'residual' needs a residual")
        out = torch.int8 if s_out is not None else torch.float32
    if residual is not None:
        if mode != "residual":
            raise ValueError(f"a residual is only added in mode 'residual'")
        if tuple(residual.shape) != (n, oh, ow, o) or residual.dtype not in (
                torch.float32, torch.int8) or residual.device != x.device:
            raise ValueError(f"residual must be ({n}, {oh}, {ow}, {o}) "
                             f"float32 or int8, got {tuple(residual.shape)} "
                             f"{residual.dtype}")
        if residual.dtype == torch.int8 and res_scale is None:
            raise ValueError("an int8 residual needs res_scale")
    return n, h, wd, c, o, oh, ow, out


def _conv_acc_reference(x, w, ksize, stride, pad) -> torch.Tensor:
    """The exact int32 accumulator as float64 NHWC: a float64 convolution
    over the int8 values (|acc| < 2^53, so no sum rounds). cuDNN is off for
    it on the card: its FFT algorithms would round."""
    c = x.shape[3]
    kh, kw = ksize
    o = w.shape[0]
    wk = w[:, :kh * kw * c].reshape(o, kh, kw, c).permute(0, 3, 1, 2)
    xf = x.permute(0, 3, 1, 2).to(torch.float64)
    (pt, pb), (pl, pr) = pad
    xf = F.pad(xf, (pl, pr, pt, pb))
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xf, wk.to(torch.float64), stride=tuple(stride))
    return acc.permute(0, 2, 3, 1)


def int8_conv_reference(x, w, m, b, s_in=None, *, ksize, stride, pad, mode,
                        s_out=None, residual=None, res_scale=None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of :func:`int8_conv`, on any device: the
    accumulator exactly (float64 convolution), then the epilogue with the
    FMAs emulated exactly (:func:`fma_f32`)."""
    stride = tuple(stride)
    _check_conv(x, w, m, b, ksize, stride, pad, mode, s_out, residual,
                res_scale, out_dtype)
    acc = _conv_acc_reference(x, w, ksize, stride, pad)
    if mode == "acc":
        return acc.to(torch.int32)
    dev = x.device
    ms = m * _scale(s_in, dev)
    y = fma_f32(acc.to(torch.float32), ms, b)
    if residual is not None:
        if residual.dtype == torch.int8:
            y = fma_f32(residual.to(torch.float32),
                        _scale(res_scale, dev), y)
        else:
            y = y + residual
    if mode in ("relu_q", "residual"):
        y = torch.relu(y)
    if mode == "deq":
        return y.to(out_dtype)
    if s_out is None:
        return y
    return torch.clamp(torch.round(y / _scale(s_out, dev)), -127, 127
                       ).to(torch.int8)


def int8_conv(x, w, m, b, s_in=None, *, ksize, stride, pad, mode,
              s_out=None, residual=None, res_scale=None,
              out_dtype=torch.float32) -> torch.Tensor:
    """NHWC int8 conv with an exact int32 accumulator and a float32 epilogue.

    :param x: (N, H, W, C) int8 activation
    :param w: (O, Kpad) int8 weight from :func:`pack_conv_weight`
    :param m, b: (O,) float32 dequant multiplier and bias: ``acc * (m *
        s_in) + b`` as one FMA
    :param s_in: the activation's scale
    :param ksize: (KH, KW); ``stride``: (SH, SW); ``pad``: ((top, bottom),
        (left, right))
    :param mode: "acc" (int32 accumulator), "deq" (the dequant in
        ``out_dtype``, float32 or bfloat16), "relu_q" (relu, then int8 at
        ``s_out``), "residual" (add ``residual`` — float32, or int8 at
        ``res_scale`` as one FMA — then relu; int8 at ``s_out``, or float32
        when ``s_out`` is None)
    :returns: (N, OH, OW, O)

    A CUDA tensor runs the kernel on the current stream; a CPU tensor runs
    :func:`int8_conv_reference`.
    """
    stride = tuple(stride)
    if x.device.type == "cpu":
        return int8_conv_reference(
            x, w, m, b, s_in, ksize=ksize, stride=stride, pad=pad, mode=mode,
            s_out=s_out, residual=residual, res_scale=res_scale,
            out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, h, wd, c, o, oh, ow, out_dt = _check_conv(
        x, w, m, b, ksize, stride, pad, mode, s_out, residual, res_scale,
        out_dtype)
    for name, t in (("x", x), ("w", w), ("m", m), ("b", b),
                    ("residual", residual)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if w.data_ptr() % 16:
        raise ValueError("the packed weight must be 16-byte aligned")
    dev = x.device
    scales = [_scale(v, dev) for v in (
        None if mode == "acc" else s_in, s_out,
        res_scale if residual is not None and residual.dtype == torch.int8
        else None)]
    if mode != "acc" and scales[0] is None:
        raise ValueError(f"mode {mode!r} needs s_in")
    vec = (16 if c % 16 == 0 and x.data_ptr() % 16 == 0
           else 4 if c % 4 == 0 and x.data_ptr() % 4 == 0 else 1)
    res_kind = 0 if residual is None else (
        2 if residual.dtype == torch.int8 else 1)
    out = torch.empty((n, oh, ow, o), dtype=out_dt, device=dev)
    fn = _nvcc.load(CONV_SOURCE, _bind_conv).gm_int8_conv
    (pt, _), (pl, _) = pad
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), m.data_ptr(), b.data_ptr(),
                 *(0 if s is None else s.data_ptr() for s in scales),
                 0 if residual is None else residual.data_ptr(),
                 out.data_ptr(), n, h, wd, c, o, ksize[0], ksize[1],
                 stride[0], stride[1], pt, pl, oh, ow, w.shape[1],
                 _OUT_KIND[out_dt], res_kind,
                 int(mode in ("relu_q", "residual")), vec, stream)
    if err != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: cudaError_t "
                           f"{err}")
    launches["int8_conv"] += 1
    return out


def int8_maxpool3x3s2_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`int8_maxpool3x3s2`: pad with -127,
    then the max of the 9 stride-2 views."""
    _check_pool(x)
    n, h, w, c = x.shape
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), value=-127)
    out = None
    for dy in range(3):
        for dx in range(3):
            v = xp[:, :, dy:dy + 2 * oh - 1:2, dx:dx + 2 * ow - 1:2]
            out = v if out is None else torch.maximum(out, v)
    return out.permute(0, 2, 3, 1).contiguous()


def _check_pool(x):
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"expected an NHWC int8 activation, got "
                         f"{tuple(x.shape)} {x.dtype}")


def int8_maxpool3x3s2(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) int8 -> (N, (H-1)//2+1, (W-1)//2+1, C) int8: the 3x3
    stride-2 max, padding 1 filled with -127. A CUDA tensor (C a multiple
    of 16, 16-byte aligned) runs the kernel; a CPU tensor runs
    :func:`int8_maxpool3x3s2_reference`."""
    _check_pool(x)
    if x.device.type == "cpu":
        return int8_maxpool3x3s2_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, h, w, c = x.shape
    if c % 16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the pool kernel needs a contiguous, 16-byte "
                         "aligned activation with channels a multiple of 16")
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    out = torch.empty((n, oh, ow, c), dtype=torch.int8, device=x.device)
    fn = _nvcc.load(POOL_SOURCE, _bind_pool).gm_int8_maxpool3x3s2
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), n, h, w, c, oh, ow, stream)
    if err != 0:
        raise RuntimeError(f"int8_maxpool3x3s2 kernel launch failed: "
                           f"cudaError_t {err}")
    launches["int8_maxpool3x3s2"] += 1
    return out
