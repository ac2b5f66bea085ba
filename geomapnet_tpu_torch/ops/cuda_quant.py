"""int8 convolution and int8 max-pool: hand-written CUDA kernels for Hopper.

The JAX package's int8 serving trunk (:mod:`geomapnet_tpu.models.quant`)
leaves its int8 convs (``lax.conv_general_dilated`` with
``preferred_element_type=int32``) and its int8 stem max-pool
(``lax.reduce_window``) to XLA. PyTorch has no int8 convolution on CUDA, so
the port writes both:

- **K1** :func:`int8_conv` (``csrc/int8_conv.cu``): NHWC int8 activation x
  packed int8 weight -> exact int32 accumulator, with the float32 epilogue
  of ``_deq`` / relu / residual / ``_q8`` in XLA's operation order. Three
  routes, picked by channel count (:func:`conv_plan`): ``body`` (C a
  multiple of 16: ``wgmma`` over a ``cp.async`` ring), ``s2d`` (C = 12: the
  space-to-depth stem, built for its bytes) and ``simple`` (any other C:
  the loader path's 3-channel 7x7 stem, on PR 3's ``mma.sync`` kernel).
  :class:`PreparedConv` holds one conv site's launch arguments, prepared
  once, so a launch costs the host little;
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
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import _nvcc

__all__ = [
    "int8_conv",
    "int8_conv_reference",
    "PreparedConv",
    "ConvPlan",
    "conv_plan",
    "conv_route",
    "int8_maxpool3x3s2",
    "int8_maxpool3x3s2_reference",
    "pack_conv_weight",
    "fma_f32",
    "conv_out_hw",
    "launches",
    "K_ALIGN",
]

ROUTES = ("body", "s2d", "simple")
# kernel launches made by each wrapper, and by each route of K1 (a run shows
# with them that its main path went through the kernels)
launches = {"int8_conv": 0, **{f"int8_conv.{r}": 0 for r in ROUTES},
            "int8_maxpool3x3s2": 0}

CONV_SOURCE = "int8_conv.cu"
POOL_SOURCE = "int8_maxpool.cu"
# the packed weight's depth is padded to the kernel's shared-memory step
K_ALIGN = 64

MODES = ("acc", "deq", "relu_q", "residual")
_OUT_KIND = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2,
             torch.int8: 3}


# the C entry point of each route; all take the same arguments: an array of
# 9 pointers (x, w, m, b, s_in, s_out, s_res, residual, out), an array of 18
# ints (n, h, w, c, o, kh, kw, sh, sw, pt, pl, oh, ow, kpad, out_kind,
# res_kind, relu, tile) and the stream
_ENTRY = {"body": "gm_int8_conv_body", "s2d": "gm_int8_conv_s2d",
          "simple": "gm_int8_conv"}
_PTRS = ctypes.c_void_p * 9
_INTS = ctypes.c_int * 18


def _bind_conv(lib: ctypes.CDLL) -> None:
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [_PTRS, _INTS, ctypes.c_void_p]
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


# ------------------------------------------------------------- K1's tile plan
#
# Mirrors the constants of csrc/int8_conv.cu: the CPU tests hold the plan
# to what the kernels need (a valid wgmma width, shared memory that fits,
# a grid that covers the output).

SM_COUNT = 132            # streaming multiprocessors of an H100 SXM
SMEM_PER_BLOCK = 232448   # the most dynamic shared memory a block can have
SMEM_PER_SM = 233472      # an SM's shared memory (1 KB of it per block is
                          # the runtime's)
BODY_BM, BODY_BK = 128, 128
BODY_THREADS = 256        # 2 warpgroups: each copies and multiplies
BODY_BN = (64, 128, 256)  # the wgmma widths the body route instantiates
BODY_STAGES = {64: 3, 128: 3, 256: 4}   # ring stages of each width
BODY_BLOCKS_PER_SM = {64: 3, 128: 2, 256: 1}   # its launch bounds
S2D_C, S2D_O, S2D_THREADS, S2D_K = 12, 64, 128, 192
S2D_ROWS = 2              # output rows per s2d block
S2D_GEOMETRY = ((4, 4), (1, 1), ((2, 1), (2, 1)))
SIMPLE_BM = SIMPLE_BN = 64
SIMPLE_THREADS = 128


@dataclass(frozen=True)
class ConvPlan:
    """How K1 runs one conv: the route, its output tile (``bm`` pixels x
    ``bn`` channels per block), grid, threads and dynamic shared memory, and
    ``tile``, the C entry point's route argument (BN for ``body``, the
    gather width for ``simple``)."""

    route: str
    bm: int
    bn: int
    grid: tuple
    threads: int
    smem: int
    tile: int


def body_smem(bn: int) -> int:
    """Dynamic shared memory of a body block (``BodyCfg<BN, S>::SMEM``):
    1 KB of alignment slack, the ring or the staged float tile, then ``ms``
    and ``b``."""
    ring = BODY_STAGES[bn] * (BODY_BM + bn) * BODY_BK
    staging = BODY_BM * (bn + 4) * 4
    return 1024 + max(ring, staging) + 8 * bn


def s2d_row_bytes(ow: int) -> int:
    """Shared bytes of one input row of the s2d route (``s2d_row_bytes``)."""
    return (48 + (-(-ow // 16) * 16 + 2) * S2D_C + 16 + 15) // 16 * 16


def s2d_smem(ow: int, direct: bool = False) -> int:
    """Dynamic shared memory of an s2d block (``s2d_smem``): the input rows
    of its output rows, the weight in rows of 208 bytes, the rows' offsets,
    ``ms`` and ``b``, one output row staged: as int8 rows of 80 bytes for
    the stem's own epilogue (``direct``: relu_q, no residual), else as
    floats (the plan states this, the larger)."""
    row = S2D_O + 16 if direct else (S2D_O + 4) * 4
    return ((S2D_ROWS + 3) * s2d_row_bytes(ow) + S2D_O * (S2D_K + 16) + 32
            + 2 * S2D_O * 4 + -(-ow // 16) * 16 * row)


def _body_bn(o: int) -> int:
    """The body tile's width: 64 for up to 64 output channels, 128 up to
    256, else 256. Timing every width at every body geometry of the window
    on an H100 chose it: 128 beat 64 at layers 2 and 3, and 256 matched or
    beat 128 at layer 4, whose M = 5,280 makes 42 x 2 blocks of 128 x 256,
    one wave on 132 SMs."""
    return 64 if o <= 64 else 128 if o <= 256 else 256


def conv_route(c: int) -> str:
    """K1's route for a conv with ``c`` input channels: ``body`` for a
    multiple of 16, ``s2d`` for the 12-channel space-to-depth stem (its
    geometry is checked by :func:`conv_plan`), ``simple`` otherwise."""
    if c % 16 == 0:
        return "body"
    if c == S2D_C:
        return "s2d"
    return "simple"


def conv_plan(shape, o: int, ksize, stride, pad, route: str | None = None
              ) -> ConvPlan:
    """K1's plan for an (N, H, W, C) int8 input and ``o`` output channels:
    the route by channel count (:func:`conv_route`) unless ``route`` names
    one (``simple`` runs any geometry: the old kernel as a yardstick).
    Raises when the route cannot run the geometry."""
    n, h, w, c = shape
    ksize, stride = tuple(ksize), tuple(stride)
    pad = tuple(tuple(p) for p in pad)
    oh, ow = conv_out_hw(h, w, ksize, stride, pad)
    m = n * oh * ow
    route = route or conv_route(c)
    if route == "body":
        if c % 16 or o % 16:
            raise ValueError(f"the body route needs input and output "
                             f"channels that are multiples of 16, got {c} "
                             f"and {o}")
        bn = _body_bn(o)
        return ConvPlan("body", BODY_BM, bn,
                        (-(-m // BODY_BM), -(-o // bn)), BODY_THREADS,
                        body_smem(bn), bn)
    if route == "s2d":
        if (c, o) != (S2D_C, S2D_O) or (ksize, stride, pad) != S2D_GEOMETRY:
            raise ValueError(
                f"the s2d route runs the {S2D_C}-channel 4x4 stride-1 stem "
                f"with pad ((2, 1), (2, 1)) and {S2D_O} outputs, got {c} "
                f"channels, {o} outputs, {ksize} {stride} {pad}")
        smem = s2d_smem(ow)
        if smem > SMEM_PER_BLOCK:
            raise ValueError(f"an s2d row of {ow} pixels needs {smem} bytes "
                             f"of shared memory")
        # grid: the pairs of output rows; the kernel is persistent and
        # launches as many blocks as the card holds at once to walk them
        return ConvPlan("s2d", ow, S2D_O, (n * -(-oh // S2D_ROWS), 1),
                        S2D_THREADS, smem, 0)
    if route == "simple":
        vec = 16 if c % 16 == 0 else 4 if c % 4 == 0 else 1
        return ConvPlan("simple", SIMPLE_BM, SIMPLE_BN,
                        (-(-m // SIMPLE_BM), -(-o // SIMPLE_BN)),
                        SIMPLE_THREADS, 0, vec)
    raise ValueError(f"route must be one of {ROUTES}, got {route!r}")


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


def _scale_arg(v, device, index: int):
    """A scale as a 0-dim float32 tensor on ``device`` (CUDA device
    ``index``): the tensor itself when it is one (no copy), else a new one
    (a Python float)."""
    if (type(v) is torch.Tensor and v.dtype is torch.float32
            and v.get_device() == index and v.numel() == 1):
        return v
    return _scale(v, device)


class _Launch:
    """One K1 launch, prepared: the route's bound C function, the weight,
    ``m`` and ``b`` pointers and every integer argument, checked once. A
    call checks and adds what changes from call to call (the activation,
    the scales, the residual, a new output) and launches on the current
    stream."""

    __slots__ = ("fn", "ptrs", "ints", "out_shape", "out_dtype", "device",
                 "index", "counter", "res_kind", "needs_s_in", "scales")

    def __init__(self, x, w, m, b, ksize, stride, pad, mode, s_out,
                 residual, res_scale, out_dtype, route=None):
        n, h, wd, c, o, oh, ow, out_dt = _check_conv(
            x, w, m, b, ksize, stride, pad, mode, s_out, residual, res_scale,
            out_dtype)
        for name, t in (("w", w), ("m", m), ("b", b)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if w.data_ptr() % 16:
            raise ValueError("the packed weight must be 16-byte aligned")
        plan = conv_plan(x.shape, o, ksize, stride, pad, route)
        self.fn = getattr(_nvcc.load(CONV_SOURCE, _bind_conv),
                          _ENTRY[plan.route])
        self.counter = f"int8_conv.{plan.route}"
        # the argument arrays, made once: a call sets only the pointers that
        # change (so a prepared launch serves one thread at a time)
        self.ptrs = _PTRS(0, w.data_ptr(), m.data_ptr(), b.data_ptr())
        (pt, _), (pl, _) = pad
        self.res_kind = 0 if residual is None else (
            2 if residual.dtype == torch.int8 else 1)
        self.ints = _INTS(n, h, wd, c, o, ksize[0], ksize[1], stride[0],
                          stride[1], pt, pl, oh, ow, w.shape[1],
                          _OUT_KIND[out_dt], self.res_kind,
                          int(mode in ("relu_q", "residual")), plan.tile)
        self.scales = None   # the scale tensors of the last call
        self.out_shape = (n, oh, ow, o)
        self.out_dtype = out_dt
        self.device = x.device
        self.index = x.device.index if x.device.index is not None else \
            torch.cuda.current_device()
        self.needs_s_in = mode != "acc"

    def __call__(self, x, s_in, s_out, residual, res_scale) -> torch.Tensor:
        index = self.index
        if x.get_device() != index or x.dtype is not torch.int8:
            raise ValueError(f"x must be int8 on cuda:{index}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("x must be contiguous and 16-byte aligned")
        if residual is not None and (
                residual.get_device() != index
                or not residual.is_contiguous() or residual.data_ptr() % 16):
            raise ValueError(f"residual must be on cuda:{index}, contiguous "
                             f"and 16-byte aligned")
        ptrs = self.ptrs
        raw = (s_in if self.needs_s_in else None, s_out,
               res_scale if self.res_kind == 2 else None)
        last = self.scales
        if last is None or any(a is not b for a, b in zip(raw, last)):
            # new scale objects: check them (a static site passes the same
            # tensors every call); they stay referenced while in use
            if self.needs_s_in and s_in is None:
                raise ValueError("this mode needs s_in")
            scales = tuple(None if v is None else
                           _scale_arg(v, self.device, index) for v in raw)
            for i, v in enumerate(scales):
                ptrs[4 + i] = None if v is None else v.data_ptr()
            # keep them for the next call unless a float made a new tensor
            self.scales = scales if all(
                a is b for a, b in zip(scales, raw)) else None
        out = torch.empty(self.out_shape, dtype=self.out_dtype,
                          device=self.device)
        ptrs[0] = x.data_ptr()
        ptrs[7] = None if residual is None else residual.data_ptr()
        ptrs[8] = out.data_ptr()
        if torch._C._cuda_getDevice() == index:
            err = self.fn(ptrs, self.ints,
                          torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                err = self.fn(ptrs, self.ints,
                              torch._C._cuda_getCurrentRawStream(index))
        if err != 0:
            raise RuntimeError(f"int8_conv kernel launch failed: cudaError_t "
                               f"{err}")
        launches["int8_conv"] += 1
        launches[self.counter] += 1
        return out


def int8_conv(x, w, m, b, s_in=None, *, ksize, stride, pad, mode,
              s_out=None, residual=None, res_scale=None,
              out_dtype=torch.float32, route=None) -> torch.Tensor:
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
    :param route: K1's route on the card, by default :func:`conv_route`'s;
        ``"simple"`` runs any geometry on PR 3's kernel (a yardstick)
    :returns: (N, OH, OW, O)

    A CUDA tensor runs the kernel on the current stream (every operand
    contiguous and 16-byte aligned); a CPU tensor runs
    :func:`int8_conv_reference`. This checks and prepares every argument on
    each call; :class:`PreparedConv` does that once per site and shape.
    """
    stride = tuple(stride)
    if x.device.type == "cpu":
        return int8_conv_reference(
            x, w, m, b, s_in, ksize=ksize, stride=stride, pad=pad, mode=mode,
            s_out=s_out, residual=residual, res_scale=res_scale,
            out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _Launch(x, w, m, b, ksize, stride, pad, mode, s_out, residual,
                   res_scale, out_dtype, route)(x, s_in, s_out, residual,
                                                res_scale)


class PreparedConv:
    """K1 for one conv site: the packed weight, ``m`` and ``b`` fixed, and
    the launch arguments prepared once per input shape, stride, padding and
    epilogue (the wrapper's checks of what those fix run then, not on every
    call). A call on CPU tensors runs :func:`int8_conv` (the plain
    version)."""

    def __init__(self, w: torch.Tensor, m: torch.Tensor, b: torch.Tensor,
                 ksize):
        self.w, self.m, self.b = w, m, b
        self.ksize = tuple(ksize)
        self._launches: dict = {}

    def __call__(self, x, s_in=None, *, stride, pad, mode, s_out=None,
                 residual=None, res_scale=None, out_dtype=torch.float32
                 ) -> torch.Tensor:
        if not x.is_cuda:
            return int8_conv(x, self.w, self.m, self.b, s_in,
                             ksize=self.ksize, stride=stride, pad=pad,
                             mode=mode, s_out=s_out, residual=residual,
                             res_scale=res_scale, out_dtype=out_dtype)
        # device and dtype are checked by the prepared launch
        key = (x.shape, stride, pad, mode, out_dtype, s_out is None,
               res_scale is None,
               None if residual is None else (residual.shape,
                                              residual.dtype))
        launch = self._launches.get(key)
        if launch is None:
            launch = self._launches[key] = _Launch(
                x, self.w, self.m, self.b, self.ksize, tuple(stride), pad,
                mode, s_out, residual, res_scale, out_dtype)
        return launch(x, s_in, s_out, residual, res_scale)


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
