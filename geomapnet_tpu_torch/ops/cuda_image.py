"""Fused GBRG demosaic-half + normalize: a hand-written CUDA kernel for Hopper.

The PyTorch counterpart of :mod:`geomapnet_tpu.ops.pallas_image` (the Pallas
TPU kernel ``demosaic_half_normalize``). The kernel lives in
``geomapnet_tpu_torch/csrc/demosaic_half_normalize.cu``; it is compiled with
``nvcc`` for ``sm_90a`` into ``geomapnet_tpu_torch/_build/`` the first time a
CUDA tensor reaches :func:`demosaic_half_normalize`, and bound with ctypes
(:mod:`geomapnet_tpu_torch.ops._nvcc`; plain C entry point, pointers and the
stream as ``c_void_p``).

:func:`demosaic_half_normalize_reference` is the plain PyTorch version of the
same function. The wrapper uses it for CPU tensors only; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _nvcc

__all__ = [
    "demosaic_half_normalize",
    "demosaic_half_normalize_reference",
    "launches",
]

# kernel launches made by demosaic_half_normalize (a run shows with it that
# its main path went through the kernel)
launches = 0

SOURCE = "demosaic_half_normalize.cu"

# the JAX kernel multiplies by 1/255 rounded to float32 (so does the plain
# version below; the CUDA source spells the same float as 0x1.010102p-8f)
_INV255 = 1.0 / 255.0


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.gm_demosaic_half_normalize
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_int64] * 3
        + [ctypes.c_float] * 6
        + [ctypes.c_int] * 3
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int


def demosaic_half_normalize_reference(
    raw: torch.Tensor,
    mean: tuple[float, float, float],
    std: tuple[float, float, float],
    dtype: torch.dtype = torch.bfloat16,
    planar: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device.

    (N, H, W) uint8 GBRG -> normalized (N, H/2, W/2, 3) ``dtype``, or
    (N, 3, H/2, W/2) with ``planar=True``. Same operations in the same order
    as the JAX kernel: f32 samples, G = (g0 + g1) * 0.5, then
    (v * float32(1/255) - mean) / std and one rounding to ``dtype``.
    """
    x = raw.to(torch.float32)
    g0 = x[:, 0::2, 0::2]   # (even row, even col) = G
    b = x[:, 0::2, 1::2]    # (even row, odd col)  = B
    r = x[:, 1::2, 0::2]    # (odd row, even col)  = R
    g1 = x[:, 1::2, 1::2]   # (odd row, odd col)   = G
    img = torch.stack([r, (g0 + g1) * 0.5, b], dim=1)
    f32 = dict(dtype=torch.float32, device=raw.device)
    m = torch.tensor(mean, **f32).view(1, 3, 1, 1)
    s = torch.tensor(std, **f32).view(1, 3, 1, 1)
    out = ((img * torch.tensor(_INV255, **f32)) - m) / s
    out = out.to(dtype)
    return out if planar else out.permute(0, 2, 3, 1).contiguous()


def demosaic_half_normalize(
    raw: torch.Tensor,
    mean: tuple[float, float, float],
    std: tuple[float, float, float],
    dtype: torch.dtype = torch.bfloat16,
    planar: bool = False,
) -> torch.Tensor:
    """(N, H, W) uint8 GBRG -> normalized (N, H/2, W/2, 3) ``dtype``.

    ``planar=True`` returns channel-first (N, 3, H/2, W/2). ``dtype`` is
    ``torch.float32`` or ``torch.bfloat16``. A CUDA tensor runs the kernel on
    the current stream; a CPU tensor runs
    :func:`demosaic_half_normalize_reference`.
    """
    global launches
    if raw.dtype != torch.uint8 or raw.dim() != 3:
        raise ValueError(f"expected an (N, H, W) uint8 mosaic, got "
                         f"{tuple(raw.shape)} {raw.dtype}")
    n, h, w = raw.shape
    if h % 2 or w % 2:
        raise ValueError(f"mosaic height and width must be even, got {h}x{w}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    if len(mean) != 3 or len(std) != 3:
        raise ValueError("mean and std need 3 channels each")
    if raw.device.type == "cpu":
        return demosaic_half_normalize_reference(raw, mean, std, dtype, planar)
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    if not raw.is_contiguous():
        raise ValueError("the mosaic must be contiguous")
    fn = _nvcc.load(SOURCE, _bind).gm_demosaic_half_normalize
    shape = (n, 3, h // 2, w // 2) if planar else (n, h // 2, w // 2, 3)
    out = torch.empty(shape, dtype=dtype, device=raw.device)
    vec = int(w % 8 == 0 and raw.data_ptr() % 8 == 0)
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream(raw.device).cuda_stream
        err = fn(raw.data_ptr(), out.data_ptr(), n, h, w,
                 *(float(m) for m in mean), *(float(s) for s in std),
                 int(dtype == torch.bfloat16), int(planar), vec, stream)
    if err != 0:
        raise RuntimeError(f"demosaic_half_normalize kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    return out
