"""Image preprocessing on the device: raw uint8 batch -> model input.

The PyTorch counterpart of :mod:`geomapnet_tpu.ops.image`, for the RobotCar
raw-Bayer path and the RGB (7Scenes) path. For mosaics,
:func:`make_device_pipeline` composes the hand-written CUDA
demosaic+normalize kernel (:mod:`geomapnet_tpu_torch.ops.cuda_image`) with a
separable resize done as two dense matmuls, the order the JAX package runs
on its accelerator. RGB batches take JAX's non-Bayer branch: float32, an
optional resize, then :func:`normalize`. Batches are NHWC at the public
boundary, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from . import cuda_image

__all__ = [
    "box_halve",
    "demosaic_half",
    "normalize",
    "resize_bilinear",
    "resize_bilinear_matmul",
    "resize_shorter_side_shape",
    "make_device_pipeline",
]


def demosaic_half(raw: torch.Tensor) -> torch.Tensor:
    """Half-resolution demosaic: (N, H, W) GBRG -> (N, H//2, W//2, 3) f32.

    Each 2x2 Bayer quad (G B / R G) yields one RGB pixel directly:
    R = the quad's red sample, G = mean of its two greens, B = its blue.
    """
    x = raw.to(torch.float32)
    g0 = x[:, 0::2, 0::2]   # (even row, even col) = G
    b = x[:, 0::2, 1::2]    # (even row, odd col)  = B
    r = x[:, 1::2, 0::2]    # (odd row, even col)  = R
    g1 = x[:, 1::2, 1::2]   # (odd row, odd col)   = G
    return torch.stack([r, (g0 + g1) * 0.5, b], dim=-1)


def normalize(img: torch.Tensor, mean, std, dtype=torch.float32,
              scale: float = 1.0 / 255.0) -> torch.Tensor:
    """(x * scale - mean) / std over the last (channel) axis, cast to
    ``dtype``; every step in float32, as in the JAX package."""
    f32 = dict(dtype=torch.float32, device=img.device)
    out = img.to(torch.float32) * torch.tensor(scale, **f32)
    out = (out - torch.tensor(mean, **f32)) / torch.tensor(std, **f32)
    return out.to(dtype)


def resize_shorter_side_shape(h: int, w: int, size: int) -> tuple[int, int]:
    """Target (H, W) for a shortest-side resize (torchvision Resize(int))."""
    if w <= h:
        return max(1, round(h * size / w)), size
    return size, max(1, round(w * size / h))


@functools.lru_cache(maxsize=32)
def _resize_weights(n_in: int, n_out: int, device: torch.device
                    ) -> torch.Tensor:
    """Dense (n_out, n_in) bilinear weights, built in numpy exactly as
    :func:`geomapnet_tpu.ops.image.resize_bilinear_matmul` builds them
    (half-pixel centers, edge clamp), then moved to ``device`` once."""
    scale = n_in / n_out
    src = (np.arange(n_out) + 0.5) * scale - 0.5
    i0 = np.clip(np.floor(src), 0, n_in - 1).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    frac = np.clip(src - i0, 0.0, 1.0)
    w = np.zeros((n_out, n_in), np.float32)
    w[np.arange(n_out), i0] += 1.0 - frac
    w[np.arange(n_out), i1] += frac
    return torch.from_numpy(w).to(device)


def resize_bilinear_matmul(img: torch.Tensor, out_h: int, out_w: int
                           ) -> torch.Tensor:
    """Separable bilinear resize as two dense matmuls.

    (N, C, H, W) channel-planar -> (N, C, out_h, out_w) float32. Bilinear
    interpolation along each axis is a sparse linear map (2 taps/output),
    materialized as a dense (out, in) matrix; weights match
    ``jax.image.resize(method='linear', antialias=False)``.
    """
    h, w = img.shape[-2], img.shape[-1]
    img = img.to(torch.float32)
    wy = _resize_weights(h, out_h, img.device)    # (out_h, H)
    wx = _resize_weights(w, out_w, img.device)    # (out_w, W)
    out = torch.matmul(wy, img)                   # (N, C, out_h, W)
    return torch.matmul(out, wx.t())              # (N, C, out_h, out_w)


def box_halve(img: torch.Tensor) -> torch.Tensor:
    """2x2 box downsample: (N, H, W, C) -> (N, H//2, W//2, C)."""
    n, h, w, c = img.shape
    img = img[:, : h - h % 2, : w - w % 2]
    return img.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


@functools.lru_cache(maxsize=32)
def _linear_resize_weights(n_in: int, n_out: int, device: torch.device
                           ) -> torch.Tensor:
    """Dense (n_out, n_in) weights of ``jax.image.resize(method='linear',
    antialias=False)``, computed in float32 in its order: a triangle kernel
    at half-pixel sample positions, normalized per output, zero where the
    sample falls outside the input."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(
        sample[None, :] - np.arange(n_in, dtype=f32)[:, None]))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, f32(0.0)).astype(f32)
    return torch.from_numpy(np.ascontiguousarray(w.T)).to(device)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int
                    ) -> torch.Tensor:
    """Batched resize (N, H, W, C) -> (N, out_h, out_w, C) float32.

    As :func:`geomapnet_tpu.ops.image.resize_bilinear`: downscales of 2x or
    more are prefiltered with 2x2 box octaves, then a plain bilinear resize
    with ``jax.image.resize``'s weights covers the rest.
    """
    img = img.to(torch.float32)
    while img.shape[1] >= 2 * out_h and img.shape[2] >= 2 * out_w:
        img = box_halve(img)
    wy = _linear_resize_weights(img.shape[1], out_h, img.device)
    wx = _linear_resize_weights(img.shape[2], out_w, img.device)
    return torch.einsum("oh,nhwc,pw->nopc", wy, img, wx)


def make_device_pipeline(
    mean,
    std,
    resize_to: tuple[int, int] | None = None,
    undistort_maps=None,
    bayer: bool = False,
    dtype=torch.bfloat16,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Compose the device pipeline: raw uint8 batch -> model input.

    :param bayer: input is an (N, H, W) or (N, T, H, W) GBRG mosaic batch
        (RobotCar raw); else an (N, H, W, 3) or (N, T, H, W, 3) RGB batch
    :param resize_to: target (H, W); for mosaics at most half their size
    :param undistort_maps: not ported yet
    :return: ``pipeline(raw) -> (N[, T], out_h, out_w, 3)`` in ``dtype``

    Mosaics run what the JAX package runs on its accelerator: the fused
    demosaic + normalize kernel writes planar float32 at half resolution,
    the matmul resize follows (normalize commutes with the linear resize),
    then the NHWC view and the cast. A CUDA batch goes through the CUDA
    kernel, a CPU batch through its plain version. RGB batches are cast to
    float32, resized when ``resize_to`` is given, and normalized.
    """
    if undistort_maps is not None:
        raise NotImplementedError(
            "undistortion on the device is not ported yet (ROADMAP.md, "
            "Queue 1: undistort / full demosaic)")
    mean = tuple(float(m) for m in mean)
    std = tuple(float(s) for s in std)
    if not bayer:
        def rgb_pipeline(raw: torch.Tensor) -> torch.Tensor:
            lead = raw.shape[:-3]
            img = raw.reshape((-1,) + tuple(raw.shape[-3:])).to(torch.float32)
            if resize_to is not None:
                img = resize_bilinear(img, *resize_to)
            out = normalize(img, mean, std, dtype=dtype)
            return out.reshape(tuple(lead) + tuple(out.shape[1:]))

        return rgb_pipeline
    if resize_to is None:
        raise NotImplementedError(
            "a full-resolution demosaic is not ported yet (ROADMAP.md, "
            "Queue 1: undistort / full demosaic); pass resize_to")
    out_h, out_w = resize_to

    def pipeline(raw: torch.Tensor) -> torch.Tensor:
        # tuple batches (N, T, H, W) fold the frame axis into the batch for
        # the per-image stages (mirrors MapNet's reshape)
        lead = raw.shape[:-2]
        raw = raw.reshape((-1,) + tuple(raw.shape[-2:]))
        if out_h * 2 > raw.shape[1] or out_w * 2 > raw.shape[2]:
            raise NotImplementedError(
                f"resize to {resize_to} from a {tuple(raw.shape[1:])} mosaic "
                f"needs the full-resolution demosaic, not ported yet "
                f"(ROADMAP.md, Queue 1: undistort / full demosaic)")
        img = cuda_image.demosaic_half_normalize(
            raw.contiguous(), mean, std, dtype=torch.float32, planar=True)
        img = resize_bilinear_matmul(img, out_h, out_w)
        out = img.permute(0, 2, 3, 1).to(dtype)
        return out.reshape(tuple(lead) + tuple(out.shape[1:]))

    return pipeline
