"""Image preprocessing on the device: raw uint8 batch -> model input.

The PyTorch counterpart of :mod:`geomapnet_tpu.ops.image`, for the RobotCar
raw-Bayer path and the RGB (7Scenes, RobotCar processed) path. For mosaics
resized to at most half their size, :func:`make_device_pipeline` composes
the hand-written CUDA demosaic+normalize kernel
(:mod:`geomapnet_tpu_torch.ops.cuda_image`) with a separable resize done as
two dense matmuls, the order the JAX package runs on its accelerator. With
undistortion maps, or a larger target, it runs JAX's other branch as torch
ops: the full-resolution bilinear :func:`demosaic`, the LUT
:func:`undistort` (four gathers), :func:`resize_bilinear`, then
:func:`normalize`. RGB batches take JAX's non-Bayer branch: float32, an
optional undistort and resize, then :func:`normalize`. Batches are NHWC at
the public boundary, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_image

__all__ = [
    "box_halve",
    "demosaic",
    "demosaic_half",
    "precompute_undistort_maps",
    "undistort",
    "normalize",
    "resize_bilinear",
    "resize_bilinear_matmul",
    "resize_shorter_side_shape",
    "make_device_pipeline",
]


def demosaic(raw: torch.Tensor) -> torch.Tensor:
    """Batched bilinear GBRG demosaic: (N, H, W) -> (N, H, W, 3) float32 in
    [0, 255], as :func:`geomapnet_tpu.ops.image.demosaic` (the device
    version of :func:`geomapnet_tpu_torch.data.robotcar_sdk.demosaic_gbrg`):
    each site keeps its own sample and averages its cross, diagonal,
    horizontal or vertical neighbours (reflect padding) for the others."""
    x = raw.to(torch.float32)
    _, h, w = x.shape
    pad = F.pad(x[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]

    def shift(dy, dx):
        return pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    cross = (shift(-1, 0) + shift(1, 0) + shift(0, -1) + shift(0, 1)) * 0.25
    diag = (shift(-1, -1) + shift(-1, 1) + shift(1, -1) + shift(1, 1)) * 0.25
    horiz = (shift(0, -1) + shift(0, 1)) * 0.5
    vert = (shift(-1, 0) + shift(1, 0)) * 0.5

    row = torch.arange(h, device=x.device)[:, None] % 2
    col = torch.arange(w, device=x.device)[None, :] % 2
    g_mask = row == col              # G at (even, even) and (odd, odd)
    b_mask = (row == 0) & (col == 1)
    r_mask = (row == 1) & (col == 0)

    green = torch.where(g_mask, x, cross)
    red = torch.where(r_mask, x, torch.where(
        b_mask, diag, torch.where(g_mask & (row == 1), horiz, vert)))
    blue = torch.where(b_mask, x, torch.where(
        r_mask, diag, torch.where(g_mask & (row == 0), horiz, vert)))
    return torch.clamp(torch.stack([red, green, blue], dim=-1), 0.0, 255.0)


def precompute_undistort_maps(lut: np.ndarray, height: int, width: int):
    """A camera LUT (2, H*W) of float64 source coordinates -> the gather
    maps of :func:`undistort`: int32 (H, W) ``y0``, ``x0`` (the floor, edge
    clamped) and float32 (H, W) fractional parts ``fy``, ``fx``; host work
    done once (:func:`geomapnet_tpu.ops.image.precompute_undistort_maps`)."""
    lx = lut[0].reshape(height, width)
    ly = lut[1].reshape(height, width)
    x0 = np.clip(np.floor(lx), 0, width - 1).astype(np.int32)
    y0 = np.clip(np.floor(ly), 0, height - 1).astype(np.int32)
    fx = (lx - x0).astype(np.float32)
    fy = (ly - y0).astype(np.float32)
    return y0, x0, fy, fx


def undistort(img: torch.Tensor, y0, x0, fy, fx) -> torch.Tensor:
    """Batched LUT undistortion, (N, H, W, C) -> (N, H, W, C) float32: each
    output pixel bilinearly samples its source point through four gathers
    (the maps of :func:`precompute_undistort_maps`, numpy or tensors), in
    :func:`geomapnet_tpu.ops.image.undistort`'s order of operations."""
    dev = img.device
    h, w = img.shape[1], img.shape[2]
    y0 = torch.as_tensor(y0, device=dev).long()
    x0 = torch.as_tensor(x0, device=dev).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fy = torch.as_tensor(fy, device=dev)[None, :, :, None]
    fx = torch.as_tensor(fx, device=dev)[None, :, :, None]
    im = img.to(torch.float32)
    return (im[:, y0, x0] * (1 - fx) * (1 - fy)
            + im[:, y0, x1] * fx * (1 - fy)
            + im[:, y1, x0] * (1 - fx) * fy
            + im[:, y1, x1] * fx * fy)


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


@functools.lru_cache(maxsize=64)
def _float32_constant(values, device: torch.device) -> torch.Tensor:
    """``values`` (a float or a tuple) as a float32 tensor on ``device``,
    made once: a copy from the host inside a CUDA graph capture would
    fail."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def normalize(img: torch.Tensor, mean, std, dtype=torch.float32,
              scale: float = 1.0 / 255.0) -> torch.Tensor:
    """(x * scale - mean) / std over the last (channel) axis, cast to
    ``dtype``; every step in float32, as in the JAX package."""
    dev = img.device
    out = img.to(torch.float32) * _float32_constant(float(scale), dev)
    out = ((out - _float32_constant(tuple(map(float, mean)), dev))
           / _float32_constant(tuple(map(float, std)), dev))
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
    :param resize_to: target (H, W) after the geometry ops (None: none)
    :param undistort_maps: output of :func:`precompute_undistort_maps`
        (moved to each batch's device once)
    :return: ``pipeline(raw) -> (N[, T], out_h, out_w, 3)`` in ``dtype``

    The branches are JAX's. A mosaic without undistortion maps and with a
    target of at most half its size runs what the JAX package runs on its
    accelerator: the fused demosaic + normalize kernel writes planar
    float32 at half resolution (a CUDA batch through the CUDA kernel, a CPU
    batch through its plain version), the matmul resize follows (normalize
    commutes with the linear resize), then the NHWC view and the cast. Any
    other mosaic runs :func:`demosaic` at full resolution, then
    :func:`undistort` when maps are given, :func:`resize_bilinear` when a
    target is, and :func:`normalize`. RGB batches are cast to float32, then
    undistorted, resized and normalized the same way.
    """
    mean = tuple(float(m) for m in mean)
    std = tuple(float(s) for s in std)
    maps_on: dict = {}

    def maps_for(device: torch.device) -> tuple:
        # the maps move to each device once: a copy from the host inside a
        # CUDA graph capture would fail
        if device not in maps_on:
            y0, x0, fy, fx = undistort_maps
            maps_on[device] = tuple(
                torch.from_numpy(np.asarray(a)).to(device)
                for a in (y0.astype(np.int64), x0.astype(np.int64), fy, fx))
        return maps_on[device]

    def geometry_normalize(img: torch.Tensor) -> torch.Tensor:
        if undistort_maps is not None:
            img = undistort(img, *maps_for(img.device))
        if resize_to is not None:
            img = resize_bilinear(img, *resize_to)
        return normalize(img, mean, std, dtype=dtype)

    if not bayer:
        def rgb_pipeline(raw: torch.Tensor) -> torch.Tensor:
            lead = raw.shape[:-3]
            img = raw.reshape((-1,) + tuple(raw.shape[-3:])).to(torch.float32)
            out = geometry_normalize(img)
            return out.reshape(tuple(lead) + tuple(out.shape[1:]))

        return rgb_pipeline

    def pipeline(raw: torch.Tensor) -> torch.Tensor:
        # tuple batches (N, T, H, W) fold the frame axis into the batch for
        # the per-image stages (mirrors MapNet's reshape)
        lead = raw.shape[:-2]
        raw = raw.reshape((-1,) + tuple(raw.shape[-2:]))
        if (undistort_maps is None and resize_to is not None
                and resize_to[0] * 2 <= raw.shape[1]
                and resize_to[1] * 2 <= raw.shape[2]):
            img = cuda_image.demosaic_half_normalize(
                raw.contiguous(), mean, std, dtype=torch.float32, planar=True)
            img = resize_bilinear_matmul(img, *resize_to)
            out = img.permute(0, 2, 3, 1).to(dtype)
        else:
            out = geometry_normalize(demosaic(raw))
        return out.reshape(tuple(lead) + tuple(out.shape[1:]))

    return pipeline
