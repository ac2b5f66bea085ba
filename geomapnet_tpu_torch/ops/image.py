"""Image preprocessing on the device: raw uint8 batch -> model input.

The PyTorch counterpart of :mod:`geomapnet_tpu.ops.image`, for the RobotCar
raw-Bayer path. :func:`make_device_pipeline` composes the hand-written CUDA
demosaic+normalize kernel (:mod:`geomapnet_tpu_torch.ops.cuda_image`) with a
separable resize done as two dense matmuls, the order the JAX package runs
on its accelerator. Batches are NHWC at the public boundary, as in the JAX
package.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from . import cuda_image

__all__ = [
    "demosaic_half",
    "normalize",
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
        (RobotCar raw); the only input this port takes so far
    :param resize_to: target (H, W), at most half the mosaic's size
    :param undistort_maps: not ported yet
    :return: ``pipeline(raw) -> (N[, T], out_h, out_w, 3)`` in ``dtype``

    Runs what the JAX package runs on its accelerator: the fused demosaic +
    normalize kernel writes planar float32 at half resolution, the matmul
    resize follows (normalize commutes with the linear resize), then the
    NHWC view and the cast. A CUDA batch goes through the CUDA kernel, a CPU
    batch through its plain version.
    """
    if undistort_maps is not None:
        raise NotImplementedError(
            "undistortion on the device is not ported yet (ROADMAP.md, "
            "Queue 1: undistort / full demosaic)")
    if not bayer:
        raise NotImplementedError(
            "the RGB (7Scenes) device pipeline is not ported yet "
            "(ROADMAP.md, Queue 1: slice 2)")
    if resize_to is None:
        raise NotImplementedError(
            "a full-resolution demosaic is not ported yet (ROADMAP.md, "
            "Queue 1: undistort / full demosaic); pass resize_to")
    mean = tuple(float(m) for m in mean)
    std = tuple(float(s) for s in std)
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
