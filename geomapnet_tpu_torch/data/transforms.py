"""Host-side image transforms: shortest-side resize, jitter, normalize.

A numpy + PIL copy of :mod:`geomapnet_tpu.data.transforms` (that package
cannot be imported without jax); tests/test_torch_import_isolation.py and
tests/test_torch_sevenscenes.py pin the copy to the original. It mirrors the
reference's torchvision pipeline (upstream scripts/train.py:120-128):
``Resize(256)`` (shortest side, bilinear) -> optional ``ColorJitter`` -> to
float -> ``Normalize(mean, sqrt(var))``. The reference stores per-channel
*variance* in ``stats.txt`` and takes the sqrt at setup (upstream
scripts/train.py:127); :class:`Normalize` takes (mean, std) directly and
:func:`std_from_stats` does the sqrt.

With the device pipeline, the host transform keeps resized uint8
(``keep_uint8=True``) and the normalize runs on the device
(:func:`geomapnet_tpu_torch.cli.builders.build_device_preprocess`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "resize_shorter_side",
    "color_jitter",
    "Normalize",
    "ImageTransform",
    "std_from_stats",
]


def resize_shorter_side(img, size: int):
    """Resize a PIL image so the shorter side equals ``size`` (torchvision
    Resize(int))."""
    from PIL import Image

    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(1, round(h * size / w))
    else:
        new_w, new_h = max(1, round(w * size / h)), size
    if (new_w, new_h) == (w, h):
        return img
    return img.resize((new_w, new_h), Image.BILINEAR)


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(factor * a + (1.0 - factor) * b, 0.0, 255.0)


def color_jitter(
    img: np.ndarray,
    rng: np.random.RandomState,
    brightness: float = 0.0,
    contrast: float = 0.0,
    saturation: float = 0.0,
    hue: float = 0.0,
) -> np.ndarray:
    """Random photometric jitter on a float (H, W, 3) array in [0, 255].

    Factor ranges and per-op semantics follow torchvision ColorJitter
    (uniform factor in [max(0, 1-x), 1+x]; hue shift in [-hue, hue] turns of
    the hue wheel); op order is randomly permuted per call.
    """
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda im: _blend(im, np.zeros_like(im), f))
    if contrast > 0:
        f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)

        def _contrast(im, f=f):
            gray = im @ np.array([0.299, 0.587, 0.114])
            return _blend(im, gray.mean(), f)

        ops.append(_contrast)
    if saturation > 0:
        f = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)

        def _saturation(im, f=f):
            gray = (im @ np.array([0.299, 0.587, 0.114]))[..., None]
            return _blend(im, gray, f)

        ops.append(_saturation)
    if hue > 0:
        shift = rng.uniform(-hue, hue)

        def _hue(im, shift=shift):
            from PIL import Image

            hsv = np.asarray(
                Image.fromarray(im.astype(np.uint8)).convert("HSV"),
                dtype=np.int16,
            )
            hsv[..., 0] = (hsv[..., 0] + int(shift * 255)) % 256
            return np.asarray(
                Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB"),
                dtype=np.float64,
            )

        ops.append(_hue)

    for k in rng.permutation(len(ops)):
        img = ops[k](img)
    return img


def std_from_stats(stats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split a (2, 3) ``stats.txt`` array into (mean, std=sqrt(variance))."""
    stats = np.asarray(stats)
    return stats[0], np.sqrt(stats[1])


@dataclasses.dataclass
class Normalize:
    """Per-channel (x - mean) / std on [0, 1]-scaled images."""

    mean: Sequence[float]
    std: Sequence[float]

    def __call__(self, img: np.ndarray) -> np.ndarray:
        mean = np.asarray(self.mean, dtype=np.float32)
        std = np.asarray(self.std, dtype=np.float32)
        return (img - mean) / std


@dataclasses.dataclass
class ImageTransform:
    """The full host transform: PIL image -> float32 (H, W, 3) HWC array.

    :param resize: shortest-side target (None to skip)
    :param normalize: Normalize instance (None to emit raw [0, 1] floats)
    :param color_jitter_strength: b/c/s jitter amount (hue fixed at 0.5 when
        active, matching upstream scripts/train.py:124-125)
    :param rng: RandomState for jitter
    :param keep_uint8: emit resized uint8 (for the device-side pipeline:
        normalize/cast happen on the device, the host->device transfer is 4x
        smaller)
    """

    resize: int | None = 256
    normalize: Normalize | None = None
    color_jitter_strength: float = 0.0
    rng: np.random.RandomState | None = None
    keep_uint8: bool = False

    def __call__(self, img) -> np.ndarray:
        if isinstance(img, np.ndarray):
            # already decoded+resized
            if (img.dtype == np.uint8 and img.ndim == 3 and self.keep_uint8
                    and self.color_jitter_strength == 0):
                # uint8 in, uint8 out, nothing to do
                return img
            arr = np.asarray(img, dtype=np.float32)
            if arr.ndim == 2:
                arr = np.stack([arr] * 3, axis=-1)
        else:
            if self.resize:
                img = resize_shorter_side(img, self.resize)
            arr = np.asarray(img.convert("RGB"), dtype=np.float32)
        if self.color_jitter_strength > 0:
            rng = self.rng if self.rng is not None else np.random.RandomState()
            arr = color_jitter(
                arr, rng,
                brightness=self.color_jitter_strength,
                contrast=self.color_jitter_strength,
                saturation=self.color_jitter_strength,
                hue=0.5,
            ).astype(np.float32)
        if self.keep_uint8:
            # round, don't truncate: astype floors, which would bias the
            # uint8 device path ~0.5/255 darker than the float host path
            return np.clip(np.rint(arr), 0, 255).astype(np.uint8)
        arr = arr / 255.0
        if self.normalize is not None:
            arr = self.normalize(arr)
        return arr.astype(np.float32)
