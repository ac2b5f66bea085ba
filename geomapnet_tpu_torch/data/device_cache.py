"""Device-resident frame cache: the whole scene lives on the card as uint8.

The PyTorch counterpart of :func:`geomapnet_tpu.data.device_cache.
upload_frames`. A resized-uint8 7Scenes scene is 0.25-1.8 GB, so it fits in
device memory next to the model: each decoded frame is uploaded ONCE, and an
eval epoch afterwards reads its batches from the device tensor
(:mod:`geomapnet_tpu_torch.cli.eval_epoch`) instead of decoding and
uploading them again.

For the int8 serving eval (``--fuse_requant``), :func:`quantize_rows`
turns the uploaded scene into the PREQUANTIZED space-to-depth row cache of
:func:`geomapnet_tpu.cli.eval._evaluate` (its lines 304-365): with static
scales the fused trunk's int8 stem input is a per-frame constant, so
preprocess + quantize + 2x2 space-to-depth run once per scene instead of
once per window.

Sharded and multi-host uploads, ``FrameRecorder`` and ``IndexLoader`` are
not ported yet (ROADMAP.md, Queue 1, items 12 and 17).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["upload_frames", "quantize_rows", "s2d_frame_shape"]


def upload_frames(
    frames,
    device: torch.device,
    chunk: int = 192,
    num_workers: int = 4,
    max_bytes: int = 8 * 1024 ** 3,
) -> torch.Tensor:
    """Decode and upload every frame of a frame dataset, once, in chunks.

    :param frames: frame dataset (``SevenScenes`` / ``RobotCar`` /
        ``CachedScene`` wrapper / synthetic) exposing ``get_image`` /
        ``get_images``; its transform must yield fixed-shape single arrays
        (the device-pipeline uint8 path or the host-normalized float path)
    :param device: where the stack lives
    :param chunk: frames per decode+upload slice (bounds peak host memory)
    :param max_bytes: refuse datasets whose frame stack would exceed this
        (a 256x341 uint8 frame is 262 KB — 8 GB holds ~30k)
    :returns: ``(N, H, W, C)`` tensor on ``device`` in the frames' own dtype
    :raises ValueError: on oversize datasets or non-array frames
    """
    n = len(frames)
    probe = _probe_frames(frames, n, max_bytes)
    # one allocation of the whole stack; each chunk is copied into its rows
    dtype = torch.from_numpy(np.empty(0, probe.dtype)).dtype
    buf = torch.empty((n,) + probe.shape, dtype=dtype, device=device)
    last_good = probe
    n_bad = 0
    for s in range(0, n, chunk):
        idx = list(range(s, min(n, s + chunk)))
        if hasattr(frames, "get_images"):
            imgs = frames.get_images(idx, num_workers=num_workers)
        else:
            imgs = [frames.get_image(i) for i in idx]
        fixed = []
        for im in imgs:
            if im is None:  # corrupt frame: substitute the previous good
                n_bad += 1  # one (mirrors the loader's skip-substitute)
                im = last_good
            else:
                last_good = im
            fixed.append(im)
        buf[s:s + len(idx)].copy_(torch.from_numpy(np.stack(fixed)))
    if n_bad:
        print(f"device frame cache: {n_bad}/{n} frames failed to decode; "
              "substituted neighboring frames")
    return buf


def s2d_frame_shape(shape) -> tuple[int, int, int]:
    """(H, W, C) frame -> its (ceil(H/2), ceil(W/2), 4C) space-to-depth
    shape, the view each row of :func:`quantize_rows` takes."""
    h, w, c = shape
    return ((h + h % 2) // 2, (w + w % 2) // 2, 4 * c)


def quantize_rows(frames: torch.Tensor, qnet, preprocess=None,
                  chunk: int = 64) -> torch.Tensor:
    """(N, H, W, C) cached frames -> (N, H'*W'*4C) int8 rows: ``preprocess``,
    then :func:`~geomapnet_tpu_torch.models.quant.quantize_input_int8` at
    ``qnet``'s static stem scale, then
    :func:`~geomapnet_tpu_torch.models.quant.space_to_depth_input` (an odd
    H or W is zero-padded high), ``chunk`` frames at a time so the float
    intermediate never holds the whole scene. A 256x341 frame becomes one
    row of 128*171*12 bytes."""
    from ..models.quant import quantize_input_int8, space_to_depth_input

    n = frames.shape[0]
    row = int(np.prod(s2d_frame_shape(tuple(frames.shape[1:]))))
    out = torch.empty((n, row), dtype=torch.int8, device=frames.device)
    with torch.inference_mode():
        for s in range(0, n, chunk):
            b = frames[s:s + chunk]
            x = preprocess(b) if preprocess is not None else b
            out[s:s + len(b)] = space_to_depth_input(
                quantize_input_int8(qnet, x)).reshape(len(b), -1)
    return out


def _probe_frames(frames, n: int, max_bytes: int) -> np.ndarray:
    """Validate a frame dataset for caching; return frame 0 as the probe."""
    if n == 0:
        raise ValueError("empty frame dataset")
    probe = frames.get_image(0)
    if probe is None or not isinstance(probe, np.ndarray):
        raise ValueError(
            "device frame cache needs fixed-shape array frames "
            f"(got {type(probe).__name__}; mode-2 [color, depth] datasets "
            "and skip_images datasets are not supported)"
        )
    total = n * probe.nbytes
    if total > max_bytes:
        raise ValueError(
            f"frame stack is {total / 2**30:.2f} GiB "
            f"({n} x {probe.nbytes / 2**20:.2f} MiB) > max_bytes "
            f"{max_bytes / 2**30:.2f} GiB"
        )
    return probe
