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

Training from the cache (:class:`geomapnet_tpu_torch.train.loop.Trainer`
with ``device_cache``) uploads each split with
:func:`upload_dataset_frames` and draws its batches from
:class:`IndexLoader`: int32 frame indices and poses, which the train step
gathers from the device stack. With ``ingest_overlap`` a
:class:`FrameRecorder` stages every frame the first epoch decodes, so the
upload costs no second decode. Each is a copy of the JAX package's
single-process code (tests/test_torch_import_isolation.py pins the copies);
the sharded and multi-host uploads wait for ROADMAP.md, Queue 1, item 17.
"""

from __future__ import annotations

import numpy as np
import torch

from .loader import Loader

__all__ = ["upload_frames", "upload_dataset_frames", "frame_sources",
           "FrameRecorder", "IndexLoader", "quantize_rows",
           "s2d_frame_shape"]


def frame_sources(dataset) -> tuple:
    """Base frame dataset(s) a (possibly composite) dataset gathers from.

    Composites declare their own ``frame_sources``; an MF-shaped composite
    gathers from its ``dset``; plain frame datasets are their own source.
    """
    if hasattr(dataset, "frame_sources"):
        return tuple(dataset.frame_sources)
    if hasattr(dataset, "dset"):  # MF-shaped composite
        return (dataset.dset,)
    return (dataset,)


class _ConcatFrames:
    """Read-only concatenated view over several frame sources, indexed as
    their buffers concatenate in ``frame_sources`` order."""

    def __init__(self, srcs):
        self.srcs = list(srcs)
        self._lens = [len(s) for s in self.srcs]
        self._offs = np.concatenate([[0], np.cumsum(self._lens)])

    def __len__(self):
        return int(self._offs[-1])

    def _locate(self, i: int):
        s = int(np.searchsorted(self._offs, i, side="right")) - 1
        return self.srcs[s], i - int(self._offs[s])

    def get_image(self, i):
        src, j = self._locate(int(i))
        return src.get_image(j)

    def get_images(self, idx, num_workers: int = 1):
        out = [None] * len(idx)
        by_src: dict = {}
        for pos, i in enumerate(idx):
            src, j = self._locate(int(i))
            by_src.setdefault(id(src), (src, []))[1].append((pos, j))
        for src, pairs in by_src.values():
            if hasattr(src, "get_images"):
                imgs = src.get_images([j for _, j in pairs],
                                      num_workers=num_workers)
            else:
                imgs = [src.get_image(j) for _, j in pairs]
            for (pos, _), im in zip(pairs, imgs):
                out[pos] = im
        return out


def upload_dataset_frames(dataset, device: torch.device,
                          **kwargs) -> torch.Tensor:
    """Upload every base frame of ``dataset`` (composite-aware) to
    ``device``: one ``(N, ...)`` stack, the sources in ``frame_sources``
    order, so a composite's ``get_indices`` rows index it directly.
    ``kwargs`` go to :func:`upload_frames`."""
    bufs = [upload_frames(src, device, **kwargs)
            for src in frame_sources(dataset)]
    return torch.cat(bufs, dim=0) if len(bufs) > 1 else bufs[0]


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


class FrameRecorder:
    """Capture the frames a live image-loader epoch decodes into a host
    staging stack, so the device-cache upload costs no second decode.

    :meth:`install` wraps the frame source's ``get_image`` / ``get_images``
    *instance* attributes (which shadow the bound methods, the dataset's
    own internal calls included) and scatters every decoded frame into
    ``staging``; :meth:`finalize` restores them, decodes only the frames the
    epoch never touched and returns the complete stack for one upload.
    """

    def __init__(self, src, max_bytes: int = 8 * 1024 ** 3):
        self.src = src
        self.n = len(src)
        probe = _probe_frames(src, self.n, max_bytes)
        self.staging = np.empty((self.n,) + probe.shape, probe.dtype)
        self.seen = np.zeros(self.n, bool)
        self.staging[0] = probe
        self.seen[0] = True
        self._orig: dict = {}

    def _record(self, i: int, im) -> None:
        if im is not None and 0 <= i < self.n and not self.seen[i]:
            self.staging[i] = im
            self.seen[i] = True

    def install(self) -> "FrameRecorder":
        src = self.src
        orig_one = src.get_image
        self._orig["get_image"] = orig_one

        def get_image(i):
            im = orig_one(i)
            self._record(int(i), im)
            return im

        src.get_image = get_image
        if hasattr(src, "get_images"):
            orig_many = src.get_images
            self._orig["get_images"] = orig_many

            def get_images(idx, **kw):
                imgs = orig_many(idx, **kw)
                for i, im in zip(idx, imgs):
                    self._record(int(i), im)
                return imgs

            src.get_images = get_images
        return self

    def restore(self) -> None:
        for name, fn in self._orig.items():
            setattr(self.src, name, fn)
        self._orig.clear()

    def finalize(self, num_workers: int = 4) -> np.ndarray:
        """Decode the frames the warmup epoch never touched; return the
        complete ``(N, ...)`` stack (a corrupt frame takes the first staged
        one, as :func:`upload_frames` substitutes a neighbour)."""
        self.restore()
        missing = np.flatnonzero(~self.seen)
        if missing.size:
            want = [int(i) for i in missing]
            if hasattr(self.src, "get_images"):
                imgs = self.src.get_images(want, num_workers=num_workers)
            else:
                imgs = [self.src.get_image(i) for i in want]
            fallback = self.seen.nonzero()[0][0]
            for i, im in zip(missing, imgs):
                self.staging[i] = self.staging[fallback] if im is None else im
                self.seen[i] = True
        return self.staging


class IndexLoader(Loader):
    """:class:`~geomapnet_tpu_torch.data.loader.Loader` for the device frame
    cache: yields ``(frame_indices, poses, n_padded)`` instead of decoded
    images, with the Loader's order, shuffle, padding and prefetch.

    ``frame_indices`` is int32 ``(B, T)`` for tuple (MF) datasets or
    ``(B,)`` for plain frame datasets, ready to gather from the stack
    :func:`upload_dataset_frames` built; poses are assembled as the image
    path assembles them (MF's pose block, or the frame dataset's
    target-transformed pose).
    """

    def _make_batch(self, idx: np.ndarray, pad: int):
        ds = self.dataset
        if hasattr(ds, "get_indices"):  # tuple (MF) dataset
            rows = [ds.get_indices(int(i)) for i in idx]
            poses = np.stack(
                [ds._poses_for(r).astype(np.float32) for r in rows])
            frame_idx = np.stack(rows).astype(np.int32)
        else:  # plain frame dataset
            tt = getattr(ds, "target_transform", None)
            poses = np.stack([
                np.asarray(
                    tt(ds.poses[int(i)]) if tt is not None
                    else ds.poses[int(i)],
                    np.float32,
                )
                for i in idx
            ])
            frame_idx = np.asarray(idx, np.int32)
        if pad:
            frame_idx = np.concatenate(
                [frame_idx, np.repeat(frame_idx[-1:], pad, axis=0)])
            poses = np.concatenate(
                [poses, np.repeat(poses[-1:], pad, axis=0)])
        return frame_idx, poses, pad
