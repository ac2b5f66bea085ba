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
upload costs no second decode. Each is a copy of the JAX package's code
(tests/test_torch_import_isolation.py pins the copies).

Over a data-parallel group (:class:`geomapnet_tpu_torch.parallel.
DataParallel`, one rank per card) the cache comes in two layouts, as in the
JAX package:

- replicated (:func:`upload_frames_global`): each rank decodes only its
  share of the frames, then one ``all_gather_into_tensor`` gives every
  rank the whole stack;
- frame-sharded (:func:`upload_frames_sharded`, ``--device_cache shard``):
  each rank holds ``ceil(N / W)`` frames, so the capacity grows with the
  rank count, and a batch is read by :func:`make_sharded_gather`: each
  rank gathers, for the full index batch, the rows it owns (zeros
  elsewhere), and one ``reduce_scatter_tensor`` (sum) leaves each rank its
  batch shard, exact on uint8 and int8 rows because every row has one
  owner.
"""

from __future__ import annotations

import numpy as np
import torch

from .loader import Loader

__all__ = ["upload_frames", "upload_frames_global", "upload_frames_sharded",
           "upload_dataset_frames", "make_sharded_gather",
           "local_shard_range", "frame_sources", "FrameRecorder",
           "IndexLoader", "quantize_rows", "s2d_frame_shape"]


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


def upload_dataset_frames(dataset, device: torch.device, mesh=None,
                          shard_frames=False, **kwargs) -> torch.Tensor:
    """Upload every base frame of ``dataset`` (composite-aware) to
    ``device``: one ``(N, ...)`` stack, the sources in ``frame_sources``
    order, so a composite's ``get_indices`` rows index it directly.
    ``kwargs`` go to the upload.

    Over a data-parallel ``mesh`` of several ranks each rank decodes only
    its share of the frames and the stack replicates by an all-gather
    (:func:`upload_frames_global`).

    :param shard_frames: keep the stack frame-sharded over ``mesh``
        (:func:`upload_frames_sharded`; batches gather through
        :func:`make_sharded_gather`), one concatenated index space for a
        composite's sources
    """
    srcs = frame_sources(dataset)
    if shard_frames:
        if mesh is None:
            raise ValueError("shard_frames needs a mesh")
        combined = _ConcatFrames(srcs) if len(srcs) > 1 else srcs[0]
        return upload_frames_sharded(combined, mesh, **kwargs)
    if mesh is not None and mesh.world_size > 1:
        bufs = [upload_frames_global(src, mesh, **kwargs) for src in srcs]
    else:
        bufs = [upload_frames(src, device, **kwargs) for src in srcs]
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


def _upload_range(frames, n: int, lo: int, hi: int, probe: np.ndarray,
                  device: torch.device, chunk: int,
                  num_workers: int) -> torch.Tensor:
    """Frames ``[lo, hi)`` of a dataset of ``n`` decoded into one device
    stack; indices past ``n`` repeat the last frame (the sharded layouts'
    pad rows) and a corrupt frame takes the probe, as the JAX package's
    collective uploads substitute it."""
    dtype = torch.from_numpy(np.empty(0, probe.dtype)).dtype
    buf = torch.empty((hi - lo,) + probe.shape, dtype=dtype, device=device)
    idx = [min(i, n - 1) for i in range(lo, hi)]
    for s in range(0, len(idx), chunk):
        part = idx[s:s + chunk]
        if hasattr(frames, "get_images"):
            imgs = frames.get_images(part, num_workers=num_workers)
        else:
            imgs = [frames.get_image(i) for i in part]
        stack = np.stack([probe if im is None else im for im in imgs])
        buf[s:s + len(part)].copy_(torch.from_numpy(stack))
    return buf


def upload_frames_global(
    frames,
    mesh,
    num_workers: int = 4,
    max_bytes: int = 8 * 1024 ** 3,
    chunk: int = 192,
) -> torch.Tensor:
    """Multi-rank replicated upload: each rank decodes only its share, one
    all-gather replicates the stack.

    Rank ``r`` decodes frames ``[r * ceil(N/W), (r + 1) * ceil(N/W))`` (pad
    rows past ``N`` repeat the last frame), uploads them, and one
    ``all_gather_into_tensor`` over ``mesh`` gives every rank the whole
    ``(N, ...)`` stack on its device: host decode costs ~1/W per rank, and
    the replication moves at the interconnect's rate. Every rank must call
    it (it runs a collective)."""
    n = len(frames)
    probe = _probe_frames(frames, n, max_bytes)
    lo, hi = _shard_bounds(n, mesh.world_size, mesh.rank)
    local = _upload_range(frames, n, lo, hi, probe, mesh.device, chunk,
                          num_workers)
    return mesh.all_gather(local)[:n]


def upload_frames_sharded(
    frames,
    mesh,
    num_workers: int = 4,
    max_bytes: int = 8 * 1024 ** 3,
    chunk: int = 192,
) -> torch.Tensor:
    """Frame-SHARDED device cache: capacity scales with the rank count.

    Rank ``r`` decodes and keeps frames ``[r * ceil(N/W), (r + 1) *
    ceil(N/W))`` on its device; the frame axis pads up to a multiple of
    ``W`` (pad rows repeat the last frame and are never indexed). Batches
    read it through :func:`make_sharded_gather`. ``max_bytes`` bounds the
    PER-RANK shard, as :func:`upload_frames` bounds a replica. Returns this
    rank's ``(ceil(N/W), ...)`` shard."""
    n = len(frames)
    d = int(mesh.world_size)
    probe = _probe_frames(frames, n, float("inf"))
    per_device = -(-n // d) * probe.nbytes
    if per_device > max_bytes:
        raise ValueError(
            f"sharded frame stack needs {per_device / 2**30:.2f} GiB per "
            f"device ({n} frames / {d} devices x "
            f"{probe.nbytes / 2**20:.2f} MiB) > max_bytes "
            f"{max_bytes / 2**30:.2f} GiB"
        )
    per = -(-n // d)
    lo = mesh.rank * per
    return _upload_range(frames, n, lo, lo + per, probe, mesh.device, chunk,
                         num_workers)


def _shard_bounds(n: int, world: int, rank: int) -> tuple[int, int]:
    """Rank ``rank``'s rows ``[lo, hi)`` of an ``n``-frame axis padded to a
    multiple of ``world`` (``hi`` may pass ``n``: pad rows)."""
    per = -(-n // world)
    return rank * per, (rank + 1) * per


def make_sharded_gather(mesh):
    """Build ``gather(buf, idx) -> buf[idx]``'s batch shard for a
    frame-sharded cache.

    ``buf`` is this rank's ``(ceil(N/W), ...)`` shard
    (:func:`upload_frames_sharded`); ``idx`` is the FULL int ``(B,)`` or
    ``(B, T)`` index batch, the same on every rank, with ``B`` divisible by
    the rank count. Each rank gathers the frames it owns for the whole
    batch (the other rows zero), then one ``reduce_scatter_tensor`` (sum)
    both combines the single-owner rows and leaves rank ``r`` rows ``[r *
    B/W, (r + 1) * B/W)``: the shard a data-parallel step consumes, equal
    bit for bit to ``buf_full[idx]``'s rows (uint8 and int8 sums are exact
    when every row has one owner). Every rank must call it with the same
    ``idx`` shape (it runs a collective); no host sync, so it can be
    captured in a CUDA graph on NCCL."""
    W, rank = int(mesh.world_size), int(mesh.rank)

    def gather(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        if idx.shape[0] % W:
            raise ValueError(f"index batch {idx.shape[0]} is not divisible "
                             f"by the {W}-rank 'data' group")
        n_local = buf.shape[0]
        loc = idx.reshape(-1).to(torch.int64) - rank * n_local
        ok = (loc >= 0) & (loc < n_local)
        g = buf.index_select(0, loc.clamp(0, n_local - 1))
        g = torch.where(ok.view((-1,) + (1,) * (g.dim() - 1)), g,
                        torch.zeros((), dtype=g.dtype, device=g.device))
        out = mesh.reduce_scatter(g)
        return out.view((idx.shape[0] // W,) + tuple(idx.shape[1:])
                        + tuple(buf.shape[1:]))

    return gather


def local_shard_range(n: int, mesh) -> tuple:
    """Frame-index range ``[lo, hi)`` this rank contributes to the
    collective uploads (:func:`upload_frames_global`,
    :func:`upload_frames_sharded`): used to bound a multi-rank
    :class:`FrameRecorder` to the frames this rank actually uploads."""
    lo, hi = _shard_bounds(n, mesh.world_size, mesh.rank)
    return lo, min(hi, n)


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

    Over several ranks pass ``lo`` / ``hi`` to record only the frames this
    rank uploads (:func:`local_shard_range`: staging drops to ~N/W);
    ``finalize`` then completes just that range and :meth:`as_source`
    feeds the collective upload (:func:`upload_frames_global` /
    :func:`upload_frames_sharded`) from staging.
    """

    def __init__(self, src, max_bytes: int = 8 * 1024 ** 3,
                 lo: int = 0, hi: int | None = None):
        self.src = src
        self.n = len(src)
        self.lo = int(lo)
        self.hi = self.n if hi is None else min(int(hi), self.n)
        n_range = self.hi - self.lo
        if not 0 < n_range <= self.n:
            raise ValueError(f"bad record range [{lo}, {hi}) for {self.n}")
        probe = _probe_frames(src, n_range, max_bytes)
        self.staging = np.empty((n_range,) + probe.shape, probe.dtype)
        self.seen = np.zeros(n_range, bool)
        if self.lo == 0:
            self.staging[0] = probe
            self.seen[0] = True
        self._orig: dict = {}

    def _record(self, i: int, im) -> None:
        if im is not None and self.lo <= i < self.hi \
                and not self.seen[i - self.lo]:
            self.staging[i - self.lo] = im
            self.seen[i - self.lo] = True

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
        complete ``(hi - lo, ...)`` stack (a corrupt frame takes the first
        staged one, as :func:`upload_frames` substitutes a neighbour)."""
        self.restore()
        missing = np.flatnonzero(~self.seen)
        if missing.size:
            want = [int(i) + self.lo for i in missing]
            if hasattr(self.src, "get_images"):
                imgs = self.src.get_images(want, num_workers=num_workers)
            else:
                imgs = [self.src.get_image(i) for i in want]
            fallback = (self.seen.nonzero()[0][0] if self.seen.any() else
                        None)
            for i, im in zip(missing, imgs):
                if im is None:
                    im = (self.staging[fallback] if fallback is not None
                          else _probe_frames(self.src, 1, float("inf")))
                self.staging[i] = im
                self.seen[i] = True
        return self.staging

    def as_source(self, num_workers: int = 4) -> "_StagedSource":
        """Finalize this recorder's range and return a frame source over the
        FULL ``[0, n)`` index space: staged frames come from host memory,
        the rest from the original dataset. Feeds the collective uploads,
        which ask each rank only for its own range."""
        self.finalize(num_workers=num_workers)
        return _StagedSource(self)


class _StagedSource:
    """Frame-source adapter over a finalized :class:`FrameRecorder`."""

    def __init__(self, rec: FrameRecorder):
        self.rec = rec

    def __len__(self):
        return self.rec.n

    def get_image(self, i):
        r = self.rec
        i = int(i)
        if r.lo <= i < r.hi:
            return r.staging[i - r.lo]
        return r.src.get_image(i)

    def get_images(self, idx, num_workers: int = 1):
        r = self.rec
        out = [None] * len(idx)
        miss = []
        for pos, i in enumerate(idx):
            i = int(i)
            if r.lo <= i < r.hi:
                out[pos] = r.staging[i - r.lo]
            else:
                miss.append((pos, i))
        if miss:
            if hasattr(r.src, "get_images"):
                imgs = r.src.get_images([i for _, i in miss],
                                        num_workers=num_workers)
            else:
                imgs = [r.src.get_image(i) for _, i in miss]
            for (pos, _), im in zip(miss, imgs):
                out[pos] = im
        return out


class IndexLoader(Loader):
    """:class:`~geomapnet_tpu_torch.data.loader.Loader` for the device frame
    cache: yields ``(frame_indices, poses, n_padded)`` instead of decoded
    images, with the Loader's order, shuffle, padding, process sharding and
    prefetch.

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
