"""The training loop: epochs, validation, snapshots, metrics.

The PyTorch counterpart of :class:`geomapnet_tpu.train.loop.Trainer`
(upstream ``Trainer.train_val``, common/train.py:206-320) on the loader
path: the same epoch structure (validate on every ``val_freq``-th epoch and
on the last one, snapshot on every ``snapshot``-th epoch and at the end),
the same per-batch data/batch-time meters, ``print_freq`` console lines and
``metrics.jsonl`` records (keys ``loss``, ``lr``, ``data_time``,
``batch_time`` and the criterion weights), on one device or data-parallel
over a group of ranks:

- batches stream through :class:`geomapnet_tpu_torch.data.loader.Loader`
  (a copy of the JAX package's, with the same seeded shuffle, so both
  packages draw the same batches from the same seed) with background
  prefetch;
- the train step (:mod:`geomapnet_tpu_torch.train.state`) returns its loss
  on the device: the host reads it back only at ``print_freq`` points, and
  validation losses stay on the device until one readback at the end.

With ``device_cache`` each split is uploaded to the device once
(:mod:`geomapnet_tpu_torch.data.device_cache`) and the steps gather their
frames from it by index (:class:`~geomapnet_tpu_torch.data.device_cache.
IndexLoader` batches); ``ingest_overlap`` trains the first epoch from the
image loader while its decoded frames are staged for the upload;
``steps_per_launch = K`` runs K train steps (and K validation batches) as
one :class:`KLaunch`: a CUDA graph over static buffers on a card.

Data parallel (``mesh``, a :class:`geomapnet_tpu_torch.parallel.
DataParallel` of one rank per card, launched by ``torchrun``): the JAX
Trainer's multi-process semantics. Each rank loads ``batch_size / W`` rows
of every global batch (the Loader's process sharding; with gradient
accumulation the rows of :func:`geomapnet_tpu_torch.parallel.
microbatch_rows`), the step syncs BatchNorm and all-reduces the gradient
(:func:`geomapnet_tpu_torch.parallel.shard_step`), the weights start from
rank 0's (:func:`geomapnet_tpu_torch.parallel.replicated`), and only rank
0 writes ``log.txt``, ``metrics.jsonl`` and checkpoints (every rank resumes
from the shared logdir). The device cache replicates by an all-gather
(each rank decodes its share) or, with ``device_cache="shard"``, stays
frame-sharded and each batch is read by one reduce-scatter
(:func:`geomapnet_tpu_torch.data.device_cache.make_sharded_gather`); with
``steps_per_launch`` the collectives are captured in the CUDA graph
(NCCL).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..data.composite import MF, MFOnline
from ..data.device_cache import (
    FrameRecorder,
    IndexLoader,
    _ConcatFrames,
    frame_sources,
    local_shard_range,
    make_sharded_gather,
    upload_dataset_frames,
    upload_frames_global,
    upload_frames_sharded,
)
from ..data.loader import Loader
from ..ops import cuda_image
from ..parallel.mesh import make_mesh, microbatch_rows, replicated
from ..parallel.multihost import (
    assert_same_across_processes,
    local_batch_size,
    make_global_batch,
    process_count,
)
from ..utils.logger import AverageMeter, MetricsWriter, Tee
from .checkpoint import load_model_params, restore_checkpoint, \
    save_checkpoint
from .optim import make_optimizer
from .state import gather_frames, make_eval_step, make_train_step

__all__ = ["Trainer", "KLaunch", "chunked"]

PROFILE_BATCHES = 10


def chunked(iterable, k):
    """Lists of up to ``k`` consecutive items; the last may be shorter (an
    epoch's tail, which runs as single steps)."""
    chunk = []
    for item in iterable:
        chunk.append(item)
        if len(chunk) == k:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def _frames_per_item(dataset) -> int:
    """The frames the model forwards for one item of ``dataset``: both
    tuples of a MapNet++ item, an MF tuple's frames, else one."""
    if isinstance(dataset, MFOnline):
        return dataset.train_set.steps + dataset.val_set.steps
    if isinstance(dataset, MF):
        return dataset.steps
    return 1


def _kernel_launches() -> dict:
    """The launch counts of the kernels a training step can reach."""
    return {"demosaic_half_normalize": cuda_image.launches}


class KLaunch:
    """``launch(idx_k, poses_k, frames) -> (K,) losses``: ``body(idx, poses,
    frames) -> loss`` for each of K stacked index batches, as one launch.

    On a card the stacks are copied into static device buffers and the K
    bodies run as one CUDA graph replay. The first launch runs them eagerly
    on a side stream (lazy set-up, the optimizer's state), the second
    captures the graph on that stream and replays it, every later one only
    replays. The graph reads ``frames`` and the model's tensors where they
    were at capture, so a launch with another ``frames`` tensor raises.
    Kernel wrappers count a launch at capture, not at replay:
    ``per_replay`` holds each counter's launches in one capture and
    ``replays`` the replays. On the CPU the K bodies run eagerly over the
    same buffers.
    """

    def __init__(self, body: Callable, k: int, device: torch.device):
        self.body = body
        self.k = int(k)
        self.device = torch.device(device)
        self.graph = None
        self.warmed = False
        self.replays = 0
        self.per_replay: dict = {}
        self._idx = self._poses = self._out = None
        self._frames_ptr = None

    def _stage(self, idx_k: np.ndarray, poses_k: np.ndarray) -> None:
        if self._idx is None or self._idx.shape != idx_k.shape:
            if self.graph is not None:
                raise ValueError(f"captured for {tuple(self._idx.shape)} "
                                 f"batches, got {idx_k.shape}")
            self._idx = torch.empty(idx_k.shape, dtype=torch.int32,
                                    device=self.device)
            self._poses = torch.empty(poses_k.shape, dtype=torch.float32,
                                      device=self.device)
        for dst, src in ((self._idx, idx_k), (self._poses, poses_k)):
            src = torch.from_numpy(np.ascontiguousarray(src))
            if self.device.type == "cuda":
                src = src.pin_memory()
            dst.copy_(src, non_blocking=True)

    def _run(self, frames: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.body(self._idx[j], self._poses[j], frames)
                            for j in range(self.k)])

    def __call__(self, idx_k: np.ndarray, poses_k: np.ndarray,
                 frames: torch.Tensor) -> torch.Tensor:
        if len(idx_k) != self.k:
            raise ValueError(f"a launch takes {self.k} batches, got "
                             f"{len(idx_k)}")
        self._stage(idx_k, poses_k)
        if self.device.type != "cuda":
            return self._run(frames)
        current = torch.cuda.current_stream(self.device)
        if self.graph is None:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            if not self.warmed:
                with torch.cuda.stream(side):
                    out = self._run(frames)
                out.record_stream(current)
                current.wait_stream(side)
                self.warmed = True
                return out
            before = _kernel_launches()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                self._out = self._run(frames)
            current.wait_stream(side)
            self.graph = graph
            self._frames_ptr = frames.data_ptr()
            self.per_replay = {k: v - before[k]
                               for k, v in _kernel_launches().items()}
        elif frames.data_ptr() != self._frames_ptr:
            raise RuntimeError("the frame cache moved after the graph was "
                               "captured")
        self.graph.replay()
        self.replays += 1
        return self._out.clone()


class Trainer:
    """Drives training of a PoseNet/MapNet-family model on ``device``.

    :param model: :class:`~geomapnet_tpu_torch.models.posenet.PoseNet` or
        :class:`~geomapnet_tpu_torch.models.posenet.MapNet`
    :param train_criterion / val_criterion: criteria of
        :mod:`geomapnet_tpu_torch.losses.criterion`
    :param config: :class:`geomapnet_tpu_torch.cli.config.ExperimentConfig`
    :param experiment: experiment name (logdir ``<logdir_root>/<experiment>``)
    :param train_dataset / val_dataset: indexable (imgs, poses) datasets
        (MapNet++ trains on ``MFOnline`` items and has no validation
        split: ``val_dataset`` None)
    :param checkpoint: a port checkpoint to start from
    :param resume_optim: restore the optimizer, loss weights and epoch too
        (else the weights only)
    :param device: where the model trains (a CUDA device, or the CPU)
    :param profile_dir: ``torch.profiler`` trace of the first
        ``PROFILE_BATCHES`` batches, written there as a Chrome trace
    :param debug_nans: anomaly detection in the backward, and a check that
        the loss is finite at each print point
    :param preprocess: device-side image function applied in the steps (the
        loader then emits raw uint8 batches)
    :param accum_steps: gradient-accumulation microbatches per update
    :param device_cache: upload each split's frames to the device once and
        feed the steps by index gather; turned off, with the JAX Trainer's
        message, when a train frame source's transform jitters (the cache
        would freeze one draw). ``"shard"`` keeps the stacks frame-sharded
        over the data-parallel group (replicated, with the JAX Trainer's
        message, when there is no group; a group of one rank runs the
        sharded path with its collectives over that rank)
    :param steps_per_launch: with ``device_cache``, K train steps and K
        validation batches per :class:`KLaunch` (a CUDA graph on a card);
        an epoch's tail shorter than K runs single steps. Ignored, with the
        JAX Trainer's message, without ``device_cache``
    :param ingest_overlap: with ``device_cache``, train the first epoch
        from the image loader while a :class:`~geomapnet_tpu_torch.data.
        device_cache.FrameRecorder` stages its decoded frames; the cache is
        uploaded at the end of that epoch (decode paid once), and the index
        loader's shuffle advances one epoch, so epochs 2+ draw the batches
        of a serial run; over several ranks each records only the frames it
        uploads
    :param mesh: the data-parallel group (default: :func:`geomapnet_tpu_torch.
        parallel.make_mesh` on ``device``, which spans the
        ``torch.distributed`` world once it is initialized)
    :param use_mesh: False trains this process alone; as in the JAX
        Trainer, a multi-process run always uses the group
    """

    def __init__(
        self,
        model: nn.Module,
        train_criterion: nn.Module,
        config,
        experiment: str,
        train_dataset,
        val_dataset=None,
        val_criterion: nn.Module | None = None,
        checkpoint: str | None = None,
        resume_optim: bool = False,
        logdir_root: str = "logs",
        device: torch.device | str = "cuda",
        profile_dir: str | None = None,
        debug_nans: bool = False,
        preprocess=None,
        accum_steps: int = 1,
        device_cache: bool | str = False,
        steps_per_launch: int = 1,
        ingest_overlap: bool = False,
        mesh=None,
        use_mesh: bool = True,
    ):
        self.device = torch.device(device)
        # the data-parallel group: each rank loads 1/W of every global
        # batch; logs, metrics and checkpoints are written by rank 0 only.
        # A multi-process run always uses the group, whatever use_mesh says
        if mesh is None and (use_mesh or process_count() > 1):
            mesh = make_mesh(self.device)
        self.mesh = mesh if mesh is not None and mesh.active else None
        self.process_index = 0 if self.mesh is None else self.mesh.rank
        self.process_count = 1 if self.mesh is None else self.mesh.world_size
        self.is_main = self.process_index == 0
        local_bs = local_batch_size(config.batch_size, self.mesh)
        self.model = model.to(device=self.device,
                              memory_format=torch.channels_last)
        self.config = config
        self.experiment = experiment
        self.profile_dir = profile_dir
        self.debug_nans = debug_nans
        self.train_criterion = train_criterion.to(self.device)
        self.val_criterion = (val_criterion or train_criterion).to(
            self.device)

        self.logdir = Path(logdir_root) / experiment
        self.logdir.mkdir(parents=True, exist_ok=True)
        self.tee = (Tee(self.logdir / "log.txt").install() if self.is_main
                    else None)
        self.metrics = MetricsWriter(self.logdir / "metrics.jsonl",
                                     enabled=self.is_main)

        print("---------------------------------------")
        print(f"Experiment: {experiment}")
        for k, v in vars(config).items():
            print(f"{k}: {v}")
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        print(f"Device: {self.device} ({name})")
        if self.mesh is not None:
            print(f"Process {self.process_index}/{self.process_count} "
                  f"({self.mesh.backend}), local batch {local_bs}")
        print("---------------------------------------")

        if device_cache:
            # cached frames are post-transform: a host jitter would freeze
            # one draw for every epoch
            for src in frame_sources(train_dataset):
                jitter = getattr(getattr(src, "transform", None),
                                 "color_jitter_strength", 0)
                if jitter:
                    print(f"trainer: device_cache disabled — the train "
                          f"transform jitters "
                          f"(color_jitter_strength={jitter})")
                    device_cache = False
                    break
        self.device_cache = bool(device_cache)
        self._cache_sharded = self.device_cache and device_cache == "shard"
        if self._cache_sharded and self.mesh is None:
            print("trainer: device_cache='shard' needs a data-parallel "
                  "group; using the replicated cache")
            self._cache_sharded = False
        if steps_per_launch > 1 and not self.device_cache:
            print("trainer: steps_per_launch needs device_cache "
                  "(the batches must already live on device); ignoring")
        self.steps_per_launch = (
            max(1, int(steps_per_launch)) if self.device_cache else 1)

        loader_cls = IndexLoader if self.device_cache else Loader
        self._loader_kwargs = dict(
            process_index=self.process_index,
            process_count=self.process_count,
            num_workers=config.num_workers)
        # with accumulation over several ranks each rank loads its share of
        # every global microbatch (JAX splits the GLOBAL batch)
        self._train_rows = (
            microbatch_rows(self.process_index, self.process_count,
                            config.batch_size, accum_steps)
            if self.process_count > 1 and accum_steps > 1 else None)
        self.train_loader = loader_cls(
            train_dataset, local_bs, shuffle=config.shuffle,
            drop_last=True, seed=config.seed, rows=self._train_rows,
            **self._loader_kwargs)
        self.val_loader = (
            loader_cls(val_dataset, local_bs, shuffle=False,
                       drop_last=False, seed=config.seed,
                       **self._loader_kwargs)
            if (config.do_val and val_dataset is not None) else None
        )

        self.optimizer = make_optimizer(
            config.opt, config.lr, self.model, self.train_criterion,
            config.weight_decay,
            steps_per_epoch=max(1, len(self.train_loader)),
            max_grad_norm=config.max_grad_norm, **config.optim_extras)

        self.start_epoch = 0
        if checkpoint:
            if resume_optim:
                self.start_epoch = restore_checkpoint(
                    checkpoint, self.model, self.train_criterion,
                    self.optimizer)
                print(f"Resumed {checkpoint} at epoch {self.start_epoch}")
            else:
                load_model_params(checkpoint, self.model)
                print(f"Loaded model weights from {checkpoint}")
        if self.mesh is not None:
            # every rank starts from rank 0's weights and loss weights
            replicated(self.model, self.mesh)
            replicated(self.train_criterion, self.mesh)

        # per trained epoch: host seconds (to a device sync), seconds spent
        # waiting on the loader, steps and forwarded frames
        self.epoch_stats: list[dict] = []
        self._frames_per_item = _frames_per_item(train_dataset)
        gather = gather_frames
        if self._cache_sharded:
            # every rank's index batch, then the sharded gather's
            # reduce-scatter leaves each rank its own rows
            sharded = make_sharded_gather(self.mesh)
            mesh = self.mesh

            def gather(frames, idx):
                return sharded(frames, mesh.all_gather(idx))

        self.train_step = make_train_step(
            self.model, self.train_criterion, self.optimizer,
            preprocess=preprocess, accum_steps=accum_steps, mesh=self.mesh,
            gather=gather)
        self.eval_step = make_eval_step(self.model, self.val_criterion,
                                        preprocess=preprocess, gather=gather)

        # the device frame cache: the splits' frame stacks, the warmup
        # epoch's recorders (ingest_overlap), the K-step launches, and the
        # seconds spent decoding and uploading the stacks
        self._train_frames = self._val_frames = None
        self._warmup_pending = False
        self._recorders: list = []
        self._val_shares_train = False
        self._train_launch = self._eval_launch = None
        self.upload_secs = 0.0
        if self.device_cache:
            self._setup_cache(train_dataset, val_dataset, ingest_overlap)

    def _setup_cache(self, train_dataset, val_dataset,
                     ingest_overlap: bool) -> None:
        cfg = self.config
        nw = cfg.num_workers
        srcs = frame_sources(train_dataset)
        has_val = self.val_loader is not None
        self._val_shares_train = (has_val and
                                  frame_sources(val_dataset) == srcs)
        up = dict(mesh=self.mesh, shard_frames=self._cache_sharded,
                  num_workers=nw)
        local_bs = self.train_loader.batch_size
        t0 = time.time()
        if ingest_overlap:
            self._warmup_pending = True
            # over several ranks (or sharded) each rank stages only the
            # frames it uploads
            ranged = self._collective_finalize()
            self._recorders = []
            for src in srcs:
                lo, hi = (local_shard_range(len(src), self.mesh) if ranged
                          else (0, None))
                self._recorders.append(
                    FrameRecorder(src, lo=lo, hi=hi).install())
            self._warmup_loader = Loader(
                train_dataset, local_bs, shuffle=cfg.shuffle,
                drop_last=True, seed=cfg.seed, rows=self._train_rows,
                **self._loader_kwargs)
            self._warmup_val_loader = (
                Loader(val_dataset, local_bs, shuffle=False,
                       drop_last=False, seed=cfg.seed, **self._loader_kwargs)
                if self._val_shares_train else None)
            if has_val and not self._val_shares_train:
                self._val_frames = upload_dataset_frames(
                    val_dataset, self.device, **up)
        else:
            self._train_frames = upload_dataset_frames(
                train_dataset, self.device, **up)
            self._val_frames = (
                self._train_frames if self._val_shares_train
                else upload_dataset_frames(val_dataset, self.device, **up)
                if has_val else None)
        self._synchronize()
        self.upload_secs = time.time() - t0
        held = [b for b in (self._train_frames, self._val_frames)
                if b is not None]
        shard = " (this rank's shard)" if self._cache_sharded else ""
        print(f"device cache: {sum(b.shape[0] for b in held)} frames{shard}, "
              f"{sum(b.nbytes for b in held) / 2 ** 30:.3f} GiB on "
              f"{self.device} in {self.upload_secs:.2f} s"
              + (" (train split at the end of the warmup epoch)"
                 if ingest_overlap else ""))
        K = self.steps_per_launch
        if K > 1:
            seed = cfg.seed
            self._train_launch = KLaunch(
                lambda i, p, f: self.train_step(i, p, seed=seed, frames=f),
                K, self.device)
            self._eval_launch = KLaunch(
                lambda i, p, f: self.eval_step(i, p, frames=f)[0], K,
                self.device)

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _collective_finalize(self) -> bool:
        """Whether the cache uploads through the collective paths (several
        ranks, or the sharded layout)."""
        return self.mesh is not None and (self._cache_sharded
                                          or self.process_count > 1)

    def _put(self, imgs: np.ndarray, poses: np.ndarray, index: bool = False):
        """This rank's host batch on its device (the local shard of the
        global batch: :func:`geomapnet_tpu_torch.parallel.
        make_global_batch`). Index batches (the frame cache) go through
        pinned memory without a host sync."""
        return make_global_batch((imgs, poses), self.device,
                                 non_blocking=index)

    def graph_launches(self) -> dict:
        """Per K-step launch (``train``, ``val``): its replays and the
        kernel launches one replay makes (counted once, at capture, by the
        kernels' wrappers)."""
        return {name: dict(replays=launch.replays,
                           per_replay=dict(launch.per_replay))
                for name, launch in (("train", self._train_launch),
                                     ("val", self._eval_launch))
                if launch is not None}

    def _finalize_device_cache(self) -> None:
        """End of the warmup epoch (``ingest_overlap``): upload the staged
        frames and advance the index loader's shuffle by the epoch the
        warmup loader drew."""
        pre_staged = sum(int(r.seen.sum()) for r in self._recorders)
        n_total = sum(r.n for r in self._recorders)
        nw = self.config.num_workers
        t0 = time.time()
        if self._collective_finalize():
            # each rank staged its own range; the collective uploads ask
            # each rank for exactly that range (stragglers out of it come
            # from the original dataset)
            staged = [r.as_source(num_workers=nw) for r in self._recorders]
            if self._cache_sharded:
                combined = (_ConcatFrames(staged) if len(staged) > 1
                            else staged[0])
                self._train_frames = upload_frames_sharded(
                    combined, self.mesh, num_workers=nw)
            else:
                bufs = [upload_frames_global(src, self.mesh, num_workers=nw)
                        for src in staged]
                self._train_frames = (torch.cat(bufs) if len(bufs) > 1
                                      else bufs[0])
        else:
            stacks = [r.finalize(num_workers=nw) for r in self._recorders]
            staging = (np.concatenate(stacks, axis=0) if len(stacks) > 1
                       else stacks[0])
            self._train_frames = torch.from_numpy(staging).to(self.device)
        if self._val_shares_train:
            self._val_frames = self._train_frames
        self._synchronize()
        self.upload_secs += time.time() - t0
        self._warmup_pending = False
        self._recorders = []
        if self.config.shuffle:
            self.train_loader.rng.shuffle(
                np.arange(len(self.train_loader.dataset)))
        print(f"device cache finalized from warmup epoch: "
              f"{pre_staged}/{n_total} frames staged in-epoch")

    def _save(self, epoch: int) -> None:
        """Rank 0 writes the checkpoint; every rank waits for it, so a rank
        that resumes from the shared logdir finds it."""
        if self.is_main:
            save_checkpoint(self.logdir, epoch, self.model,
                            self.train_criterion, self.optimizer)
        if self.mesh is not None:
            self.mesh.barrier()

    def validate(self, epoch: int) -> float:
        """The validation loss, weighted by each batch's real (unpadded)
        rows; the per-batch losses stay on the device until one readback."""
        losses, weights, pads = [], [], []
        batch_time = AverageMeter()
        end = time.time()
        if self._warmup_pending and self._val_frames is None:
            # warmup epoch, the val split shares the train frames: the
            # cache is not built yet, so validate from the image loader
            loader, frames = self._warmup_val_loader, None
        else:
            loader, frames = self.val_loader, self._val_frames
        launch = self._eval_launch if frames is not None else None
        K = self.steps_per_launch if launch is not None else 1
        n_val = len(loader)
        base = 0
        for chunk in chunked(loader, K):
            if launch is not None and len(chunk) == K:
                chunk_losses = list(launch(np.stack([c[0] for c in chunk]),
                                           np.stack([c[1] for c in chunk]),
                                           frames))
            else:
                chunk_losses = []
                for x, poses, _ in chunk:
                    x, poses = self._put(x, poses, index=frames is not None)
                    chunk_losses.append(
                        self.eval_step(x, poses, frames=frames)[0])
            batch_time.update(time.time() - end)
            for j, (x, _, pad) in enumerate(chunk):
                losses.append(chunk_losses[j])
                # global valid rows: every rank pads its local tail alike
                # (checked after the loop)
                weights.append((x.shape[0] - pad) * self.process_count)
                pads.append(pad)
                if (base + j) % self.config.print_freq == 0:
                    print(
                        f"Val {self.experiment}: Epoch {epoch}\t"
                        f"Batch {base + j}/{n_val - 1}\t"
                        f"Batch time {batch_time.val:.4f} "
                        f"({batch_time.avg:.4f})\t"
                        f"Loss {float(chunk_losses[j]):f}"
                    )
            base += len(chunk)
            end = time.time()
        stacked = torch.stack(losses)
        if self.mesh is not None:
            # one collective per validation: the weighted average below is
            # right only if every rank padded every batch alike
            assert_same_across_processes(pads, "per-batch val pad counts",
                                         self.mesh)
            # each batch's global loss: the mean of the ranks' local ones
            stacked = self.mesh.all_reduce_(stacked.float()) \
                / self.process_count
        w = np.asarray(weights, np.float64)
        host = stacked.to("cpu", torch.float64).numpy()
        val_loss = float(np.dot(host, w) / w.sum())
        print(f"Val {self.experiment}: Epoch {epoch}, val_loss {val_loss:f}")
        self.metrics.write(kind="val", epoch=epoch, step=self.optimizer.count,
                           loss=val_loss)
        return val_loss

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profiler(self, prof) -> None:
        if self.device.type == "cuda":
            # the queued steps must run before the trace closes
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = Path(self.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        print(f"Profiler trace written to {out / 'trace.json'}")

    def train_epoch(self, epoch: int) -> None:
        cfg = self.config
        data_time = AverageMeter()
        batch_time = AverageMeter()
        # the warmup epoch (ingest_overlap) trains from the image loader
        # while the recorders stage frames; the cache is uploaded after it
        warmup = self._warmup_pending
        if warmup:
            loader, frames = self._warmup_loader, None
        else:
            loader = self.train_loader
            frames = self._train_frames if self.device_cache else None
        launch = self._train_launch if frames is not None else None
        K = self.steps_per_launch if launch is not None else 1
        n_batches = len(loader)
        prof = (self._profiler()
                if self.profile_dir and epoch == self.start_epoch else None)
        end = time.time()

        def emit(batch_idx, loss, step):
            # loss readback only at print points: a sync per batch would
            # stall the launch queue
            loss = float(loss)
            if self.debug_nans and not np.isfinite(loss):
                raise FloatingPointError(
                    f"non-finite loss {loss} at epoch {epoch}, batch "
                    f"{batch_idx}")
            cparams = {k: v.item() for k, v in
                       self.train_criterion.named_parameters()}
            lr = float(self.optimizer.schedule(step))
            print(
                f"Train {self.experiment}: Epoch {epoch}\t"
                f"Batch {batch_idx}/{n_batches - 1}\t"
                f"Data Time {data_time.val:.4f} ({data_time.avg:.4f})\t"
                f"Batch Time {batch_time.val:.4f} ({batch_time.avg:.4f})\t"
                f"Loss {loss:f}\t"
                f"lr: {lr:f}"
            )
            self.metrics.write(
                kind="train", step=step, epoch=epoch, batch=batch_idx,
                loss=loss, lr=lr, data_time=data_time.avg,
                batch_time=batch_time.avg, **cparams,
            )

        start, images, base = end, 0, 0
        for chunk in chunked(loader, K):
            data_time.update(time.time() - end)
            if prof is not None and base >= PROFILE_BATCHES:
                self._stop_profiler(prof)
                prof = None
            images += (self._frames_per_item * self.process_count
                       * sum(len(c[1]) for c in chunk))
            count = self.optimizer.count
            if launch is not None and len(chunk) == K:
                # K steps in one launch; timing meters are per launch here
                losses = launch(np.stack([c[0] for c in chunk]),
                                np.stack([c[1] for c in chunk]), frames)
                self.optimizer.count = count + K
            else:
                losses = []
                for x, poses, _ in chunk:
                    x, poses = self._put(x, poses, index=frames is not None)
                    losses.append(self.train_step(x, poses, seed=cfg.seed,
                                                  frames=frames))
            batch_time.update(time.time() - end)
            for j in range(len(chunk)):
                if (base + j) % cfg.print_freq == 0:
                    emit(base + j, losses[j], count + j + 1)
            base += len(chunk)
            end = time.time()
        if prof is not None:
            self._stop_profiler(prof)
        self._synchronize()
        secs = time.time() - start
        self.epoch_stats.append(dict(epoch=epoch, secs=secs,
                                     data_secs=data_time.sum,
                                     steps=n_batches, images=images))
        print(f"Train {self.experiment}: Epoch {epoch} done in {secs:.2f} s, "
              f"{images / max(secs, 1e-9):.1f} images/s, waiting on data "
              f"{data_time.sum:.2f} s")
        if warmup:
            self._finalize_device_cache()

    def train_val(self) -> None:
        """Run the full schedule (validation / snapshot / train epochs)."""
        cfg = self.config
        try:
            with torch.autograd.set_detect_anomaly(self.debug_nans):
                for epoch in range(self.start_epoch, cfg.n_epochs):
                    if self.val_loader is not None and (
                        epoch % cfg.val_freq == 0
                        or epoch == cfg.n_epochs - 1
                    ):
                        self.validate(epoch)
                    if epoch % cfg.snapshot == 0:
                        self._save(epoch)
                        print(f"Epoch {epoch} checkpoint saved for "
                              f"{self.experiment}")
                    self.train_epoch(epoch)
            self._save(cfg.n_epochs)
            print(f"Epoch {cfg.n_epochs} checkpoint saved")
        finally:
            if self.tee is not None:
                self.tee.uninstall()
                self.tee.close()
            self.metrics.close()
