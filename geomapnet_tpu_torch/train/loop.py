"""The training loop: epochs, validation, snapshots, metrics.

The PyTorch counterpart of :class:`geomapnet_tpu.train.loop.Trainer`
(upstream ``Trainer.train_val``, common/train.py:206-320) on the loader
path: the same epoch structure (validate on every ``val_freq``-th epoch and
on the last one, snapshot on every ``snapshot``-th epoch and at the end),
the same per-batch data/batch-time meters, ``print_freq`` console lines and
``metrics.jsonl`` records (keys ``loss``, ``lr``, ``data_time``,
``batch_time`` and the criterion weights), on one device:

- batches stream through :class:`geomapnet_tpu_torch.data.loader.Loader`
  (a copy of the JAX package's, with the same seeded shuffle, so both
  packages draw the same batches from the same seed) with background
  prefetch;
- the train step (:mod:`geomapnet_tpu_torch.train.state`) returns its loss
  on the device: the host reads it back only at ``print_freq`` points, and
  validation losses stay on the device until one readback at the end.

The device cache, launch fusion, ingest overlap, meshes and multi-host runs
of the JAX Trainer are not ported yet (ROADMAP.md, Queue 1 items 12c and
17).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..data.loader import Loader
from ..utils.logger import AverageMeter, MetricsWriter, Tee
from .checkpoint import load_model_params, restore_checkpoint, \
    save_checkpoint
from .optim import make_optimizer
from .state import make_eval_step, make_train_step

__all__ = ["Trainer"]

PROFILE_BATCHES = 10


class Trainer:
    """Drives training of a PoseNet/MapNet-family model on ``device``.

    :param model: :class:`~geomapnet_tpu_torch.models.posenet.PoseNet` or
        :class:`~geomapnet_tpu_torch.models.posenet.MapNet`
    :param train_criterion / val_criterion: criteria of
        :mod:`geomapnet_tpu_torch.losses.criterion`
    :param config: :class:`geomapnet_tpu_torch.cli.config.ExperimentConfig`
    :param experiment: experiment name (logdir ``<logdir_root>/<experiment>``)
    :param train_dataset / val_dataset: indexable (imgs, poses) datasets
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
    ):
        self.device = torch.device(device)
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
        self.tee = Tee(self.logdir / "log.txt").install()
        self.metrics = MetricsWriter(self.logdir / "metrics.jsonl")

        print("---------------------------------------")
        print(f"Experiment: {experiment}")
        for k, v in vars(config).items():
            print(f"{k}: {v}")
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        print(f"Device: {self.device} ({name})")
        print("---------------------------------------")

        self.train_loader = Loader(
            train_dataset, config.batch_size, shuffle=config.shuffle,
            drop_last=True, seed=config.seed, num_workers=config.num_workers)
        self.val_loader = (
            Loader(val_dataset, config.batch_size, shuffle=False,
                   drop_last=False, seed=config.seed,
                   num_workers=config.num_workers)
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

        # per trained epoch: host seconds (to a device sync), seconds spent
        # waiting on the loader, steps and images
        self.epoch_stats: list[dict] = []
        self.train_step = make_train_step(
            self.model, self.train_criterion, self.optimizer,
            preprocess=preprocess, accum_steps=accum_steps)
        self.eval_step = make_eval_step(self.model, self.val_criterion,
                                        preprocess=preprocess)

    def _put(self, imgs: np.ndarray, poses: np.ndarray):
        return (torch.from_numpy(imgs).to(self.device),
                torch.from_numpy(poses).to(self.device))

    def _save(self, epoch: int) -> None:
        save_checkpoint(self.logdir, epoch, self.model, self.train_criterion,
                        self.optimizer)

    def validate(self, epoch: int) -> float:
        """The validation loss, weighted by each batch's real (unpadded)
        rows; the per-batch losses stay on the device until one readback."""
        losses, weights = [], []
        batch_time = AverageMeter()
        end = time.time()
        n_val = len(self.val_loader)
        for batch_idx, (imgs, poses, pad) in enumerate(self.val_loader):
            imgs, poses = self._put(imgs, poses)
            loss, _ = self.eval_step(imgs, poses)
            losses.append(loss)
            weights.append(imgs.shape[0] - pad)
            batch_time.update(time.time() - end)
            end = time.time()
            if batch_idx % self.config.print_freq == 0:
                print(
                    f"Val {self.experiment}: Epoch {epoch}\t"
                    f"Batch {batch_idx}/{n_val - 1}\t"
                    f"Batch time {batch_time.val:.4f} "
                    f"({batch_time.avg:.4f})\t"
                    f"Loss {float(loss):f}"
                )
        w = np.asarray(weights, np.float64)
        host = torch.stack(losses).to("cpu", torch.float64).numpy()
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
        n_batches = len(self.train_loader)
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

        start, images = end, 0
        for batch_idx, (imgs, poses, _) in enumerate(self.train_loader):
            data_time.update(time.time() - end)
            if prof is not None and batch_idx == PROFILE_BATCHES:
                self._stop_profiler(prof)
                prof = None
            images += int(np.prod(poses.shape[:-1]))
            imgs, poses = self._put(imgs, poses)
            loss = self.train_step(imgs, poses, seed=cfg.seed)
            batch_time.update(time.time() - end)
            if batch_idx % cfg.print_freq == 0:
                emit(batch_idx, loss, self.optimizer.count)
            end = time.time()
        if prof is not None:
            self._stop_profiler(prof)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        secs = time.time() - start
        self.epoch_stats.append(dict(epoch=epoch, secs=secs,
                                     data_secs=data_time.sum,
                                     steps=n_batches, images=images))
        print(f"Train {self.experiment}: Epoch {epoch} done in {secs:.2f} s, "
              f"{images / max(secs, 1e-9):.1f} images/s, waiting on data "
              f"{data_time.sum:.2f} s")

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
            self.tee.uninstall()
            self.tee.close()
            self.metrics.close()
