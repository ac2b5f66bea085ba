"""Faults planted in the measured program underneath a run, to show that
the correctness check catches them (``benchmark/tests/test_bench_faults.py``
at the CPU rehearsal size; ``readings.py --fault`` at a cell's own size):

- ``altered_eval``: the eval epoch's pose table has a quarter of its rows
  moved, translations by 1.0 and log-quaternions by 0.3 (an answer altered
  where it is produced);
- ``zero_t_eval``: the eval epoch's pose table has every translation set
  to zero (a translation head that is left out);
- ``permuted_eval``: the eval epoch's pose table has its rows permuted (a
  wrong mapping of frames to rows in the dedup epoch);
- ``altered_serve``: the serving artifact's first frame has its rotation
  moved by 0.3;
- ``zero_t_serve``: the serving artifact's translations are all zero;
- ``unchanged``: the train step's update leaves every weight as it was;
- ``half_batch``: the train step leaves out the second half of its batch
  and takes the mean over the rest;
- ``no_exchange``: the ranks of a data-parallel step leave out the
  all-reduce of their gradients and loss (each updates on its own shard).

A driver that starts processes of its own plants ``active`` in them too.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

__all__ = ["FAULTS", "planted"]


def _patched_epoch(edit):
    from geomapnet_tpu_torch.cli import eval as cli_eval

    real = cli_eval.run_epoch

    def patched(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        edit(out.view(-1, out.shape[-1]))
        return out

    return mock.patch.object(cli_eval, "run_epoch", patched)


def _altered_eval():
    def alter(rows):
        rows[: rows.shape[0] // 4, :3] += 1.0
        rows[: rows.shape[0] // 4, 3:] += 0.3

    return _patched_epoch(alter)


def _zero_t_eval():
    return _patched_epoch(lambda rows: rows[:, :3].zero_())


def _permuted_eval():
    def permute(rows):
        gen = torch.Generator(device="cpu").manual_seed(0)
        perm = torch.randperm(rows.shape[0], generator=gen).to(rows.device)
        rows.copy_(rows[perm])

    return _patched_epoch(permute)


def _zero_t_serve():
    from geomapnet_tpu_torch import serving

    real = serving.Inference.__call__

    def zeroed(self, images):
        out = real(self, images).clone()
        out[..., :3] = 0.0
        return out

    return mock.patch.object(serving.Inference, "__call__", zeroed)


def _altered_serve():
    from geomapnet_tpu_torch import serving

    real = serving.Inference.__call__

    def altered(self, images):
        out = real(self, images).clone()
        out[..., 0, 3:] += 0.3
        return out

    return mock.patch.object(serving.Inference, "__call__", altered)


def _unchanged():
    from geomapnet_tpu_torch.train.optim import Optimizer

    def unchanged(self):
        self.count += 1
        self.step_t.add_(1)

    return mock.patch.object(Optimizer, "step", unchanged)


def _half_batch():
    from geomapnet_tpu_torch.train.state import TrainStep

    real = TrainStep._loss

    def half(self, images, targets, *args):
        n = images.shape[0] // 2
        return real(self, images[:n], targets[:n], *args)

    return mock.patch.object(TrainStep, "_loss", half)


def _no_exchange():
    from geomapnet_tpu_torch.parallel.mesh import GradientBucket

    return mock.patch.object(GradientBucket, "all_reduce_mean_",
                             lambda self, tensors, mesh: None)


FAULTS = {"altered_eval": _altered_eval, "zero_t_eval": _zero_t_eval,
          "permuted_eval": _permuted_eval, "altered_serve": _altered_serve,
          "zero_t_serve": _zero_t_serve,
          "unchanged": _unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange}
# the fault planted now in this process (None: none)
active: str | None = None


@contextlib.contextmanager
def planted(name: str | None):
    """A context in which fault ``name`` (None: none) is planted."""
    global active
    if name is None:
        yield
        return
    active = name
    try:
        with FAULTS[name]():
            yield
    finally:
        active = None
