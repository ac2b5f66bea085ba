"""Logging utilities: stdout tee, running meters, structured JSONL metrics.

Copies of :mod:`geomapnet_tpu.utils.logger` (upstream common/Logger.py plus
a structured metrics stream in place of upstream's visdom plots);
tests/test_torch_import_isolation.py pins them to the originals. The
TensorBoard writer (``MetricsWriter(tensorboard=True)``) imports
``torch.utils.tensorboard`` only when asked for, and fails at once, naming
the ``tensorboard`` package, where that is not installed
(:func:`require_tensorboard`).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

__all__ = ["Tee", "AverageMeter", "MetricsWriter", "require_tensorboard"]


class Tee:
    """Mirror stdout to a logfile (unbuffered-ish)."""

    def __init__(self, filename: str | Path):
        self.terminal = sys.stdout
        self.log = open(filename, "w", buffering=1)

    def write(self, message: str) -> None:
        self.terminal.write(message)
        self.log.write(message)

    def flush(self) -> None:
        self.terminal.flush()
        self.log.flush()

    def close(self) -> None:
        self.log.close()

    def install(self) -> "Tee":
        sys.stdout = self
        return self

    def uninstall(self) -> None:
        sys.stdout = self.terminal


class AverageMeter:
    """Running mean/current value (upstream Logger.py:27-44)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def require_tensorboard():
    """``torch.utils.tensorboard.SummaryWriter``; raises an ``ImportError``
    that names the missing ``tensorboard`` package."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise ImportError(
            "TensorBoard logging (--tensorboard, or visdom = yes in the "
            "config) needs the tensorboard package, which this Python "
            "lacks: install tensorboard, or drop the option (metrics.jsonl "
            f"is written either way). ({e})") from e
    return SummaryWriter


class MetricsWriter:
    """Append-only JSONL metrics stream with wall-clock stamps.

    :param enabled: no-op writer when False (ranks other than 0 of a
        data-parallel run)
    :param tensorboard: also emit TensorBoard event files next to the JSONL
        (scalars only; numeric fields are tagged ``<kind>/<field>`` and keyed
        by ``step`` when present, else by write count)
    """

    def __init__(self, path: str | Path, enabled: bool = True,
                 tensorboard: bool = False):
        self.enabled = enabled
        self.path = Path(path)
        self._f = None
        self._tb = None
        self._n = 0
        self._t0 = time.time()
        if not enabled:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", buffering=1)
        if tensorboard:
            self._tb = require_tensorboard()(
                log_dir=str(self.path.parent / "tb"))

    def write(self, **fields) -> None:
        if not self.enabled:
            return
        fields.setdefault("t", round(time.time() - self._t0, 3))
        self._f.write(json.dumps(fields) + "\n")
        self._n += 1
        if self._tb is not None:
            kind = fields.get("kind", "metrics")
            step = int(fields.get("step", self._n))
            for k, v in fields.items():
                if k in ("kind", "step", "t"):
                    continue
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(f"{kind}/{k}", v, step)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()
