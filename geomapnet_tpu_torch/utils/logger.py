"""Logging utilities: stdout tee, running meters, structured JSONL metrics.

Copies of :mod:`geomapnet_tpu.utils.logger` (upstream common/Logger.py plus
a structured metrics stream in place of upstream's visdom plots);
tests/test_torch_import_isolation.py pins them to the originals. The JAX
package's TensorBoard writer is left out: the card's machine has no
tensorboard package, and ``--tensorboard`` is refused.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

__all__ = ["Tee", "AverageMeter", "MetricsWriter"]


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


class MetricsWriter:
    """Append-only JSONL metrics stream with wall-clock stamps.

    :param enabled: no-op writer when False
    """

    def __init__(self, path: str | Path, enabled: bool = True):
        self.enabled = enabled
        self.path = Path(path)
        self._f = None
        self._n = 0
        self._t0 = time.time()
        if not enabled:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", buffering=1)

    def write(self, **fields) -> None:
        if not self.enabled:
            return
        fields.setdefault("t", round(time.time() - self._t0, 3))
        self._f.write(json.dumps(fields) + "\n")
        self._n += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
