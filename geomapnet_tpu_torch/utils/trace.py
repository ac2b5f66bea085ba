"""Program spans: the host clock of a phase, and a profiler range around it
when a profiler records.

``with span("eval.epoch") as s: ...`` always measures the block's host
seconds (``s.seconds``, from ``time.perf_counter_ns``). Only while a
``torch.profiler`` is recording does it also open
``torch.profiler.record_function("gm.<name>")``, so the range lands in that
profiler's trace on the clock of its CPU and CUDA events, nested by time in
the span that encloses it on the calling thread. With no profiler the cost
is one flag read and two clock reads; keep spans coarse all the same (a
phase, a step, a request), never one per kernel launch.

There is no store and no exporter here: the profiler's Chrome trace (the
benchmark's traced run, or ``cli.train --profile_dir``) carries the spans.
"""

from __future__ import annotations

import time

from torch.autograd import profiler as _profiler

__all__ = ["span", "PREFIX"]

# the prefix of the program's ranges in a trace (the benchmark's own are
# ``bench.``)
PREFIX = "gm."
# the spans' clock, a module name so that a test can step it
_clock = time.perf_counter_ns


class span:
    """Context manager: ``seconds`` holds the block's host time once it
    exits (0.0 before)."""

    __slots__ = ("name", "seconds", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._range = None

    def __enter__(self) -> "span":
        # the module attribute, read at entry: torch sets it while any
        # profiler records
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = (_clock() - self._t0) / 1e9
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False
