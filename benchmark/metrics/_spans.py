"""The arithmetic of the metrics that read the program's own spans
(``geomapnet_tpu_torch/utils/trace.py``: profiler ranges named
``gm.<name>``) from a traced window, on the trace's clock (us).

Spans of one name are merged where they overlap (a span inside another of
its name counts once), so covered time never exceeds the window. A span's
device idle time is the time it covers less the part of it in which the
device ran a kernel, a copy or a set (the union of the device intervals).
"""

from __future__ import annotations

import numpy as np

from benchmark.core.trace import union_intervals

__all__ = ["PREFIX", "events", "intervals", "covered_s", "overlap_s",
           "device_idle_s"]

PREFIX = "gm."


def _total(starts, ends) -> float:
    bs, be = union_intervals(starts, ends)
    return float(np.sum(be - bs))


def events(trace, name: str) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) of every ``gm.<name>`` range of the host's events,
    as they are (not merged)."""
    hit = trace.host_name == PREFIX + name
    return trace.host_start[hit], trace.host_end[hit]


def intervals(trace, name: str) -> tuple[np.ndarray, np.ndarray]:
    """The ``gm.<name>`` ranges merged into disjoint, sorted blocks."""
    return union_intervals(*events(trace, name))


def covered_s(trace, name: str) -> float:
    """Seconds in which the host was inside a ``gm.<name>`` range."""
    return _total(*intervals(trace, name)) / 1e6


def overlap_s(a: tuple, b: tuple) -> float:
    """Seconds common to two sets of intervals (each merged first):
    |A| + |B| - |A u B|."""
    both = (np.concatenate([a[0], b[0]]), np.concatenate([a[1], b[1]]))
    return (_total(*a) + _total(*b) - _total(*both)) / 1e6


def device_idle_s(trace, name: str) -> float:
    """Seconds in which the host was inside a ``gm.<name>`` range and the
    device ran nothing."""
    spans = intervals(trace, name)
    return covered_s(trace, name) - overlap_s(
        spans, (trace.dev_start, trace.dev_end))
