"""The traced run: ``torch.profiler`` (CPU and CUDA) over the measured
window, read back from its Chrome trace.

The device's busy time is the UNION of its kernel, copy and set intervals:
intervals that overlap (two streams at once) count once, so busy time never
exceeds the traced span and the idle share never falls below 0.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass

import numpy as np

__all__ = ["Tracer", "Trace", "union_intervals", "idle_share"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SPAN_PREFIX = "bench."


def union_intervals(starts, ends) -> tuple[np.ndarray, np.ndarray]:
    """Merge intervals [start, end) into disjoint, sorted blocks."""
    s = np.asarray(starts, np.float64)
    e = np.asarray(ends, np.float64)
    if s.size == 0:
        return s, e
    order = np.argsort(s, kind="stable")
    s, e = s[order], np.maximum.accumulate(e[order])
    new = np.empty(s.size, bool)
    new[0] = True
    new[1:] = s[1:] > e[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, s.size - 1)
    return s[first], e[last]


def idle_share(starts, ends, span_start: float, span_end: float) -> float:
    """1 - (union of the intervals, clipped to the span) / span."""
    bs, be = union_intervals(np.clip(starts, span_start, span_end),
                             np.clip(ends, span_start, span_end))
    span = span_end - span_start
    return 1.0 - float(np.sum(be - bs)) / span if span > 0 else float("nan")


@dataclass
class Trace:
    """Device and host events of one traced window (times in us)."""

    dev_name: np.ndarray
    dev_start: np.ndarray
    dev_end: np.ndarray
    host_name: np.ndarray
    host_start: np.ndarray
    host_end: np.ndarray
    host_span: np.ndarray     # True for the benchmark's own spans
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_s(self) -> float:
        bs, be = union_intervals(self.dev_start, self.dev_end)
        return float(np.sum(be - bs)) / 1e6

    def idle(self) -> float:
        return idle_share(self.dev_start, self.dev_end, self.start, self.end)

    def kernels(self, names) -> tuple[float, int]:
        """(seconds, launches) of the device kernels whose name contains
        one of ``names``."""
        hit = np.zeros(self.dev_name.size, bool)
        for n in names:
            hit |= np.char.find(self.dev_name.astype(str), n) >= 0
        return (float(np.sum(self.dev_end[hit] - self.dev_start[hit])) / 1e6,
                int(hit.sum()))

    def share_of_busy(self, names) -> float | None:
        """The share of the union of device time spent in kernels whose
        name contains one of ``names`` (their own union)."""
        busy = self.busy_s()
        if busy <= 0:
            return None
        hit = np.zeros(self.dev_name.size, bool)
        for n in names:
            hit |= np.char.find(self.dev_name.astype(str), n) >= 0
        if not hit.any():
            return None
        bs, be = union_intervals(self.dev_start[hit], self.dev_end[hit])
        return float(np.sum(be - bs)) / 1e6 / busy

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps of
        the device summed by what the host was doing meanwhile: the
        benchmark's span around it and the innermost host operation."""
        ops: dict = {}
        for n, d in zip(self.dev_name, self.dev_end - self.dev_start):
            ops[n] = ops.get(n, 0.0) + float(d) / 1e6
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        bs, be = union_intervals(self.dev_start, self.dev_end)
        gs = np.concatenate([[self.start], be])
        ge = np.concatenate([bs, [self.end]])
        keep = ge > gs
        gs, ge = gs[keep], ge[keep]
        longest = np.argsort(gs - ge)[:200]
        gaps: dict = {}
        for i in longest:
            label = self._host_label(gs[i])
            gaps[label] = gaps.get(label, 0.0) + float(ge[i] - gs[i]) / 1e6
        idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in device_ops],
                "idle_gaps": [[k, v] for k, v in idle_gaps]}

    def _host_label(self, t: float) -> str:
        cover = (self.host_start <= t) & (self.host_end > t)
        spans = cover & self.host_span
        outer = "no span"
        if spans.any():
            j = np.flatnonzero(spans)
            outer = str(self.host_name[j[np.argmax(
                self.host_end[j] - self.host_start[j])]])
        ops = cover & ~self.host_span
        inner = "python"
        if ops.any():
            j = np.flatnonzero(ops)
            inner = str(self.host_name[j[np.argmin(
                self.host_end[j] - self.host_start[j])]])
        return f"{outer} > {inner}"


def _read_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host = [], []
    main_tid = None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((e["name"], float(e["ts"]), float(e["dur"])))
        elif cat in HOST_CATS:
            name = e["name"]
            if main_tid is None and cat == "user_annotation" and \
                    name.startswith(SPAN_PREFIX):
                main_tid = e.get("tid")
            host.append((name, float(e["ts"]), float(e["dur"]),
                         e.get("tid"), cat == "user_annotation"
                         and name.startswith(SPAN_PREFIX)))
    if main_tid is not None:
        host = [h for h in host if h[3] == main_tid]
    times = [(t, t + d) for _, t, d in dev] + [(t, t + d)
                                               for _, t, d, _, _ in host]
    start = min(t for t, _ in times) if times else 0.0
    end = max(t for _, t in times) if times else 0.0
    return Trace(
        dev_name=np.array([n for n, _, _ in dev], dtype=object),
        dev_start=np.array([t for _, t, _ in dev], np.float64),
        dev_end=np.array([t + d for _, t, d in dev], np.float64),
        host_name=np.array([h[0] for h in host], dtype=object),
        host_start=np.array([h[1] for h in host], np.float64),
        host_end=np.array([h[1] + h[2] for h in host], np.float64),
        host_span=np.array([h[4] for h in host], bool),
        start=start, end=end)


class Tracer:
    """``with tracer:`` profiles the window when ``enabled``;
    ``tracer.span(name)`` marks a benchmark span (a profiler annotation
    named ``bench.<name>``; nothing when disabled). After the block,
    :meth:`read` returns the :class:`Trace` (the Chrome trace is written to
    the temporary directory and deleted once read)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self.trace: Trace | None = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(SPAN_PREFIX + name)

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            import torch
            torch.cuda.synchronize()
            self._prof.__exit__(*exc)
        return False

    def read(self) -> Trace | None:
        if self._prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self.trace = _read_chrome_trace(path)
        finally:
            os.unlink(path)
        self._prof = None
        return self.trace
