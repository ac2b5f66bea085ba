"""Share of the serving call's host time (the program's ``serve.call``
span) spent inside the hand-written kernels' operators (the profiler's
``geomapnet::int8_conv`` and ``geomapnet::int8_maxpool3x3s2`` op events:
shape lookup, checks and the launch), against the loaded graph's own
dispatch."""

import numpy as np

from benchmark.metrics._spans import covered_s, intervals, overlap_s

SPAN = "serve.call"
OPS = ("geomapnet::int8_conv", "geomapnet::int8_maxpool3x3s2")


def read(window):
    if window.trace is None:
        return None
    tr = window.trace
    covered = covered_s(tr, SPAN)
    if covered <= 0:
        return None
    hit = np.isin(tr.host_name, OPS)
    ops = (tr.host_start[hit], tr.host_end[hit])
    return 100.0 * overlap_s(intervals(tr, SPAN), ops) / covered
