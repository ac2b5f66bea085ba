"""Share of the traced window in which ``evaluate()`` was in its pose graph
(the program's ``eval.pgo`` span) and the device ran no kernel, copy or
set: the part of the device's idle time that the host's dispatch of the
Gauss-Newton iterations holds."""

from benchmark.metrics._spans import covered_s, device_idle_s

SPAN = "eval.pgo"


def read(window):
    if window.trace is None or covered_s(window.trace, SPAN) <= 0:
        return None
    return 100.0 * device_idle_s(window.trace, SPAN) / window.trace.window_s
