"""Share of the traced window in which ``evaluate()`` was building the
served net (the program's ``eval.serving_tree`` span) and the device ran
no kernel, copy or set: the part of the device's idle time that the
serving tree holds."""

from benchmark.metrics._spans import covered_s, device_idle_s

SPAN = "eval.serving_tree"


def read(window):
    if window.trace is None or covered_s(window.trace, SPAN) <= 0:
        return None
    return 100.0 * device_idle_s(window.trace, SPAN) / window.trace.window_s
