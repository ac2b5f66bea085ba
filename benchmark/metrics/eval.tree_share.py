"""Share of the traced window that ``evaluate()`` spent turning each
checkpoint into the served net (the program's ``eval.serving_tree`` span:
the weights to the host, the int8 tree, calibration and the net's build
and upload)."""

from benchmark.metrics._spans import covered_s

SPAN = "eval.serving_tree"


def read(window):
    if window.trace is None:
        return None
    covered = covered_s(window.trace, SPAN)
    if covered <= 0:
        return None
    return 100.0 * covered / window.trace.window_s
