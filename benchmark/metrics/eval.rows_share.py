"""Share of the traced window that ``evaluate()`` spent making the
prequantized space-to-depth int8 rows of the cached frames (the program's
``eval.quantize_rows`` span), which every call with a uint8 cache makes
anew."""

from benchmark.metrics._spans import covered_s

SPAN = "eval.quantize_rows"


def read(window):
    if window.trace is None:
        return None
    covered = covered_s(window.trace, SPAN)
    if covered <= 0:
        return None
    return 100.0 * covered / window.trace.window_s
