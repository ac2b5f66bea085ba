"""Share of the traced window that ``evaluate()`` spent in its pose graph
(the program's ``eval.pgo`` span: the VOs to unit quaternions, the upload,
ten batched Gauss-Newton iterations on the card, the one ``info``
readback and the fused poses back to the host)."""

from benchmark.metrics._spans import covered_s

SPAN = "eval.pgo"


def read(window):
    if window.trace is None:
        return None
    covered = covered_s(window.trace, SPAN)
    if covered <= 0:
        return None
    return 100.0 * covered / window.trace.window_s
