"""Share of the traced window in which a streaming session was inside its
recurrence (the program's ``serve.recurrence`` span: the window's copy into
the recurrence, its launch, a CUDA-graph replay for a full window, and the
poses' copy out) and the device ran no kernel, copy or set: what the
host's enqueueing of the recurrence leaves the card waiting."""

from benchmark.metrics._spans import covered_s, device_idle_s

SPAN = "serve.recurrence"


def read(window):
    if window.trace is None or covered_s(window.trace, SPAN) <= 0:
        return None
    return 100.0 * device_idle_s(window.trace, SPAN) / window.trace.window_s
