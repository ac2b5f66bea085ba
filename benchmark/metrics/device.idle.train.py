"""The device's idle share over the traced window: 1 - the union of its
kernel, copy and set intervals over the traced span."""


def read(window):
    if window.trace is None or window.trace.dev_start.size == 0:
        return None
    return 100.0 * window.trace.idle()
