"""Mean host time from entering the serving artifact's call to its
return, before the readback: the benchmark's span around
``Inference.__call__``."""

import numpy as np


def read(window):
    host = window.record.get("host_s")
    if not host:
        return None
    return 1e3 * float(np.mean(host))
