"""K4 (``csrc/demosaic_half_normalize.cu``) against its roofline: the
bytes each launch of the trace must move for a step's frames (the mosaics
read once, half-size planar float32 written once) at the memory rate, over
the device time of K4's kernel."""

from benchmark.metrics._yardstick import H100, k4_launch_bytes

KERNELS = ("demosaic_half_normalize",)


def read(window):
    if window.trace is None:
        return None
    seconds, launches = window.trace.kernels(KERNELS)
    if not launches:
        return None
    raw_h, raw_w = window.config["raw_frame"]
    nbytes = launches * k4_launch_bytes(window.record["frames_per_step"],
                                        raw_h, raw_w)
    return 100.0 * nbytes / H100["hbm_bytes_per_s"] / seconds
