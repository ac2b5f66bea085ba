"""K1 (``csrc/int8_conv.cu``) against its roofline: the least time of the
int8 convs that the window's ``evaluate()`` calls need (each call's
calibration batches unfused, its epoch's windows fused; counted from the
shapes), over the device time of K1's kernels in the trace."""

from benchmark.metrics._yardstick import k1_call_bound_s, windows_per_epoch

KERNELS = ("int8_conv_kernel", "int8_conv_body", "int8_conv_s2d")


def read(window):
    if window.trace is None or not window.record.get("calls"):
        return None
    seconds, launches = window.trace.kernels(KERNELS)
    if not launches:
        return None
    cfg, rec = window.config, window.record
    wf = cfg["experiment"]["batch_size"] * rec["steps"]
    bound = k1_call_bound_s(
        *cfg["frame"], cfg["stage_sizes"], wf,
        windows_per_epoch(rec["unique_frames"], wf),
        window.params["eval"]["calib_batches"]) * len(rec["calls"])
    return 100.0 * bound / seconds
