"""The stream's share of the card's float32 peak: two operations a
multiply-add of each request's work (the ResNet-34 trunk on one frame, the
bidirectional LSTM over the whole window, ``fc_pose`` on its frames;
counted from the shapes), over the window's wall."""

from benchmark.metrics._stream import stream_request_macs
from benchmark.metrics._yardstick import H100


def read(window):
    rec = window.record
    if not rec.get("attempted") or not rec.get("wall_s"):
        return None
    done = 2.0 * stream_request_macs(window.config) * rec["attempted"]
    return 100.0 * done / rec["wall_s"] / (
        H100["fp32_flops_per_s"] * window.chips)
