"""Training's share of the cards' float32 peak: three times the PoseNet
forward's operations (forward, and a backward of twice its work) for every
trained image, over the window's wall."""

from benchmark.metrics._yardstick import H100, posenet_macs


def read(window):
    images = window.record.get("images")
    if not images:
        return None
    cfg = window.config
    flops = 3 * 2.0 * posenet_macs(*cfg["frame"], cfg["stage_sizes"],
                                   cfg["feat_dim"]) * images
    return 100.0 * flops / window.record["wall_s"] / (
        H100["fp32_flops_per_s"] * window.chips)
