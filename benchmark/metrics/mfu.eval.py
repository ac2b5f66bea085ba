"""The sweep's share of the card's int8 peak: two operations a
multiply-add of the PoseNet forward (ResNet trunk, ``fc_feat``, heads) at
the frame size, over the unique frames each call's epoch needs (not its
pads), over the window's wall."""

from benchmark.metrics._yardstick import H100, posenet_macs


def read(window):
    calls = window.record.get("calls")
    if not calls:
        return None
    cfg = window.config
    ops = 2.0 * posenet_macs(*cfg["frame"], cfg["stage_sizes"],
                             cfg["feat_dim"])
    done = ops * window.record["unique_frames"] * len(calls)
    return 100.0 * done / window.record["wall_s"] / (
        H100["int8_ops_per_s"] * window.chips)
