"""The yardstick of the streaming cell's metrics: the work of one request
of a VidLoc stream, from shapes alone (the trunk's convolutions as
:func:`benchmark.metrics._yardstick.resnet_sites` lists them)."""

from __future__ import annotations

from benchmark.metrics._yardstick import _macs, resnet_sites

__all__ = ["trunk_macs", "lstm_macs", "stream_request_macs"]


def trunk_macs(h: int, w: int, stage_sizes) -> int:
    """Multiply-adds of one frame's ResNet trunk (its convolutions)."""
    return sum(_macs(s) for s in resnet_sites(h, w, stage_sizes))


def lstm_macs(window: int, features: int, hidden: int,
              directions: int = 2) -> int:
    """Multiply-adds of the LSTM over a window: each direction's T steps,
    each the four gates' input and recurrent matmuls."""
    return directions * window * 4 * hidden * (features + hidden)


def stream_request_macs(cfg: dict) -> int:
    """Multiply-adds of one request: the trunk on the new frame, the LSTM
    over the whole window and ``fc_pose`` on each of its frames."""
    directions = 2 if cfg["bidirectional"] else 1
    T, F, H = cfg["window"], cfg["features"], cfg["hidden_size"]
    return (trunk_macs(*cfg["frame"], cfg["stage_sizes"])
            + lstm_macs(T, F, H, directions) + T * directions * H * 6)
