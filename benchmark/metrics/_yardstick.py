"""The yardstick of the per-layer metrics: the card's published peaks, and
the work that the inputs need, worked out from shapes alone.

Nothing here asks the program what it did, so the counts stay the same
whatever implementation a later change puts in: a ResNet's convolutions
are counted as the architecture defines them (the stem as a 7x7 stride-2
conv of the 3-channel image, whatever layout a kernel reads it in).
"""

from __future__ import annotations

import math

__all__ = ["H100", "conv_out", "resnet_sites", "posenet_macs",
           "int8_conv_bound_s", "k1_call_bound_s", "k4_launch_bytes"]

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit
H100 = {"int8_ops_per_s": 1979e12, "bf16_flops_per_s": 989e12,
        "tf32_flops_per_s": 495e12, "fp32_flops_per_s": 67e12,
        "hbm_bytes_per_s": 3.35e12}


def conv_out(n: int, k: int, stride: int, pad: int) -> int:
    """Output length of a convolution along one axis (symmetric pad)."""
    return (n + 2 * pad - k) // stride + 1


def resnet_sites(h: int, w: int, stage_sizes=(3, 4, 6, 3)) -> list:
    """Every convolution of a basic-block ResNet trunk on an (h, w, 3)
    image, in order: dicts with ``name``, ``role`` (stem, conv1, conv2,
    down), ``hw`` and ``cin`` of the input, ``cout``, ``k``, ``stride``,
    ``pad``, ``out`` (its output's height and width), and for a conv2
    whether its shortcut is a projection (``projected``) and whether it is
    the trunk's last conv (``last``)."""
    sites = []

    def add(name, role, hw, cin, cout, k, stride, **kw):
        pad = k // 2
        out = (conv_out(hw[0], k, stride, pad), conv_out(hw[1], k, stride,
                                                          pad))
        sites.append(dict(name=name, role=role, hw=hw, cin=cin, cout=cout,
                          k=k, stride=stride, pad=pad, out=out, **kw))
        return out

    hw = add("conv1", "stem", (h, w), 3, 64, 7, 2)
    hw = (conv_out(hw[0], 3, 2, 1), conv_out(hw[1], 3, 2, 1))   # max-pool
    cin = 64
    n_blocks = sum(stage_sizes)
    b_all = 0
    for s, n in enumerate(stage_sizes):
        f = 64 * 2 ** s
        for b in range(n):
            stride = 2 if (s > 0 and b == 0) else 1
            proj = stride != 1 or cin != f
            name = f"layer{s + 1}_{b}"
            out = add(f"{name}.conv1", "conv1", hw, cin, f, 3, stride)
            if proj:
                add(f"{name}.downsample", "down", hw, cin, f, 1, stride)
            b_all += 1
            add(f"{name}.conv2", "conv2", out, f, f, 3, 1, projected=proj,
                last=b_all == n_blocks)
            hw, cin = out, f
    return sites


def _macs(site: dict, frames: int = 1) -> int:
    oh, ow = site["out"]
    return frames * oh * ow * site["cout"] * site["k"] ** 2 * site["cin"]


def posenet_macs(h: int, w: int, stage_sizes=(3, 4, 6, 3),
                 feat_dim: int = 2048) -> int:
    """Multiply-adds of one frame's PoseNet forward: the trunk's convs,
    ``fc_feat`` and the two 3-wide heads."""
    width = 64 * 2 ** (len(stage_sizes) - 1)
    return (sum(_macs(s) for s in resnet_sites(h, w, stage_sizes))
            + width * feat_dim + feat_dim * 6)


def int8_conv_bound_s(site: dict, frames: int, fused: bool) -> float:
    """The least time of one int8 conv launch over ``frames`` frames: its
    operations at the int8 peak, or the bytes it must move at the memory
    rate (int8 input, int8 kernel, the float32 dequant multiplier and bias
    read once, the output written once, a residual read once), whichever is
    longer. ``fused``: the int8 dataflow's epilogues (an int8 output, a
    float32 one for a projection and the trunk's last conv, the residual
    read in the epilogue); otherwise a bfloat16 dequantized output."""
    oh, ow = site["out"]
    n_out = frames * oh * ow * site["cout"]
    kk = site["k"] ** 2 * site["cin"]
    nbytes = (frames * site["hw"][0] * site["hw"][1] * site["cin"]
              + site["cout"] * kk + 8 * site["cout"])
    if not fused:
        nbytes += 2 * n_out
    elif site["role"] == "down":
        nbytes += 4 * n_out
    elif site["role"] == "conv2":
        res = 4 if site["projected"] else 1
        nbytes += res * n_out + (4 if site["last"] else 1) * n_out
    else:
        nbytes += n_out
    return max(2.0 * n_out * kk / H100["int8_ops_per_s"],
               nbytes / H100["hbm_bytes_per_s"])


def k1_call_bound_s(h: int, w: int, stage_sizes, frames_per_window: int,
                    windows: int, calib_batches: int) -> float:
    """The least time of the int8 convs of one serving ``evaluate()``
    call: ``calib_batches`` unfused batches (calibration) and ``windows``
    fused windows, each of ``frames_per_window`` frames."""
    sites = resnet_sites(h, w, stage_sizes)
    fused = sum(int8_conv_bound_s(s, frames_per_window, True) for s in sites)
    plain = sum(int8_conv_bound_s(s, frames_per_window, False)
                for s in sites)
    return windows * fused + calib_batches * plain


def k4_launch_bytes(frames: int, raw_h: int, raw_w: int) -> int:
    """Bytes one demosaic launch must move: the uint8 mosaics read once and
    the half-size planar float32 RGB written once."""
    return frames * (raw_h * raw_w + 3 * (raw_h // 2) * (raw_w // 2) * 4)


def windows_per_epoch(unique_frames: int, window_frames: int) -> int:
    """Windows of a slice epoch over ``unique_frames``."""
    return math.ceil(unique_frames / window_frames)
