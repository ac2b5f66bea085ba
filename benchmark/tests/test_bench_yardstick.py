"""The benchmark's frozen arithmetic against hand-computed values."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.core.trace import Trace, idle_share, union_intervals
from benchmark.metrics import _yardstick as y


def test_resnet34_macs_match_he_et_al():
    # He et al. 2016, Table 1: ResNet-34 at 224x224 is 3.6e9 multiply-adds
    # (the 1000-way classifier included)
    macs = sum(s["out"][0] * s["out"][1] * s["cout"] * s["k"] ** 2
               * s["cin"] for s in y.resnet_sites(224, 224)) + 512 * 1000
    assert macs == pytest.approx(3.6e9, rel=0.02)


def test_resnet34_sites():
    sites = y.resnet_sites(256, 341)
    assert len(sites) == 36
    stem = sites[0]
    assert stem["out"] == (128, 171)
    # the stem's multiply-adds by hand: 128 x 171 outputs x 64 x 7 x 7 x 3
    assert y._macs(stem) == 128 * 171 * 64 * 147
    last = sites[-1]
    assert last["last"] and last["out"] == (8, 11) and last["cout"] == 512
    assert [s["role"] for s in sites].count("down") == 3


def test_posenet_macs_adds_heads():
    trunk = sum(y._macs(s) for s in y.resnet_sites(256, 341))
    assert y.posenet_macs(256, 341) == trunk + 512 * 2048 + 2048 * 6


def test_int8_conv_bound_by_hand():
    site = y.resnet_sites(256, 341)[1]   # layer1_0.conv1: 64x86x64, 3x3
    assert site["hw"] == (64, 86) and site["out"] == (64, 86)
    n_out = 60 * 64 * 86 * 64
    ops_s = 2.0 * n_out * 576 / 1979e12
    bytes_s = (60 * 64 * 86 * 64 + 64 * 576 + 8 * 64 + n_out) / 3.35e12
    assert y.int8_conv_bound_s(site, 60, True) == pytest.approx(
        max(ops_s, bytes_s))
    # PERF.md's kernel table: a fused 60-frame window bounds at 0.474 ms
    window = sum(y.int8_conv_bound_s(s, 60, True)
                 for s in y.resnet_sites(256, 341))
    assert window * 1e3 == pytest.approx(0.474, abs=0.001)


def test_k4_bytes_by_hand():
    # 60 mosaics of 960x1280 read, 60 x 3 x 480 x 640 float32 written
    assert y.k4_launch_bytes(60, 960, 1280) == 60 * (1228800 + 3686400)
    assert y.k4_launch_bytes(60, 960, 1280) / 3.35e12 * 1e6 == \
        pytest.approx(88.0, abs=0.1)


def test_windows_per_epoch():
    assert y.windows_per_epoch(5000, 60) == 84
    assert y.windows_per_epoch(60, 60) == 1


def test_union_counts_overlap_once():
    s, e = union_intervals([0, 5, 2, 20], [10, 8, 12, 30])
    assert s.tolist() == [0, 20] and e.tolist() == [12, 30]
    # two streams covering the whole span at once: busy once, idle 0
    assert idle_share([0, 0], [100, 100], 0, 100) == 0.0
    assert idle_share([0, 50], [40, 70], 0, 100) == pytest.approx(0.4)


@pytest.mark.parametrize("seed", range(5))
def test_idle_share_never_negative(seed):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0, 100, 200)
    e = s + rng.uniform(0, 50, 200)
    assert 0.0 <= idle_share(s, e, 0, 100) <= 1.0


def test_breakdown_labels_gaps_by_host_span():
    t = Trace(dev_name=np.array(["k1", "k2", "k1"], dtype=object),
              dev_start=np.array([0.0, 10.0, 40.0]),
              dev_end=np.array([10.0, 20.0, 50.0]),
              host_name=np.array(["bench.call", "aten::copy_"],
                                 dtype=object),
              host_start=np.array([0.0, 20.0]),
              host_end=np.array([60.0, 30.0]),
              host_span=np.array([True, False]), start=0.0, end=60.0)
    assert t.busy_s() == pytest.approx(30e-6)
    assert t.idle() == pytest.approx(0.5)
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    labels = dict((k, v) for k, v in b["idle_gaps"])
    assert labels["bench.call > python"] == pytest.approx(10e-6)
    assert labels["bench.call > aten::copy_"] == pytest.approx(20e-6)
    assert t.kernels(["k1"]) == (pytest.approx(20e-6), 2)
