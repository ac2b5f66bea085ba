"""K1, the int8 conv kernel: its tile plan, models of its addressing, and
(on a card) its routes against the plain version.

The CUDA kernels cannot run here, so what surrounds them is held on the
CPU:

- the tile plan (:func:`cuda_quant.conv_plan`) at every geometry of a
  60-frame ResNet-34 window (``chip_smoke.window_convs``) and the extra
  ones (``chip_smoke.EXTRA_CONVS``): the route by channel count, a valid
  ``wgmma`` width, shared memory that fits, a grid that covers the output;
- models of the integer addressing that ``csrc/int8_conv.cu`` uses, written
  out as the kernel writes it (running tap/channel counters, zero-filled
  copies, the 128-byte swizzle; the space-to-depth stem's row strip),
  against ``F.unfold``;
- the packed weight and the prepared launches on CPU tensors.

This file imports no JAX, so the ``cuda``-marked tests at the end run on a
machine that has a card and no JAX:
``python -m pytest --noconftest tests/test_torch_k1.py -m cuda``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from geomapnet_tpu_torch.ops import cuda_quant as CQ

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

WINDOW = {c[0]: c for c in chip_smoke.window_convs() + chip_smoke.EXTRA_CONVS}
WGMMA_N = {8, 16, 24} | set(range(32, 257, 16))   # m64nNk32 with s8


# ------------------------------------------------------------- the tile plan


@pytest.mark.parametrize("name", list(WINDOW))
def test_tile_plan_covers_window_geometry(name):
    _, shape, o, ksize, stride, pad, _, _ = WINDOW[name]
    n, h, w, c = shape
    oh, ow = CQ.conv_out_hw(h, w, ksize, stride, pad)
    m = n * oh * ow
    plan = CQ.conv_plan(shape, o, ksize, stride, pad)
    assert plan.route == CQ.conv_route(c)
    assert plan.route == ("body" if c % 16 == 0 else
                          "s2d" if c == 12 else "simple")
    assert plan.smem <= CQ.SMEM_PER_BLOCK
    if plan.route == "body":
        assert plan.bn in WGMMA_N and plan.bn in CQ.BODY_BN
        assert plan.bn == 64 if o == 64 else plan.bn in (128, 256)
        # two warpgroups of 64 rows each
        assert plan.bm == CQ.BODY_BM == 128 and plan.threads == 2 * 128
        assert plan.tile == plan.bn and plan.smem == CQ.body_smem(plan.bn)
        # a ring of 3 stages or more that also holds the staged tile, and
        # room on an SM for the blocks its launch bounds promise
        stages = CQ.BODY_STAGES[plan.bn]
        assert stages >= 3
        assert plan.smem >= max(stages * (128 + plan.bn) * CQ.BODY_BK,
                                128 * (plan.bn + 4) * 4)
        assert CQ.BODY_BLOCKS_PER_SM[plan.bn] * (plan.smem + 1024) <= \
            CQ.SMEM_PER_SM
    elif plan.route == "s2d":
        assert plan.grid == (n * -(-oh // CQ.S2D_ROWS), 1)
        assert plan.bm == ow == w
        assert plan.bn == o == 64 and plan.smem == CQ.s2d_smem(ow)
    else:
        assert plan.smem == 0 and plan.tile in (16, 4, 1)
    # the grid covers M x O, and no block lies wholly outside it
    assert plan.grid[0] * plan.bm >= m > (plan.grid[0] - 1) * plan.bm or (
        plan.route == "s2d")
    assert plan.grid[1] * plan.bn >= o > (plan.grid[1] - 1) * plan.bn


def test_tile_plan_waves_and_routes():
    """Layer 4's M = 5,280 takes one wave of 256-wide tiles on 132 SMs; a
    route named by hand is checked; a 12-channel conv that is not the stem
    has no route."""
    layer4 = WINDOW["layer4_conv1"]
    plan = CQ.conv_plan(*layer4[1:6])
    assert plan.bn == 256 and plan.grid[0] * plan.grid[1] <= CQ.SM_COUNT
    assert CQ.conv_plan(*layer4[1:6], route="simple").route == "simple"
    for bad in (((2, 8, 8, 12), 64, (3, 3), (1, 1), ((1, 1), (1, 1))),
                ((2, 8, 8, 12), 32, (4, 4), (1, 1), ((2, 1), (2, 1)))):
        with pytest.raises(ValueError, match="s2d route"):
            CQ.conv_plan(*bad)
    with pytest.raises(ValueError, match="multiples of 16"):
        CQ.conv_plan((2, 8, 8, 64), 24, (3, 3), (1, 1), ((1, 1), (1, 1)))
    with pytest.raises(ValueError, match="route must be"):
        CQ.conv_plan((2, 8, 8, 64), 64, (3, 3), (1, 1), ((1, 1), (1, 1)),
                     route="fast")
    assert CQ.conv_route(3) == "simple"


# ------------------------------------------- models of the kernel's addressing


def _unfold_rows(x: np.ndarray, ksize, stride, pad) -> np.ndarray:
    """(M, KH*KW*C) im2col of an NHWC int8 array, depth in (kh, kw, c)
    order, from ``F.unfold`` on the zero-padded input."""
    n, h, w, c = x.shape
    (pt, pb), (pl, pr) = pad
    xt = F.pad(torch.from_numpy(x).permute(0, 3, 1, 2).double(),
               (pl, pr, pt, pb))
    cols = F.unfold(xt, ksize, stride=stride)          # (N, C*KH*KW, L)
    cols = cols.reshape(n, c, ksize[0], ksize[1], -1).permute(0, 4, 2, 3, 1)
    return cols.reshape(-1, ksize[0] * ksize[1] * c).numpy().astype(np.int8)


def _body_a_model(x: np.ndarray, ksize, stride, pad, kpad: int) -> np.ndarray:
    """The A operand that ``int8_conv_body`` gives the tensor cores, as its
    copies and descriptors build it: each of 256 threads moves chunk ``ch``
    of rows ``rsub + 32*i`` into the swizzled stage (source size 0 where a
    tap is padding, the depth is past K or the row past M), its tap and
    channel advanced by running counters; ``wgmma`` then reads row r, chunk
    q at ``r*128 + ((q ^ (r & 7)) << 4)``. Returns (blocks*128,
    steps*128)."""
    n, h, w, c = x.shape
    kh_, kw_ = ksize
    sh, sw = stride
    pt, pl = pad[0][0], pad[1][0]
    oh, ow = CQ.conv_out_hw(h, w, ksize, stride, pad)
    m, k = n * oh * ow, kh_ * kw_ * c
    bm, bk = CQ.BODY_BM, CQ.BODY_BK
    nsteps = -(-kpad // bk)
    blocks = -(-m // bm)
    flat = x.reshape(-1)
    out = np.full((blocks * bm, nsteps * bk), 99, np.int8)   # 99: unwritten
    for blk in range(blocks):
        row0 = blk * bm
        stages = np.full((nsteps, bm * bk), 99, np.int8)
        for tid in range(CQ.BODY_THREADS):
            ch, rsub = tid & 7, tid >> 3
            base, ih0, iw0 = [], [], []
            for i in range(4):
                grow = row0 + rsub + 32 * i
                if grow < m:
                    nn, rem = divmod(grow, oh * ow)
                    o_h, o_w = divmod(rem, ow)
                    ih0.append(o_h * sh - pt)
                    iw0.append(o_w * sw - pl)
                    base.append(((nn * h + ih0[-1]) * w + iw0[-1]) * c)
                else:
                    ih0.append(-(1 << 30))
                    iw0.append(0)
                    base.append(0)
            kabs = ch * 16
            cc = kabs % c
            kh = (kabs // c) // kw_
            kw = (kabs // c) - kh * kw_
            for step in range(nsteps):
                tap = (kh * w + kw) * c + cc
                for i in range(4):
                    r = rsub + 32 * i
                    ih, iw = ih0[i] + kh, iw0[i] + kw
                    ok = kabs < k and 0 <= ih < h and 0 <= iw < w
                    dst = r * bk + ((ch ^ (r & 7)) << 4)
                    stages[step, dst:dst + 16] = (
                        flat[base[i] + tap:base[i] + tap + 16] if ok else 0)
                kabs += bk
                cc += bk
                while cc >= c:
                    cc -= c
                    kw += 1
                    if kw == kw_:
                        kw = 0
                        kh += 1
        for step in range(nsteps):
            for r in range(bm):
                for q in range(8):
                    src = r * bk + ((q ^ (r & 7)) << 4)
                    out[row0 + r, step * bk + q * 16:step * bk + q * 16 + 16] \
                        = stages[step, src:src + 16]
    return out


BODY_KINDS = {
    "3x3_s1": ((2, 6, 9, 64), (3, 3), (1, 1), ((1, 1), (1, 1))),
    "3x3_s2_odd": ((1, 9, 13, 32), (3, 3), (2, 2), ((1, 1), (1, 1))),
    "1x1_s2": ((2, 8, 11, 64), (1, 1), (2, 2), ((0, 0), (0, 0))),
    "1x1_s1_ragged": ((1, 7, 19, 64), (1, 1), (1, 1), ((0, 0), (0, 0))),
    "c16_wraps": ((1, 5, 7, 16), (3, 3), (1, 1), ((1, 1), (1, 1))),
    "c512_deep": ((1, 3, 4, 512), (3, 3), (1, 1), ((1, 1), (1, 1))),
}


@pytest.mark.parametrize("kind", list(BODY_KINDS))
def test_body_im2col_model_matches_unfold(kind):
    """The body route's A tiles are the im2col matrix: real taps where F.unfold
    has them, zeros for padding, for depth past K (the last half step when
    K_ALIGN leaves Kpad % 128 == 64) and for rows past M."""
    shape, ksize, stride, pad = BODY_KINDS[kind]
    x = np.random.RandomState(0).randint(-127, 128, shape).astype(np.int8)
    k = ksize[0] * ksize[1] * shape[3]
    kpad = -(-k // CQ.K_ALIGN) * CQ.K_ALIGN
    a = _body_a_model(x, ksize, stride, pad, kpad)
    want = _unfold_rows(x, ksize, stride, pad)
    m = want.shape[0]
    np.testing.assert_array_equal(a[:m, :k], want)
    assert not a[:m, k:].any() and not a[m:].any()


def _body_b_model(wp: np.ndarray, col0: int, bn: int, step: int
                  ) -> np.ndarray:
    """One stage's B tile (bn rows x 128) as the copies fill it: weight row
    col0 + r, depth step*128 + 16*ch, zero past O and past Kpad."""
    o, kpad = wp.shape
    tile = np.zeros((bn, CQ.BODY_BK), np.int8)
    for r in range(bn):
        for ch in range(8):
            kabs = step * CQ.BODY_BK + ch * 16
            if col0 + r < o and kabs < kpad:
                tile[r, ch * 16:ch * 16 + 16] = wp[col0 + r, kabs:kabs + 16]
    return tile


def test_packed_weight_and_b_tiles():
    """``pack_conv_weight`` pads the depth to K_ALIGN = 64 with zeros in
    (kh, kw, i) order; the B tiles of a 96-channel conv with 64-wide
    columns cover it, zero past O and past Kpad, and their product with the
    model's A tiles is the plain version's accumulator."""
    rng = np.random.RandomState(1)
    shape, ksize, stride, pad = ((1, 5, 6, 64), (3, 3), (1, 1),
                                 ((1, 1), (1, 1)))
    kern = rng.randint(-127, 128, ksize + (64, 96)).astype(np.int8)
    wp = CQ.pack_conv_weight(torch.from_numpy(kern)).numpy()
    assert CQ.K_ALIGN == 64 and wp.shape == (96, 576) and 576 % 128 == 64
    np.testing.assert_array_equal(wp, kern.transpose(3, 0, 1, 2).reshape(
        96, 576))
    x = rng.randint(-127, 128, shape).astype(np.int8)
    a = _body_a_model(x, ksize, stride, pad, 576).astype(np.int64)
    nsteps = -(-576 // CQ.BODY_BK)
    acc = np.zeros((a.shape[0], 128), np.int64)
    for col0 in (0, 64):
        b = np.concatenate([_body_b_model(wp, col0, 64, s)
                            for s in range(nsteps)], axis=1).astype(np.int64)
        assert not b[96 - col0:].any() and not b[:, 576:].any()
        acc[:, col0:col0 + 64] = a @ b.T
    oh, ow = CQ.conv_out_hw(5, 6, ksize, stride, pad)
    want = CQ.int8_conv_reference(
        torch.from_numpy(x), torch.from_numpy(wp), torch.ones(96),
        torch.zeros(96), ksize=ksize, stride=stride, pad=pad, mode="acc")
    np.testing.assert_array_equal(acc[:oh * ow, :96],
                                  want.reshape(-1, 96).numpy())


def _s2d_a_model(x: np.ndarray, n: int, oh: int) -> np.ndarray:
    """The A rows that ``int8_conv_s2d`` reads for output row (n, oh), as it
    builds them: its block owns output rows oh0 = oh - oh % 2 and oh0 + 1
    and loads input rows oh0 - 2 .. oh0 + 2 as the aligned 16-byte chunks
    that cover each (a row's first byte lands at 32 + its offset % 16; a
    chunk past the tensor's end is read word by word), zero-padded; then
    each fragment word is at ``ow*12 + s_row[oh - oh0 + kh] + k % 48`` for
    depth k of tap row kh = k // 48. Returns (ceil16(OW), 192)."""
    nn_, h, w, c = x.shape
    assert c == CQ.S2D_C and CQ.S2D_ROWS == 2
    flat = x.reshape(-1)
    rb = CQ.s2d_row_bytes(w)
    rows_in = CQ.S2D_ROWS + 3
    strip = np.full(rows_in * rb, 99, np.int8)
    s_row = []
    row_bytes = w * c
    oh0 = oh - oh % CQ.S2D_ROWS
    for r in range(rows_in):
        ih = oh0 - 2 + r
        row = strip[r * rb:(r + 1) * rb]
        if not 0 <= ih < h:
            row[:] = 0
            s_row.append(r * rb + 32 - 24)
            continue
        start = (n * h + ih) * row_bytes      # the tensor is 16-aligned
        delta = start & 15
        for i in range((delta + row_bytes + 15) >> 4):
            src = start - delta + 16 * i
            for q in range(4):               # word by word past the end
                if src + 4 * q < flat.size:
                    row[32 + 16 * i + 4 * q:32 + 16 * i + 4 * q + 4] = \
                        flat[src + 4 * q:src + 4 * q + 4]
        first = 32 + delta
        row[first - 24:first] = 0
        row[first + row_bytes:] = 0
        s_row.append(r * rb + first - 24)
    rows = -(-w // 16) * 16
    a = np.zeros((rows, 192), np.int8)
    reads = []
    for o_w in range(rows):
        for k in range(0, 192, 4):
            kh = k // 48
            at = o_w * 12 + s_row[oh - oh0 + kh] + (k - kh * 48)
            reads.append(at)
            a[o_w, k:k + 4] = strip[at:at + 4]
    assert 0 <= min(reads) and max(reads) + 4 <= strip.size
    return a


@pytest.mark.parametrize("shape", [(2, 5, 11, 12), (1, 4, 171, 12),
                                   (1, 3, 7, 12)])
def test_s2d_strip_model_matches_unfold(shape):
    """The stem's rows from its strip equal F.unfold's, for rows whose
    starts fall at every offset mod 16 (2,052-byte rows at 171 pixels),
    for the top and bottom padding rows, and for a tensor whose end is not
    16-byte aligned (1x3x7x12 = 252 bytes)."""
    x = np.random.RandomState(2).randint(-127, 128, shape).astype(np.int8)
    geo = CQ.S2D_GEOMETRY
    want = _unfold_rows(x, *geo).reshape(shape[0], shape[1], shape[2], 192)
    for n in range(shape[0]):
        for oh in range(shape[1]):
            got = _s2d_a_model(x, n, oh)
            np.testing.assert_array_equal(got[:shape[2]], want[n, oh],
                                          err_msg=f"row {n}, {oh}")


def _requant_quotient(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``requant_quotient`` of the .cu in float32 torch: r = RN(1/s), q0 =
    RN(y*r), then q0 + RN(y - q0*s)*r with both FMAs rounded once
    (:func:`cuda_quant.fma_f32`), for 0.25 <= |q0| < 2^24; q0 elsewhere."""
    r = (1.0 / s).float()
    q0 = (y * r).float()
    q1 = CQ.fma_f32(CQ.fma_f32(-q0, s, y), r, q0)
    a = q0.abs()
    return torch.where((a >= 0.25) & (a < 2.0 ** 24), q1, q0)


def test_requant_quotient_is_the_division():
    """The kernels requantize without dividing: the FMA-corrected reciprocal
    quotient equals IEEE division wherever 0.25 <= |q0| < 2^24, and rint +
    clamp give the same int8 everywhere, on scales across the range the
    kernels take it for and on dividends at and next to half-integer
    quotients."""
    gen = torch.Generator().manual_seed(6)
    n = 200_000
    s = ((torch.rand(n, generator=gen) + 0.01) * 10.0 ** torch.randint(
        -12, 3, (n,), generator=gen).float()).float()
    half = (torch.randint(-300, 300, (n,), generator=gen).float() + 0.5) * s
    nudge = torch.randint(-1, 2, (n,), generator=gen)
    near = torch.where(nudge == 0, half, torch.nextafter(
        half, torch.where(nudge > 0, torch.tensor(np.inf),
                          torch.tensor(-np.inf))))
    wide = (torch.randn(n, generator=gen) * 10.0 ** torch.randint(
        -4, 9, (n,), generator=gen).float()) * s
    for y in (near.float(), wide.float(), torch.zeros(n)):
        want = (y / s).float()
        got = _requant_quotient(y, s)
        a = got.abs()
        sel = (a >= 0.25) & (a < 2.0 ** 24)
        assert torch.equal(got[sel], want[sel])
        np.testing.assert_array_equal(
            torch.clamp(torch.round(got), -127, 127).numpy(),
            torch.clamp(torch.round(want), -127, 127).numpy())


# ------------------------------------------------------- prepared launches


def _operands(shape, o, ksize, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))
    k = rng.randint(-127, 128, tuple(ksize) + (shape[3], o)).astype(np.int8)
    depth = ksize[0] * ksize[1] * shape[3]
    m = torch.from_numpy((rng.uniform(0.5, 1.5, o)
                          / (5376.0 * depth ** 0.5)).astype(np.float32))
    b = torch.from_numpy((rng.randn(o) * 0.1).astype(np.float32))
    return x, CQ.pack_conv_weight(torch.from_numpy(k)), m, b


def test_prepared_conv_on_cpu_equals_int8_conv():
    """A site's prepared K1 runs the plain version on CPU tensors, with the
    same result as :func:`int8_conv`, in every epilogue kind."""
    x, w, m, b = _operands((2, 6, 7, 64), 32, (3, 3))
    site = CQ.PreparedConv(w, m, b, (3, 3))
    geo = dict(stride=(1, 1), pad=((1, 1), (1, 1)))
    before = dict(CQ.launches)
    res = torch.from_numpy(np.random.RandomState(3).randint(
        -127, 128, (2, 6, 7, 32)).astype(np.int8))
    for kw in (dict(mode="acc"), dict(mode="deq", out_dtype=torch.bfloat16),
               dict(mode="relu_q", s_out=3 / 127),
               dict(mode="residual", residual=res, res_scale=1 / 40,
                    s_out=3 / 127)):
        got = site(x, 1.0, **geo, **kw)
        want = CQ.int8_conv(x, w, m, b, 1.0, ksize=(3, 3), **geo, **kw)
        assert torch.equal(got, want), kw
    assert CQ.launches == before   # CPU tensors launch nothing


def test_site_rebuilds_prepared_launch_after_to():
    """``_Site.conv`` prepares its launch once, and again when its buffers
    are replaced, as ``.to(device)`` replaces them (the old pointers would
    be stale)."""
    from geomapnet_tpu_torch.models.quant import _Site

    rng = np.random.RandomState(4)
    site = _Site({"qkernel": rng.randint(-127, 128, (1, 1, 16, 16)).astype(
        np.int8), "m": np.ones(16, np.float32), "b": np.zeros(16, np.float32)})
    x = torch.from_numpy(rng.randint(-127, 128, (1, 2, 2, 16)).astype(np.int8))
    geo = dict(stride=(1, 1), pad=((0, 0), (0, 0)), mode="acc")
    first = site.conv(x, None, **geo)
    k1 = site._k1
    assert site.conv(x, None, **geo).equal(first) and site._k1 is k1
    site.m = site.m.clone()
    assert site.conv(x, None, **geo).equal(first)
    assert site._k1 is not k1 and site._k1.m is site.m


# ----------------------------------------------------------------- on the card

# (input NHWC, O, ksize, stride, pad) of every kind a route meets, at a few
# frames: ragged M (not a multiple of 128), odd widths, O narrower than the
# tile, the 1x1 convs, the deep layer, the S2D stem, the 7x7 loader stem
CARD_KINDS = {
    "s2d_stem": ((2, 16, 22, 12), 64, (4, 4), (1, 1), ((2, 1), (2, 1))),
    "s2d_stem_odd": ((3, 9, 37, 12), 64, (4, 4), (1, 1), ((2, 1), (2, 1))),
    "stem_7x7_s2": ((2, 32, 43, 3), 64, (7, 7), (2, 2), ((3, 3), (3, 3))),
    "3x3_s1": ((2, 8, 11, 64), 64, (3, 3), (1, 1), ((1, 1), (1, 1))),
    "3x3_s2": ((2, 9, 13, 64), 128, (3, 3), (2, 2), ((1, 1), (1, 1))),
    "1x1_s2": ((2, 8, 11, 64), 128, (1, 1), (2, 2), ((0, 0), (0, 0))),
    "1x1_s1": ((2, 8, 11, 64), 96, (1, 1), (1, 1), ((0, 0), (0, 0))),
    "3x3_deep_narrow": ((2, 3, 4, 512), 32, (3, 3), (1, 1), ((1, 1), (1, 1))),
    "3x3_c16": ((2, 8, 11, 16), 16, (3, 3), (1, 1), ((1, 1), (1, 1))),
    "3x3_wide": ((2, 4, 5, 256), 512, (3, 3), (1, 1), ((1, 1), (1, 1))),
}

EPILOGUES = ("acc", "deq_f32", "deq_bf16", "relu_q", "res_f32", "res_i8",
             "res_i8_f32")


def _epilogue(epi, n, oh, ow, o, dev):
    rng = np.random.RandomState(5)
    if epi == "acc":
        return dict(mode="acc")
    if epi.startswith("deq"):
        return dict(mode="deq", out_dtype=torch.float32 if epi == "deq_f32"
                    else torch.bfloat16)
    if epi == "relu_q":
        return dict(mode="relu_q", s_out=3 / 127)
    kw = dict(mode="residual", s_out=None if epi == "res_i8_f32" else 3 / 127)
    if epi == "res_f32":
        kw["residual"] = torch.from_numpy(rng.randn(n, oh, ow, o).astype(
            np.float32)).to(dev)
    else:
        kw["residual"] = torch.from_numpy(rng.randint(
            -127, 128, (n, oh, ow, o)).astype(np.int8)).to(dev)
        kw["res_scale"] = 1 / 40
    return kw


def assert_k1_matches_plain_on_card(cases: dict) -> dict:
    """Every case through its route and through ``simple`` in every
    epilogue against the plain version on the card: int32 and int8
    exactly, float32 and bf16 exactly (the same intrinsics in the same
    order). Returns the launches counted per route."""
    before = dict(CQ.launches)
    for name, (shape, o, ksize, stride, pad) in cases.items():
        x, w, m, b = (t.cuda() for t in _operands(shape, o, ksize))
        oh, ow = CQ.conv_out_hw(shape[1], shape[2], ksize, stride, pad)
        geo = dict(ksize=ksize, stride=stride, pad=pad)
        for epi in EPILOGUES:
            kw = _epilogue(epi, shape[0], oh, ow, o, x.device)
            want = CQ.int8_conv_reference(x, w, m, b, 1.0, **geo, **kw)
            for route in (None, "simple"):
                got = CQ.int8_conv(x, w, m, b, 1.0, **geo, **kw, route=route)
                torch.cuda.synchronize()
                assert got.dtype == want.dtype and torch.equal(got, want), (
                    name, epi, route)
    return {k: CQ.launches[k] - before[k] for k in CQ.launches}


@pytest.mark.cuda
def test_k1_routes_match_plain_on_card():
    """Each route at each kind it meets, every epilogue, with its own launch
    counter: s2d for the 12-channel stem, simple for the 3-channel one (and
    as the yardstick everywhere), body for the rest."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels build and run only "
                    "there")
    got = assert_k1_matches_plain_on_card(CARD_KINDS)
    routes = {name: CQ.conv_route(v[0][3]) for name, v in CARD_KINDS.items()}
    n_e = len(EPILOGUES)
    for route in CQ.ROUTES:
        own = sum(r == route for r in routes.values())
        assert got[f"int8_conv.{route}"] == n_e * (
            own + (len(CARD_KINDS) if route == "simple" else 0)), route
    assert got["int8_conv"] == 2 * n_e * len(CARD_KINDS)


@pytest.mark.cuda
def test_prepared_conv_on_card_reuses_its_launch():
    """A prepared site launches the same kernel as :func:`int8_conv`, keeps
    one prepared launch per shape, and raises on a misaligned input."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels build and run only "
                    "there")
    x, w, m, b = (t.cuda() for t in _operands((2, 8, 11, 64), 64, (3, 3)))
    site = CQ.PreparedConv(w, m, b, (3, 3))
    s = torch.tensor(1.0, device="cuda")
    geo = dict(stride=(1, 1), pad=((1, 1), (1, 1)), mode="relu_q",
               s_out=torch.tensor(3 / 127, device="cuda"))
    for _ in range(3):
        got = site(x, s, **geo)
    assert len(site._launches) == 1
    assert torch.equal(got, CQ.int8_conv_reference(x, w, m, b, s,
                                                   ksize=(3, 3), **geo))
    flat = torch.zeros(x.numel() + 1, dtype=torch.int8, device="cuda")
    odd = flat[1:].view(x.shape)
    with pytest.raises(ValueError, match="aligned"):
        site(odd, s, **geo)
