"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. build: compile the CUDA demosaic kernel from this checkout's sources and
   print the card's name and power limit;
2. kernel: at the main path's shape (60 frames of 960x1280 GBRG uint8) the
   kernel must equal its plain PyTorch version on the card, bit for bit in
   float32 and within 1 ulp in bf16; CUDA-event times of both;
3. main path: MapNet with a ResNet-34 trunk (feat_dim 2048, configs/
   mapnet.ini: steps 3, skip 10, batch 20) and numpy-seeded weights runs
   through ``geomapnet_tpu_torch.cli.eval.main()`` on a RobotCar scene of
   native raw mosaics (tools/make_verify_fixture.py's disk format). The
   kernel's launch count must equal the eval's batch count, every pose must
   be finite, the poses must match a run with the kernel's plain version,
   and the model on the card must agree with itself on the CPU on a small
   input.
4. 7Scenes main path: the same MapNet (ResNet-34, configs/mapnet.ini) on a
   generated 7Scenes scene in the dataset's disk format, 480x640 colour
   PNGs resized on the host to 256x341, a test split of 500 frames, through
   ``cli.eval.main()`` four times: (a) the loader path in float32, (b)
   ``--device_cache`` in float32 (the slice epoch: each unique frame
   computed once), (c) ``--device_cache --no_frame_dedup`` (the tuple
   epoch), (d) ``--device_cache --bf16``. Poses must be finite with one row
   per frame, (a)-(c) must agree, (b) must compute ceil(U/(B*T))*B*T
   frames, and (d)'s translations must stay within the bf16 tolerance of
   (b)'s. Then the slice epoch again in float32 and bf16 through
   ``evaluate()`` on (b)'s device frames (no upload, warm), which must
   agree with (b) and (d). Prints each run's images/s, upload time and
   frames computed, and the CUDA-event time of one device-cache window
   (preprocess + forward of 60 frames) in float32 and bf16.
5. int8 serving: the int8 conv kernel (K1) and the int8 max-pool kernel
   (K2), built in phase 1 from ``geomapnet_tpu_torch/csrc/`` (K1's ptxas
   report printed; its body route's SASS must hold GMMA instructions), must
   equal their plain PyTorch versions on the card at every geometry of a
   60-frame ResNet-34 window (bit for bit on int8 and int32 outputs, within
   1 ulp on float32 and bf16), in every epilogue mode, through K1's route
   for the geometry (body, s2d) and through PR 3's kernel (route simple,
   the yardstick). Per geometry: kernel_ms and simple_ms (CUDA-graph
   replays), gemm_ms (``torch._int_mm`` on the geometry's (M, Kpad) x
   (Kpad, O), not the same function), plain_ms and the bound; K1's host
   time per launch through ``int8_conv`` and through a prepared site.
   ``torch._int_mm`` (the int8 ``fc_feat`` head) must equal an exact
   product. Then the 7Scenes scene of phase 4 through ``cli.eval.main()``:
   (e) ``--device_cache --quantize int8 --calibrate 2 --quantize_heads
   --fuse_requant`` (the serving configuration: the prequantized
   space-to-depth row cache), (f) the same without ``--device_cache``
   (loader path, 7x7 stem), (g) ``--device_cache --quantize int8
   --calibrate 2`` (unfused static int8), (h) ``--device_cache --fold_bn
   --bf16``. Every pose must be finite; (e) and (f) must agree within 1e-6
   of the largest translation; (e) must stay within 12% and (h) within the
   bf16 tolerance of phase 4's float32 (b); K1 must launch 36 times per
   forward of 60 frames (the windows and the calibration batches), 35 of
   them on the body route, the window's stem on the s2d route and the
   calibration trunk's 7x7 stem on the simple one, and K2 once per window;
   a warm ``evaluate()`` on (e)'s returned int8 rows must equal (e); the
   fused model on the card must agree with itself on the CPU on a small
   input. Prints images/s, upload_secs, frames_computed, the CUDA-event
   times of one int8 window and one folded bf16 window, and the int8
   window's host time per K1 launch.
6. MapNet+PGO and eval-time dropout: (a) ``optimize_poses_batch`` on the
   card against itself on the CPU, float32, within ``PGO_TOL``, at 1,000
   windows of 7 poses with chain VOs (the 7Scenes shape) and with
   all-pairs VOs (P = 21, the RobotCar shape), on noisy trajectories made
   from the seed; and on the card against the upstream reference's PGO
   goldens (tests/golden_reference.py) within 2e-3. (b) the CUDA-event time
   of one call at each shape, windows/s, the host's wall time of a call
   and the card's busy time and kernel count under ``torch.profiler``.
   (c) phase 4's scene with DSO "real" poses written beside it, through
   ``cli.eval.main()`` with configs/pgo_inference_7Scenes.ini (steps 7,
   skip 150, real, dso, unit weights) and ``--pose_graph``: (i)
   ``--device_cache`` float32 (slice epoch), (j) the serving configuration,
   where K1 and K2 must launch once per site and window under PGO. Finite
   errors; the two PGO'd translation medians, their gap against the
   largest f32 translation (within ``INT8_TOL``) and PGO's share of each
   run's wall time. (d) ``--eval_dropout`` through the CLI: the 500-frame
   scene on the tuple epoch (``--device_cache --no_frame_dedup``), which
   must differ from phase 4's deterministic (c); then a 60-frame scene,
   whose tuple epoch must give bit-identical poses on a rerun with the same
   seed, other poses with another seed, and bit-identical poses on the
   loader path.

The line before the last is a JSON object with every kernel's launches on
its main path, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
MAIN_FRAMES = 60          # one eval batch: 20 tuples x 3 frames
SCENE_FRAMES = 64         # frames per sequence of the smoke scene
KERNEL_SOURCE = "geomapnet_tpu_torch/csrc/demosaic_half_normalize.cu"
KERNEL_REPLACES = "geomapnet_tpu/ops/pallas_image.py:58"
SEVEN_SCENES_FRAMES = 500   # test split of the 7Scenes scene
# bf16 against float32, relative to the largest |translation|: the bound
# tests/test_torch_sevenscenes.py fixes (BF16_TOL)
BF16_TOL = 0.03
# int8 fused against float32, relative to the largest |translation|: the
# bound of tests/test_quant.py (the JAX package's int8 against its float)
INT8_TOL = 0.12
CALIBRATE = 2
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): device
# memory bytes/s and int8 tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
K1_SOURCE = "geomapnet_tpu_torch/csrc/int8_conv.cu"
K2_SOURCE = "geomapnet_tpu_torch/csrc/int8_maxpool.cu"
# the JAX package has no TPU kernel here: XLA lowered these lines
K1_REPLACES = "geomapnet_tpu/models/quant.py:351"
K2_REPLACES = "geomapnet_tpu/models/quant.py:429"
PGO_WINDOWS = 1000        # about a 7Scenes test split's tuples
PGO_STEPS = 7
# float32 PGO on the card against float32 PGO on the CPU: ten Gauss-Newton
# iterations whose products and factorizations sum in another order; the
# CPU tests hold the port's float32 solve to JAX's within 2e-5
PGO_TOL = 1e-4
GOLDEN_TOL = 2e-3         # tests/test_golden_parity.py::TestPGO
PGO_CONFIG = "configs/pgo_inference_7Scenes.ini"
SMALL_SCENE_FRAMES = 60


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int = 20, groups: int = 5) -> float:
    """CUDA-event time of one ``fn``, after warm-up: the median over
    ``groups`` of the mean of ``reps`` back-to-back runs between two events
    (one run between two events would also count the host's launch gap)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn`` from replays of a CUDA graph of ``reps``
    back-to-back calls (the median of 5): no host work between launches, so
    a short kernel is not timed at its wrapper's pace. ``fn`` is run once
    first, outside the graph (builds, prepared launches)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return float(np.median(times))


def host_us(fn, reps: int = 200) -> float:
    """Host time of one ``fn`` in microseconds: ``reps`` calls queued back to
    back after a synchronize, without waiting for the card (whose queue
    does not fill at this count)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def check_k1_build(nvcc, cq) -> None:
    """K1's compiler report (registers, shared memory, spills per kernel)
    and its SASS: the body route must run on ``wgmma`` (GMMA instructions)."""
    lines = [ln.strip() for ln in nvcc.build_log(cq.CONV_SOURCE).splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    for ln in lines:
        print(f"ptxas K1: {ln}")
    sass = subprocess.run(
        [nvcc.tool("cuobjdump"), "-sass", str(nvcc.build(cq.CONV_SOURCE))],
        capture_output=True, text=True, check=True, timeout=120).stdout
    body = [part for part in sass.split("Function : ")[1:]
            if "int8_conv_body" in part.split("\n", 1)[0]]
    gmma = [sorted({w for w in part.split() if "GMMA" in w})
            for part in body]
    print(f"SASS K1 body route: {len(body)} kernels, GMMA instructions "
          f"{gmma}")
    if not body or not all(gmma):
        raise AssertionError("the body route's SASS has no GMMA instruction")


def profile_window(step, window, reps: int = 5) -> float | None:
    """Device time of ``reps`` windows by kernel (``torch.profiler``, self
    device time), the kernels launched per window and the card's busy share
    of their wall time; the profiler slows the host, so the idle share is
    an upper bound. Returns the device's busy ms per window (None when the
    profiler saw none)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        step(window)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                step(window)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((dev, e.key, e.count))
    busy = sum(r[0] for r in rows)
    if not busy:
        print("profile: no device time recorded (not measured)")
        return None
    kernels = sum(r[2] for r in rows) / reps
    print(f"profile, {reps} windows: device busy {busy / reps / 1e3} ms of "
          f"{wall_us / reps / 1e3} ms wall per window ({busy / wall_us} "
          f"busy under the profiler), {kernels} device operations per "
          f"window")
    for dev, key, count in sorted(rows, reverse=True)[:8]:
        print(f"  {dev / busy:.4f} of device time, {dev / reps / 1e3} ms "
              f"per window, {count // reps} per window: {key[:90]}")
    return busy / reps / 1e3


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ia = a.view(torch.int16).to(torch.int32)
    ib = b.view(torch.int16).to(torch.int32)
    ia = torch.where(ia < 0, -32768 - ia, ia)
    ib = torch.where(ib < 0, -32768 - ib, ib)
    return int((ia - ib).abs().max())


def check_kernel(cuda_image, mean, std) -> dict:
    """Kernel vs plain version at the main path's shape, on the card."""
    rng = np.random.RandomState(SEED)
    raw = torch.from_numpy(rng.randint(
        0, 256, (MAIN_FRAMES, 960, 1280), dtype=np.uint8)).cuda()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        got = cuda_image.demosaic_half_normalize(raw, mean, std, dtype,
                                                 planar=True)
        want = cuda_image.demosaic_half_normalize_reference(
            raw, mean, std, dtype, planar=True)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"kernel output {got.shape} {got.dtype} vs "
                                 f"{want.shape} {want.dtype}")
        err = float((got.float() - want.float()).abs().max())
        if dtype == torch.float32 and not torch.equal(got, want):
            raise AssertionError(f"f32 kernel differs from its plain version "
                                 f"(max abs {err})")
        if dtype == torch.bfloat16 and bf16_ulps(got, want) > 1:
            raise AssertionError("bf16 kernel is more than 1 ulp off")
        k_ms = cuda_ms(lambda: cuda_image.demosaic_half_normalize(
            raw, mean, std, dtype, planar=True))
        p_ms = cuda_ms(lambda: cuda_image.demosaic_half_normalize_reference(
            raw, mean, std, dtype, planar=True))
        name = str(dtype).replace("torch.", "")
        print(f"kernel {name} {tuple(raw.shape)} planar: max_abs_err {err} "
              f"kernel_ms {k_ms} plain_ms {p_ms}")
        out[name] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms)
    return out


def f32_ulps(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    """(elements that differ, largest difference in float32 ulps)."""
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    ia = torch.where(ia < 0, -2 ** 31 - ia, ia)
    ib = torch.where(ib < 0, -2 ** 31 - ib, ib)
    d = (ia - ib).abs()
    return int((d > 0).sum()), int(d.max()) if d.numel() else 0


def window_convs(frames: int = MAIN_FRAMES, h: int = 256, w: int = 341,
                 stages=(3, 4, 6, 3)) -> list:
    """The K1 launches of one fused int8 ResNet-34 window over the S2D row
    cache, grouped by geometry and epilogue: (name, input NHWC, O, ksize,
    stride, pad, epilogue, launches). 36 launches in all."""
    from geomapnet_tpu_torch.ops.cuda_quant import conv_out_hw

    p1 = ((1, 1), (1, 1))
    p0 = ((0, 0), (0, 0))
    sh, sw = (h + h % 2) // 2, (w + w % 2) // 2
    out = [("stem_s2d_4x4", (frames, sh, sw, 12), 64, (4, 4), (1, 1),
            ((2, 1), (2, 1)), "relu_q", 1)]
    ph, pw = (sh - 1) // 2 + 1, (sw - 1) // 2 + 1    # after the 3x3/2 pool
    c = 64
    for s, n in enumerate(stages):
        o = 64 * 2 ** s
        if s == 0:
            out += [(f"layer1_conv1", (frames, ph, pw, c), o, (3, 3), (1, 1),
                     p1, "relu_q", n),
                    (f"layer1_conv2", (frames, ph, pw, o), o, (3, 3), (1, 1),
                     p1, "res_i8", n)]
            continue
        oh, ow = conv_out_hw(ph, pw, (3, 3), (2, 2), p1)
        last = s == len(stages) - 1
        out += [
            (f"layer{s + 1}_0_conv1", (frames, ph, pw, c), o, (3, 3), (2, 2),
             p1, "relu_q", 1),
            (f"layer{s + 1}_0_down", (frames, ph, pw, c), o, (1, 1), (2, 2),
             p0, "deq_f32", 1),
            (f"layer{s + 1}_0_conv2", (frames, oh, ow, o), o, (3, 3), (1, 1),
             p1, "res_f32", 1),
            (f"layer{s + 1}_conv1", (frames, oh, ow, o), o, (3, 3), (1, 1),
             p1, "relu_q", n - 1),
            (f"layer{s + 1}_conv2", (frames, oh, ow, o), o, (3, 3), (1, 1),
             p1, "res_i8", n - 1 - last),
        ]
        if last:   # the trunk's last conv writes float32 for the mean
            out.append((f"layer{s + 1}_last_conv2", (frames, oh, ow, o), o,
                        (3, 3), (1, 1), p1, "res_i8_f32", 1))
        ph, pw, c = oh, ow, o
    return out


# K1 geometries off the fused S2D window: the loader path's 7x7 stem, the
# unfused sites' bf16 dequant, the raw accumulator and ResNet-50's 1x1
# stride-1 conv (launches 0: not in the window's account)
EXTRA_CONVS = [
    ("stem_7x7_loader", (MAIN_FRAMES, 256, 341, 3), 64, (7, 7), (2, 2),
     ((3, 3), (3, 3)), "relu_q", 0),
    ("unfused_3x3_deq_bf16", (MAIN_FRAMES, 64, 86, 64), 64, (3, 3), (1, 1),
     ((1, 1), (1, 1)), "deq_bf16", 0),
    ("acc_int32_3x3", (MAIN_FRAMES, 32, 43, 128), 128, (3, 3), (1, 1),
     ((1, 1), (1, 1)), "acc", 0),
    ("resnet50_1x1_s1", (MAIN_FRAMES, 64, 86, 64), 256, (1, 1), (1, 1),
     ((0, 0), (0, 0)), "deq_bf16", 0),
]


def conv_case(cq, case, gen) -> tuple[dict, dict]:
    """Random int8 operands for one K1 case on ``gen``'s device: the
    wrapper's positional and keyword arguments. Scales put the dequantized
    values near N(0, 1), so the requant spans the int8 range."""
    name, shape, o, ksize, stride, pad, epi, _ = case
    dev = gen.device
    k = ksize[0] * ksize[1] * shape[3]

    def i8(*s):
        return torch.randint(-127, 128, s, generator=gen, device=dev,
                             dtype=torch.int8)

    x = i8(*shape)
    w = cq.pack_conv_weight(i8(ksize[0], ksize[1], shape[3], o))
    f32 = dict(device=dev, dtype=torch.float32)
    m = (torch.rand(o, generator=gen, **f32) + 0.5) / (5376.0 * k ** 0.5)
    b = torch.randn(o, generator=gen, **f32) * 0.1
    s_in = torch.tensor(1.0, **f32)
    oh, ow = cq.conv_out_hw(shape[1], shape[2], ksize, stride, pad)
    kw = dict(ksize=ksize, stride=stride, pad=pad)
    if epi == "acc":
        kw["mode"] = "acc"
    elif epi.startswith("deq"):
        kw.update(mode="deq", out_dtype=(torch.float32 if epi == "deq_f32"
                                         else torch.bfloat16))
    else:
        kw["s_out"] = (None if epi == "res_i8_f32"
                       else torch.tensor(3.0 / 127.0, **f32))
        kw["mode"] = "relu_q" if epi == "relu_q" else "residual"
        if epi == "res_f32":
            kw["residual"] = torch.randn((shape[0], oh, ow, o),
                                         generator=gen, **f32)
        elif epi.startswith("res_i8"):
            kw["residual"] = i8(shape[0], oh, ow, o)
            kw["res_scale"] = torch.tensor(1.0 / 40.0, **f32)
    return dict(x=x, w=w, m=m, b=b, s_in=s_in), kw


def conv_bound_ms(args: dict, kw: dict, out: torch.Tensor, case) -> tuple:
    """(bound ms, "bytes" or "operations") of one K1 case: its int8
    multiply-adds at the card's int8 peak, or the bytes it must move (input,
    weight, m, b, residual read once, output written once) at its memory
    rate, whichever is longer."""
    _, shape, o, ksize, _, _, _, _ = case
    k = ksize[0] * ksize[1] * shape[3]
    n_out = out.numel()
    ops = 2.0 * n_out * k
    nbytes = (args["x"].numel() + o * k + 8 * o
              + out.numel() * out.element_size())
    res = kw.get("residual")
    if res is not None:
        nbytes += res.numel() * res.element_size()
    t_ops, t_bytes = ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_int8_kernels(cq) -> dict:
    """Phase 5, kernel checks: K1 at every geometry and epilogue of a
    60-frame window (and the extra ones), through its route and through PR
    3's kernel (route ``simple``, the yardstick), K2 at the stem's pool,
    against their plain versions on the card. Times: K1 and its yardsticks
    from CUDA-graph replays (device time), the plain versions from CUDA
    events. Returns per-window totals for the JSON line."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1 = dict(ms=0.0, simple_ms=0.0, plain_ms=0.0, bound_ms=0.0, launches=0,
              max_abs_err=0.0, ops_ms=0.0, routes={})
    slower = []
    for case in window_convs() + EXTRA_CONVS:
        name, shape, o, ksize, stride, pad, epi, count = case
        args, kw = conv_case(cq, case, gen)
        plan = cq.conv_plan(shape, o, ksize, stride, pad)
        got = cq.int8_conv(*args.values(), **kw)
        want = cq.int8_conv_reference(*args.values(), **kw)
        old = cq.int8_conv(*args.values(), **kw, route="simple")
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"K1 {name}: {tuple(got.shape)} {got.dtype}"
                                 f" vs {tuple(want.shape)} {want.dtype}")
        err = float((got.double() - want.double()).abs().max())
        if got.dtype in (torch.int8, torch.int32):
            ndiff, ulps = int((got != want).sum()), 0
            if ndiff:
                raise AssertionError(f"K1 {name} ({epi}): {ndiff} of "
                                     f"{got.numel()} outputs differ")
        elif got.dtype == torch.float32:
            ndiff, ulps = f32_ulps(got, want)
        else:
            ndiff, ulps = int((got != want).sum()), bf16_ulps(got, want)
        if ulps > 1:
            raise AssertionError(f"K1 {name} ({epi}): {ulps} ulps off")
        if not torch.equal(old, got):
            raise AssertionError(f"K1 {name} ({epi}): the simple route "
                                 f"differs from route {plan.route}")
        del old
        ms = graph_ms(lambda: cq.int8_conv(*args.values(), **kw))
        simple = graph_ms(lambda: cq.int8_conv(*args.values(), **kw,
                                               route="simple"))
        plain = cuda_ms(lambda: cq.int8_conv_reference(*args.values(), **kw),
                        reps=3)
        # a yardstick that is not the same function: the int8 product of
        # the geometry's (M, Kpad) x (Kpad, O), no im2col, no epilogue
        a = torch.randint(-127, 128, (got.numel() // o, args["w"].shape[1]),
                          generator=gen, device="cuda", dtype=torch.int8)
        gemm = graph_ms(lambda: torch._int_mm(a, args["w"].t()))
        del a
        bound, by = conv_bound_ms(args, kw, got, case)
        # operand bytes the body route reads through L2: each block gathers
        # its A rows and loads its B columns anew
        kpad = args["w"].shape[1]
        l2_mb = ((got.numel() // o) * kpad * plan.grid[1]
                 + plan.grid[0] * o * kpad) / 1e6 if plan.route == "body" \
            else None
        print(f"K1 {name} {tuple(shape)} -> {tuple(got.shape)} "
              f"{str(got.dtype)[6:]} k{ksize[0]}x{ksize[1]}/s{stride[0]} "
              f"{epi} route {plan.route} tile {plan.bm}x{plan.bn}: {ndiff} "
              f"mismatches (max {ulps} ulp, max_abs_err {err}), kernel_ms "
              f"{ms} simple_ms {simple} gemm_ms {gemm} plain_ms {plain} "
              f"bound_ms {bound} ({by}, {bound / ms:.3f} of it), l2_mb {l2_mb}, "
              f"{count} per window")
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        if plan.route == "body" and ms >= simple:
            slower.append(name)
        if count:
            k1["ms"] += count * ms
            k1["simple_ms"] += count * simple
            k1["plain_ms"] += count * plain
            k1["bound_ms"] += count * bound
            k1["launches"] += count
            k1["routes"][plan.route] = k1["routes"].get(plan.route, 0) + \
                count * ms
            if by == "operations":
                k1["ops_ms"] += count * bound
        del args, kw, got, want
    if k1["launches"] != 36:
        raise AssertionError(f"a window has {k1['launches']} K1 launches")
    k1["bound_by"] = ("operations" if k1["ops_ms"] >= k1["bound_ms"] / 2
                      else "bytes")
    print(f"K1 per 60-frame window (36 launches): kernel_ms {k1['ms']} "
          f"(by route {k1['routes']}) simple_ms {k1['simple_ms']} "
          f"({k1['simple_ms'] / k1['ms']:.3f}x the kernel) plain_ms "
          f"{k1['plain_ms']} bound_ms {k1['bound_ms']} ({k1['bound_by']}: "
          f"{k1['ops_ms']} ms of it operations-bound; the kernel at "
          f"{k1['bound_ms'] / k1['ms']:.3f} of it)")
    print(f"K1 body geometries where PR 3's kernel is as fast or faster: "
          f"{slower or 'none'}")

    # host cost of a launch: int8_conv (checks and prepares every argument
    # on each call, as PR 3's wrapper did) against a prepared site
    case = next(c for c in window_convs() if c[0] == "layer3_conv1")
    args, kw = conv_case(cq, case, gen)
    site = cq.PreparedConv(args["w"], args["m"], args["b"], case[3])
    kw_site = {k: v for k, v in kw.items() if k != "ksize"}
    before = host_us(lambda: cq.int8_conv(*args.values(), **kw))
    after = host_us(lambda: site(args["x"], args["s_in"], **kw_site))
    k1["host_us"] = (before, after)
    print(f"K1 host time per launch (layer3 3x3, {case[6]}): int8_conv "
          f"{before} us, prepared site {after} us; device time "
          f"{graph_ms(lambda: site(args['x'], args['s_in'], **kw_site)) * 1e3}"
          f" us")
    del args, kw, site

    # K2 at the stem's pool: (60, 128, 171, 64) -> (60, 64, 86, 64)
    x = torch.randint(-127, 128, (MAIN_FRAMES, 128, 171, 64), generator=gen,
                      device="cuda", dtype=torch.int8)
    got = cq.int8_maxpool3x3s2(x)
    want = cq.int8_maxpool3x3s2_reference(x)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K2 differs from its plain version")
    ms = cuda_ms(lambda: cq.int8_maxpool3x3s2(x))
    plain = cuda_ms(lambda: cq.int8_maxpool3x3s2_reference(x), reps=5)
    bound = (x.numel() + got.numel()) / HBM_BYTES_PER_S * 1e3
    # the one PyTorch call that computes the same: max_pool2d, where its
    # CUDA dispatch takes int8 (the port does not call it)
    try:
        xc = x.permute(0, 3, 1, 2)
        lib_out = torch.nn.functional.max_pool2d(xc, 3, 2, 1)
        if not torch.equal(lib_out.permute(0, 2, 3, 1), got):
            raise AssertionError("max_pool2d int8 differs from K2")
        library = cuda_ms(lambda: torch.nn.functional.max_pool2d(xc, 3, 2, 1))
    except RuntimeError as e:
        print(f"max_pool2d does not take int8 on CUDA: {e}")
        library = None
    print(f"K2 {tuple(x.shape)} -> {tuple(got.shape)}: bit-exact, kernel_ms "
          f"{ms} plain_ms {plain} bound_ms {bound} (bytes) library_ms "
          f"{library}")
    k2 = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by="bytes",
              library_ms=library, max_abs_err=0.0)

    # the int8 fc_feat head's product (a library call, not a port kernel)
    from geomapnet_tpu_torch.models.quant import _int_mm
    for rows in (MAIN_FRAMES, 5):
        a = torch.randint(-127, 128, (rows, 512), generator=gen,
                          device="cuda", dtype=torch.int8)
        bt = torch.randint(-127, 128, (2048, 512), generator=gen,
                           device="cuda", dtype=torch.int8)
        got = _int_mm(a, bt.t())
        want = (a.double() @ bt.t().double()).to(torch.int32)
        if not torch.equal(got, want):
            raise AssertionError(f"torch._int_mm differs ({rows} rows)")
    print("torch._int_mm (60 and 5 rows x 512 x 2048): exact")
    return dict(K1=k1, K2=k2)


def seeded_flax_npz(posenet: torch.nn.Module, path: Path) -> None:
    """Numpy-seeded PoseNet weights in the Flax layout that the JAX package's
    ``save_npz`` writes (HWIO convs, (in, out) dense kernels, BN scale/bias
    and mean/var), so the run loads them through the port's weight bridge.
    He-scaled kernels, BN scale and running variance in [0.5, 1.5]."""
    rng = np.random.RandomState(SEED)
    flat = {}

    def put(collection, mod, leaf, v):
        flat["/".join([collection, *mod.split("."), leaf])] = np.asarray(
            v, np.float32)

    for name, m in posenet.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            o, i, kh, kw = m.weight.shape
            put("params", name, "kernel",
                rng.randn(kh, kw, i, o) * np.sqrt(2.0 / (kh * kw * i)))
        elif isinstance(m, torch.nn.Linear):
            o, i = m.weight.shape
            put("params", name, "kernel", rng.randn(i, o) * np.sqrt(2.0 / i))
            put("params", name, "bias", rng.randn(o) * 0.1)
        elif isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            put("params", name, "scale", rng.uniform(0.5, 1.5, c))
            put("params", name, "bias", rng.randn(c) * 0.1)
            put("batch_stats", name, "mean", rng.randn(c) * 0.1)
            put("batch_stats", name, "var", rng.uniform(0.5, 1.5, c))
    np.savez(path, **flat)


def load_fixture_builder():
    spec = importlib.util.spec_from_file_location(
        "make_verify_fixture", ROOT / "tools" / "make_verify_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_robotcar


def write_7scenes_scene(root: Path, n_test: int, n_train: int = 4) -> Path:
    """A 7Scenes scene ('heads') in the dataset's disk format: seq-01 (train
    split, ``n_train`` frames) and seq-02 (test split, ``n_test`` frames) of
    480x640 colour PNGs with 4x4 pose files, and the scene's stats.txt. Each
    frame is a 640-pixel-wide window panning along a smooth random panorama,
    plus sensor noise."""
    from PIL import Image

    scene = root / "deepslam" / "7Scenes" / "heads"
    rng = np.random.RandomState(SEED)
    width = 640 + n_test
    pano = np.asarray(Image.fromarray(
        rng.randint(0, 256, (24, width // 20 + 1, 3), dtype=np.uint8)
    ).resize((width, 480), Image.BILINEAR), np.float32)

    def write(seq: Path, s: int, i: int) -> None:
        noise = np.random.RandomState(1000 * s + i).randn(480, 640, 3) * 6
        frame = np.clip(pano[:, i:i + 640] + noise, 0, 255).astype(np.uint8)
        Image.fromarray(frame).save(seq / f"frame-{i:06d}.color.png",
                                    compress_level=1)
        a = 0.002 * i
        pose = np.eye(4)
        pose[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]]
        pose[:3, 3] = [0.004 * i, 0.1 * np.sin(i / 50), 1.0 + 0.2 * s]
        np.savetxt(seq / f"frame-{i:06d}.pose.txt", pose)

    with ThreadPoolExecutor(8) as pool:
        jobs = []
        for s, n in ((1, n_train), (2, n_test)):
            seq = scene / f"seq-{s:02d}"
            seq.mkdir(parents=True)
            jobs += [pool.submit(write, seq, s, i) for i in range(n)]
        for job in jobs:
            job.result()
    (scene / "TrainSplit.txt").write_text("sequence1\n")
    (scene / "TestSplit.txt").write_text("sequence2\n")
    assets = root / "assets" / "7Scenes" / "heads"
    assets.mkdir(parents=True)
    np.savetxt(assets / "stats.txt",
               np.array([[0.45, 0.45, 0.46], [0.078, 0.077, 0.072]]))
    return root


def check_7scenes(tmp: Path, npz: Path, config_file: Path, config) -> dict:
    """Phase 4: the 7Scenes eval through the CLI, loader path and device
    cache, float32 and bf16; raises when a check fails. Returns the scene
    and runs that phase 5 reuses."""
    from geomapnet_tpu_torch.cli import builders
    from geomapnet_tpu_torch.cli import eval as cli_eval
    from geomapnet_tpu_torch.cli.eval_epoch import make_step
    from geomapnet_tpu_torch.data.composite import MF
    from geomapnet_tpu_torch.data.sevenscenes import SevenScenes
    from geomapnet_tpu_torch.models.flax_import import (
        load_npz,
        variables_to_state_dict,
    )
    from geomapnet_tpu_torch.ops import cuda_image

    t0 = time.time()
    root = write_7scenes_scene(tmp / "7scenes", SEVEN_SCENES_FRAMES)
    # the train split writes the scene's pose_stats.txt, as training would
    SevenScenes("heads", str(root / "deepslam" / "7Scenes"), train=True,
                asset_dir=str(root / "assets" / "7Scenes"))
    print(f"7Scenes scene: {SEVEN_SCENES_FRAMES} test frames 480x640 in "
          f"{time.time() - t0:.2f} s")
    argv = [
        "--dataset", "7Scenes", "--scene", "heads", "--model", "mapnet",
        "--trunk", "resnet34", "--val", "--weights", str(npz),
        "--config_file", str(config_file),
        "--batch_size", str(config.batch_size),
        "--data_path", str(root / "deepslam"),
        "--asset_root", str(root / "assets"),
    ]
    runs = {}
    for name, extra in (("a_loader_f32", []),
                        ("b_cache_f32", ["--device_cache"]),
                        ("c_cache_tuple_f32", ["--device_cache",
                                               "--no_frame_dedup"]),
                        ("d_cache_bf16", ["--device_cache", "--bf16"])):
        cuda_image.launches = 0
        t0 = time.time()
        res = cli_eval.main(argv + extra)
        wall = time.time() - t0
        runs[name] = res
        print(f"7Scenes {name}: wall {wall:.2f} s, eval "
              f"{res['images_per_sec']:.1f} images/s, upload_secs "
              f"{res.get('upload_secs')}, frames_computed "
              f"{res.get('frames_computed')}, dedup_slice "
              f"{res.get('dedup_slice')}, median_t {res['median_t']:.4f}, "
              f"K4 launches {cuda_image.launches} (not on this path)")
        if res["pred_poses"].shape != (SEVEN_SCENES_FRAMES, 7):
            raise AssertionError(f"{name}: pred_poses "
                                 f"{res['pred_poses'].shape}")
        if not np.isfinite(res["pred_poses"]).all():
            raise AssertionError(f"{name}: non-finite poses")

    a, b, c, d = (runs[k] for k in sorted(runs))
    B, T = config.batch_size, config.steps
    U = SEVEN_SCENES_FRAMES   # every frame is some tuple's middle
    if not b["dedup_slice"] or c["dedup_slice"]:
        raise AssertionError("expected the slice epoch for (b) only")
    if b["frames_computed"] != -(-U // (B * T)) * B * T:
        raise AssertionError(f"(b) computed {b['frames_computed']} frames")
    if c["frames_computed"] != -(-SEVEN_SCENES_FRAMES // B) * B * T:
        raise AssertionError(f"(c) computed {c['frames_computed']} frames")
    for name, other in (("loader", a), ("tuple epoch", c)):
        diff = np.abs(b["pred_poses"] - other["pred_poses"])
        print(f"poses, slice epoch vs {name}: max abs diff translation "
              f"{float(diff[:, :3].max())} quaternion "
              f"{float(diff[:, 3:].max())}, bit-identical "
              f"{np.array_equal(b['pred_poses'], other['pred_poses'])}")
        np.testing.assert_allclose(b["pred_poses"], other["pred_poses"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(b["targ_poses"], other["targ_poses"])
    t32, t16 = b["pred_poses"][:, :3], d["pred_poses"][:, :3]
    rel = float(np.abs(t16 - t32).max() / np.abs(t32).max())
    print(f"translations, bf16 vs f32: max abs diff "
          f"{float(np.abs(t16 - t32).max())} = {rel} of the largest "
          f"|translation| (bound {BF16_TOL})")
    if not 0 < rel <= BF16_TOL:
        raise AssertionError(f"bf16 translations off by {rel}")

    # warm reruns through evaluate() on the frames (b) uploaded: a repeated
    # eval (a sweep, a serving loop) passes them back and skips the upload.
    # Then the CUDA-event time of one window (B*T frames): preprocess +
    # forward.
    frames = b["device_frames"]
    # the CLI's host transform (256x341 uint8), which phase 5 decodes with
    tf = builders.build_transform("7Scenes", "heads", config,
                                  str(root / "assets"), train=False,
                                  seed=config.seed, keep_uint8=True)
    dataset = MF(SevenScenes("heads", str(root / "deepslam" / "7Scenes"),
                             train=False, transform=tf,
                             asset_dir=str(root / "assets" / "7Scenes")),
                 steps=T, skip=config.skip,
                 variable_skip=config.variable_skip, seed=config.seed)
    pose_stats = tuple(np.loadtxt(root / "assets" / "7Scenes" / "heads"
                                  / "pose_stats.txt"))
    for dtype, first in ((torch.float32, b), (torch.bfloat16, d)):
        name = str(dtype).replace("torch.", "")
        model, _ = builders.build_model("mapnet", config, trunk="resnet34",
                                        dtype=dtype)
        model.posenet.load_state_dict(
            variables_to_state_dict(load_npz(str(npz))))
        model.to(device=frames.device, memory_format=torch.channels_last)
        preprocess = builders.build_device_preprocess(
            "7Scenes", "heads", str(root / "assets"), dtype=dtype)
        warm = cli_eval.evaluate(
            model, dataset, frames.device, batch_size=B,
            pose_stats=pose_stats, preprocess=preprocess,
            num_workers=config.num_workers, device_cache=frames,
            progress=False)
        same = np.array_equal(warm["pred_poses"], first["pred_poses"])
        print(f"7Scenes warm slice epoch {name}, frames reused: eval "
              f"{warm['images_per_sec']:.1f} images/s, upload_secs "
              f"{warm['upload_secs']}, bit-identical to the CLI run {same}")
        np.testing.assert_allclose(warm["pred_poses"], first["pred_poses"],
                                   rtol=1e-5, atol=1e-5)
        step = make_step(model, preprocess, T)
        window = frames.narrow(0, 0, B * T)
        with torch.inference_mode():
            ms = cuda_ms(lambda: step(window))
        print(f"device-cache window, {B * T} frames 256x341, preprocess + "
              f"forward, {name}: {ms} ms")
    return dict(argv=argv, runs=runs, root=root, dataset=dataset,
                pose_stats=pose_stats, model=model)


def check_int8_eval(p4: dict, npz: Path, config) -> dict:
    """Phase 5, the int8 serving eval on phase 4's scene through the CLI
    (e)-(h), a warm rerun on (e)'s row cache, the int8 window's time and the
    fused model on the card against the CPU. Returns K1's and K2's launches
    in (e)."""
    from geomapnet_tpu_torch.cli import builders
    from geomapnet_tpu_torch.cli import eval as cli_eval
    from geomapnet_tpu_torch.cli.eval_epoch import make_step
    from geomapnet_tpu_torch.cli.eval_epoch import tuple_index_matrix
    from geomapnet_tpu_torch.data.device_cache import s2d_frame_shape
    from geomapnet_tpu_torch.models import quant
    from geomapnet_tpu_torch.ops import cuda_quant

    B, T = config.batch_size, config.steps
    q = ["--quantize", "int8", "--calibrate", str(CALIBRATE)]
    serving = q + ["--quantize_heads", "--fuse_requant"]
    runs = {}
    launches = {}
    for name, extra in (("e_cache_int8_fused", ["--device_cache"] + serving),
                        ("f_loader_int8_fused", serving),
                        ("g_cache_int8_static", ["--device_cache"] + q),
                        ("h_cache_folded_bf16", ["--device_cache", "--fold_bn",
                                                 "--bf16"])):
        for k in cuda_quant.launches:
            cuda_quant.launches[k] = 0
        t0 = time.time()
        res = cli_eval.main(p4["argv"] + extra)
        wall = time.time() - t0
        launches[name] = dict(cuda_quant.launches)
        runs[name] = res
        print(f"7Scenes {name}: wall {wall:.2f} s, eval "
              f"{res['images_per_sec']:.1f} images/s, upload_secs "
              f"{res.get('upload_secs')}, frames_computed "
              f"{res.get('frames_computed')}, dedup_slice "
              f"{res.get('dedup_slice')}, median_t {res['median_t']:.4f}, "
              f"launches {launches[name]}")
        if res["pred_poses"].shape != (SEVEN_SCENES_FRAMES, 7):
            raise AssertionError(f"{name}: pred_poses "
                                 f"{res['pred_poses'].shape}")
        if not np.isfinite(res["pred_poses"]).all():
            raise AssertionError(f"{name}: non-finite poses")
    e, f, g, h = (runs[k] for k in sorted(runs))
    b = p4["runs"]["b_cache_f32"]
    if e["device_frames"].dtype != torch.int8 or e["device_frames"].dim() != 2:
        raise AssertionError("(e) did not run on the int8 row cache")
    scale = float(np.abs(e["pred_poses"][:, :3]).max())
    ef = float(np.abs(e["pred_poses"][:, :3] - f["pred_poses"][:, :3]).max())
    print(f"translations, (e) cache S2D vs (f) loader 7x7: max abs diff {ef} "
          f"= {ef / scale} of the largest, bit-identical "
          f"{np.array_equal(e['pred_poses'], f['pred_poses'])}")
    if ef > 1e-6 * scale:
        raise AssertionError("(e) and (f) disagree")
    t32 = b["pred_poses"][:, :3]
    for name, run, tol in (("(e) int8 fused", e, INT8_TOL),
                           ("(g) int8 static", g, INT8_TOL),
                           ("(h) folded bf16", h, BF16_TOL)):
        rel = float(np.abs(run["pred_poses"][:, :3] - t32).max()
                    / np.abs(t32).max())
        print(f"translations, {name} vs (b) float32: {rel} of the largest "
              f"|translation| (bound {tol})")
        if not rel <= tol:
            raise AssertionError(f"{name} off by {rel}")
    # K1: one launch per conv site (36 in a ResNet-34) per 60-frame
    # forward: the epoch's windows and, before them, the calibration batches
    # (the dynamic-scale unfused trunk); K2: one per fused window
    stages = getattr(p4["model"], "posenet", p4["model"]) \
        .feature_extractor.stage_sizes
    sites = 1 + 2 * sum(stages) + len(stages) - 1
    windows = e["frames_computed"] // (B * T)
    # every conv but the stem on the body route; the window's S2D stem on
    # the s2d route; the calibration trunk's 7x7 stem (3 channels) on simple
    want = {"int8_conv": sites * (windows + CALIBRATE),
            "int8_conv.body": (sites - 1) * (windows + CALIBRATE),
            "int8_conv.s2d": windows, "int8_conv.simple": CALIBRATE,
            "int8_maxpool3x3s2": windows}
    if launches["e_cache_int8_fused"] != want:
        raise AssertionError(f"(e) launches {launches['e_cache_int8_fused']}"
                             f", expected {want}")

    # a warm evaluate() on (e)'s returned row cache (no upload, no
    # transform; calibration decodes its batches)
    model = p4["model"]
    dataset, pose_stats = p4["dataset"], p4["pose_stats"]
    preprocess = builders.build_device_preprocess(
        "7Scenes", "heads", str(p4["root"] / "assets"))
    rows = e["device_frames"]
    warm = cli_eval.evaluate(
        model, dataset, rows.device, batch_size=B, pose_stats=pose_stats,
        preprocess=preprocess, num_workers=config.num_workers,
        device_cache=rows, progress=False, quantize=True,
        calib_batches=CALIBRATE, quantize_heads=True, fuse_requant=True)
    same = np.array_equal(warm["pred_poses"], e["pred_poses"])
    print(f"7Scenes warm (e), int8 rows reused: eval "
          f"{warm['images_per_sec']:.1f} images/s, upload_secs "
          f"{warm['upload_secs']}, bit-identical to the CLI run {same}")
    np.testing.assert_allclose(warm["pred_poses"], e["pred_poses"],
                               rtol=1e-6, atol=1e-6)

    # one int8 fused window on the row cache: CUDA-event time
    posenet = getattr(model, "posenet", model)
    idx_mat = tuple_index_matrix(dataset, True)
    frames = p4["runs"]["b_cache_f32"]["device_frames"]
    qtree = cli_eval._serving_tree(
        posenet, True, True, CALIBRATE,
        cli_eval._calibration_batches(
            dataset, True, frames, idx_mat, CALIBRATE, B, preprocess,
            frames.device, config.num_workers))
    s2d = quant.convert_stem_s2d(qtree)
    net = quant.QuantizedPoseNet(s2d, torch.bfloat16, fused=True).cuda()
    step = make_step(net, preprocess, T)
    shape = s2d_frame_shape(tuple(frames.shape[1:]))
    window = rows.narrow(0, 0, B * T).view((B * T,) + shape)
    folded = quant.QuantizedPoseNet(
        cli_eval._serving_tree(posenet, False, False, 0, None),
        torch.bfloat16).cuda()
    folded_step = make_step(folded, builders.build_device_preprocess(
        "7Scenes", "heads", str(p4["root"] / "assets"), dtype=torch.bfloat16),
        T)
    frames_window = frames.narrow(0, 0, B * T)
    with torch.inference_mode():
        ms = cuda_ms(lambda: step(window))
        folded_ms = cuda_ms(lambda: folded_step(frames_window))
        # the host's share: windows queued after a synchronize, without
        # waiting for the card
        host_ms = host_us(lambda: step(window), reps=20) / 1e3
    print(f"int8 fused window, {B * T} frames of S2D rows {shape}: {ms} ms "
          f"(CUDA events, back to back); folded bf16 window (h), {B * T} "
          f"uint8 frames: {folded_ms} ms")
    busy_ms = profile_window(step, window)
    print(f"int8 window host time: {host_ms} ms, {host_ms / sites * 1e3} us "
          f"per K1 launch ({sites} launches); device busy {busy_ms} ms: the "
          f"window is "
          f"{'host' if busy_ms is None or host_ms >= busy_ms else 'device'}"
          f"-bound")

    # the fused model on the card against the CPU on a small input: int8
    # activations exact (the kernels equal their plain versions), bf16
    # heads within a few ulp of the pose scale
    x = torch.from_numpy(np.random.RandomState(SEED + 2).randn(
        2, 64, 96, 3).astype(np.float32))
    cpu_net = quant.QuantizedPoseNet(s2d, torch.bfloat16, fused=True)
    with torch.inference_mode():
        feat_c = quant._trunk_forward_fused(cpu_net, x, torch.float32)
        feat_g = quant._trunk_forward_fused(net, x.cuda(), torch.float32)
        pose_c = cpu_net(x).numpy()
        pose_g = net(x.cuda()).cpu().numpy()
    fd = float((feat_g.cpu() - feat_c).abs().max() / feat_c.abs().max())
    pd = float(np.abs(pose_g - pose_c).max() / np.abs(pose_c).max())
    print(f"small-input int8 fused, card vs CPU: features {fd}, poses {pd} "
          f"of their largest")
    if fd > 1e-6 or pd > 0.01:
        raise AssertionError("int8 model on the card disagrees with the CPU")
    return launches["e_cache_int8_fused"]


def pgo_windows(n_windows: int, n: int, fc: bool, seed: int):
    """Noisy predicted poses around smooth random trajectories, the VOs of
    those trajectories (chain, or all pairs with ``fc``) and the
    trajectories: (W, n, 7) and (W, P, 7) float32, (W, n, 7) float64."""
    from geomapnet_tpu_torch.geometry import (
        pair_indices_fc,
        qexp_np,
        qinv_np,
        qmult_np,
        rotate_vector_np,
    )
    from geomapnet_tpu_torch.pgo import chain_pairs

    rng = np.random.RandomState(seed)
    half_yaw = (rng.uniform(-np.pi, np.pi, (n_windows, 1))
                + 0.15 * np.arange(n)) / 2
    zero = np.zeros_like(half_yaw)
    q = np.stack([np.cos(half_yaw), zero, zero, np.sin(half_yaw)], -1)
    q = qmult_np(q, qexp_np(rng.randn(n_windows, n, 3) * 0.03))
    t = np.cumsum(rng.randn(n_windows, n, 3) * 0.3, axis=1)
    i, j = pair_indices_fc(n) if fc else chain_pairs(n)
    qi_inv = qinv_np(q[:, i])
    vos = np.concatenate([rotate_vector_np(t[:, j] - t[:, i], qi_inv),
                          qmult_np(qi_inv, q[:, j])], -1)
    noisy_q = q + rng.randn(*q.shape) * 0.02
    noisy_q /= np.linalg.norm(noisy_q, axis=-1, keepdims=True)
    noisy = np.concatenate([t + rng.randn(*t.shape) * 0.1, noisy_q], -1)
    return (noisy.astype(np.float32), vos.astype(np.float32),
            np.concatenate([t, q], -1))


def check_pgo(card: str) -> dict:
    """Phase 6 (a)-(b): PGO on the card against the upstream goldens and
    against the port's PGO on the CPU, then its times. Returns windows/s
    and ms per call by shape."""
    from geomapnet_tpu_torch.pgo import gauss_newton_pgo, optimize_poses_batch

    spec = importlib.util.spec_from_file_location(
        "golden_reference", ROOT / "tests" / "golden_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    gold = mod.GOLDEN
    for name, vos, kw in (
            ("pgo_chain_out", gold["pgo_vos"][:2], {}),
            ("pgo_chain_w_out", gold["pgo_vos"][:2],
             dict(sax=0.5, saq=0.5, srx=10.0, srq=10.0)),
            ("pgo_fc_out", gold["pgo_fc_vos"], dict(fc=True))):
        out = gauss_newton_pgo(gold["pgo_poses"].astype(np.float32),
                               vos.astype(np.float32), device="cuda", **kw)
        err = float(np.abs(out.cpu().numpy() - gold[name]).max())
        print(f"PGO golden {name}, float32 on the card: max abs err {err} "
              f"(bound {GOLDEN_TOL})")
        if not err <= GOLDEN_TOL:
            raise AssertionError(f"PGO {name} off the golden by {err}")

    out = {}
    for shape, fc in (("chain", False), ("fc", True)):
        poses, vos, truth = pgo_windows(PGO_WINDOWS, PGO_STEPS, fc,
                                        SEED + fc)
        p, v = torch.from_numpy(poses), torch.from_numpy(vos)
        pc, vc = p.cuda(), v.cuda()
        t0 = time.perf_counter()
        card_out = optimize_poses_batch(pc, vc, fc=fc)
        first_ms = (time.perf_counter() - t0) * 1e3
        cpu_out = optimize_poses_batch(p, v, fc=fc)
        f64_out = optimize_poses_batch(p.double(), v.double(), fc=fc)
        got = card_out.cpu()
        err = float((got - cpu_out).abs().max())
        err64 = float((got.double() - f64_out).abs().max())
        moved = float((got - p).abs().max())
        before = np.linalg.norm(poses[..., :3] - truth[..., :3], axis=-1)
        after = np.linalg.norm(got.numpy()[..., :3] - truth[..., :3],
                               axis=-1)
        print(f"PGO {shape} {tuple(p.shape)} VOs {tuple(v.shape)}: card vs "
              f"CPU float32 max abs diff {err} (bound {PGO_TOL}), card "
              f"float32 vs CPU float64 {err64}; poses moved up to {moved}; "
              f"mean translation error {before.mean()} -> {after.mean()}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"PGO {shape}: non-finite poses")
        if not err <= PGO_TOL:
            raise AssertionError(f"PGO {shape}: card vs CPU {err}")
        if not after.mean() < before.mean():
            raise AssertionError(f"PGO {shape} did not reduce the error")

        ms = cuda_ms(lambda: optimize_poses_batch(pc, vc, fc=fc), reps=5,
                     groups=5)
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            optimize_poses_batch(pc, vc, fc=fc)   # ends on a host sync
            host.append((time.perf_counter() - t0) * 1e3)
        host_ms = float(np.median(host))
        busy_ms = profile_window(
            lambda _: optimize_poses_batch(pc, vc, fc=fc), None, reps=3)
        rate = PGO_WINDOWS / (ms / 1e3)
        print(f"PGO {shape} timing ({card}): {ms} ms per call of "
              f"{PGO_WINDOWS} windows (CUDA events) = {rate:.1f} windows/s; "
              f"host wall of a call {host_ms} ms (first call {first_ms} ms); "
              f"device busy {busy_ms} ms per call")
        out[shape] = dict(ms=ms, windows_per_s=rate, host_ms=host_ms,
                          busy_ms=busy_ms)
    return out


def write_dso_vo(root: Path, n: int, seq: int = 2) -> None:
    """DSO "real" poses for 7Scenes sequence ``seq`` of the scene at
    ``root``, where ``data/sevenscenes.py::_vo_sequence`` reads them:
    ``dso_poses/seq-XX.txt`` (frame number, then the 3x4 [R|t] of the
    ground-truth pose with noise, mapped by the inverse of the alignment)
    and ``seq-XX/dso_vo_stats.pkl`` (the alignment)."""
    import pickle

    from geomapnet_tpu_torch.geometry import euler2mat

    rng = np.random.RandomState(SEED + 3)
    gt_dir = root / "deepslam" / "7Scenes" / "heads" / f"seq-{seq:02d}"
    assets = root / "assets" / "7Scenes" / "heads"
    align = {"R": euler2mat(0, 0, 0.1), "t": np.array([0.05, -0.02, 0.01]),
             "s": 1.1}
    rows = []
    for i in range(n):
        pose = np.loadtxt(gt_dir / f"frame-{i:06d}.pose.txt")
        R = pose[:3, :3] @ euler2mat(*(rng.randn(3) * 0.01))
        t = (pose[:3, 3] + rng.randn(3) * 0.01 - align["t"]) / align["s"]
        rows.append(np.concatenate([[i], np.concatenate(
            [align["R"].T @ R, (align["R"].T @ t)[:, None]], 1).ravel()]))
    (assets / "dso_poses").mkdir(exist_ok=True)
    np.savetxt(assets / "dso_poses" / f"seq-{seq:02d}.txt", np.stack(rows))
    (assets / f"seq-{seq:02d}").mkdir(exist_ok=True)
    with open(assets / f"seq-{seq:02d}" / "dso_vo_stats.pkl", "wb") as f:
        pickle.dump(align, f)


def replace_args(argv: list, **values) -> list:
    """``argv`` with the value after each ``--<key>`` set to
    ``values[key]``."""
    out = list(argv)
    for flag, value in values.items():
        out[out.index(f"--{flag}") + 1] = str(value)
    return out


def check_pgo_eval(p4: dict) -> dict:
    """Phase 6 (c): the 7Scenes PGO eval through the CLI, float32 from the
    device cache and the int8 serving configuration. Returns K1's and K2's
    launches in the serving run."""
    from geomapnet_tpu_torch.cli import eval as cli_eval
    from geomapnet_tpu_torch.cli.config import parse_ini
    from geomapnet_tpu_torch.ops import cuda_quant

    write_dso_vo(p4["root"], SEVEN_SCENES_FRAMES)
    config_file = ROOT / PGO_CONFIG
    config = parse_ini(config_file)
    B, T = config.batch_size, config.steps
    argv = replace_args(p4["argv"], config_file=config_file,
                        batch_size=B) + ["--pose_graph", "--device_cache"]
    serving = ["--quantize", "int8", "--calibrate", str(CALIBRATE),
               "--quantize_heads", "--fuse_requant"]
    runs, launches = {}, {}
    for name, extra in (("i_pgo_cache_f32", []),
                        ("j_pgo_cache_int8_fused", serving)):
        for k in cuda_quant.launches:
            cuda_quant.launches[k] = 0
        t0 = time.time()
        res = cli_eval.main(argv + extra)
        wall = time.time() - t0
        launches[name] = dict(cuda_quant.launches)
        runs[name] = res
        print(f"7Scenes PGO {name} (steps {T}, skip {config.skip}, "
              f"{config.vo_lib} VOs): wall {wall:.2f} s, eval "
              f"{res['images_per_sec']:.1f} images/s, upload_secs "
              f"{res['upload_secs']}, frames_computed "
              f"{res['frames_computed']}, dedup_slice {res['dedup_slice']}, "
              f"pgo_secs {res['pgo_secs']} = {res['pgo_secs'] / wall} of "
              f"the wall, median_t {res['median_t']} mean_t "
              f"{res['mean_t']} median_q {res['median_q']}, launches "
              f"{launches[name]}")
        if res["pred_poses"].shape != (SEVEN_SCENES_FRAMES, 7):
            raise AssertionError(f"{name}: pred_poses "
                                 f"{res['pred_poses'].shape}")
        if not (np.isfinite(res["pred_poses"]).all() and np.isfinite(
                [res[k] for k in ("median_t", "mean_t", "median_q",
                                  "mean_q")]).all()):
            raise AssertionError(f"{name}: non-finite poses or errors")
    i, j = runs["i_pgo_cache_f32"], runs["j_pgo_cache_int8_fused"]
    if not i["dedup_slice"] or i["frames_computed"] != \
            -(-SEVEN_SCENES_FRAMES // (B * T)) * B * T:
        raise AssertionError(f"(i) ran {i['frames_computed']} frames, "
                             f"slice {i['dedup_slice']}")
    scale = float(np.abs(i["pred_poses"][:, :3]).max())
    gap = abs(i["median_t"] - j["median_t"])
    rel = float(np.abs(j["pred_poses"][:, :3] - i["pred_poses"][:, :3])
                .max() / scale)
    print(f"PGO'd translation medians: (i) float32 {i['median_t']}, (j) "
          f"int8 {j['median_t']}; gap {gap} = {gap / scale} of the largest "
          f"float32 translation; largest pose gap {rel} of it (bound "
          f"{INT8_TOL})")
    if not rel <= INT8_TOL:
        raise AssertionError(f"(j) off (i) by {rel}")
    windows = j["frames_computed"] // (B * T)
    sites = 36
    want = {"int8_conv": sites * (windows + CALIBRATE),
            "int8_conv.body": (sites - 1) * (windows + CALIBRATE),
            "int8_conv.s2d": windows, "int8_conv.simple": CALIBRATE,
            "int8_maxpool3x3s2": windows}
    if launches["j_pgo_cache_int8_fused"] != want:
        raise AssertionError(f"(j) launches "
                             f"{launches['j_pgo_cache_int8_fused']}, "
                             f"expected {want}")
    return launches["j_pgo_cache_int8_fused"]


def check_eval_dropout(p4: dict, tmp: Path, config_file: Path) -> None:
    """Phase 6 (d): ``--eval_dropout`` through the CLI on the tuple epoch;
    same seed, same draws; another seed, other draws; the loader path, the
    same draws as the tuple epoch."""
    from geomapnet_tpu_torch.cli import eval as cli_eval
    from geomapnet_tpu_torch.data.sevenscenes import SevenScenes

    argv = p4["argv"] + ["--eval_dropout"]
    tuple_epoch = ["--device_cache", "--no_frame_dedup"]
    t0 = time.time()
    full = cli_eval.main(argv + tuple_epoch)
    det = p4["runs"]["c_cache_tuple_f32"]
    diff = float(np.abs(full["pred_poses"] - det["pred_poses"]).max())
    print(f"7Scenes --eval_dropout tuple epoch: wall {time.time() - t0:.2f} "
          f"s, eval {full['images_per_sec']:.1f} images/s, frames_computed "
          f"{full['frames_computed']}, dedup_slice {full['dedup_slice']}, "
          f"median_t {full['median_t']}; max abs diff from the "
          f"deterministic tuple epoch {diff}")
    if full["dedup_slice"] or full["frames_computed"] != \
            det["frames_computed"]:
        raise AssertionError("--eval_dropout did not run the tuple epoch")
    if not (np.isfinite(full["pred_poses"]).all() and diff > 0):
        raise AssertionError("--eval_dropout: non-finite or no dropout")

    small = write_7scenes_scene(tmp / "7scenes_small", SMALL_SCENE_FRAMES)
    SevenScenes("heads", str(small / "deepslam" / "7Scenes"), train=True,
                asset_dir=str(small / "assets" / "7Scenes"))
    other_ini = tmp / "mapnet_seed8.ini"
    other_ini.write_text(config_file.read_text().replace("seed = 7",
                                                         "seed = 8"))
    base = replace_args(argv, data_path=small / "deepslam",
                        asset_root=small / "assets")
    other = replace_args(base, config_file=other_ini)
    runs = {name: cli_eval.main(a) for name, a in (
        ("tuple", base + tuple_epoch), ("tuple_again", base + tuple_epoch),
        ("tuple_seed8", other + tuple_epoch), ("loader", base))}
    same = {k: np.array_equal(runs["tuple"]["pred_poses"],
                              runs[k]["pred_poses"]) for k in runs}
    print(f"--eval_dropout, {SMALL_SCENE_FRAMES}-frame scene: bit-identical "
          f"to the tuple epoch {same}")
    if not (same["tuple_again"] and same["loader"]) or same["tuple_seed8"]:
        raise AssertionError(f"--eval_dropout draws: {same}")
    for res in runs.values():
        if not np.isfinite(res["pred_poses"]).all():
            raise AssertionError("--eval_dropout: non-finite poses")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs only "
              "on an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from geomapnet_tpu_torch.cli import builders
    from geomapnet_tpu_torch.cli import eval as cli_eval
    from geomapnet_tpu_torch.cli.config import parse_ini
    from geomapnet_tpu_torch.data.robotcar import RobotCar
    from geomapnet_tpu_torch.data.transforms import std_from_stats
    from geomapnet_tpu_torch.models.flax_import import (
        load_npz,
        variables_to_state_dict,
    )
    from geomapnet_tpu_torch.ops import _nvcc, cuda_image, cuda_quant

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # phase 1: build every kernel, one nvcc per source, all at once
    t0 = time.time()
    sources = [cuda_image.SOURCE, cuda_quant.CONV_SOURCE,
               cuda_quant.POOL_SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(_nvcc.build, sources))
    print(f"build: {', '.join(lib.name for lib in libs)} in "
          f"{time.time() - t0:.2f} s")
    check_k1_build(_nvcc, cuda_quant)

    # phase 2: kernel vs plain version, at the main path's shape
    stats = np.loadtxt(ROOT / "data" / "RobotCar" / "loop" / "stats.txt")
    mean, std = (tuple(float(v) for v in a) for a in std_from_stats(stats))
    kernel = check_kernel(cuda_image, mean, std)

    # phase 3: the main path through the CLI
    config_file = ROOT / "configs" / "mapnet.ini"
    config = parse_ini(config_file)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        t0 = time.time()
        root = load_fixture_builder()(tmp / "scene", n_frames=SCENE_FRAMES)
        # the train split writes the scene's pose_stats.txt, as training would
        RobotCar("loop", str(root / "deepslam" / "RobotCar"), train=True,
                 asset_dir=str(root / "assets" / "RobotCar"))
        model, _ = builders.build_model("mapnet", config, trunk="resnet34")
        npz = tmp / "mapnet_resnet34.npz"
        seeded_flax_npz(model.posenet, npz)
        print(f"scene + weights: {time.time() - t0:.2f} s")
        argv = [
            "--dataset", "RobotCar", "--scene", "loop", "--model", "mapnet",
            "--trunk", "resnet34", "--raw_bayer", "--val",
            "--weights", str(npz), "--config_file", str(config_file),
            "--batch_size", str(config.batch_size),
            "--data_path", str(root / "deepslam"),
            "--asset_root", str(root / "assets"),
        ]

        cuda_image.launches = 0
        t0 = time.time()
        res = cli_eval.main(argv)
        wall = time.time() - t0
        launches = cuda_image.launches
        n_tuples = res["pred_poses"].shape[0]
        n_batches = -(-n_tuples // config.batch_size)
        print(f"main path: {n_tuples} tuples x {config.steps} frames in "
              f"{n_batches} batches, wall {wall:.2f} s, eval "
              f"{res['images_per_sec']:.1f} images/s, kernel launches "
              f"{launches}")
        if launches != n_batches:
            raise AssertionError(f"kernel launched {launches} times for "
                                 f"{n_batches} eval batches")
        if res["pred_poses"].shape != (SCENE_FRAMES, 7):
            raise AssertionError(f"pred_poses {res['pred_poses'].shape}")
        if not (np.isfinite(res["pred_poses"]).all()
                and np.isfinite([res["median_t"], res["mean_t"]]).all()):
            raise AssertionError("non-finite poses or errors")

        # the same run with the kernel's plain version in its place
        kernel_fn = cuda_image.demosaic_half_normalize
        cuda_image.demosaic_half_normalize = \
            cuda_image.demosaic_half_normalize_reference
        try:
            plain = cli_eval.main(argv)
        finally:
            cuda_image.demosaic_half_normalize = kernel_fn
        # a warm rerun through the kernel (the first run paid set-up)
        warm = cli_eval.main(argv)
        print(f"eval images/s: kernel {res['images_per_sec']:.1f} (first "
              f"run), plain {plain['images_per_sec']:.1f}, kernel "
              f"{warm['images_per_sec']:.1f} (warm)")

        # The kernel equals its plain version bit for bit (phase 2), so the
        # runs differ only where cuDNN or cuBLAS pick another algorithm.
        diff = float(np.abs(res["pred_poses"] - plain["pred_poses"]).max())
        print(f"poses, kernel vs plain pipeline: max abs diff {diff}")
        np.testing.assert_allclose(res["pred_poses"], plain["pred_poses"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(res["targ_poses"], plain["targ_poses"])

        # the model on the card against the same weights on the CPU, on a
        # small input: float32 without TF32 on both, sums in another order,
        # so the poses agree within 1e-4 relative
        posenet = model.posenet
        posenet.load_state_dict(variables_to_state_dict(load_npz(str(npz))))
        posenet.eval()
        x = torch.from_numpy(np.random.RandomState(SEED + 1).randn(
            2, 64, 96, 3).astype(np.float32))
        with torch.inference_mode():
            cpu_out = posenet(x).numpy()
            gpu_out = posenet.cuda()(x.cuda()).cpu().numpy()
        print(f"small-input forward, card vs CPU: max abs diff "
              f"{float(np.abs(gpu_out - cpu_out).max())}, scale "
              f"{float(np.abs(cpu_out).max())}")
        np.testing.assert_allclose(gpu_out, cpu_out, rtol=1e-4, atol=1e-4)

        # phase 4: the 7Scenes main path, loader and device cache
        p4 = check_7scenes(tmp, npz, config_file, config)

        # phase 5: int8 serving, the kernels and then the CLI runs
        t0 = time.time()
        int8 = check_int8_kernels(cuda_quant)
        print(f"int8 kernel checks: {time.time() - t0:.2f} s")
        int8_launches = check_int8_eval(p4, npz, config)

        # phase 6: PGO and eval-time dropout
        t0 = time.time()
        pgo = check_pgo(card)
        pgo_launches = check_pgo_eval(p4)
        check_eval_dropout(p4, tmp, config_file)
        print(f"phase 6: {time.time() - t0:.2f} s; PGO windows/s "
              f"{ {k: v['windows_per_s'] for k, v in pgo.items()} } "
              f"({card}); K1/K2 launches under PGO {pgo_launches}")

    f32 = kernel["float32"]
    # K4's bound: each mosaic byte read once, each float32 output written
    # once (60x960x1280 uint8 -> 60x3x480x640 float32)
    k4_bytes = MAIN_FRAMES * (960 * 1280 + 3 * 480 * 640 * 4)
    k1, k2 = int8["K1"], int8["K2"]
    print(f"card: {card}")
    print(json.dumps({"kernels": [{
        "name": "demosaic_half_normalize",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max(k["max_abs_err"] for k in kernel.values()),
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": k4_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "int8_conv",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": int8_launches["int8_conv"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
    }, {
        "name": "int8_maxpool3x3s2",
        "route": "cuda",
        "source": K2_SOURCE,
        "replaces": K2_REPLACES,
        "launches": int8_launches["int8_maxpool3x3s2"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
