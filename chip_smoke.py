"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --grid     # phase 12 alone (no result line)
    python3 chip_smoke.py --vidloc   # phase 13 alone, on its own small
                                     # scene and logdir (no result line)
    python3 chip_smoke.py --lstm     # phase 14 alone (no result line)

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
7. Training: (a) one train step of MapNet (ResNet-34, feat_dim 2048, Adam
   of configs/mapnet.ini, an injected dropout mask) on 2 tuples x 3 frames
   at 64x96, on the card and on the CPU from the same weights and batch:
   the loss within ``TRAIN_TOL`` relative, the criterion's and the heads'
   gradients within ``TRAIN_TOL`` of each tensor's max-abs, every BatchNorm
   running statistic within ``TRAIN_TOL`` of its tensor's max-abs. (b) the
   full-width step (20 tuples x 3 frames at 256x341 uint8, normalized on
   the card) in float32 and bf16: CUDA-event time per step, train
   images/s, the host's time to queue a step, the peak of
   ``max_memory_allocated`` and the top device operations of a
   ``torch.profiler`` trace of 5 steps; the loss must fall over 10 steps on
   the fixed batch. (c) ``cli.train.main()`` (default device: the card) on
   a generated 7Scenes scene (200 train, 60 test frames; configs/
   mapnet.ini with 2 epochs, validation and a snapshot every epoch, and its
   host colour jitter) with ``--profile_dir``: ``epoch_000``-``epoch_002``
   written, every logged loss finite; the wall time, train images/s, the
   loop's wait on the loader (host decode, resize and jitter), and the
   card's busy share of the profiled first epoch; ``--auto_resume``
   restarts at epoch 2 with the weights restored bit for bit;
   ``cli.eval.main --weights`` on the final checkpoint gives finite errors.
   (d) ``cli.train.main --raw_bayer`` on phase 3's RobotCar scene for one
   epoch: the demosaic kernel's launches must equal the train steps plus
   the validation batches.
8. Training from the device frame cache: phase 3's RobotCar scene raised
   to 200 train and 200 test frames. (a) On the cached mosaics at full
   width (MapNet ResNet-34, configs/mapnet.ini, the demosaic kernel in the
   preprocess), one ``KLaunch`` of K=5 steps (a CUDA graph) against 5
   eager steps from the same state, batches and dropout draws, in float32
   and bf16: losses, parameters, BatchNorm statistics, loss weights and the
   optimizer's state within ``TRAIN_TOL``, and whether they are bit-equal;
   the same for 5 validation batches. (b) ``cli.train.main --raw_bayer
   --device_cache`` for 3 epochs in float32 with K=1, bf16 with K=1 and
   K=5, and bf16 ``--bn_bf16_bwd``: train images/s over epochs 1-2, the
   loader wait, the card's busy share of one more profiled epoch, peak
   memory (the cache included) and the upload seconds; the demosaic
   kernel's launches (graph replays counted) must equal the train steps
   plus the validation batches. (c) ``--ingest_overlap`` against the serial
   upload-then-train run (bf16, 2 epochs): the first epoch's wall with its
   upload, and the shuffle stream after epoch 2 equal to the serial run's.
   (d) phase 7's 7Scenes scene with ``--device_cache``: configs/posenet.ini
   (no jitter) trains from the cache, configs/mapnet.ini (colour jitter)
   prints "device_cache disabled" and trains from the loader. (e) the bf16
   step with and without ``bn_bf16_bwd`` (CUDA events, in turns) after a
   check that its forward and BatchNorm statistics are bit-identical.
9. MapNet++ fine-tuning and RobotCar's undistortion, at full width
   (ResNet-34, feat_dim 2048, configs/mapnet++_RobotCar.ini: batch 20, T 3,
   120 frames a step), on phase 8's scene with a stereo ``vo/vo.csv`` and a
   ``gps/gps_ins.csv`` written for its test split. (a) One MapNet++ train
   step on the card and on the CPU from the same weights, batch (2 items of
   2x3 frames at 64x96) and keep-mask, VO, GPS, and VO with two equal
   unlabeled frames and mask rows (the NaN cotangents, counted on both
   devices, that the guard zeroes): the loss within ``TRAIN_TOL`` relative,
   the criterion's and the heads' gradients within ``TRAIN_TOL``, ``srq``
   untouched in GPS mode. (b) ``cli.train.main``: a MapNet epoch
   (``--raw_bayer --device_cache``), then ``--model mapnet++ --checkpoint``
   of it from the cache in float32 K=1, bf16 K=5 and GPS bf16 K=5, 4 epochs
   each: train images/s (2T frames an item) over epochs 2-3 (epoch 1
   captures the graph), loader wait, busy share of a profiled epoch, peak
   memory, upload seconds; every loss finite, the first
   snapshot equal to the MapNet weights, ``srq`` exactly at its init after
   the GPS graphs, K4's launches (replays counted) equal to the steps; then
   ``cli.eval.main --model mapnet++ --pose_graph`` (configs/
   pgo_inference_RobotCar.ini) on the fine-tuned weights: finite errors, K4
   once per batch. (c) One ``KLaunch`` of 5 MapNet++ steps against 5 eager
   steps under ``cudnn.deterministic``. (d) 7Scenes MapNet++ with DSO VOs
   (configs/mapnet++_7Scenes.ini, skip 77) from phase 7's checkpoint on a
   generated scene whose 200-frame test split covers the skip. (e)
   ``--camera_models_dir`` with a written 960x1280 LUT: the undistortion
   pipeline on the card against the CPU within 1e-5 with K4 not launched,
   its CUDA-event time per 60-frame batch beside K4's path and its peak
   memory at 60 and 120 frames, then one train epoch and one eval through
   the CLIs.
10. The native decoder and serving. (a) ``geomapnet_tpu_torch.native``
   built from this checkout with g++ (the command, its seconds, the batch
   reader it chose). Where it builds: decode + resize ms a frame at 1, 4 and
   all threads on phase 4's 500 frames against PIL's, the ``--native_loader``
   eval's images/s and ``--device_cache --native_loader``'s upload beside
   phase 4's (frames byte-equal to the decode on the CPU, poses finite),
   and phase 8's 400 mosaics through ``decode_batch_gray``. Where it cannot
   build (no libpng / libjpeg headers), it prints ``native decoder: not
   buildable on this host: <the compiler's first error>``, and
   ``--native_loader`` must fail with that message (no PIL in its place).
   (b) ``geomapnet_tpu_torch.serving`` artifacts of MapNet ResNet-34
   (configs/mapnet.ini, T 3) at 256x341 with the uint8 normalize fused:
   export, size, load on the card; batches 1, 7 and 20 against the eager
   model (float32 within 1e-5 of the largest translation, bf16 within the
   bf16 tolerance); the float32 artifact also loads on the CPU (batch 1
   within 1e-4); the int8 serving configuration (calibrated on 2 batches,
   int8 heads, fused requant) with every int8 activation bit-equal to the
   in-process fused forward, poses within 1e-6, and K1 36 / K2 1 launches a
   forward run node by node; the call itself (a CUDA graph a shape)
   bit-equal to that run at its capture and at a replay, K1 72 / K2 2
   launches at the capture (the warm-up, the capture) and none at a
   replay; CUDA-event ms a 60-frame batch, artifact and eager. (c) a
   raw-Bayer artifact (the K4 pipeline fused) equal to the eager pipeline +
   model, K4 launched twice from the host at the CUDA graph's capture (the
   warm-up, the capture) and not at a replay. (d) ``cli.tools``
   export_model (equal to (b)'s float32 artifact) and time_imload on the
   card.

11. Data parallel over ``torch.distributed``: W ranks, one per card (W =
   the largest of 4, 2, 1 that the visible cards allow; NCCL), each a
   ``chip_smoke.py --dp-rank`` process with the environment ``torchrun``
   gives a rank. (a) ``cli.eval.main()`` on phase 4's scene with
   ``--device_cache shard``, in float32 (within 1e-5 of phase 4's one-rank
   (b)) and in the serving configuration (``--quantize int8 --calibrate 2
   --quantize_heads --fuse_requant``, the frame-sharded S2D int8 row cache:
   bit-equal to phase 5's one-rank (e); K1 36 launches a window and
   calibration batch and K2 one a window on every rank). (b)
   ``cli.train.main --distributed --raw_bayer --device_cache shard
   --steps_per_launch 5`` on phase 8's RobotCar scene for 2 epochs (lr
   1e-5, cuDNN deterministic; the all-reduce, the index all-gather and the
   sharded gather's reduce-scatter inside the graphs): K4 once per step and
   validation batch on every rank (replays counted), losses and parameters
   within the train-step bounds of the same run on one card without a
   group; the all-reduce's and reduce-scatter's share of a step's device
   time from a ``torch.profiler`` trace of 3 eager steps; the train
   images/s against the one-card run of the same configuration and phase
   8's one-card float32 K=1 rate. Each rank then leaves the group through
   ``shutdown_distributed`` (no ``os._exit``). (c) ``torchrun
   --nproc_per_node=W -m geomapnet_tpu_torch.cli.train --distributed``
   (one epoch, the same flags) and ``-m geomapnet_tpu_torch.cli.eval
   --device_cache shard`` on phase 8's scene, as a user launches them:
   each must exit with 0 within ``TORCHRUN_TIMEOUT``, every rank having
   left the group. Then two gloo ranks on card 0 probe each collective the
   port calls on CUDA tensors; where gloo takes them all, (a) and (b) run
   again over gloo (eager steps); where it refuses one, the phase prints
   which.
12. The multi-card dry run (``geomapnet_tpu_torch.dryrun``, the port of
   ``__graft_entry__.dryrun_multichip``) under ``torchrun``: four NCCL
   ranks, one a card, where four cards are visible, else four gloo ranks
   sharing card 0 (printed as such; not the four-card check). JAX's nine
   legs on its tiny MapNet (ResNet(stage_sizes=(1, 1)), feat_dim 64,
   64x64 tuples, batch 8): dp, dp2xtp2 (the tensor-parallel head; loss
   within 1e-5 relative and gradients within 1e-2 relative norm of the
   one-rank step), spatial eval (height banded over ``model``; within
   1e-4 of the one-rank forward), pp2 and pp2-train (GPipe with
   stage-sharded packed weights; forward, loss and gradients within 1e-4
   of the sequential composition), dp2xpp2-train, the device-cache step,
   two ``KLaunch`` K=2 launches (a CUDA graph on NCCL) and the int8
   serving artifact on every rank's share of the batch, in which K1 and
   K2 must launch on every rank (counted from 0 just before the dry run)
   and every K1 and K2 call must be bit-equal to its plain version on CPU
   copies of the same inputs (the rank's poses within 1e-5 of the largest
   of the same artifact loaded on the CPU). The ranks run the package's
   entry point, ``python -m geomapnet_tpu_torch.dryrun`` (with
   ``--device cuda:0 --backend gloo`` on fewer than four cards). Prints
   every leg's line and seconds, the checks' gaps and the dp,
   tensor-parallel and pipeline step times.
13. VidLoc, saliency, the dashboard and the optional packages. (a) VidLoc
   at full width (ResNet-34 trunk, hidden 512, bidirectional; numpy-seeded
   weights in the Flax layout carried across by the weight bridge, the
   LSTM's input kernels scaled to the trunk's feature size) on 4 sequences
   of 20 raw 960x1280 GBRG mosaics through the raw-Bayer device pipeline
   (K4, then the matmul resize to 256x341): K4 bit-equal to its plain
   version on these frames; the forward in float32 and bf16 (counts set to
   0 just before: K4 twice), poses finite of shape (4, 20, 6), bf16 within
   ``BF16_TOL`` of float32; CUDA-event ms of each forward and of one f32
   Adam train step (K4 in its preprocess), peak memory; the model on the
   card against the CPU on 2x4 frames at 64x96 within 1e-4, and one train
   step within ``TRAIN_TOL``. (b) ``python -m
   geomapnet_tpu_torch.cli.plot_activations``'s ``main`` on phase 4's scene
   (MapNet, ResNet-34, ``--frames 50``) writes 50 frames; the saliency of
   one 2-tuple batch on the card (cuDNN deterministic) against the CPU's,
   relative to its largest value: within ``SALIENCY_F64_TOL`` in float64
   (the model converted by ``.double()``) and ``SALIENCY_TOL`` in float32
   (ill-conditioned at a few pixels; the CPU's two conv backends printed
   beside it); ms a batch of 8 tuples against the forward's. (c)
   ``utils.dashboard.make_server`` on port 0 over phase 7's logdir serves
   its page and exactly its rows. (d) ``cli.eval
   --output_dir`` on phase 4's scene writes the ``.pkl`` and
   ``_metrics.json``, and the ``.png`` only where matplotlib imports (else
   it prints the skip line); ``cli.train --tensorboard`` writes an event
   file where the tensorboard package is installed, else stops at start
   with exit 2 naming the package. Each branch taken is printed.
14. The stream's recurrence kernel (``csrc/lstm_persistent.cu``, behind the
   ``geomapnet::lstm`` operator) at the stream's shape: one window of T =
   200 frames of 512 features through a bidirectional LSTM of 512 a
   direction (weights drawn as the stream cell draws them), its ptxas
   report printed. It must stay within ``LSTM_TOL`` of its plain step loop
   on the card and of ``torch.lstm`` (cuDNN), and give the same bits on a
   second call. Prints the kernel's ms (CUDA-graph replays, with the
   exchange words' memset), its latency floor (``EXCHANGE_PROBE``, built
   here: the kernel's grid and its T dependent exchanges of h, with no
   arithmetic), its operation bound (2 x 2 x T x 4H x (F + H) FLOP at 67
   TFLOP/s float32), the plain loop's ms and cuDNN's (graph replays, its
   weight-compaction copies included). Then a VidLoc streaming session
   with the stream's LSTM (a ResNet-18 trunk on 64x80 frames) runs the
   main path: two growing windows (eager, a launch each), the first full
   window (its capture: 2 launches), then graphed steps under
   ``torch.profiler``, each of which must run the kernel once, none of
   cuDNN's RNN kernels, and launch nothing from the host. The kernel's
   ``launches`` in the result line are this session's; prints a step's
   device operations.

The line before the last is a JSON object with every kernel's launches on
its main path, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import importlib
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
# one float32 train step on the card against the CPU: the forward and
# backward of a ResNet-34 summed in another order
TRAIN_TOL = 1e-4
TRAIN_FRAMES = 200        # train split of the training scene
TRAIN_VAL_FRAMES = 60


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
    """:func:`profile_calls` of ``step(window)`` in inference mode."""
    with torch.inference_mode():
        return profile_calls(lambda: step(window), reps, "window")


def profile_calls(fn, reps: int = 5, what: str = "call") -> float | None:
    """Device time of ``reps`` calls of ``fn`` by kernel (``torch.profiler``,
    the card's kernels, copies and sets), the device operations per call
    and the card's busy share of their wall time; the profiler slows the
    host, so the idle share is an upper bound. Returns the device's busy ms
    per call (None when the profiler saw none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType

    # the card's own events only (kernels, copies, sets): an operator's
    # row carries the time of the kernels it launched and an annotation's
    # the time it spans, so counting them too counts those kernels twice
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU or getattr(
                e, "is_user_annotation", False):
            continue
        dev = e.self_device_time_total
        if dev > 0:
            rows.append((dev, e.key, e.count))
    busy = sum(r[0] for r in rows)
    if not busy:
        print("profile: no device time recorded (not measured)")
        return None
    kernels = sum(r[2] for r in rows) / reps
    print(f"profile, {reps} {what}s: device busy {busy / reps / 1e3} ms of "
          f"{wall_us / reps / 1e3} ms wall per {what} ({busy / wall_us} "
          f"busy under the profiler), {kernels} device operations per "
          f"{what}")
    for dev, key, count in sorted(rows, reverse=True)[:8]:
        print(f"  {dev / busy:.4f} of device time, {dev / reps / 1e3} ms "
              f"per {what}, {count // reps} per {what}: {key[:90]}")
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
    width = 640 + max(n_test, n_train)
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
    p4["runs"]["e_cache_int8_fused"] = e    # phase 11's one-rank reference
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
    net = quant.serving_net(
        posenet, frames.device, quantize=True, quantize_heads=True,
        calib_batches=cli_eval._calibration_batches(
            dataset, True, lambda rows: frames.index_select(0, rows),
            idx_mat, CALIBRATE, B, preprocess, frames.device,
            config.num_workers),
        fuse_requant=True, s2d_stem=True)
    # the served net moved to the CPU, for the card-vs-CPU check below
    cpu_net = copy.deepcopy(net).cpu()
    step = make_step(net, preprocess, T)
    shape = s2d_frame_shape(tuple(frames.shape[1:]))
    window = rows.narrow(0, 0, B * T).view((B * T,) + shape)
    folded = quant.serving_net(posenet, frames.device, quantize=False)
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


def train_setup(config, dtype=torch.float32, device="cpu", state=None,
                preprocess=None, bn_bf16_bwd=False, model_name="mapnet"):
    """A MapNet (or ``model_name``; ResNet-34, feat_dim 2048) with its
    criterion (beta and gamma learned), optimizer and train step (through
    ``preprocess``) on ``device``; the weights from ``state`` when given,
    else from torch's seeded default generator."""
    from geomapnet_tpu_torch.cli import builders
    from geomapnet_tpu_torch.train.optim import make_optimizer
    from geomapnet_tpu_torch.train.state import make_train_step

    torch.manual_seed(SEED)
    model, _ = builders.build_model(model_name, config, trunk="resnet34",
                                    dtype=dtype, bn_bf16_bwd=bn_bf16_bwd)
    if state is not None:
        model.load_state_dict(state)
    model.to(device=device, memory_format=torch.channels_last)
    crit, _ = builders.build_criteria(model_name, config, True, True)
    crit.to(device)
    opt = make_optimizer(config.opt, config.lr, model, crit,
                         config.weight_decay, **config.optim_extras)
    return model, crit, make_train_step(model, crit, opt, preprocess)


def check_train_card_vs_cpu(config) -> None:
    """Phase 7 (a): one train step on the card against the CPU from the same
    weights, batch and dropout mask."""
    rng = np.random.RandomState(SEED + 7)
    x = torch.from_numpy(rng.randn(2, 3, 64, 96, 3).astype(np.float32))
    y = torch.from_numpy((rng.randn(2, 3, 6) * 0.1).astype(np.float32))
    mask = torch.from_numpy(rng.rand(6, 2048) >= config.dropout)
    out = {}
    state = None
    for dev in ("cpu", "cuda"):
        model, crit, step = train_setup(config, device=dev, state=state)
        state = state or {k: v.clone() for k, v in model.state_dict().items()}
        loss = step(x.to(dev), y.to(dev), keep_masks=[mask.to(dev)])
        pn = model.posenet
        grads = {f"crit.{k}": p.grad for k, p in crit.named_parameters()}
        grads.update({f"{m}.{k}": p.grad
                      for m in ("fc_feat", "fc_xyz", "fc_wpqr")
                      for k, p in getattr(pn, m).named_parameters()})
        stats = {k: v for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        out[dev] = (float(loss), {k: v.detach().cpu().double() for k, v in
                                  {**grads, **stats}.items()})
    (l_cpu, t_cpu), (l_gpu, t_gpu) = out["cpu"], out["cuda"]
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    worst = max((float((t_gpu[k] - v).abs().max()
                       / max(float(v.abs().max()), 1e-30)), k)
                for k, v in t_cpu.items())
    print(f"train step, card vs CPU (MapNet ResNet-34, 2x3x64x96, injected "
          f"dropout): loss {l_gpu} vs {l_cpu}, rel {rel}; largest gradient/"
          f"BN-statistic gap {worst[0]} of its tensor's max-abs ({worst[1]}; "
          f"{len(t_cpu)} tensors; bound {TRAIN_TOL})")
    if not (rel <= TRAIN_TOL and worst[0] <= TRAIN_TOL):
        raise AssertionError("the train step on the card differs from the "
                             "CPU's")


def time_train_step(config, card: str) -> dict:
    """Phase 7 (b): the full-width step in float32 and bf16."""
    from geomapnet_tpu_torch.ops.image import normalize

    B, T = config.batch_size, config.steps
    rng = np.random.RandomState(SEED + 8)
    raw = torch.from_numpy(rng.randint(0, 256, (B, T, 256, 341, 3),
                                       dtype=np.uint8)).cuda()
    y = torch.from_numpy((rng.randn(B, T, 6) * 0.1).astype(np.float32)
                         ).cuda()
    mean, std = (0.45, 0.45, 0.46), (0.28, 0.28, 0.27)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        model, crit, step = train_setup(
            config, dtype, "cuda", preprocess=lambda im, dt=dtype: normalize(
                im, mean, std, dtype=dt))
        losses = [float(step(raw, y)) for _ in range(10)]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"{name} train loss did not fall: {losses}")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(raw, y), reps=5, groups=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        queue = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(raw, y)
            queue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        queue_ms = float(np.median(queue))
        print(f"train step {name} ({card}), {B}x{T} frames 256x341: {ms} ms "
              f"(CUDA events) = {B * T / ms * 1e3:.1f} train images/s; host "
              f"queues a step in {queue_ms} ms; peak memory {peak:.3f} GiB; "
              f"loss over 10 steps {losses[0]:.4f} -> {losses[-1]:.4f}")
        busy = profile_calls(lambda: step(raw, y), 5, "step")
        out[name] = dict(ms=ms, images_per_s=B * T / ms * 1e3,
                         queue_ms=queue_ms, peak_gib=peak, busy_ms=busy)
        del model, crit, step
        torch.cuda.empty_cache()
    return out


def write_train_ini(tmp: Path, config_file: Path, n_epochs: int,
                    name: str, **values) -> Path:
    """``config_file`` with ``n_epochs``, validation and a snapshot every
    epoch, a print line every 5 batches, and the other keys of
    ``values``."""
    text = config_file.read_text()
    for key, value in (("n_epochs", n_epochs), ("val_freq", 1),
                       ("snapshot", 1), ("print_freq", 5),
                       *values.items()):
        text = "\n".join(f"{key} = {value}" if ln.startswith(f"{key} =")
                         else ln for ln in text.split("\n"))
    path = tmp / f"{name}.ini"
    path.write_text(text)
    return path


def check_train_cli_7scenes(tmp: Path, config_file: Path) -> Path:
    """Phase 7 (c): the train CLI on a generated 7Scenes scene, resume, and
    the eval CLI on its checkpoint. Returns the final checkpoint."""
    import os

    from benchmark.core.trace import _read_chrome_trace
    from geomapnet_tpu_torch.cli import eval as cli_eval
    from geomapnet_tpu_torch.cli import train as cli_train

    t0 = time.time()
    root = write_7scenes_scene(tmp / "7scenes_train", TRAIN_VAL_FRAMES,
                               n_train=TRAIN_FRAMES)
    ini = write_train_ini(tmp, config_file, 2, "mapnet_2ep")
    print(f"7Scenes training scene: {TRAIN_FRAMES} train / "
          f"{TRAIN_VAL_FRAMES} test frames in {time.time() - t0:.2f} s")
    argv = ["--dataset", "7Scenes", "--scene", "heads", "--model", "mapnet",
            "--trunk", "resnet34", "--config_file", str(ini),
            "--learn_beta", "--learn_gamma",
            "--data_path", str(root / "deepslam"),
            "--asset_root", str(root / "assets")]
    cwd = Path.cwd()
    os.chdir(tmp)   # logs/<experiment> under the temporary directory
    try:
        t0 = time.time()
        trainer = cli_train.main(argv + ["--profile_dir",
                                         str(tmp / "train_profile")])
        wall = time.time() - t0
        logdir = tmp / trainer.logdir
        names = sorted(p.name for p in logdir.glob("epoch_*.pth.tar"))
        if names != [f"epoch_{e:03d}.pth.tar" for e in range(3)]:
            raise AssertionError(f"checkpoints {names}")
        records = [json.loads(ln) for ln in
                   (logdir / "metrics.jsonl").read_text().splitlines()]
        losses = [r["loss"] for r in records]
        if not (len(losses) >= 4 and np.isfinite(losses).all()):
            raise AssertionError(f"logged losses {losses}")
        st = trainer.epoch_stats
        secs = sum(e["secs"] for e in st)
        images = sum(e["images"] for e in st)
        data = sum(e["data_secs"] for e in st)
        # the card's busy share, read as the benchmark's traced run reads
        # its trace: the union of the kernel, copy and set intervals
        prof = _read_chrome_trace(str(tmp / "train_profile" / "trace.json"))
        busy_ms, share = prof.busy_s() * 1e3, 1.0 - prof.idle()
        n_val = sum(r["kind"] == "val" for r in records)
        print(f"train CLI 7Scenes ({card_line()}): wall {wall:.2f} s for 2 "
              f"epochs of {st[0]['steps']} steps ({n_val} validations of "
              f"{len(trainer.val_loader)} batches, 3 checkpoints); train "
              f"{secs:.2f} s = {images / secs:.1f} train images/s; the loop "
              f"waited on the loader (decode, resize, jitter) {data:.2f} s = "
              f"{data / secs:.3f} of the train time, {data / wall:.3f} of the "
              f"wall; profiled epoch 0: card busy {busy_ms:.1f} ms = "
              f"{share:.3f} of its span (idle {1 - share:.3f}, an upper bound "
              f"under the profiler); losses {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}")

        saved = torch.load(logdir / "epoch_002.pth.tar", map_location="cpu",
                           weights_only=False)
        resumed = cli_train.main(argv + ["--auto_resume"])
        same = all(torch.equal(v.cpu(), saved["model_state_dict"][k])
                   for k, v in resumed.model.state_dict().items())
        print(f"--auto_resume: start epoch {resumed.start_epoch}, update "
              f"count {resumed.optimizer.count}, weights bit-identical to "
              f"epoch_002 {same}")
        if resumed.start_epoch != 2 or not same or \
                resumed.optimizer.count != saved["step"]:
            raise AssertionError("--auto_resume did not restore epoch 2")

        res = cli_eval.main([
            "--dataset", "7Scenes", "--scene", "heads", "--model", "mapnet",
            "--trunk", "resnet34", "--val", "--config_file", str(ini),
            "--weights", str(logdir / "epoch_002.pth.tar"),
            "--data_path", str(root / "deepslam"),
            "--asset_root", str(root / "assets")])
        errors = [res[k] for k in ("median_t", "mean_t", "median_q",
                                   "mean_q")]
        print(f"eval CLI on the trained checkpoint: median/mean translation "
              f"{errors[0]:.4f} / {errors[1]:.4f} m, rotation "
              f"{errors[2]:.3f} / {errors[3]:.3f} degrees")
        if not np.isfinite(errors).all():
            raise AssertionError("non-finite errors")
    finally:
        os.chdir(cwd)
    return logdir / "epoch_002.pth.tar"


def check_train_cli_robotcar(root: Path, tmp: Path,
                             config_file: Path) -> int:
    """Phase 7 (d): one epoch of ``--raw_bayer`` training on phase 3's
    RobotCar scene; the demosaic kernel launches once per train step and
    per validation batch. Returns its launches."""
    import os

    from geomapnet_tpu_torch.cli import train as cli_train
    from geomapnet_tpu_torch.ops import cuda_image

    ini = write_train_ini(tmp, config_file, 1, "mapnet_rc")
    cwd = Path.cwd()
    os.chdir(tmp)
    try:
        cuda_image.launches = 0
        t0 = time.time()
        trainer = cli_train.main([
            "--dataset", "RobotCar", "--scene", "loop", "--model", "mapnet",
            "--trunk", "resnet34", "--raw_bayer", "--config_file", str(ini),
            "--data_path", str(root / "deepslam"),
            "--asset_root", str(root / "assets")])
        launches = cuda_image.launches
    finally:
        os.chdir(cwd)
    steps = sum(e["steps"] for e in trainer.epoch_stats)
    val = len(trainer.val_loader)    # one validation: epoch 0 is the last
    print(f"train CLI RobotCar --raw_bayer: wall {time.time() - t0:.2f} s, "
          f"{steps} train steps + {val} validation batches; demosaic kernel "
          f"launches {launches}")
    if launches != steps + val:
        raise AssertionError(f"K4 launched {launches} times for {steps} "
                             f"steps and {val} validation batches")
    return launches


PHASE8_FRAMES = 200       # train and test split of phase 8's RobotCar scene
PHASE8_K = 5              # steps per launch in phase 8


def extend_robotcar_scene(root: Path, n: int) -> None:
    """Raise both sequences of phase 3's RobotCar scene to ``n`` frames: new
    native 960x1280 mosaics (random, from the seed), stereo timestamps and
    INS rows continuing tools/make_verify_fixture.py's pattern."""
    from PIL import Image

    scene = root / "deepslam" / "RobotCar" / "loop"
    for s, seq_name in enumerate(("2014-06-26-08-53-56",
                                  "2014-06-26-09-24-58")):
        seq = scene / seq_name
        ts_file = seq / "stereo.timestamps"
        have = len(ts_file.read_text().splitlines())
        new = range(have, n)
        with open(ts_file, "a") as f:
            f.writelines(f"{1000 * (i + 1)} {i}\n" for i in new)
        with open(seq / "gps" / "ins.csv", "a") as f:
            f.writelines(f"{1000 * (i + 1)},INS_SOLUTION_GOOD,0,0,0,"
                         f"{5e6 + s + i * 1.0},{6e5 + i * 0.5},"
                         f"{-1.0 - 0.1 * i},30U,0,0,0,0,0,{0.05 * i}\n"
                         for i in new)

        def write(i, seq=seq, s=s):
            mosaic = np.random.RandomState(SEED + 10_000 * s + i).randint(
                0, 255, (960, 1280), dtype=np.uint8)
            Image.fromarray(mosaic).save(
                seq / "stereo" / "centre" / f"{1000 * (i + 1)}.png",
                compress_level=1)

        with ThreadPoolExecutor(8) as pool:
            list(pool.map(write, new))


def cache_state_tensors(model, crit, step) -> dict:
    """Every tensor a train step moves, by name: parameters, BatchNorm
    statistics, loss weights, the optimizer's state, update count and
    rate."""
    opt = step.optimizer
    out = dict(model.state_dict(keep_vars=True))
    out.update({f"crit.{k}": v for k, v in crit.named_parameters()})
    out.update({"opt.step_t": opt.step_t, "opt.lr_t": opt.lr_t})
    for i, st in enumerate(opt.optimizer.state.values()):
        out.update({f"opt.{i}.{k}": v for k, v in st.items()
                    if torch.is_tensor(v)})
    return out


def state_gap(a: dict, b: dict) -> tuple[float, str, bool]:
    """The largest gap between two states, relative to its tensor's
    max-abs, its tensor's name, and whether the states are bit-equal."""
    worst, name, same = 0.0, "", True
    for k, x in a.items():
        x, y = x.detach().double(), b[k].detach().double()
        same = same and torch.equal(x, y)
        gap = float((x - y).abs().max() / max(float(y.abs().max()), 1e-30))
        if gap > worst:
            worst, name = gap, k
    return worst, name, same


def check_graph_vs_eager(root: Path, config) -> dict:
    """Phase 8 (a): one ``KLaunch`` of K train steps (a CUDA graph) against
    K eager steps from the same state, batches and dropout draws, on the
    RobotCar frame cache at full width, in float32 and bf16, with cuDNN's
    deterministic algorithms (two eager runs from the same state are then
    bit-equal: the control); the same for K validation batches."""
    from geomapnet_tpu_torch.cli import builders
    from geomapnet_tpu_torch.data.composite import MF
    from geomapnet_tpu_torch.data.device_cache import (
        IndexLoader,
        upload_dataset_frames,
    )
    from geomapnet_tpu_torch.data.robotcar import RobotCar
    from geomapnet_tpu_torch.train.loop import KLaunch
    from geomapnet_tpu_torch.train.state import make_eval_step

    K = PHASE8_K
    data = str(root / "deepslam" / "RobotCar")
    assets = str(root / "assets")
    ds = MF(RobotCar("loop", data, train=True, raw_bayer=True,
                     asset_dir=str(Path(assets) / "RobotCar")),
            steps=config.steps, skip=config.skip, seed=config.seed)
    t0 = time.time()
    cache = upload_dataset_frames(ds, torch.device("cuda"))
    torch.cuda.synchronize()
    print(f"phase 8 (a): {cache.shape[0]} mosaics cached "
          f"({cache.nbytes / 2 ** 30:.3f} GiB) in {time.time() - t0:.2f} s")
    batches = []
    for idx, poses, _ in IndexLoader(ds, config.batch_size, shuffle=True,
                                     seed=config.seed):
        batches.append((idx, poses))
        if len(batches) == 2 * K:
            break
    idx_k = np.stack([b[0] for b in batches[K:]])
    poses_k = np.stack([b[1] for b in batches[K:]])
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            pre = builders.build_raw_device_preprocess("loop", assets,
                                                       dtype=dtype)
            model, crit, step = train_setup(config, dtype, "cuda",
                                            preprocess=pre)
            launch = KLaunch(lambda i, p, f: step(i, p, seed=SEED, frames=f),
                             K, torch.device("cuda"))
            # the first launch runs eagerly (warm-up); the second captures
            launch(np.stack([b[0] for b in batches[:K]]),
                   np.stack([b[1] for b in batches[:K]]), cache)
            tensors = cache_state_tensors(model, crit, step)
            start = {k: t.detach().clone() for k, t in tensors.items()}

            def restore():
                with torch.no_grad():
                    for k, t in tensors.items():
                        t.copy_(start[k])

            def eager():
                restore()
                losses = torch.stack([
                    step(torch.from_numpy(i).cuda(),
                         torch.from_numpy(p).cuda(), seed=SEED, frames=cache)
                    for i, p in zip(idx_k, poses_k)])
                torch.cuda.synchronize()
                return losses, {k: t.detach().clone()
                                for k, t in tensors.items()}

            g_losses = launch(idx_k, poses_k, cache)
            graph_state = {k: t.detach().clone() for k, t in tensors.items()}
            e_losses, eager_state = eager()
            c_losses, control_state = eager()
            rel = float(((g_losses - e_losses).abs() / e_losses.abs()).max())
            worst, where, bitwise = state_gap(graph_state, eager_state)
            bitwise = bitwise and torch.equal(g_losses, e_losses)
            c_worst, _, c_bitwise = state_gap(control_state, eager_state)
            # K validation batches through their own graph
            ev = make_eval_step(model, crit, pre)
            elaunch = KLaunch(lambda i, p, f: ev(i, p, frames=f)[0], K,
                              torch.device("cuda"))
            for _ in range(2):
                elaunch(idx_k, poses_k, cache)
            v_graph = elaunch(idx_k, poses_k, cache)
            v_eager = torch.stack([ev(torch.from_numpy(i).cuda(),
                                      torch.from_numpy(p).cuda(),
                                      frames=cache)[0]
                                   for i, p in zip(idx_k, poses_k)])
            v_rel = float(((v_graph - v_eager).abs() / v_eager.abs()).max())
            per = launch.per_replay["demosaic_half_normalize"]
            print(f"phase 8 (a) {name}: K={K} graph vs {K} eager steps: "
                  f"losses rel {rel}, largest state gap {worst} of its "
                  f"tensor's max-abs ({where}; {len(tensors)} tensors), "
                  f"bit-equal {bitwise}; control (eager vs eager) gap "
                  f"{c_worst}, bit-equal {c_bitwise}; {K} validation "
                  f"batches graph vs eager rel {v_rel}; K4 launches per "
                  f"train replay {per}; update count {step.optimizer.count}"
                  f", step_t {int(step.optimizer.step_t)}; losses "
                  f"{[round(float(v), 4) for v in g_losses]}")
            if not (rel <= TRAIN_TOL and worst <= TRAIN_TOL
                    and v_rel <= TRAIN_TOL):
                raise AssertionError(f"{name}: the K-step graph differs "
                                     f"from {K} eager steps")
            if per != K or elaunch.per_replay["demosaic_half_normalize"] != K:
                raise AssertionError(f"K4 captured {per} times in a "
                                     f"{K}-step graph")
            out[name] = dict(rel=rel, worst=worst, bitwise=bitwise)
            del model, crit, step, launch, elaunch, ev
            torch.cuda.empty_cache()
        out.update(check_graph_optimizers(config))
    finally:
        torch.backends.cudnn.deterministic = False
    del cache
    torch.cuda.empty_cache()
    return out


def check_graph_optimizers(config) -> dict:
    """Phase 8 (a), the other optimizers: SGD (momentum 0.9, the rate
    decayed 10x at update 7, inside the graph's 5 steps) and RMSprop, a
    K=5 graph against 5 eager steps on a small MapNet (ResNet-18, 2x3
    frames of 64x96 from a random uint8 cache), bit for bit."""
    from geomapnet_tpu_torch.cli import builders
    from geomapnet_tpu_torch.ops.image import normalize
    from geomapnet_tpu_torch.train.loop import KLaunch
    from geomapnet_tpu_torch.train.optim import make_optimizer
    from geomapnet_tpu_torch.train.state import make_train_step

    K = PHASE8_K
    rng = np.random.RandomState(SEED + 9)
    cache = torch.from_numpy(rng.randint(0, 256, (16, 64, 96, 3),
                                         dtype=np.uint8)).cuda()
    idx = rng.randint(0, 16, (2 * K, 2, 3)).astype(np.int32)
    poses = (rng.randn(2 * K, 2, 3, 6) * 0.1).astype(np.float32)
    mean, std = (0.45, 0.45, 0.46), (0.28, 0.28, 0.27)
    out = {}
    for method, kw in (("sgd", dict(momentum=0.9, lr_decay=0.1,
                                    lr_stepvalues=[7])),
                       ("rmsprop", {})):
        torch.manual_seed(SEED)
        model, _ = builders.build_model("mapnet", config, trunk="resnet18")
        model.cuda().to(memory_format=torch.channels_last)
        crit, _ = builders.build_criteria("mapnet", config, True, True)
        crit.cuda()
        opt = make_optimizer(method, 1e-3, model, crit, 5e-4,
                             steps_per_epoch=1, **kw)
        step = make_train_step(model, crit, opt,
                               lambda im: normalize(im, mean, std))
        launch = KLaunch(lambda i, p, f: step(i, p, seed=SEED, frames=f), K,
                         torch.device("cuda"))
        launch(idx[:K], poses[:K], cache)
        tensors = cache_state_tensors(model, crit, step)
        start = {k: t.detach().clone() for k, t in tensors.items()}
        g_losses = launch(idx[K:], poses[K:], cache)
        lr_graph = float(opt.lr_t)
        graph = {k: t.detach().clone() for k, t in tensors.items()}
        with torch.no_grad():
            for k, t in tensors.items():
                t.copy_(start[k])
        e_losses = torch.stack([
            step(torch.from_numpy(i).cuda(), torch.from_numpy(p).cuda(),
                 seed=SEED, frames=cache)
            for i, p in zip(idx[K:], poses[K:])])
        torch.cuda.synchronize()
        worst, where, same = state_gap(graph, cache_state_tensors(
            model, crit, step))
        same = same and torch.equal(g_losses, e_losses)
        print(f"phase 8 (a) {method}: K={K} graph vs {K} eager steps "
              f"bit-equal {same}, largest state gap {worst} ({where}); "
              f"rate after the graph {lr_graph}, after eager "
              f"{float(opt.lr_t)} (schedule {opt.schedule(2 * K - 1)})")
        if not (worst <= TRAIN_TOL and lr_graph == float(opt.lr_t)
                and lr_graph == np.float32(opt.schedule(2 * K - 1))):
            raise AssertionError(f"{method}: the K-step graph differs from "
                                 f"{K} eager steps")
        out[method] = dict(worst=worst, bitwise=same)
        del model, crit, opt, step, launch
    return out


def run_train_cli(argv: list, tmp: Path):
    """``cli.train.main(argv)`` from ``tmp``, with the peak of device memory
    and K4's launches the run made (graph replays included)."""
    import os

    from geomapnet_tpu_torch.cli import train as cli_train
    from geomapnet_tpu_torch.ops import cuda_image

    cwd = Path.cwd()
    os.chdir(tmp)
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda_image.launches = 0
        t0 = time.time()
        trainer = cli_train.main(argv)
        wall = time.time() - t0
        counted = cuda_image.launches
    finally:
        os.chdir(cwd)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    k4 = counted
    for g in trainer.graph_launches().values():
        per = g["per_replay"].get("demosaic_half_normalize", 0)
        k4 += (g["replays"] - 1) * per
    return trainer, dict(wall=wall, peak_gib=peak, k4=k4,
                         k4_counted=counted)


def steady(trainer, first: int = 1) -> dict:
    """Train images/s and the loader's share of the train time over the
    epochs from ``first`` on (epoch 0 pays set-up and, with K > 1, the
    eager warm-up launch and the capture)."""
    st = trainer.epoch_stats[first:]
    secs = sum(e["secs"] for e in st)
    return dict(images_per_s=sum(e["images"] for e in st) / secs,
                data_share=sum(e["data_secs"] for e in st) / secs,
                step_ms=secs / sum(e["steps"] for e in st) * 1e3)


def profile_epoch(trainer) -> float:
    """The card's busy share of one more epoch under ``torch.profiler``:
    the union of its kernel, copy and set intervals over the traced span
    (the benchmark's traced run)."""
    from benchmark.core.trace import Tracer

    trainer.metrics.enabled = False     # its file closed with the run
    with Tracer(True) as tracer:
        trainer.train_epoch(len(trainer.epoch_stats))
    return 1.0 - tracer.read().idle()


def check_cache_training(root: Path, tmp: Path, config_file: Path,
                         card: str) -> dict:
    """Phase 8 (b), (c), (e): RobotCar ``--raw_bayer --device_cache``
    training through the CLI at full width."""
    ini3 = write_train_ini(tmp, config_file, 3, "mapnet_rc3")
    ini2 = write_train_ini(tmp, config_file, 2, "mapnet_rc2")
    base = ["--dataset", "RobotCar", "--scene", "loop", "--model", "mapnet",
            "--trunk", "resnet34", "--raw_bayer", "--learn_beta",
            "--learn_gamma", "--data_path", str(root / "deepslam"),
            "--asset_root", str(root / "assets")]
    runs = {}
    for name, extra in (("f32_k1", []), ("bf16_k1", ["--bf16"]),
                        ("bf16_k5", ["--bf16", "--steps_per_launch",
                                     str(PHASE8_K)]),
                        ("bf16_bnbwd_k1", ["--bf16", "--bn_bf16_bwd"])):
        trainer, r = run_train_cli(
            base + ["--config_file", str(ini3), "--device_cache",
                    "--suffix", f"_{name}"] + extra, tmp)
        steps = sum(e["steps"] for e in trainer.epoch_stats)
        n_val = len(trainer.val_loader) * 3
        if r["k4"] != steps + n_val:
            raise AssertionError(f"{name}: K4 ran {r['k4']} times for "
                                 f"{steps} steps and {n_val} validation "
                                 f"batches")
        records = [json.loads(ln) for ln in
                   (tmp / trainer.logdir / "metrics.jsonl").read_text()
                   .splitlines()]
        if not np.isfinite([x["loss"] for x in records]).all():
            raise AssertionError(f"{name}: non-finite losses")
        r.update(steady(trainer), upload_secs=trainer.upload_secs,
                 steps=steps, val_batches=n_val,
                 graphs=trainer.graph_launches())
        r["busy_share"] = profile_epoch(trainer)
        print(f"phase 8 (b) {name} ({card}): train {r['images_per_s']:.1f} "
              f"images/s ({r['step_ms']:.2f} ms a step) over epochs 1-2, "
              f"loader wait {r['data_share']:.4f} of the train time, card "
              f"busy {r['busy_share']:.3f} of a profiled epoch, peak memory "
              f"{r['peak_gib']:.3f} GiB (cache included), upload "
              f"{r['upload_secs']:.2f} s, wall {r['wall']:.2f} s; K4 ran "
              f"{r['k4']} times = {steps} steps + {n_val} validation "
              f"batches (counted at launch or capture {r['k4_counted']}, "
              f"graphs {r['graphs']})")
        runs[name] = r
        del trainer
        torch.cuda.empty_cache()

    # (c) --ingest_overlap against the serial upload-then-train run
    loaders = {}
    for name, extra in (("serial", []), ("overlap", ["--ingest_overlap"])):
        trainer, r = run_train_cli(
            base + ["--config_file", str(ini2), "--device_cache", "--bf16",
                    "--suffix", f"_{name}"] + extra, tmp)
        e0 = trainer.epoch_stats[0]["secs"]
        first = e0 + trainer.upload_secs
        loaders[name] = trainer.train_loader.rng.get_state()
        print(f"phase 8 (c) {name}: first epoch {e0:.2f} s + upload "
              f"{trainer.upload_secs:.2f} s = {first:.2f} s; epoch 1 "
              f"{trainer.epoch_stats[1]['secs']:.2f} s")
        runs[name] = dict(first_epoch=first, epoch0=e0,
                          upload_secs=trainer.upload_secs)
        del trainer
        torch.cuda.empty_cache()
    same = all(np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
               for a, b in zip(loaders["serial"], loaders["overlap"]))
    print(f"phase 8 (c): the shuffle stream after 2 epochs equal {same} "
          f"(epoch 2 drew the serial run's batches)")
    if not same:
        raise AssertionError("--ingest_overlap: epoch 2 drew other batches")
    return runs


def check_step_bn_bf16_bwd(root: Path, config, card: str) -> dict:
    """Phase 8 (e): the bf16 train step with and without ``bn_bf16_bwd``
    on the RobotCar cache (CUDA events, in turns), and the forward and
    BatchNorm statistics of the two bit for bit."""
    from geomapnet_tpu_torch.cli import builders
    from geomapnet_tpu_torch.data.composite import MF
    from geomapnet_tpu_torch.data.device_cache import (
        IndexLoader,
        upload_dataset_frames,
    )
    from geomapnet_tpu_torch.data.robotcar import RobotCar

    assets = str(root / "assets")
    ds = MF(RobotCar("loop", str(root / "deepslam" / "RobotCar"),
                     train=True, raw_bayer=True,
                     asset_dir=str(Path(assets) / "RobotCar")),
            steps=config.steps, skip=config.skip, seed=config.seed)
    cache = upload_dataset_frames(ds, torch.device("cuda"))
    idx, poses, _ = next(iter(IndexLoader(ds, config.batch_size)))
    idx, poses = torch.from_numpy(idx).cuda(), torch.from_numpy(poses).cuda()
    pre = builders.build_raw_device_preprocess("loop", assets,
                                               dtype=torch.bfloat16)
    steps, models = {}, {}
    for flag in (False, True):
        torch.manual_seed(SEED)
        model, _ = builders.build_model("mapnet", config, trunk="resnet34",
                                        dtype=torch.bfloat16,
                                        bn_bf16_bwd=flag)
        if flag:
            model.load_state_dict(models[False].state_dict())
        model.cuda().to(memory_format=torch.channels_last).train()
        models[flag] = model
    from geomapnet_tpu_torch.train.state import gather_frames

    # the trunks (the heads' train-mode dropout draws from the global
    # generator), on the batch's 60 frames
    x = pre(gather_frames(cache, idx)).flatten(0, 1)
    with torch.no_grad():
        outs = [models[f].posenet.feature_extractor(x)
                for f in (False, True)]
    same = torch.equal(outs[0], outs[1]) and all(
        torch.equal(a, b) for a, b in zip(models[False].buffers(),
                                          models[True].buffers()))
    print(f"phase 8 (e): bn_bf16_bwd forward and BatchNorm statistics "
          f"bit-identical to the default on the card: {same}")
    if not same:
        raise AssertionError("bn_bf16_bwd changed the forward")
    for flag in (False, True):
        state = models[flag].state_dict()
        _, _, step = train_setup(config, torch.bfloat16, "cuda",
                                 state=state, preprocess=pre,
                                 bn_bf16_bwd=flag)
        steps[flag] = step
    ms = {False: [], True: []}
    for flag in (False, True, True, False):
        ms[flag].append(cuda_ms(lambda: steps[flag](idx, poses, seed=SEED,
                                                    frames=cache),
                                reps=5, groups=3))
    out = {("bnbwd" if f else "default"): float(np.mean(v))
           for f, v in ms.items()}
    print(f"phase 8 (e) ({card}): bf16 train step {out['default']:.3f} ms, "
          f"with bn_bf16_bwd {out['bnbwd']:.3f} ms (CUDA events, in turns "
          f"default, bnbwd, bnbwd, default: {ms})")
    del cache, steps, models
    torch.cuda.empty_cache()
    return out


def check_cache_7scenes(tmp: Path) -> dict:
    """Phase 8 (d): 7Scenes ``--device_cache`` training with configs/
    posenet.ini (no jitter: the cache runs) and with configs/mapnet.ini
    (colour jitter: the cache turns itself off and the loader feeds)."""
    root = tmp / "7scenes_train"
    out = {}
    for name, cfg_name, epochs in (("posenet", "posenet.ini", 2),
                                   ("mapnet", "mapnet.ini", 1)):
        ini = write_train_ini(tmp, ROOT / "configs" / cfg_name, epochs,
                              f"{name}_7s_cache")
        trainer, r = run_train_cli([
            "--dataset", "7Scenes", "--scene", "heads", "--model", name,
            "--trunk", "resnet34", "--config_file", str(ini),
            "--device_cache", "--data_path", str(root / "deepslam"),
            "--asset_root", str(root / "assets")], tmp)
        log = (tmp / trainer.logdir / "log.txt").read_text()
        disabled = "device_cache disabled" in log
        st = trainer.epoch_stats[-1]
        print(f"phase 8 (d) {name} ({cfg_name}): device_cache "
              f"{trainer.device_cache}, 'device_cache disabled' printed "
              f"{disabled}; upload {trainer.upload_secs:.2f} s; last epoch "
              f"{st['images'] / st['secs']:.1f} train images/s, loader wait "
              f"{st['data_secs'] / st['secs']:.3f} of it; wall "
              f"{r['wall']:.2f} s")
        if trainer.device_cache != (name == "posenet") or \
                disabled != (name == "mapnet"):
            raise AssertionError(f"{name}: the cache should run only "
                                 f"without jitter")
        out[name] = dict(st, upload_secs=trainer.upload_secs)
        del trainer
        torch.cuda.empty_cache()
    return out


PHASE9_EPOCHS = 4         # epochs of each MapNet++ run of phase 9 (b)
PHASE9_7S_TEST = 200      # test split of phase 9 (d)'s 7Scenes scene
RC_TEST_SEQ = "2014-06-26-09-24-58"   # the RobotCar fixture's test split


def write_robotcar_vo_gps(root: Path, n: int) -> None:
    """The "real" poses of the RobotCar scene's test sequence: a stereo
    ``vo/vo.csv`` (one relative motion per frame, keyed by the later
    frame's timestamp), ``gps/gps_ins.csv`` (every other INS row, the same
    schema) and both alignments into the ground-truth frame."""
    import pickle

    from geomapnet_tpu_torch.geometry import euler2mat

    rng = np.random.RandomState(SEED + 90)
    seq = root / "deepslam" / "RobotCar" / "loop" / RC_TEST_SEQ
    (seq / "vo").mkdir(exist_ok=True)
    with open(seq / "vo" / "vo.csv", "w") as f:
        f.write("source_timestamp,destination_timestamp,x,y,z,roll,pitch,"
                "yaw\n")
        for i in range(n):
            motion = [1.0, 0.5, -0.1, 0, 0, 0.05] + rng.randn(6) * [
                0.05, 0.05, 0.01, 0.005, 0.005, 0.01]
            f.write(f"{1000 * (i + 1)},{1000 * i},"
                    + ",".join(str(v) for v in motion) + "\n")
    ins = (seq / "gps" / "ins.csv").read_text().splitlines()
    (seq / "gps" / "gps_ins.csv").write_text("\n".join(ins[:1] + ins[1::2])
                                             + "\n")
    assets = root / "assets" / "RobotCar" / "loop" / RC_TEST_SEQ
    assets.mkdir(parents=True, exist_ok=True)
    for lib, align in (("stereo", {"R": euler2mat(0, 0, 0.05),
                                   "t": np.array([0.5, -0.2, 0.0]),
                                   "s": 1.0}),
                       ("gps", {"R": np.eye(3), "t": np.zeros(3), "s": 1})):
        with open(assets / f"{lib}_vo_stats.pkl", "wb") as f:
            pickle.dump(align, f)


def mapnetpp_batch(gps: bool, equal: bool, dropout: float):
    """Phase 9 (a)'s batch: 2 items of 2x3 frames at 64x96, their pose
    blocks and a keep-mask; with ``equal`` the first two unlabeled frames
    of each item are one image with one mask row (equal predictions)."""
    rng = np.random.RandomState(SEED + 91)
    x = rng.randn(2, 6, 64, 96, 3).astype(np.float32)
    y = (rng.randn(2, 6 if gps else 5, 6) * 0.1).astype(np.float32)
    mask = rng.rand(2, 6, 2048) >= dropout
    if equal:
        x[:, 4], mask[:, 4] = x[:, 3], mask[:, 3]
    return (torch.from_numpy(x), torch.from_numpy(y),
            torch.from_numpy(mask.reshape(12, 2048)))


def check_mapnetpp_card_vs_cpu(pp_config) -> dict:
    """Phase 9 (a): one MapNet++ train step (ResNet-34, feat_dim 2048,
    configs/mapnet++_RobotCar.ini, an injected keep-mask) on the card and on
    the CPU from the same weights and batch, VO and GPS, and VO with equal
    unlabeled predictions (NaN cotangents, zeroed by the guard)."""
    import dataclasses

    out = {}
    for case in ("vo", "gps", "vo_equal"):
        gps = case == "gps"
        cfg = dataclasses.replace(pp_config, vo_lib="gps" if gps else "stereo")
        x, y, mask = mapnetpp_batch(gps, case == "vo_equal", cfg.dropout)
        res, state = {}, None
        for dev in ("cpu", "cuda"):
            model, crit, step = train_setup(cfg, device=dev, state=state,
                                            model_name="mapnet++")
            state = state or {k: v.clone()
                              for k, v in model.state_dict().items()}
            # the criterion's cotangent on the predictions, before the guard
            with torch.no_grad():
                model.train()
                pred = model(x.to(dev), keep_mask=mask.to(dev))
            pred.requires_grad_(True)
            crit(pred, y.to(dev)).backward()
            nan = int(torch.isnan(pred.grad).sum())
            equal = bool(torch.equal(pred[:, 3], pred[:, 4]))
            crit.zero_grad(set_to_none=True)
            with torch.no_grad():       # the BN statistics moved: restore
                model.load_state_dict(state)
            loss = step(x.to(dev), y.to(dev), keep_masks=[mask.to(dev)])
            pn = model.posenet
            grads = {f"crit.{k}": p.grad for k, p in crit.named_parameters()
                     if p.grad is not None}
            grads.update({f"{m}.{k}": p.grad
                          for m in ("fc_feat", "fc_xyz", "fc_wpqr")
                          for k, p in getattr(pn, m).named_parameters()})
            finite = all(bool(torch.isfinite(p).all())
                         for p in model.parameters())
            res[dev] = (float(loss), nan, equal, finite, crit.srq.item(),
                        {k: v.detach().cpu().double()
                         for k, v in grads.items()})
        (l_cpu, nan_c, eq_c, fin_c, srq_c, g_cpu), \
            (l_gpu, nan_g, eq_g, fin_g, srq_g, g_gpu) = res["cpu"], \
            res["cuda"]
        rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        worst = max((float((g_gpu[k] - v).abs().max()
                           / max(float(v.abs().max()), 1e-30)), k)
                    for k, v in g_cpu.items())
        print(f"phase 9 (a) {case}: MapNet++ step card vs CPU (2x6x64x96): "
              f"loss {l_gpu} vs {l_cpu}, rel {rel}; largest gradient gap "
              f"{worst[0]} of its tensor's max-abs ({worst[1]}; "
              f"{len(g_cpu)} tensors; bound {TRAIN_TOL}); NaN cotangents "
              f"card {nan_g} / CPU {nan_c}, equal unlabeled pair card {eq_g} "
              f"/ CPU {eq_c}; parameters finite {fin_g} / {fin_c}; srq "
              f"{srq_g} / {srq_c}")
        if not (rel <= TRAIN_TOL and worst[0] <= TRAIN_TOL and fin_g
                and fin_c and g_gpu.keys() == g_cpu.keys()):
            raise AssertionError(f"{case}: the MapNet++ step on the card "
                                 f"differs from the CPU's")
        if case == "vo_equal" and not (nan_g and nan_c and eq_g and eq_c):
            raise AssertionError("the equal-prediction batch made no NaN")
        if gps and not (srq_g == srq_c == cfg.gamma
                        and "crit.srq" not in g_gpu):
            raise AssertionError("GPS mode moved srq")
        out[case] = dict(rel=rel, worst=worst[0], nan=nan_g)
    return out


def check_mapnetpp_workflow(root: Path, tmp: Path, config_file: Path,
                            card: str) -> dict:
    """Phase 9 (b): MapNet -> MapNet++ -> the PGO eval through the CLIs on
    phase 8's RobotCar scene (``--raw_bayer --device_cache``)."""
    from geomapnet_tpu_torch.cli import eval as cli_eval
    from geomapnet_tpu_torch.ops import cuda_image

    base = ["--dataset", "RobotCar", "--scene", "loop", "--trunk",
            "resnet34", "--raw_bayer", "--learn_beta", "--learn_gamma",
            "--data_path", str(root / "deepslam"),
            "--asset_root", str(root / "assets")]
    ini = write_train_ini(tmp, config_file, 1, "mapnet_p9")
    trainer, r = run_train_cli(base + ["--model", "mapnet", "--config_file",
                                       str(ini), "--device_cache",
                                       "--suffix", "_p9"], tmp)
    ckpt = tmp / trainer.logdir / "epoch_001.pth.tar"
    steps = sum(e["steps"] for e in trainer.epoch_stats)
    n_val = len(trainer.val_loader)
    print(f"phase 9 (b) mapnet: 1 epoch of {steps} steps and {n_val} "
          f"validation batches, wall {r['wall']:.2f} s, K4 {r['k4']}; "
          f"checkpoint {ckpt.name}")
    if r["k4"] != steps + n_val:
        raise AssertionError(f"mapnet: K4 ran {r['k4']} times for {steps} "
                             f"steps and {n_val} validation batches")
    del trainer
    runs = {"mapnet": dict(r, steps=steps)}
    pp = ROOT / "configs" / "mapnet++_RobotCar.ini"
    inis = {"vo": write_train_ini(tmp, pp, PHASE9_EPOCHS, "mapnetpp_rc"),
            "gps": write_train_ini(tmp, pp, PHASE9_EPOCHS, "mapnetpp_rc_gps",
                                   vo_lib="gps")}
    for name, mode, extra in (
            ("f32_k1", "vo", []),
            ("bf16_k5", "vo", ["--bf16", "--steps_per_launch",
                               str(PHASE8_K)]),
            ("gps_bf16_k5", "gps", ["--bf16", "--steps_per_launch",
                                    str(PHASE8_K)])):
        trainer, r = run_train_cli(
            base + ["--model", "mapnet++", "--config_file", str(inis[mode]),
                    "--checkpoint", str(ckpt), "--device_cache",
                    "--suffix", f"_{name}"] + extra, tmp)
        steps = sum(e["steps"] for e in trainer.epoch_stats)
        logdir = tmp / trainer.logdir
        records = [json.loads(ln) for ln in
                   (logdir / "metrics.jsonl").read_text().splitlines()]
        losses = [x["loss"] for x in records]
        if not (losses and np.isfinite(losses).all()):
            raise AssertionError(f"{name}: non-finite losses {losses}")
        if r["k4"] != steps:     # do_val = no: one launch a step
            raise AssertionError(f"{name}: K4 ran {r['k4']} times for "
                                 f"{steps} steps")
        start = torch.load(logdir / "epoch_000.pth.tar", map_location="cpu",
                           weights_only=False)["model_state_dict"]
        mapnet = torch.load(ckpt, map_location="cpu",
                            weights_only=False)["model_state_dict"]
        if not all(torch.equal(v, start[k]) for k, v in mapnet.items()):
            raise AssertionError(f"{name}: did not start from the MapNet "
                                 f"checkpoint")
        srq = trainer.train_criterion.srq.item()
        if mode == "gps" and srq != -3.0:
            raise AssertionError(f"{name}: srq moved to {srq} in GPS mode")
        # epoch 1 captures the K-step graph: steady from epoch 2
        r.update(steady(trainer, first=2), upload_secs=trainer.upload_secs,
                 steps=steps, graphs=trainer.graph_launches(), srq=srq,
                 frames=int(trainer._train_frames.shape[0]),
                 epoch_secs=[round(e["secs"], 3)
                             for e in trainer.epoch_stats])
        r["busy_share"] = profile_epoch(trainer)
        print(f"phase 9 (b) {name} ({card}): MapNet++ train "
              f"{r['images_per_s']:.1f} images/s (2T = 6 frames an item, "
              f"{r['step_ms']:.2f} ms a step of "
              f"{6 * trainer.config.batch_size} frames) over epochs 2-"
              f"{PHASE9_EPOCHS - 1} (epoch seconds {r['epoch_secs']}), "
              f"loader wait {r['data_share']:.4f} of the "
              f"train time, card busy {r['busy_share']:.3f} of a profiled "
              f"epoch, peak memory {r['peak_gib']:.3f} GiB (cache of "
              f"{r['frames']} mosaics included), upload "
              f"{r['upload_secs']:.2f} s, wall {r['wall']:.2f} s; K4 ran "
              f"{r['k4']} times = {steps} steps (counted at launch or "
              f"capture {r['k4_counted']}, graphs {r['graphs']}); losses "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; srq {srq}")
        runs[name] = dict(r, final=logdir / f"epoch_{PHASE9_EPOCHS:03d}"
                                            f".pth.tar")
        del trainer
        torch.cuda.empty_cache()

    # the fine-tuned weights through MapNet+PGO on the test split
    cuda_image.launches = 0
    t0 = time.time()
    res = cli_eval.main([
        "--dataset", "RobotCar", "--scene", "loop", "--model", "mapnet++",
        "--trunk", "resnet34", "--raw_bayer", "--val", "--pose_graph",
        "--weights", str(runs["f32_k1"]["final"]), "--batch_size", "20",
        "--config_file", str(ROOT / "configs" / "pgo_inference_RobotCar.ini"),
        "--data_path", str(root / "deepslam"),
        "--asset_root", str(root / "assets")])
    wall = time.time() - t0
    launches = cuda_image.launches
    n_batches = -(-res["pred_poses"].shape[0] // 20)
    errors = [res[k] for k in ("median_t", "mean_t", "median_q", "mean_q")]
    print(f"phase 9 (b) eval --model mapnet++ --pose_graph "
          f"(pgo_inference_RobotCar.ini, 7-frame windows, stereo VO): "
          f"{res['pred_poses'].shape[0]} tuples, wall {wall:.2f} s, "
          f"{res['images_per_sec']:.1f} images/s, PGO {res['pgo_secs']:.2f} "
          f"s; errors {errors}; K4 launches {launches} for {n_batches} "
          f"batches")
    if not np.isfinite(errors).all():
        raise AssertionError("non-finite errors after MapNet++ + PGO")
    if launches != n_batches:
        raise AssertionError(f"K4 ran {launches} times for {n_batches} eval "
                             f"batches")
    runs["eval"] = dict(k4=launches, wall=wall, errors=errors)
    return runs


def check_mapnetpp_graph(root: Path, pp_config) -> dict:
    """Phase 9 (c): one ``KLaunch`` of K MapNet++ steps (a CUDA graph)
    against K eager steps from the same state and batches, on the RobotCar
    cache of both splits at full width (float32, dropout drawn on the card
    from the update count), under ``cudnn.deterministic``."""
    from geomapnet_tpu_torch.cli import builders
    from geomapnet_tpu_torch.data.device_cache import (
        IndexLoader,
        upload_dataset_frames,
    )
    from geomapnet_tpu_torch.train.loop import KLaunch

    K = PHASE8_K
    assets = str(root / "assets")
    ds, _ = builders.build_datasets(
        "mapnet++", "RobotCar", "loop", str(root / "deepslam" / "RobotCar"),
        pp_config, asset_root=assets, raw_bayer=True)
    cache = upload_dataset_frames(ds, torch.device("cuda"))
    loader = IndexLoader(ds, pp_config.batch_size, shuffle=True,
                         seed=pp_config.seed)
    batches = []
    while len(batches) < 2 * K:     # an epoch may hold fewer than 2K
        batches += [(idx, poses) for idx, poses, _ in loader]
    batches = batches[:2 * K]
    idx_k = np.stack([b[0] for b in batches[K:]])
    poses_k = np.stack([b[1] for b in batches[K:]])
    torch.backends.cudnn.deterministic = True
    try:
        pre = builders.build_raw_device_preprocess("loop", assets)
        model, crit, step = train_setup(pp_config, device="cuda",
                                        preprocess=pre,
                                        model_name="mapnet++")
        launch = KLaunch(lambda i, p, f: step(i, p, seed=SEED, frames=f), K,
                         torch.device("cuda"))
        launch(np.stack([b[0] for b in batches[:K]]),
               np.stack([b[1] for b in batches[:K]]), cache)
        tensors = cache_state_tensors(model, crit, step)
        start = {k: t.detach().clone() for k, t in tensors.items()}
        g_losses = launch(idx_k, poses_k, cache)
        graph_state = {k: t.detach().clone() for k, t in tensors.items()}
        with torch.no_grad():
            for k, t in tensors.items():
                t.copy_(start[k])
        e_losses = torch.stack([
            step(torch.from_numpy(i).cuda(), torch.from_numpy(p).cuda(),
                 seed=SEED, frames=cache) for i, p in zip(idx_k, poses_k)])
        torch.cuda.synchronize()
        rel = float(((g_losses - e_losses).abs() / e_losses.abs()).max())
        worst, where, bitwise = state_gap(graph_state,
                                          cache_state_tensors(model, crit,
                                                              step))
        bitwise = bitwise and torch.equal(g_losses, e_losses)
    finally:
        torch.backends.cudnn.deterministic = False
    per = launch.per_replay["demosaic_half_normalize"]
    print(f"phase 9 (c): MapNet++ K={K} graph vs {K} eager steps "
          f"({idx_k.shape[1]} items x {idx_k.shape[2]} frames, cache of "
          f"{cache.shape[0]} mosaics): losses rel {rel}, largest state gap "
          f"{worst} ({where}; {len(tensors)} tensors), bit-equal {bitwise}; "
          f"K4 per replay {per}; losses "
          f"{[round(float(v), 4) for v in g_losses]}")
    if not (rel <= TRAIN_TOL and worst <= TRAIN_TOL and per == K):
        raise AssertionError("the MapNet++ K-step graph differs from K "
                             "eager steps")
    del cache, model, crit, step, launch
    torch.cuda.empty_cache()
    return dict(rel=rel, worst=worst, bitwise=bitwise)


def check_mapnetpp_7scenes(tmp: Path, mapnet_ckpt: Path) -> dict:
    """Phase 9 (d): 7Scenes MapNet++ with DSO targets (configs/
    mapnet++_7Scenes.ini: skip 77, no duplicates) from phase 7's MapNet
    checkpoint, on a generated scene whose test split covers the skip."""
    root = write_7scenes_scene(tmp / "7scenes_pp", PHASE9_7S_TEST,
                               n_train=100)
    write_dso_vo(root, PHASE9_7S_TEST)
    ini = write_train_ini(tmp, ROOT / "configs" / "mapnet++_7Scenes.ini", 1,
                          "mapnetpp_7s")
    trainer, r = run_train_cli([
        "--dataset", "7Scenes", "--scene", "heads", "--model", "mapnet++",
        "--trunk", "resnet34", "--config_file", str(ini), "--checkpoint",
        str(mapnet_ckpt), "--device_cache", "--learn_beta", "--learn_gamma",
        "--data_path", str(root / "deepslam"),
        "--asset_root", str(root / "assets")], tmp)
    ds = trainer.train_loader.dataset
    losses = [json.loads(ln)["loss"] for ln in
              (tmp / trainer.logdir / "metrics.jsonl").read_text()
              .splitlines()]
    st = trainer.epoch_stats[-1]
    idx = np.stack([ds.get_indices(i) for i in range(len(ds))])
    unlab = idx[:, 3:] - len(ds.train_set.dset)
    distinct = bool((np.diff(unlab, axis=1) == 77).all())
    print(f"phase 9 (d) 7Scenes MapNet++ (DSO, skip 77): {len(ds)} items, "
          f"{st['steps']} steps, device cache {trainer.device_cache} "
          f"({trainer._train_frames.shape[0]} frames, upload "
          f"{trainer.upload_secs:.2f} s), {st['images'] / st['secs']:.1f} "
          f"train images/s, unlabeled frames 77 apart (no repeats) "
          f"{distinct}; losses {losses}")
    if not (st["steps"] >= 1 and losses and np.isfinite(losses).all()
            and distinct and trainer.device_cache):
        raise AssertionError("7Scenes MapNet++ failed")
    return dict(st, upload_secs=trainer.upload_secs)


def write_camera_lut(d: Path, h: int = 960, w: int = 1280) -> Path:
    """The stereo centre camera's model files (the SDK's layout): the
    intrinsics and a distortion LUT of smooth barrel distortion (each
    output pixel samples a point up to 4% nearer the centre) with the
    seed's sub-pixel noise."""
    d.mkdir(parents=True, exist_ok=True)
    np.savetxt(d / "stereo_narrow_left.txt",
               np.asarray([[983.0, 983.0, w / 2, h / 2]]))
    rng = np.random.RandomState(SEED + 92)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = (h - 1) / 2, (w - 1) / 2
    k = 1.0 - 0.08 * (((yy - cy) / h) ** 2 + ((xx - cx) / w) ** 2)
    lut = np.stack([(cx + (xx - cx) * k + rng.uniform(-0.2, 0.2, (h, w)))
                    .ravel(),
                    (cy + (yy - cy) * k + rng.uniform(-0.2, 0.2, (h, w)))
                    .ravel()])
    lut.tofile(d / "stereo_narrow_left_distortion_lut.bin")
    return d


def check_camera_models(root: Path, tmp: Path, config_file: Path,
                        card: str) -> dict:
    """Phase 9 (e): ``--camera_models_dir``: the undistortion pipeline
    (full demosaic, LUT undistortion, resize, normalize as torch ops) on
    the card against the CPU, its time per 60-frame batch beside K4's path,
    and one train epoch and one eval through the CLIs; K4 never runs."""
    from geomapnet_tpu_torch.cli import builders
    from geomapnet_tpu_torch.cli import eval as cli_eval
    from geomapnet_tpu_torch.ops import cuda_image

    models = write_camera_lut(tmp / "camera_models")
    assets = str(root / "assets")
    undist = builders.build_raw_device_preprocess(
        "loop", assets, camera_models_dir=str(models))
    plain = builders.build_raw_device_preprocess("loop", assets)
    raw = torch.from_numpy(np.random.RandomState(SEED + 93).randint(
        0, 256, (MAIN_FRAMES, 960, 1280), dtype=np.uint8))
    cuda_image.launches = 0
    cpu = undist(raw[:4])
    gpu = undist(raw[:4].cuda()).cpu()
    gap = float((gpu - cpu).abs().max())
    if cuda_image.launches:
        raise AssertionError("K4 ran under --camera_models_dir")
    raw_gpu = raw.cuda()
    ms = cuda_ms(lambda: undist(raw_gpu), reps=5, groups=3)
    k4_ms = cuda_ms(lambda: plain(raw_gpu), reps=5, groups=3)
    peaks = {}
    for n in (MAIN_FRAMES, 2 * MAIN_FRAMES):
        batch = raw_gpu.repeat(2, 1, 1)[:n]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        undist(batch)
        torch.cuda.synchronize()
        peaks[n] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        del batch
    print(f"phase 9 (e) ({card}): undistortion pipeline card vs CPU (4 "
          f"frames): max abs gap {gap} (bound 1e-5); {MAIN_FRAMES} frames "
          f"960x1280 -> 256x341: {ms:.3f} ms (CUDA events) against "
          f"{k4_ms:.3f} ms through K4 and the matmul resize; peak memory "
          f"above the input {peaks[MAIN_FRAMES]:.3f} GiB for "
          f"{MAIN_FRAMES} frames, {peaks[2 * MAIN_FRAMES]:.3f} GiB for "
          f"{2 * MAIN_FRAMES}")
    if gap > 1e-5:
        raise AssertionError("the undistortion pipeline on the card differs "
                             "from the CPU's")
    del raw_gpu
    torch.cuda.empty_cache()
    ini = write_train_ini(tmp, config_file, 1, "mapnet_cam")
    argv = ["--dataset", "RobotCar", "--scene", "loop", "--model", "mapnet",
            "--trunk", "resnet34", "--raw_bayer", "--camera_models_dir",
            str(models), "--config_file", str(ini),
            "--data_path", str(root / "deepslam"), "--asset_root", assets]
    trainer, r = run_train_cli(argv + ["--device_cache"], tmp)
    st = trainer.epoch_stats[-1]
    losses = [json.loads(ln)["loss"] for ln in
              (tmp / trainer.logdir / "metrics.jsonl").read_text()
              .splitlines()]
    cuda_image.launches = 0
    res = cli_eval.main(argv + [
        "--val", "--batch_size", "20",
        "--weights", str(tmp / trainer.logdir / "epoch_001.pth.tar")])
    errors = [res[k] for k in ("median_t", "mean_t", "median_q", "mean_q")]
    print(f"phase 9 (e) CLI --camera_models_dir: train "
          f"{st['images'] / st['secs']:.1f} images/s ({st['steps']} steps), "
          f"peak memory {r['peak_gib']:.3f} GiB, K4 {r['k4']}; eval "
          f"{res['images_per_sec']:.1f} images/s, errors {errors}, K4 "
          f"{cuda_image.launches}")
    if r["k4"] or cuda_image.launches or not (
            np.isfinite(losses).all() and np.isfinite(errors).all()):
        raise AssertionError("--camera_models_dir run failed")
    return dict(ms=ms, k4_ms=k4_ms, gap=gap, peaks=peaks,
                train_images_per_s=st["images"] / st["secs"])

# ---------------------------------------------------------------- phase 10


def check_native_decoder(p4: dict, rc_root: Path, upload8: dict,
                         card: str) -> dict:
    """Phase 10 (a): the native decoder built from this checkout with g++.
    Where it builds: decode ms per frame at 1, 4 and all threads against
    PIL's decode + resize, the ``--native_loader`` eval and
    ``--device_cache --native_loader`` upload (frames byte-equal to the
    native decode on the CPU), and phase 8's 400 mosaics through
    ``decode_batch_gray``. Where it does not (no libpng / libjpeg headers),
    ``--native_loader`` must fail with the compiler's message: the JAX
    package's contract, no PIL in its place."""
    import os

    from geomapnet_tpu_torch import native
    from geomapnet_tpu_torch.cli import eval as cli_eval
    from geomapnet_tpu_torch.data.sevenscenes import SevenScenes
    from geomapnet_tpu_torch.data.transforms import ImageTransform
    from geomapnet_tpu_torch.native import build as native_build

    print("native decoder: " + " ".join(
        native_build.command(native_build.library_path())))
    t0 = time.time()
    try:
        native_build.build()
        error = None
    except native_build.BuildError as e:
        error = str(e)
    build_secs = time.time() - t0
    if error is not None:
        first = error.strip().splitlines()[0]
        print(f"native decoder: g++ failed after {build_secs:.2f} s")
        print(f"native decoder: not buildable on this host: {first}")
        if native.available():
            raise AssertionError("the library loaded after a failed build")
        for extra in ([], ["--device_cache"]):
            try:
                cli_eval.main(p4["argv"] + ["--native_loader"] + extra)
            except RuntimeError as e:
                if first not in str(e):
                    raise AssertionError(f"--native_loader failed with "
                                         f"another message: {e}") from e
                print(f"--native_loader {' '.join(extra)}: refused with the "
                      f"compiler's message (no PIL in its place)")
            else:
                raise AssertionError("--native_loader ran without the "
                                     "native decoder")
        return {"buildable": False, "error": first}
    if not native.available():
        raise AssertionError(f"built, but not loadable: "
                             f"{native.build_error()}")
    print(f"native decoder: built in {build_secs:.2f} s, batch-read backend "
          f"{native.io_backend()} ({card})")
    data = p4["root"] / "deepslam" / "7Scenes"
    assets = p4["root"] / "assets" / "7Scenes"
    paths = SevenScenes("heads", str(data), train=False,
                        asset_dir=str(assets)).c_imgs
    out = {"buildable": True, "backend": native.io_backend()}
    for threads in (1, 4, os.cpu_count()):
        t0 = time.time()
        frames, ok = native.decode_batch(paths, 256, 341, n_threads=threads)
        ms = (time.time() - t0) / len(paths) * 1e3
        if not ok.all():
            raise AssertionError("native decode flagged frames")
        out[f"native_ms_{threads}"] = ms
        print(f"native decode + resize 480x640 -> 256x341, {threads} "
              f"threads: {ms:.3f} ms a frame ({len(paths)} frames)")
    pil = SevenScenes("heads", str(data), train=False, asset_dir=str(assets),
                      transform=ImageTransform(resize=256, keep_uint8=True))
    n = 100
    t0 = time.time()
    pil.get_images(list(range(n)))
    out["pil_ms"] = (time.time() - t0) / n * 1e3
    print(f"PIL decode + resize (the loader's transform): "
          f"{out['pil_ms']:.3f} ms a frame ({n} frames)")
    a = p4["runs"]["a_loader_f32"]
    loader = cli_eval.main(p4["argv"] + ["--native_loader"])
    cache = cli_eval.main(p4["argv"] + ["--native_loader", "--device_cache"])
    for name, res in (("loader", loader), ("device cache", cache)):
        if not np.isfinite(res["pred_poses"]).all():
            raise AssertionError(f"--native_loader {name}: non-finite poses")
    got = cache["device_frames"].cpu().numpy()
    if not np.array_equal(got, frames):
        raise AssertionError("uploaded frames differ from the native decode "
                             "on the CPU")
    b = p4["runs"]["b_cache_f32"]
    print(f"--native_loader loader f32: {loader['images_per_sec']:.1f} "
          f"images/s (phase 4 (a), PIL: {a['images_per_sec']:.1f}); "
          f"--device_cache upload {cache['upload_secs']:.2f} s (phase 4 "
          f"(b): {b['upload_secs']:.2f} s), frames byte-equal to the CPU "
          f"decode; median translation {loader['median_t']:.4f} (PIL "
          f"{a['median_t']:.4f}) ({card})")
    mosaics = sorted((rc_root / "deepslam" / "RobotCar" / "loop").glob(
        "*/stereo/centre/*.png"))
    t0 = time.time()
    _, ok = native.decode_batch_gray(mosaics, 960, 1280,
                                     n_threads=os.cpu_count())
    secs = time.time() - t0
    if not ok.all():
        raise AssertionError("mosaics flagged")
    print(f"{len(mosaics)} RobotCar mosaics through decode_batch_gray: "
          f"{secs:.2f} s (phase 8 uploads {upload8}) ({card})")
    out.update(loader=loader["images_per_sec"], upload=cache["upload_secs"],
               mosaic_secs=secs)
    return out


def _int8_activations(infer, x) -> tuple:
    """The artifact's int8 activations in graph order (the pooled stem
    (K2), each block's residual conv (K1)) and its poses."""
    acts = []

    class Capture(torch.fx.Interpreter):
        def call_function(self, target, args, kwargs):
            res = super().call_function(target, args, kwargs)
            if target is torch.ops.geomapnet.int8_maxpool3x3s2.default or (
                    target is torch.ops.geomapnet.int8_conv.default
                    and args[8] == "residual"):
                acts.append(res)
            return res

    with torch.inference_mode():
        poses = Capture(infer.module).run(x)
    return poses, acts


def _in_process_activations(net, preprocess, x) -> tuple:
    """The in-process fused forward's pooled stem and block outputs."""
    from geomapnet_tpu_torch.models import quant

    acts = []
    pool, block = quant.int8_maxpool3x3s2, quant._fused_basic_block
    quant.int8_maxpool3x3s2 = lambda *a: acts.append(pool(*a)) or acts[-1]
    quant._fused_basic_block = \
        lambda *a: acts.append(block(*a)) or acts[-1]
    try:
        with torch.inference_mode():
            poses = quant.mapnet_apply_int8(net, preprocess(x), fused=True)
    finally:
        quant.int8_maxpool3x3s2, quant._fused_basic_block = pool, block
    return poses, acts


def check_serving(p4: dict, npz: Path, config, rc_root: Path, tmp: Path,
                  card: str) -> dict:
    """Phase 10 (b)-(d): serving artifacts (``geomapnet_tpu_torch.serving``)
    of MapNet ResNet-34 at 256x341 with the uint8 normalize fused, float32,
    bf16 and the int8 serving configuration; a raw-Bayer artifact (the
    demosaic kernel's operator inside); ``cli.tools`` export_model and
    time_imload. Returns the kernels' launches in this phase's artifacts."""
    from geomapnet_tpu_torch import serving
    from geomapnet_tpu_torch.cli import builders
    from geomapnet_tpu_torch.cli import tools as cli_tools
    from geomapnet_tpu_torch.data.robotcar import RobotCar
    from geomapnet_tpu_torch.models import quant
    from geomapnet_tpu_torch.models.flax_import import (
        load_npz,
        state_dict_to_variables,
        variables_to_state_dict,
    )
    from geomapnet_tpu_torch.ops import cuda_image, cuda_quant

    B, T = config.batch_size, config.steps
    assets = str(p4["root"] / "assets")
    frames = p4["runs"]["b_cache_f32"]["device_frames"]   # (500, 256, 341, 3)
    variables = load_npz(str(npz))

    def mapnet(dtype):
        model, _ = builders.build_model("mapnet", config, trunk="resnet34",
                                        dtype=dtype)
        model.posenet.load_state_dict(variables_to_state_dict(variables))
        return model.to(device="cuda",
                        memory_format=torch.channels_last).eval()

    def tuples(b):
        return frames.narrow(0, 0, b * T).view(b, T, *frames.shape[1:])

    def export_load(name, model, **kw):
        t0 = time.time()
        blob = serving.export_inference(model, None, (T, 256, 341, 3),
                                        dtype=torch.uint8, **kw)
        export_s = time.time() - t0
        path = tmp / f"{name}.pt2"
        path.write_bytes(blob)
        t0 = time.time()
        infer = serving.load_inference(path, "cuda")
        torch.cuda.synchronize()
        print(f"artifact {name}: export {export_s:.2f} s, "
              f"{len(blob) / 2 ** 20:.1f} MB, load on the card "
              f"{time.time() - t0:.2f} s")
        return infer, path

    def zero():
        cuda_image.launches = 0
        for k in cuda_quant.launches:
            cuda_quant.launches[k] = 0

    counts = {"K4": 0, "int8_conv": 0, "int8_maxpool3x3s2": 0}

    def count():
        counts["K4"] += cuda_image.launches
        counts["int8_conv"] += cuda_quant.launches["int8_conv"]
        counts["int8_maxpool3x3s2"] += cuda_quant.launches[
            "int8_maxpool3x3s2"]

    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model = mapnet(dtype)
        pre = builders.build_device_preprocess("7Scenes", "heads", assets,
                                               dtype=dtype)
        infer, path = export_load(
            name, model, preprocess=pre,
            platforms=("cuda", "cpu") if name == "f32" else None)
        for b in (1, 7, 20):
            x = tuples(b)
            with torch.inference_mode():
                want = model(pre(x)).float().cpu().numpy()
            got = infer(x).float().cpu().numpy()
            scale = float(np.abs(want[..., :3]).max())
            gap = float(np.abs(got - want).max())
            tol = 1e-5 if name == "f32" else BF16_TOL
            print(f"artifact {name} batch {b}: max abs diff to the eager "
                  f"model {gap} = {gap / scale} of the largest translation "
                  f"(bound {tol}), bit-identical {np.array_equal(got, want)}")
            if got.shape != (b, T, 6) or gap > tol * scale:
                raise AssertionError(f"artifact {name} disagrees")
        if name == "f32":
            cpu = serving.load_inference(path, "cpu")
            x1 = tuples(1)
            got_cpu = cpu(x1.cpu()).numpy()
            card_out = infer(x1).cpu().numpy()
            rel = float(np.abs(got_cpu - card_out).max()
                        / np.abs(card_out[..., :3]).max())
            print(f"artifact f32 loaded on the CPU, batch 1: {rel} of the "
                  f"largest translation from the card's (bound 1e-4)")
            if rel > 1e-4:
                raise AssertionError("the CPU load disagrees")
            del cpu
        x60 = tuples(B)
        with torch.inference_mode():
            art_ms = cuda_ms(lambda: infer(x60), reps=5, groups=3)
            eager_ms = cuda_ms(lambda: model(pre(x60)), reps=5, groups=3)
        out[name] = dict(ms=art_ms, eager_ms=eager_ms)
        print(f"artifact {name}: {art_ms:.3f} ms a {B * T}-frame batch, "
              f"eager {eager_ms:.3f} ms (CUDA events) ({card})")
        del infer, model

    # int8: the serving configuration, calibrated on 2 batches
    model = mapnet(torch.float32)
    pre = builders.build_device_preprocess("7Scenes", "heads", assets)
    calib = [pre(frames.narrow(0, i * B * T, B * T).view(B, T,
                                                         *frames.shape[1:]))
             for i in range(CALIBRATE)]
    infer, _ = export_load("int8_fused", model, preprocess=pre,
                           quantize=True, calib_data=calib,
                           quantize_heads=True, fuse_requant=True)
    qtree = quant.calibrate_activation_scales(
        quant.quantize_posenet_variables(
            state_dict_to_variables(model.posenet.state_dict()),
            tuple(model.posenet.feature_extractor.stage_sizes),
            quantize_heads=True), calib)
    net = quant.QuantizedPoseNet(qtree, torch.bfloat16, fused=True).cuda()
    for b in (1, 7, 20):
        x = tuples(b)
        zero()
        got, acts = _int8_activations(infer, x)
        n_k1, n_k2 = (cuda_quant.launches["int8_conv"],
                      cuda_quant.launches["int8_maxpool3x3s2"])
        count()
        if (n_k1, n_k2) != (36, 1):
            raise AssertionError(f"int8 artifact launched K1 {n_k1} and K2 "
                                 f"{n_k2} times in a forward")
        want, ref = _in_process_activations(net, pre, x)
        if len(acts) != len(ref) or not all(
                torch.equal(a, r) for a, r in zip(acts, ref)):
            raise AssertionError("int8 activations differ from the "
                                 "in-process fused forward")
        got, want = got.cpu().numpy(), want.cpu().numpy()
        gap = float(np.abs(got - want).max())
        scale = float(np.abs(want[..., :3]).max())
        print(f"artifact int8_fused batch {b}: {len(acts)} int8 activations "
              f"bit-equal to the in-process fused forward; poses {gap} = "
              f"{gap / scale} of the largest translation (bound 1e-6); K1 "
              f"{n_k1}, K2 {n_k2} launches")
        if gap > 1e-6 * scale:
            raise AssertionError("int8 artifact poses disagree")
        # the call itself: this shape's CUDA graph, captured and replayed
        graphed, launched = [], []
        for _ in range(2):
            zero()
            graphed.append(infer(x))
            launched.append((cuda_quant.launches["int8_conv"],
                             cuda_quant.launches["int8_maxpool3x3s2"]))
            count()
        equal = [torch.equal(g.cpu(), torch.from_numpy(got))
                 for g in graphed]
        print(f"artifact int8_fused batch {b}, the call (CUDA graph): "
              f"bit-equal to the run node by node at the capture "
              f"{equal[0]}, at a replay {equal[1]}; K1, K2 launches at the "
              f"capture {launched[0]}, at a replay {launched[1]}")
        if not all(equal) or launched != [(72, 2), (0, 0)]:
            raise AssertionError("int8 artifact's CUDA graph")
    x60 = tuples(B)
    with torch.inference_mode():
        art_ms = cuda_ms(lambda: infer(x60), reps=5, groups=3)
        eager_ms = cuda_ms(
            lambda: quant.mapnet_apply_int8(net, pre(x60), fused=True),
            reps=5, groups=3)
    out["int8_fused"] = dict(ms=art_ms, eager_ms=eager_ms)
    print(f"artifact int8_fused: {art_ms:.3f} ms a {B * T}-frame batch, "
          f"eager {eager_ms:.3f} ms (CUDA events) ({card})")
    del infer, net

    # (c) a raw-Bayer artifact: the demosaic kernel's operator inside
    raw_pre = builders.build_raw_device_preprocess(
        "loop", str(rc_root / "assets"))
    mosaics = RobotCar("loop", str(rc_root / "deepslam" / "RobotCar"),
                       train=False, raw_bayer=True,
                       asset_dir=str(rc_root / "assets" / "RobotCar")
                       ).get_images(list(range(2 * T)))
    raw = torch.from_numpy(np.stack(mosaics)).view(2, T, 960, 1280).cuda()
    t0 = time.time()
    blob = serving.export_inference(model, None, (T, 960, 1280),
                                    dtype=torch.uint8, preprocess=raw_pre)
    infer = serving.load_inference(blob, "cuda")
    print(f"artifact raw_bayer: export + load {time.time() - t0:.2f} s")
    # the first call of a shape runs the forward twice from the host (the
    # warm-up and the CUDA graph's capture); a later call replays the graph
    zero()
    got = infer(raw)
    k4 = cuda_image.launches
    count()
    zero()
    replayed = infer(raw)
    k4_replay = cuda_image.launches
    with torch.inference_mode():
        want = model(raw_pre(raw))
    gap = float((got - want).abs().max() / want[..., :3].abs().max())
    print(f"artifact raw_bayer, 2 tuples of 960x1280 mosaics: {gap} of the "
          f"largest translation from the eager pipeline + model (bound "
          f"1e-5); K4 launches at the capture {k4}, at a replay {k4_replay}")
    if (k4 != 2 or k4_replay != 0 or gap > 1e-5
            or not torch.equal(replayed, got)):
        raise AssertionError("raw-Bayer artifact")
    del infer

    # (d) the tools CLI on the card: export_model and time_imload
    cli_tools.main([
        "export_model", "--dataset", "7Scenes", "--scene", "heads",
        "--asset_root", assets, "--model", "mapnet", "--trunk", "resnet34",
        "--config_file", str(ROOT / "configs" / "mapnet.ini"),
        "--weights", str(npz), "--output", str(tmp / "tools.pt2")])
    tools_art = serving.load_inference(tmp / "tools.pt2")
    f32 = serving.load_inference(tmp / "f32.pt2")
    x = tuples(2)
    gap = float((tools_art(x) - f32(x)).abs().max())
    print(f"tools export_model on the card: {gap} from the f32 artifact")
    if gap > 1e-5 * float(f32(x)[..., :3].abs().max()):
        raise AssertionError("tools export_model disagrees")
    del tools_art, f32
    zero()
    cli_tools.main(["time_imload", "--image", str(sorted(
        (rc_root / "deepslam" / "RobotCar" / "loop").glob(
            "*/stereo/centre/*.png"))[0]), "--number", "8", "--batch", "16"])
    print(f"time_imload: K4 launches {cuda_image.launches} ({card})")
    if cuda_image.launches == 0:
        raise AssertionError("time_imload did not run the demosaic kernel")
    count()
    out["launches"] = counts
    return out


# ---------------------------------------------------------------- phase 11

PHASE11_RANKS = (4, 2, 1)  # rank counts that divide the batch of 20
PHASE11_EPOCHS = 2
# the CPU step tests' rate: at random init, with BatchNorm over a batch,
# float32 noise grows chaotically at 1e-4 (tests/test_torch_train_step.py)
PHASE11_LR = 1e-5
PHASE11_TIMEOUT = 300
TORCHRUN_TIMEOUT = 300
COLLECTIVES = ("all_reduce", "reduce_scatter_tensor",
               "all_gather_into_tensor", "broadcast")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(spec: dict, world: int, local_ranks: list, tmp: Path,
              timeout: float = PHASE11_TIMEOUT) -> list:
    """``world`` processes of ``chip_smoke.py --dp-rank``, each with the
    environment ``torchrun`` gives a rank (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); returns their
    results in rank order. A rank that fails (or a group past ``timeout``)
    stops every rank and raises with the rank's log."""
    import os

    name = spec["name"]
    out = tmp / f"p11_{name}"
    out.mkdir(parents=True, exist_ok=True)
    spec = dict(spec, out=str(out), timeout=timeout)
    (out / "spec.json").write_text(json.dumps(spec))
    port = str(free_port())
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(local_ranks[r]), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, OMP_NUM_THREADS="2",
                   PYTHONUNBUFFERED="1")
        log = out / f"rank{r}.log"
        logs.append(log)
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--dp-rank",
                 str(out / "spec.json")], env=env, stdout=f,
                stderr=subprocess.STDOUT, cwd=str(ROOT)))
    deadline = time.time() + timeout
    failed = None
    while any(p.poll() is None for p in procs):
        bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if bad or time.time() > deadline:
            failed = bad[0] if bad else None
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    codes = [p.returncode for p in procs]
    if failed is None and codes != [0] * world:
        failed = next(r for r, c in enumerate(codes) if c != 0)
    if failed is not None or codes != [0] * world:
        r = 0 if failed is None else failed
        tail = logs[r].read_text()[-3000:]
        raise AssertionError(f"phase 11 {name}: rank exit codes {codes} "
                             f"(timeout {timeout} s); rank {r}'s log:\n"
                             f"{tail}")
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(world)]


def run_torchrun(args: list, nproc: int, cwd: Path, name: str,
                 timeout: float = TORCHRUN_TIMEOUT) -> dict:
    """``torchrun --standalone --nproc_per_node=nproc <args>`` from ``cwd``
    (its own process group, killed whole at ``timeout``); raises on an
    exit code other than 0 or a timeout. Returns the wall time and the
    ranks' output."""
    import os
    import signal

    log = cwd / f"{name}.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONUNBUFFERED="1",
               OMP_NUM_THREADS="2")
    t0 = time.time()
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc_per_node={nproc}", *args], cwd=str(cwd), env=env,
            stdout=f, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = None
    wall = time.time() - t0
    text = log.read_text()
    if rc != 0:
        # a rank's own traceback comes before torchrun's summary
        first = text.find("Traceback (most recent call last)")
        raise AssertionError(f"{name}: torchrun exit code {rc} after "
                             f"{wall:.1f} s (timeout {timeout} s); the "
                             f"first traceback:\n{text[first:first + 4000]}"
                             f"\nlog tail:\n{text[-1500:]}")
    return dict(wall=wall, log=text)


def check_torchrun_clis(W: int, train: list, eval_argv: list, tmp: Path,
                        card: str) -> dict:
    """``cli.train --distributed`` (captured K-step graphs with NCCL
    collectives inside, then the teardown) and ``cli.eval`` under
    ``torchrun --nproc_per_node=W``, as a user launches them: each must
    exit with 0 within its timeout, having left the group itself (no
    "destroy_process_group() was not called" warning)."""
    d = tmp / "p11_torchrun"
    d.mkdir()
    out = {}
    for name, args in (
            ("train", ["-m", "geomapnet_tpu_torch.cli.train",
                       "--distributed", *train]),
            ("eval", ["-m", "geomapnet_tpu_torch.cli.eval", *eval_argv])):
        run = run_torchrun(args, W, d, f"torchrun_{name}")
        if "destroy_process_group() was not called" in run["log"]:
            raise AssertionError(f"torchrun {name}: a rank exited without "
                                 f"leaving the group")
        out[name] = run["wall"]
        print(f"phase 11 torchrun --nproc_per_node={W} cli.{name}: exit 0 "
              f"in {run['wall']:.1f} s, group left by every rank ({card})")
    return out


def _probe_collectives(mesh, device) -> dict:
    """Each collective the port calls, on tensors on ``device``: accepted
    (and its value) or the backend's refusal."""
    W, r = mesh.world_size, mesh.rank
    cases = {
        "all_reduce": (lambda: mesh.all_reduce_(torch.full(
            (8,), float(r + 1), device=device)), float(W * (W + 1) // 2)),
        "reduce_scatter_tensor": (lambda: mesh.reduce_scatter(torch.full(
            (4 * W,), r + 1, dtype=torch.uint8, device=device)),
            W * (W + 1) // 2),
        "all_gather_into_tensor": (lambda: mesh.all_gather(torch.full(
            (4,), r + 1, dtype=torch.uint8, device=device)), None),
        "broadcast": (lambda: mesh.broadcast_(torch.full(
            (8,), float(r + 7), device=device)), 7.0),
    }
    out = {}
    for name, (fn, want) in cases.items():
        try:
            got = fn()
            torch.cuda.synchronize(device)
            vals = got.cpu().tolist()
            ok = (vals == [v for v in range(1, W + 1) for _ in range(4)]
                  if want is None else all(v == want for v in vals))
            out[name] = dict(accepted=True, correct=bool(ok))
        except Exception as e:   # the backend's refusal, reported
            out[name] = dict(accepted=False,
                             error=f"{type(e).__name__}: {str(e)[:200]}")
    return out


def _collective_share(trainer, tmp: Path, name: str,
                      steps: int = 3) -> dict:
    """``steps`` eager data-parallel train steps under ``torch.profiler``:
    the device time of a step, the NCCL kernels' share of it (all-reduce,
    reduce-scatter, all-gather, by kernel name), and the host-side share
    of the steps' wall spent in the c10d collectives (a gloo collective
    runs on the host)."""
    from torch.profiler import ProfilerActivity, profile

    batches = iter(trainer.train_loader)
    idx, poses, _ = next(batches)
    batches.close()     # stops the loader's prefetch thread
    idx, poses = trainer._put(idx, poses, index=True)
    frames = trainer._train_frames
    seed = trainer.config.seed
    trainer.train_step(idx, poses, seed=seed, frames=frames)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_step(idx, poses, seed=seed, frames=frames)
        torch.cuda.synchronize()
    trace = tmp / f"{name}_trace.json"
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    total = sum(e["dur"] for e in kernels)
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"]
                                                         for e in events)
    out = dict(step_device_ms=total / steps / 1e3,
               step_wall_ms=span / steps / 1e3)
    def named(e, tag):   # "ncclDevKernel_AllReduce...", "c10d::allreduce_"
        return tag in e["name"].lower().replace("_", "")

    for key, tag in (("all_reduce", "allreduce"),
                     ("reduce_scatter", "reducescatter"),
                     ("all_gather", "allgather")):
        dev = sum(e["dur"] for e in kernels
                  if "nccl" in e["name"].lower() and named(e, tag))
        host = sum(e["dur"] for e in events if e.get("cat") == "cpu_op"
                   and e["name"].startswith("c10d::") and named(e, tag))
        out[f"{key}_device_share"] = dev / total if total else 0.0
        out[f"{key}_host_share"] = host / span if span else 0.0
    return out


def dp_rank_main(spec_path: str) -> int:
    """One rank of phase 11 (``chip_smoke.py --dp-rank SPEC``, started by
    :func:`run_ranks`): joins the group on the spec's backend, then runs
    the spec's evals and training through the CLIs' ``main()`` and writes
    what the parent checks."""
    import faulthandler
    import os

    sys.path.insert(0, str(ROOT))
    from geomapnet_tpu_torch.cli import eval as cli_eval
    from geomapnet_tpu_torch.cli import train as cli_train
    from geomapnet_tpu_torch.ops import cuda_image, cuda_quant
    from geomapnet_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        shutdown_distributed,
    )

    spec = json.loads(Path(spec_path).read_text())
    out = Path(spec["out"])
    rank = int(os.environ["RANK"])
    # a rank that hangs prints every thread's stack into its log (and
    # exits) before the parent's timeout
    faulthandler.dump_traceback_later(spec.get("timeout", PHASE11_TIMEOUT)
                                      - 15, exit=True)
    device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the phase picks the backend; the CLIs then find the group formed
    initialize_distributed(backend=spec["backend"], device=device,
                           timeout_s=PHASE11_TIMEOUT)
    mesh = make_mesh(device)
    result = dict(rank=rank, world=mesh.world_size, backend=mesh.backend)
    if spec.get("probe"):
        result["probe"] = _probe_collectives(mesh, device)
    for name, argv in spec.get("evals", {}).items():
        for k in cuda_quant.launches:
            cuda_quant.launches[k] = 0
        cuda_image.launches = 0
        t0 = time.time()
        res = cli_eval.main(argv)
        torch.cuda.synchronize()
        result[name] = dict(
            wall=time.time() - t0, images_per_sec=res["images_per_sec"],
            upload_secs=res.get("upload_secs"),
            frames_computed=res.get("frames_computed"),
            dedup_slice=res.get("dedup_slice"),
            rows=list(res["device_frames"].shape),
            launches=dict(cuda_quant.launches, K4=cuda_image.launches))
        np.save(out / f"{name}_rank{rank}.npy", res["pred_poses"])
        del res
        torch.cuda.empty_cache()
    if spec.get("train"):
        # graph and eager steps equal, and the runs comparable, only with
        # cuDNN's deterministic algorithms (phase 8 (a))
        torch.backends.cudnn.deterministic = True
        run_dir = out / "train"
        run_dir.mkdir(exist_ok=True)
        os.chdir(run_dir)
        cuda_image.launches = 0
        t0 = time.time()
        trainer = cli_train.main(spec["train"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        k4 = cuda_image.launches
        graphs = trainer.graph_launches()
        for g in graphs.values():
            per = g["per_replay"].get("demosaic_half_normalize", 0)
            k4 += (g["replays"] - 1) * per
        st = trainer.epoch_stats[1:]
        result["train"] = dict(
            wall=wall, k4=k4, graphs=graphs,
            steps=sum(e["steps"] for e in trainer.epoch_stats),
            val_batches=len(trainer.val_loader) * PHASE11_EPOCHS,
            images_per_s=sum(e["images"] for e in st)
            / sum(e["secs"] for e in st),
            upload_secs=trainer.upload_secs,
            logdir=str(run_dir / trainer.logdir))
        if spec.get("profile"):
            result["train"]["profile"] = _collective_share(
                trainer, out, f"{spec['name']}_rank{rank}")
    (out / f"rank{rank}.json").write_text(json.dumps(result))
    # the rank leaves the group as the CLIs do: its train launches' CUDA
    # graphs dropped (destroy_process_group hangs while a graph that
    # captured an NCCL collective is alive), a barrier, the teardown
    shutdown_distributed(device)
    return 0


def _train_logs(logdir: Path) -> tuple:
    """(train losses by step, final model state) of a run's logdir."""
    records = [json.loads(ln) for ln in
               (logdir / "metrics.jsonl").read_text().splitlines()]
    losses = np.array([r["loss"] for r in records if r["kind"] == "train"])
    last = sorted(logdir.glob("epoch_*.pth.tar"))[-1]
    state = torch.load(last, map_location="cpu", weights_only=False)
    return losses, state["model_state_dict"]


def _train_gaps(a_dir: Path, b_dir: Path, steps: int, what: str) -> dict:
    """Run a's gaps to run b: per-step relative loss gaps, the BatchNorm
    statistics' gap (of each tensor's max-abs) and the parameters' largest
    absolute gap."""
    a_loss, a = _train_logs(a_dir)
    b_loss, b = _train_logs(b_dir)
    if len(a_loss) != len(b_loss) or len(a_loss) != steps:
        raise AssertionError(f"{what}: {len(a_loss)} / {len(b_loss)} "
                             f"logged steps, expected {steps}")
    stats = params = 0.0
    for k, v in b.items():
        if not v.is_floating_point():
            continue
        d = float((a[k].double() - v.double()).abs().max())
        if "running" in k:
            stats = max(stats, d / max(float(v.abs().max()), 1e-30))
        else:
            params = max(params, d)
    return dict(loss=np.abs(a_loss - b_loss) / np.abs(b_loss), stats=stats,
                params=params)


def _compare_train(ranks_dir: Path, one_dir: Path, control_dir: Path,
                   steps: int, what: str) -> dict:
    """The W-rank run against the one-card run on the same global batches.
    tests/test_torch_train_step.py's bounds over its 4 steps: step 1's
    loss within 1e-5 and steps 1-4 within 1e-4 relative; the parameters
    within 2 lr N after all N steps (Adam). Past step 4 the trajectory is
    chaotic at random init (ROADMAP.md Queue 3): the later losses and the
    BatchNorm statistics are held within 10x the gap of a control, the
    one-card run from weights moved by one ulp, as
    ``test_lr_1e4_envelope_of_a_one_ulp_control`` holds the port."""
    g = _train_gaps(ranks_dir, one_dir, steps, what)
    c = _train_gaps(control_dir, one_dir, steps, f"{what} control")
    out = dict(loss1=float(g["loss"][0]), loss4=float(g["loss"][:4].max()),
               loss=float(g["loss"].max()), stats=g["stats"],
               params=g["params"], params_bound=2 * PHASE11_LR * steps,
               control_loss=float(c["loss"].max()),
               control_stats=c["stats"])
    print(f"phase 11 (b) {what} vs one card: step-1 loss {out['loss1']:.3g}"
          f", steps 1-4 {out['loss4']:.3g}, all {steps} steps "
          f"{out['loss']:.3g} relative (one-ulp control "
          f"{out['control_loss']:.3g}); BatchNorm statistics "
          f"{out['stats']:.3g} of their max-abs (control "
          f"{out['control_stats']:.3g}); parameters {out['params']:.3g} "
          f"(bound {out['params_bound']:.3g})")
    if not (out["loss1"] <= 1e-5 and out["loss4"] <= 1e-4
            and out["params"] <= out["params_bound"]
            and out["loss"] <= max(1e-4, 10 * out["control_loss"])
            and out["stats"] <= max(1e-4, 10 * out["control_stats"])):
        raise AssertionError(f"{what}: outside the train-step bounds {out}")
    return out


def check_data_parallel(p4: dict, root: Path, tmp: Path, config_file: Path,
                        card: str, f32_k1: float, gloo: bool = True) -> dict:
    """Phase 11: data-parallel eval and training over ``torch.distributed``
    through the CLIs, one rank per card (NCCL), the CLIs under torchrun,
    and (``gloo``) two gloo ranks on one card where gloo takes CUDA
    tensors. ``f32_k1``: phase 8's one-card float32 K=1 train images/s."""

    t_phase = time.time()
    n_cards = torch.cuda.device_count()
    W = next(w for w in PHASE11_RANKS if w <= n_cards)
    serving = ["--quantize", "int8", "--calibrate", str(CALIBRATE),
               "--quantize_heads", "--fuse_requant"]
    evals = {"f32_shard": p4["argv"] + ["--device_cache", "shard"],
             "int8_shard": p4["argv"] + ["--device_cache", "shard"]
             + serving}
    # no dropout: the W-rank global batch holds the one-card run's samples
    # in another row order (ranks take strided slices), and a keep-mask
    # row follows the row, not the sample (in the JAX package too)
    ini = write_train_ini(tmp, config_file, PHASE11_EPOCHS, "mapnet_dp",
                          print_freq=1, lr=PHASE11_LR, dropout=0.0)
    # every run starts from the same seeded weights (--checkpoint: the
    # weights only), the group's from rank 0's
    from geomapnet_tpu_torch.cli import builders
    from geomapnet_tpu_torch.cli.config import parse_ini

    torch.manual_seed(SEED)
    model, _ = builders.build_model("mapnet", parse_ini(ini),
                                    trunk="resnet34")
    init = tmp / "p11_init.pth.tar"
    torch.save({"model_state_dict": model.state_dict()}, init)
    # the control's start: every float weight moved by one ulp
    ulp = tmp / "p11_init_ulp.pth.tar"
    torch.save({"model_state_dict": {
        k: torch.nextafter(v, torch.full_like(v, float("inf")))
        if v.is_floating_point() else v
        for k, v in model.state_dict().items()}}, ulp)
    del model
    train = ["--dataset", "RobotCar", "--scene", "loop", "--model",
             "mapnet", "--trunk", "resnet34", "--raw_bayer",
             "--checkpoint", str(init),
             "--learn_beta", "--learn_gamma", "--config_file", str(ini),
             "--data_path", str(root / "deepslam"),
             "--asset_root", str(root / "assets"),
             "--steps_per_launch", str(PHASE8_K)]
    one_b = p4["runs"]["b_cache_f32"]["pred_poses"]
    one_e = p4["runs"]["e_cache_int8_fused"]["pred_poses"]

    def check_evals(ranks: list, what: str, tmp_out: Path) -> dict:
        rates = {}
        for name, one, exact in (("f32_shard", one_b, False),
                                 ("int8_shard", one_e, True)):
            poses = [np.load(tmp_out / f"{name}_rank{r}.npy")
                     for r in range(len(ranks))]
            for r, p in enumerate(poses[1:], 1):
                if not np.array_equal(p, poses[0]):
                    raise AssertionError(f"{what} {name}: rank {r}'s poses "
                                         f"differ from rank 0's")
            # translations against the largest |translation|; the random
            # weights' log-q outputs are O(1e2-1e3) rad, so a 1e-7 relative
            # change turns their unit quaternions by ~1e-4 (reported only)
            scale = float(np.abs(one[:, :3]).max())
            gap = float(np.abs(poses[0][:, :3] - one[:, :3]).max()) / scale
            qgap = float(np.abs(poses[0][:, 3:] - one[:, 3:]).max())
            same = np.array_equal(poses[0], one)
            runs = [rk[name] for rk in ranks]
            print(f"phase 11 (a) {what} {name}: "
                  f"{runs[0]['images_per_sec']:.1f} images/s, wall "
                  f"{runs[0]['wall']:.2f} s, upload "
                  f"{runs[0]['upload_secs']:.2f} s, rows a rank "
                  f"{runs[0]['rows']}, frames_computed "
                  f"{runs[0]['frames_computed']}; vs the one-rank eval: "
                  f"translations {gap} of the largest, quaternions {qgap}, "
                  f"bit-equal {same}; launches by rank "
                  f"{[r['launches'] for r in runs]}")
            if exact:
                # the int8 trunk is exact at any batch, and the heads run on
                # the all-gathered features of the whole window, the batch
                # the one-rank eval gives them
                if not same:
                    raise AssertionError(f"{what} {name}: int8 poses off "
                                         f"the one-rank eval's by {gap}")
            elif gap > 1e-5:
                raise AssertionError(f"{what} {name}: translations off by "
                                     f"{gap} of the largest")
            if name == "int8_shard":
                sites = 36
                windows = runs[0]["frames_computed"] // MAIN_FRAMES
                for r, run in enumerate(runs):
                    want = sites * (windows + CALIBRATE)
                    if (run["launches"]["int8_conv"] != want or
                            run["launches"]["int8_maxpool3x3s2"] != windows):
                        raise AssertionError(
                            f"{what} rank {r}: K1/K2 launches "
                            f"{run['launches']}, expected {want} / "
                            f"{windows}")
            rates[name] = runs[0]["images_per_sec"]
        return rates

    def check_train(ranks: list, what: str, refs: tuple) -> dict:
        runs = [rk["train"] for rk in ranks]
        for r, run in enumerate(runs):
            if run["k4"] != run["steps"] + run["val_batches"]:
                raise AssertionError(
                    f"{what} rank {r}: K4 ran {run['k4']} times for "
                    f"{run['steps']} steps and {run['val_batches']} "
                    f"validation batches")
        gaps = _compare_train(Path(runs[0]["logdir"]), *refs,
                              runs[0]["steps"], what)
        print(f"phase 11 (b) {what}: train {runs[0]['images_per_s']:.1f} "
              f"images/s over epoch 2 (all ranks), upload "
              f"{runs[0]['upload_secs']:.2f} s, wall {runs[0]['wall']:.2f} "
              f"s; K4 by rank {[r['k4'] for r in runs]} (graphs "
              f"{runs[0]['graphs']}); profile "
              f"{runs[0].get('profile')}")
        return dict(images_per_s=runs[0]["images_per_s"], gaps=gaps,
                    k4=sum(r["k4"] for r in runs),
                    profile=runs[0].get("profile"))

    one_rate = {}

    def one_card(argv: list, name: str) -> tuple:
        """The same training on one card without a group (the same global
        batches), and its one-ulp control, under deterministic cuDNN;
        their logdirs."""
        dirs = []
        torch.backends.cudnn.deterministic = True
        try:
            for tag, start in (("", init), ("_ulp", ulp)):
                d = tmp / f"p11_{name}{tag}"
                d.mkdir()
                argv_ = [str(start) if a == str(init) else a for a in argv]
                trainer, _ = run_train_cli(argv_ + ["--device_cache"], d)
                dirs.append(d / trainer.logdir)
                one_rate.setdefault("f32", steady(trainer)["images_per_s"])
                del trainer
                torch.cuda.empty_cache()
        finally:
            torch.backends.cudnn.deterministic = False
        return tuple(dirs)

    refs = one_card(train, "one")

    # the NCCL group: one rank per card, every phase at once
    t0 = time.time()
    ranks = run_ranks(dict(name="nccl", backend="nccl", evals=evals,
                           train=train + ["--distributed", "--device_cache",
                                          "shard"], profile=True),
                      W, list(range(W)), tmp)
    nccl_wall = time.time() - t0
    rates = check_evals(ranks, f"NCCL W={W}", tmp / "p11_nccl")
    trained = check_train(ranks, f"NCCL W={W}", refs)
    launches = {k: sum(rk[n]["launches"][k] for rk in ranks
                       for n in evals)
                for k in ("int8_conv", "int8_maxpool3x3s2")}
    launches["K4"] = trained["k4"]
    one = one_rate["f32"]
    print(f"phase 11 (b) NCCL W={W} train {trained['images_per_s']:.1f} "
          f"images/s (all ranks, K={PHASE8_K}) = "
          f"{trained['images_per_s'] / one:.3f}x the one-card run of the "
          f"same configuration ({one:.1f}) and "
          f"{trained['images_per_s'] / f32_k1:.3f}x phase 8's one-card "
          f"float32 K=1 ({f32_k1:.1f}) ({card})")
    out = dict(W=W, backend="nccl", wall=nccl_wall, eval_rates=rates,
               train=trained, launches=launches, one_card=one)

    # the CLIs as a user launches them, one epoch, then the group's teardown
    cli_ini = write_train_ini(tmp, config_file, 1, "mapnet_dp_cli",
                              lr=PHASE11_LR, dropout=0.0)
    cli_train = [a if a != str(ini) else str(cli_ini) for a in train]
    rc_eval = ["--dataset", "RobotCar", "--scene", "loop", "--model",
               "mapnet", "--trunk", "resnet34", "--raw_bayer", "--val",
               "--weights", str(init), "--config_file", str(config_file),
               "--batch_size", "20", "--data_path", str(root / "deepslam"),
               "--asset_root", str(root / "assets"), "--device_cache",
               "shard"]
    out["torchrun"] = check_torchrun_clis(
        W, cli_train + ["--device_cache", "shard"], rc_eval, tmp, card)

    if gloo:
        # two gloo ranks sharing card 0: used only if gloo takes CUDA tensors
        # for every collective the port calls (nothing is staged on the host)
        probe = run_ranks(
            dict(name="gloo_probe", backend="gloo", probe=True), 2, [0, 0],
            tmp, timeout=120)[0]["probe"]
        refused = [k for k in COLLECTIVES if not probe[k]["accepted"]]
        print(f"phase 11: gloo on CUDA tensors (2 ranks, card 0): "
              f"{ {k: v['accepted'] for k, v in probe.items()} }; refused "
              f"{[(k, probe[k]['error']) for k in refused]}")
        if any(v["accepted"] and not v["correct"] for v in probe.values()):
            raise AssertionError(f"gloo on CUDA gave a wrong result: "
                                 f"{probe}")
        out["gloo_cuda"] = {k: v["accepted"] for k, v in probe.items()}
        if not refused:
            on0 = ["--device", "cuda:0"]
            ranks = run_ranks(dict(
                name="gloo", backend="gloo",
                evals={k: v + on0 for k, v in evals.items()},
                # gloo collectives cannot be captured: eager steps
                train=train[:-2] + ["--distributed", "--device_cache",
                                    "shard"] + on0, profile=True),
                2, [0, 0], tmp)
            check_evals(ranks, "gloo W=2", tmp / "p11_gloo")
            for k in ("int8_conv", "int8_maxpool3x3s2"):
                out["launches"][k] += sum(rk[n]["launches"][k]
                                          for rk in ranks for n in evals)
            out["launches"]["K4"] += sum(rk["train"]["k4"] for rk in ranks)
            # the K=5 references hold for eager steps too: under
            # deterministic cuDNN a graph of K steps equals K eager steps
            # bit for bit (phase 8 (a))
            out["gloo"] = check_train(ranks, "gloo W=2", refs)
    out["wall"] = time.time() - t_phase
    print(f"phase 11: W={W} ({card}), backend nccl, wall "
          f"{out['wall']:.2f} s (NCCL group {nccl_wall:.2f} s); (a) "
          f"images/s {rates}; (b) train images/s "
          f"{trained['images_per_s']:.1f}; collectives' share of a step "
          f"{trained['profile']}; launches {out['launches']}; gloo on CUDA "
          f"{out.get('gloo_cuda', 'not probed')}"
          + (f"; gloo W=2 train images/s {out['gloo']['images_per_s']:.1f},"
             f" collectives' share {out['gloo']['profile']}"
             if "gloo" in out else ""))
    return out


# ---------------------------------------------------------------- phase 12

PHASE12_RANKS = 4
PHASE12_REPEATS = 5
PHASE12_TIMEOUT = 300


def check_grid(tmp: Path, card: str) -> dict:
    """Phase 12: ``dryrun_multichip(4)`` under ``torchrun``: four NCCL
    ranks, one a card, where four cards are visible, else four gloo ranks
    sharing card 0 (not the four-card check). Every leg must pass its bars
    (the dry run raises otherwise: the serving artifact's K1 and K2 calls
    against their plain versions too) and K1 and K2 must launch in the
    serving artifact on every rank. Returns the launches summed over the
    ranks."""
    n = PHASE12_RANKS
    nccl = torch.cuda.device_count() >= n
    out = tmp / "p12"
    out.mkdir()
    what = (f"{n} NCCL ranks, one a card" if nccl else
            f"{n} gloo ranks sharing card 0 ({torch.cuda.device_count()} "
            f"card(s) visible; not the four-card check)")
    # the package's entry point, as a user launches it; each rank sets the
    # kernels' counters to 0 just before the dry run and writes them
    run = run_torchrun(["-m", "geomapnet_tpu_torch.dryrun", "--repeats",
                        str(PHASE12_REPEATS), "--out", str(out)]
                       + ([] if nccl else ["--device", "cuda:0",
                                           "--backend", "gloo"]),
                       n, out, "p12_torchrun", timeout=PHASE12_TIMEOUT)
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(n)]
    for line in ranks[0]["lines"]:
        print(f"phase 12 {line}")
    legs = ranks[0]["legs"]
    print(f"phase 12 checks ({what}): tp loss {legs['tp']['loss_gap']:.3g} "
          f"relative, gradients {legs['tp']['grad_relnorm']:.3g} relative "
          f"norm (worst {legs['tp']['worst']}); spatial eval "
          f"{legs['spatial']['gap']:.3g}; pp2 forward "
          f"{legs['pp2']['gap']:.3g}; pp2-train loss "
          f"{legs['pp2-train']['loss_gap']:.3g} gradient "
          f"{legs['pp2-train']['grad_gap']:.3g}; dp2xpp2-train loss "
          f"{legs['dp2xpp2-train']['loss_gap']:.3g} gradient "
          f"{legs['dp2xpp2-train']['grad_gap']:.3g}; scan2 graph "
          f"{legs['dp-devicecache-scan2-train']['graph']}; serving: int8 "
          f"calls bit-equal to the plain versions by rank "
          f"{[r['legs']['serving-artifact-dp']['int8_calls'] for r in ranks]}"
          f", poses off the CPU load by "
          f"{[r['legs']['serving-artifact-dp']['gap'] for r in ranks]}")
    steps = {k: round(legs[k]["step_ms"], 3) for k in
             ("dp", "tp", "pp2-train", "dp2xpp2-train")}
    print(f"phase 12 step ms (mean of {PHASE12_REPEATS}, rank 0): {steps}; "
          f"leg seconds {({k: round(v['seconds'], 2) for k, v in legs.items()})}"
          f"; torchrun wall {run['wall']:.1f} s ({card})")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ("int8_conv", "int8_maxpool3x3s2")}
    for r, rk in enumerate(ranks):
        if not (rk["launches"]["int8_conv"] and
                rk["launches"]["int8_maxpool3x3s2"]):
            raise AssertionError(f"phase 12 rank {r}: K1/K2 did not launch "
                                 f"in the serving artifact: "
                                 f"{rk['launches']}")
    print(f"phase 12: K1/K2 launches by rank "
          f"{[rk['launches'] for rk in ranks]}")
    return launches


VIDLOC_N, VIDLOC_T = 4, 20   # phase 13: sequences x frames of VidLoc
VIDLOC_HIDDEN = 512
SALIENCY_FRAMES = 50
# The saliency on the card (cuDNN deterministic, no TF32) against the CPU
# on one batch, relative to the batch's largest saliency value. In float64
# (the model converted by .double()) the two compute the same function to
# rounding: SALIENCY_F64_TOL. In float32, the path plot_activations runs,
# the input gradient of this random ResNet-34 is ill-conditioned at a few
# pixels: where a max-pool window's largest inputs nearly tie or a ReLU's
# input is near zero, the summation order flips which input takes the
# gradient, so float32 is held to SALIENCY_TOL at the worst pixel, and the
# phase prints the CPU's own two conv backends (oneDNN, native) against
# each other beside the card's gap as the yardstick.
SALIENCY_F64_TOL = 1e-9
SALIENCY_TOL = 1e-1


def seeded_vidloc_variables(model) -> dict:
    """Numpy-seeded variables in the Flax layout of the VidLoc ``model``
    (``state_dict_to_variables`` gives the tree: the trunk, the
    ``lstm_fwd`` / ``lstm_bwd`` cells, ``fc_pose``): He-scaled kernels,
    biases around 0, BatchNorm scale and running variance in [0.5, 1.5]."""
    from geomapnet_tpu_torch.models.flax_import import state_dict_to_variables

    rng = np.random.RandomState(SEED + 13)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = rng.randn(*v.shape) * np.sqrt(2.0 / fan_in)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape)
            else:
                out[k] = rng.randn(*v.shape) * 0.1
            if not isinstance(v, dict):
                out[k] = np.asarray(out[k], np.float32)
        return out

    return fill(state_dict_to_variables(model.state_dict()))


def scale_lstm_inputs(variables: dict, feats: torch.Tensor) -> dict:
    """``variables`` with the LSTM's input kernels rescaled to a standard
    deviation of 1 / (sqrt(F) * rms(feats)): the gates' pre-activations
    then have about unit variance on these trunk features, the cell's
    working range (the random trunk's features are far from unit size)."""
    rms = float(feats.float().pow(2).mean().sqrt())
    f = feats.shape[-1]
    out = {**variables, "params": dict(variables["params"])}
    for cell in ("lstm_fwd", "lstm_bwd"):
        gates = dict(out["params"][cell])
        for g in "ifgo":
            k = gates[f"i{g}"]["kernel"]
            gates[f"i{g}"] = {"kernel": (k / k.std() / (np.sqrt(f) * rms)
                                         ).astype(np.float32)}
        out["params"][cell] = gates
    return out


def check_vidloc(card: str) -> dict:
    """Phase 13 (a): VidLoc at full width (ResNet-34 trunk, hidden 512,
    bidirectional) on 4 sequences of 20 raw 960x1280 GBRG mosaics through
    the raw-Bayer device pipeline (K4, the matmul resize to 256x341), in
    float32 and bf16, the weights numpy-seeded in the Flax layout and
    carried across by the weight bridge; K4 against its plain version on
    these frames; the model and one train step on the card against the
    CPU on a small input. Returns K4's launches in the main path."""
    from geomapnet_tpu_torch.cli import builders
    from geomapnet_tpu_torch.losses.criterion import PoseNetCriterion
    from geomapnet_tpu_torch.models import VidLoc, resnet34
    from geomapnet_tpu_torch.models.flax_import import variables_to_state_dict
    from geomapnet_tpu_torch.ops import cuda_image
    from geomapnet_tpu_torch.train.optim import make_optimizer
    from geomapnet_tpu_torch.train.state import make_train_step

    t0 = time.time()
    n, t = VIDLOC_N, VIDLOC_T
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    raw = torch.randint(0, 256, (n, t, 960, 1280), dtype=torch.uint8,
                        device="cuda", generator=gen)
    pipes = {dt: builders.build_raw_device_preprocess(
        "loop", str(ROOT / "data"), dtype=dt)
        for dt in (torch.float32, torch.bfloat16)}

    # K4 on these frames against its plain version (not counted below)
    stats = np.loadtxt(ROOT / "data" / "RobotCar" / "loop" / "stats.txt")
    from geomapnet_tpu_torch.data.transforms import std_from_stats

    mean, std = (tuple(float(v) for v in a) for a in std_from_stats(stats))
    flat = raw.reshape(n * t, 960, 1280)
    k4 = cuda_image.demosaic_half_normalize(flat, mean, std,
                                            dtype=torch.float32, planar=True)
    plain = cuda_image.demosaic_half_normalize_reference(
        flat, mean, std, torch.float32, True)
    if not torch.equal(k4, plain):
        raise AssertionError("K4 differs from its plain version on the "
                             "VidLoc frames")
    print(f"phase 13 K4 on {n * t} mosaics: bit-equal to its plain version")
    del k4, plain

    model = VidLoc(resnet34(), hidden_size=VIDLOC_HIDDEN)
    variables = seeded_vidloc_variables(model)
    model.load_state_dict(variables_to_state_dict(variables))
    model.cuda().eval()
    with torch.inference_mode():
        x32 = pipes[torch.float32](raw)
        feats = model.feature_extractor(x32.reshape((n * t,) + x32.shape[2:]))
    variables = scale_lstm_inputs(variables, feats)
    models = {}
    for dt in (torch.float32, torch.bfloat16):
        m = VidLoc(resnet34(dt), hidden_size=VIDLOC_HIDDEN, dtype=dt)
        m.load_state_dict(variables_to_state_dict(variables))
        models[dt] = m.to("cuda", memory_format=torch.channels_last).eval()
    print(f"phase 13 VidLoc (ResNet-34, hidden {VIDLOC_HIDDEN}, "
          f"bidirectional): weights through the bridge, trunk feature rms "
          f"{float(feats.pow(2).mean().sqrt()):.4g}; set-up "
          f"{time.time() - t0:.2f} s")
    del x32, feats

    # the main path: mosaics -> K4 pipeline -> VidLoc, float32 and bf16
    cuda_image.launches = 0
    poses = {}
    with torch.inference_mode():
        for dt, m in models.items():
            poses[dt] = m(pipes[dt](raw)).float().cpu().numpy()
    launches = cuda_image.launches
    p32, p16 = poses[torch.float32], poses[torch.bfloat16]
    for dt, p in poses.items():
        if p.shape != (n, t, 6) or not np.isfinite(p).all():
            raise AssertionError(f"VidLoc {dt} poses {p.shape}, finite "
                                 f"{np.isfinite(p).all()}")
    rel = float(np.abs(p16 - p32).max() / np.abs(p32).max())
    print(f"phase 13 VidLoc poses {p32.shape}: bf16 vs f32 {rel} of the "
          f"largest |pose| {float(np.abs(p32).max())} (bound {BF16_TOL}); "
          f"K4 launches {launches}")
    if not 0 < rel <= BF16_TOL or launches != 2:
        raise AssertionError(f"bf16 off by {rel}, or K4 launched {launches} "
                             f"times for 2 forwards")

    # timing: the forward on preprocessed frames, and the train step
    out = {}
    for dt, m in models.items():
        with torch.inference_mode():
            x = pipes[dt](raw)
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: m(x), reps=5, groups=3)
        out[str(dt).replace("torch.", "")] = ms
        print(f"phase 13 VidLoc forward {dt}, {n}x{t} frames 256x341: {ms} "
              f"ms (CUDA events) = {n * t / ms * 1e3:.1f} images/s; peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
              f"({card})")
        del x
    m = models[torch.float32]
    crit = PoseNetCriterion(saq=-3.0, learn_beta=True).cuda()
    opt = make_optimizer("adam", 1e-4, m, crit, 5e-4)
    step = make_train_step(m, crit, opt, pipes[torch.float32])
    y = torch.randn(n, t, 6, device="cuda", generator=gen) * 0.1
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(raw, y), reps=3, groups=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = float(step(raw, y))
    print(f"phase 13 VidLoc train step f32 (K4 preprocess, Adam), {n}x{t} "
          f"frames: {ms} ms (CUDA events) = {n * t / ms * 1e3:.1f} train "
          f"images/s; peak {peak:.3f} GiB; loss {loss:.4f} ({card})")
    if not np.isfinite(loss):
        raise AssertionError("non-finite VidLoc train loss")
    out.update(step_ms=ms, peak_gib=peak)
    del models, step, opt, m
    torch.cuda.empty_cache()

    check_vidloc_card_vs_cpu(variables)
    print(f"phase 13 (a): {time.time() - t0:.2f} s")
    return dict(launches=launches, **out)


def check_vidloc_card_vs_cpu(variables: dict) -> None:
    """Phase 13 (a): the same VidLoc on the card and on the CPU, on 2
    sequences of 4 frames at 64x96: the forward within 1e-4, and one f32
    Adam train step (an injected dropout mask) within ``TRAIN_TOL``: the
    loss relative, the gradients of the LSTM, ``fc_pose`` and the
    criterion and every BatchNorm running statistic of each tensor's
    max-abs."""
    from geomapnet_tpu_torch.losses.criterion import PoseNetCriterion
    from geomapnet_tpu_torch.models import VidLoc, resnet34
    from geomapnet_tpu_torch.models.flax_import import variables_to_state_dict
    from geomapnet_tpu_torch.train.optim import make_optimizer
    from geomapnet_tpu_torch.train.state import make_train_step

    rng = np.random.RandomState(SEED + 14)
    x = torch.from_numpy(rng.randn(2, 4, 64, 96, 3).astype(np.float32))
    y = torch.from_numpy((rng.randn(2, 4, 6) * 0.1).astype(np.float32))
    mask = torch.from_numpy(rng.rand(8, 512) >= 0.5)
    fwd, res = {}, {}
    for dev in ("cpu", "cuda"):
        m = VidLoc(resnet34(), hidden_size=VIDLOC_HIDDEN)
        m.load_state_dict(variables_to_state_dict(variables))
        m.to(dev).eval()
        with torch.inference_mode():
            fwd[dev] = m(x.to(dev)).cpu().numpy()
        crit = PoseNetCriterion(saq=-3.0, learn_beta=True).to(dev)
        opt = make_optimizer("adam", 1e-4, m, crit, 5e-4)
        step = make_train_step(m, crit, opt)
        loss = float(step(x.to(dev), y.to(dev), keep_masks=[mask.to(dev)]))
        grads = {f"crit.{k}": p.grad for k, p in crit.named_parameters()}
        grads.update({k: p.grad for k, p in m.named_parameters()
                      if k.startswith(("lstm.", "fc_pose."))})
        stats = {k: v for k, v in m.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        res[dev] = (loss, {k: v.detach().cpu().double()
                           for k, v in {**grads, **stats}.items()})
    gap = float(np.abs(fwd["cuda"] - fwd["cpu"]).max())
    print(f"phase 13 VidLoc small-input forward, card vs CPU: max abs diff "
          f"{gap}, scale {float(np.abs(fwd['cpu']).max())}")
    np.testing.assert_allclose(fwd["cuda"], fwd["cpu"], rtol=1e-4, atol=1e-4)
    (l_cpu, t_cpu), (l_gpu, t_gpu) = res["cpu"], res["cuda"]
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    worst = max((float((t_gpu[k] - v).abs().max()
                       / max(float(v.abs().max()), 1e-30)), k)
                for k, v in t_cpu.items())
    print(f"phase 13 VidLoc train step, card vs CPU (2x4x64x96, injected "
          f"dropout): loss {l_gpu} vs {l_cpu}, rel {rel}; largest gradient/"
          f"BN-statistic gap {worst[0]} of its tensor's max-abs ({worst[1]};"
          f" {len(t_cpu)} tensors; bound {TRAIN_TOL})")
    if not (rel <= TRAIN_TOL and worst[0] <= TRAIN_TOL):
        raise AssertionError("the VidLoc train step on the card differs "
                             "from the CPU's")


def check_saliency(scene_root: Path, npz: Path, tmp: Path,
                   card: str) -> float:
    """Phase 13 (b): ``cli.plot_activations`` on phase 4's 7Scenes scene
    (MapNet, ResNet-34, ``--frames 50``) must write 50 frames; the card's
    saliency on one 2-tuple batch against the CPU's within
    ``SALIENCY_TOL`` of its largest value; ms a batch of 8 tuples.
    Returns that time."""
    from geomapnet_tpu_torch.cli import builders
    from geomapnet_tpu_torch.cli import plot_activations as pa
    from geomapnet_tpu_torch.cli.config import parse_ini
    from geomapnet_tpu_torch.train.checkpoint import load_weights

    config_file = ROOT / "configs" / "mapnet.ini"
    t0 = time.time()
    written = pa.main([
        "--dataset", "7Scenes", "--scene", "heads", "--model", "mapnet",
        "--trunk", "resnet34", "--config_file", str(config_file), "--val",
        "--weights", str(npz), "--frames", str(SALIENCY_FRAMES),
        "--output_dir", str(tmp / "saliency"),
        "--data_path", str(scene_root / "deepslam"),
        "--asset_root", str(scene_root / "assets")])
    wall = time.time() - t0
    print(f"phase 13 plot_activations: {len(written)} files "
          f"({written[0].name} ...) in {wall:.2f} s")
    # 50 PNG frames, or one video of them where imageio writes one
    if len(written) != (1 if written[0].suffix == ".mp4"
                        else SALIENCY_FRAMES):
        raise AssertionError(f"{len(written)} saliency files written")

    config = parse_ini(config_file)
    _, val_set = builders.build_datasets(
        "mapnet", "7Scenes", "heads", str(scene_root / "deepslam" / "7Scenes"),
        config, asset_root=str(scene_root / "assets"))
    batch = np.stack([val_set[i][0] for i in range(8)])
    sal = {}
    deterministic = torch.backends.cudnn.deterministic
    mkldnn = torch.backends.mkldnn.enabled
    torch.backends.cudnn.deterministic = True
    try:
        for name, dev, dtype, onednn in (
                ("cpu", "cpu", torch.float32, True),
                ("cpu_native", "cpu", torch.float32, False),
                ("card", "cuda", torch.float32, True),
                ("cpu64", "cpu", torch.float64, True),
                ("card64", "cuda", torch.float64, True)):
            torch.backends.mkldnn.enabled = onednn
            model, _ = builders.build_model("mapnet", config,
                                            trunk="resnet34", dtype=dtype)
            load_weights(npz, model)
            model.to(dev, dtype, memory_format=torch.channels_last)
            sal[name] = pa.saliency_fn(model)(
                torch.from_numpy(batch[:2]).to(dev, dtype)).cpu().numpy()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.mkldnn.enabled = mkldnn

    def gap(a, b):
        d = np.abs(sal[a] - sal[b]) / np.abs(sal[b]).max()
        return float(d.max()), float((d > 1e-3).mean())

    (rel, share), (rel64, _) = gap("card", "cpu"), gap("card64", "cpu64")
    print(f"phase 13 saliency on 2 tuples, card vs CPU, relative to the "
          f"largest value: float64 {rel64} (bound {SALIENCY_F64_TOL}); "
          f"float32 {rel} at the worst pixel (bound {SALIENCY_TOL}), {share}"
          f" of the pixels beyond 1e-3; the CPU's native conv backend vs "
          f"its oneDNN one (float32): {gap('cpu_native', 'cpu')}; the "
          f"float32 saliency vs float64: card {gap('card', 'cpu64')}, CPU "
          f"{gap('cpu', 'cpu64')}")
    if not (sal["card"].shape == (2, 3, 256, 341) and rel <= SALIENCY_TOL
            and rel64 <= SALIENCY_F64_TOL):
        raise AssertionError(f"saliency {sal['card'].shape}, off by {rel} "
                             f"(float32) and {rel64} (float64)")
    model, _ = builders.build_model("mapnet", config, trunk="resnet34")
    load_weights(npz, model)
    model.to("cuda", memory_format=torch.channels_last)
    fn = pa.saliency_fn(model)
    x = torch.from_numpy(batch).cuda()
    ms = cuda_ms(lambda: fn(x), reps=3, groups=3)
    with torch.inference_mode():
        fwd = cuda_ms(lambda: model(x), reps=3, groups=3)
    print(f"phase 13 saliency, a batch of 8 tuples (24 frames 256x341): "
          f"{ms} ms (CUDA events), {ms / fwd:.2f}x the forward's {fwd} ms "
          f"({card})")
    return ms


def check_dashboard(logdir: Path) -> None:
    """Phase 13 (c): the dashboard over a Trainer's logdir serves its page
    and its rows."""
    import threading
    import urllib.request

    from geomapnet_tpu_torch.utils.dashboard import make_server

    rows = [json.loads(ln) for ln in
            (logdir / "metrics.jsonl").read_text().splitlines()]
    srv = make_server(logdir.parent, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        page = urllib.request.urlopen(f"{base}/", timeout=30).read().decode()
        data = json.loads(urllib.request.urlopen(
            f"{base}/data?exp={logdir.name}", timeout=30).read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    print(f"phase 13 dashboard: page {len(page)} bytes, experiment "
          f"{data['exp']}, {len(data['rows'])} rows of {len(rows)}")
    if "Criterion parameters" not in page or data["rows"] != rows \
            or not rows:
        raise AssertionError("the dashboard did not serve the logdir's rows")


def check_optional_packages(eval_argv: list, tmp: Path) -> dict:
    """Phase 13 (d): the eval CLI's ``--output_dir`` (the ``.png`` only
    where matplotlib imports, else the skip line) and ``cli.train
    --tensorboard`` (an event file where the package is installed, else a
    refusal at start naming it). Returns the branch each took."""
    import contextlib
    import io
    import os

    from geomapnet_tpu_torch.cli import eval as cli_eval
    from geomapnet_tpu_torch.cli import train as cli_train

    def has(name):
        try:
            importlib.import_module(name)
        except ImportError:
            return False
        return True

    out_dir = tmp / "p13_eval"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_eval.main(eval_argv + ["--output_dir", str(out_dir)])
    text = buf.getvalue()
    names = sorted(p.name for p in out_dir.iterdir())
    stem = "7Scenes_heads_mapnet"
    want = [f"{stem}.pkl", f"{stem}_metrics.json"]
    if has("matplotlib"):
        want = sorted(want + [f"{stem}.png"])
    elif "png skipped: the trajectory plot needs matplotlib" not in text:
        raise AssertionError("no skip line for the trajectory plot")
    if names != want:
        raise AssertionError(f"--output_dir wrote {names}, expected {want}")
    branches = {"matplotlib": has("matplotlib")}
    tensorboard = has("torch.utils.tensorboard")
    print(f"phase 13 eval --output_dir: {names} (matplotlib "
          f"{'installed' if has('matplotlib') else 'missing: skip line'})")

    ini = write_train_ini(tmp, ROOT / "configs" / "mapnet.ini", 1, "p13_tb")
    argv = ["--dataset", "synth", "--model", "mapnet", "--trunk", "resnet18",
            "--config_file", str(ini), "--tensorboard"]
    cwd = Path.cwd()
    os.chdir(tmp)
    err = io.StringIO()
    try:
        if tensorboard:
            trainer = cli_train.main(argv)
            events = list((tmp / trainer.logdir / "tb").glob("events.*"))
            if not events:
                raise AssertionError("--tensorboard wrote no event file")
            print(f"phase 13 train --tensorboard: {events[0].name}")
        else:
            with contextlib.redirect_stderr(err):
                try:
                    cli_train.main(argv)
                except SystemExit as e:
                    code = e.code
                else:
                    raise AssertionError("--tensorboard ran without the "
                                         "tensorboard package")
            message = err.getvalue().strip().splitlines()[-1]
            print(f"phase 13 train --tensorboard without the package: exit "
                  f"{code}: {message}")
            if code != 2 or "needs the tensorboard package" not in message:
                raise AssertionError("--tensorboard did not name the package")
    finally:
        os.chdir(cwd)
    branches["tensorboard"] = tensorboard
    return branches


def check_phase13(scene_root: Path, eval_argv: list, npz: Path,
                  logdir: Path, tmp: Path, card: str) -> dict:
    """Phase 13: VidLoc (a), saliency (b), the dashboard (c) and the
    optional packages (d). Returns (a)'s numbers (K4's launches among
    them) and (b)'s ms a batch."""
    t0 = time.time()
    vid = check_vidloc(card)
    vid["saliency_ms"] = check_saliency(scene_root, npz, tmp, card)
    check_dashboard(logdir)
    branches = check_optional_packages(eval_argv, tmp)
    print(f"phase 13: {time.time() - t0:.2f} s; VidLoc forward ms "
          f"f32 {vid['float32']} bf16 {vid['bfloat16']}, step "
          f"{vid['step_ms']} ms, peak {vid['peak_gib']:.3f} GiB; saliency "
          f"{vid['saliency_ms']} ms a batch; packages {branches} ({card})")
    return vid


LSTM_WINDOW, LSTM_FEATURES, LSTM_HIDDEN = 200, 512, 512
# the kernel against its plain loop and cuDNN: float32 sums in three
# orders over 200 dependent steps (tests/test_torch_lstm_kernel.py)
LSTM_TOL = 1e-5
LSTM_SOURCE = "geomapnet_tpu_torch/csrc/lstm_persistent.cu"
FP32_FLOP_PER_S = 67e12


# the floor of csrc/lstm_persistent.cu's steps: its grid (D x H/U CTAs of
# U warps, launched cooperatively) and its exchange of h (a 64-bit (value,
# step) word a unit, two slots by step parity, read until both of a
# thread's words carry the step), with one barrier a step and no
# arithmetic but a dependence on another CTA's h
EXCHANGE_PROBE = r"""
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256, 1)
    exchange_probe(unsigned long long* xch, float* out, int T, int H, int U) {
  __shared__ float hbuf[2][512];
  const int ctas = H / U, dir = blockIdx.x / ctas;
  const int j = (blockIdx.x - dir * ctas) * U + (threadIdx.x >> 5);
  xch += (size_t)dir * 2 * H;
  float h = 0.f;
  for (int i = 0; i < T; ++i) {
    if (i > 0) {
      const unsigned long long* slot = xch + (size_t)((i - 1) & 1) * H;
      for (int p = threadIdx.x; 2 * p < H; p += blockDim.x) {
        unsigned long long w0, w1;
        long long spins = 0;
        do {
          if (++spins > (1ll << 24)) __trap();
          asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
                       : "=l"(w0), "=l"(w1) : "l"(slot + 2 * p));
        } while ((unsigned)(w0 >> 32) != (unsigned)i ||
                 (unsigned)(w1 >> 32) != (unsigned)i);
        hbuf[(i - 1) & 1][2 * p] = __uint_as_float((unsigned)w0);
        hbuf[(i - 1) & 1][2 * p + 1] = __uint_as_float((unsigned)w1);
      }
      __syncthreads();
      h = 0.5f * hbuf[(i - 1) & 1][(j + 1) % H] + 0.25f;
    }
    if ((threadIdx.x & 31) == 0)
      asm volatile("st.volatile.global.u64 [%0], %1;" ::"l"(
                       xch + (size_t)(i & 1) * H + j),
                   "l"(((unsigned long long)(i + 1) << 32) |
                       __float_as_uint(h))
                   : "memory");
  }
  if ((threadIdx.x & 31) == 0) out[dir * H + j] = h;
}

extern "C" int gm_exchange_probe(unsigned long long* xch, float* out, int T,
                                 int H, int D, int U, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(D * (H / U));
  cfg.blockDim = dim3(32 * U);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, exchange_probe, xch, out, T, H,
                                       U);
  return err != cudaSuccess ? err : cudaGetLastError();
}
"""


def exchange_floor_ms(T: int, H: int, units: int) -> float:
    """Graph-replay ms of ``EXCHANGE_PROBE`` over T steps of two
    directions of H units (``units`` a CTA), with its slots' memset."""
    import ctypes

    from geomapnet_tpu_torch.ops import _nvcc

    with tempfile.TemporaryDirectory(prefix="exchange_probe_") as d:
        src, lib = Path(d) / "exchange_probe.cu", Path(d) / "probe.so"
        src.write_text(EXCHANGE_PROBE)
        subprocess.run([_nvcc.tool(), *_nvcc.NVCC_FLAGS, "-o", str(lib),
                        str(src)], check=True, capture_output=True)
        fn = ctypes.CDLL(str(lib)).gm_exchange_probe
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    out = torch.empty(2 * H, device="cuda")

    def probe():
        xch = torch.zeros((2, 2, H), dtype=torch.int64, device="cuda")
        err = fn(xch.data_ptr(), out.data_ptr(), T, H, 2, units,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"exchange probe: cudaError_t {err}")

    return graph_ms(probe)


def check_lstm(card: str) -> dict:
    """Phase 14: the persistent LSTM kernel at the stream's shape against
    its plain loop and cuDNN, its time beside its floor, its bound, the
    plain loop's and cuDNN's, then the stream session's main path. Returns
    the kernel's row of the result line."""
    import math

    from geomapnet_tpu_torch.ops import _nvcc, cuda_rnn

    t0 = time.time()
    lines = [ln.strip() for ln in _nvcc.build_log(cuda_rnn.SOURCE).splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    print("lstm_persistent ptxas:\n  " + "\n  ".join(lines))
    T, F, H = LSTM_WINDOW, LSTM_FEATURES, LSTM_HIDDEN
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 20)
    params = []
    for _ in range(2):
        q, r = torch.linalg.qr(torch.randn((4, H, H), generator=gen,
                                           device=dev))
        q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
        params += [torch.randn((4 * H, F), generator=gen, device=dev)
                   / math.sqrt(F), q.reshape(4 * H, H).contiguous(),
                   0.1 * torch.randn(4 * H, generator=gen, device=dev),
                   0.1 * torch.randn(4 * H, generator=gen, device=dev)]
    x = torch.randn((1, T, F), generator=gen, device=dev)
    h0 = torch.zeros((2, 1, H), device=dev)

    def kernel():
        return cuda_rnn.lstm(x, params, True)

    def cudnn():
        return torch.lstm(x, (h0, h0), params, True, 1, 0.0, False, True,
                          True)[0]

    got = kernel()
    torch.cuda.synchronize()
    err_plain = float((got - cuda_rnn.lstm_reference(x, params, True)
                       ).abs().max())
    err_cudnn = float((got - cudnn()).abs().max())
    print(f"lstm_persistent: max abs diff against the plain loop "
          f"{err_plain:.3e}, against cuDNN {err_cudnn:.3e} (h in (-1, 1))")
    if max(err_plain, err_cudnn) > LSTM_TOL:
        raise AssertionError(f"lstm_persistent off by {err_plain}, "
                             f"{err_cudnn} > {LSTM_TOL}")
    if not torch.equal(kernel(), got):
        raise AssertionError("lstm_persistent: two calls differ")
    ms = graph_ms(kernel)
    floor_ms = exchange_floor_ms(T, H, cuda_rnn.plan(
        H, F, T, 2, torch.cuda.get_device_properties(0).multi_processor_count))
    library_ms = graph_ms(cudnn)
    plain_ms = cuda_ms(lambda: cuda_rnn.lstm_reference(x, params, True),
                       reps=3, groups=3)
    bound_ms = 2 * 2 * T * 4 * H * (F + H) / FP32_FLOP_PER_S * 1e3
    ops, launches = check_stream_recurrence()
    print(f"phase 14: {time.time() - t0:.2f} s; lstm_persistent (1, {T}, "
          f"{F}) -> 2 x {H}: kernel {ms:.4f} ms ({ms / T * 1e3:.3f} us a "
          f"step), floor of {T} exchanges {floor_ms:.4f} ms, operation "
          f"bound {bound_ms:.4f} ms, plain loop {plain_ms:.4f} ms, cuDNN "
          f"{library_ms:.4f} ms ({card}); a graphed stream step's device "
          f"operations {ops}")
    return {"launches": launches,
            "max_abs_err": max(err_plain, err_cudnn), "ms": ms,
            "floor_ms": floor_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "library_ms": library_ms}


def check_stream_recurrence(steps: int = 10) -> tuple[dict, int]:
    """Phase 14 (b): a VidLoc streaming session on the card whose
    recurrence has the stream's LSTM (a ResNet-18 trunk's 512 features on
    64x80 frames, 512 a direction, T = 200): opened with T - 3 frames, two
    eager steps of growing windows (a launch each), the first full window
    (its capture: the warm-up and the capture, 2 launches), then ``steps``
    graphed steps under ``torch.profiler``: the persistent kernel must run
    once a step and cuDNN's RNN kernels (``elemWiseRNNcell``,
    ``gemv2T_kernel_val``) not at all, and a replay launches nothing from
    the host. Returns the device operations a step, by name (shortened)
    and count, and the session's launches of the kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from geomapnet_tpu_torch import serving
    from geomapnet_tpu_torch.models import VidLoc
    from geomapnet_tpu_torch.models.resnet import resnet18
    from geomapnet_tpu_torch.ops import cuda_rnn
    from geomapnet_tpu_torch.ops.image import normalize

    def preprocess(frames):
        return normalize(frames, (0.5, 0.45, 0.4), (0.25, 0.22, 0.2),
                         dtype=torch.float32)

    T = LSTM_WINDOW
    torch.manual_seed(SEED + 21)
    model = VidLoc(resnet18(), hidden_size=LSTM_HIDDEN).eval().cuda()
    blob = serving.export_inference(model, None, frame_shape=(64, 80, 3),
                                    dtype=torch.uint8, preprocess=preprocess,
                                    window=T)
    session = serving.load_inference(blob, "cuda").session()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 22)
    frames = torch.randint(0, 256, (T + steps, 64, 80, 3), generator=gen,
                           dtype=torch.uint8, device="cuda")
    cuda_rnn.launches = 0
    session.open(frames[:T - 3])
    session.step(frames[T - 3])     # windows of T - 2 and T - 1: eager
    session.step(frames[T - 2])
    eager = cuda_rnn.launches
    session.step(frames[T - 1])     # the first full window captures
    torch.cuda.synchronize()
    captured = cuda_rnn.launches - eager
    print(f"phase 14 (b): the stream session's launches of the kernel: "
          f"{eager} for 2 eager windows, {captured} at the capture")
    if (eager, captured) != (2, 2):
        raise AssertionError(f"the session launched the kernel {eager} "
                             f"times for 2 eager windows, {captured} at "
                             f"the capture (want 2, 2)")
    launched = cuda_rnn.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            session.step(frames[T + i])
        torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CPU or e.self_device_time_total <= 0
                or getattr(e, "is_user_annotation", False)):
            continue
        ops[e.key[:60]] = ops.get(e.key[:60], 0) + e.count / steps
    lstm = sum(n for k, n in ops.items() if "lstm_persistent_kernel" in k)
    cudnn = [k for k in ops if "elemWiseRNNcell" in k or "gemv2T" in k]
    if lstm != 1 or cudnn or cuda_rnn.launches != launched:
        raise AssertionError(
            f"a graphed stream step ran the persistent kernel {lstm} times "
            f"(host launches {cuda_rnn.launches - launched}) and cuDNN's "
            f"{cudnn}: {ops}")
    return ops, cuda_rnn.launches


def phase13_alone(tmp: Path) -> dict:
    """Phase 13 on its own inputs: a 60-frame 7Scenes scene with seeded
    MapNet weights, and a one-epoch synthetic training run's logdir."""
    import os

    from geomapnet_tpu_torch.cli import builders
    from geomapnet_tpu_torch.cli import train as cli_train
    from geomapnet_tpu_torch.cli.config import parse_ini
    from geomapnet_tpu_torch.data.sevenscenes import SevenScenes
    from geomapnet_tpu_torch.ops import _nvcc, cuda_image

    _nvcc.build(cuda_image.SOURCE)
    config_file = ROOT / "configs" / "mapnet.ini"
    config = parse_ini(config_file)
    root = write_7scenes_scene(tmp / "7scenes", SMALL_SCENE_FRAMES)
    SevenScenes("heads", str(root / "deepslam" / "7Scenes"), train=True,
                asset_dir=str(root / "assets" / "7Scenes"))
    model, _ = builders.build_model("mapnet", config, trunk="resnet34")
    npz = tmp / "mapnet_resnet34.npz"
    seeded_flax_npz(model.posenet, npz)
    argv = ["--dataset", "7Scenes", "--scene", "heads", "--model", "mapnet",
            "--trunk", "resnet34", "--weights", str(npz),
            "--config_file", str(config_file),
            "--data_path", str(root / "deepslam"),
            "--asset_root", str(root / "assets")]
    ini = write_train_ini(tmp, config_file, 1, "p13_logs")
    cwd = Path.cwd()
    os.chdir(tmp)
    try:
        trainer = cli_train.main(["--dataset", "synth", "--model", "mapnet",
                                  "--trunk", "resnet18",
                                  "--config_file", str(ini)])
    finally:
        os.chdir(cwd)
    return check_phase13(root, argv, npz, tmp / trainer.logdir, tmp,
                         card_line())


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
    from geomapnet_tpu_torch.ops import _nvcc, cuda_image, cuda_quant, cuda_rnn

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
               cuda_quant.POOL_SOURCE, cuda_rnn.SOURCE]
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

        # phase 7: training, the step on the card and the train CLI
        t0 = time.time()
        check_train_card_vs_cpu(config)
        train = time_train_step(config, card)
        mapnet_7s = check_train_cli_7scenes(tmp, config_file)
        train_k4 = check_train_cli_robotcar(root, tmp, config_file)
        print(f"phase 7: {time.time() - t0:.2f} s; train images/s "
              f"{ {k: round(v['images_per_s'], 1) for k, v in train.items()} }"
              f" ({card}); K4 launches in --raw_bayer training {train_k4}")

        # phase 8: training from the device frame cache
        t0 = time.time()
        extend_robotcar_scene(root, PHASE8_FRAMES)
        print(f"phase 8: RobotCar scene raised to {PHASE8_FRAMES} train and "
              f"test frames in {time.time() - t0:.2f} s")
        graphs = check_graph_vs_eager(root, config)
        cache_runs = check_cache_training(root, tmp, config_file, card)
        bnbwd = check_step_bn_bf16_bwd(root, config, card)
        seven = check_cache_7scenes(tmp)
        b_runs = ("f32_k1", "bf16_k1", "bf16_k5", "bf16_bnbwd_k1")
        cache_k4 = sum(cache_runs[k]["k4"] for k in b_runs)
        rates = {k: round(cache_runs[k]["images_per_s"], 1) for k in b_runs}
        print(f"phase 8: {time.time() - t0:.2f} s; cache training images/s "
              f"{rates} ({card}); graph vs eager {graphs}; bf16 step ms "
              f"{bnbwd}; 7Scenes runs {sorted(seven)}; K4 launches in (b) "
              f"{cache_k4}")

        # phase 9: MapNet++ fine-tuning, and RobotCar's undistortion
        t0 = time.time()
        pp_config = parse_ini(ROOT / "configs" / "mapnet++_RobotCar.ini")
        write_robotcar_vo_gps(root, PHASE8_FRAMES)
        pp_step = check_mapnetpp_card_vs_cpu(pp_config)
        pp_runs = check_mapnetpp_workflow(root, tmp, config_file, card)
        pp_graph = check_mapnetpp_graph(root, pp_config)
        pp_7s = check_mapnetpp_7scenes(tmp, mapnet_7s)
        undist = check_camera_models(root, tmp, config_file, card)
        pp_k4 = sum(r["k4"] for r in pp_runs.values())
        rates = {k: round(pp_runs[k]["images_per_s"], 1)
                 for k in ("f32_k1", "bf16_k5", "gps_bf16_k5")}
        print(f"phase 9: {time.time() - t0:.2f} s; MapNet++ train images/s "
              f"{rates} ({card}); card vs CPU {pp_step}; graph vs eager "
              f"{pp_graph}; 7Scenes DSO {pp_7s['images'] / pp_7s['secs']:.1f}"
              f" images/s; undistortion pipeline {undist['ms']:.3f} ms vs "
              f"K4 path {undist['k4_ms']:.3f} ms a {MAIN_FRAMES}-frame batch;"
              f" K4 launches in (b) {pp_k4}")

        # phase 10: the native decoder, serving artifacts, the tools CLI
        t0 = time.time()
        upload8 = {k: round(cache_runs[k]["upload_secs"], 2)
                   for k in ("f32_k1", "bf16_k1")}
        decoder = check_native_decoder(p4, root, upload8, card)
        served = check_serving(p4, npz, config, root, tmp, card)
        p10 = served["launches"]
        print(f"phase 10: {time.time() - t0:.2f} s; native decoder "
              f"{decoder}; artifact ms a {MAIN_FRAMES}-frame batch "
              f"{ {k: v for k, v in served.items() if k != 'launches'} } "
              f"({card}); launches {p10}")

        # phase 11: data-parallel eval and training over torch.distributed
        p11 = check_data_parallel(p4, root, tmp, config_file, card,
                                  cache_runs["f32_k1"]["images_per_s"]
                                  )["launches"]

        # phase 12: the dry run's legs: tensor parallelism, spatial
        # partitioning, GPipe, the device cache, the serving artifact
        t0 = time.time()
        p12 = check_grid(tmp, card)
        print(f"phase 12: {time.time() - t0:.2f} s ({card})")

        # phase 13: VidLoc through K4, saliency, the dashboard over phase
        # 7's logdir, and the optional packages; the eval of (d) on phase
        # 4's scene's 4-frame train split
        p13 = check_phase13(
            p4["root"], [a for a in p4["argv"] if a != "--val"], npz,
            mapnet_7s.parent, tmp, card)

    # phase 14: the stream's recurrence kernel
    rnn = check_lstm(card)

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
        "launches": (launches + cache_k4 + pp_k4 + p10["K4"] + p11["K4"]
                     + p13["launches"]),
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
        "launches": (int8_launches["int8_conv"] + p10["int8_conv"]
                     + p11["int8_conv"] + p12["int8_conv"]),
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
        "launches": (int8_launches["int8_maxpool3x3s2"]
                     + p10["int8_maxpool3x3s2"] + p11["int8_maxpool3x3s2"]
                     + p12["int8_maxpool3x3s2"]),
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
    }, {
        "name": "lstm_persistent",
        "route": "cuda",
        "source": LSTM_SOURCE,
        "replaces": None,
        "launches": rnn["launches"],
        "max_abs_err": rnn["max_abs_err"],
        "ms": rnn["ms"],
        "floor_ms": rnn["floor_ms"],
        "plain_ms": rnn["plain_ms"],
        "bound_ms": rnn["bound_ms"],
        "bound_by": "operations",
        "library_ms": rnn["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-rank":
        sys.exit(dp_rank_main(sys.argv[2]))
    if sys.argv[1:] == ["--grid"]:      # phase 12 alone, no result line
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
            print(check_grid(Path(d), card_line()))
        sys.exit(0)
    if sys.argv[1:] == ["--vidloc"]:    # phase 13 alone, no result line
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device is visible")
        sys.path.insert(0, str(ROOT))
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
            print(phase13_alone(Path(d)))
        sys.exit(0)
    if sys.argv[1:] == ["--lstm"]:      # phase 14 alone, no result line
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device is visible")
        sys.path.insert(0, str(ROOT))
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        print(check_lstm(card_line()))
        sys.exit(0)
    sys.exit(main())
