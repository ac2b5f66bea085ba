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

The line before the last is a JSON object with the kernel's launches, error
and times; the last line is ``{"ok": true, "device": {...}}``.
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


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def check_7scenes(tmp: Path, npz: Path, config_file: Path, config) -> None:
    """Phase 4: the 7Scenes eval through the CLI, loader path and device
    cache, float32 and bf16; raises when a check fails."""
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
    dataset = MF(SevenScenes("heads", str(root / "deepslam" / "7Scenes"),
                             train=False,
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
    from geomapnet_tpu_torch.ops import cuda_image

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # phase 1: build
    t0 = time.time()
    lib = cuda_image.build_kernel()
    print(f"build: {lib.name} in {time.time() - t0:.2f} s")

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
        check_7scenes(tmp, npz, config_file, config)

    f32 = kernel["float32"]
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
