#!/usr/bin/env python3
"""Benchmark of the PyTorch / CUDA port (``geomapnet_tpu_torch``): one run of
one cell.

    python3 benchmark/run.py --workload 7scenes-eval-int8 --seed 123 \\
        --seconds 10 --trace 0

Set-up (imports, CUDA init, kernel builds, weights and frames from the seed,
uploads, export, warm-up) is timed from process start; then the cell's
traffic runs for ``--seconds``; then the outputs of the window are compared
with the plain reference under ``benchmark/reference/``. Earlier lines of
standard output describe the run; the last line is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics from a
``torch.profiler`` trace of the window), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error.

The run exits non-zero and prints no result without a card (or with fewer
cards than the cell asks for), and when a module of JAX or of the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every kernel cache at a fixed place inside the checkout, so only a
# checkout's first run builds (the port's nvcc builds go to its own
# geomapnet_tpu_torch/_build/)
CACHE = ROOT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
# load from one process with one compute thread: the host's share of a
# run moves less from process to process
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
sys.path.insert(0, str(ROOT))


def keep_heap() -> None:
    """Have glibc's allocator keep freed memory for reuse instead of handing
    it back to the system (no trimming; blocks under 32 MiB from the heap),
    so that each call does not fault its buffers in anew."""
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    m_trim_threshold, m_mmap_threshold = -1, -3
    libc.mallopt(m_trim_threshold, 2 ** 31 - 1)
    libc.mallopt(m_mmap_threshold, 32 * 2 ** 20)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def build_kernels(sources) -> None:
    """Build (or find built) the port's CUDA sources the cell runs, and
    print the seconds: a checkout's first run compiles, later ones load."""
    from geomapnet_tpu_torch.ops import _nvcc

    for src in sources:
        t = time.time()
        lib = _nvcc.build(src)
        print(f"kernel {src}: {lib.name} ready in {time.time() - t:.3f} s",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    keep_heap()

    import torch

    from benchmark.core import manifest
    from benchmark.core.runner import banned_loaded, run_cell

    chips = int(manifest.workload(args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the configurations state float32: no TF32 (as the port's CLIs set)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card_line()}; {torch.cuda.device_count()} visible; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    build_kernels(manifest.workload(args.workload).get("kernels", []))

    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=T0)
    banned = banned_loaded()
    if banned:
        print(f"modules of JAX or the JAX package are loaded: {banned}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
