"""Data-parallel training: the ``train_epochs`` traffic over the cell's
cards, one rank per card, as ``torchrun --nproc_per_node=N -m
geomapnet_tpu_torch.cli.train --distributed`` runs it.

The benchmark's process is rank 0; set-up starts ranks 1..N-1 as processes
of this file, each with the environment a launcher gives a rank (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, the rendezvous on a free local port), and
every rank joins the group (NCCL on cards, gloo on the CPU) and runs
``train_epochs``' set-up and window alike: the global batch is the
configuration's, each rank holding ``batch_size / N`` tuples of it, the
frames sharded over the ranks with the parameters' ``device_cache``. Rank 0
decides when the window ends, judges its first steps (recorded over the
global batch) against the reference, and reports the device's busy time
averaged over the ranks and the fullest card's memory peak. Every rank
leaves the group, and rank 0 waits for the others to exit.
"""

from __future__ import annotations

import atexit
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

if __name__ == "__main__":      # a rank process: the checkout on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.core import faults  # noqa: E402
from benchmark.core.runner import Run  # noqa: E402
from benchmark.core.trace import Tracer  # noqa: E402
from benchmark.traffic import train_epochs as single  # noqa: E402

__all__ = ["setup", "window", "release", "check", "control"]

RANK_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join(run) -> None:
    from geomapnet_tpu_torch.parallel import initialize_distributed

    cuda = run.device.type == "cuda"
    initialize_distributed(backend="nccl" if cuda else "gloo",
                           device=run.device if cuda else None)


def _rank_env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def _stop(procs) -> None:
    """End every rank process still running (a run that failed on rank 0
    leaves the others waiting on the group)."""
    for proc, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def setup(run) -> None:
    world = run.chips
    if run.device.type == "cuda":
        run.device = torch.device("cuda", 0)     # rank 0's card
    port = _free_port()
    logs = tempfile.TemporaryDirectory(prefix="bench_ranks_")
    spec = dict(cell=run.cell, seed=run.seed, params=run.params,
                config=run.config, trace=run.tracer.enabled,
                device=run.device.type, fault=faults.active)
    procs = []
    for r in range(1, world):
        env = dict(os.environ, **_rank_env(r, world, port),
                   OMP_NUM_THREADS="2", PYTHONUNBUFFERED="1")
        log = open(Path(logs.name) / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, json.dumps(spec)], env=env,
            stdout=log, stderr=subprocess.STDOUT), log))
    atexit.register(_stop, procs)
    run.state.update(procs=procs, rank_logs=logs)
    os.environ.update(_rank_env(0, world, port))
    _join(run)
    single.setup(run)


def window(run, seconds: float) -> dict:
    return single.window(run, seconds)


def _device_info(run, trace) -> dict:
    """Every rank's (busy s, window s, memory peak), gathered on each."""
    import torch.distributed as dist

    mine = (trace.busy_s() if trace is not None else None,
            trace.window_s if trace is not None else None,
            torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def release(run) -> None:
    from geomapnet_tpu_torch.parallel import shutdown_distributed

    every = _device_info(run, run.tracer.trace)
    run.device_info = {"memory_peak_bytes": max(e[2] for e in every)}
    if run.tracer.trace is not None:
        run.device_info["busy_s"] = sum(e[0] for e in every) / len(every)
        run.device_info["window_s"] = sum(e[1] for e in every) / len(every)
    single.release(run)
    shutdown_distributed()
    failed = []
    deadline = time.time() + RANK_TIMEOUT_S
    for r, (proc, log) in enumerate(run.state.pop("procs"), start=1):
        try:
            code = proc.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            proc.kill()
            code = proc.wait()
        log.close()
        if code != 0:
            failed.append((r, code))
    logs = run.state.pop("rank_logs")
    if failed:
        r = failed[0][0]
        tail = (Path(logs.name) / f"rank{r}.log").read_text()[-3000:]
        logs.cleanup()
        raise RuntimeError(f"ranks exited with {failed}; rank {r}'s log:\n"
                           f"{tail}")
    logs.cleanup()


def check(run, record) -> dict:
    return single.check(run, record)


def control(run, record) -> dict:
    return single.control(run, record)


def _rank_main(spec: dict) -> int:
    """Rank ``RANK``'s part of a run: join, set up, the window, and leave."""
    from geomapnet_tpu_torch.parallel import shutdown_distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = int(os.environ["LOCAL_RANK"])
    device = (torch.device("cuda", rank) if spec["device"] == "cuda"
              else torch.device("cpu"))
    tracer = Tracer(spec["trace"] and device.type == "cuda")
    run = Run(spec["cell"], spec["seed"], spec["params"], spec["config"],
              device, tracer, chips=int(os.environ["WORLD_SIZE"]))
    with faults.planted(spec["fault"]):
        _join(run)
        single.setup(run)
        with tracer:
            single.window(run, float("inf"))
        _device_info(run, tracer.read())
        single.release(run)
        shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(json.loads(sys.argv[1])))
