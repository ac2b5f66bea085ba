"""One run of one cell: set-up, the measured window, the correctness check,
and the result line.

A traffic driver (``benchmark/traffic/<driver>.py``) provides
``setup(run)``, ``window(run, seconds) -> record``, ``release(run)`` and
``check(run, record) -> {number: value}`` (the workload file's
``limits`` name the numbers compared; the others are printed); it keeps its
state on ``run.state``. The
record holds the end-to-end values under their metric names
(``record["e2e"]``), ``attempted`` and ``failed``, and whatever the cell's
per-layer readers need (``benchmark/metrics/<metric>.py``: ``read(window)
-> float | None``, where ``window`` has ``record``, ``trace``, ``params``,
``config`` and ``chips``).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any

from . import manifest as mf
from .trace import Tracer

__all__ = ["Run", "Window", "run_cell", "BANNED_MODULES", "banned_loaded"]

BANNED_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "geomapnet_tpu")


def banned_loaded() -> list[str]:
    """Top-level names in ``sys.modules`` that the run may not load,
    compared whole (``geomapnet_tpu_torch`` is not ``geomapnet_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(BANNED_MODULES))


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell's parameters and configuration, the
    seed, the device, the tracer, and ``state`` for its own use."""

    cell: str
    seed: int
    params: dict
    config: dict
    device: Any
    tracer: Tracer
    chips: int = 1
    state: dict = dataclasses.field(default_factory=dict)
    # a driver over several ranks sets the device's numbers over all of
    # them (busy_s, window_s averaged; memory_peak_bytes of the fullest)
    device_info: dict = dataclasses.field(default_factory=dict)

    def log(self, *parts) -> None:
        print(f"[{self.cell}]", *parts, flush=True)


@dataclasses.dataclass
class Window:
    record: dict
    trace: Any
    params: dict
    config: dict
    chips: int


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device=None, params_override: dict | None = None,
             config_override: dict | None = None,
             t_start: float | None = None) -> dict:
    """Run ``cell`` once; returns the result object (the last line's
    keys, ``checks`` last). ``device`` None means the card."""
    import torch

    t_start = time.time() if t_start is None else t_start
    man = mf.manifest()
    wl = mf.workload(cell)
    params = {**wl["params"], **(params_override or {})}
    config = {**mf.config(wl["config"]), **(config_override or {})}
    device = torch.device("cuda" if device is None else device)
    tracer = Tracer(trace and device.type == "cuda")
    run = Run(cell=cell, seed=int(seed), params=params, config=config,
              device=device, tracer=tracer, chips=int(wl.get("chips", 1)))
    drv = mf.driver(wl["driver"])

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    drv.setup(run)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - t_start
    run.log(f"set-up {setup_s:.3f} s")

    with tracer:
        record = drv.window(run, seconds)
    tr = tracer.read()
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    drv.release(run)
    numbers = drv.check(run, record)
    limits = wl["limits"]
    for k, v in numbers.items():
        if k not in limits:
            run.log(f"reading {k}: {v!r} (not compared)")
    checks = {k: {"value": float(numbers[k]), "limit": float(v)}
              for k, v in limits.items()}
    correct = (record["failed"] == 0 and bool(checks)
               and all(c["value"] <= c["limit"] for c in checks.values()))

    metrics = {}
    if trace:
        win = Window(record=record, trace=tr, params=params, config=config,
                     chips=run.chips)
        for m in mf.cell_metrics(man, cell, per_layer=True):
            value = mf.metric_reader(m["name"]).read(win)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        values = dict(record["e2e"], setup_s=setup_s)
        for m in mf.cell_metrics(man, cell, per_layer=False):
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": run.chips, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(correct), "attempted": int(record["attempted"]),
           "failed": int(record["failed"]), "metrics": metrics,
           "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    dev.update(run.device_info)
    out["checks"] = checks
    return out
