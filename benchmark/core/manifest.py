"""Find the benchmark's parts by name: ``BENCHMARK.json`` at the checkout's
root, ``benchmark/workloads/<cell>.json``, ``benchmark/configs/<config>.json``,
``benchmark/traffic/<driver>.py`` and ``benchmark/metrics/<metric>.py``. A
cell or a metric is added by adding its files; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

__all__ = ["ROOT", "BENCH", "manifest", "workload", "config", "driver",
           "metric_reader", "cell_metrics", "load_module"]

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    """The cell's file: its configuration, traffic mix, driver, parameters,
    chips and the limits of its correctness numbers."""
    return _json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return _json(BENCH / "configs" / f"{name}.json")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    """The traffic driver ``benchmark/traffic/<name>.py``."""
    return load_module(BENCH / "traffic" / f"{name}.py",
                       f"benchmark_traffic_{name}")


def metric_reader(name: str):
    """The per-layer metric's reader ``benchmark/metrics/<name>.py``: a
    module with ``read(window) -> float | None``."""
    return load_module(BENCH / "metrics" / f"{name}.py",
                       "benchmark_metric_" + name.replace(".", "_")
                       .replace("-", "_"))


def cell_metrics(man: dict, cell: str, per_layer: bool) -> list:
    """The metrics ``cell`` reports: end-to-end ones (no ``workloads`` key,
    or one that names the cell), or with ``per_layer`` the per-layer ones
    that name it, or that have no ``workloads`` key and move an end-to-end
    metric the cell reports."""
    e2e = [m for m in man["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not per_layer:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if cell in m.get("workloads", ()) or
            ("workloads" not in m and m["moves"] in moved)]
