#!/usr/bin/env python3
"""Readings for the limits of a cell's correctness numbers, in one process.

    python3 benchmark/readings.py --workload 7scenes-eval-int8 \\
        --seeds 11,12,13 --control-seeds 11,12,13 --seconds 3

On the card, at the workload file's own parameters and configuration.
For each seed: the cell's set-up, a short window at the cell's own load,
and the program's numbers against the plain reference (the run's check);
for each control seed also the control's numbers: the reference itself,
computed in the precision below the configuration's, in the program's
place. With ``--fault`` the program runs with that fault planted
underneath (``benchmark/core/faults.py``). One JSON line a seed, then the largest program reading and the
smallest control reading of each number. Not part of a benchmark run; the
limits in ``benchmark/workloads/`` are set from its readings
(``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default=None,
                    help="plant a fault of benchmark/core/faults.py")
    args = ap.parse_args(argv)

    import torch

    from benchmark.core import manifest as mf
    from benchmark.core.faults import planted
    from benchmark.core.runner import Run
    from benchmark.core.trace import Tracer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    wl = mf.workload(args.workload)
    drv = mf.driver(wl["driver"])
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    worst, least = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        run = Run(args.workload, seed, dict(wl["params"]),
                  mf.config(wl["config"]), torch.device("cuda"),
                  Tracer(False), chips=int(wl.get("chips", 1)))
        with planted(args.fault):
            drv.setup(run)
            record = drv.window(run, args.seconds)
            drv.release(run)
        line = {"seed": seed, "attempted": record["attempted"],
                "program": drv.check(run, record)}
        if seed in controls:
            line["control"] = drv.control(run, record)
            for k, v in line["control"].items():
                if isinstance(v, float):
                    least[k] = min(least.get(k, float("inf")), v)
        for k, v in line["program"].items():
            if isinstance(v, float):
                worst[k] = max(worst.get(k, 0.0), v)
        print("READING " + json.dumps(line), flush=True)
        del run, record
        torch.cuda.empty_cache()
    print("READINGS " + json.dumps({"lower": worst, "control_least": least}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
