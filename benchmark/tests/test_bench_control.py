"""The control of every cell comes out not correct, on the card at the
cell's own size: the plain reference, computed in the precision below the
one the configuration states (int4 for the int8 serving cells, TF32 for the
float32 training cell), put in the program's place, fails at least one of
the cell's limits on three seeds. Run on the card with
``python -m pytest benchmark/tests -m cuda``."""

from __future__ import annotations

import pytest

from benchmark.core import manifest as mf
from benchmark.core.runner import Run
from benchmark.core.trace import Tracer

SEEDS = (2 ** 31 + 7, 2 ** 31 + 8, 2 ** 31 + 9)
# a short window at the cell's load: long enough to judge as many answers
# as a run does (the sweep's eight checkpoints; a few hundred requests; one
# epoch, whose first steps are judged)
SECONDS = {"eval_sweep": 8.0, "closed_loop_serve": 2.0, "train_epochs": 0.1,
           "dp_train": 0.1}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in mf.manifest()
                                  ["workloads"]])
def test_control_fails_a_limit(card, cell):
    import torch

    wl = mf.workload(cell)
    if torch.cuda.device_count() < wl["chips"]:
        pytest.skip(f"needs {wl['chips']} cards")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    drv = mf.driver(wl["driver"])
    for seed in SEEDS:
        run = Run(cell, seed, dict(wl["params"]), mf.config(wl["config"]),
                  card, Tracer(False), chips=wl["chips"])
        drv.setup(run)
        record = drv.window(run, SECONDS[wl["driver"]])
        drv.release(run)
        numbers = drv.control(run, record)
        assert any(numbers[k] > v for k, v in wl["limits"].items()), \
            (seed, numbers)
        del run, record
        torch.cuda.empty_cache()
