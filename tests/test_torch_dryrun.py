"""The multi-card dry run on gloo ranks on the CPU.

``dryrun_multichip(n)`` (:mod:`geomapnet_tpu_torch.dryrun`, the port of
``__graft_entry__.dryrun_multichip``) runs on every rank of an n-rank
group: at n = 4 all nine legs of the JAX package's dry run, at n = 2 the
four that need no 2-D grid. Each rank returns JAX's leg lines with the
leg's seconds, and the legs' checks (the tensor-parallel step against the
one-rank step, the spatial eval against the one-rank forward, the
pipeline against the sequential composition) hold within their bars.
Under ``torchrun`` the module's entry point runs the dry run and leaves
the group (``shutdown_distributed``): the launch exits with 0.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from dp_ranks import run_group

REPO = Path(__file__).resolve().parent.parent
GRID_LEGS = ("dp2xtp2 ok, loss=", "spatial eval ok, out=(8, 3, 6)",
             "pp2 ok, out=(24, 6)", "pp2-train ok, loss=",
             "dp2xpp2-train ok, loss=")
LEGS = ("dp ok, loss=", "dp-devicecache-train ok, loss=",
        "dp-devicecache-scan2-train ok, losses=",
        "serving-artifact-dp ok, ")


@pytest.mark.parametrize("n", (2, 4))
def test_dryrun_prints_every_leg(n):
    from geomapnet_tpu_torch.dryrun import (
        PIPE_TOL,
        SERVING_TOL,
        SPATIAL_TOL,
        TP_GRAD_RELNORM,
        TP_LOSS_RTOL,
    )

    ranks = run_group("grid_ranks:dryrun", n, timeout=300, n=n)
    want = LEGS[:1] + (GRID_LEGS if n == 4 else ()) + LEGS[1:]
    for rank, r in enumerate(ranks):
        lines = r["lines"]
        assert len(lines) == len(want)
        for line, start in zip(lines, want):
            if rank >= 2 and start.startswith("pp2"):   # not a stage rank
                start = start.split(" ")[0] + ": not a stage rank"
            assert line.startswith(f"dryrun_multichip({n}): {start}"), line
            assert "[leg " in line and "s, total " in line
            assert "nan" not in line
        assert all(leg["seconds"] >= 0 for leg in r["legs"].values())
        # the stem's and the blocks' five int8 convs and the max-pool, each
        # held to its plain version
        serving = r["legs"]["serving-artifact-dp"]
        assert serving["int8_calls"] == 7
        assert serving["gap"] <= SERVING_TOL
    if n == 4:
        legs = ranks[0]["legs"]
        assert legs["tp"]["loss_gap"] <= TP_LOSS_RTOL
        assert legs["tp"]["grad_relnorm"] <= TP_GRAD_RELNORM
        assert legs["spatial"]["gap"] <= SPATIAL_TOL
        for leg in ("pp2-train", "dp2xpp2-train"):
            assert legs[leg]["loss_gap"] <= PIPE_TOL
            assert legs[leg]["grad_gap"] <= PIPE_TOL
        assert legs["pp2"]["gap"] <= PIPE_TOL
        assert "gap" not in ranks[2]["legs"]["pp2"]     # not a stage rank
    assert ranks[0]["legs"]["dp-devicecache-scan2-train"]["graph"] is False


def test_dryrun_refuses_another_group_size():
    from geomapnet_tpu_torch.dryrun import dryrun_multichip

    with pytest.raises(ValueError, match="runs on an 4-rank group; this "
                       "one has 1"):
        dryrun_multichip(4, "cpu")


def test_shutdown_leaves_the_group():
    """``shutdown_distributed`` runs the live ``on_shutdown`` hooks while
    the group exists (a dropped owner's is gone), then leaves it."""
    for r in run_group("grid_ranks:shutdown", 2):
        assert r == dict(before=True, after=False, calls=[("live", True)])


def test_dryrun_under_torchrun_exits(tmp_path):
    """``torchrun -m geomapnet_tpu_torch.dryrun --device cpu --out DIR``
    over two gloo ranks prints the legs, writes each rank's legs and kernel
    launches (none on the CPU) to ``DIR/rank<R>.json`` and exits with 0
    after leaving the group."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "geomapnet_tpu_torch.dryrun",
         "--device", "cpu", "--out", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for start in LEGS:
        assert f"dryrun_multichip(2): {start}" in proc.stdout
    for rank in range(2):
        result = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert result["launches"]["int8_conv"] == 0
        assert result["legs"]["serving-artifact-dp"]["int8_calls"] == 7
