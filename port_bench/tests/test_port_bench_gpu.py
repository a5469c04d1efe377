"""On the card (skips itself without one): one short run of a cell through
the benchmark's command, whose last line has the contract's keys; and the
control, the program's products in TF32, which the comparison has to
find not correct (at 512 envs and the cell's widths)."""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from port_bench import cells
from port_bench import run as R


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_short_run_prints_the_contract_keys():
    _card()
    out = subprocess.run(
        [sys.executable, "-m", "port_bench", "--workload",
         "parkour.cat_ppo", "--seed", str(2 ** 31 + 5), "--seconds", "2",
         "--trace", "0"], cwd=cells.ROOT, capture_output=True, text=True,
        env=dict(os.environ), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert set(res["metrics"]) == set(cells.end_to_end_metrics(
        "parkour.cat_ppo", cells.benchmark()))
    assert res["correct"] is True, res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["go1_mob.fp32", "parkour.cat_ppo",
                                  "parkour.cat_ppornn"])
def test_tf32_control_is_not_correct(name):
    _card()
    cell = copy.deepcopy(cells.load_cell(name))
    cell["cfg"]["num_envs"] = 512
    out = R.run(cell, 2 ** 31 + 9, 0.5, False, device="cuda",
                control="tf32", t_start=time.perf_counter())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert out["correct"] is False, out["checks"]
