"""A whole run on the CPU at a small size (the harness's look for a card
skipped), sound and with each fault a training cell can have planted in
the timed path: `correct` comes out true only for the sound run, under
each cell's own limits. (One chip: no exchange between chips to leave
out.)"""
from __future__ import annotations

import time

import pytest
import torch

from port_bench import cells, faults, tiny
from port_bench import run as R

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fault", (None,) + faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_fault_makes_the_run_incorrect(name, fault):
    cell = tiny.shrink(cells.load_cell(name))
    out = R.run(cell, 2 ** 31 + 77, 0.5, False, device="cpu", fault=fault,
                t_start=time.perf_counter())
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(out)[-2] == "checks"            # last but the notes
    assert out["correct"] is (fault is None), out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
