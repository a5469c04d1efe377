"""A traced run on the CPU at a small size reports the metrics read from
the program's spans and sync counter, and their readers' record slice
[check_iterations, check_iterations + whole_iterations) is exactly the
window's whole iterations: no other call of the learner's rollout opens a
record before them or among them."""
from __future__ import annotations

import time

import torch

from port_bench import cells, tiny
from port_bench import run as R
from wtw_tpu_torch.utils import spans

HOST = ("env.step_host_ms", "physics.step_host_ms", "learner.update_host_ms",
        "device.host_syncs_per_iter", "device.sync_wait_ms")


def test_traced_run_reads_the_whole_iterations_records(monkeypatch):
    cell = tiny.shrink(cells.load_cell("parkour.cat_ppo"))
    ad = cells.algo(cell["algo"])
    opened = []                 # (record index, how the harness drove it)

    def logged(fn, how):
        def call(*args):
            out = fn(*args)
            opened.append((spans.records()[-1]["index"], how))
            return out
        return call
    monkeypatch.setattr(ad, "iterate", logged(ad.iterate, "whole"))
    monkeypatch.setattr(ad, "rollout", logged(ad.rollout, "split"))
    seen = []
    reader = cells.metric_reader

    def keep_rec(name):
        read = reader(name)

        def call(rec):
            seen.append(rec)
            return read(rec)
        return call
    monkeypatch.setattr(cells, "metric_reader", keep_rec)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    spans.reset()
    try:
        out = R.run(cell, 2 ** 31 + 91, 2.0, True, device="cpu",
                    t_start=time.perf_counter())
    finally:
        torch.set_num_threads(n)
    for name in HOST:
        assert out["metrics"][name]["value"] > 0, name
    rec = seen[0]
    k, whole = cell["check_iterations"], rec["whole_iterations"]
    assert whole >= 1
    # the check iterations, the window's whole iterations, its split ones,
    # then the traced ones, each one record in turn
    idx = [i for i, _ in opened]
    assert idx == list(range(len(opened)))
    hows = [h for _, h in opened]
    n_split = len(rec["rollout_s"])
    assert hows == (["whole"] * (k + whole) + ["split"] * n_split
                    + ["whole"] * cell["trace_iterations"])
    recs = {r["index"]: r for r in spans.records()}
    window = [recs[i] for i in range(k, k + whole)]
    assert not any(r["profiled"] for r in window)
    assert all(recs[i]["profiled"] for i in idx[-cell["trace_iterations"]:])
    assert all(r["spans"]["learner.rollout"]["count"] == 1
               and r["spans"]["learner.update"]["count"] == 1
               for r in window)
    spans.reset()
