"""A cell's files, found by name: `configs/<config>.json`,
`workloads/<cell>.json`, `algos/<algo>.py`, `counts/flops_<algo>.py`,
`metrics/<metric>.py` and `reference/<algo>.py`. Nothing here knows a
cell, a learner or a metric by name."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts):
    path = os.path.join(HERE, *parts)
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell `name`: its workload file with its configuration file under
    "cfg"."""
    wl = _json("workloads", f"{name}.json")
    wl["name"] = name
    wl["cfg"] = _json("configs", f"{wl['config']}.json")
    return wl


def algo(name: str):
    """The adaptor of one learner (`algos/<name>.py`)."""
    return importlib.import_module(f"port_bench.algos.{name}")


def reference(name: str):
    """The plain reference of one learner (`reference/<name>.py`)."""
    return importlib.import_module(f"port_bench.reference.{name}")


def flops(name: str):
    """The network FLOP count of one learner (`counts/flops_<name>.py`)."""
    return importlib.import_module(f"port_bench.counts.flops_{name}")


def metric_reader(name: str):
    """`read(rec) -> float | None` of one per-layer metric, from
    `metrics/<name>.py` (a file name may hold dots, so it is loaded by
    path)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def benchmark() -> dict:
    """BENCHMARK.json at the root of the checkout."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def per_layer_metrics(cell: str, bench: dict):
    """Names of the per-layer metrics BENCHMARK.json gives this cell."""
    return [m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", [cell])]


def end_to_end_metrics(cell: str, bench: dict):
    return [m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]
