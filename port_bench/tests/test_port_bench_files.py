"""BENCHMARK.json and the files it names: every configuration, cell,
learner and metric loads by name, and one added as a new file is found by
name without an edit."""
from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from port_bench import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return cells.benchmark()


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["port_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in [m["name"] for m in bench["end_to_end"]]
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("kind", ["config", "cell", "metric", "learner"])
def test_every_named_file_loads(bench, kind):
    if kind == "config":
        for c in bench["configs"]:
            path = os.path.join(cells.ROOT, c["file"])
            cfg = json.load(open(path))
            assert cfg["name"] == c["name"]
            assert cfg["reduced"] == c["reduced"]
            assert cfg["source"] == c["source"]
    elif kind == "cell":
        for w in bench["workloads"]:
            cell = cells.load_cell(w["name"])
            assert cell["config"] == w["config"]
            assert cell["chips"] == w["chips"] == 1
            assert set(cell["limits"]) == {
                "start_gap", "step_gap", "action_gap", "loss_gap",
                "grad_gap", "change_gap"}
            # every cell reports setup_s, another end-to-end metric and a
            # per-layer metric
            assert "setup_s" in cells.end_to_end_metrics(w["name"], bench)
            assert len(cells.end_to_end_metrics(w["name"], bench)) >= 2
            assert cells.per_layer_metrics(w["name"], bench)
    elif kind == "metric":
        for m in bench["per_layer"]:
            assert callable(cells.metric_reader(m["name"]))
    else:
        for w in bench["workloads"]:
            algo = cells.load_cell(w["name"])["algo"]
            for mod in (cells.algo(algo), cells.reference(algo),
                        cells.flops(algo)):
                assert mod is not None


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    """A cell and a metric added as files only are found by their names."""
    root = tmp_path / "port_bench"
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(os.path.join(cells.HERE, sub), root / sub)
    wl = json.load(open(root / "workloads" / "go1_mob.fp32.json"))
    wl["overrides"] = wl["overrides"] + ["ac.compute_dtype=bfloat16"]
    wl["dtype"] = "bfloat16"
    (root / "workloads" / "go1_mob.bf16.json").write_text(json.dumps(wl))
    (root / "metrics" / "device.new_metric.py").write_text(
        "def read(rec):\n    return rec['x'] * 2\n")
    monkeypatch.setattr(cells, "HERE", str(root))
    cell = cells.load_cell("go1_mob.bf16")
    assert cell["dtype"] == "bfloat16" and cell["cfg"]["num_envs"] == 4000
    assert cells.metric_reader("device.new_metric")({"x": 2.5}) == 5.0


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, _, files in os.walk(cells.HERE):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), cells.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
