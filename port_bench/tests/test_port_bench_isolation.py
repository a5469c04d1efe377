"""Nothing the benchmark or its reference runs imports JAX, its
libraries or the JAX package, by whole top-level names (`wtw_tpu_torch`
passes, `wtw_tpu` does not); the reference imports nothing of the port;
the harness reads none of the JAX package's bench files; and a run that
finds no card fails without a result and without falling back to the
CPU."""
from __future__ import annotations

import ast
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

from port_bench import cells
from port_bench import run as R

SOURCES = [os.path.join(d, f) for d, _, fs in os.walk(cells.HERE)
           for f in fs if f.endswith(".py") and "tests" not in d]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_whole_name_compare(monkeypatch):
    monkeypatch.setitem(sys.modules, "wtw_tpu_torch_fake", object())
    assert "wtw_tpu" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "wtw_tpu.fake", object())
    assert R.forbidden_modules() == ["wtw_tpu"]


def test_no_source_imports_a_forbidden_module():
    for path in SOURCES:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in R.FORBIDDEN, (path, mod)
            if os.sep + "reference" + os.sep in path:
                assert top != "wtw_tpu_torch", (path, mod)


def test_reads_no_jax_bench_file():
    """The harness's own sources (the frozen copy of the port's plain env
    opens only its robot data, under frozen/models/data)."""
    for path in SOURCES:
        if os.sep + "frozen" + os.sep in path:
            continue
        src = open(path).read()
        for word in ("bench.py", "BENCH_r", "MULTICHIP_r", "BASELINE.json",
                     "checkpoints/", "results/", "SCALING_virtualmesh"):
            assert word not in src, (path, word)


def test_loaded_modules_of_every_part():
    """Import every module of the harness and its reference in a fresh
    process, the port's entry points the adaptors call with them, and
    list what got loaded."""
    mods = ["port_bench." + os.path.relpath(p, cells.ROOT)[len(
        "port_bench/"):-3].replace(os.sep, ".") for p in SOURCES
        if os.sep + "metrics" + os.sep not in p]
    code = ("import sys, json\n"
            f"for m in {mods!r}:\n"
            "    __import__(m.replace('.__init__', ''))\n"
            "import wtw_tpu_torch.train, wtw_tpu_torch.train_parkour\n"
            "from port_bench import cells\n"
            "for m in cells.benchmark()['per_layer']:\n"
            "    cells.metric_reader(m['name'])\n"
            "print(json.dumps(sorted({k.split('.')[0] "
            "for k in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "wtw_tpu_torch" in tops
    assert not tops & set(R.FORBIDDEN), tops & set(R.FORBIDDEN)


def test_no_card_fails_without_a_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = R.main(["--workload", "go1_mob.fp32", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert buf.getvalue() == ""


def test_only_benchmark_files_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and port_bench, the
    command exits non-zero and prints no result."""
    import shutil
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cells.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    out = subprocess.run(bench["command"] + [
        "--workload", "go1_mob.fp32", "--seed", "3", "--seconds", "1",
        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax", "optax",
                                  "wtw_tpu"])
def test_each_forbidden_name_is_caught(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, object())
    assert name in R.forbidden_modules()


def test_pin_takes_one_cpu_before_torch():
    """`python3 -m port_bench` pins itself to one CPU before torch loads
    (in a child process: the test's own stays free)."""
    code = ("import os, sys\n"
            "from port_bench.__main__ import pin\n"
            "cpu = pin()\n"
            "assert 'torch' not in sys.modules\n"
            "print(os.sched_getaffinity(0) == {cpu}, "
            "os.environ['OMP_NUM_THREADS'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["True", "1"]
