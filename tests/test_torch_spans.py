"""The host spans and host-sync counter of `wtw_tpu_torch.utils.spans`:
nesting and self time, phases, the record ring and its indices, the
no-op when off, no profiler range without a profiler and ranges inside a
profiler's window with one, the counted syncs; one tiny CPU
`train_iteration` of each benchmarked learner with the span counts of a
24-step rollout; the benchmark's six readers of the spans; and on the
card, the counted syncs against the synchronizing ops that CUDA's sync
debug mode reports."""
from __future__ import annotations

import time
import warnings

import pytest
import torch

from port_bench import cells
from wtw_tpu_torch.utils import spans


@pytest.fixture(autouse=True)
def _fresh():
    spans.reset()
    spans.enable(True)
    yield
    spans.enable(True)
    spans.reset()


@spans.spanned("it", opens_record=True)
def _iteration(body):
    body()


def _sleep_ms(ms):
    t = time.perf_counter() + ms / 1e3
    while time.perf_counter() < t:
        pass


def test_nesting_and_self_time():
    def body():
        with spans.span("outer"):
            _sleep_ms(2)
            with spans.span("inner"):
                _sleep_ms(3)
            with spans.span("inner"):
                _sleep_ms(1)
            spans.phase("p1")
            _sleep_ms(1)
            spans.phase("p2")
            with spans.span("in_p2"):
                pass
        with spans.span("after"):
            pass
    _iteration(body)
    (rec,) = spans.records()
    s = rec["spans"]
    assert rec["index"] == 0 and rec["profiled"] is False
    assert s["inner"]["count"] == 2 and s["outer"]["count"] == 1
    assert s["p1"]["count"] == s["p2"]["count"] == 1
    assert s["in_p2"]["count"] == s["after"]["count"] == 1
    assert s["inner"]["ns"] >= 4e6
    assert s["inner"]["self_ns"] == s["inner"]["ns"]
    # a span's self time is its time less its children's, phases included
    children = s["inner"]["ns"] + s["p1"]["ns"] + s["p2"]["ns"]
    assert s["outer"]["self_ns"] == s["outer"]["ns"] - children
    assert s["outer"]["self_ns"] >= 2e6
    assert s["p2"]["self_ns"] == s["p2"]["ns"] - s["in_p2"]["ns"]
    assert s["it"]["ns"] >= s["outer"]["ns"] + s["after"]["ns"]
    assert spans._stack == []


def test_phase_ends_with_its_span_on_an_exception():
    def body():
        with spans.span("outer"):
            spans.phase("p")
            raise ValueError
    with pytest.raises(ValueError):
        _iteration(body)
    s = spans.records()[0]["spans"]
    assert s["p"]["count"] == s["outer"]["count"] == s["it"]["count"] == 1
    assert spans._stack == []


def test_ring_and_record_indices():
    for _ in range(spans.RING + 44):
        _iteration(lambda: None)
    recs = spans.records()
    assert len(recs) == spans.RING
    assert [r["index"] for r in recs] == list(range(44, spans.RING + 44))
    assert all(r["spans"]["it"]["count"] == 1 for r in recs)
    spans.reset()
    assert spans.records() == []
    _iteration(lambda: None)
    assert spans.records()[0]["index"] == 0


def test_off_is_one_shared_noop():
    spans.enable(False)
    assert spans.span("a") is spans.span("b")
    with spans.span("a"):
        spans.phase("p")
    _iteration(lambda: spans.host_float(torch.ones(())))
    assert spans.tensor([1.0, 2.0], "cpu").tolist() == [1.0, 2.0]
    assert spans.records() == [] and spans._stack == []


def test_no_range_without_a_profiler(monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)

    def body():
        with spans.span("a"):
            spans.phase("p")
    _iteration(body)
    assert set(spans.records()[0]["spans"]) == {"it", "a", "p"}


def test_ranges_inside_the_profilers_window():
    def body():
        with spans.span("outer"):
            torch.ones(8).sum()
            with spans.span("inner"):
                torch.ones(8).mul(2)
            spans.phase("p")
            torch.ones(8).add(1)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("window"):
            _iteration(body)
    events = prof.events()
    (win,) = [e for e in events if e.name == "window"]
    got = {}
    for e in events:
        if e.name in ("it", "outer", "inner", "p"):
            got[e.name] = got.get(e.name, 0) + 1
            assert win.time_range.start <= e.time_range.start
            assert e.time_range.end <= win.time_range.end
    assert got == {"it": 1, "outer": 1, "inner": 1, "p": 1}
    (outer,) = [e for e in events if e.name == "outer"]
    (inner,) = [e for e in events if e.name == "inner"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert spans.records()[0]["profiled"] is True
    _iteration(lambda: None)
    assert spans.records()[1]["profiled"] is False


def test_syncs_are_counted_and_charged_to_the_innermost_span():
    x = torch.tensor([2.5])

    def body():
        assert spans.host_float(x) == 2.5
        with spans.span("a"):
            t = spans.tensor([1.0, 2.0], "cpu", torch.float64)
            assert t.dtype == torch.float64
            with spans.span("b"):
                spans.as_tensor(0.5, dtype=torch.float32, device="cpu")
                spans.as_tensor(x, device="cpu")      # a tensor: no copy
    _iteration(body)
    rec = spans.records()[0]
    assert rec["counters"]["host_syncs"] == 3
    assert rec["counters"]["sync_wait_ns"] > 0
    s = rec["spans"]
    assert (s["it"]["syncs"], s["a"]["syncs"], s["b"]["syncs"]) == (1, 1, 1)
    assert s["b"]["sync_ns"] <= rec["counters"]["sync_wait_ns"]


# ---------------------------------------------------------------------------
# one tiny CPU train_iteration of each benchmarked learner
# ---------------------------------------------------------------------------

TINY_PARKOUR = ["terrain.num_levels=3", "terrain.num_terrains=5",
                "terrain.border_size=4.0", "ppo.hidden=16,8"]


def _learner(algo, device, num_envs, run_dir):
    """(learner, world, obs) of the benchmark's three learners, as their
    CLIs build them, at `num_envs` envs on a small map."""
    run_dir = str(run_dir)
    if algo == "ppo_cse":
        from wtw_tpu_torch.train import build
        _, runner = build(
            "go1_mob", num_envs,
            ["terrain.num_rows=3", "terrain.num_cols=3",
             "runner.tensorboard=False", "ac.actor_hidden_dims=16",
             "ac.critic_hidden_dims=16", "ac.adaptation_hidden_dims=8"],
            device=device, run_dir=run_dir, save_interval=0)
        return runner.ppo, runner.world, runner.obs_dict
    from wtw_tpu_torch.train_parkour import build
    extra = ["ppo.rnn_hidden_dim=8"] if algo == "ppornn" else []
    runner = build(num_envs, TINY_PARKOUR + extra, device=device,
                   run_dir=run_dir, save_interval=0, algo=algo)
    return runner.learner, runner.world, runner.obs_n


@pytest.mark.parametrize("algo,minibatches", [("ppo_cse", 20), ("ppo", 30),
                                              ("ppornn", 30)])
def test_one_iteration_records_the_rollouts_spans(algo, minibatches,
                                                  tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ln, world, obs = _learner(algo, "cpu", 6, tmp_path)
        ln.train_iteration(world, obs)
    finally:
        torch.set_num_threads(n)
    (rec,) = spans.records()
    calls = {k: v["count"] for k, v in rec["spans"].items()}
    assert calls["learner.rollout"] == calls["learner.update"] == 1
    assert calls["learner.gae"] == 1
    assert calls["learner.act"] == calls["env.step"] == 24
    assert calls["env.torques"] == calls["physics.step"] == 96
    for p in ("env.reward", "env.reset", "env.observe"):
        assert calls[p] == 24
    assert calls["learner.minibatch"] == minibatches
    rnn = 30 if algo == "ppornn" else 0
    assert calls.get("learner.replay", 0) == rnn
    if algo != "ppo_cse":
        assert calls["learner.backward"] == calls["learner.optimizer"] == 30
    s = rec["spans"]
    assert s["env.step"]["ns"] < s["learner.rollout"]["ns"]
    assert s["physics.step"]["ns"] < s["env.step"]["ns"]
    # the counted sites (the card's test holds them to its syncs)
    syncs = rec["counters"]["host_syncs"]
    assert syncs == sum(v["syncs"] for v in s.values())
    if algo == "ppo_cse":
        assert s["learner.minibatch"]["syncs"] == 20      # float(kl)
        assert syncs >= 24 and rec["counters"]["sync_wait_ns"] > 0
    else:
        # the parkour env step and the CaT learners make none
        assert syncs == 0


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

def _record(index, profiled, scale):
    row = lambda ms: {"count": 1, "ns": int(ms * 1e6), "self_ns": 0,
                      "syncs": 0, "sync_ns": 0}
    return {"index": index, "profiled": profiled,
            "spans": {"env.step": row(10 * scale),
                      "physics.step": row(2 * scale),
                      "learner.update": row(30 * scale)},
            "counters": {"host_syncs": 7 * scale,
                         "sync_wait_ns": int(4e6 * scale)}}


READS = {"env.step_host_ms": 10.0, "physics.step_host_ms": 2.0,
         "learner.update_host_ms": 30.0, "device.host_syncs_per_iter": 7.0,
         "device.sync_wait_ms": 4.0}


@pytest.mark.parametrize("name", sorted(READS))
def test_host_readers_take_the_windows_whole_iterations(name, monkeypatch):
    """The median over records [check_iterations, check_iterations +
    whole_iterations) that ran without a profiler; None with none."""
    read = cells.metric_reader(name)
    rec = {"cell": {"check_iterations": 3}, "whole_iterations": 3}
    recs = ([_record(i, False, 100) for i in range(3)]       # check its
            + [_record(3, False, 1), _record(4, False, 1),
               _record(5, False, 3)]                          # the window
            + [_record(6, False, 50), _record(7, True, 70)])  # split, traced
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert read(rec) == pytest.approx(READS[name])
    monkeypatch.setattr(spans, "records", lambda: recs[:3] + recs[6:])
    assert read(rec) is None


def test_device_reader_reads_the_env_step_ranges():
    read = cells.metric_reader("env.step_device_ms")
    summary = {"ops": {"k": [5.0, 1]}, "busy_s": 1e-5, "iterations": 2,
               "ranges": {"env.step": [48000.0, 48]}}
    assert read({"summary": summary}) == pytest.approx(24.0)
    summary["ranges"] = {}
    assert read({"summary": summary}) is None
    assert read({"summary": None}) is None


# ---------------------------------------------------------------------------
# on the card: the counter holds every synchronizing op of an iteration
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["ppo_cse", "ppo", "ppornn"])
def test_host_syncs_are_the_sync_debug_modes_syncs(card, algo, tmp_path):
    """One warmed `train_iteration` at 256 envs under
    `torch.cuda.set_sync_debug_mode("warn")`: each synchronizing op warns
    once, and their number is the record's `host_syncs`."""
    ln, world, obs = _learner(algo, card, 256, tmp_path)
    world, obs, _ = ln.train_iteration(world, obs)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        # the first switch to "warn" in a process warns once by itself
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ln.train_iteration(world, obs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where = [f"{w.filename}:{w.lineno}" for w in got
             if "synchroniz" in str(w.message)]
    rec = spans.records()[-1]
    assert rec["counters"]["host_syncs"] == len(where), sorted(set(where))
    # the parkour env step replays a graph and makes none
    assert (len(where) > 0) == (algo == "ppo_cse")
