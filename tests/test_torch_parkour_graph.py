"""The parkour env step without host syncs, over a donated world, and as
one CUDA graph (`wtw_tpu_torch/envs/parkour_env.py`: `DonatedStep`).

On the CPU: no counted host sync in a step of either task; the device
mirror of the soft-p curriculum against the host's `soft_p_step`, bit for
bit over the whole ramp; the donated arena's write-back (run eagerly,
without a graph) against the functional step, field by field, through
resets and copy-ins; a sharded env stays eager. On the card: the graphed
step against the eager step, bit for bit, in three configurations and
while another env's graph is collected; no synchronizing op in 24
replays; returned tensors outlive the next replay. And the benchmark's
reader of the replay counter.
"""
from __future__ import annotations

import dataclasses
import gc
import warnings
import weakref

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

from port_bench import cells
from wtw_tpu_torch.envs.parkour_env import (DonatedStep, ParkourCfg,
                                            ParkourEnv, _leaves,
                                            graph_engages, rough_terrain_cfg,
                                            soft_p_mirror, soft_p_step)
from wtw_tpu_torch.models import load_robot
from wtw_tpu_torch.terrain import ParkourTerrainCfg
from wtw_tpu_torch.utils import spans

SMALL = ParkourTerrainCfg(num_levels=3, num_terrains=5, border_size=4.0)

# the configurations the card holds to the eager step: CaT parkour; the
# full reward battery with the pre-reset observation; the terrain task
CONFIGS = {
    "parkour_cat": dict(task="parkour"),
    "parkour_full": dict(task="parkour", reward_mode="full",
                         provide_true_next_obs=True),
    "terrain": dict(task="terrain", reward_mode="full", use_gait_clocks=True,
                    observe_clock_inputs=True, use_actuator_net=True),
}


def _env(device, num_envs=8, task="parkour", **kw):
    """A small map; 0.3 s episodes (15 policy steps), so that every env
    times out and resets within the steps a test runs."""
    if task == "terrain":
        kw.setdefault("rough_terrain", dataclasses.replace(
            rough_terrain_cfg(), num_rows=3, num_cols=3, border_size=1.0))
    cfg = ParkourCfg(task=task, num_envs=num_envs, episode_length_s=0.3,
                     terrain=SMALL, **kw)
    return ParkourEnv(cfg, load_robot("go2"), seed=0, device=device)


def _actions(rng, n, device):
    return torch.from_numpy((rng.randn(n, 12)).astype(np.float32)).to(device)


def _outputs(out):
    """The tensors and numbers a step returns besides its world."""
    return tree_flatten(out[1:])[0]


def _assert_same_step(a, b, what):
    """Two steps' worlds and outputs, bit for bit."""
    wa, wb = a[0], b[0]
    for i, (x, y) in enumerate(zip(_leaves(wa), _leaves(wb))):
        assert torch.equal(x, y), f"{what}: world leaf {i}"
    assert (wa.soft_p_progress, wa.common_step) == (wb.soft_p_progress,
                                                    wb.common_step), what
    assert torch.equal(wa.gen.get_state(), wb.gen.get_state()), what
    fa, fb = _outputs(a), _outputs(b)
    assert len(fa) == len(fb), what
    for i, (x, y) in enumerate(zip(fa, fb)):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y), \
                f"{what}: output {i}"
        else:
            assert x == y and type(x) is type(y), f"{what}: output {i}"


@pytest.fixture(autouse=True)
def _fresh_spans():
    spans.reset()
    spans.enable(True)
    yield
    spans.reset()


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", [
    dict(task="parkour", observe_phases=True, observe_imu=True,
         provide_true_next_obs=True),
    dict(task="parkour", only_forwards=True, reward_mode="full"),
    dict(task="terrain", reward_mode="full", use_gait_clocks=True,
         observe_clock_inputs=True, use_actuator_net=True),
], ids=["parkour", "parkour_forwards_full", "terrain"])
def test_step_makes_no_host_sync(config):
    """Every counted host sync (`spans.host_float`, `tensor`, `as_tensor`
    of host data) is gone from the step, resets and every optional block
    included."""
    env = _env("cpu", **config)
    world = env.init_state(0)
    rng = np.random.RandomState(0)

    @spans.spanned("it", opens_record=True)
    def steps():
        nonlocal world
        for _ in range(16):
            world, _, _, _, info = env.step(world, _actions(rng, 8, "cpu"))
            resets.append(bool(info["true_dones"].any()))
    resets = []
    steps()
    (rec,) = spans.records()
    assert rec["spans"]["env.step"]["count"] == 16
    assert rec["counters"]["host_syncs"] == 0
    assert rec["counters"]["env_graph_replays"] == 0
    assert any(resets)


def test_soft_p_mirror_is_the_host_schedule_bit_for_bit():
    """The mirror's arithmetic over the host's whole progress sequence at
    once: the 192,000-step ramp from 0, a resumed mid-ramp progress, the
    clip at 1, and the constant soft p without the curriculum. Each
    sequence is a float32 running sum, checked to be the host's recurrence
    by `soft_p_step` on the whole sequence."""
    cfg = ParkourCfg()
    inc = np.float32(1.0 / cfg.soft_p_total_steps)
    for p0, n in ((0.0, cfg.soft_p_total_steps), (0.4137, 20000),
                  (0.9999, 2000)):
        acc = np.add.accumulate(np.concatenate(
            [[np.float32(p0)], np.full(n, inc, np.float32)]), dtype=np.float32)
        seq = np.where(np.maximum.accumulate(acc >= 1.0), np.float32(1.0),
                       acc).astype(np.float32)
        host_p, host_sp = soft_p_step(seq[:-1], cfg)
        np.testing.assert_array_equal(host_p, seq[1:])      # the recurrence
        dev_p, dev_sp = soft_p_mirror(torch.from_numpy(seq[:-1]), cfg)
        assert dev_p.dtype == dev_sp.dtype == torch.float32
        np.testing.assert_array_equal(dev_p.numpy(), host_p)
        np.testing.assert_array_equal(dev_sp.numpy(), host_sp)
    assert seq[-1] == 1.0
    # the scalar the host carries is the array's element
    p, sp = soft_p_step(np.float32(0.4137), cfg)
    assert type(p) is type(sp) is np.float32
    mp, msp = soft_p_mirror(torch.tensor(np.float32(0.4137)), cfg)
    assert (float(mp), float(msp)) == (float(p), float(sp))
    flat = dataclasses.replace(cfg, use_soft_p_curriculum=False)
    _, sp = soft_p_step(np.float32(0.3), flat)
    _, msp = soft_p_mirror(torch.tensor(np.float32(0.3)), flat)
    assert float(msp) == float(sp) == float(np.float32(flat.soft_p))


def test_donated_write_back_is_the_functional_step():
    """40 steps through timeouts and resets, the donated arena run eagerly
    (no graph) beside the functional step from the same world: every world
    field, output, host field and the generator's state bit for bit. The
    arena takes the first world from `init_state`, a `dataclasses.replace`
    of one field at step 20 and a new `init_state` world (its own
    generator, mirrors rewound) at step 30: the copy-ins are counted."""
    env = _env("cpu", push_robots=True, add_noise=True)
    don = DonatedStep(env)
    wa, wb = env.init_state(0), env.init_state(0)
    rng = np.random.RandomState(1)
    resets, copy_ins = 0, []

    @spans.spanned("it", opens_record=True)
    def step(t):
        nonlocal wa, wb, resets
        a = _actions(rng, 8, "cpu")
        oa = env.functional_step(wa, a)
        ob = don.step(wb, a)
        _assert_same_step(oa, ob, f"step {t}")
        assert all(x is y for x, y in zip(_leaves(ob[0]), don.arena))
        resets += int(oa[4]["true_dones"].sum())
        wa, wb = oa[0], ob[0]

    for t in range(40):
        if t == 20:
            wb = dataclasses.replace(wb, env=dataclasses.replace(
                wb.env, commands=wb.env.commands.clone()))
        if t == 30:
            wa, wb = env.init_state(5), env.init_state(5)
        step(t)
        copy_ins.append(spans.records()[-1]["counters"]["env_state_copy_ins"])
    assert resets > 0
    n_leaves = len(_leaves(wa))
    # step 20: one field; step 30: every world tensor, the generator and
    # the mirrors; none else (the first step makes the arena)
    assert copy_ins[20] == 1 and copy_ins[30] == n_leaves + 2
    assert sum(copy_ins) == 1 + n_leaves + 2
    assert wb.common_step == 10 and wa.soft_p_progress == wb.soft_p_progress


def test_a_dropped_env_is_freed_with_its_donated_step_at_once():
    """No reference cycle holds an env that donates its world: dropped,
    the env and its `DonatedStep` (with its graph, on a card) are freed by
    reference counting, with the collector off, while the world it
    returned is still held."""
    env = _env("cpu")
    env._donated = DonatedStep(env)         # as on a card
    world = env.init_state(0)
    rng = np.random.RandomState(0)
    for _ in range(2):
        world = env.step(world, _actions(rng, 8, "cpu"))[0]
    assert world.hist_obs is env._donated.arena[-1]
    refs = weakref.ref(env), weakref.ref(env._donated)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del env
        assert all(r() is None for r in refs)
    finally:
        if collecting:
            gc.enable()


def test_a_sharded_or_cpu_env_keeps_the_eager_step():
    assert graph_engages(torch.device("cuda"), None)
    assert not graph_engages(torch.device("cuda", 0), object())
    assert not graph_engages("cpu", None)
    assert _env("cpu")._donated is None


def test_graph_replays_reader_takes_the_windows_whole_iterations(
        monkeypatch):
    """The median of `env_graph_replays` over the window's whole
    unprofiled iterations; None for a program whose records lack the
    counter."""
    read = cells.metric_reader("env.graph_replays_per_iter")
    rec = {"cell": {"check_iterations": 2}, "whole_iterations": 3}

    def r(i, n, profiled=False):
        return {"index": i, "profiled": profiled, "spans": {},
                "counters": {"host_syncs": 0, "sync_wait_ns": 0,
                             "env_graph_replays": n,
                             "env_state_copy_ins": 0}}
    recs = [r(0, 1), r(1, 1), r(2, 24), r(3, 24), r(4, 23), r(5, 0),
            r(6, 24, True)]
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert read(rec) == 24.0
    recs = [r(i, 0) for i in range(6)]
    assert read(rec) == 0.0
    for x in recs:
        del x["counters"]["env_graph_replays"]
    assert read(rec) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_graphed_step_is_the_eager_step(card, config):
    """60 steps at 256 envs through resets: the graph's replays against
    the functional step on its own world of the same seed, bit for bit
    (world, outputs, host fields, generator state). Into the captured env
    come two foreign worlds, copied in: at step 20 a `dataclasses.replace`
    of the commands (halved on both sides), at step 40 a new `init_state`
    world (its own generator, set into the graph's registered one, and
    the mirrors rewound)."""
    env = _env(card, 256, push_robots=True, add_noise=True, **CONFIGS[config])
    assert env._donated is not None
    wa, wb = env.init_state(3), env.init_state(3)
    rng = np.random.RandomState(2)
    resets = 0
    for t in range(60):
        if t == 20:
            wa, wb = (dataclasses.replace(w, env=dataclasses.replace(
                w.env, commands=w.env.commands * 0.5)) for w in (wa, wb))
        if t == 40:
            wa, wb = env.init_state(5), env.init_state(5)
        a = _actions(rng, 256, card)
        oa = env.functional_step(wa, a)
        ob = env.step(wb, a)
        _assert_same_step(oa, ob, f"{config} step {t}")
        resets += int(oa[4]["true_dones"].sum())
        wa, wb = oa[0], ob[0]
    assert env._donated.graph is not None and resets > 0
    assert wb.common_step == 20


@pytest.mark.gpu
def test_a_dropped_env_frees_its_graph_before_another_capture(card):
    """A captured env, dropped with the collector off, is freed at once
    with its `DonatedStep` and graph (no reference cycle holds them); then
    another env's first steps, with the collector at its most frequent,
    so that a collection inside the capture finds nothing of the old env.
    The new graph's steps are the eager ones, bit for bit."""
    rng = np.random.RandomState(4)
    old = _env(card, 256, **CONFIGS["parkour_full"])
    w = old.init_state(1)
    for _ in range(2):
        w = old.step(w, _actions(rng, 256, card))[0]
    assert old._donated.graph is not None
    env = _env(card, 256, **CONFIGS["parkour_full"])
    wa, wb = env.init_state(2), env.init_state(2)
    gone = weakref.ref(old._donated)
    collecting, thresholds = gc.isenabled(), gc.get_threshold()
    gc.disable()
    try:
        del old, w
        assert gone() is None
        gc.enable()
        gc.set_threshold(1)
        for t in range(4):
            a = _actions(rng, 256, card)
            oa = env.functional_step(wa, a)
            ob = env.step(wb, a)
            _assert_same_step(oa, ob, f"step {t}")
            wa, wb = oa[0], ob[0]
    finally:
        gc.set_threshold(*thresholds)
        (gc.enable if collecting else gc.disable)()
    assert env._donated.graph is not None


@pytest.mark.gpu
def test_replays_make_no_synchronizing_op_and_outputs_stay(card):
    """24 replays under `torch.cuda.set_sync_debug_mode("error")`; the
    tensors a step returned keep their values through the next replays."""
    env = _env(card, 256, **CONFIGS["parkour_cat"])
    world = env.init_state(0)
    rng = np.random.RandomState(3)
    for _ in range(2):
        world = env.step(world, _actions(rng, 256, card))[0]
    acts = [_actions(rng, 256, card) for _ in range(24)]
    kept, snaps = [], []

    @spans.spanned("it", opens_record=True)
    def rollout():
        nonlocal world
        for a in acts:
            out = env.step(world, a)
            world = out[0]
            kept.append(_outputs(out))
            snaps.append([x.clone() if torch.is_tensor(x) else x
                          for x in kept[-1]])
    from wtw_tpu_torch.physics import kernels as K
    counts = lambda: [(k.launches, k.ceiling_launches, k.replayed,
                       k.replayed_ceiling) for k in K.KERNELS]
    before = counts()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # the first switch warns once
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        rollout()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counters = spans.records()[-1]["counters"]
    assert counters["env_graph_replays"] == 24
    assert counters["env_state_copy_ins"] == 0
    assert counters["host_syncs"] == 0
    # the replays launched what the capture recorded, counted apart from
    # the launches the wrappers made (none): 4 substeps a step, each with
    # the ceiling where the course has one
    n = 24 * env.cfg.decimation
    with_ceiling = n if env.hf_ceiling is not None else 0
    assert [tuple(x - y for x, y in zip(a, b))
            for a, b in zip(counts(), before)] == [
        (0, 0, n, 0), (0, 0, n, with_ceiling)]
    # what each step returned, copied right after it, is what it still
    # holds after the later replays
    for t, (got, snap) in enumerate(zip(kept, snaps)):
        for x, y in zip(got, snap):
            assert torch.equal(x, y) if torch.is_tensor(x) else x == y, t
