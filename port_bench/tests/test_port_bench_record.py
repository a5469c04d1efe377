"""What the check iterations record: the seeded env steps, the first
reset and the step after it; every field of a world; integer fields
compared by the share of entries that differ."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from port_bench import cells, check, record, tiny
from port_bench import run as R


@dataclasses.dataclass
class World:
    pos: torch.Tensor
    level: torch.Tensor
    progress: np.float32
    gen: torch.Generator


class Env:
    """Steps a counter; env 1 resets at step `reset_at`."""

    def __init__(self, reset_at):
        self.t, self.reset_at = 0, reset_at

    def step(self, world, actions):
        done = torch.zeros(3, dtype=torch.bool)
        done[1] = self.t == self.reset_at
        self.t += 1
        return (dataclasses.replace(world, pos=world.pos + actions), None,
                actions.sum(-1), done, {})


def _world():
    return World(torch.zeros(3, 2), torch.zeros(3, dtype=torch.int64),
                 np.float32(0.5), torch.Generator().manual_seed(1))


def _record(reset_at, snapshot_at):
    env = Env(reset_at)
    rec = record.StepRecorder(
        env, lambda w, o, r, d, i: {"rew": r, "done": d},
        lambda kept: kept["done"], snapshot_at)
    world = _world()
    for _ in range(8):
        world = env.step(world, torch.ones(3, 2))[0]
    rec.close()
    return rec


def test_snapshots_take_the_first_reset_and_the_step_after():
    rec = _record(reset_at=4, snapshot_at=[1, 6])
    assert [s["t"] for s in rec.snapshots] == [1, 4, 5, 6]
    assert rec.reset_at == 4 and len(rec.steps) == 8
    four = rec.snapshots[1]
    assert torch.equal(four["before"]["pos"], torch.full((3, 2), 4.0))
    assert torch.equal(four["after"][0]["pos"], torch.full((3, 2), 5.0))


def test_no_reset_keeps_the_seeded_steps():
    rec = _record(reset_at=99, snapshot_at=[2, 3])
    assert [s["t"] for s in rec.snapshots] == [2, 3]
    assert rec.reset_at is None


def test_tree_fields_take_every_field_and_the_generator():
    f = record.tree_fields("world", record.to_host(_world()))
    assert set(f) == {"world.pos", "world.level", "world.progress",
                      "world.gen"}
    assert f["world.gen"].dtype == torch.uint8


def test_world_fields_keep_physics_and_integers():
    w = {"env": {"phys": {"q": torch.ones(2)}, "swing": torch.ones(2),
                 "level": torch.zeros(2, dtype=torch.int64)},
         "gen": {"__generator__": torch.zeros(4, dtype=torch.uint8)}}
    assert set(record.world_fields(w)) == {"world.env.phys.q",
                                           "world.env.level", "world.gen"}


def test_integer_fields_read_the_share_that_differs():
    a = torch.tensor([0, 1, 2, 3], dtype=torch.int64)
    b = torch.tensor([0, 1, 2, 4], dtype=torch.int64)
    assert check.rel_gap(b, a) == 0.25
    assert check.rel_gap(a > 1, b > 2) == 0.25
    assert check.rel_gap(torch.tensor([3.0, 4.0]),
                         torch.tensor([3.0, 5.0])) == 1 / 34 ** 0.5


@pytest.mark.parametrize("name", ["parkour.cat_ppo", "parkour.cat_ppornn"])
def test_the_reference_follows_the_program_step_by_step(name):
    """`follow`: a row an optimizer step, where the CPU's sound run (the
    same plain code on both sides) never parts from the program."""
    torch.set_num_threads(2)
    cell = tiny.shrink(cells.load_cell(name))
    out = R.run(cell, 2 ** 31 + 77, 0.5, False, device="cpu",
                t_start=time.perf_counter(), follow=True)
    trail = out["_notes"]["diag"]["trail"]
    d = cell["cfg"]
    assert trail["step"] is None
    assert trail["widest_gap"] < 1e-5
    assert len(trail["rows"]) == 3 and all(
        set(r) == {"flips", "near", "gap"} for r in trail["rows"])
    assert d["update_epochs"] * d["num_minibatches"] >= 3
