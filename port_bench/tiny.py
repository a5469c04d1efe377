"""Cells shrunk to a size the CPU tests can run (a few envs, a 3 x 3-cell
map or a small course, four policy steps), with the same learners, widths
and code paths; for tests only."""
from __future__ import annotations

import copy

SHRINK = {
    "train": {"cfg": {"num_envs": 8, "num_steps_per_env": 4},
              "overrides": ["terrain.num_rows=3", "terrain.num_cols=3",
                            "ppo.num_steps_per_env=4"]},
    "train_parkour": {"cfg": {"num_envs": 12, "num_steps": 4,
                              "hidden": [32, 16], "rnn_hidden_dim": 16},
                      "overrides": ["terrain.num_levels=3",
                                    "terrain.num_terrains=5",
                                    "terrain.border_size=4.0",
                                    "ppo.num_steps=4", "ppo.hidden=32,16",
                                    "ppo.rnn_hidden_dim=16"]},
}


def shrink(cell: dict) -> dict:
    cell = copy.deepcopy(cell)
    s = SHRINK[cell["cfg"]["builder"]]
    cell["cfg"].update(s["cfg"])
    extra = [o for o in s["overrides"]
             if not (cell["algo"] != "ppornn" and "rnn_hidden" in o)]
    cell["overrides"] = list(cell["overrides"]) + extra
    return cell
