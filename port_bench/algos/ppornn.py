"""`train_parkour --algo ppornn`: recurrent CaT PPO with two GRU memories
(`wtw_tpu_torch.learn.cat_ppornn`)."""
from __future__ import annotations

import math

import torch

from .. import weights as W
from .cat import (build, dims, iterate, keep, resets,  # noqa: F401
                  rollout, start, start_fields, step_fields, update)


def weight_spec(cell):
    d = dims(cell)
    n = len(d.hidden) + 1
    head_in = d.rnn + d.O
    gb = 1.0 / math.sqrt(d.rnn)
    gru = lambda name: [(f"{name}.weight_ih", (3 * d.rnn, d.O), gb),
                        (f"{name}.weight_hh", (3 * d.rnn, d.rnn), gb),
                        (f"{name}.bias_ih", (3 * d.rnn,), gb),
                        (f"{name}.bias_hh", (3 * d.rnn,), gb)]
    return (W.mlp("critic", [head_in, *d.hidden, 1], W.scaled(1.0, n))
            + W.mlp("actor_mean", [head_in, *d.hidden, d.A],
                    W.scaled(0.01, n))
            + [("actor_logstd", (d.A,), ("const", 0.0))]
            + gru("actor_memory") + gru("critic_memory"))


def draws(cell, gen, device) -> dict:
    """Action noise (T, N, A) and one permutation of the envs an epoch."""
    d = dims(cell)
    return {"noise": torch.randn((d.T, d.N, d.A), generator=gen,
                                 device=device),
            "perms": torch.stack([
                torch.randperm(d.N, generator=gen, device=device)
                for _ in range(d.epochs)])}
