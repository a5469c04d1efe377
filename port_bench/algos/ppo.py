"""`train_parkour --algo ppo`: CaT PPO (`wtw_tpu_torch.learn.cat_ppo`)."""
from __future__ import annotations

import torch

from .. import weights as W
from .cat import (build, dims, iterate, keep, resets,  # noqa: F401
                  rollout, start, start_fields, step_fields, update)


def weight_spec(cell):
    d = dims(cell)
    n = len(d.hidden) + 1
    return (W.mlp("critic", [d.O, *d.hidden, 1], W.scaled(1.0, n))
            + W.mlp("actor_mean", [d.O, *d.hidden, d.A], W.scaled(0.01, n))
            + [("actor_logstd", (d.A,), ("const", 0.0))])


def draws(cell, gen, device) -> dict:
    """Action noise (T, N, A) and one permutation of the T N samples an
    epoch."""
    d = dims(cell)
    return {"noise": torch.randn((d.T, d.N, d.A), generator=gen,
                                 device=device),
            "perms": torch.stack([
                torch.randperm(d.T * d.N, generator=gen, device=device)
                for _ in range(d.epochs)])}
