"""The one-process forms of the port's `parallel/mesh.py` helpers that the
envs call (a process group is never passed here)."""
from __future__ import annotations

from typing import Callable

import torch


def _one(group):
    if group is not None:
        raise ValueError("the frozen reference runs in one process")


def group_size(group) -> int:
    _one(group)
    return 1


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    _one(group)
    return x


def all_mean(x: torch.Tensor, group) -> torch.Tensor:
    _one(group)
    return x


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    _one(group)
    return x


def draw_rows(draw: Callable, shape, group) -> torch.Tensor:
    _one(group)
    return draw(tuple(shape))


def shard_rows(x, group):
    _one(group)
    return x
