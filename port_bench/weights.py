"""The learner's starting weights, made on the device from the seed in one
draw and handed to the program and to the reference alike."""
from __future__ import annotations

import math

import torch


def linear(name: str, n_in: int, n_out: int, bound: float, bias_bound=None):
    """Spec rows of one Linear layer (torch's (out, in) weight): weight and
    bias uniform in +-bound (+-bias_bound; 0 for a zero bias)."""
    bb = bound if bias_bound is None else bias_bound
    return [(f"{name}.weight", (n_out, n_in), bound),
            (f"{name}.bias", (n_out,), bb)]


def mlp(name: str, sizes, bound_of):
    """An `nn.Sequential(Linear, ELU, ...)` tower: Linear i sits at index
    2 i. `bound_of(i, n_in, n_out)` -> (weight bound, bias bound)."""
    rows = []
    for i in range(len(sizes) - 1):
        wb, bb = bound_of(i, sizes[i], sizes[i + 1])
        rows += linear(f"{name}.{2 * i}", sizes[i], sizes[i + 1], wb, bb)
    return rows


def fan_in(i, n_in, n_out):
    """torch.nn.Linear's default: weight and bias in +-1/sqrt(fan_in)."""
    b = 1.0 / math.sqrt(n_in)
    return b, b


def scaled(gain_last: float, n_layers: int):
    """The variance of an orthogonal init of gain sqrt(2) (gain_last on
    the last layer), g^2 / max(in, out), as a uniform draw; zero biases."""
    def bound(i, n_in, n_out):
        g = gain_last if i == n_layers - 1 else math.sqrt(2.0)
        return g * math.sqrt(3.0 / max(n_in, n_out)), 0.0
    return bound


def make(spec, gen: torch.Generator, device) -> dict:
    """spec: rows (name, shape, bound) drawn uniform in +-bound, or (name,
    shape, ("const", value)). One draw on the device for every leaf."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for (name, shape, b), n in zip(spec, sizes):
        if isinstance(b, tuple):
            out[name] = torch.full(shape, float(b[1]), device=device)
        else:
            out[name] = (u[at:at + n] * b).reshape(shape).clone()
        at += n
    return out
