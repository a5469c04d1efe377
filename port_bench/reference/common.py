"""Plain pieces the learners' references share: a tower of Linear/ELU
layers over a dict of leaves, Adam, the clip of the global gradient
norm."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def leaves(weights: dict, device) -> dict:
    """Trainable float32 copies of the handed weights."""
    return {k: v.detach().to(device, torch.float32).clone()
            .requires_grad_(True) for k, v in weights.items()}


def tower(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """Linear layers `name.0`, `name.2`, ... with ELU between them."""
    i = 0
    while f"{name}.{2 * i}.weight" in p:
        if i:
            x = F.elu(x)
        x = x @ p[f"{name}.{2 * i}.weight"].T + p[f"{name}.{2 * i}.bias"]
        i += 1
    return x


class Adam:
    """torch.optim.Adam's update written out (bias-corrected moments, eps
    added to the corrected root)."""

    def __init__(self, params, eps: float, betas=(0.9, 0.999)):
        self.params, self.eps, self.betas = list(params), eps, betas
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads, lr: float):
        b1, b2 = self.betas
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(m, denom, value=-lr / c1)


def clip_global(grads, max_norm: float):
    """Scale by max_norm / norm when the global norm reaches max_norm."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    scale = 1.0 if float(norm) < max_norm else max_norm / norm
    return [g * scale for g in grads]


def dev(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else x
