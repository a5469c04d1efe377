"""Constraints-as-Terminations (CaT) (port of `wtw_tpu/envs/constraints.py`;
reference utils/constraint_manager.py:3-121).

- each constraint is an (N, w) violation array (w columns, e.g. one per
  joint); per COLUMN a Polyak running max of the batch-max violation
  (tau = 0.95, :52-54);
- termination probability per element: 0 where no violation, else
  min_p + clip(violation / running_max, 0, 1) * (max_p - min_p) (:63-70);
- per-env probability = max over all constraints' columns (:73-77).

Constraints are declared once (names and widths); the state is one flat
(total_cols,) running-max vector. Under env sharding (`group`) the batch
max is the group's max and the violation fractions are group means (the
shards hold equal env counts), so every rank updates the running max
alike.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from ..parallel.mesh import all_max, all_mean


@dataclasses.dataclass
class CaTState:
    running_max: torch.Tensor    # (total_cols,)


class CaTManager:
    """Static declaration of the constraint battery."""

    def __init__(self, names_widths: Sequence[Tuple[str, int]],
                 tau: float = 0.95, min_p: float = 0.0, device="cpu",
                 group=None):
        self.names = [n for n, _ in names_widths]
        self.widths = [w for _, w in names_widths]
        self.offsets = {}
        off = 0
        for n, w in names_widths:
            self.offsets[n] = (off, off + w)
            off += w
        self.total = off
        self.tau = tau
        self.min_p = min_p
        self.group = group
        # column -> its constraint, for the per-constraint violation
        # fractions (a sum over columns, not a matrix product: the parkour
        # env step is captured on a side stream, where a cuBLAS call would
        # allocate that stream a workspace of its own)
        self._col_constraint = torch.tensor(
            [k for k, w in enumerate(self.widths) for _ in range(w)],
            device=device)
        self.device = torch.device(device)

    def init_state(self) -> CaTState:
        return CaTState(running_max=torch.full((self.total,), 1e-6,
                                               device=self.device))

    def columns(self, names) -> torch.Tensor:
        """(total_cols,) bool mask of the named constraints' columns (built
        once, on the host)."""
        mask = torch.zeros(self.total, dtype=torch.bool)
        for n in names:
            a, b = self.offsets[n]
            mask[a:b] = True
        return mask.to(self.device)

    def step(self, state: CaTState, constraints: Dict[str, torch.Tensor],
             maxp: torch.Tensor):
        """One step: -> (new state, probs (N,), violation fraction per
        constraint {name: ()}, binding column per env (N,)).

        constraints[name]: (N,) or (N, w) violation values (> 0 = violated).
        maxp: (total_cols,) float32, each column's max termination
        probability, on the device."""
        if set(constraints) != set(self.names):
            raise KeyError(f"declared {self.names}, got {list(constraints)}")
        allc = torch.cat([constraints[n].reshape(
            constraints[n].shape[0], -1).float() for n in self.names], dim=1)
        batch_max = all_max(torch.clamp(allc.max(dim=0).values, min=1e-6),
                            self.group)
        new_rm = self.tau * state.running_max + (1 - self.tau) * batch_max
        scaled = torch.clamp(allc / new_rm[None, :], 0.0, 1.0)
        probs = torch.where(allc > 0.0,
                            self.min_p + scaled * (maxp - self.min_p)[None, :],
                            torch.zeros_like(allc))
        env_prob, env_argmax_col = probs.max(dim=1)
        # fraction of envs with any violated column, per constraint
        # (ConstraintManager.log_all / get_vals :104-121)
        hit = torch.zeros(probs.shape[0], len(self.names),
                          device=probs.device).index_add_(
            1, self._col_constraint, (probs > 0.0).float()) > 0.0
        frac = all_mean(hit.float().mean(dim=0), self.group)
        viol = dict(zip(self.names, frac.unbind()))
        return CaTState(running_max=new_rm), env_prob, viol, env_argmax_col


def sqrt_func(x: torch.Tensor) -> torch.Tensor:
    """The reference wraps many constraints in `sqrt_func`, which is a
    pass-through (`return x`, go2_parkour.py:17-19; the sqrt variant is
    commented out). Kept as a named hook for parity."""
    return x
