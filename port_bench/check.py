"""The numbers that decide `correct`, each the program's reading against
the reference's, and their limits (a cell's workload file holds the
limits; PERF.md gives the readings they were set from)."""
from __future__ import annotations

import math
import statistics

import torch

# the order the numbers are printed in
NAMES = ("start_gap", "step_gap", "action_gap", "loss_gap", "grad_gap",
         "change_gap")


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """|prog - ref| / |ref| in the 2-norm; for integer and boolean tensors
    (flags, levels, a generator's state) the share of entries that
    differ."""
    if not ref.is_floating_point():
        return float((prog.cpu() != ref.cpu()).double().mean()) \
            if ref.numel() else 0.0
    p, r = prog.double().cpu(), ref.double().cpu()
    return _norm(p - r) / max(_norm(r), 1e-12)


def field_gaps(prog: dict, ref: dict) -> dict:
    """rel_gap of every field the reference gives."""
    return {k: rel_gap(prog[k], ref[k]) for k in ref}


def fields_gap(prog: dict, ref: dict):
    """The widest rel_gap over the fields both give; -> (gap, field)."""
    gaps = field_gaps(prog, ref)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def leaf_gap(prog_norms: dict, ref_norms: dict, names) -> float:
    """The worst leaf's |norm_prog - norm_ref| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = statistics.median([ref_norms[n] for n in names])
    return max(abs(prog_norms[n] - ref_norms[n]) / max(ref_norms[n], med,
                                                       1e-30)
               for n in names)


def moving_leaves(ref_grad_norms: dict):
    """Leaves whose first gradient in the reference is at least a
    thousandth of the median leaf's: the others move under Adam by
    round-off alone."""
    med = statistics.median(list(ref_grad_norms.values()))
    return [n for n, g in ref_grad_norms.items() if g >= 1e-3 * med]


def learner_numbers(prog: dict, ref: dict, w0: dict) -> dict:
    """prog: the program's losses, first gradient (from Adam's state),
    leaves after the check iterations and rollout actions; ref: the same
    of the reference; w0: the handed weights."""
    names = list(w0)
    g_p = {n: _norm(prog["grad1"][n]) for n in names}
    g_r = {n: _norm(ref["grad1"][n]) for n in names}
    moving = moving_leaves(g_r)
    d_p = {n: _norm(prog["params"][n].double() - w0[n].double().cpu())
           for n in moving}
    d_r = {n: _norm(ref["params"][n].double() - w0[n].double().cpu())
           for n in moving}
    return {
        "action_gap": max(rel_gap(a, b) for a, b in
                          zip(prog["actions"], ref["actions"])),
        "loss_gap": max(abs(lp - lr) / max(abs(lr), 1e-12) for lp, lr in
                        zip(prog["losses"], ref["losses"])),
        "grad_gap": leaf_gap(g_p, g_r, names),
        "change_gap": leaf_gap(d_p, d_r, moving),
    }


def left_out_leaves(ref: dict) -> list:
    """The leaves `change_gap` leaves out (see `moving_leaves`)."""
    g_r = {n: _norm(g) for n, g in ref["grad1"].items()}
    keep = set(moving_leaves(g_r))
    return [n for n in g_r if n not in keep]


def leaf_changes(prog: dict, ref: dict, w0: dict) -> dict:
    """Each leaf's change norm after the check iterations, (program,
    reference): what `change_gap` reads, for a look at its tail."""
    return {n: (_norm(prog["params"][n].double() - w0[n].double()),
                _norm(ref["params"][n].double() - w0[n].double()))
            for n in w0}


def first_departure(trail, at: float = 1e-5):
    """The reference's trail (`reference/ppo.Follow`, a row an optimizer
    step) up to the first step whose gap to the program's parameters
    reaches `at`: that step, its row and the two before it, and the
    flipped branches before it. None without a trail."""
    if not trail:
        return None
    hit = next((i for i, r in enumerate(trail) if r["gap"] >= at), None)
    end = len(trail) if hit is None else hit + 1
    return {"step": hit, "rows": trail[max(end - 3, 0):end],
            "flips_before": sum(r["flips"] for r in trail[:end - 1]),
            "widest_gap": max(r["gap"] for r in trail)}


def verdict(numbers: dict, limits: dict):
    """-> (correct, rows): each row (name, value, limit); a number that is
    not finite, or has no limit, fails."""
    rows = [(n, numbers[n], limits.get(n)) for n in NAMES if n in numbers]
    ok = all(lim is not None and math.isfinite(v) and v <= lim
             for _, v, lim in rows) and len(rows) == len(NAMES)
    return ok, rows
