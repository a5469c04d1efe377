"""Helpers the per-layer metric readers (`metrics/<name>.py`) share. A
reader takes the traced run's record: `summary` (from `profile.py`: the
traced stretch's device ops by name, busy and window seconds, host ranges'
device time, idle gaps), `iterations` and `window_s` of the unprofiled
window, its `rollout_s` and `update_s` per iteration, `flops_per_iteration`,
`dims` and the `cell`. It returns None where it finds nothing to read."""
from __future__ import annotations


def group(name: str) -> str:
    """The port's trace grouping of a device op (`wtw_tpu_torch/trace.py`
    `_group`, copied)."""
    n = name.lower()
    if "wtw_fk" in n:
        return "kernel A (fk)"
    if "wtw_dynamics" in n:
        return "kernel B (dynamics)"
    if ("gemm" in n or "cutlass" in n or "sm90_" in n or "xmma" in n
            or "nvjet" in n):
        return "matrix products"
    if "gather" in n:
        return "gathers"
    return "other kernels"


def device_traced(rec) -> bool:
    s = rec.get("summary")
    return bool(s and s["ops"] and s["busy_s"] > 0)


def per_iteration_ms(rec, pick) -> float | None:
    """Device ms a traced iteration of the ops whose names `pick` takes."""
    if not device_traced(rec):
        return None
    s = rec["summary"]
    us = sum(v[0] for k, v in s["ops"].items() if pick(k))
    return us / 1e3 / s["iterations"] if us > 0 else None


def us_per_launch(rec, pick):
    """(device us a launch, launches) of the ops `pick` takes."""
    if not device_traced(rec):
        return None, 0
    hits = [v for k, v in rec["summary"]["ops"].items() if pick(k)]
    n = sum(c for _, c in hits)
    return (sum(us for us, _ in hits) / n if n else None), n
