"""Console monitoring tables (port of `wtw_tpu/utils/monitor.py`):
`monitor_table`, a fixed-width key/value table printer, the analog of the
Texttable console monitors (tasks/go2_parkour.py:1487-1600, algos/PPO.py
monitor():115-143) without the external texttable dependency. The runner
prints one every `RunnerArgs.console_table_freq` iterations.

The JAX module's `profile_trace` (a jax.profiler context) has its
counterpart in `wtw_tpu_torch.trace`, and its `PhaseTimer` in the host
spans of `wtw_tpu_torch.utils.spans`.
"""
from __future__ import annotations

from typing import Dict


def monitor_table(rows: Dict[str, float], title: str = "",
                  width: int = 34) -> str:
    """Render {name: value} as the reference's two-column console table."""
    lines = []
    if title:
        lines.append(f"============ {title} ============")
    lines.append(f"{'Element':<{width}} {'Mean Value':>12}")
    lines.append("-" * (width + 13))
    for k, v in rows.items():
        try:
            lines.append(f"{k:<{width}} {float(v):>12.4f}")
        except (TypeError, ValueError):
            lines.append(f"{k:<{width}} {str(v):>12}")
    return "\n".join(lines)

