"""Running-mean metric caches (a numpy copy of
`wtw_tpu/learn/metrics_caches.py`; reference
go1_gym_learn/ppo_cse/metrics_caches.py:6-90):
- DistCache: per-key running means over all logged values (:6-33);
- SlotCache: per-curriculum-bin running means, vectorized over bins
  (:47-78) — used to log per-bin episode rewards for the command
  curriculum dashboards.

Pure numpy on the host: these sit on the logging side.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np


class DistCache:
    def __init__(self):
        self.cache = defaultdict(lambda: 0.0)

    def log(self, **key_vals):
        """Accumulate running means (metrics_caches.py:11-25)."""
        for k, v in key_vals.items():
            v = np.asarray(v, dtype=np.float64)
            count = self.cache[f"{k}@counts"] + 1
            self.cache[f"{k}@counts"] = count
            self.cache[k] = self.cache[k] * (1 - 1 / count) \
                + np.mean(v) / count

    def get_summary(self):
        ret = {k: v for k, v in self.cache.items() if "@counts" not in k}
        self.cache.clear()
        return ret


class SlotCache:
    """Per-slot (curriculum-bin) running means (metrics_caches.py:47-78)."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.cache = defaultdict(lambda: np.zeros(n_slots))

    def log(self, slots, **key_vals):
        """slots: (B,) bin index per sample; key_vals: (B,) values."""
        slots = np.asarray(slots)
        for k, v in key_vals.items():
            v = np.asarray(v, dtype=np.float64)
            counts = np.zeros(self.n_slots)
            np.add.at(counts, slots, 1)
            sums = np.zeros(self.n_slots)
            np.add.at(sums, slots, v)
            prev_counts = self.cache[f"{k}@counts"]
            new_counts = prev_counts + counts
            safe = np.maximum(new_counts, 1)
            self.cache[k] = (self.cache[k] * prev_counts + sums) / safe
            self.cache[f"{k}@counts"] = new_counts

    def get_summary(self):
        ret = {k: v.copy() for k, v in self.cache.items()
               if "@counts" not in k}
        for k in list(self.cache.keys()):
            self.cache[k][:] = 0
        return ret
