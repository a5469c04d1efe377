"""The terrain map container (port of `TerrainMap`,
`wtw_tpu/terrain/stack_a.py:29`).

One big heightfield of (num_rows x num_cols) sub-terrains (rows =
difficulty, cols = terrain type), the per-cell env origins, and for parkour
the per-cell ceilings and the ceiling grid. Built on the host with numpy;
`terrain.to_heightfield` and `terrain.ceiling_heightfield` put it on a
device. The Stack-A map constructors (`build_terrain`,
`assign_env_origins`) are ported with the go1_mob slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class TerrainMap:
    heights: np.ndarray          # (rows_px, cols_px) float32 meters
    horizontal_scale: float
    origin: np.ndarray           # (2,) world xy of heights[0, 0]
    env_origins: np.ndarray      # (num_rows_total, num_cols, 3)
    num_rows: int                # train difficulty levels
    num_cols: int                # terrain types
    num_eval_rows: int = 0
    ceilings: Optional[np.ndarray] = None        # (rows, cols) parkour only
    ceilings_grid: Optional[np.ndarray] = None   # (rows_px, cols_px) parkour only
