"""Stack-A terrain map builder: the curriculum grid of sub-terrains (port of
`wtw_tpu/terrain/stack_a.py`, numpy only, bit-identical to it for one
seed).

Behavioral equivalent of go1_gym/utils/terrain.py:12-180 — one big
heightfield of (num_rows x num_cols) sub-terrains: rows = difficulty,
cols = terrain type (chosen by cumulative `terrain_proportions`); per-cell
env origins at the cell center with z = max height of the cell. A separate
eval cfg is appended as extra rows (Terrain.load_cfgs :38-53).

Runs once on the host at env construction; `terrain.to_heightfield` puts
the map on a device, and the origins feed `LeggedEnv`. The parkour maps
(`terrain/parkour.py`) use the same `TerrainMap` container.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config import TerrainCfg
from . import generators as G

# index meaning of terrain_proportions (go1_gym/utils/terrain.py:126-159):
# 0 smooth pyramid slope (± sign), 1 rough slope, 2 stairs up, 3 stairs down,
# 4 discrete obstacles, 5 stepping stones, 6 gap (unimplemented -> flat),
# 7 pit (unimplemented -> flat), 8 rough flat, 9 rough flat w/ half cleared


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


def _make_subterrain(cfg: TerrainCfg, choice: float, difficulty: float,
                     proportions, rng: np.random.Generator,
                     L: int, W: int) -> np.ndarray:
    """One sub-terrain cell (make_terrain, go1_gym/utils/terrain.py:114-159)."""
    h = np.zeros((L, W), np.float32)
    s = cfg.horizontal_scale
    slope = difficulty * 0.4
    step_height = 0.05 + 0.18 * difficulty
    max_platform_height = 0.2   # Cfg.terrain default (legged_robot_config.py)
    obstacle_height = 0.05 + difficulty * (max_platform_height - 0.05)
    stone_size = 1.5 * (1.05 - difficulty)
    stone_distance = 0.05 if difficulty == 0 else 0.1

    if choice < proportions[0]:
        if choice < proportions[0] / 2:
            slope *= -1
        G.pyramid_sloped(h, slope=slope, platform_size=3.0, horizontal_scale=s)
    elif choice < proportions[1]:
        G.pyramid_sloped(h, slope=slope, platform_size=3.0, horizontal_scale=s)
        G.random_uniform(h, rng, min_height=-0.05, max_height=0.05,
                         step=cfg.terrain_smoothness, downsampled_scale=0.2,
                         horizontal_scale=s)
    elif choice < proportions[3]:
        if choice < proportions[2]:
            step_height *= -1
        G.pyramid_stairs(h, step_width=0.31, step_height=step_height,
                         platform_size=3.0, horizontal_scale=s)
    elif choice < proportions[4]:
        G.discrete_obstacles(h, rng, max_height=obstacle_height,
                             min_size=1.0, max_size=2.0, num_rects=20,
                             platform_size=3.0, horizontal_scale=s)
    elif choice < proportions[5]:
        G.stepping_stones(h, rng, stone_size=stone_size,
                          stone_distance=stone_distance, max_height=0.0,
                          platform_size=4.0, horizontal_scale=s)
    elif choice < proportions[6]:
        pass   # gap: unimplemented in the reference too (terrain.py:152)
    elif choice < proportions[7]:
        pass   # pit: unimplemented in the reference too (terrain.py:154)
    elif choice < proportions[8]:
        G.random_uniform(h, rng, min_height=-cfg.terrain_noise_magnitude,
                         max_height=cfg.terrain_noise_magnitude, step=0.005,
                         downsampled_scale=0.2, horizontal_scale=s)
    elif choice < (proportions[9] if len(proportions) > 9 else 0):
        G.random_uniform(h, rng, min_height=-0.05, max_height=0.05,
                         step=cfg.terrain_smoothness, downsampled_scale=0.2,
                         horizontal_scale=s)
        h[: L // 2, :] = 0.0
    return h


def build_terrain(cfg: TerrainCfg, seed: int = 0,
                  eval_cfg: Optional[TerrainCfg] = None) -> TerrainMap:
    """Build the full terrain map. rows = difficulty (x axis), cols = type
    (y axis), as the reference lays them out (add_terrain_to_map,
    go1_gym/utils/terrain.py:161-180): the map starts at world (0, 0) minus
    the border, and cell (i, j)'s env origin is at its center."""
    rng = np.random.default_rng(seed)
    s = cfg.horizontal_scale
    L = int(cfg.terrain_length / s)      # per-cell pixels along x
    W = int(cfg.terrain_width / s)       # per-cell pixels along y
    border = int(cfg.border_size / s)

    cfgs = [cfg] + ([eval_cfg] if eval_cfg is not None else [])
    total_rows = sum(c.num_rows for c in cfgs)
    tot_x = total_rows * L + 2 * border
    tot_y = max(c.num_cols for c in cfgs) * W + 2 * border
    heights = np.zeros((tot_x, tot_y), np.float32)
    env_origins = np.zeros((total_rows, cfg.num_cols, 3), np.float32)

    row_off = 0
    for c in cfgs:
        proportions = np.cumsum(c.terrain_proportions)
        for j in range(c.num_cols):
            for i in range(c.num_rows):
                if c.curriculum:
                    difficulty = i / c.num_rows * c.difficulty_scale
                    choice = j / c.num_cols + 0.001
                else:
                    choice = rng.uniform(0, 1)
                    difficulty = rng.choice([0.5, 0.75, 0.9])
                cell = _make_subterrain(c, choice, difficulty, proportions,
                                        rng, L, W)
                gi = row_off + i
                x0, y0 = border + gi * L, border + j * W
                heights[x0:x0 + L, y0:y0 + W] = cell
                env_origins[gi, j] = [
                    (gi + 0.5) * c.terrain_length,
                    (j + 0.5) * c.terrain_width,
                    float(cell.max())]
        row_off += c.num_rows

    return TerrainMap(
        heights=heights, horizontal_scale=s,
        origin=np.array([-cfg.border_size, -cfg.border_size], np.float32),
        env_origins=env_origins, num_rows=cfg.num_rows, num_cols=cfg.num_cols,
        num_eval_rows=(eval_cfg.num_rows if eval_cfg is not None else 0))


def assign_env_origins(tm: TerrainMap, num_envs: int, cfg: TerrainCfg,
                       seed: int = 0):
    """Initial (terrain_level, terrain_type) per env and the resulting
    origins (_get_env_origins, legged_robot.py:1675-1704).

    Returns (env_origins (N, 3), terrain_levels (N,), terrain_types (N,))."""
    rng = np.random.default_rng(seed + 1)
    if cfg.center_robots:
        lo_r = max(0, cfg.num_rows // 2 - cfg.center_span)
        hi_r = min(cfg.num_rows - 1, cfg.num_rows // 2 + cfg.center_span - 1)
        lo_c = max(0, cfg.num_cols // 2 - cfg.center_span)
        hi_c = min(cfg.num_cols - 1, cfg.num_cols // 2 + cfg.center_span - 1)
        levels = rng.integers(lo_r, hi_r + 1, num_envs)
        types = rng.integers(lo_c, hi_c + 1, num_envs)
    else:
        max_lvl = (cfg.max_init_terrain_level if cfg.curriculum
                   else cfg.num_rows - 1)
        min_lvl = cfg.min_init_terrain_level if cfg.curriculum else 0
        levels = rng.integers(min_lvl, max_lvl + 1, num_envs)
        types = (np.arange(num_envs) // (num_envs / cfg.num_cols)).astype(int)
    origins = tm.env_origins[levels, types]
    return (origins.astype(np.float32), levels.astype(np.int32),
            types.astype(np.int32))
