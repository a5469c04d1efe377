"""Parkour terrain maps (Stack B; port of `wtw_tpu/terrain/parkour.py`,
numpy only, bit-identical to it for one seed).

Behavioral equivalent of tasks/terrainParkour.py:15-231 — procedural parkour
tracks laid out as (numLevels rows of difficulty) × (numTerrains cols of
type), with lava moats around every track, per-cell ceilings for the crawl
tracks, and env origins at the START of each track (the robot runs along +x,
terrain-level promotion at 0.8 × track length; go2_parkour.py:1158-1186).

The reference's ceiling trimesh boxes (box_trimesh :385) become a second
heightfield: `ceilings_grid[x, y]` = world-z of the lowest overhead obstacle
underside (CEILING_OPEN where open sky). The physics engine applies a
downward contact against it, and the env reads per-cell `ceilings` for
observations/constraints (go2_parkour.py:1313-1316).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from . import generators as G
from .stack_a import TerrainMap

CEILING_OPEN = 1e6   # "no ceiling" sentinel, metres


@dataclass(frozen=True)
class ParkourTerrainCfg:
    # cfg/task/Go2Parkour.yaml env.terrain block
    horizontal_scale: float = 0.05
    border_size: float = 8.0
    map_length: float = 12.0      # track length (x)
    map_width: float = 4.0        # track width (y)
    num_levels: int = 10          # difficulty rows
    num_terrains: int = 20        # type columns
    easy_mode: bool = False
    # Soft-start curriculum (round-5 adjudication, BASELINE.md): level-0
    # obstacles shrink to trivially-traversable sizes (2 cm hurdles/steps,
    # shallow 8 cm trenches) and ramp to the REFERENCE'S FULL-difficulty
    # geometry by the top rows. The reference relies on PhysX contact
    # offset/solver compliance to make its 5-15 cm level-0 obstacles
    # survivable often enough for PPO to discover traversal; under the
    # spring-damper heightfield engine those encounters are ~100% terminal
    # (knee/base contact) and 1500 dedicated iterations never sample one
    # success (runs/diag_{hurdle,gap}_scratch). Softening only the first
    # rungs restores the discovery ladder without weakening the endpoint.
    soft_start: bool = False
    curriculum: bool = True
    min_init_map_level: int = 0
    max_init_map_level: int = 0
    # proportions dict in yaml order (Go2Parkour.yaml:46-52); cumulated over
    # nonzero entries like the reference (terrainParkour.py:24-33)
    proportions: Tuple[Tuple[str, float], ...] = (
        ("gap_parkour", 0.2), ("jump_parkour", 0.2), ("stairs_parkour", 0.2),
        ("hurdle_parkour", 0.2), ("crawl_parkour", 0.2),
        ("random_uniform", 0.0), ("flat", 0.0))
    default_ceiling: float = 0.4


def build_parkour(cfg: ParkourTerrainCfg, seed: int = 0) -> TerrainMap:
    rng = np.random.default_rng(seed)
    s = cfg.horizontal_scale
    L = int(cfg.map_length / s)
    W = int(cfg.map_width / s)
    border = int(cfg.border_size / s)
    tot_x = cfg.num_levels * L + 2 * border
    tot_y = cfg.num_terrains * W + 2 * border
    heights = np.zeros((tot_x, tot_y), np.float32)
    ceilings_grid = np.full((tot_x, tot_y), CEILING_OPEN, np.float32)
    env_origins = np.zeros((cfg.num_levels, cfg.num_terrains, 3), np.float32)
    cell_ceilings = np.full((cfg.num_levels, cfg.num_terrains),
                            cfg.default_ceiling, np.float32)

    keys, cum = [], []
    total = 0.0
    for k, v in cfg.proportions:
        if v != 0.0:
            total += float(v)
            keys.append(k)
            cum.append(round(total, 2))

    for j in range(cfg.num_terrains):
        for i in range(cfg.num_levels):
            h = np.zeros((L, W), np.float32)
            ceil = np.full((L, W), CEILING_OPEN, np.float32)
            difficulty = i / max(cfg.num_levels - 1.0, 1.0)
            choice = j / cfg.num_terrains
            lava_depth = -float(rng.uniform(0.7, 1.3))
            ceiling = cfg.default_ceiling

            k = 0
            while k < len(cum) and choice >= cum[k]:
                k += 1
            kind = keys[k] if k < len(keys) else "flat"

            # Soft-start ramps are QUADRATIC in difficulty: the round-5
            # L0-linear ramp produced 97-100% deterministic crossing at
            # level 0 but stalled by level 3 (+3.7 cm/promotion was too
            # steep — results/parkour_soft_r5/diag_*). Quadratic ramps
            # densify the early rungs while keeping the SAME reference-full
            # endpoints at the top row.
            ss = cfg.soft_start
            d2 = difficulty * difficulty
            if kind == "gap_parkour":
                if ss:
                    # 6 cm slot -> the reference's 0.6 m at the top row;
                    # slot floor: recoverable 10 cm trench -> lava by d~0.7
                    gap_length = round(0.06 + 0.54 * d2, 2)
                    gap_depth = max(lava_depth, -(0.1 + 2.0 * d2))
                    gph = min(0.1, 0.02 + 0.2 * d2)
                else:
                    gap_length = round(0.15 + i * 0.05, 2)  # terrainParkour.py:155
                    gap_depth, gph = None, 0.1
                G.gap_parkour(h, rng, horizontal_scale=s,
                              lava_depth=lava_depth, gap_length=gap_length,
                              gap_depth=gap_depth, gap_platform_height=gph)
            elif kind == "jump_parkour":
                if ss:
                    height = 0.02 + 0.48 * d2            # -> full 0.5 at top
                else:
                    height = (0.05 + 0.37 * difficulty if cfg.easy_mode
                              else 0.05 + 0.45 * difficulty)
                G.jump_parkour(h, rng, horizontal_scale=s,
                               lava_depth=lava_depth, height=height)
            elif kind == "stairs_parkour":
                G.stairs_parkour(h, rng, horizontal_scale=s,
                                 lava_depth=lava_depth,
                                 height=(0.02 + 0.18 * d2 if ss
                                         else 0.02 + 0.18 * difficulty))
            elif kind == "hurdle_parkour":
                height = (0.02 + 0.33 * d2 if ss         # -> full 0.35
                          else 0.05 + 0.3 * difficulty)
                G.hurdle_parkour(h, rng, horizontal_scale=s,
                                 lava_depth=lava_depth, height=height)
            elif kind == "crawl_parkour":
                ceiling = (0.38 - 0.12 * d2 if ss        # -> full 0.26
                           else 0.34 - 0.08 * difficulty)  # terrainParkour.py:191
                step_h = 0.02 + 0.13 * d2 if ss else 0.15  # -> full 0.15
                G.crawl_parkour(h, ceil, rng, horizontal_scale=s,
                                lava_depth=lava_depth, height=ceiling,
                                height_step=step_h)
            elif kind == "random_uniform":
                pass   # add_roughness is a no-op in the reference (:233-241)

            x0, y0 = border + i * L, border + j * W
            heights[x0:x0 + L, y0:y0 + W] = h
            ceilings_grid[x0:x0 + L, y0:y0 + W] = ceil
            # origin at track START (terrainParkour.py:226-229)
            env_origins[i, j] = [i * cfg.map_length,
                                 (j + 0.5) * cfg.map_width, 0.0]
            cell_ceilings[i, j] = ceiling

    return TerrainMap(
        heights=heights, horizontal_scale=s,
        origin=np.array([-cfg.border_size, -cfg.border_size], np.float32),
        env_origins=env_origins, num_rows=cfg.num_levels,
        num_cols=cfg.num_terrains, ceilings=cell_ceilings,
        ceilings_grid=ceilings_grid)


def assign_parkour_origins(tm: TerrainMap, num_envs: int,
                           cfg: ParkourTerrainCfg, seed: int = 0):
    """Initial per-env (level, type) (go2_parkour.py:404-431): random level
    in [minInit, maxInit], type = env index striped over columns."""
    rng = np.random.default_rng(seed + 1)
    levels = rng.integers(cfg.min_init_map_level,
                          cfg.max_init_map_level + 1, num_envs)
    types = (np.arange(num_envs) //
             (num_envs / cfg.num_terrains)).astype(int) % cfg.num_terrains
    origins = tm.env_origins[levels, types]
    return origins.astype(np.float32), levels.astype(np.int32), types.astype(np.int32)
