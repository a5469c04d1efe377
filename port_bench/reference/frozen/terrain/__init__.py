"""Terrain generation (host-side numpy at build time; port of
`wtw_tpu/terrain`).

- generators: sub-terrain primitives (replaces isaacgym.terrain_utils)
- stack_a: the `TerrainMap` container and the Stack-A curriculum grid
  (`build_terrain`, `assign_env_origins`)
- parkour: parkour tracks with lava + ceilings (tasks/terrainParkour.py)

`to_heightfield` and `ceiling_heightfield` put a map's ground and ceiling
grids on a device as the port's `HeightField`.
"""
from __future__ import annotations

from ..physics.heightfield import HeightField, make_heightfield
from .parkour import (CEILING_OPEN, ParkourTerrainCfg, assign_parkour_origins,
                      build_parkour)
from .stack_a import TerrainMap, assign_env_origins, build_terrain


def to_heightfield(tm: TerrainMap, device="cpu") -> HeightField:
    return make_heightfield(tm.heights, tm.horizontal_scale, tm.origin,
                            device=device)


def ceiling_heightfield(tm: TerrainMap, device="cpu") -> HeightField:
    if tm.ceilings_grid is None:
        raise ValueError("not a parkour terrain: it has no ceiling grid")
    return make_heightfield(tm.ceilings_grid, tm.horizontal_scale, tm.origin,
                            device=device)


__all__ = [
    "CEILING_OPEN", "HeightField", "ParkourTerrainCfg", "TerrainMap",
    "assign_env_origins", "assign_parkour_origins", "build_parkour",
    "build_terrain", "ceiling_heightfield", "to_heightfield",
]
