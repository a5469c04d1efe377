"""Procedural sub-terrain generators (host-side numpy, build time; a copy
of `wtw_tpu/terrain/generators.py`, which imports nothing of JAX either).

The replacement for `isaacgym.terrain_utils` (behaviors consumed by the
reference at go1_gym/utils/terrain.py:114-159 and
tasks/terrainParkour.py:241-384):

- heights are float32 METERS (no int16 raw units / vertical_scale
  quantization: the engine queries heights directly);
- every generator takes an explicit `np.random.Generator`, so a terrain
  build is deterministic under a seed and bit-identical to the JAX
  package's for the same seed;
- generators write into a (L, W) array whose axis 0 is the track/"length"
  direction; `parkour.py` places them into the world map.

All of this runs once at env construction on the host.
"""
from __future__ import annotations

import numpy as np


def _px(meters: float, scale: float) -> int:
    return int(meters / scale)


def random_uniform(h: np.ndarray, rng: np.random.Generator, *,
                   min_height: float, max_height: float, step: float,
                   downsampled_scale: float, horizontal_scale: float) -> None:
    """Uniform noise drawn on a coarse grid, bilinearly upsampled
    (terrain_utils.random_uniform_terrain semantics; used at
    go1_gym/utils/terrain.py:135-137,152-157)."""
    L, W = h.shape
    n_vals = max(2, int((max_height - min_height) / step) + 1)
    levels = np.linspace(min_height, max_height, n_vals)
    cl = max(2, int(L * horizontal_scale / downsampled_scale))
    cw = max(2, int(W * horizontal_scale / downsampled_scale))
    coarse = rng.choice(levels, size=(cl, cw))
    # bilinear upsample to (L, W)
    xi = np.linspace(0, cl - 1, L)
    yi = np.linspace(0, cw - 1, W)
    x0 = np.floor(xi).astype(int)
    y0 = np.floor(yi).astype(int)
    x1 = np.minimum(x0 + 1, cl - 1)
    y1 = np.minimum(y0 + 1, cw - 1)
    dx = (xi - x0)[:, None]
    dy = (yi - y0)[None, :]
    up = (coarse[np.ix_(x0, y0)] * (1 - dx) * (1 - dy)
          + coarse[np.ix_(x1, y0)] * dx * (1 - dy)
          + coarse[np.ix_(x0, y1)] * (1 - dx) * dy
          + coarse[np.ix_(x1, y1)] * dx * dy)
    h += up.astype(h.dtype)


def pyramid_sloped(h: np.ndarray, *, slope: float, platform_size: float,
                   horizontal_scale: float) -> None:
    """Pyramid rising (slope>0) or sinking (slope<0) toward a flat center
    platform (terrain_utils.pyramid_sloped_terrain; used at
    go1_gym/utils/terrain.py:131-134)."""
    L, W = h.shape
    cx, cy = (L - 1) / 2, (W - 1) / 2
    # fraction of the way from border (0) to center (1), per axis, take min
    fx = 1.0 - np.abs(np.arange(L) - cx) / cx
    fy = 1.0 - np.abs(np.arange(W) - cy) / cy
    frac = np.minimum(fx[:, None], fy[None, :])
    max_h = slope * (L / 2) * horizontal_scale
    plat_frac = 1.0 - (platform_size / 2) / (cx * horizontal_scale)
    plat_frac = np.clip(plat_frac, 0.0, 1.0)
    ramp = np.clip(frac / max(plat_frac, 1e-6), 0.0, 1.0)
    h += (max_h * ramp).astype(h.dtype)


def pyramid_stairs(h: np.ndarray, *, step_width: float, step_height: float,
                   platform_size: float, horizontal_scale: float) -> None:
    """Concentric rectangular steps toward a center platform
    (terrain_utils.pyramid_stairs_terrain; go1_gym/utils/terrain.py:140-142)."""
    L, W = h.shape
    sw = max(1, _px(step_width, horizontal_scale))
    half_plat = max(1, _px(platform_size / 2, horizontal_scale))
    # ring index: how many full step_widths a cell is away from the border
    dist = np.minimum(
        np.minimum(np.arange(L)[:, None], (L - 1 - np.arange(L))[:, None]),
        np.minimum(np.arange(W)[None, :], (W - 1 - np.arange(W))[None, :]))
    ring = dist // sw
    max_dist = min(L, W) // 2 - half_plat
    max_ring = max(1, max_dist // sw)
    ring = np.minimum(ring, max_ring)
    h += (ring * step_height).astype(h.dtype)


def discrete_obstacles(h: np.ndarray, rng: np.random.Generator, *,
                       max_height: float, min_size: float, max_size: float,
                       num_rects: int, platform_size: float,
                       horizontal_scale: float) -> None:
    """Random rectangles at ± heights with a flat center platform
    (terrain_utils.discrete_obstacles_terrain; go1_gym/utils/terrain.py:143-148)."""
    L, W = h.shape
    heights = np.array([-max_height, -max_height / 2, max_height / 2, max_height])
    for _ in range(num_rects):
        w = _px(rng.uniform(min_size, max_size), horizontal_scale)
        l = _px(rng.uniform(min_size, max_size), horizontal_scale)
        x = rng.integers(0, max(1, L - l))
        y = rng.integers(0, max(1, W - w))
        h[x:x + l, y:y + w] = rng.choice(heights)
    # clear center platform
    x1 = max(0, (L - _px(platform_size, horizontal_scale)) // 2)
    y1 = max(0, (W - _px(platform_size, horizontal_scale)) // 2)
    x2, y2 = L - x1, W - y1
    h[x1:x2, y1:y2] = 0.0


def stepping_stones(h: np.ndarray, rng: np.random.Generator, *,
                    stone_size: float, stone_distance: float,
                    max_height: float, platform_size: float,
                    horizontal_scale: float, depth: float = -2.0) -> None:
    """Grid of stones separated by deep gaps
    (terrain_utils.stepping_stones_terrain; go1_gym/utils/terrain.py:149-151).
    The gap depth is capped at -2 m (the reference's -10 m only wastes
    contact-solver range; anything deeper than the robot can stand in is
    equivalent)."""
    L, W = h.shape
    ss = max(1, _px(stone_size, horizontal_scale))
    sd = max(1, _px(stone_distance, horizontal_scale))
    h[:] = depth
    pitch = ss + sd
    for x0 in range(0, L, pitch):
        # offset every row like the reference for stagger
        off = int(rng.integers(0, pitch))
        for y0 in range(-off, W, pitch):
            ys = slice(max(0, y0), min(W, y0 + ss))
            xs = slice(x0, min(L, x0 + ss))
            h[xs, ys] = rng.uniform(0.0, max_height) if max_height > 0 else 0.0
    # center platform
    x1 = max(0, (L - _px(platform_size, horizontal_scale)) // 2)
    y1 = max(0, (W - _px(platform_size, horizontal_scale)) // 2)
    x2, y2 = L - x1, W - y1
    h[x1:x2, y1:y2] = 0.0


# ----------------------------------------------------------------------
# Parkour tracks (tasks/terrainParkour.py:241-384). Track direction = axis 0.
# Lava moats run along both sides (axis 1 edges). Each returns nothing but
# mutates `h`; crawl also fills a `ceiling` array (underside height of
# overhead barriers, +inf where open sky).
# ----------------------------------------------------------------------

def _lava(h: np.ndarray, lava_width: float, lava_depth: float, scale: float):
    lw = _px(lava_width, scale)
    h[:, :lw] = lava_depth
    h[:, -lw:] = lava_depth


def gap_parkour(h: np.ndarray, rng: np.random.Generator, *,
                horizontal_scale: float, lava_depth: float = -1.0,
                gap_length: float = 0.5, platform_length: float = 1.0,
                gap_platform_length: tuple = (1.25, 1.5),
                gap_platform_height: float = 0.1,
                gap_depth: float = None,
                lava_width: float = 0.5) -> None:
    """Alternating gaps and slightly sunken platforms
    (tasks/terrainParkour.py:241-265).

    gap_depth: floor level of the gap slots; defaults to lava_depth (the
    reference's geometry). The soft-start curriculum uses a shallow trench
    at low difficulty so a misstep is recoverable instead of terminal."""
    L, _ = h.shape
    s = horizontal_scale
    pl = _px(platform_length, s)
    gl = max(1, _px(gap_length, s))
    gph = gap_platform_height
    gd = lava_depth if gap_depth is None else gap_depth
    start = pl
    while start + gl <= L - pl // 2:
        gpl = int(rng.integers(_px(gap_platform_length[0], s),
                               _px(gap_platform_length[1], s)))
        h[start:start + gl, :] = gd
        if start + gl + gpl <= L - pl // 2:
            h[start + gl:start + gl + gpl, :] = -gph
        start += gl + gpl
    _lava(h, lava_width, lava_depth, s)


def jump_parkour(h: np.ndarray, rng: np.random.Generator, *,
                 horizontal_scale: float, lava_depth: float = -1.0,
                 height: float = 0.5, platform_length: float = 1.25,
                 lava_width: float = 0.5) -> None:
    """Three concentric raised platforms: a 3-step box to jump on and off
    (tasks/terrainParkour.py:267-287)."""
    s = horizontal_scale
    pl = _px(platform_length, s)
    h[1 * pl:6 * pl, :] = 1 * height
    h[2 * pl:5 * pl, :] = 2 * height
    h[3 * pl:4 * pl, :] = 3 * height
    _lava(h, lava_width, lava_depth, s)


def stairs_parkour(h: np.ndarray, rng: np.random.Generator, *,
                   horizontal_scale: float, lava_depth: float = -1.0,
                   height: float = 0.18, width: float = 0.3,
                   platform_length: float = 1.0,
                   lava_width: float = 0.5) -> None:
    """Stairs up then down, pyramid-style along the track
    (tasks/terrainParkour.py:289-310)."""
    L, _ = h.shape
    s = horizontal_scale
    pl = _px(platform_length, s)
    wd = max(1, _px(width, s))
    start, stop = pl, L - pl // 2
    curr = height
    while stop - start > pl:
        h[start:stop, :] = curr
        curr += height
        start += wd
        stop -= wd
    _lava(h, lava_width, lava_depth, s)


def hurdle_parkour(h: np.ndarray, rng: np.random.Generator, *,
                   horizontal_scale: float, lava_depth: float = -1.0,
                   height: float = 0.2, platform_length: float = 1.5,
                   width_range: tuple = (0.3, 0.5),
                   lava_width: float = 0.5) -> None:
    """Thin raised bars across the track (tasks/terrainParkour.py:312-332)."""
    L, _ = h.shape
    s = horizontal_scale
    pl = _px(platform_length, s)
    wmin, wmax = _px(width_range[0], s), _px(width_range[1], s)
    start = pl
    width = int(rng.integers(wmin, wmax))
    while start + pl + width <= L - pl // 2:
        h[start:start + width, :] = height
        start += pl + width
        width = int(rng.integers(wmin, wmax))
    _lava(h, lava_width, lava_depth, s)


def crawl_parkour(h: np.ndarray, ceiling: np.ndarray,
                  rng: np.random.Generator, *,
                  horizontal_scale: float, lava_depth: float = -1.0,
                  height: float = 0.2, height_step: float = 0.15,
                  barrier_depth: float = 1.0,
                  lava_width: float = 0.5) -> None:
    """Overhead barriers to crawl under (tasks/terrainParkour.py:359-383).

    The reference realizes barriers as extra trimesh boxes (box_trimesh
    :385-413); here they live in a ceiling heightfield: `ceiling[x, y]` is
    the world-z of the lowest overhead obstacle's underside (+inf = open).
    Barrier 1 underside at `height` around x=2.5 m; barrier 2 at
    `height + height_step` around x=6.5 m, over a floor step of height_step
    at x in [6, 7] m."""
    s = horizontal_scale
    bd = _px(barrier_depth, s)
    c1 = _px(2.5, s)
    c2 = _px(6.5, s)
    ceiling[c1 - bd // 2:c1 + bd // 2, :] = height
    ceiling[c2 - bd // 2:c2 + bd // 2, :] = height + height_step
    h[_px(6.0, s):_px(7.0, s), :] = height_step
    _lava(h, lava_width, lava_depth, s)
