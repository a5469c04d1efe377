"""Heightfield terrain (port of `wtw_tpu/physics/heightfield.py`).

One heightfield is shared by all envs on a device. `is_flat` marks a
constant grid: the engine then fills the corner rows from `flat_value`
instead of gathering them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class HeightField:
    heights: torch.Tensor        # (H, W) float32 meters
    horizontal_scale: float      # meters per cell
    origin: torch.Tensor         # (2,) world xy of cell (0, 0)
    corners: torch.Tensor        # (H*W, 4) rows [h00, h10, h01, h11]
    is_flat: bool = False
    flat_value: float = 0.0

    @property
    def shape(self):
        return tuple(self.heights.shape)

    def to(self, device) -> "HeightField":
        return dataclasses.replace(
            self, heights=self.heights.to(device),
            origin=self.origin.to(device), corners=self.corners.to(device))


def pack_corners(heights: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H*W, 4) rows [h(i,j), h(i+1,j), h(i,j+1), h(i+1,j+1)]
    with edge clamping."""
    h = heights
    h_r = torch.cat([h[1:], h[-1:]], dim=0)          # i+1
    h_c = torch.cat([h[:, 1:], h[:, -1:]], dim=1)    # j+1
    h_rc = torch.cat([h_r[:, 1:], h_r[:, -1:]], dim=1)
    return torch.stack([h.reshape(-1), h_r.reshape(-1),
                        h_c.reshape(-1), h_rc.reshape(-1)], dim=-1)


def make_heightfield(heights, scale, origin, device="cpu") -> HeightField:
    h = torch.as_tensor(np.asarray(heights, np.float32), device=device)
    hn = h.cpu().numpy()
    flat = bool(np.all(hn == hn.flat[0]))
    return HeightField(
        heights=h, horizontal_scale=float(np.float32(scale)),
        origin=torch.as_tensor(np.asarray(origin, np.float32), device=device),
        corners=pack_corners(h), is_flat=flat,
        flat_value=float(hn.flat[0]) if flat else 0.0)


def flat_heightfield(extent: float = 40.0, scale: float = 0.5,
                     device="cpu") -> HeightField:
    n = int(extent / scale)
    return make_heightfield(np.zeros((n, n), np.float32), scale,
                            [-extent / 2, -extent / 2], device=device)


def _cell_coords(hf: HeightField, x: torch.Tensor, y: torch.Tensor):
    """Continuous cell coordinates, clipped inside the grid."""
    H, W = hf.shape
    u = torch.clamp((x - hf.origin[0]) / hf.horizontal_scale, 0.0, H - 1.001)
    v = torch.clamp((y - hf.origin[1]) / hf.horizontal_scale, 0.0, W - 1.001)
    return u, v


def corner_rows(hf: HeightField, x: torch.Tensor, y: torch.Tensor):
    """Corner rows + in-cell offsets at world xy (any matching shapes):
    ([h00, h10, h01, h11], du, dv), one packed row gather per point
    (`wtw_tpu/physics/batched.py:_hf_gather`)."""
    u, v = _cell_coords(hf, x, y)
    u0, v0 = torch.floor(u), torch.floor(v)
    W = hf.shape[1]
    base = u0.long() * W + v0.long()
    hc = hf.corners[base]                          # (..., 4)
    return list(hc.unbind(-1)), u - u0, v - v0


def height_min3(hf: HeightField, xy: torch.Tensor) -> torch.Tensor:
    """Min over the 3 nearest grid samples, the raycast semantics of the
    height scan and of foot clearance (`wtw_tpu/physics/heightfield.py:130`):
    min(h[i, j], h[i+1, j], h[i, j+1]); xy: (..., 2) -> (...)."""
    (h00, h10, h01, _), _, _ = corner_rows(hf, xy[..., 0], xy[..., 1])
    return torch.minimum(torch.minimum(h00, h10), h01)


def corner_heights(hf: HeightField, x: torch.Tensor, y: torch.Tensor):
    """`corner_rows`' values by four element gathers from the (H, W) grid
    instead of one packed-row gather: for many points (the depth camera's
    113 M at 1024 envs) PyTorch's gather of 16-byte rows is ~20x slower on
    the card than `torch.take` of single elements. The clipped cell
    coordinates keep i + 1 and j + 1 inside the grid, so the values are the
    packed rows' exactly."""
    u, v = _cell_coords(hf, x, y)
    u0, v0 = torch.floor(u), torch.floor(v)
    W = hf.shape[1]
    base = u0.long() * W + v0.long()
    flat = hf.heights.reshape(-1)
    return ([torch.take(flat, base + o) for o in (0, W, 1, W + 1)],
            u - u0, v - v0)


def bilinear(h, du, dv) -> torch.Tensor:
    """The bilinear patch over corners [h00, h10, h01, h11]."""
    h00, h10, h01, h11 = h
    return (h00 * (1 - du) * (1 - dv) + h10 * du * (1 - dv)
            + h01 * (1 - du) * dv + h11 * du * dv)


def height_at(hf: HeightField, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear terrain height at world xy; xy: (..., 2) -> (...)."""
    return bilinear(*corner_rows(hf, xy[..., 0], xy[..., 1]))
