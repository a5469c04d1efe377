"""Pseudo-depth camera: ray-marched heightfield depth images (port of
`wtw_tpu/envs/depth.py`).

The reference renders the robot's camera with Isaac Gym's rasterizer
(tasks/go2_parkour.py:761-808). The only scene geometry is the terrain
heightfield (and the robot's own collision spheres), so each pixel's ray is
marched against the heightfield instead: `march_steps` samples between the
near and far clip, the depth is the first sample below the ground, and the
frame is normalized to [0, 1] like the reference's processed depth
(:800-802).

With `model`, the robot's collision spheres are composited into the frame
by closed-form ray-sphere intersection. Their world centres come from
kernel A (`physics/kernels.fk`, its `fk_p` rows) on a CUDA tensor and from
its plain version on a CPU tensor, so every rendered frame launches kernel
A once on the card. The march and the ray-sphere test are plain torch; the
ground under the march's samples is read with four element gathers from
the height grid (`heightfield.corner_heights`), the heightfield's bilinear
patch at each sample as `height_at` gives it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..physics import kernels
from ..physics.heightfield import HeightField, bilinear, corner_heights
from ..utils import spans
from ..utils.quat import quat_rotate


# the span around the march's ground lookups (`trace.py --task vision`
# reads its device time from its profiler ranges)
MARCH_RANGE = "depth_march_ground"


@dataclass(frozen=True)
class DepthCameraCfg:
    # cfg/task/Go2Parkour.yaml env.depth (:215-223)
    height: int = 48
    width: int = 48          # reference crops 85 -> 48 (:523, [..., 19:-18])
    position: tuple = (0.3, 0.0, 0.1)   # camera offset in base frame
    pitch_deg: float = 0.0   # randomized ±5° in the reference (:778)
    horizontal_fov_deg: float = 87.0
    clip_min: float = 0.04
    clip_max: float = 1.0
    march_steps: int = 48    # samples along each ray
    update_interval: int = 5


def _pixel_dirs(cfg: DepthCameraCfg) -> np.ndarray:
    """Unit ray directions in the camera frame (x forward, y left, z up),
    (H, W, 3) float32. The 87° hfov spans the native 85-px width and the
    48 x 48 crop keeps its central 48/85 (go2_parkour.py:523), a ~56° x 56°
    square."""
    hfov = np.radians(cfg.horizontal_fov_deg)
    native_w = 85 if cfg.width <= 64 else cfg.width
    tan_h = np.tan(hfov / 2) * cfg.width / native_w
    tan_v = tan_h * cfg.height / cfg.width
    v = np.linspace(tan_v, -tan_v, cfg.height)     # top -> bottom
    u = np.linspace(tan_h, -tan_h, cfg.width)      # left -> right
    vv, uu = np.meshgrid(v, u, indexing="ij")
    dirs = np.stack([np.ones_like(uu), uu, vv], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pitch = np.radians(cfg.pitch_deg)
    # pitch the camera down by rotating about +y
    c, s = np.cos(pitch), np.sin(pitch)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return (dirs @ R.T).astype(np.float32)


def sphere_centres(model, base_pos, base_quat, joint_q) -> torch.Tensor:
    """World centres of the robot's collision spheres, (N, K, 3): kernel A
    on CUDA tensors, its plain version on CPU tensors."""
    fk_in = torch.cat([base_pos, base_quat, joint_q], dim=1).T.contiguous()
    _, fk_p = kernels.fk(model, fk_in)
    return fk_p.permute(2, 1, 0)


def make_depth_fn(hf: HeightField, cfg: DepthCameraCfg = DepthCameraCfg(),
                  model=None):
    """-> render(base_pos (N, 3), base_quat (N, 4)) -> (N, H, W) float32 in
    [0, 1] (0 at the near clip, 1 at the far clip). With `model` (the
    robot's `RobotModel`) render takes a third argument, joint_q (N, nj),
    and the robot's spheres are drawn into the frame."""
    dev = hf.heights.device
    dirs_cam = torch.from_numpy(_pixel_dirs(cfg).reshape(-1, 3)).to(dev)
    cam_off = torch.tensor(cfg.position, dtype=torch.float32, device=dev)
    ts = torch.linspace(cfg.clip_min, cfg.clip_max, cfg.march_steps,
                        device=dev)
    span = cfg.clip_max - cfg.clip_min

    def terrain_depth(base_pos, base_quat):
        # the camera is body-fixed: the full base rotation turns its rays
        origin = base_pos + quat_rotate(base_quat, cam_off.expand_as(base_pos))
        d_world = quat_rotate(base_quat[:, None, :], dirs_cam[None])  # (N, P, 3)
        # sample points (N, P, S), one coordinate at a time
        at = lambda c: origin[:, c, None, None] + d_world[..., c, None] * ts
        with spans.span(MARCH_RANGE):
            ground = bilinear(*corner_heights(hf, at(0), at(1)))
        # the first marched sample below the terrain (argmax of an integer
        # tensor returns the first maximal index); clip_max when none
        below = (at(2) <= ground).to(torch.uint8)
        depth = torch.where(below.amax(-1) > 0,
                            ts[torch.argmax(below, dim=-1)], cfg.clip_max)
        return depth, origin, d_world

    def norm_img(depth):
        return ((depth - cfg.clip_min) / span).reshape(
            -1, cfg.height, cfg.width)

    if model is None:
        def render(base_pos, base_quat):
            return norm_img(terrain_depth(base_pos, base_quat)[0])
        return render

    radius2 = model.sph_radius.to(dev) ** 2

    def render_legs(base_pos, base_quat, joint_q):
        depth, origin, d_world = terrain_depth(base_pos, base_quat)
        oc = sphere_centres(model, base_pos, base_quat, joint_q) \
            - origin[:, None, :]                                 # (N, K, 3)
        b = torch.bmm(d_world, oc.transpose(1, 2))               # (N, P, K)
        disc = b * b - ((oc * oc).sum(-1) - radius2)[:, None, :]
        t = b - torch.sqrt(torch.clamp_min(disc, 0.0))           # near root
        hit = (disc > 0.0) & (t > cfg.clip_min)
        t_sph = torch.where(hit, t, cfg.clip_max).amin(-1)
        return norm_img(torch.minimum(depth, t_sph))

    return render_legs
