"""Offline trajectory rendering (port of `wtw_tpu/utils/video.py`).

The reference logs training videos through Isaac Gym camera sensors
(legged_robot.py:1611-1673, an mp4 every save_video_interval iterations).
Here, as in the JAX package, a video is recorded and then rendered: one
env's state trajectory (base pose and joint angles) is recorded on the
device through the env's step (both physics kernels on the card), read
back once at the end, and drawn with matplotlib as the robot's kinematic
skeleton over the terrain profile, into an mp4 (ffmpeg) or else a GIF
(pillow). matplotlib is imported inside `render_trajectory` only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Trajectory:
    base_pos: np.ndarray     # (T, 3)
    base_quat: np.ndarray    # (T, 4)
    joint_q: np.ndarray      # (T, nj)


@torch.no_grad()
def record_rollout(env, policy_fn, steps: int = 250, seed: int = 0,
                   env_index: int = 0, commands=None) -> Trajectory:
    """Roll `policy_fn(obs_dict) -> actions` from `env.init_state(seed)`
    for `steps` policy steps (every env's command pinned to `commands`
    where given) and record env `env_index`'s state. The trace stays on
    the device until one read-back at the end."""
    from ..learn.eval_metrics import rollout
    i = env_index
    tr = rollout(env, policy_fn, steps, seed, commands,
                 lambda world, rew: {"s": torch.cat([
                     world.env.phys.base_pos[i], world.env.phys.base_quat[i],
                     world.env.phys.joint_q[i]])})
    s = tr["s"].cpu().numpy()                       # the one read-back
    return Trajectory(s[:, :3].copy(), s[:, 3:7].copy(), s[:, 7:].copy())


def render_trajectory(traj: Trajectory, model, hf=None,
                      path: str = "rollout.mp4", fps: int = 50,
                      stride: int = 2) -> str:
    """Render a recorded trajectory as a side and a top view, the leg
    skeleton from the model's forward kinematics (`physics.engine.fk`, the
    plain version, on the CPU). Saves an mp4 through ffmpeg, else a GIF
    through pillow; -> the path written."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    from ..physics.engine import fk

    model = model.to("cpu")
    frames = range(0, len(traj.base_pos), stride)
    fig, (ax_side, ax_top) = plt.subplots(2, 1, figsize=(8, 8))
    if hf is not None:
        heights = hf.heights.cpu().numpy()
        origin = hf.origin.cpu().numpy()
        scale = float(hf.horizontal_scale)
    chains = _leg_chains(model)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))

    def draw(t):
        ax_side.clear()
        ax_top.clear()
        body_pos = fk(model, f32(traj.base_pos[t]), f32(traj.base_quat[t]),
                      f32(traj.joint_q[t]))[0].numpy()
        bx, by, bz = traj.base_pos[t]
        if hf is not None:
            xs = np.linspace(bx - 1.5, bx + 1.5, 60)
            iu = np.clip(((xs - origin[0]) / scale).astype(int), 0,
                         heights.shape[0] - 1)
            iv = np.clip(int((by - origin[1]) / scale), 0,
                         heights.shape[1] - 1)
            ax_side.fill_between(xs, -1.0, heights[iu, iv], color="0.8")
        for chain in chains:
            pts = body_pos[chain]
            ax_side.plot(pts[:, 0], pts[:, 2], "o-", lw=2, ms=3)
            ax_top.plot(pts[:, 0], pts[:, 1], "o-", lw=2, ms=3)
        ax_side.plot([bx], [bz], "ks", ms=8)
        ax_top.plot([bx], [by], "ks", ms=8)
        ax_side.set_xlim(bx - 1.5, bx + 1.5)
        ax_side.set_ylim(bz - 0.8, bz + 0.8)
        ax_side.set_ylabel("z [m]")
        ax_top.set_xlim(bx - 1.5, bx + 1.5)
        ax_top.set_ylim(by - 1.0, by + 1.0)
        ax_top.set_ylabel("y [m]")
        ax_side.set_title(f"t = {t * 0.02:.2f} s")

    anim = animation.FuncAnimation(fig, draw, frames=frames,
                                   interval=1000 / fps * stride)
    try:
        anim.save(path, writer="ffmpeg", fps=fps // stride)
    except Exception:
        path = path.rsplit(".", 1)[0] + ".gif"
        anim.save(path, writer="pillow", fps=max(fps // stride, 1))
    plt.close(fig)
    return path


def _leg_chains(model):
    """Body-index chains base -> hip -> thigh -> calf, one per leg, from
    the parent table."""
    parent = list(model.parent_static)
    children = {p for p in parent[1:]}
    leaves = [i for i in range(len(parent)) if i not in children and i > 0]
    chains = []
    for leaf in leaves:
        chain = [leaf]
        while chain[-1] != 0:
            chain.append(parent[chain[-1]])
        chains.append(list(reversed(chain)))
    return chains
