"""Mixed-robot batches (port of `wtw_tpu/models/multi.py`).

Go1, Go2, B1 and the mini-cheetah share one kinematic topology (13 bodies,
12 joints, the same tree), so one batch can mix them: `stack_models` stacks
their array fields along a leading robot axis and `assign_robots` gives each
env a robot, as a per-env model whose array fields carry the env axis.

Sphere counts differ per robot; spheres are padded to the largest count
with radius -1e3, label 0 (base) and leg -1. A negative radius puts a
sphere out of contact with the ground (depth = (z - h) n_z + r < 0) and with
the ceiling (depth = z + r - ceil < 0), so its force is exactly zero. Padded
spheres sit on the base's origin (body 0, offset 0).

The per-env model is what both kernel wrappers take: the kernels stage
its stack (one `WtwModel` per robot) and read its per-env robot index
(`RobotModel.robot`); the plain versions read its per-env fields.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .robot import RobotModel, _make

PAD_RADIUS = -1e3


def _pad_spheres(static, max_p: int):
    p = int(static["sph_body"].shape[0])
    if p == max_p:
        return static
    extra = max_p - p
    pad = dict(sph_body=np.zeros(extra, np.int32),
               sph_pos=np.zeros((extra, 3), np.float32),
               sph_radius=np.full(extra, PAD_RADIUS, np.float32),
               sph_label=np.zeros(extra, np.int32),
               sph_leg=np.full(extra, -1, np.int32))
    return {k: (np.concatenate([v, pad[k]]) if k in pad else v)
            for k, v in static.items()}


def stack_models(models: Sequence[RobotModel]) -> RobotModel:
    """Stack same-topology robots into one model with a leading robot axis
    on every array field. Names, the tree and `fixed_base` come from the
    first model; the name is the robots' names joined by '+'."""
    base = models[0]
    for m in models[1:]:
        if m.parent_static != base.parent_static \
                or m.nj != base.nj or m.nb != base.nb:
            raise ValueError("a mixed-robot batch needs robots of one "
                             "topology")
    max_p = max(m.P for m in models)
    padded = [_pad_spheres(m.static, max_p) for m in models]
    static = {k: np.stack([p[k] for p in padded]) for k in base.static}
    return _make("+".join(m.name for m in models), base.joint_names,
                 base.body_names, base.fixed_base, static, base.device)


def assign_robots(stacked: RobotModel, num_envs: int,
                  proportions: Sequence[float] | None = None,
                  seed: int = 0):
    """Per-env model of a stack: env i gets robot `assignment[i]`,
    `arange(N) % R`, or drawn with `proportions` from
    `numpy.random.default_rng(seed)` as the JAX package draws it.
    -> (per-env model, assignment (N,) int)."""
    n_robots = int(stacked.static["mass"].shape[0])
    if proportions is None:
        assignment = np.arange(num_envs) % n_robots
    else:
        rng = np.random.default_rng(seed)
        assignment = rng.choice(n_robots, size=num_envs,
                                p=np.asarray(proportions))
    return stacked.take(assignment), assignment


def robot_of(stacked: RobotModel, r: int) -> RobotModel:
    """Robot r of a stack, sphere-padded as the stack holds it."""
    return _make(stacked.name.split("+")[r], stacked.joint_names,
                 stacked.body_names, stacked.fixed_base,
                 {k: v[r] for k, v in stacked.static.items()}, stacked.device)
