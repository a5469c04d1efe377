"""The mixed-robot LeggedEnv factory (port of `wtw_tpu/envs/multi_env.py`).

Builds one LeggedEnv whose batch mixes robots of one topology (Go1, Go2,
B1, the mini-cheetah; `models/multi.py`): each env's model rides the env
axis, so one learner trains every robot in one batch. Each robot keeps the
constants of its own `<robot>_flat` preset: PD gains, spawn height and
default joint angles, the last resolved against the robot's own joint order
(Go1 lists FR first, Go2 FL first).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import PRESETS, Cfg
from ..models.multi import assign_robots, stack_models
from ..models.robot import default_joint_angles, load_robot
from .legged_env import LeggedEnv


def make_multi_legged_env(cfg: Cfg, robots: Sequence[str] = ("go1", "go2"),
                          proportions: Sequence[float] | None = None,
                          seed: int = 0, device=None) -> LeggedEnv:
    """LeggedEnv over a mixed-robot batch on flat ground.
    `env.robot_assignment` (N,) says which robot each env is,
    `env.robot_names` the robots' order. B1 gets kp 100, kd 2.5 and a
    0.8 m spawn height beside Go1's 20, 0.5 and 0.30 m: one shared go1
    config leaves the heavy robots born collapsed (the JAX package's
    round-5 fix)."""
    models = [load_robot(r) for r in robots]
    rcfgs = [PRESETS[f"{r}_flat"](cfg.env.num_envs)
             if f"{r}_flat" in PRESETS else cfg for r in robots]
    dqs = [default_joint_angles(m, dict(rc.init_state.default_joint_angles))
           .numpy() for m, rc in zip(models, rcfgs)]
    per_env, assignment = assign_robots(stack_models(models),
                                        cfg.env.num_envs, proportions,
                                        seed=seed)
    a = np.asarray(assignment)
    nj = models[0].nj
    per_robot = lambda rows: np.asarray(rows, np.float32)[a]
    env = LeggedEnv(
        cfg, per_env, device=device,
        default_joint_q_override=per_robot(dqs),
        per_env_control={
            "p_gains": per_robot([[rc.control.stiffness] * nj
                                  for rc in rcfgs]),
            "d_gains": per_robot([[rc.control.damping] * nj
                                  for rc in rcfgs]),
            "init_pos": per_robot([rc.init_state.pos for rc in rcfgs])})
    env.robot_assignment = a
    env.robot_names = tuple(robots)
    return env


def robot_masks(env: LeggedEnv) -> torch.Tensor:
    """(R, N) float 0/1 masks of each robot's envs, on the env's device."""
    a = torch.as_tensor(env.robot_assignment, device=env.device)
    return torch.stack([(a == r).float()
                        for r in range(len(env.robot_names))])
