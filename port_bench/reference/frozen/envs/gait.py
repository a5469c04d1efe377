"""Gait clocks and desired contact states (port of `wtw_tpu/envs/gait.py`,
batched over the env axis).

The reference's `_step_contact_targets` (go1_gym/envs/base/legged_robot.py:
826-905): per-foot phase variables driven by the commanded gait
(frequency, phase, offset, bound, duration), duration-warped clocks, and
Normal-CDF-smoothed desired contact states used by the MoB gait-tracking
rewards (corl_rewards.py:67-84).

Command layout (legged_robot.py:1193-1203):
  [0] vx [1] vy [2] wz [3] body height [4] gait freq [5] phase [6] offset
  [7] bound [8] duration [9] footswing height [10] pitch [11] roll
  [12] stance width [13] stance length [14] aux reward coef
"""
from __future__ import annotations

import math

import torch


def step_gait(gait_index: torch.Tensor, commands: torch.Tensor, dt: float,
              kappa: float, pacing_offset: bool = False):
    """Advance the gait clock one policy step for N envs.

    gait_index (N,), commands (N, nc >= 9). Returns (new_gait_index (N,),
    foot_indices (N, 4), clock_inputs (N, 4), doubletime_clock (N, 4),
    halftime_clock (N, 4), desired_contact_states (N, 4)). Foot order
    matches the URDF/actuator convention (FR, FL, RR, RL)."""
    frequencies = commands[:, 4]
    phases = commands[:, 5]
    offsets = commands[:, 6]
    bounds = commands[:, 7]
    durations = commands[:, 8:9]

    gait_index = torch.remainder(gait_index + dt * frequencies, 1.0)
    g = gait_index
    if pacing_offset:
        raw = torch.stack([g + phases + offsets + bounds, g + bounds,
                           g + offsets, g + phases], dim=-1)
    else:
        raw = torch.stack([g + phases + offsets + bounds, g + offsets,
                           g + bounds, g + phases], dim=-1)
    foot_indices = torch.remainder(raw, 1.0)

    # duration warp: stance occupies [0, 0.5), swing [0.5, 1) regardless of
    # the commanded duty factor (legged_robot.py:848-854)
    stance = foot_indices < durations
    warped = torch.where(
        stance, foot_indices * (0.5 / durations),
        0.5 + (foot_indices - durations) * (0.5 / (1.0 - durations)))

    clock = torch.sin(2 * math.pi * warped)
    doubletime = torch.sin(4 * math.pi * warped)
    halftime = torch.sin(math.pi * warped)

    # smoothed desired contact state via the Normal(0, kappa) CDF
    # (legged_robot.py:873-902)
    cdf = lambda x: torch.special.ndtr(x / kappa)
    fi = torch.remainder(warped, 1.0)
    desired_contact = (cdf(fi) * (1 - cdf(fi - 0.5))
                       + cdf(fi - 1.0) * (1 - cdf(fi - 0.5 - 1.0)))

    return gait_index, foot_indices, clock, doubletime, halftime, \
        desired_contact
