"""Observation assembly, batched over envs (port of
`wtw_tpu/envs/observations.py`; reference compute_observations,
go1_gym/envs/base/legged_robot.py:302-491)."""
from __future__ import annotations

import numpy as np
import torch

from ..config import Cfg
from ..utils import spans


def commands_scale(cfg: Cfg) -> np.ndarray:
    """legged_robot.py:1196-1203."""
    s = cfg.obs_scales
    full = np.array([
        s.lin_vel, s.lin_vel, s.ang_vel, s.body_height_cmd, s.gait_freq_cmd,
        s.gait_phase_cmd, s.gait_phase_cmd, s.gait_phase_cmd, s.gait_phase_cmd,
        s.footswing_height_cmd, s.body_pitch_cmd, s.body_roll_cmd,
        s.stance_width_cmd, s.stance_length_cmd, s.aux_reward_cmd])
    return full[:cfg.commands.num_commands]


def build_obs(cfg: Cfg, *, projected_gravity, commands, joint_q, joint_qd,
              default_joint_q, actions, last_actions, clock_inputs,
              gait_index, base_lin_vel, base_ang_vel, base_quat,
              contact_states) -> torch.Tensor:
    """(N, num_obs) observations, block order = reference :305-372."""
    s = cfg.obs_scales
    blocks = [projected_gravity]
    if cfg.env.observe_command:
        blocks.append(commands * spans.as_tensor(
            commands_scale(cfg), dtype=torch.float32, device=commands.device))
    blocks.append((joint_q - default_joint_q) * s.dof_pos)
    blocks.append(joint_qd * s.dof_vel)
    blocks.append(actions)
    if cfg.env.observe_two_prev_actions:
        blocks.append(last_actions)
    if cfg.env.observe_timing_parameter:
        blocks.append(gait_index[:, None])
    if cfg.env.observe_clock_inputs:
        blocks.append(clock_inputs)
    if cfg.env.observe_vel:
        blocks = [base_lin_vel * s.lin_vel, base_ang_vel * s.ang_vel] + blocks
    if cfg.env.observe_only_ang_vel:
        blocks = [base_ang_vel * s.ang_vel] + blocks
    if cfg.env.observe_only_lin_vel:
        blocks = [base_lin_vel * s.lin_vel] + blocks
    if cfg.env.observe_yaw:
        from ..utils.quat import quat_yaw
        blocks.append(quat_yaw(base_quat)[:, None])
    if cfg.env.observe_contact_states:
        blocks.append(contact_states.float())
    return torch.cat(blocks, dim=-1)


def noise_scale_vec(cfg: Cfg) -> np.ndarray:
    """Static noise amplitude per obs dim (legged_robot.py:1053-1120)."""
    ns, s = cfg.noise, cfg.obs_scales
    lvl = ns.noise_level
    nj = cfg.env.num_actions
    parts = [np.full(3, ns.gravity * lvl)]
    if cfg.env.observe_command:
        parts.append(np.zeros(cfg.commands.num_commands))
    parts.append(np.full(nj, ns.dof_pos * lvl * s.dof_pos))
    parts.append(np.full(nj, ns.dof_vel * lvl * s.dof_vel))
    parts.append(np.zeros(nj))  # actions
    if cfg.env.observe_two_prev_actions:
        parts.append(np.zeros(nj))
    if cfg.env.observe_timing_parameter:
        parts.append(np.zeros(1))
    if cfg.env.observe_clock_inputs:
        parts.append(np.zeros(4))
    vec = np.concatenate(parts)
    if cfg.env.observe_vel:
        vec = np.concatenate([np.full(3, ns.lin_vel * lvl * s.lin_vel),
                              np.full(3, ns.ang_vel * lvl * s.ang_vel), vec])
    if cfg.env.observe_only_ang_vel:
        vec = np.concatenate([np.full(3, ns.ang_vel * lvl * s.ang_vel), vec])
    if cfg.env.observe_only_lin_vel:
        vec = np.concatenate([np.full(3, ns.lin_vel * lvl * s.lin_vel), vec])
    if cfg.env.observe_yaw:
        vec = np.concatenate([vec, np.zeros(1)])
    if cfg.env.observe_contact_states:
        vec = np.concatenate([vec, np.full(4, ns.contact_states * lvl)])
    return vec.astype(np.float32)


def _scale_shift(rng):
    """get_scale_shift (go1_gym/utils/math_utils.py:35-38)."""
    return 2.0 / (rng[1] - rng[0]), (rng[0] + rng[1]) / 2.0


def build_privileged_obs(cfg: Cfg, *, friction, restitution, payload,
                         com_displacement, motor_strength, motor_offset,
                         Kp_factor, Kd_factor, base_lin_vel, base_height,
                         gravity_offset, clock_inputs,
                         desired_contact_states) -> torch.Tensor:
    """(N, num_privileged_obs) teacher observation (legged_robot.py:380-491),
    block order of the reference's if-chain."""
    n, e = cfg.normalization, cfg.env
    N = friction.shape[0]
    blocks = []

    def add(flag, rng, x):
        if flag:
            sc, sh = _scale_shift(rng)
            blocks.append((x - sh) * sc)

    add(e.priv_observe_friction, n.friction_range, friction[:, None])
    add(e.priv_observe_restitution, n.restitution_range, restitution[:, None])
    add(e.priv_observe_base_mass, n.added_mass_range, payload[:, None])
    add(e.priv_observe_com_displacement, n.com_displacement_range,
        com_displacement)
    add(e.priv_observe_motor_strength, n.motor_strength_range, motor_strength)
    add(e.priv_observe_motor_offset, n.motor_offset_range, motor_offset)
    add(e.priv_observe_Kp_factor, n.Kp_factor_range, Kp_factor)
    add(e.priv_observe_Kd_factor, n.Kd_factor_range, Kd_factor)
    add(e.priv_observe_body_height, n.body_height_range, base_height[:, None])
    add(e.priv_observe_body_velocity, n.body_velocity_range, base_lin_vel)
    add(e.priv_observe_gravity, n.gravity_range,
        gravity_offset.expand(N, 3))
    if e.priv_observe_clock_inputs:
        blocks.append(clock_inputs)
    if e.priv_observe_desired_contact_states:
        blocks.append(desired_contact_states)
    if not blocks:
        return torch.zeros(N, 0, device=friction.device)
    return torch.cat(blocks, dim=-1)
