"""CoRL reward stack, batched over envs (port of `wtw_tpu/envs/rewards.py`;
reference go1_gym/envs/rewards/corl_rewards.py:15-202).

Every function maps (ctx, cfg) to an (N,) tensor. The env resolves the
active terms from the nonzero reward scales through REWARD_FNS, as
_prepare_reward_function does (legged_robot.py:1385-1412).
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils import quat as quat_util
from ..utils import spans


@dataclasses.dataclass
class RewardCtx:
    base_pos: torch.Tensor          # (N, 3)
    base_quat: torch.Tensor         # (N, 4)
    base_lin_vel: torch.Tensor      # (N, 3) body frame
    base_ang_vel: torch.Tensor      # (N, 3) body frame
    projected_gravity: torch.Tensor
    commands: torch.Tensor          # (N, num_commands)
    joint_q: torch.Tensor
    joint_qd: torch.Tensor
    last_joint_qd: torch.Tensor
    torques: torch.Tensor
    actions: torch.Tensor
    last_actions: torch.Tensor
    last_last_actions: torch.Tensor
    joint_pos_target: torch.Tensor
    last_joint_pos_target: torch.Tensor
    last_last_joint_pos_target: torch.Tensor
    default_joint_q: torch.Tensor   # (nj,), or (N, nj) in a mixed batch
    soft_pos_limits: torch.Tensor   # (nj, 2), or (N, nj, 2)
    foot_forces: torch.Tensor       # (N, 4, 3)
    foot_velocities: torch.Tensor   # (N, 4, 3)
    prev_foot_velocities: torch.Tensor
    foot_positions: torch.Tensor    # (N, 4, 3) world
    desired_contact_states: torch.Tensor  # (N, 4)
    foot_indices: torch.Tensor      # (N, 4)
    contact_filt: torch.Tensor      # (N, 4) bool
    thigh_contact: torch.Tensor     # (N, 4)
    calf_contact: torch.Tensor
    feet_air_time: torch.Tensor     # (N, 4)
    first_contact: torch.Tensor     # (N, 4) bool
    dt: float
    foot_side: torch.Tensor         # (4,) or (N, 4): +1 left / -1 right


def _cmd(ctx, i, default=0.0):
    c = ctx.commands
    return c[:, i] if i < c.shape[1] else torch.full_like(c[:, 0], default)


def tracking_lin_vel(ctx, cfg):
    err = torch.sum(torch.square(ctx.commands[:, :2] - ctx.base_lin_vel[:, :2]), -1)
    return torch.exp(-err / cfg.rewards.tracking_sigma)


def tracking_ang_vel(ctx, cfg):
    err = torch.square(ctx.commands[:, 2] - ctx.base_ang_vel[:, 2])
    return torch.exp(-err / cfg.rewards.tracking_sigma_yaw)


def lin_vel_z(ctx, cfg):
    return torch.square(ctx.base_lin_vel[:, 2])


def ang_vel_xy(ctx, cfg):
    return torch.sum(torch.square(ctx.base_ang_vel[:, :2]), -1)


def orientation(ctx, cfg):
    return torch.sum(torch.square(ctx.projected_gravity[:, :2]), -1)


def torques(ctx, cfg):
    return torch.sum(torch.square(ctx.torques), -1)


def dof_vel(ctx, cfg):
    return torch.sum(torch.square(ctx.joint_qd), -1)


def dof_acc(ctx, cfg):
    return torch.sum(torch.square((ctx.last_joint_qd - ctx.joint_qd) / ctx.dt), -1)


def action_rate(ctx, cfg):
    return torch.sum(torch.square(ctx.last_actions - ctx.actions), -1)


def collision(ctx, cfg):
    # penalized bodies = thigh + calf (go1_config.py:42)
    forces = torch.cat([ctx.thigh_contact, ctx.calf_contact], -1)
    return torch.sum((forces > 0.1).float(), -1)


def dof_pos_limits(ctx, cfg):
    lo = -torch.clamp(ctx.joint_q - ctx.soft_pos_limits[..., 0], max=0.0)
    hi = torch.clamp(ctx.joint_q - ctx.soft_pos_limits[..., 1], min=0.0)
    return torch.sum(lo + hi, -1)


def jump(ctx, cfg):
    target = _cmd(ctx, 3) + cfg.rewards.base_height_target
    return -torch.square(ctx.base_pos[:, 2] - target)


def base_height(ctx, cfg):
    return torch.square(ctx.base_pos[:, 2] - cfg.rewards.base_height_target)


def tracking_contacts_shaped_force(ctx, cfg):
    forces = torch.linalg.norm(ctx.foot_forces, dim=-1)
    desired = ctx.desired_contact_states
    r = -(1 - desired) * (1 - torch.exp(-forces ** 2 / cfg.rewards.gait_force_sigma))
    return torch.sum(r, -1) / 4


def tracking_contacts_shaped_vel(ctx, cfg):
    vels = torch.linalg.norm(ctx.foot_velocities, dim=-1)
    desired = ctx.desired_contact_states
    r = -(desired * (1 - torch.exp(-vels ** 2 / cfg.rewards.gait_vel_sigma)))
    return torch.sum(r, -1) / 4


def dof_pos(ctx, cfg):
    return torch.sum(torch.square(ctx.joint_q - ctx.default_joint_q), -1)


def action_smoothness_1(ctx, cfg):
    diff = torch.square(ctx.joint_pos_target - ctx.last_joint_pos_target)
    return torch.sum(diff * (ctx.last_actions != 0), -1)


def action_smoothness_2(ctx, cfg):
    diff = torch.square(ctx.joint_pos_target - 2 * ctx.last_joint_pos_target
                        + ctx.last_last_joint_pos_target)
    diff = diff * (ctx.last_actions != 0) * (ctx.last_last_actions != 0)
    return torch.sum(diff, -1)


def feet_slip(ctx, cfg):
    xy_speed_sq = torch.sum(torch.square(ctx.foot_velocities[..., :2]), -1)
    return torch.sum(ctx.contact_filt * xy_speed_sq, -1)


def feet_contact_forces(ctx, cfg):
    f = torch.linalg.norm(ctx.foot_forces, dim=-1)
    return torch.sum(torch.clamp(f - cfg.rewards.max_contact_force, min=0.0), -1)


def feet_clearance_cmd_linear(ctx, cfg):
    phases = 1 - torch.abs(
        1.0 - torch.clamp(ctx.foot_indices * 2.0 - 1.0, 0.0, 1.0) * 2.0)
    target = _cmd(ctx, 9, cfg.rewards.footswing_height)[:, None] * phases + 0.02
    r = torch.square(target - ctx.foot_positions[..., 2]) * (
        1 - ctx.desired_contact_states)
    return torch.sum(r, -1)


def feet_impact_vel(ctx, cfg):
    prev_vz = ctx.prev_foot_velocities[..., 2]
    contact = torch.linalg.norm(ctx.foot_forces, dim=-1) > 1.0
    return torch.sum(contact * torch.square(torch.clamp(prev_vz, -100.0, 0.0)), -1)


def feet_contact_vel(ctx, cfg):
    """Penalize foot speed near the ground (corl_rewards.py:115-120)."""
    near_ground = ctx.foot_positions[..., 2] < 0.03
    foot_speed_sq = torch.sum(torch.square(ctx.foot_velocities), -1)
    return torch.sum(near_ground * foot_speed_sq, -1)


def feet_air_time(ctx, cfg):
    rew = torch.sum((ctx.feet_air_time - 0.5) * ctx.first_contact, -1)
    return rew * (torch.linalg.norm(ctx.commands[:, :2], dim=-1) > 0.1)


def orientation_control(ctx, cfg):
    roll_cmd, pitch_cmd = _cmd(ctx, 11), _cmd(ctx, 10)
    dev = roll_cmd.device
    ex = spans.tensor([1.0, 0.0, 0.0], dev)
    ey = spans.tensor([0.0, 1.0, 0.0], dev)
    quat_roll = quat_util.quat_from_angle_axis(-roll_cmd, ex)
    quat_pitch = quat_util.quat_from_angle_axis(-pitch_cmd, ey)
    desired_quat = quat_util.quat_mul(quat_roll, quat_pitch)
    desired_pg = quat_util.quat_rotate_inverse(
        desired_quat, spans.tensor([0.0, 0.0, -1.0], dev))
    return torch.sum(torch.square(ctx.projected_gravity[:, :2]
                                  - desired_pg[:, :2]), -1)


def raibert_heuristic(ctx, cfg):
    # corl_rewards.py:161-202, with the JAX package's round-4 stance-width
    # sign fix: ys_nom follows each foot's own side (ctx.foot_side)
    translated = ctx.foot_positions - ctx.base_pos[:, None, :]
    q_conj = quat_util.quat_conjugate(ctx.base_quat)
    feet_body = quat_util.quat_apply_yaw(
        q_conj[:, None, :].expand(-1, 4, 4), translated)
    c = ctx.commands
    n = c.shape[1]
    full = lambda v: torch.full_like(c[:, 0], v)
    w = c[:, 12] if n >= 13 else full(0.3)
    l = c[:, 13] if n >= 14 else full(0.45)
    ys_nom = ctx.foot_side * (w[:, None] / 2)
    xs_nom = torch.stack([l / 2, l / 2, -l / 2, -l / 2], -1)
    phases = torch.abs(1.0 - ctx.foot_indices * 2.0) * 1.0 - 0.5
    freq = c[:, 4] if n > 4 else full(3.0)
    y_vel_des = c[:, 2] * l / 2
    ys_off = phases * (y_vel_des * (0.5 / freq))[:, None]
    ys_off = ys_off * spans.tensor([1.0, 1.0, -1.0, -1.0], c.device)
    xs_off = phases * (c[:, 0] * (0.5 / freq))[:, None]
    err = torch.stack([xs_nom + xs_off, ys_nom + ys_off], -1) - feet_body[..., :2]
    return torch.sum(torch.square(torch.abs(err)), dim=(-1, -2))


REWARD_FNS = {
    "tracking_lin_vel": tracking_lin_vel,
    "tracking_ang_vel": tracking_ang_vel,
    "lin_vel_z": lin_vel_z,
    "ang_vel_xy": ang_vel_xy,
    "orientation": orientation,
    "orientation_control": orientation_control,
    "torques": torques,
    "dof_vel": dof_vel,
    "dof_acc": dof_acc,
    "action_rate": action_rate,
    "collision": collision,
    "dof_pos_limits": dof_pos_limits,
    "dof_pos": dof_pos,
    "jump": jump,
    "base_height": base_height,
    "tracking_contacts_shaped_force": tracking_contacts_shaped_force,
    "tracking_contacts_shaped_vel": tracking_contacts_shaped_vel,
    "action_smoothness_1": action_smoothness_1,
    "action_smoothness_2": action_smoothness_2,
    "feet_slip": feet_slip,
    "feet_contact_forces": feet_contact_forces,
    "feet_clearance_cmd_linear": feet_clearance_cmd_linear,
    "feet_impact_vel": feet_impact_vel,
    "feet_contact_vel": feet_contact_vel,
    "feet_air_time": feet_air_time,
    "raibert_heuristic": raibert_heuristic,
}


def active_reward_terms(cfg) -> list:
    """(name, scale*dt) for nonzero scales with an implementation, mirroring
    _prepare_reward_function (legged_robot.py:1394-1412)."""
    out = []
    for name, scale in cfg.reward_scales.items():
        if name == "termination" or scale == 0.0:
            continue
        if name not in REWARD_FNS:
            print(f"Warning: reward '{name}' has nonzero scale but no "
                  f"implementation — dropped (reference does the same).")
            continue
        out.append((name, scale * cfg.dt))
    return out
