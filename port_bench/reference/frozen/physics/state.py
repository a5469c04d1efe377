"""Physics state containers (port of `wtw_tpu/physics/state.py`).

Batched: every field carries a leading (B,) env axis, as the JAX batched
engine's inputs and outputs do."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PhysicsState:
    """Mirrors the root_states/dof_state tensors of the reference
    (legged_robot.py:1138-1143)."""
    base_pos: torch.Tensor      # (B, 3) world
    base_quat: torch.Tensor     # (B, 4) xyzw, body->world
    base_lin_vel: torch.Tensor  # (B, 3) world, velocity of base frame origin
    base_ang_vel: torch.Tensor  # (B, 3) world
    joint_q: torch.Tensor       # (B, nj)
    joint_qd: torch.Tensor      # (B, nj)


@dataclasses.dataclass
class ContactInfo:
    """Per-step contact diagnostics (legged_robot.py:1156-1157) plus foot
    kinematics (legged_robot.py:112-115)."""
    foot_forces: torch.Tensor       # (B, 4, 3) world contact force per foot
    foot_positions: torch.Tensor    # (B, 4, 3) world foot sphere centers
    foot_velocities: torch.Tensor   # (B, 4, 3) world foot sphere velocities
    thigh_contact: torch.Tensor     # (B, 4) force norm on thigh group per leg
    calf_contact: torch.Tensor      # (B, 4) force norm on calf group per leg
    base_contact: torch.Tensor      # (B,) force norm on base group
    total_normal_force: torch.Tensor  # (B,)
