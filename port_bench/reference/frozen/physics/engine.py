"""Engine parameters and the per-robot engine (port of
`wtw_tpu/physics/engine.py`).

The JAX package's per-robot engine (`fk`, `physics_step`) runs one env and
is batched with `jax.vmap`, over the model too in a mixed-robot batch (its
`physics_backend="vmap"`). Here both are thin functions over the batched
engine (`physics/batched.py`), which already takes a per-env model: one env
goes through it as a batch of one, a leading env axis as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class EngineParams:
    dt: float = 0.005
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    # contact model
    contact_stiffness: float = 10_000.0   # N/m per sphere
    contact_damping: float = 300.0        # N·s/m per sphere
    friction_vel_eps: float = 0.05        # m/s smoothing
    # joint model
    armature: float = 0.01                # kg·m² reflected rotor inertia
    # max penetration speed used to cap the elastic contact force
    max_depenetration_velocity: float = 1.0   # mirrors physx block :418


def fk(model, base_pos, base_quat, joint_q):
    """Forward kinematics (`engine.py:82`): body_pos (nb, 3), body_quat
    (nb, 4), joint anchors (nj, 3) and world axes (nj, 3) for one env, or
    with a leading env axis for (B, 3), (B, 4), (B, nj) inputs."""
    from .batched import fk_core
    one = base_pos.dim() == 1
    if one:
        base_pos, base_quat, joint_q = (x[None] for x in (
            base_pos, base_quat, joint_q))
    out = fk_core(model, base_pos, base_quat, joint_q)
    return tuple(x[0] for x in out) if one else out


def physics_step(model, hf, params: EngineParams, state, joint_torque,
                 friction, restitution, payload_mass=0.0, com_offset=None,
                 external_accel=None, hf_ceiling=None):
    """One substep (`engine.py:172`) -> (PhysicsState, ContactInfo): one env
    (state fields without an env axis, one robot), or B envs with a leading
    env axis on the state, the torques and the per-env coefficients, where
    the model is shared or per-env (`models/multi.py`)."""
    from .batched import physics_step_batched
    from .state import ContactInfo, PhysicsState
    one = state.base_pos.dim() == 1
    if not one:
        return physics_step_batched(
            model, hf, params, state, joint_torque, friction, restitution,
            payload_mass=payload_mass, com_offset=com_offset,
            external_accel=external_accel, hf_ceiling=hf_ceiling)
    dev = state.base_pos.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    opt = lambda x: None if x is None else f32(x)[None]
    s1 = PhysicsState(**{f.name: getattr(state, f.name)[None]
                         for f in dataclasses.fields(PhysicsState)})
    s, info = physics_step_batched(
        model, hf, params, s1, f32(joint_torque)[None],
        f32(friction).reshape(1), f32(restitution).reshape(1),
        payload_mass=f32(payload_mass).reshape(1),
        com_offset=opt(com_offset), external_accel=external_accel,
        hf_ceiling=hf_ceiling)
    unbatch = lambda x, cls: cls(**{f.name: getattr(x, f.name)[0]
                                    for f in dataclasses.fields(cls)})
    return unbatch(s, PhysicsState), unbatch(info, ContactInfo)
