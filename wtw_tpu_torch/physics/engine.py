"""Engine parameters (port of `EngineParams`, `wtw_tpu/physics/engine.py:44`).

The per-robot engine of the JAX package (`physics_step` under vmap) is not
ported yet; the batched engine (`physics/batched.py`) is the port's engine.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


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
