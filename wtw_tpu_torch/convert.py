"""Carry weights and env state across from the JAX package.

Both helpers take the JAX objects with their array leaves already turned
into numpy (e.g. `jax.tree.map(np.asarray, tree)`); they read them by
attribute or key only, so this module imports nothing of JAX or wtw_tpu.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .envs.legged_env import EnvState, WorldState
from .physics import PhysicsState

_NETS = ("adaptation", "actor", "critic")


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX actor-critic parameter tree {'adaptation'|'actor'|'critic':
    [{'w': (in, out), 'b': (out,)}, ...], 'std': (A,)} -> a state_dict for
    `models.actor_critic.ActorCritic` (Linear weights are (out, in); the
    i-th Linear of a net sits at Sequential index 2 i)."""
    sd = {}
    for net in _NETS:
        for i, layer in enumerate(tree[net]):
            sd[f"{net}.{2 * i}.weight"] = torch.from_numpy(
                np.array(np.asarray(layer["w"]).T, np.float32))
            sd[f"{net}.{2 * i}.bias"] = torch.from_numpy(
                np.array(layer["b"], np.float32))
    sd["std"] = torch.from_numpy(np.array(tree["std"], np.float32))
    return sd


def world_from_jax(world, device="cpu", seed: int = 0) -> WorldState:
    """JAX `WorldState` (numpy leaves) -> the port's WorldState.

    The JAX per-env RNG keys and the actuator-net history have no
    counterpart; the port's generator is seeded with `seed`."""
    dev = torch.device(device)

    def t(x, dtype=None):
        a = np.array(x)
        if dtype is None:
            dtype = {np.dtype(np.bool_): torch.bool,
                     np.dtype(np.int32): torch.int32}.get(a.dtype,
                                                          torch.float32)
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    e = world.env
    p = e.phys
    phys = PhysicsState(**{f: t(getattr(p, f)) for f in (
        "base_pos", "base_quat", "base_lin_vel", "base_ang_vel", "joint_q",
        "joint_qd")})
    names = [f for f in EnvState.__dataclass_fields__ if f != "phys"]
    fields = {}
    for f in names:
        if f in ("env_bin", "env_category"):
            fields[f] = t(getattr(e, f), torch.long)
        else:
            fields[f] = t(getattr(e, f))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return WorldState(env=EnvState(phys=phys, **fields),
                      curriculum_weights=t(world.curriculum.weights),
                      obs_history=t(world.obs_history),
                      gravity_offset=t(world.gravity_offset),
                      common_step=int(np.asarray(world.common_step)),
                      gen=gen)
