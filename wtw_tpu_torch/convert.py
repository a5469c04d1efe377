"""Carry weights and env state across from the JAX package.

The helpers take the JAX objects with their array leaves already turned
into numpy (e.g. `jax.tree.map(np.asarray, tree)`); they read them by
attribute or key only, so this module imports nothing of JAX or wtw_tpu.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .envs.constraints import CaTState
from .envs.legged_env import EnvState, WorldState
from .envs.parkour_env import ParkourEnvState, ParkourWorld
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


def _tensor(x, dev, dtype=None):
    a = np.array(x)
    if dtype is None:
        dtype = {np.dtype(np.bool_): torch.bool,
                 np.dtype(np.int32): torch.int32}.get(a.dtype, torch.float32)
    return torch.from_numpy(a).to(device=dev, dtype=dtype)


def _phys(p, dev) -> PhysicsState:
    return PhysicsState(**{f: _tensor(getattr(p, f), dev) for f in (
        "base_pos", "base_quat", "base_lin_vel", "base_ang_vel", "joint_q",
        "joint_qd")})


def _generator(dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return gen


def world_from_jax(world, device="cpu", seed: int = 0) -> WorldState:
    """JAX `WorldState` (numpy leaves) -> the port's WorldState: every env
    field, the gait clock and the actuator-net history included, the
    curriculum weights, the observation history, the gravity offset and the
    step counter. The JAX per-env RNG keys have no counterpart; the port's
    generator is seeded with `seed`."""
    dev = torch.device(device)
    t = lambda x, dtype=None: _tensor(x, dev, dtype)
    e = world.env
    phys = _phys(e.phys, dev)
    names = [f for f in EnvState.__dataclass_fields__ if f != "phys"]
    fields = {}
    for f in names:
        if f in ("env_bin", "env_category"):
            fields[f] = t(getattr(e, f), torch.long)
        else:
            fields[f] = t(getattr(e, f))
    return WorldState(env=EnvState(phys=phys, **fields),
                      curriculum_weights=t(world.curriculum.weights),
                      obs_history=t(world.obs_history),
                      gravity_offset=t(world.gravity_offset),
                      common_step=int(np.asarray(world.common_step)),
                      gen=_generator(dev, seed))


def actuator_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX actuator-net parameters {'w0': (6, 32), 'b0': (32,), ...}
    (numpy leaves, as `wtw_tpu.models.actuator_net.load_actuator_net` gives
    them) -> the port's, for `models.actuator_net.apply_actuator_net`
    (the same keys and (in, out) layout, as float32 CPU tensors)."""
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in params.items()}


def cat_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX CaT agent parameters {'critic'|'actor_mean': [{'w': (in, out),
    'b': (out,)}, ...], 'actor_logstd': (A,)} -> a state_dict for
    `learn.cat_ppo.CatAgent`."""
    sd = {}
    for net in ("critic", "actor_mean"):
        for i, layer in enumerate(tree[net]):
            sd[f"{net}.{2 * i}.weight"] = torch.from_numpy(
                np.array(np.asarray(layer["w"]).T, np.float32))
            sd[f"{net}.{2 * i}.bias"] = torch.from_numpy(
                np.array(layer["b"], np.float32))
    sd["actor_logstd"] = torch.from_numpy(
        np.array(tree["actor_logstd"], np.float32))
    return sd


def parkour_world_from_jax(world, device="cpu", seed: int = 0) -> ParkourWorld:
    """JAX `ParkourWorld` (numpy leaves) -> the port's ParkourWorld: every
    env field (the gait clock, the actuator-net history, the previous
    actions, joint velocities and base velocity included), the CaT running
    maxima, the float32 soft-p progress, the observation history and the
    step counter. The JAX per-env RNG keys have no counterpart; the port's
    generator is seeded with `seed`."""
    dev = torch.device(device)
    e = world.env
    fields = {}
    for f in ParkourEnvState.__dataclass_fields__:
        if f == "phys":
            continue
        dtype = torch.long if f in ("terrain_level", "terrain_type") else None
        fields[f] = _tensor(getattr(e, f), dev, dtype)
    return ParkourWorld(
        env=ParkourEnvState(phys=_phys(e.phys, dev), **fields),
        cat=CaTState(running_max=_tensor(world.cat.running_max, dev)),
        soft_p_progress=np.float32(np.asarray(world.soft_p_progress)),
        hist_obs=_tensor(world.hist_obs, dev),
        common_step=int(np.asarray(world.common_step)),
        gen=_generator(dev, seed))
