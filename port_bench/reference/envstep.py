"""The env step checked by itself: the frozen copy of the port's plain env
(`frozen/`), built from the cell's configuration file and the seed, takes
the program's world from before a recorded step and the program's actions,
and steps once; its start is built from the seed alone."""
from __future__ import annotations

import dataclasses

import torch

from .frozen import config as C
from .frozen.envs import constraints, legged_env, parkour_env
from .frozen.physics import state

_CLASSES = {cls.__name__: cls
            for mod in (legged_env, parkour_env, state, constraints)
            for cls in vars(mod).values()
            if isinstance(cls, type) and dataclasses.is_dataclass(cls)
            and cls.__module__ == mod.__name__}


def build_env(cell, device, seed):
    """The frozen env of the cell's configuration (the port's builders'
    steps, from the configuration file's keys)."""
    c = cell["cfg"]
    over = [s for s in cell["overrides"]
            if not s.startswith(("ppo.", "runner.", "ac."))]
    if c["builder"] == "train":
        cfg = C.PRESETS[c["preset"]]()
        cfg = dataclasses.replace(cfg, env=dataclasses.replace(
            cfg.env, num_envs=c["num_envs"]))
        cfg = C.apply_overrides(cfg, over)
        return legged_env.make_legged_env(cfg, device=device, seed=seed)
    from .frozen.models import load_robot
    from .frozen.terrain import ParkourTerrainCfg
    props = tuple((k, float(v)) for k, v in c["terrain_proportions"])
    cfg = parkour_env.ParkourCfg(
        num_envs=c["num_envs"],
        soft_p_total_steps=c["num_steps"] * c["num_iterations"],
        terrain=ParkourTerrainCfg(proportions=props))
    cfg = C.apply_overrides(cfg, over)
    return parkour_env.ParkourEnv(cfg, load_robot(cfg.robot), seed=seed,
                                  device=device)


def from_host(x, device):
    """A host record of `record.to_host` as the frozen env's objects."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict) and "__generator__" in x:
        gen = torch.Generator(device=device)
        gen.set_state(x["__generator__"])
        return gen
    if isinstance(x, dict) and "__class__" in x:
        cls = _CLASSES[x["__class__"]]
        return cls(**{f.name: from_host(x[f.name], device)
                      for f in dataclasses.fields(cls)})
    if isinstance(x, dict):
        return {k: from_host(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(from_host(v, device) for v in x)
    return x


def start(env, seed, builder: str):
    """The world and first observations from the seed, as the runners
    make them."""
    world = env.init_state(seed)
    if builder == "train":
        world, obs = env.get_observations(world)
        return {"obs_history": obs["obs_history"],
                "privileged_obs": obs["privileged_obs"], "world": world}
    return {"obs": env.get_observations(world), "world": world}


def step(env, snap, device):
    """One env step from a recorded world with the recorded actions."""
    with torch.no_grad():
        return env.step(from_host(snap["before"], device),
                        snap["actions"].to(device))
