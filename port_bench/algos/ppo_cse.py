"""`train --preset <preset>` with the PPO learner of concurrent state
estimation (`wtw_tpu_torch.learn.ppo_cse`)."""
from __future__ import annotations

from types import SimpleNamespace

import torch

from .. import record
from .. import weights as W


def dims(cell) -> SimpleNamespace:
    c = cell["cfg"]
    return SimpleNamespace(
        N=c["num_envs"], T=c["num_steps_per_env"], A=c["num_actions"],
        H=c["num_observations"] * c["num_observation_history"],
        P=c["num_privileged_obs"], epochs=c["num_learning_epochs"],
        M=c["num_mini_batches"], actor=c["actor_hidden_dims"],
        critic=c["critic_hidden_dims"],
        adaptation=c["adaptation_hidden_dims"])


def build(cell, device, seed, run_dir):
    from wtw_tpu_torch.train import build as build_train
    c = cell["cfg"]
    env, runner = build_train(c["preset"], c["num_envs"],
                              list(cell["overrides"]), device=device,
                              seed=seed, run_dir=run_dir, save_interval=0,
                              algo="ppo_cse")
    ppo = runner.ppo
    return SimpleNamespace(env=env, learner=ppo, world=runner.world,
                           obs=runner.obs_dict, module=ppo.ac, opt=ppo.opt)


def weight_spec(cell):
    d = dims(cell)
    return (W.mlp("adaptation", [d.H, *d.adaptation, d.P], W.fan_in)
            + W.mlp("actor", [d.H + d.P, *d.actor, d.A], W.fan_in)
            + W.mlp("critic", [d.H + d.P, *d.critic, 1], W.fan_in)
            + [("std", (d.A,), ("const", 1.0))])


def draws(cell, gen, device) -> dict:
    """The iteration's action noise (T, N, A) and minibatch permutation."""
    d = dims(cell)
    return {"noise": torch.randn((d.T, d.N, d.A), generator=gen,
                                 device=device),
            "perm": torch.randperm(d.T * d.N, generator=gen, device=device)}


def iterate(p, dr):
    p.world, p.obs, stats = p.learner.train_iteration(p.world, p.obs, **dr)
    return stats


def rollout(p, dr):
    p.world, p.obs, traj, _ = p.learner.rollout(p.world, p.obs, dr["noise"])
    return traj


def update(p, traj, dr):
    return p.learner.update(traj, p.obs, dr["perm"])


def start(p):
    """What the reference starts from: the first observations."""
    return {"obs_history": p.obs["obs_history"],
            "privileged_obs": p.obs["privileged_obs"], "world": p.world}


def keep(world, obs, rew, done, info):
    """What the reference's learner reads of one env step."""
    return {"obs_history": obs["obs_history"],
            "privileged_obs": obs["privileged_obs"], "rew": rew,
            "done": done, "time_outs": info["time_outs"]}


def resets(kept):
    """The envs that reset in a recorded step."""
    return kept["done"]


def step_fields(out):
    """The env step's outputs that the env check compares (host copies of
    (world, obs, rew, done, info)): `record.world_fields` of the world
    after it."""
    world, obs, rew, done, info = out
    return {"obs_history": obs["obs_history"],
            "privileged_obs": obs["privileged_obs"], "rew": rew,
            "done": done, "time_outs": info["time_outs"],
            **record.world_fields(world)}


def start_fields(st):
    return {"obs_history": st["obs_history"],
            "privileged_obs": st["privileged_obs"],
            **record.world_fields(st["world"])}
