"""What the two CaT learners of `train_parkour` share: the build through
the port's `train_parkour.build`, the env step's record and the env
check's fields. `ppo.py` and `ppornn.py` add their weights and draws."""
from __future__ import annotations

from types import SimpleNamespace

from .. import record


def dims(cell) -> SimpleNamespace:
    c = cell["cfg"]
    return SimpleNamespace(
        N=c["num_envs"], T=c["num_steps"], A=c["num_actions"],
        O=c["num_observations"], epochs=c["update_epochs"],
        M=c["num_minibatches"], hidden=c["hidden"],
        rnn=c.get("rnn_hidden_dim"))


def build(cell, device, seed, run_dir):
    from wtw_tpu_torch.train_parkour import build as build_parkour
    c = cell["cfg"]
    runner = build_parkour(c["num_envs"], list(cell["overrides"]),
                           device=device, seed=seed, run_dir=run_dir,
                           save_interval=0, task=c["task"],
                           algo=cell["algo"], horizon=c["num_steps"],
                           iterations=c["num_iterations"])
    ln = runner.learner
    return SimpleNamespace(env=runner.env, learner=ln, world=runner.world,
                           obs=runner.obs_n, module=ln.agent, opt=ln.opt)


def iterate(p, dr):
    p.world, p.obs, stats = p.learner.train_iteration(p.world, p.obs, **dr)
    return stats


def rollout(p, dr):
    p.world, p.obs, traj, _ = p.learner.rollout(p.world, p.obs, dr["noise"])
    return traj


def update(p, traj, dr):
    return p.learner.update(traj, p.obs, dr["perms"])


def start(p):
    """The raw first observation (the runner folded it into the learner's
    normalizer) and the world it came from."""
    return {"obs": p.env.get_observations(p.world), "world": p.world}


def keep(world, obs, rew, done_prob, info):
    return {"obs": obs, "rew": rew, "done": done_prob,
            "true_dones": info["true_dones"]}


def resets(kept):
    """The envs that reset in a recorded step (hard dones and time-outs)."""
    return kept["true_dones"]


def step_fields(out):
    world, obs, rew, done_prob, info = out
    return {"obs": obs, "rew": rew, "done": done_prob,
            "true_dones": info["true_dones"],
            **record.world_fields(world)}


def start_fields(st):
    return {"obs": st["obs"], **record.world_fields(st["world"])}
