"""Faults planted in the timed path, to show that the comparison catches
them (the tests under `tests/`, and the readings that set the limits).
Never used by a benchmark run."""
from __future__ import annotations

import torch

FAULTS = ("unchanged", "half_batch", "altered_reward", "altered_start")


def _unchanged(p, cell):
    """The learner's step returns its parameters unchanged (the optimizer
    still updates its moments)."""
    opt, orig = p.opt, p.opt.step
    params = [q for g in opt.param_groups for q in g["params"]]

    def step(*a, **k):
        saved = [q.detach().clone() for q in params]
        out = orig(*a, **k)
        with torch.no_grad():
            for q, s in zip(params, saved):
                q.copy_(s)
        return out
    opt.step = step


def _half_batch(p, cell):
    """Half of each minibatch left out, the loss's means over the rest."""
    ln = p.learner
    if cell["algo"] == "ppo_cse":
        orig = ln.ppo_loss

        def ppo_loss(obs_h, priv, actions, logp, mu, old_std, v, adv, ret):
            h = obs_h.shape[0] // 2
            return orig(obs_h[:h], priv[:h], actions[:h], logp[:h], mu[:h],
                        old_std, v[:h], adv[:h], ret[:h])
        ln.ppo_loss = ppo_loss
        return
    orig = ln.loss
    # PPO-RNN's batch: (T, envs, ...) sequences, its two hiddens (envs, H)
    # at places 6 and 7
    rnn = cell["algo"] == "ppornn"
    axis = lambda i: (0 if i in (6, 7) else 1) if rnn else 0

    def loss(batch, value_rms):
        n = batch[0].shape[axis(0)] // 2
        return orig(tuple(x.narrow(axis(i), 0, n)
                          for i, x in enumerate(batch)), value_rms)
    ln.loss = loss


def _altered_reward(p, cell):
    """The env step's reward of env 0 altered where it is produced."""
    env, orig = p.env, p.env.step

    def step(world, actions):
        world, obs, rew, done, info = orig(world, actions)
        rew = rew.clone()
        rew[0] += 1.0
        return world, obs, rew, done, info
    env.step = step


def _altered_start(p, cell):
    """The first observation of env 0 altered where it is produced: the
    obs dict the runner made (`train`), or the env's first observation
    (`train_parkour`)."""
    if isinstance(p.obs, dict):
        p.obs["obs_history"][0] += 1.0
        return
    env, orig = p.env, p.env.get_observations

    def get_observations(world):
        obs = orig(world).clone()
        obs[0] += 1.0
        return obs
    env.get_observations = get_observations


def plant(name: str, p, cell):
    {"unchanged": _unchanged, "half_batch": _half_batch,
     "altered_reward": _altered_reward,
     "altered_start": _altered_start}[name](p, cell)
