"""Population-based training over the PPO learner (port of
`wtw_tpu/learn/pbt.py`).

P members, each with its own world from its own seed, its own
`ppo_cse.PPO` and a learning rate log-spaced around the base one
(base * 2**(i - P/2)); one env object is shared. The members step one
after another, each through the env at its own batch, so every kernel
launches P times a policy substep. Every `exploit_interval` iterations the
bottom members by fitness (an EMA of the mean step reward) copy a
uniformly chosen top member's whole learner state (weights, both Adam
states, learning rate, iteration and generator) and perturb the learning
rate by exp(U(log 0.8, log 1.25)); worlds are not copied.
"""
from __future__ import annotations

import copy
import math
import os
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from . import ppo_cse
from .runner import (_no_jax_state, _sync, load_checkpoint, world_blob,
                     world_from_blob)


@dataclass(frozen=True)
class PBTArgs:
    population: int = 4
    exploit_interval: int = 50        # iterations between exploit/explore
    exploit_frac: float = 0.25        # bottom quantile replaced
    lr_perturb: tuple = (0.8, 1.25)


def exploit_explore(members: List[ppo_cse.PPO], fitness, pbt: PBTArgs,
                    gen: Optional[torch.Generator] = None, choice=None,
                    perturb=None) -> dict:
    """Truncation PBT on the members in place. `choice` (n_cut,) picks
    each bottom member's source among the top n_cut, `perturb` (P,) the lr
    factor of each member (used by the bottom ones); both are drawn from
    `gen` unless given. -> {"bottom", "src", "lr_before", "lr_after"}."""
    P = len(members)
    n_cut = max(1, int(P * pbt.exploit_frac))
    order = np.argsort(np.asarray(fitness), kind="stable")   # ascending
    bottom, top = order[:n_cut], order[P - n_cut:]
    if choice is None:
        choice = torch.randint(0, n_cut, (n_cut,), generator=gen)
    if perturb is None:
        lo, hi = math.log(pbt.lr_perturb[0]), math.log(pbt.lr_perturb[1])
        perturb = torch.exp(lo + (hi - lo) * torch.rand(P, generator=gen,
                                                        dtype=torch.float64))
    src = top[np.asarray(choice)]
    lr_before = [m.lr for m in members]
    # every source as it was before any copy (a member may be both)
    states = {int(s): copy.deepcopy(members[s].state()) for s in set(src)}
    for b, s in zip(bottom, src):
        members[b].load_state(copy.deepcopy(states[int(s)]))
        members[b].lr = states[int(s)]["lr"] * float(perturb[b])
    return {"bottom": bottom.tolist(), "src": src.tolist(),
            "lr_before": lr_before, "lr_after": [m.lr for m in members]}


class Population:
    """The population, its worlds and observations, the fitness EMA and
    the generator of the exploit draws (`init_population`)."""

    def __init__(self, env, ppo_args: ppo_cse.PPOArgs = ppo_cse.PPOArgs(),
                 pbt: PBTArgs = PBTArgs(), seed: int = 0,
                 run_dir: Optional[str] = None, log_freq: int = 10):
        self.env, self.args, self.pbt = env, ppo_args, pbt
        self.run_dir, self.log_freq = run_dir, log_freq
        P = pbt.population
        self.members, self.worlds, self.obs = [], [], []
        for i in range(P):
            member_seed = seed * P + i
            world = env.init_state(member_seed)
            world, obs = env.get_observations(world)
            learner = ppo_cse.PPO(env, ppo_args, seed=member_seed)
            learner.lr = ppo_args.learning_rate * 2.0 ** (i - P / 2)
            self.members.append(learner)
            self.worlds.append(world)
            self.obs.append(obs)
        self.fitness = np.zeros(P, np.float32)
        self.gen = torch.Generator()
        self.gen.manual_seed(int(seed))
        self.iteration = 0
        self.last_exploit = None
        self.last_stats = None

    @property
    def lr(self) -> np.ndarray:
        return np.array([m.lr for m in self.members], np.float32)

    def learn(self, iterations: int, log_fn=print):
        """`train_pbt`'s loop; returns the per-iteration wall seconds of the
        whole population (device work finished at the end of each)."""
        walls = []
        for it in range(self.iteration, self.iteration + iterations):
            t0 = time.perf_counter()
            stats = []
            for i, m in enumerate(self.members):
                self.worlds[i], self.obs[i], s = m.train_iteration(
                    self.worlds[i], self.obs[i])
                stats.append(s)
            _sync(self.env.device)
            walls.append(time.perf_counter() - t0)
            self.last_stats = stats
            rew = np.array([float(s["mean_step_reward"]) for s in stats],
                           np.float32)
            self.fitness = (np.float32(0.9) * self.fitness
                            + np.float32(0.1) * rew)
            if (it + 1) % self.pbt.exploit_interval == 0:
                self.last_exploit = exploit_explore(
                    self.members, self.fitness, self.pbt, self.gen)
            if it % self.log_freq == 0:
                log_fn(f"pbt it {it:5d} | fitness "
                       + " ".join(f"{float(f):.4f}" for f in self.fitness)
                       + " | lr " + " ".join(f"{float(l):.1e}"
                                             for l in self.lr))
            self.iteration += 1
        if self.run_dir:
            self.save()
        return walls

    def save(self):
        """Exact-resume state `<run_dir>/pbt_state.pt`."""
        os.makedirs(self.run_dir, exist_ok=True)
        path = os.path.join(self.run_dir, "pbt_state.pt")
        torch.save({"members": [m.state() for m in self.members],
                    "worlds": [world_blob(w) for w in self.worlds],
                    "obs": self.obs, "fitness": self.fitness,
                    "gen_state": self.gen.get_state(),
                    "iteration": self.iteration, "cfg": self.env.cfg}, path)
        return path

    def load(self, path):
        _no_jax_state(path, "population")
        dev = self.env.device
        blob = load_checkpoint(path, dev)
        if len(blob["members"]) != len(self.members):
            raise ValueError(f"{path} holds {len(blob['members'])} members, "
                             f"not {len(self.members)}")
        for m, s in zip(self.members, blob["members"]):
            m.load_state(s)
        self.worlds = [world_from_blob(w, dev) for w in blob["worlds"]]
        self.obs = blob["obs"]
        self.fitness = blob["fitness"]
        self.gen.set_state(blob["gen_state"])
        self.iteration = blob["iteration"]
        return self


def train_pbt(env, ppo_args, pbt: PBTArgs, iterations: int, seed: int = 0,
              log_fn=print, log_freq: int = 10, run_dir=None):
    """The host loop: population training with periodic exploit/explore on
    the fitness; -> (Population, fitness (P,))."""
    pop = Population(env, ppo_args, pbt, seed=seed, run_dir=run_dir,
                     log_freq=log_freq)
    pop.learn(iterations, log_fn=log_fn)
    return pop, pop.fitness
