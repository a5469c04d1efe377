"""CleanRL-style PPO with Constraints-as-Terminations (Stack B learner; port
of `wtw_tpu/learn/cat_ppo.py`, reference algos/PPO.py:14-330).

- RunningMeanStd observation and value normalizers (:20-62);
- separate actor-mean and critic MLPs [512, 256, 128], ELU, orthogonal
  init, and a learned state-independent log-std (:69-105);
- CaT float-done GAE: rewards *= (1 - done_prob), and the bootstrap factor
  is nextnonterminal (probabilistic) x true_nextnonterminal (hard dones)
  (:244-263);
- linear LR anneal, clipped surrogate + clipped value loss on the
  value-normalized returns, 5 epochs of minibatches over a fresh
  permutation each (:276-325).

The optimizer follows the JAX package's optax chain: clip the global
gradient norm at `max_grad_norm`, then Adam with eps 1e-5 outside the sqrt
(`torch.optim.Adam` computes the same update). The JAX package's
`sharding_invariant` mode belongs to multi-device training, which is a
later slice; this learner is the default (reference) mode.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from .ppo_cse import clip_by_global_norm_


@dataclass(frozen=True)
class CatPPOArgs:
    # cfg/train/Go2ParkourPPO.yaml via algos/PPO.py:152-165
    learning_rate: float = 3e-4
    num_steps: int = 24               # horizon_length
    num_iterations: int = 8000        # max_epochs (the LR-anneal horizon)
    gamma: float = 0.99
    gae_lambda: float = 0.95
    update_epochs: int = 5
    num_minibatches: int = 6          # minibatch_size 16384 of 24*4096
    clip_coef: float = 0.2
    ent_coef: float = 0.001
    vf_coef: float = 2.0
    max_grad_norm: float = 1.0
    norm_adv: bool = True
    clip_vloss: bool = True
    anneal_lr: bool = True
    std_floor: float = 0.0            # 0 = free logstd (reference-exact)
    hidden: tuple = (512, 256, 128)


@dataclasses.dataclass
class RMSState:
    """RunningMeanStd (algos/PPO.py:20-62)."""
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @classmethod
    def create(cls, shape=(), device="cpu"):
        return cls(mean=torch.zeros(shape, device=device),
                   var=torch.ones(shape, device=device),
                   count=torch.ones((), device=device))


def rms_update(s: RMSState, x: torch.Tensor) -> RMSState:
    bm = x.mean(dim=0)
    bv = (x * x).mean(dim=0) - bm * bm
    bc = x.shape[0]
    delta = bm - s.mean
    tot = s.count + bc
    m2 = s.var * s.count + bv * bc + delta * delta * s.count * bc / tot
    return RMSState(mean=s.mean + delta * bc / tot, var=m2 / tot, count=tot)


def rms_norm(s: RMSState, x: torch.Tensor, eps: float = 1e-8):
    return (x - s.mean) / torch.sqrt(s.var + eps)


def _mlp(sizes, out_gain: float, generator=None) -> nn.Sequential:
    """Linear/ELU stack, orthogonal weights (gain sqrt 2, `out_gain` on the
    last layer) and zero biases (layer_init, algos/PPO.py:64-67)."""
    layers = []
    n = len(sizes) - 1
    for i in range(n):
        lin = nn.Linear(sizes[i], sizes[i + 1])
        with torch.no_grad():
            nn.init.orthogonal_(lin.weight,
                                gain=out_gain if i == n - 1 else math.sqrt(2),
                                generator=generator)
            lin.bias.zero_()
        layers.append(lin)
        if i < n - 1:
            layers.append(nn.ELU())
    return nn.Sequential(*layers)


class CatAgent(nn.Module):
    """Actor mean, critic and log-std (init_agent, `cat_ppo.py:92-148`).
    The heads read `head_in` features (default: the observation)."""

    def __init__(self, num_obs: int, num_actions: int, hidden=(512, 256, 128),
                 generator: Optional[torch.Generator] = None,
                 head_in: Optional[int] = None):
        super().__init__()
        h, n_in = list(hidden), head_in or num_obs
        self.critic = _mlp([n_in] + h + [1], 1.0, generator)
        self.actor_mean = _mlp([n_in] + h + [num_actions], 0.01, generator)
        self.actor_logstd = nn.Parameter(torch.zeros(num_actions))

    def value(self, obs: torch.Tensor) -> torch.Tensor:
        return self.critic(obs)[..., 0]

    def log_prob(self, mean: torch.Tensor, actions: torch.Tensor):
        logstd = self.actor_logstd
        return (-0.5 * ((actions - mean) / torch.exp(logstd)) ** 2 - logstd
                - 0.5 * math.log(2 * math.pi)).sum(-1)

    def entropy(self) -> torch.Tensor:
        return (self.actor_logstd
                + 0.5 * math.log(2 * math.pi * math.e)).sum()


def cat_gae(rewards, dones, true_dones, values, next_value, next_done,
            next_true_done, gamma: float, lam: float):
    """Float-done GAE (algos/PPO.py:244-263), (T, N) inputs: rewards *=
    (1 - dones), and the bootstrap carries nextnonterminal x
    true_nextnonterminal. -> (advantages, returns)."""
    rewards = rewards * (1.0 - dones)
    nd = torch.cat([dones[1:], next_done[None]])
    ntd = torch.cat([true_dones[1:], next_true_done[None]])
    nv = torch.cat([values[1:], next_value[None]])
    advs = torch.empty_like(rewards)
    last = torch.zeros_like(next_value)
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterm = (1.0 - nd[t]) * (1.0 - ntd[t])
        delta = rewards[t] + gamma * nv[t] * nonterm - values[t]
        last = delta + gamma * lam * nonterm * last
        advs[t] = last
    return advs, advs + values


def clipped_terms(args: CatPPOArgs, logp, old_logp, adv, newv, ret_n, val_n):
    """The clipped surrogate on advantages normalized over the minibatch
    (population std, as `jnp.std`) and the clipped value loss on normalized
    values; -> (pg_loss, v_loss)."""
    ratio = torch.exp(logp - old_logp)
    if args.norm_adv:
        m = adv.mean()
        v = ((adv - m) ** 2).mean()
        adv = (adv - m) / (torch.sqrt(v) + 1e-8)
    pg_loss = torch.maximum(
        -adv * ratio,
        -adv * torch.clamp(ratio, 1 - args.clip_coef, 1 + args.clip_coef)
    ).mean()
    if args.clip_vloss:
        v_cl = val_n + torch.clamp(newv - val_n, -args.clip_coef,
                                   args.clip_coef)
        v_loss = 0.5 * torch.maximum((newv - ret_n) ** 2,
                                     (v_cl - ret_n) ** 2).mean()
    else:
        v_loss = 0.5 * ((newv - ret_n) ** 2).mean()
    return pg_loss, v_loss


@dataclasses.dataclass
class CatRollout:
    """(T, N, ...) buffers of one rollout; dones are the carried values
    before each step, CleanRL style."""
    obs: torch.Tensor
    actions: torch.Tensor
    logp: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    true_dones: torch.Tensor
    values: torch.Tensor


class CatPPO:
    """Learner state (the JAX CatTrainState): agent, optimizer, both
    normalizers, the iteration count, the dones carried between rollouts
    and the generator for action noise and minibatch permutations."""

    # names of what `loss` returns, averaged over the minibatches
    LOSS_KEYS = ("loss", "pg_loss", "value_loss")
    # the JAX CaT learner floors the log-std after each step; PPO+ does not
    APPLIES_STD_FLOOR = True

    def __init__(self, env, args: CatPPOArgs = CatPPOArgs(), seed: int = 0):
        self.env, self.args = env, args
        dev = env.device
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(int(seed) + 1)
        init_gen = torch.Generator()
        init_gen.manual_seed(int(seed))
        self.agent = self.make_agent(init_gen).to(dev)
        self.opt = torch.optim.Adam(self.agent.parameters(),
                                    lr=args.learning_rate, eps=1e-5)
        self.obs_rms = RMSState.create((env.num_obs,), dev)
        self.value_rms = RMSState.create((), dev)
        self.iteration = 0
        self.next_done = torch.zeros(env.num_envs, device=dev)
        self.next_true_done = torch.zeros(env.num_envs, device=dev)

    def make_agent(self, generator) -> nn.Module:
        return CatAgent(self.env.num_obs, self.env.num_actions,
                        self.args.hidden, generator=generator)

    def state(self) -> dict:
        """Everything an exact resume needs, for `torch.save`."""
        return {"agent": self.agent.state_dict(), "opt": self.opt.state_dict(),
                "obs_rms": dataclasses.asdict(self.obs_rms),
                "value_rms": dataclasses.asdict(self.value_rms),
                "iteration": self.iteration, "gen_state": self.gen.get_state(),
                "next_done": self.next_done,
                "next_true_done": self.next_true_done}

    def load_state(self, blob: dict):
        self.agent.load_state_dict(blob["agent"])
        self.opt.load_state_dict(blob["opt"])
        self.obs_rms = RMSState(**blob["obs_rms"])
        self.value_rms = RMSState(**blob["value_rms"])
        self.iteration = blob["iteration"]
        self.gen.set_state(blob["gen_state"])
        self.next_done, self.next_true_done = (blob["next_done"],
                                               blob["next_true_done"])

    def observe(self, obs: torch.Tensor) -> torch.Tensor:
        """Fold a raw observation into the normalizer; -> normalized."""
        self.obs_rms = rms_update(self.obs_rms, obs)
        return rms_norm(self.obs_rms, obs)

    # ------------------------------------------------------------------
    def sample(self, t: int, mean, noise=None):
        """mean + std eps; `noise` (T, N, A) replaces the drawn eps."""
        eps = (noise[t] if noise is not None else torch.randn(
            mean.shape, generator=self.gen, device=mean.device))
        return mean + torch.exp(self.agent.actor_logstd) * eps

    def act(self, t: int, obs_norm, noise=None):
        """The rollout's step-t policy: sampled actions, their log-prob and
        the value."""
        agent = self.agent
        mean = agent.actor_mean(obs_norm)
        actions = self.sample(t, mean, noise)
        return actions, agent.log_prob(mean, actions), agent.value(obs_norm)

    @torch.no_grad()
    def rollout(self, world, obs_norm, noise: Optional[torch.Tensor] = None,
                **draws):
        """`num_steps` env steps; `noise` (T, N, A) and a subclass's other
        `draws` replace the drawn ones. -> (world, next normalized obs,
        CatRollout, metrics)."""
        env = self.env
        done, true_done = self.next_done, self.next_true_done
        steps = []
        ep_sums = n_resets = ep_len = cross = dones_t = 0
        for t in range(self.args.num_steps):
            actions, logp, value = self.act(t, obs_norm, noise, **draws)
            world, next_obs, rew, done_prob, info = env.step(world, actions)
            steps.append((obs_norm, actions, logp, rew, done, true_done,
                          value))
            obs_norm = self.observe(next_obs)
            done, true_done = done_prob, info["true_dones"].float()
            ep_sums = ep_sums + info["episode_sums_at_reset"]
            n_resets = n_resets + info["num_resets"]
            ep_len = ep_len + info["episode_len_at_reset"]
            cross = cross + info["crossings_by_type"]
            dones_t = dones_t + info["dones_by_type"]
        self.next_done, self.next_true_done = done, true_done
        traj = CatRollout(*[torch.stack(x) for x in zip(*steps)])
        total = torch.clamp(n_resets, min=1)
        metrics = {
            "terrain_level_mean": info["terrain_level_mean"],
            "episode_sums": ep_sums / total,
            "mean_episode_length": ep_len / total * env.dt,
            "num_episodes": n_resets,
            "crossings_by_type": cross, "dones_by_type": dones_t,
            "mean_step_reward": traj.rewards.mean(),
        }
        return world, obs_norm, traj, metrics

    # ------------------------------------------------------------------
    def loss(self, batch, value_rms: RMSState):
        """Clipped surrogate - entropy bonus + clipped value loss on
        normalized returns (`cat_ppo.py` loss_fn); -> (loss, pg, v)."""
        args, agent = self.args, self.agent
        obs, actions, old_logp, adv, ret_n, val_n = batch
        logp = agent.log_prob(agent.actor_mean(obs), actions)
        pg_loss, v_loss = clipped_terms(
            args, logp, old_logp, adv, rms_norm(value_rms, agent.value(obs)),
            ret_n, val_n)
        loss = pg_loss - args.ent_coef * agent.entropy() + args.vf_coef * v_loss
        return loss, pg_loss, v_loss

    def lr(self) -> float:
        """Linear anneal (:199-202), clamped at 0 past num_iterations."""
        args = self.args
        if not args.anneal_lr:
            return args.learning_rate
        frac = min(max(1.0 - self.iteration / args.num_iterations, 0.0), 1.0)
        return frac * args.learning_rate

    def set_lr(self) -> float:
        lr = self.lr()
        for group in self.opt.param_groups:
            group["lr"] = lr
        return lr

    def optimize(self, out) -> torch.Tensor:
        """Backward of `out[0]`, clip, Adam step (and the std floor); ->
        the detached row of `out`."""
        self.opt.zero_grad(set_to_none=True)
        out[0].backward()
        clip_by_global_norm_(list(self.agent.parameters()),
                             self.args.max_grad_norm)
        self.opt.step()
        if self.APPLIES_STD_FLOOR and self.args.std_floor > 0.0:
            with torch.no_grad():
                self.agent.actor_logstd.clamp_(
                    min=math.log(self.args.std_floor))
        return torch.stack([x.detach() for x in out])

    def stats(self, rows, lr) -> Dict[str, torch.Tensor]:
        """Minibatch rows averaged under LOSS_KEYS, the lr, one iteration
        more."""
        self.iteration += 1
        stats = dict(zip(self.LOSS_KEYS, torch.stack(rows).mean(0).unbind()))
        stats["lr"] = lr
        return stats

    def update(self, traj: CatRollout, next_obs_norm,
               perms: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """CaT GAE, value normalization and `update_epochs` x
        `num_minibatches` steps; `perms` (epochs, T*N) replaces the drawn
        permutations."""
        args, agent = self.args, self.agent
        T, N = traj.rewards.shape
        with torch.no_grad():
            next_value = agent.value(next_obs_norm)
        advs, returns = cat_gae(traj.rewards, traj.dones, traj.true_dones,
                                traj.values, next_value, self.next_done,
                                self.next_true_done, args.gamma,
                                args.gae_lambda)
        flat = lambda x: x.reshape((T * N,) + x.shape[2:])
        b_obs, b_act, b_logp = flat(traj.obs), flat(traj.actions), flat(
            traj.logp)
        b_adv, b_ret, b_val = flat(advs), flat(returns), flat(traj.values)
        # value normalization over the batch (algos/PPO.py:273-275)
        value_rms = rms_update(rms_update(self.value_rms, b_val), b_ret)
        self.value_rms = value_rms
        b_val_n, b_ret_n = rms_norm(value_rms, b_val), rms_norm(value_rms,
                                                                b_ret)
        lr = self.set_lr()
        mb = T * N // args.num_minibatches
        rows = []
        for ep in range(args.update_epochs):
            perm = (perms[ep] if perms is not None else torch.randperm(
                T * N, generator=self.gen, device=b_obs.device))
            for idx in perm[:mb * args.num_minibatches].reshape(
                    args.num_minibatches, mb):
                batch = (b_obs[idx], b_act[idx], b_logp[idx], b_adv[idx],
                         b_ret_n[idx], b_val_n[idx])
                rows.append(self.optimize(self.loss(batch, value_rms)))
        return self.stats(rows, lr)

    def train_iteration(self, world, obs_norm, noise=None, perms=None):
        """Rollout + update; -> (world, next normalized obs, stats)."""
        world, obs_norm, traj, metrics = self.rollout(world, obs_norm, noise)
        stats = self.update(traj, obs_norm, perms)
        stats.update(metrics)
        return world, obs_norm, stats
