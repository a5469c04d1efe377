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
(`torch.optim.Adam` computes the same update).

Env-sharded data parallelism (`group`, `parallel.mesh`): gradients and the
loss statistics are averaged over the group and the episode counts
summed, in every CaT learner. This learner also takes the normalizers'
moments (averaged, the count summed) and the advantage moments over the
group, and has `CatPPOArgs.sharding_invariant`: per-env action noise (at
the group's global width, this rank's rows) and env-strided minibatches
(env n to minibatch n % M, the same in every epoch), so a sharded run
trains as the unsharded one, here to the bit (each product on one env
block's rows, each sum over envs a fixed tree over the blocks:
`parallel.mesh`). PPO+ and PPO-RNN keep per-rank normalizers and
advantage moments, as the JAX learners do (`GROUP_MOMENTS`).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..parallel.mesh import (all_mean, all_mean_grads_, all_sum, draw_rows,
                             invariant_blocks, invariant_grads, invariant_sum)
from ..utils import spans
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
    # per-env action noise and env-strided minibatches reused across
    # epochs: an env-sharded run trains as the unsharded one (default off:
    # a fresh permutation per epoch, algos/PPO.py:276-285)
    sharding_invariant: bool = False


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


def rms_update(s: RMSState, x: torch.Tensor, group=None,
               blocks=None) -> RMSState:
    """Fold the batch `x` (rows, or (T, envs) for a scalar normalizer) in;
    over a `group` the batch moments are the group's means and its count
    the group's total. With env `blocks` (sharding invariance) the sums are
    block trees (`parallel.mesh.invariant_sum`), envs on x's last axis for
    a scalar normalizer and its first otherwise."""
    W = 1 if group is None else group.size()
    if blocks is not None:
        feat = s.mean.shape
        env_dim = x.dim() - 1 - len(feat)
        part = lambda f, b: f(x.narrow(env_dim, b.start, b.stop - b.start)
                              ).contiguous().reshape((-1,) + feat).sum(0)
        n = x.numel() // max(s.mean.numel(), 1) * W
        bm = invariant_sum([part(lambda y: y, b) for b in blocks], group) / n
        ex2 = invariant_sum([part(lambda y: y * y, b) for b in blocks],
                            group) / n
        bc = n
    else:
        bm = all_mean(x.mean(dim=0), group)
        ex2 = all_mean((x * x).mean(dim=0), group)
        bc = x.shape[0] * W
    bv = ex2 - bm * bm
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


@spans.spanned("learner.gae")
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


def clipped_terms(args: CatPPOArgs, logp, old_logp, adv, newv, ret_n, val_n,
                  group=None):
    """The clipped surrogate on advantages normalized over the minibatch
    (population std, as `jnp.std`; the group's minibatch under sharding)
    and the clipped value loss on normalized values; -> (pg_loss,
    v_loss)."""
    if args.norm_adv:
        m = all_mean(adv.mean(), group)
        v = all_mean(((adv - m) ** 2).mean(), group)
        adv = (adv - m) / (torch.sqrt(v) + 1e-8)
    pg, v_rows = clipped_rows(args, logp, old_logp, adv, newv, ret_n, val_n)
    return pg.mean(), 0.5 * v_rows.mean()


def clipped_rows(args: CatPPOArgs, logp, old_logp, adv, newv, ret_n, val_n):
    """Per-sample clipped surrogate and squared value error (the value
    loss is half their mean) on already normalized advantages."""
    ratio = torch.exp(logp - old_logp)
    pg = torch.maximum(
        -adv * ratio,
        -adv * torch.clamp(ratio, 1 - args.clip_coef, 1 + args.clip_coef))
    if args.clip_vloss:
        v_cl = val_n + torch.clamp(newv - val_n, -args.clip_coef,
                                   args.clip_coef)
        return pg, torch.maximum((newv - ret_n) ** 2, (v_cl - ret_n) ** 2)
    return pg, (newv - ret_n) ** 2


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
    # normalizer and advantage moments over the group, and the
    # sharding_invariant mode: the JAX CaT learner has them, PPO+ and
    # PPO-RNN do not
    GROUP_MOMENTS = True

    def __init__(self, env, args: CatPPOArgs = CatPPOArgs(), seed: int = 0,
                 group=None):
        """group: a process group of env-sharded data parallelism
        (`parallel.mesh`), or None."""
        self.env, self.args, self.group = env, args, group
        self.moments_group = group if self.GROUP_MOMENTS else None
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

    def invariant(self) -> bool:
        """The sharding_invariant mode (CaT PPO only, as in JAX)."""
        return self.args.sharding_invariant and self.GROUP_MOMENTS

    def blocks(self, n: int):
        return invariant_blocks(n, self.group)

    def per_block(self, f, x):
        """f over x's rows, one env block at a time under sharding
        invariance (a product's rows then do not depend on the width)."""
        if not self.invariant():
            return f(x)
        return torch.cat([f(x[b]) for b in self.blocks(x.shape[0])])

    def observe(self, obs: torch.Tensor) -> torch.Tensor:
        """Fold a raw observation into the normalizer; -> normalized."""
        self.obs_rms = rms_update(
            self.obs_rms, obs, self.moments_group,
            self.blocks(obs.shape[0]) if self.invariant() else None)
        return rms_norm(self.obs_rms, obs)

    # ------------------------------------------------------------------
    def sample(self, t: int, mean, noise=None):
        """mean + std eps; `noise` (T, N, A) replaces the drawn eps. Under
        sharding_invariant eps is drawn per env (the group's global width,
        this rank's rows)."""
        draw = lambda shape: torch.randn(shape, generator=self.gen,
                                         device=mean.device)
        if noise is not None:
            eps = noise[t]
        elif self.args.sharding_invariant and self.GROUP_MOMENTS:
            eps = draw_rows(draw, mean.shape, self.group)
        else:
            eps = draw(mean.shape)
        return mean + torch.exp(self.agent.actor_logstd) * eps

    @spans.spanned("learner.act")
    def act(self, t: int, obs_norm, noise=None):
        """The rollout's step-t policy: sampled actions, their log-prob and
        the value."""
        agent = self.agent
        mean = self.per_block(agent.actor_mean, obs_norm)
        actions = self.sample(t, mean, noise)
        return (actions, agent.log_prob(mean, actions),
                self.per_block(agent.value, obs_norm))

    @spans.spanned("learner.rollout", opens_record=True)
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
        g = self.group
        n_resets = all_sum(n_resets, g)
        total = torch.clamp(n_resets, min=1)
        metrics = {
            "terrain_level_mean": all_mean(info["terrain_level_mean"], g),
            "episode_sums": all_sum(ep_sums, g) / total,
            "mean_episode_length": all_sum(ep_len, g) / total * env.dt,
            "num_episodes": n_resets,
            "crossings_by_type": all_sum(cross, g),
            "dones_by_type": all_sum(dones_t, g),
            "mean_step_reward": all_mean(traj.rewards.mean(), g),
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
            ret_n, val_n, self.moments_group)
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
        with spans.span("learner.backward"):
            out[0].backward()
        all_mean_grads_(list(self.agent.parameters()), self.group)
        self.step()
        return torch.stack([x.detach() for x in out])

    @spans.spanned("learner.optimizer")
    def step(self):
        """Clip the gradients' global norm, the Adam step, the std
        floor."""
        clip_by_global_norm_(list(self.agent.parameters()),
                             self.args.max_grad_norm)
        self.opt.step()
        if self.APPLIES_STD_FLOOR and self.args.std_floor > 0.0:
            with torch.no_grad():
                self.agent.actor_logstd.clamp_(
                    min=math.log(self.args.std_floor))

    def stats(self, rows, lr) -> Dict[str, torch.Tensor]:
        """Minibatch rows averaged under LOSS_KEYS, the lr, one iteration
        more."""
        self.iteration += 1
        stats = dict(zip(self.LOSS_KEYS, all_mean(
            torch.stack(rows).mean(0), self.group).unbind()))
        stats["lr"] = lr
        return stats

    @spans.spanned("learner.update")
    def update(self, traj: CatRollout, next_obs_norm,
               perms: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """CaT GAE, value normalization and `update_epochs` x
        `num_minibatches` steps; `perms` (epochs, T*N) replaces the drawn
        permutations."""
        args, agent = self.args, self.agent
        T, N = traj.rewards.shape
        if perms is None and self.invariant():
            return self._invariant_update(traj, next_obs_norm)
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
        mg = self.moments_group
        value_rms = rms_update(rms_update(self.value_rms, b_val, mg), b_ret,
                               mg)
        self.value_rms = value_rms
        b_val_n, b_ret_n = rms_norm(value_rms, b_val), rms_norm(value_rms,
                                                                b_ret)
        lr = self.set_lr()
        M = args.num_minibatches
        mb = T * N // M
        rows = []
        for ep in range(args.update_epochs):
            perm = (perms[ep] if perms is not None else torch.randperm(
                T * N, generator=self.gen, device=b_obs.device))
            for idx in perm[:mb * M].reshape(M, mb):
                with spans.span("learner.minibatch"):
                    batch = (b_obs[idx], b_act[idx], b_logp[idx], b_adv[idx],
                             b_ret_n[idx], b_val_n[idx])
                    rows.append(self.optimize(self.loss(batch, value_rms)))
        return self.stats(rows, lr)

    def _invariant_update(self, traj: CatRollout, next_obs_norm):
        """`update` under sharding_invariant, block by block: minibatch m
        holds the envs n with n % M == m in every epoch, each block's rows
        in timestep order; the value normalizer's and each minibatch's
        advantage moments and every loss are sums over a block's rows as a
        tree over the blocks, each block's gradient taken apart and summed
        as a tree (`parallel.mesh.invariant_grads`), the entropy term's
        added once."""
        args, agent, g = self.args, self.agent, self.group
        T, N = traj.rewards.shape
        M, W = args.num_minibatches, 1 if g is None else g.size()
        if N % M:
            raise ValueError(f"sharding_invariant: {N} envs a shard do not "
                             f"divide into {M} minibatches")
        blocks = self.blocks(N)
        with torch.no_grad():
            next_value = self.per_block(agent.value, next_obs_norm)
        advs, returns = cat_gae(traj.rewards, traj.dones, traj.true_dones,
                                traj.values, next_value, self.next_done,
                                self.next_true_done, args.gamma,
                                args.gae_lambda)
        value_rms = rms_update(rms_update(self.value_rms, traj.values, g,
                                          blocks), returns, g, blocks)
        self.value_rms = value_rms
        flat = lambda x: x.reshape((T * N,) + x.shape[2:])
        data = [flat(x) for x in (traj.obs, traj.actions, traj.logp, advs,
                                  rms_norm(value_rms, returns),
                                  rms_norm(value_rms, traj.values))]
        dev = traj.rewards.device
        rows = {}
        for m in range(M):
            for i, b in enumerate(blocks):
                envs = torch.arange(b.start, b.stop, device=dev)
                envs = envs[envs % M == m]
                rows[m, i] = (torch.arange(T, device=dev)[:, None] * N
                              + envs[None]).reshape(-1)
        cnt = T * N * W // M
        params = list(agent.parameters())
        lr = self.set_lr()
        out = []
        for _ in range(args.update_epochs):
            for m in range(M):
                out.append(self._invariant_step(
                    [[x[rows[m, i]] for x in data]
                     for i in range(len(blocks))], value_rms, cnt, params))
        return self.stats(out, lr)

    @spans.spanned("learner.minibatch")
    def _invariant_step(self, batches, value_rms, cnt, params):
        """One minibatch of `_invariant_update`; -> (loss, pg, v)."""
        args, agent, g = self.args, self.agent, self.group
        if args.norm_adv:
            m = invariant_sum([b[3].sum() for b in batches], g) / cnt
            v = invariant_sum([((b[3] - m) ** 2).sum() for b in batches],
                              g) / cnt
        grads, aux = [], []
        for obs, act, logp0, adv, ret_n, val_n in batches:
            if args.norm_adv:
                adv = (adv - m) / (torch.sqrt(v) + 1e-8)
            pg, v_rows = clipped_rows(
                args, agent.log_prob(agent.actor_mean(obs), act), logp0, adv,
                rms_norm(value_rms, agent.value(obs)), ret_n, val_n)
            pg, vl = pg.sum(), 0.5 * v_rows.sum()
            grads.append(torch.autograd.grad(
                (pg + args.vf_coef * vl) / cnt, params, allow_unused=True))
            aux.append(torch.stack([pg.detach(), vl.detach()]))
        pg, vl = (invariant_sum(aux, g) / cnt).unbind()
        ent = agent.entropy()
        (g_ent,) = torch.autograd.grad(-args.ent_coef * ent,
                                       agent.actor_logstd)
        grads = invariant_grads(grads, g)
        i = next(i for i, p in enumerate(params) if p is agent.actor_logstd)
        grads[i] = grads[i] + g_ent
        self.opt.zero_grad(set_to_none=True)
        for p, gr in zip(params, grads):
            p.grad = gr
        self.step()
        return torch.stack([pg - args.ent_coef * ent.detach()
                            + args.vf_coef * vl, pg, vl])

    def train_iteration(self, world, obs_norm, noise=None, perms=None):
        """Rollout + update; -> (world, next normalized obs, stats)."""
        world, obs_norm, traj, metrics = self.rollout(world, obs_norm, noise)
        stats = self.update(traj, obs_norm, perms)
        stats.update(metrics)
        return world, obs_norm, stats
