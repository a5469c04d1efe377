"""Recurrent PPO with Constraints-as-Terminations: GRU memories for the
actor and the critic (port of `wtw_tpu/learn/cat_ppornn.py`, reference
algos/PPORNN.py:69-337).

- one GRU memory per net (hidden 256) whose output is concatenated before
  the observation, [gru_out, obs], into the 512-256-128 ELU heads
  (:72-95). The memories are `nn.GRUCell`s: torch's own gating (r, z, n
  with n = tanh(i_n + r (W_hn h + b_hn))), which is the JAX package's
  hand-rolled cell; its (in, 3H) weights are the cell's transposed;
- hiddens carried across iterations and zeroed on hard dones in the
  rollout (:207-210);
- minibatches are whole env trajectories: the update replays each env's
  T-step sequence from the iteration-start hiddens (:246-266). The replay
  zeroes the hiddens after step t with the hard-done flag carried INTO
  step t (the previous step's), one step later than the rollout zeroed
  them, exactly as the JAX learner does; so after a hard done the
  replayed action means differ from the rollout's under the same weights;
- `num_envs // num_minibatches` envs a minibatch, the remainder dropped
  each epoch; the entropy is the scalar sum(logstd + 0.5 log(2 pi e));
- the CaT float-done GAE and both normalizers of `cat_ppo.py`.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..parallel.mesh import all_mean
from ..utils import spans
from .cat_ppo import (CatAgent, CatPPO, CatPPOArgs, CatRollout, cat_gae,
                      clipped_terms, rms_norm, rms_update)


@dataclass(frozen=True)
class RNNArgs(CatPPOArgs):
    rnn_hidden_dim: int = 256     # RNN_LATENT_DIM (algos/PPORNN.py:140)


class RNNAgent(CatAgent):
    """Two GRU memories and the CaT heads over [gru_out, obs]."""

    def __init__(self, num_obs: int, num_actions: int, hidden=(512, 256, 128),
                 rnn_hidden_dim: int = 256,
                 generator: Optional[torch.Generator] = None):
        d = rnn_hidden_dim
        super().__init__(num_obs, num_actions, hidden, generator,
                         head_in=d + num_obs)
        self.actor_memory = nn.GRUCell(num_obs, d)
        self.critic_memory = nn.GRUCell(num_obs, d)
        bound = 1.0 / math.sqrt(d)          # init_gru, torch's default
        with torch.no_grad():
            for p in list(self.actor_memory.parameters()) + list(
                    self.critic_memory.parameters()):
                p.uniform_(-bound, bound, generator=generator)

    def forward(self, obs, ac_h, cr_h):
        """One step; -> (action mean, value, actor hidden, critic
        hidden)."""
        ac_out = self.actor_memory(obs, ac_h)
        cr_out = self.critic_memory(obs, cr_h)
        mean = self.actor_mean(torch.cat([ac_out, obs], dim=-1))
        value = self.critic(torch.cat([cr_out, obs], dim=-1))[..., 0]
        return mean, value, ac_out, cr_out


@dataclasses.dataclass
class RNNRollout(CatRollout):
    """CatRollout and the iteration-start hiddens the update replays
    from."""
    ac_h0: torch.Tensor = None
    cr_h0: torch.Tensor = None


class CatPPORNN(CatPPO):
    """The recurrent CaT learner (the JAX RNNTrainState): CatPPO's state and
    the carried hiddens (N, rnn_hidden_dim) of both memories."""

    APPLIES_STD_FLOOR = False
    GROUP_MOMENTS = False

    def __init__(self, env, args: RNNArgs = RNNArgs(), seed: int = 0,
                 group=None):
        super().__init__(env, args, seed, group)
        shape = (env.num_envs, args.rnn_hidden_dim)
        self.ac_hidden = torch.zeros(shape, device=env.device)
        self.cr_hidden = torch.zeros(shape, device=env.device)

    def make_agent(self, generator):
        return RNNAgent(self.env.num_obs, self.env.num_actions,
                        self.args.hidden, self.args.rnn_hidden_dim,
                        generator=generator)

    def state(self) -> dict:
        return {**super().state(), "ac_hidden": self.ac_hidden,
                "cr_hidden": self.cr_hidden}

    def load_state(self, blob: dict):
        super().load_state(blob)
        self.ac_hidden, self.cr_hidden = blob["ac_hidden"], blob["cr_hidden"]

    @spans.spanned("learner.rollout", opens_record=True)
    @torch.no_grad()
    def rollout(self, world, obs_norm, noise: Optional[torch.Tensor] = None):
        """`num_steps` env steps carrying both hiddens, zeroed after a hard
        done; `noise` (T, N, A) replaces the drawn action noise. ->
        (world, next normalized obs, RNNRollout, {"mean_step_reward"})."""
        env, agent = self.env, self.agent
        done, true_done = self.next_done, self.next_true_done
        ac_h0, cr_h0 = self.ac_hidden, self.cr_hidden
        ac_h, cr_h = ac_h0, cr_h0
        steps = []
        for t in range(self.args.num_steps):
            with spans.span("learner.act"):
                mean, value, ac_h, cr_h = agent(obs_norm, ac_h, cr_h)
                actions = self.sample(t, mean, noise)
                logp = agent.log_prob(mean, actions)
            world, next_obs, rew, done_prob, info = env.step(world, actions)
            steps.append((obs_norm, actions, logp, rew, done, true_done,
                          value))
            obs_norm = self.observe(next_obs)
            done, true_done = done_prob, info["true_dones"].float()
            keep = (1.0 - true_done)[:, None]
            ac_h, cr_h = ac_h * keep, cr_h * keep
        self.next_done, self.next_true_done = done, true_done
        self.ac_hidden, self.cr_hidden = ac_h, cr_h
        traj = RNNRollout(*[torch.stack(x) for x in zip(*steps)],
                          ac_h0=ac_h0, cr_h0=cr_h0)
        return world, obs_norm, traj, {"mean_step_reward": all_mean(
            traj.rewards.mean(), self.group)}

    @spans.spanned("learner.replay")
    def replay(self, obs, ac_h, cr_h, true_dones):
        """Both GRUs over (T, B, obs) from the given hiddens, zeroing them
        after step t with `true_dones[t]` (the flags carried into each
        step, as the JAX update has it); -> (means (T, B, A), values
        (T, B))."""
        means, values = [], []
        for t in range(obs.shape[0]):
            mean, value, ac_h, cr_h = self.agent(obs[t], ac_h, cr_h)
            keep = (1.0 - true_dones[t])[:, None]
            ac_h, cr_h = ac_h * keep, cr_h * keep
            means.append(mean)
            values.append(value)
        return torch.stack(means), torch.stack(values)

    def loss(self, batch, value_rms):
        """The CaT loss on replayed sequences (`cat_ppornn.py` loss_fn);
        advantages normalized over the (T, envs) block; -> (loss, pg,
        v)."""
        args, agent = self.args, self.agent
        obs, actions, old_logp, adv, ret_n, val_n, ac_h0, cr_h0, td = batch
        means, values = self.replay(obs, ac_h0, cr_h0, td)
        logp = agent.log_prob(means, actions)
        pg_loss, v_loss = clipped_terms(args, logp, old_logp, adv,
                                        rms_norm(value_rms, values), ret_n,
                                        val_n)
        loss = pg_loss - args.ent_coef * agent.entropy() + args.vf_coef * v_loss
        return loss, pg_loss, v_loss

    @spans.spanned("learner.update")
    def update(self, traj: RNNRollout, next_obs_norm,
               perms: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """CaT GAE bootstrapped through one more GRU step, value
        normalization, then `update_epochs` x `num_minibatches` steps on
        whole env sequences; `perms` (epochs, N) replaces the drawn
        permutations of the envs."""
        args = self.args
        T, N = traj.rewards.shape
        with torch.no_grad():
            _, next_value, _, _ = self.agent(next_obs_norm, self.ac_hidden,
                                             self.cr_hidden)
        advs, returns = cat_gae(traj.rewards, traj.dones, traj.true_dones,
                                traj.values, next_value, self.next_done,
                                self.next_true_done, args.gamma,
                                args.gae_lambda)
        value_rms = rms_update(rms_update(self.value_rms,
                                          traj.values.reshape(-1)),
                               returns.reshape(-1))
        self.value_rms = value_rms
        val_n, ret_n = (rms_norm(value_rms, traj.values),
                        rms_norm(value_rms, returns))
        lr = self.set_lr()
        mb = max(N // args.num_minibatches, 1)
        rows = []
        for ep in range(args.update_epochs):
            perm = (perms[ep] if perms is not None else torch.randperm(
                N, generator=self.gen, device=advs.device))
            for idx in perm[:mb * args.num_minibatches].reshape(
                    args.num_minibatches, mb):
                with spans.span("learner.minibatch"):
                    batch = (traj.obs[:, idx], traj.actions[:, idx],
                             traj.logp[:, idx], advs[:, idx], ret_n[:, idx],
                             val_n[:, idx], traj.ac_h0[idx], traj.cr_h0[idx],
                             traj.true_dones[:, idx])
                    rows.append(self.optimize(self.loss(batch, value_rms)))
        return self.stats(rows, lr)

    def train_iteration(self, world, obs_norm, noise=None, perms=None):
        """Rollout + update; -> (world, next normalized obs, stats): the
        losses, lr and the mean step reward, as the JAX learner."""
        world, obs_norm, traj, metrics = self.rollout(world, obs_norm, noise)
        stats = self.update(traj, obs_norm, perms)
        stats.update(metrics)
        return world, obs_norm, stats
