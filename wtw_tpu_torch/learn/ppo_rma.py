"""RMA-style PPO: a teacher with an env-factor encoder and a student
adaptation module (port of `wtw_tpu/learn/ppo_rma.py`, reference
go1_gym_learn/ppo/).

- encoder: privileged obs -> latent (18), hidden 256-128
  (ppo/actor_critic.py:17-20, 38-56);
- adaptation module: obs_history -> latent, hidden 256-32, trained by MSE
  onto the encoder's latent, the target detached (ppo/ppo.py:156-164);
- actor and critic read [current obs, latent]; std is a parameter;
- the rollout acts with the teacher latent encoder(priv) and bootstraps
  time-outs into the reward (rew + gamma value time_out);
- one permutation of the T*N samples, reused across epochs; per
  minibatch the adaptive-KL learning rate, the PPO step (clip the global
  gradient norm, then Adam with eps 1e-8), then
  `num_adaptation_module_substeps` Adam steps of the adaptation module.

The JAX package runs the adaptation step as `optax.adam` over the whole
parameter tree with zero gradients outside the adaptation module. Adam
moves a parameter whose gradients have all been exactly zero by exactly
zero, so an Adam over the adaptation module's parameters alone computes
the same thing, as long as the loss reaches no other parameter (the
encoder's target is detached, the heads are not used). Likewise the PPO
step's Adam skips the adaptation module, which its loss does not reach.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..models import actor_critic as ac
from ..parallel.mesh import all_mean, all_mean_grads_
from .ppo_cse import PPOArgs, clip_by_global_norm_, compute_gae


@dataclass(frozen=True)
class RMAArgs:
    # ppo/actor_critic.py:9-20
    init_noise_std: float = 1.0
    actor_hidden_dims: Tuple[int, ...] = (512, 256, 128)
    critic_hidden_dims: Tuple[int, ...] = (512, 256, 128)
    encoder_hidden_dims: Tuple[int, ...] = (256, 128)
    adaptation_hidden_dims: Tuple[int, ...] = (256, 32)
    latent_dim: int = 18
    activation: str = "elu"


class RMAModel(nn.Module):
    """Encoder, adaptation module, actor, critic and std (init_rma);
    Linear layers uniform in +-1/sqrt(fan_in) from `generator`."""

    def __init__(self, num_obs: int, num_privileged_obs: int,
                 num_obs_history: int, num_actions: int,
                 args: RMAArgs = RMAArgs(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, act = args.latent_dim, args.activation
        self.encoder = ac._mlp((num_privileged_obs,)
                               + tuple(args.encoder_hidden_dims) + (d,), act)
        self.adaptation = ac._mlp((num_obs_history,)
                                  + tuple(args.adaptation_hidden_dims) + (d,),
                                  act)
        self.actor = ac._mlp((num_obs + d,) + tuple(args.actor_hidden_dims)
                             + (num_actions,), act)
        self.critic = ac._mlp((num_obs + d,) + tuple(args.critic_hidden_dims)
                              + (1,), act)
        self.std = nn.Parameter(args.init_noise_std * torch.ones(num_actions))
        ac.init_uniform_(self, generator)

    def actor_mean(self, obs, latent):
        return self.actor(torch.cat([obs, latent], dim=-1))

    def evaluate(self, obs, latent):
        return self.critic(torch.cat([obs, latent], dim=-1))[..., 0]

    def act_student(self, obs, obs_history):
        """Deployment path: the latent from the adaptation module."""
        latent = self.adaptation(obs_history)
        return self.actor_mean(obs, latent), latent


@dataclasses.dataclass
class RMARollout:
    """(T, N, ...) buffers of one rollout."""
    obs: torch.Tensor
    privileged_obs: torch.Tensor
    obs_history: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor          # time-outs bootstrapped in
    dones: torch.Tensor
    values: torch.Tensor
    log_probs: torch.Tensor
    mu: torch.Tensor


class RMA:
    """Learner state (the JAX RMATrainState): the model, both optimizers,
    the adaptive learning rate, the iteration count and the generator for
    action noise and the permutation."""

    def __init__(self, env, args: PPOArgs = PPOArgs(),
                 rma: RMAArgs = RMAArgs(), seed: int = 0, group=None):
        """group: a process group of env-sharded data parallelism
        (`parallel.mesh`): gradients, the KL and the statistics are
        averaged over it, where the JAX learner pmeans them."""
        self.env, self.args, self.group = env, args, group
        dev = env.device
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(int(seed) + 1)
        init_gen = torch.Generator()
        init_gen.manual_seed(int(seed))
        self.model = RMAModel(env.num_obs, env.num_privileged_obs,
                              env.num_obs_history, env.num_actions, rma,
                              generator=init_gen).to(dev)
        self.opt = torch.optim.Adam(
            [p for n, p in self.model.named_parameters()
             if not n.startswith("adaptation.")],
            lr=args.learning_rate, eps=1e-8)
        self.adapt_opt = torch.optim.Adam(
            self.model.adaptation.parameters(),
            lr=args.adaptation_module_learning_rate, eps=1e-8)
        self.lr = float(args.learning_rate)
        self.iteration = 0

    def state(self) -> dict:
        """Everything an exact resume needs, for `torch.save`."""
        return {"model": self.model.state_dict(), "opt": self.opt.state_dict(),
                "adapt_opt": self.adapt_opt.state_dict(), "lr": self.lr,
                "iteration": self.iteration, "gen_state": self.gen.get_state()}

    def load_state(self, blob: dict):
        self.model.load_state_dict(blob["model"])
        self.opt.load_state_dict(blob["opt"])
        self.adapt_opt.load_state_dict(blob["adapt_opt"])
        self.lr, self.iteration = blob["lr"], blob["iteration"]
        self.gen.set_state(blob["gen_state"])

    # ------------------------------------------------------------------
    @torch.no_grad()
    def rollout(self, world, obs_dict, noise: Optional[torch.Tensor] = None):
        """`num_steps_per_env` env steps acting with the teacher latent;
        `noise` (T, N, A) replaces the drawn action noise. -> (world,
        obs_dict, RMARollout, {"mean_step_reward"} of the raw rewards)."""
        env, args, model = self.env, self.args, self.model
        steps, raw = [], []
        for t in range(args.num_steps_per_env):
            obs, priv = obs_dict["obs"], obs_dict["privileged_obs"]
            latent = model.encoder(priv)
            mean = model.actor_mean(obs, latent)
            std = model.std.expand_as(mean)
            eps = (noise[t] if noise is not None else torch.randn(
                mean.shape, generator=self.gen, device=mean.device))
            actions = mean + std * eps
            logp = ac.log_prob(mean, std, actions)
            values = model.evaluate(obs, latent)
            world, next_obs, rew, done, info = env.step(world, actions)
            rew_b = rew + args.gamma * values * info["time_outs"]
            steps.append((obs, priv, obs_dict["obs_history"], actions, rew_b,
                          done.float(), values, logp, mean))
            raw.append(rew)
            obs_dict = next_obs
        traj = RMARollout(*[torch.stack(x) for x in zip(*steps)])
        return world, obs_dict, traj, {"mean_step_reward":
                                       torch.stack(raw).mean()}

    # ------------------------------------------------------------------
    def ppo_loss(self, obs, priv, actions, old_logp, old_mu, old_std,
                 target_v, adv, ret):
        """Clipped surrogate + clipped value loss - entropy, and the KL to
        the rollout's policy; -> (loss, surrogate, value loss, kl)."""
        args, model = self.args, self.model
        latent = model.encoder(priv)
        mean = model.actor_mean(obs, latent)
        std = model.std.expand_as(mean)
        logp = ac.log_prob(mean, std, actions)
        value = model.evaluate(obs, latent)
        ratio = torch.exp(logp - old_logp)
        surr = torch.maximum(
            -adv * ratio,
            -adv * torch.clamp(ratio, 1 - args.clip_param,
                               1 + args.clip_param)).mean()
        v_clipped = target_v + torch.clamp(value - target_v, -args.clip_param,
                                           args.clip_param)
        v_loss = torch.maximum((value - ret) ** 2,
                               (v_clipped - ret) ** 2).mean()
        loss = (surr + args.value_loss_coef * v_loss
                - args.entropy_coef * ac.entropy(std).mean())
        with torch.no_grad():
            kl = torch.sum(
                torch.log(std / old_std + 1e-5)
                + (old_std ** 2 + (old_mu - mean) ** 2) / (2 * std ** 2)
                - 0.5, dim=-1).mean()
        return loss, surr, v_loss, kl

    def adaptation_loss(self, obs_h, priv):
        """MSE of the adaptation module onto the detached encoder latent
        (ppo/ppo.py:156-164)."""
        model = self.model
        with torch.no_grad():
            target = model.encoder(priv)
        return torch.mean((model.adaptation(obs_h) - target) ** 2)

    def minibatch_step(self, batch) -> torch.Tensor:
        """The PPO step with the adaptive-KL learning rate, then the
        adaptation substeps; -> (loss, surrogate, value, kl, the last
        substep's adaptation loss)."""
        args = self.args
        obs, priv, obs_h, actions, logp, mu, values, adv, ret, old_std = batch
        self.opt.zero_grad(set_to_none=True)
        loss, surr, v_loss, kl = self.ppo_loss(obs, priv, actions, logp, mu,
                                               old_std, values, adv, ret)
        loss.backward()
        all_mean_grads_(list(self.model.parameters()), self.group)
        kl = all_mean(kl, self.group)
        if args.desired_kl is not None and args.schedule == "adaptive":
            k = float(kl)
            if k > args.desired_kl * 2.0:
                self.lr = max(1e-5, self.lr / 1.5)
            elif 0.0 < k < args.desired_kl / 2.0:
                self.lr = min(1e-2, self.lr * 1.5)
        for group in self.opt.param_groups:
            group["lr"] = self.lr
        clip_by_global_norm_([p for g in self.opt.param_groups
                              for p in g["params"]], args.max_grad_norm)
        self.opt.step()
        a_loss = torch.zeros((), device=loss.device)
        for _ in range(args.num_adaptation_module_substeps):
            self.adapt_opt.zero_grad(set_to_none=True)
            a_loss = self.adaptation_loss(obs_h, priv)
            a_loss.backward()
            all_mean_grads_(list(self.model.adaptation.parameters()),
                            self.group)
            self.adapt_opt.step()
        return torch.stack([loss.detach(), surr.detach(), v_loss.detach(),
                            kl, a_loss.detach()])

    def update(self, traj: RMARollout, last_obs_dict,
               perm: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """GAE (advantages normalized over the batch), then
        num_learning_epochs x num_mini_batches minibatch steps over one
        permutation of the T*N samples; `perm` replaces the drawn one."""
        args, model = self.args, self.model
        T, N = traj.rewards.shape
        with torch.no_grad():
            last_values = model.evaluate(
                last_obs_dict["obs"],
                model.encoder(last_obs_dict["privileged_obs"]))
        advs, returns = compute_gae(traj.rewards, traj.dones, traj.values,
                                    last_values, args.gamma, args.lam)
        old_std = model.std.detach().clone()
        if perm is None:
            perm = torch.randperm(T * N, generator=self.gen,
                                  device=traj.rewards.device)
        flat = lambda x: x.reshape((T * N,) + x.shape[2:])[perm]
        data = [flat(x) for x in (traj.obs, traj.privileged_obs,
                                  traj.obs_history, traj.actions,
                                  traj.log_probs, traj.mu, traj.values, advs,
                                  returns)]
        mb = T * N // args.num_mini_batches
        rows = []
        for _ in range(args.num_learning_epochs):
            for m in range(args.num_mini_batches):
                sl = slice(m * mb, (m + 1) * mb)
                rows.append(self.minibatch_step(
                    tuple(x[sl] for x in data) + (old_std,)))
        self.iteration += 1
        keys = ("loss", "surrogate_loss", "value_loss", "kl_mean",
                "adaptation_loss")
        stats = dict(zip(keys, all_mean(torch.stack(rows).mean(0),
                                        self.group).unbind()))
        stats["lr"] = self.lr
        return stats

    def train_iteration(self, world, obs_dict, noise=None, perm=None):
        """Rollout + update; -> (world, obs_dict, stats)."""
        world, obs_dict, traj, metrics = self.rollout(world, obs_dict, noise)
        stats = self.update(traj, obs_dict, perm)
        stats.update({k: all_mean(v, self.group) for k, v in metrics.items()})
        return world, obs_dict, stats
