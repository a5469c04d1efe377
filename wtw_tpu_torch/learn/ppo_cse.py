"""PPO with concurrent state estimation (port of `wtw_tpu/learn/ppo_cse.py`;
reference go1_gym_learn/ppo_cse/{ppo.py, rollout_storage.py}).

One train iteration: a 24-step rollout of env.step, GAE, then 5 epochs x 4
minibatches of clipped-surrogate PPO with the adaptive-KL learning rate,
each minibatch followed by the supervised adaptation-module substep (the
reference's exact interleaving, ppo.py:163-189). Optimizers follow optax's
conventions as the JAX package uses them: the PPO step clips the global
gradient norm (optax.clip_by_global_norm: scale by max/norm when
norm >= max) then runs Adam (eps outside the sqrt, as torch.optim.Adam
does); the adaptation module has its own Adam.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..models import actor_critic as ac


@dataclass(frozen=True)
class PPOArgs:
    # ppo_cse/ppo.py:13-30
    value_loss_coef: float = 1.0
    use_clipped_value_loss: bool = True
    clip_param: float = 0.2
    entropy_coef: float = 0.01
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    learning_rate: float = 1e-3
    adaptation_module_learning_rate: float = 1e-3
    num_adaptation_module_substeps: int = 1
    schedule: str = "adaptive"
    gamma: float = 0.99
    lam: float = 0.95
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    # RunnerArgs (ppo_cse/__init__.py:46)
    num_steps_per_env: int = 24
    # eval envs act with the teacher (the true privileged obs in place of
    # the adaptation module's estimate) instead of the student
    # (ppo_cse/__init__.py:139-145)
    eval_expert: bool = False
    # clamp of the learned policy std after each update (the JAX package's
    # stabilizer, not in the reference)
    std_range: Optional[tuple] = (0.05, 2.0)


@dataclasses.dataclass
class Rollout:
    """(T, n_train, ...) buffers of one rollout."""
    obs_history: torch.Tensor
    privileged_obs: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    values: torch.Tensor
    log_probs: torch.Tensor
    mu: torch.Tensor


def compute_gae(rewards, dones, values, last_values, gamma, lam):
    """rollout_storage.py:76-90; rewards/dones/values (T, N) -> normalized
    advantages and returns."""
    T = rewards.shape[0]
    advs = torch.empty_like(rewards)
    adv_next = torch.zeros_like(last_values)
    v_next = last_values
    dones = dones.float()
    for t in range(T - 1, -1, -1):
        not_done = 1.0 - dones[t]
        delta = rewards[t] + not_done * gamma * v_next - values[t]
        adv_next = delta + not_done * gamma * lam * adv_next
        advs[t] = adv_next
        v_next = values[t]
    returns = advs + values
    mean = advs.mean()
    var = ((advs - mean) ** 2).mean()
    return (advs - mean) / (torch.sqrt(var) + 1e-8), returns


def clip_by_global_norm_(params, max_norm: float):
    """optax.clip_by_global_norm on .grad in place (no host sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)


class PPO:
    """Learner state (the JAX TrainState): actor-critic, both optimizers,
    the adaptive learning rate, the iteration count and the generator for
    action noise and minibatch permutations."""

    def __init__(self, env, args: PPOArgs = PPOArgs(),
                 ac_args: ac.ACArgs = ac.ACArgs(), seed: int = 0):
        self.env, self.args = env, args
        dev = env.device
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(int(seed) + 1)
        init_gen = torch.Generator()
        init_gen.manual_seed(int(seed))
        self.ac = ac.ActorCritic(env.num_obs, env.num_privileged_obs,
                                 env.num_obs_history, env.num_actions,
                                 ac_args, generator=init_gen).to(dev)
        self.opt = torch.optim.Adam(self.ac.parameters(),
                                    lr=args.learning_rate, eps=1e-8)
        self.adapt_opt = torch.optim.Adam(
            self.ac.adaptation.parameters(),
            lr=args.adaptation_module_learning_rate, eps=1e-8)
        self.lr = float(args.learning_rate)
        self.iteration = 0

    def state(self) -> dict:
        """Everything an exact resume needs, for `torch.save`."""
        return {"ac": self.ac.state_dict(), "opt": self.opt.state_dict(),
                "adapt_opt": self.adapt_opt.state_dict(), "lr": self.lr,
                "iteration": self.iteration, "gen_state": self.gen.get_state()}

    def load_state(self, blob: dict):
        self.ac.load_state_dict(blob["ac"])
        self.opt.load_state_dict(blob["opt"])
        self.adapt_opt.load_state_dict(blob["adapt_opt"])
        self.lr, self.iteration = blob["lr"], blob["iteration"]
        self.gen.set_state(blob["gen_state"])

    # ------------------------------------------------------------------
    @torch.no_grad()
    def rollout(self, world, obs_dict):
        env, args, model = self.env, self.args, self.ac
        T, n_tr = args.num_steps_per_env, env.num_train_envs
        steps = []
        ep_sums = n_resets = ep_sums_ev = n_resets_ev = 0
        rew_sum = 0.0
        for _ in range(T):
            obs_h = obs_dict["obs_history"]
            priv = obs_dict["privileged_obs"]
            mean, std = model.distribution(obs_h)
            actions = ac.sample_actions(mean, std, self.gen)
            logp = ac.log_prob(mean, std, actions)
            values = model.evaluate(obs_h, priv)
            # train/eval split (ppo_cse/__init__.py:136-146): the trailing
            # eval envs act with the sampled student, or with the teacher
            # under eval_expert; only the train envs enter the batch
            exec_actions = actions
            if args.eval_expert and n_tr < actions.shape[0]:
                t_mean = model.actor_mean(obs_h[n_tr:], priv[n_tr:])
                exec_actions = torch.cat([actions[:n_tr], ac.sample_actions(
                    t_mean, std[n_tr:], self.gen)])
            world, next_obs, rew, done, info = env.step(world, exec_actions)
            # timeout bootstrapping (ppo.py:84-86)
            rew_b = rew + args.gamma * values * info["time_outs"]
            steps.append((obs_h[:n_tr], priv[:n_tr], actions[:n_tr],
                          rew_b[:n_tr], done[:n_tr], values[:n_tr],
                          logp[:n_tr], mean[:n_tr]))
            ep_sums = ep_sums + info["episode_sums_at_reset"]
            n_resets = n_resets + info["num_resets"]
            ep_sums_ev = ep_sums_ev + info["eval_episode_sums_at_reset"]
            n_resets_ev = n_resets_ev + info["eval_num_resets"]
            rew_sum = rew_sum + rew[:n_tr].mean()
            obs_dict = next_obs
        traj = Rollout(*[torch.stack(x) for x in zip(*steps)])
        metrics = {
            "episode_reward_sums": ep_sums / torch.clamp(n_resets, min=1),
            "num_episodes": n_resets,
            "eval_episode_reward_sums": ep_sums_ev
            / torch.clamp(n_resets_ev, min=1),
            "eval_num_episodes": n_resets_ev,
            "mean_step_reward": rew_sum / T,
            "mean_episode_length": info["mean_episode_length"],
        }
        return world, obs_dict, traj, metrics

    # ------------------------------------------------------------------
    def ppo_loss(self, obs_h, priv, actions, old_logp, old_mu, old_std,
                 target_v, adv, ret):
        """Clipped surrogate + value + entropy (ppo.py:95-160); returns
        (loss, surrogate, value loss, kl)."""
        args, model = self.args, self.ac
        latent = model.adaptation_module(obs_h)
        mean = model.actor_mean(obs_h, latent)
        std = model.std.expand_as(mean)
        logp = ac.log_prob(mean, std, actions)
        value = model.evaluate(obs_h, priv)
        ratio = torch.exp(logp - old_logp)
        surr = torch.maximum(
            -adv * ratio,
            -adv * torch.clamp(ratio, 1 - args.clip_param,
                               1 + args.clip_param)).mean()
        if args.use_clipped_value_loss:
            v_clipped = target_v + torch.clamp(value - target_v,
                                               -args.clip_param,
                                               args.clip_param)
            v_loss = torch.maximum((value - ret) ** 2,
                                   (v_clipped - ret) ** 2).mean()
        else:
            v_loss = ((ret - value) ** 2).mean()
        loss = (surr + args.value_loss_coef * v_loss
                - args.entropy_coef * ac.entropy(std).mean())
        with torch.no_grad():      # KL for the adaptive LR (ppo.py:118-124)
            kl = torch.sum(
                torch.log(std / old_std + 1e-5)
                + (old_std ** 2 + (old_mu - mean) ** 2) / (2 * std ** 2)
                - 0.5, dim=-1).mean()
        return loss, surr, v_loss, kl

    def adaptation_loss(self, obs_h, priv):
        """80/20 train/test regression of the adaptation module
        (ppo.py:163-183)."""
        pred = self.ac.adaptation_module(obs_h)
        B = pred.shape[0]
        n_train = max(1, (B // 5) * 4)
        train = torch.mean((pred[:n_train] - priv[:n_train]) ** 2)
        test = (torch.mean((pred[n_train:] - priv[n_train:]) ** 2)
                if n_train < B else train)
        return train, test

    def minibatch_step(self, batch) -> Tuple[torch.Tensor, ...]:
        """One PPO step then the adaptation substep(s) on one minibatch."""
        args, model = self.args, self.ac
        obs_h, priv, actions, logp, mu, values, adv, ret, old_std = batch
        self.opt.zero_grad(set_to_none=True)
        loss, surr, v_loss, kl = self.ppo_loss(obs_h, priv, actions, logp, mu,
                                               old_std, values, adv, ret)
        loss.backward()
        # adaptive-KL learning rate (ppo.py:126-132), set before the step
        if args.desired_kl is not None and args.schedule == "adaptive":
            k = float(kl)
            if k > args.desired_kl * 2.0:
                self.lr = max(1e-5, self.lr / 1.5)
            elif 0.0 < k < args.desired_kl / 2.0:
                self.lr = min(1e-2, self.lr * 1.5)
        for group in self.opt.param_groups:
            group["lr"] = self.lr
        clip_by_global_norm_(list(model.parameters()), args.max_grad_norm)
        self.opt.step()
        if args.std_range is not None:
            with torch.no_grad():
                model.std.clamp_(args.std_range[0], args.std_range[1])
        a_losses = []
        for _ in range(args.num_adaptation_module_substeps):
            self.adapt_opt.zero_grad(set_to_none=True)
            a_loss, a_test = self.adaptation_loss(obs_h, priv)
            a_loss.backward()
            self.adapt_opt.step()
            a_losses.append((a_loss.detach(), a_test.detach()))
        n = len(a_losses)
        return (loss.detach(), surr.detach(), v_loss.detach(), kl,
                sum(l for l, _ in a_losses) / n,
                sum(t for _, t in a_losses) / n)

    def update(self, traj: Rollout, last_obs_dict,
               perm: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """GAE + num_learning_epochs x num_mini_batches minibatch steps over
        one permutation of the T*N samples, reused across epochs
        (rollout_storage.py:100-139). `perm` overrides the drawn one."""
        args, model = self.args, self.ac
        T, N = traj.rewards.shape
        with torch.no_grad():
            last_values = model.evaluate(last_obs_dict["obs_history"][:N],
                                         last_obs_dict["privileged_obs"][:N])
        advs, returns = compute_gae(traj.rewards, traj.dones, traj.values,
                                    last_values, args.gamma, args.lam)
        old_std = model.std.detach().clone()
        if perm is None:
            perm = torch.randperm(T * N, generator=self.gen,
                                  device=traj.rewards.device)
        flat = lambda x: x.reshape((T * N,) + x.shape[2:])[perm]
        obs_h, priv, actions, mu = (flat(traj.obs_history),
                                    flat(traj.privileged_obs),
                                    flat(traj.actions), flat(traj.mu))
        logp, values, adv, ret = (flat(traj.log_probs), flat(traj.values),
                                  flat(advs), flat(returns))
        mb = T * N // args.num_mini_batches
        rows = []
        for _ in range(args.num_learning_epochs):
            for m in range(args.num_mini_batches):
                sl = slice(m * mb, (m + 1) * mb)
                rows.append(torch.stack(self.minibatch_step(
                    (obs_h[sl], priv[sl], actions[sl], logp[sl], mu[sl],
                     values[sl], adv[sl], ret[sl], old_std))))
        means = torch.stack(rows).mean(0)
        self.iteration += 1
        keys = ("loss", "surrogate_loss", "value_loss", "kl_mean",
                "adaptation_loss", "adaptation_test_loss")
        stats = dict(zip(keys, means.unbind()))
        stats["lr"] = self.lr
        return stats

    def train_iteration(self, world, obs_dict):
        """Rollout + update; returns (world, obs_dict, stats)."""
        world, obs_dict, traj, metrics = self.rollout(world, obs_dict)
        stats = self.update(traj, obs_dict)
        stats.update(metrics)
        return world, obs_dict, stats
