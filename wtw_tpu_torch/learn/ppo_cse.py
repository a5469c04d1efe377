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

Options of the JAX learner: `ACArgs.compute_dtype="bfloat16"` stores the
rollout's observation history in bf16; `fused_adaptation_substep` takes
the adaptation gradient from the PPO pass's own forward, at the pre-step
parameters; `sharding_invariant` draws the action noise per env (at the
group's global width, this rank's rows), cuts env-strided minibatches (env
n to minibatch n % M) and splits the adaptation regression 80/20 on
timestep boundaries, so an env-sharded run trains exactly as the unsharded
one: here to the bit, as the JAX learner does up to float32 reassociation
(each product on one env block's rows, each sum over envs a fixed tree over
the blocks: `parallel.mesh`). With a process `group`, gradients, the KL,
the statistics and the advantage moments are reduced over the group and
the episode counts summed, where the JAX learner pmeans and psums them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..models import actor_critic as ac
from ..parallel.mesh import (all_mean, all_mean_grads_, all_sum, draw_rows,
                             invariant_blocks, invariant_grads, invariant_sum)
from ..utils import spans


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
    # per-env action noise, env-strided minibatches and a timestep-aligned
    # adaptation split: an env-sharded run trains as the unsharded one
    # (default off: one random permutation over T*N, the reference's)
    sharding_invariant: bool = False
    # clamp of the learned policy std after each update (the JAX package's
    # stabilizer, not in the reference)
    std_range: Optional[tuple] = (0.05, 2.0)
    # the adaptation substep's gradient from the PPO pass's forward, at the
    # pre-step parameters, applied to the post-step ones by the separate
    # Adam (needs num_adaptation_module_substeps == 1; default off, the
    # reference's interleaving)
    fused_adaptation_substep: bool = False


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


@spans.spanned("learner.gae")
def compute_gae(rewards, dones, values, last_values, gamma, lam,
                group=None, blocks=None):
    """rollout_storage.py:76-90; rewards/dones/values (T, N) -> normalized
    advantages and returns. The advantage moments are the group's (the
    global batch's under env sharding); with env `blocks` (sharding
    invariance) they are block trees (`parallel.mesh.invariant_sum`)."""
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
    if blocks is not None:
        n = advs.numel() * (1 if group is None else group.size())
        mean = invariant_sum([advs[:, b].contiguous().sum() for b in blocks],
                             group) / n
        var = invariant_sum([((advs[:, b] - mean) ** 2).contiguous().sum()
                             for b in blocks], group) / n
        return (advs - mean) / (torch.sqrt(var) + 1e-8), returns
    mean = all_mean(advs.mean(), group)
    var = all_mean(((advs - mean) ** 2).mean(), group)
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
                 ac_args: ac.ACArgs = ac.ACArgs(), seed: int = 0,
                 group=None):
        """group: a process group of env-sharded data parallelism
        (`parallel.mesh`), or None."""
        self.env, self.args, self.group = env, args, group
        self.ac_args = ac_args
        self.history_dtype = (torch.bfloat16
                              if ac_args.compute_dtype == "bfloat16"
                              else torch.float32)
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
    def _action_noise(self, mean):
        """Per-env standard normal draws under sharding_invariant (the
        group's global width, this rank's rows)."""
        draw = lambda shape: torch.randn(shape, generator=self.gen,
                                         device=mean.device)
        return draw_rows(draw, mean.shape, self.group)

    @spans.spanned("learner.rollout", opens_record=True)
    @torch.no_grad()
    def rollout(self, world, obs_dict, noise: Optional[torch.Tensor] = None):
        """`num_steps_per_env` env steps; `noise` (T, N, A) replaces the
        drawn action noise. -> (world, obs_dict, Rollout, metrics)."""
        env, args, model = self.env, self.args, self.ac
        T, n_tr = args.num_steps_per_env, env.num_train_envs
        steps = []
        ep_sums = n_resets = ep_sums_ev = n_resets_ev = 0
        rew_sum = 0.0
        for t in range(T):
            obs_h = obs_dict["obs_history"]
            priv = obs_dict["privileged_obs"]
            with spans.span("learner.act"):
                if args.sharding_invariant:
                    blocks = invariant_blocks(obs_h.shape[0], self.group)
                    mean = torch.cat([model.distribution(obs_h[b])[0]
                                      for b in blocks])
                    std = model.std.expand_as(mean)
                else:
                    mean, std = model.distribution(obs_h)
                if noise is not None:
                    actions = mean + std * noise[t]
                elif args.sharding_invariant:
                    actions = mean + std * self._action_noise(mean)
                else:
                    actions = ac.sample_actions(mean, std, self.gen)
                logp = ac.log_prob(mean, std, actions)
                values = (torch.cat([model.evaluate(obs_h[b], priv[b])
                                     for b in blocks])
                          if args.sharding_invariant
                          else model.evaluate(obs_h, priv))
                # train/eval split (ppo_cse/__init__.py:136-146): the
                # trailing eval envs act with the sampled student, or with
                # the teacher under eval_expert; only the train envs enter
                # the batch
                exec_actions = actions
                if args.eval_expert and n_tr < actions.shape[0]:
                    t_mean = model.actor_mean(obs_h[n_tr:], priv[n_tr:])
                    exec_actions = torch.cat([
                        actions[:n_tr],
                        ac.sample_actions(t_mean, std[n_tr:], self.gen)])
            world, next_obs, rew, done, info = env.step(world, exec_actions)
            # timeout bootstrapping (ppo.py:84-86)
            rew_b = rew + args.gamma * values * info["time_outs"]
            # under bf16 compute the history is stored in bf16, as the
            # products read it (ppo_cse.py:217-226 of the JAX package)
            steps.append((obs_h[:n_tr].to(self.history_dtype), priv[:n_tr],
                          actions[:n_tr],
                          rew_b[:n_tr], done[:n_tr], values[:n_tr],
                          logp[:n_tr], mean[:n_tr]))
            ep_sums = ep_sums + info["episode_sums_at_reset"]
            n_resets = n_resets + info["num_resets"]
            ep_sums_ev = ep_sums_ev + info["eval_episode_sums_at_reset"]
            n_resets_ev = n_resets_ev + info["eval_num_resets"]
            rew_sum = rew_sum + rew[:n_tr].mean()
            obs_dict = next_obs
        traj = Rollout(*[torch.stack(x) for x in zip(*steps)])
        g = self.group
        n_resets, n_resets_ev = all_sum(n_resets, g), all_sum(n_resets_ev, g)
        metrics = {
            "episode_reward_sums": all_sum(ep_sums, g)
            / torch.clamp(n_resets, min=1),
            "num_episodes": n_resets,
            "eval_episode_reward_sums": all_sum(ep_sums_ev, g)
            / torch.clamp(n_resets_ev, min=1),
            "eval_num_episodes": n_resets_ev,
            "mean_step_reward": all_mean(rew_sum / T, g),
            "mean_episode_length": all_mean(info["mean_episode_length"], g),
        }
        return world, obs_dict, traj, metrics

    # ------------------------------------------------------------------
    def ppo_loss(self, obs_h, priv, actions, old_logp, old_mu, old_std,
                 target_v, adv, ret):
        """Clipped surrogate + value + entropy (ppo.py:95-160); returns
        (loss, surrogate, value loss, kl)."""
        latent = self.ac.adaptation_module(obs_h)
        return self.ppo_terms(obs_h, priv, actions, old_logp, old_mu,
                              old_std, target_v, adv, ret, latent)

    def ppo_terms(self, obs_h, priv, actions, old_logp, old_mu, old_std,
                  target_v, adv, ret, latent):
        """`ppo_loss` given the adaptation latent."""
        args = self.args
        surr, v_loss, kl, std = self.ppo_rows(obs_h, priv, actions, old_logp,
                                              old_mu, old_std, target_v, adv,
                                              ret, latent)
        surr, v_loss = surr.mean(), v_loss.mean()
        loss = (surr + args.value_loss_coef * v_loss
                - args.entropy_coef * ac.entropy(std).mean())
        return loss, surr, v_loss, kl.mean()

    def ppo_rows(self, obs_h, priv, actions, old_logp, old_mu, old_std,
                 target_v, adv, ret, latent):
        """Per-sample clipped surrogate, value loss and KL (the KL without a
        gradient), and the expanded std."""
        args, model = self.args, self.ac
        mean = model.actor_mean(obs_h, latent)
        std = model.std.expand_as(mean)
        logp = ac.log_prob(mean, std, actions)
        value = model.evaluate(obs_h, priv)
        ratio = torch.exp(logp - old_logp)
        surr = torch.maximum(
            -adv * ratio,
            -adv * torch.clamp(ratio, 1 - args.clip_param,
                               1 + args.clip_param))
        if args.use_clipped_value_loss:
            v_clipped = target_v + torch.clamp(value - target_v,
                                               -args.clip_param,
                                               args.clip_param)
            v_loss = torch.maximum((value - ret) ** 2,
                                   (v_clipped - ret) ** 2)
        else:
            v_loss = (ret - value) ** 2
        with torch.no_grad():      # KL for the adaptive LR (ppo.py:118-124)
            kl = torch.sum(
                torch.log(std / old_std + 1e-5)
                + (old_std ** 2 + (old_mu - mean) ** 2) / (2 * std ** 2)
                - 0.5, dim=-1)
        return surr, v_loss, kl, std

    def adaptation_loss(self, obs_h, priv):
        """80/20 train/test regression of the adaptation module
        (ppo.py:163-183)."""
        return self.split_losses(self.ac.adaptation_module(obs_h), priv)

    @staticmethod
    def split_losses(pred, priv):
        B = pred.shape[0]
        n_train = max(1, (B // 5) * 4)
        train = torch.mean((pred[:n_train] - priv[:n_train]) ** 2)
        test = (torch.mean((pred[n_train:] - priv[n_train:]) ** 2)
                if n_train < B else train)
        return train, test

    @spans.spanned("learner.minibatch")
    def minibatch_step(self, batch) -> Tuple[torch.Tensor, ...]:
        """One PPO step then the adaptation substep(s) on one minibatch."""
        args, model, g = self.args, self.ac, self.group
        obs_h, priv, actions, logp, mu, values, adv, ret, old_std = batch
        fused = (args.fused_adaptation_substep
                 and args.num_adaptation_module_substeps == 1)
        self.opt.zero_grad(set_to_none=True)
        ad_params = list(model.adaptation.parameters())
        if fused:
            # one adaptation forward for both losses; the regression's
            # gradient is taken at the pre-step parameters
            latent = model.adaptation_module(obs_h)
            loss, surr, v_loss, kl = self.ppo_terms(
                obs_h, priv, actions, logp, mu, old_std, values, adv, ret,
                latent)
            a_loss, a_test = self.split_losses(latent, priv)
            a_grads = torch.autograd.grad(a_loss, ad_params,
                                          retain_graph=True)
        else:
            loss, surr, v_loss, kl = self.ppo_loss(
                obs_h, priv, actions, logp, mu, old_std, values, adv, ret)
        loss.backward()
        all_mean_grads_(list(model.parameters()), g)
        kl = all_mean(kl, g)
        # adaptive-KL learning rate (ppo.py:126-132), set before the step
        if args.desired_kl is not None and args.schedule == "adaptive":
            k = spans.host_float(kl)
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
        if fused:
            self.adapt_opt.zero_grad(set_to_none=True)
            for p, ga in zip(ad_params, a_grads):
                p.grad = ga
            all_mean_grads_(ad_params, g)
            self.adapt_opt.step()
            a_losses = [(a_loss.detach(), a_test.detach())]
        else:
            a_losses = []
            for _ in range(args.num_adaptation_module_substeps):
                self.adapt_opt.zero_grad(set_to_none=True)
                a_loss, a_test = self.adaptation_loss(obs_h, priv)
                a_loss.backward()
                all_mean_grads_(ad_params, g)
                self.adapt_opt.step()
                a_losses.append((a_loss.detach(), a_test.detach()))
        n = len(a_losses)
        return (loss.detach(), surr.detach(), v_loss.detach(), kl,
                sum(l for l, _ in a_losses) / n,
                sum(t for _, t in a_losses) / n)

    @spans.spanned("learner.update")
    def update(self, traj: Rollout, last_obs_dict,
               perm: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """GAE + num_learning_epochs x num_mini_batches minibatch steps over
        one permutation of the T*N samples, reused across epochs
        (rollout_storage.py:100-139); `perm` overrides the drawn one. Under
        sharding_invariant (and no `perm`): `_invariant_update`."""
        args, model = self.args, self.ac
        T, N = traj.rewards.shape
        M = args.num_mini_batches
        if args.sharding_invariant and perm is None:
            return self._invariant_update(traj, last_obs_dict)
        with torch.no_grad():
            last_values = model.evaluate(last_obs_dict["obs_history"][:N],
                                         last_obs_dict["privileged_obs"][:N])
        advs, returns = compute_gae(traj.rewards, traj.dones, traj.values,
                                    last_values, args.gamma, args.lam,
                                    self.group)
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
        mb = T * N // M
        rows = []
        for _ in range(args.num_learning_epochs):
            for m in range(M):
                sl = slice(m * mb, (m + 1) * mb)
                rows.append(torch.stack(self.minibatch_step(
                    (obs_h[sl], priv[sl], actions[sl], logp[sl], mu[sl],
                     values[sl], adv[sl], ret[sl], old_std))))
        means = all_mean(torch.stack(rows).mean(0), self.group)
        self.iteration += 1
        keys = ("loss", "surrogate_loss", "value_loss", "kl_mean",
                "adaptation_loss", "adaptation_test_loss")
        stats = dict(zip(keys, means.unbind()))
        stats["lr"] = self.lr
        return stats

    # ------------------------------------------------------------------
    def _invariant_update(self, traj: Rollout, last_obs_dict):
        """`update` under sharding_invariant, block by block: minibatch m
        holds the envs n with n % M == m, each block's rows in timestep
        order, the first 4/5 of the timesteps the adaptation regression's
        train rows; each loss is a sum over a block's rows divided by the
        global count, its gradient taken per block and summed as a tree
        (`parallel.mesh.invariant_grads`), the entropy term's (the same for
        every row) added once."""
        args, model, g = self.args, self.ac, self.group
        T, N = traj.rewards.shape
        M, W = args.num_mini_batches, 1 if g is None else g.size()
        if N % M:
            raise ValueError(f"sharding_invariant: {N} envs a shard do not "
                             f"divide into {M} minibatches")
        blocks = invariant_blocks(N, g)
        with torch.no_grad():
            oh_l, pr_l = (last_obs_dict["obs_history"][:N],
                          last_obs_dict["privileged_obs"][:N])
            last_values = torch.cat([model.evaluate(oh_l[b], pr_l[b])
                                     for b in blocks])
        advs, returns = compute_gae(traj.rewards, traj.dones, traj.values,
                                    last_values, args.gamma, args.lam, g,
                                    blocks)
        old_std = model.std.detach().clone()
        flat = lambda x: x.reshape((T * N,) + x.shape[2:])
        data = [flat(x) for x in (traj.obs_history, traj.privileged_obs,
                                  traj.actions, traj.log_probs, traj.mu,
                                  traj.values, advs, returns)]
        dev = traj.rewards.device
        t4 = T * 4 // 5
        cnt = T * N * W // M                      # rows of a minibatch
        n_train, n_test = t4 * N * W // M, (T - t4) * N * W // M
        rows = {}
        for m in range(M):
            for i, b in enumerate(blocks):
                envs = torch.arange(b.start, b.stop, device=dev)
                envs = envs[envs % M == m]
                rows[m, i] = (torch.arange(T, device=dev)[:, None] * N
                              + envs[None]).reshape(-1)
        params = list(model.parameters())
        ad = list(model.adaptation.parameters())
        fused = (args.fused_adaptation_substep
                 and args.num_adaptation_module_substeps == 1)
        out = []
        for _ in range(args.num_learning_epochs):
            for m in range(M):
                batches = [[x[rows[m, i]] for x in data]
                           for i in range(len(blocks))]
                out.append(self._invariant_step(
                    batches, old_std, cnt, n_train, n_test, params, ad,
                    fused))
        means = torch.stack(out).mean(0)
        self.iteration += 1
        keys = ("loss", "surrogate_loss", "value_loss", "kl_mean",
                "adaptation_loss", "adaptation_test_loss")
        stats = dict(zip(keys, means.unbind()))
        stats["lr"] = self.lr
        return stats

    @spans.spanned("learner.minibatch")
    def _invariant_step(self, batches, old_std, cnt, n_train, n_test,
                        params, ad, fused):
        """One minibatch of `_invariant_update`: the PPO step, then the
        adaptation substep(s); -> the row of `update`'s statistics."""
        args, model, g = self.args, self.ac, self.group
        n_ad = len(ad)

        def adapt_sums(pred, priv):
            """(train, test) sums of squares of one block (its first 4/5
            of the timesteps train)."""
            d2 = (pred - priv) ** 2
            k = d2.shape[0] * n_train // (n_train + n_test)
            return d2[:k].sum(), d2[k:].sum()

        P = batches[0][1].shape[-1]

        def adapt_loss(tr, te):
            tr, te = tr / (n_train * P), te / (max(n_test, 1) * P)
            return tr, (te if n_test else tr)

        grads, a_grads, aux = [], [], []
        for oh, priv, act, logp0, mu, v0, adv, ret in batches:
            latent = model.adaptation_module(oh)
            surr, vl, kl, _ = self.ppo_rows(oh, priv, act, logp0, mu,
                                            old_std, v0, adv, ret, latent)
            surr, vl, kl = surr.sum(), vl.sum(), kl.sum()
            extra = []
            if fused:
                tr, te = adapt_sums(latent, priv)
                extra = [tr.detach(), te.detach()]
                a_grads.append(torch.autograd.grad(
                    tr / (n_train * P), ad, retain_graph=True))
            grads.append(torch.autograd.grad(
                (surr + args.value_loss_coef * vl) / cnt, params,
                allow_unused=True))
            aux.append(torch.stack([surr.detach(), vl.detach(), kl] + extra))
        tot = invariant_sum(aux, g)
        surr, vl, kl = tot[0] / cnt, tot[1] / cnt, tot[2] / cnt
        ent = ac.entropy(model.std)
        (g_ent,) = torch.autograd.grad(-args.entropy_coef * ent, model.std)
        grads = invariant_grads(grads, g)
        std_i = next(i for i, p in enumerate(params) if p is model.std)
        grads[std_i] = grads[std_i] + g_ent
        # adaptive-KL learning rate (ppo.py:126-132), set before the step
        if args.desired_kl is not None and args.schedule == "adaptive":
            k = spans.host_float(kl)
            if k > args.desired_kl * 2.0:
                self.lr = max(1e-5, self.lr / 1.5)
            elif 0.0 < k < args.desired_kl / 2.0:
                self.lr = min(1e-2, self.lr * 1.5)
        for group in self.opt.param_groups:
            group["lr"] = self.lr
        self.opt.zero_grad(set_to_none=True)
        for p, gr in zip(params, grads):
            p.grad = gr
        clip_by_global_norm_(params, args.max_grad_norm)
        self.opt.step()
        if args.std_range is not None:
            with torch.no_grad():
                model.std.clamp_(args.std_range[0], args.std_range[1])
        loss = surr + args.value_loss_coef * vl - args.entropy_coef * ent
        if fused:
            steps = [(invariant_grads(a_grads, g), tot[3], tot[4])]
        else:
            steps = []
        for _ in range(0 if fused else args.num_adaptation_module_substeps):
            per, sums = [], []
            for oh, priv, *_ in batches:
                tr, te = adapt_sums(model.adaptation_module(oh), priv)
                per.append(torch.autograd.grad(tr / (n_train * P), ad))
                sums.append(torch.stack([tr.detach(), te.detach()]))
            s_tot = invariant_sum(sums, g)
            steps.append((invariant_grads(per, g), s_tot[0], s_tot[1]))
            self._adapt_step(ad, steps[-1][0])
        if fused:
            self._adapt_step(ad, steps[0][0])
        a = [adapt_loss(tr, te) for _, tr, te in steps]
        return torch.stack([loss.detach(), surr, vl, kl,
                            sum(x for x, _ in a) / len(a),
                            sum(y for _, y in a) / len(a)])

    def _adapt_step(self, ad, grads):
        self.adapt_opt.zero_grad(set_to_none=True)
        for p, gr in zip(ad, grads):
            p.grad = gr
        self.adapt_opt.step()

    def train_iteration(self, world, obs_dict, noise=None, perm=None):
        """Rollout + update; returns (world, obs_dict, stats). `noise` (T,
        N, A) and `perm` replace the drawn action noise and permutation."""
        world, obs_dict, traj, metrics = self.rollout(world, obs_dict, noise)
        stats = self.update(traj, obs_dict, perm)
        stats.update(metrics)
        return world, obs_dict, stats
