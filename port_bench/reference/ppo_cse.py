"""Plain reference of `train --algo ppo_cse` (PPO with concurrent state
estimation; walk-these-ways go1_gym_learn/ppo_cse/{ppo.py,
rollout_storage.py}): the rollout's forwards on the env's observations,
GAE with timeout bootstrapping, then epochs x minibatches of the clipped
surrogate with the adaptive-KL learning rate, each followed by the
adaptation module's regression substep."""
from __future__ import annotations

import math

import torch

from .common import Adam, clip_global, dev, leaves, tower


def _policy(p, oh):
    latent = tower(p, "adaptation", oh)
    return tower(p, "actor", torch.cat([oh, latent], -1))


def _value(p, oh, priv):
    return tower(p, "critic", torch.cat([oh, priv], -1))[..., 0]


def _log_prob(mean, std, a):
    var = std ** 2
    return (-0.5 * ((a - mean) ** 2 / var
                    + torch.log(2 * math.pi * var))).sum(-1)


def run(cell, weights, start, steps, draws, device):
    """Follows the program's env steps (`steps`, `start`) through
    len(draws) iterations from `weights`. -> losses, the first step's
    gradient per leaf, the leaves after the last iteration, the rollout's
    actions."""
    h = cell["cfg"]["learner"]
    p = leaves(weights, device)
    names = list(p)
    ad_names = [n for n in names if n.startswith("adaptation.")]
    opt = Adam([p[n] for n in names], eps=1e-8)
    ad_opt = Adam([p[n] for n in ad_names], eps=1e-8)
    lr = h["learning_rate"]
    oh = dev(start["obs_history"], device)
    priv = dev(start["privileged_obs"], device)
    losses, actions, grad1, lrs = [], [], None, []
    T = len(steps) // len(draws)
    for k, dr in enumerate(draws):
        noise, perm = dev(dr["noise"], device), dev(dr["perm"], device)
        buf = []
        with torch.no_grad():
            for t in range(T):
                s = steps[k * T + t]
                mean = _policy(p, oh)
                std = p["std"].expand_as(mean)
                a = mean + std * noise[t]
                val = _value(p, oh, priv)
                rew = dev(s["rew"], device) + h["gamma"] * val * dev(
                    s["time_outs"], device).float()
                buf.append((oh, priv, a, _log_prob(mean, std, a), mean, val,
                            rew, dev(s["done"], device).float()))
                actions.append(a)
                oh = dev(s["obs_history"], device)
                priv = dev(s["privileged_obs"], device)
            last_v = _value(p, oh, priv)
        B_oh, B_pr, B_a, B_lp, B_mu, B_v, B_r, B_d = [
            torch.stack(x) for x in zip(*buf)]
        adv = torch.empty_like(B_r)
        nxt_a, nxt_v = torch.zeros_like(last_v), last_v
        for t in range(T - 1, -1, -1):
            nd = 1.0 - B_d[t]
            delta = B_r[t] + nd * h["gamma"] * nxt_v - B_v[t]
            nxt_a = delta + nd * h["gamma"] * h["lam"] * nxt_a
            adv[t] = nxt_a
            nxt_v = B_v[t]
        ret = adv + B_v
        mu_a = adv.mean()
        adv = (adv - mu_a) / (torch.sqrt(((adv - mu_a) ** 2).mean()) + 1e-8)
        old_std = p["std"].detach().clone()
        flat = lambda x: x.reshape((-1,) + x.shape[2:])[perm]
        F_oh, F_pr, F_a, F_lp, F_mu, F_v, F_adv, F_ret = [
            flat(x) for x in (B_oh, B_pr, B_a, B_lp, B_mu, B_v, adv, ret)]
        n = F_oh.shape[0]
        M = h["num_mini_batches"]
        mb = n // M
        it_losses = []
        for _ in range(h["num_learning_epochs"]):
            for m in range(M):
                sl = slice(m * mb, (m + 1) * mb)
                o, pr = F_oh[sl], F_pr[sl]
                mean = _policy(p, o)
                std = p["std"].expand_as(mean)
                ratio = torch.exp(_log_prob(mean, std, F_a[sl]) - F_lp[sl])
                A = F_adv[sl]
                surr = torch.maximum(-A * ratio, -A * torch.clamp(
                    ratio, 1 - h["clip_param"], 1 + h["clip_param"])).mean()
                v = _value(p, o, pr)
                tv, R = F_v[sl], F_ret[sl]
                v_cl = tv + torch.clamp(v - tv, -h["clip_param"],
                                        h["clip_param"])
                v_loss = torch.maximum((v - R) ** 2, (v_cl - R) ** 2).mean()
                ent = (0.5 * torch.log(2 * math.pi * math.e * std ** 2)
                       ).sum(-1).mean()
                loss = (surr + h["value_loss_coef"] * v_loss
                        - h["entropy_coef"] * ent)
                grads = torch.autograd.grad(loss, [p[x] for x in names])
                with torch.no_grad():
                    kl = torch.sum(
                        torch.log(std / old_std + 1e-5)
                        + (old_std ** 2 + (F_mu[sl] - mean) ** 2)
                        / (2 * std ** 2) - 0.5, dim=-1).mean()
                kv = float(kl)
                if kv > h["desired_kl"] * 2.0:
                    lr = max(1e-5, lr / 1.5)
                elif 0.0 < kv < h["desired_kl"] / 2.0:
                    lr = min(1e-2, lr * 1.5)
                grads = clip_global(grads, h["max_grad_norm"])
                if grad1 is None:
                    grad1 = {x: g.detach().cpu() for x, g in zip(names, grads)}
                opt.step(grads, lr)
                with torch.no_grad():
                    p["std"].clamp_(*h["std_range"])
                pred = tower(p, "adaptation", o)
                k4 = max(1, (pred.shape[0] // 5) * 4)
                a_loss = torch.mean((pred[:k4] - pr[:k4]) ** 2)
                ad_opt.step(torch.autograd.grad(
                    a_loss, [p[x] for x in ad_names]),
                    h["adaptation_module_learning_rate"])
                it_losses.append(loss.detach())
        losses.append(float(torch.stack(it_losses).mean()))
        lrs.append(lr)
    return {"losses": losses, "grad1": grad1,
            "params": {x: p[x].detach().cpu() for x in names},
            "actions": actions, "lrs": lrs}
