"""Plain reference of `train_parkour --algo ppo` (CaT PPO; Chane-Sane et
al. 2024, the CleanRL-style algos/PPO.py): running mean/std normalizers of
the observation and of the value, the float-done GAE of
Constraints-as-Terminations, a linear learning-rate anneal, and epochs of
the clipped surrogate and clipped value loss over a fresh permutation
each."""
from __future__ import annotations

import math

import torch

from .common import Adam, clip_global, dev, leaves, tower


class RMS:
    """Running mean and variance (algos/PPO.py:20-62), folded a batch at a
    time along its first axis."""

    def __init__(self, shape, device):
        self.mean = torch.zeros(shape, device=device)
        self.var = torch.ones(shape, device=device)
        self.count = torch.ones((), device=device)

    def fold(self, x):
        bm, ex2 = x.mean(0), (x * x).mean(0)
        bv, bc = ex2 - bm * bm, x.shape[0]
        delta = bm - self.mean
        tot = self.count + bc
        m2 = self.var * self.count + bv * bc + delta * delta * self.count \
            * bc / tot
        self.mean, self.var, self.count = (self.mean + delta * bc / tot,
                                           m2 / tot, tot)

    def norm(self, x):
        return (x - self.mean) / torch.sqrt(self.var + 1e-8)


def log_prob(logstd, mean, a):
    return (-0.5 * ((a - mean) / torch.exp(logstd)) ** 2 - logstd
            - 0.5 * math.log(2 * math.pi)).sum(-1)


def entropy(logstd):
    return (logstd + 0.5 * math.log(2 * math.pi * math.e)).sum()


def cat_gae(rew, dones, true_dones, values, next_v, next_d, next_td, gamma,
            lam):
    """Rewards scaled by 1 - done probability; the bootstrap carries
    (1 - next done probability) (1 - next hard done)."""
    rew = rew * (1.0 - dones)
    nd = torch.cat([dones[1:], next_d[None]])
    ntd = torch.cat([true_dones[1:], next_td[None]])
    nv = torch.cat([values[1:], next_v[None]])
    adv = torch.empty_like(rew)
    last = torch.zeros_like(next_v)
    for t in range(rew.shape[0] - 1, -1, -1):
        keep = (1.0 - nd[t]) * (1.0 - ntd[t])
        last = rew[t] + gamma * nv[t] * keep - values[t] \
            + gamma * lam * keep * last
        adv[t] = last
    return adv, adv + values


def clipped_loss(h, logstd, logp, old_logp, adv, v_n, ret_n, val_n):
    """Advantages normalized over the minibatch (population std), the
    clipped surrogate, the clipped value loss on normalized values, the
    entropy bonus."""
    m = adv.mean()
    adv = (adv - m) / (torch.sqrt(((adv - m) ** 2).mean()) + 1e-8)
    ratio = torch.exp(logp - old_logp)
    c = h["clip_coef"]
    pg = torch.maximum(-adv * ratio,
                       -adv * torch.clamp(ratio, 1 - c, 1 + c)).mean()
    v_cl = val_n + torch.clamp(v_n - val_n, -c, c)
    vl = 0.5 * torch.maximum((v_n - ret_n) ** 2, (v_cl - ret_n) ** 2).mean()
    return pg - h["ent_coef"] * entropy(logstd) + h["vf_coef"] * vl


def branches(h, logp, v_n, old_logp, adv, ret_n, val_n):
    """Each sample's side of `clipped_loss`'s two maxima (is the clipped
    term taken, for the surrogate and for the value) and its distance
    from the nearest switch."""
    m = adv.mean()
    adv = (adv - m) / (torch.sqrt(((adv - m) ** 2).mean()) + 1e-8)
    ratio = torch.exp(logp - old_logp)
    c = h["clip_coef"]
    edge = torch.where(adv > 0, 1.0 + c, 1.0 - c)
    pg = torch.where(adv > 0, ratio > edge, ratio < edge)
    d = v_n - val_n
    u = (v_n - ret_n) ** 2
    w = (val_n + torch.clamp(d, -c, c) - ret_n) ** 2
    v = (d.abs() > c) & (w > u)
    near_v = torch.where(d.abs() > c,
                         torch.minimum(d.abs() - c, (w - u).abs()),
                         c - d.abs())
    return (torch.cat([pg.flatten(), v.flatten()]),
            torch.cat([(ratio - edge).abs().flatten(), near_v.flatten()]))


class Follow:
    """The look at a swinging number (`calibrate.py --follow`), step by
    optimizer step: the samples whose clipped branch differs between the
    reference's parameters and the program's before the step, the
    reference's samples within 1e-5 of a switch, and after the step the
    worst leaf's gap to the program's parameters (|diff| over the larger
    of the leaf's norm and the median leaf's)."""

    def __init__(self, h, weights, trail, device):
        self.h, self.device = h, device
        self.before, self.trail, self.rows = weights, trail, []

    def before_step(self, forward, p, old_logp, adv, ret_n, val_n):
        q = {k: v.to(self.device) for k, v in self.before.items()}
        with torch.no_grad():
            bp, near = branches(self.h, *forward(p), old_logp, adv, ret_n,
                                val_n)
            bq, _ = branches(self.h, *forward(q), old_logp, adv, ret_n,
                             val_n)
        self.rows.append({"flips": int((bp != bq).sum()),
                          "near": int((near < 1e-5).sum())})

    def after_step(self, p):
        q = self.trail[len(self.rows) - 1]
        self.before = q
        norm = {k: float(torch.linalg.vector_norm(v.double()))
                for k, v in q.items()}
        med = sorted(norm.values())[len(norm) // 2]
        self.rows[-1]["gap"] = max(
            float(torch.linalg.vector_norm(p[k].detach().cpu().double()
                                           - q[k].double()))
            / max(norm[k], med, 1e-30) for k in q)


def lr_at(h, iteration):
    frac = min(max(1.0 - iteration / h["num_iterations"], 0.0), 1.0)
    return frac * h["learning_rate"]


def step(h, p, names, opt, loss, grad1):
    grads = clip_global(torch.autograd.grad(loss, [p[x] for x in names]),
                        h["max_grad_norm"])
    if grad1 is None:
        grad1 = {x: g.detach().cpu() for x, g in zip(names, grads)}
    return grads, grad1


def run(cell, weights, start, steps, draws, device, follow=None):
    """`follow`: the program's parameters after each optimizer step (see
    `Follow`); its rows come back under "trail"."""
    h = {**cell["cfg"]["learner"], **cell["cfg"]}
    p = leaves(weights, device)
    names = list(p)
    look = Follow(h, weights, follow, device) if follow else None
    opt = Adam([p[x] for x in names], eps=1e-5)
    obs_rms, val_rms = RMS(h["num_observations"], device), RMS((), device)
    raw = dev(start["obs"], device)
    obs_rms.fold(raw)
    obs_n = obs_rms.norm(raw)
    N = raw.shape[0]
    done = torch.zeros(N, device=device)
    tdone = torch.zeros(N, device=device)
    T = len(steps) // len(draws)
    losses, actions, grad1 = [], [], None
    for k, dr in enumerate(draws):
        noise, perms = dev(dr["noise"], device), dev(dr["perms"], device)
        buf = []
        with torch.no_grad():
            for t in range(T):
                s = steps[k * T + t]
                mean = tower(p, "actor_mean", obs_n)
                a = mean + torch.exp(p["actor_logstd"]) * noise[t]
                val = tower(p, "critic", obs_n)[..., 0]
                buf.append((obs_n, a, log_prob(p["actor_logstd"], mean, a),
                            dev(s["rew"], device), done, tdone, val))
                actions.append(a)
                raw = dev(s["obs"], device)
                obs_rms.fold(raw)
                obs_n = obs_rms.norm(raw)
                done = dev(s["done"], device)
                tdone = dev(s["true_dones"], device).float()
            next_v = tower(p, "critic", obs_n)[..., 0]
        B_o, B_a, B_lp, B_r, B_d, B_td, B_v = [torch.stack(x)
                                               for x in zip(*buf)]
        adv, ret = cat_gae(B_r, B_d, B_td, B_v, next_v, done, tdone,
                           h["gamma"], h["gae_lambda"])
        flat = lambda x: x.reshape((-1,) + x.shape[2:])
        b_v, b_ret = flat(B_v), flat(ret)
        val_rms.fold(b_v)
        val_rms.fold(b_ret)
        b_vn, b_rn = val_rms.norm(b_v), val_rms.norm(b_ret)
        b_o, b_a, b_lp, b_adv = flat(B_o), flat(B_a), flat(B_lp), flat(adv)
        lr = lr_at(h, k)
        M = h["num_minibatches"]
        mb = b_o.shape[0] // M
        it_losses = []
        for ep in range(h["update_epochs"]):
            for idx in perms[ep][:mb * M].reshape(M, mb):
                def forward(q, o=b_o[idx], a=b_a[idx]):
                    logp = log_prob(q["actor_logstd"],
                                    tower(q, "actor_mean", o), a)
                    return logp, val_rms.norm(tower(q, "critic", o)[..., 0])
                logp, v_n = forward(p)
                if look:
                    look.before_step(forward, p, b_lp[idx], b_adv[idx],
                                     b_rn[idx], b_vn[idx])
                loss = clipped_loss(h, p["actor_logstd"], logp, b_lp[idx],
                                    b_adv[idx], v_n, b_rn[idx], b_vn[idx])
                grads, grad1 = step(h, p, names, opt, loss, grad1)
                opt.step(grads, lr)
                if look:
                    look.after_step(p)
                it_losses.append(loss.detach())
        losses.append(float(torch.stack(it_losses).mean()))
    return {"losses": losses, "grad1": grad1,
            "params": {x: p[x].detach().cpu() for x in names},
            "actions": actions, "trail": look.rows if look else None}
