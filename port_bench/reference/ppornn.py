"""Plain reference of `train_parkour --algo ppornn` (algos/PPORNN.py): CaT
PPO whose actor and critic each read a GRU memory (hidden 256) before the
observation; hiddens carried across iterations and zeroed after a hard
done; the update replays each minibatch's env sequences from the
iteration-start hiddens, zeroing them after step t with the hard-done flag
carried into step t."""
from __future__ import annotations

import torch

from .common import Adam, dev, leaves, tower
from .ppo import RMS, Follow, cat_gae, clipped_loss, log_prob, lr_at, step


def gru(p, name, x, h):
    """torch.nn.GRUCell's gates (r, z, n) written out."""
    gi = x @ p[f"{name}.weight_ih"].T + p[f"{name}.bias_ih"]
    gh = h @ p[f"{name}.weight_hh"].T + p[f"{name}.bias_hh"]
    i_r, i_z, i_n = gi.chunk(3, -1)
    h_r, h_z, h_n = gh.chunk(3, -1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h


def forward(p, obs, ah, ch):
    ah = gru(p, "actor_memory", obs, ah)
    ch = gru(p, "critic_memory", obs, ch)
    mean = tower(p, "actor_mean", torch.cat([ah, obs], -1))
    value = tower(p, "critic", torch.cat([ch, obs], -1))[..., 0]
    return mean, value, ah, ch


def run(cell, weights, start, steps, draws, device, follow=None):
    """`follow`: the program's parameters after each optimizer step (see
    `ppo.Follow`); its rows come back under "trail"."""
    h = {**cell["cfg"]["learner"], **cell["cfg"]}
    p = leaves(weights, device)
    names = list(p)
    look = Follow(h, weights, follow, device) if follow else None
    opt = Adam([p[x] for x in names], eps=1e-5)
    obs_rms, val_rms = RMS(h["num_observations"], device), RMS((), device)
    raw = dev(start["obs"], device)
    obs_rms.fold(raw)
    obs_n = obs_rms.norm(raw)
    N, H = raw.shape[0], h["rnn_hidden_dim"]
    done = torch.zeros(N, device=device)
    tdone = torch.zeros(N, device=device)
    ah = torch.zeros(N, H, device=device)
    ch = torch.zeros(N, H, device=device)
    T = len(steps) // len(draws)
    losses, actions, grad1 = [], [], None
    for k, dr in enumerate(draws):
        noise, perms = dev(dr["noise"], device), dev(dr["perms"], device)
        ah0, ch0 = ah, ch
        buf = []
        with torch.no_grad():
            for t in range(T):
                s = steps[k * T + t]
                mean, val, ah, ch = forward(p, obs_n, ah, ch)
                a = mean + torch.exp(p["actor_logstd"]) * noise[t]
                buf.append((obs_n, a, log_prob(p["actor_logstd"], mean, a),
                            dev(s["rew"], device), done, tdone, val))
                actions.append(a)
                raw = dev(s["obs"], device)
                obs_rms.fold(raw)
                obs_n = obs_rms.norm(raw)
                done = dev(s["done"], device)
                tdone = dev(s["true_dones"], device).float()
                keep = (1.0 - tdone)[:, None]
                ah, ch = ah * keep, ch * keep
            _, next_v, _, _ = forward(p, obs_n, ah, ch)
        B_o, B_a, B_lp, B_r, B_d, B_td, B_v = [torch.stack(x)
                                               for x in zip(*buf)]
        adv, ret = cat_gae(B_r, B_d, B_td, B_v, next_v, done, tdone,
                           h["gamma"], h["gae_lambda"])
        val_rms.fold(B_v.reshape(-1))
        val_rms.fold(ret.reshape(-1))
        vn, rn = val_rms.norm(B_v), val_rms.norm(ret)
        lr = lr_at(h, k)
        M = h["num_minibatches"]
        mb = max(N // M, 1)
        it_losses = []
        for ep in range(h["update_epochs"]):
            for idx in perms[ep][:mb * M].reshape(M, mb):
                def replay(q, idx=idx):
                    a_h, c_h = ah0[idx], ch0[idx]
                    means, values = [], []
                    for t in range(T):
                        mean, value, a_h, c_h = forward(q, B_o[t, idx], a_h,
                                                        c_h)
                        keep = (1.0 - B_td[t, idx])[:, None]
                        a_h, c_h = a_h * keep, c_h * keep
                        means.append(mean)
                        values.append(value)
                    logp = log_prob(q["actor_logstd"], torch.stack(means),
                                    B_a[:, idx])
                    return logp, val_rms.norm(torch.stack(values))
                logp, v_n = replay(p)
                if look:
                    look.before_step(replay, p, B_lp[:, idx], adv[:, idx],
                                     rn[:, idx], vn[:, idx])
                loss = clipped_loss(h, p["actor_logstd"], logp,
                                    B_lp[:, idx], adv[:, idx], v_n,
                                    rn[:, idx], vn[:, idx])
                grads, grad1 = step(h, p, names, opt, loss, grad1)
                opt.step(grads, lr)
                if look:
                    look.after_step(p)
                it_losses.append(loss.detach())
        losses.append(float(torch.stack(it_losses).mean()))
    return {"losses": losses, "grad1": grad1,
            "params": {x: p[x].detach().cpu() for x in names},
            "actions": actions, "trail": look.rows if look else None}
