"""Actuator-network training from robot logs (port of
`wtw_tpu/learn/actuator_train.py`, reference
scripts/actuator_net/{train,eval,utils}.py): fit the per-joint torque model
(MLP 6 -> 32 -> 32 -> 1, softsign) on logged (pos_err, pos_err@t-1,
pos_err@t-2, vel, vel@t-1, vel@t-2) -> tau_est pairs (features
utils.py:187-206; Adam lr 8e-4, batch 128, an 80/20 split, utils.py:78-146)
and export the `.npz` that `models/actuator_net.py` loads.

    python -m wtw_tpu_torch.learn.actuator_train --log episode.pkl --out net.npz

Runs on the CUDA device unless `--device cpu` is given.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ..models.actuator_net import apply_actuator_net

HIDDEN = (32, 32)


def build_features(joint_pos_target, joint_pos, joint_vel,
                   history_gap: int = 2):
    """Logged (T, nj) arrays -> (T-2g, nj, 6) float32 features: the error
    and the velocity at t, t-g and t-2g (utils.py:187-206)."""
    err = joint_pos_target - joint_pos
    g = history_gap
    t0, t1, t2 = slice(2 * g, None), slice(g, -g), slice(None, -2 * g)
    x = np.stack([err[t0], err[t1], err[t2],
                  joint_vel[t0], joint_vel[t1], joint_vel[t2]], axis=-1)
    return x.astype(np.float32)


def init_actuator_net(generator: Optional[torch.Generator] = None,
                      hidden=HIDDEN) -> Dict[str, torch.Tensor]:
    """Weights uniform in +-1/sqrt(fan_in), stored (in, out); zero biases
    (`wtw_tpu/models/actuator_net.py:init_actuator_net`)."""
    sizes = (6,) + tuple(hidden) + (1,)
    params = {}
    for i in range(len(sizes) - 1):
        bound = 1.0 / math.sqrt(sizes[i])
        w = torch.rand(sizes[i], sizes[i + 1], generator=generator)
        params[f"w{i}"] = w * 2 * bound - bound
        params[f"b{i}"] = torch.zeros(sizes[i + 1])
    return params


def _net(params, x):
    return apply_actuator_net(params, *x.unbind(-1))


def train_actuator_network(xs: np.ndarray, ys: np.ndarray, *,
                           lr: float = 8e-4, epochs: int = 100,
                           batch_size: int = 128, seed: int = 0,
                           log_fn=print, device="cpu", params=None,
                           split=None, perms=None):
    """xs: (N, 6) features, ys: (N,) measured torques. `params` (default: a
    fresh net from `seed`), `split` (a permutation of N: the first 80% train)
    and `perms` (each epoch's permutation of the training rows) default to
    draws from a generator seeded with `seed`. -> (params as float32 CPU
    tensors, (in, out) weights; the final test MAE)."""
    dev = torch.device(device)
    xs = torch.as_tensor(np.asarray(xs, np.float32), device=dev)
    ys = torch.as_tensor(np.asarray(ys, np.float32), device=dev)
    n = xs.shape[0]
    n_train = n // 5 * 4
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    perm = (torch.as_tensor(split, device=dev) if split is not None
            else torch.randperm(n, generator=gen, device=dev))
    tr_idx, te_idx = perm[:n_train], perm[n_train:]
    if params is None:
        init_gen = torch.Generator()
        init_gen.manual_seed(int(seed))
        params = init_actuator_net(init_gen)
    params = {k: torch.tensor(np.array(v, np.float32), device=dev,
                              requires_grad=True) for k, v in params.items()}
    opt = torch.optim.Adam(params.values(), lr=lr, eps=1e-8)
    x_te, y_te = xs[te_idx], ys[te_idx]
    mae = math.inf
    for epoch in range(epochs):
        order = (torch.as_tensor(perms[epoch], device=dev)
                 if perms is not None else
                 torch.randperm(n_train, generator=gen, device=dev))
        losses = []
        for i in range(n_train // batch_size):
            rows = tr_idx[order[i * batch_size:(i + 1) * batch_size]]
            loss = torch.mean((_net(params, xs[rows]) - ys[rows]) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        if epoch % 10 == 0 or epoch == epochs - 1:
            with torch.no_grad():
                err = _net(params, x_te) - y_te
                test_loss, mae = float(torch.mean(err ** 2)), float(
                    torch.mean(torch.abs(err)))
            log_fn(f"epoch {epoch:3d} | loss "
                   f"{float(torch.stack(losses).mean()):.4f} | "
                   f"test {test_loss:.4f} | mae {mae:.4f}")
    return {k: v.detach().cpu() for k, v in params.items()}, mae


def save_actuator_network(params, path: str):
    np.savez(path, **{k: np.asarray(torch.as_tensor(v).cpu(), np.float32)
                      for k, v in params.items()})


def main(argv=None):
    """CLI counterpart of scripts/actuator_net/train.py: fit the torque model
    from a log (a pickled dict with (T, 12) arrays joint_pos_target,
    joint_pos, joint_vel and tau_est, the deploy logger's episode format)
    and export the `.npz`."""
    import argparse
    import pickle

    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--log", required=True,
                    help="episode .pkl with joint_pos_target/joint_pos/"
                         "joint_vel/tau_est arrays")
    ap.add_argument("--out", default="actuator_net.npz")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    from .. import resolve_device
    dev = resolve_device(args.device)

    with open(args.log, "rb") as f:
        log = pickle.load(f)
    arrs = {k: np.asarray(log[k], np.float32)
            for k in ("joint_pos_target", "joint_pos", "joint_vel",
                      "tau_est")}
    g = 2
    x = build_features(arrs["joint_pos_target"], arrs["joint_pos"],
                       arrs["joint_vel"], history_gap=g)
    xs = x.reshape(-1, 6)
    ys = arrs["tau_est"][2 * g:].reshape(-1)     # align with the t0 slice
    params, mae = train_actuator_network(xs, ys, epochs=args.epochs,
                                         seed=args.seed, device=dev)
    save_actuator_network(params, args.out)
    print(f"{args.out}: test MAE {mae:.4f} NM over {len(ys)} samples")
    return {"out": args.out, "mae": mae, "samples": len(ys),
            "label_std": float(np.std(ys))}


if __name__ == "__main__":
    main()
