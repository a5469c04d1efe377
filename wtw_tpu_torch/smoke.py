"""Installation smoke test of the port (the counterpart of
`scripts/smoke.py`; reference scripts/{go1,go2,b1}/test.py, "If it runs
then you have installed the gym environments correctly",
README.md:108-115): build a small world, step it with zero actions, print
progress.

    python -m wtw_tpu_torch.smoke [--preset go1_flat] [--steps 100] [--device cpu]

Runs on the CUDA device unless `--device cpu` is given; on the card every
step goes through kernels A and B.
"""
from __future__ import annotations

import argparse
import time

import torch

from . import config as C
from . import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="go1_flat", choices=sorted(C.PRESETS))
    ap.add_argument("--num-envs", type=int, default=3)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    from .envs import make_legged_env

    dev = resolve_device(args.device)
    cfg = C.PRESETS[args.preset](num_envs=args.num_envs)
    env = make_legged_env(cfg, device=dev, seed=0)
    world = env.init_state(0)
    zeros = torch.zeros(args.num_envs, env.num_actions, device=dev)
    t0 = time.time()
    finite = torch.ones((), dtype=torch.bool, device=dev)
    for i in range(args.steps):
        world, obs, rew, done, info = env.step(world, zeros)
        finite &= torch.isfinite(rew).all()
        if i % max(args.steps // 10, 1) == 0:
            print(f"step {i:4d} | rew {float(rew.mean()):+.4f} | "
                  f"base z {float(world.env.phys.base_pos[:, 2].mean()):.3f}")
    assert bool(finite), "NaN reward"
    print(f"OK — {args.steps} steps x {args.num_envs} envs in "
          f"{time.time() - t0:.1f}s. If this ran, the environments are "
          f"installed correctly.")
    return world


if __name__ == "__main__":
    main()
