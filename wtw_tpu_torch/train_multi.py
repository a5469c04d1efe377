"""Train one policy on a mixed-robot batch with the PyTorch/CUDA port (the
counterpart of `scripts/train_multi.py`):

    python -m wtw_tpu_torch.train_multi --robots go1,go2 --num-envs 1024 \\
        --iterations 800

Robots of one topology (go1, go2, b1, mini_cheetah) train in one batch
through one `ppo_cse` learner, each env with its robot's own flat-preset
gains, spawn height and default pose (`envs/multi_env.py`); both physics
kernels read each env's robot from its index. Per-robot reward curves land
in `<run_dir>/metrics.csv` (`rew_<robot>`: the mean reward over that
robot's envs of one extra policy step of the mean action on the current
world, which is not advanced). `--set` takes `section.field=value` for the
Cfg tree, and `ppo.*` / `ac.*` for the learner. Runs on the CUDA device
unless `--cpu` is given. The learner's state, the config and the robots
are saved to `<run_dir>/state_last.pt` at the end; like the JAX script,
there is no `--resume`.
"""
from __future__ import annotations

import argparse
import csv
import os
import time

import torch

from . import config as C
from . import resolve_device


class MultiRunner:
    """The JAX script's loop: a `ppo_cse` iteration, then the per-robot
    reward of one more policy step from the iteration's end."""

    def __init__(self, env, ppo_args, ac_args, seed: int = 0,
                 run_dir: str = "runs/multi", log_freq: int = 20):
        from .envs.multi_env import robot_masks
        from .learn import ppo_cse
        self.env, self.args, self.run_dir = env, ppo_args, run_dir
        self.log_freq = log_freq
        self.robots = env.robot_names
        self.masks = robot_masks(env)                       # (R, N)
        self.counts = torch.clamp(self.masks.sum(1), min=1.0)
        self.ppo = ppo_cse.PPO(env, ppo_args, ac_args, seed=seed + 1)
        self.world = env.init_state(seed)
        self.world, self.obs_dict = env.get_observations(self.world)
        self.last_stats = self.last_per_robot = None
        os.makedirs(run_dir, exist_ok=True)

    @torch.no_grad()
    def per_robot_reward(self, world, obs_dict) -> torch.Tensor:
        """(R,) mean reward over each robot's envs of one step of the mean
        action from `world`, which stays as it was (its generator too)."""
        mean, _ = self.ppo.ac.act_student(obs_dict["obs_history"])
        gen_state = world.gen.get_state()
        _, _, rew, _, _ = self.env.step(world, mean)
        world.gen.set_state(gen_state)
        return (self.masks @ rew) / self.counts

    def iteration(self):
        self.world, self.obs_dict, stats = self.ppo.train_iteration(
            self.world, self.obs_dict)
        per_robot = self.per_robot_reward(self.world, self.obs_dict)
        return stats, per_robot

    def learn(self, iterations: int, log_fn=print):
        """Returns the per-iteration wall seconds (device work finished at
        the end of each)."""
        dev = self.env.device
        csv_path = os.path.join(self.run_dir, "metrics.csv")
        it0 = self.ppo.iteration
        keys, walls = None, []
        t_start = time.perf_counter()
        for it in range(it0, it0 + iterations):
            t0 = time.perf_counter()
            stats, per_robot = self.iteration()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
            self.last_stats, self.last_per_robot = stats, per_robot
            if (it - it0) % self.log_freq and it != it0 + iterations - 1:
                continue
            pr = per_robot.cpu().tolist()
            row = {"iteration": it,
                   "wall_s": round(time.perf_counter() - t_start, 1),
                   "mean_step_reward": float(stats["mean_step_reward"]),
                   "ep_rew_total": float(stats["episode_reward_sums"][-1]),
                   "value_loss": float(stats["value_loss"]),
                   "adaptation_loss": float(stats["adaptation_loss"])}
            for name, r in zip(self.robots, pr):
                row[f"rew_{name}"] = r
            if keys is None:
                keys = list(row)
                with open(csv_path, "w", newline="") as f:
                    csv.DictWriter(f, keys).writeheader()
            with open(csv_path, "a", newline="") as f:
                csv.DictWriter(f, keys).writerow(row)
            log_fn(f"it {it:5d} | rew {row['mean_step_reward']:.4f} | "
                   + " ".join(f"{n} {row[f'rew_{n}']:.4f}"
                              for n in self.robots)
                   + f" | ep_rew {row['ep_rew_total']:.2f}")
        self.save()
        return walls

    def save(self):
        path = os.path.join(self.run_dir, "state_last.pt")
        torch.save({**self.ppo.state(), "cfg": self.env.cfg,
                    "robots": list(self.robots)}, path)
        return path


def build(robots=("go1", "go2"), num_envs: int = 1024, overrides=(),
          device=None, seed: int = 0, run_dir=None, log_freq: int = 20):
    """(env, runner) as `scripts/train_multi.py` builds them: go1_flat's
    config at `num_envs`, `overrides` routed like `train.build` (`ppo.*` to
    PPOArgs, `ac.*` to ACArgs, the rest to the Cfg tree), the mixed-robot
    env and a `MultiRunner`."""
    from .envs.multi_env import make_multi_legged_env
    from .learn import PPOArgs
    from .models.actor_critic import ACArgs

    dev = resolve_device(device)
    if dev.type == "cuda":
        # true fp32 everywhere: TF32 is below the engine's precision
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    robots = tuple(robots)
    pick = lambda pre: [s[len(pre):] for s in overrides if s.startswith(pre)]
    cfg = C.go1_flat_config(num_envs=num_envs)
    cfg = C.apply_overrides(cfg, [s for s in overrides
                                  if not s.startswith(("ppo.", "ac."))])
    env = make_multi_legged_env(cfg, robots, seed=seed, device=dev)
    run_dir = run_dir or f"runs/multi_{'_'.join(robots)}"
    runner = MultiRunner(env, C.apply_overrides(PPOArgs(), pick("ppo.")),
                         C.apply_overrides(ACArgs(), pick("ac.")), seed=seed,
                         run_dir=run_dir, log_freq=log_freq)
    return env, runner


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--robots", default="go1,go2")
    ap.add_argument("--num-envs", type=int, default=1024)
    ap.add_argument("--iterations", type=int, default=800)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-freq", type=int, default=20)
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    ap.add_argument("--set", action="append", default=[], metavar="K=V")
    args = ap.parse_args(argv)
    robots = args.robots.split(",")
    env, runner = build(robots, args.num_envs, args.set,
                        "cpu" if args.cpu else None, args.seed, args.run_dir,
                        args.log_freq)
    print(f"multi-embodiment: {robots} x {args.num_envs} envs -> "
          f"{runner.run_dir} (device {env.device})")
    t0 = time.time()
    runner.learn(args.iterations)
    print(f"done: {args.iterations} iterations in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
