"""Two-stage vision distillation on the PyTorch/CUDA port (the counterpart
of `scripts/train_vision.py`, the reference's DDPG demos pipeline):

1. generate demos from a trained parkour expert
   (algos/DDPG_demos_generate.py):

     python -m wtw_tpu_torch.train_vision generate \\
         --checkpoint checkpoints/parkour_v2_r5.pkl.gz --steps 512 --out runs/vision

2. train the recurrent depth-vision student against them
   (algos/DDPG_demos_rnn_vision.py):

     python -m wtw_tpu_torch.train_vision train --demos runs/vision/rb_demos.pt \\
         --env-steps 100000 --bc-steps 2000

3. evaluate the student (or, with `--checkpoint`, the expert):

     python -m wtw_tpu_torch.train_vision eval --student runs/vision/vision_student.pt

`--checkpoint` takes a JAX CaT `state_*.pkl[.gz]` or the port's parkour
`.pt`; `--demos` the port's `rb_demos.pt` or the JAX script's
`rb_demos.pkl`; `--student` the port's `vision_student.pt` or the JAX
script's `vision_student.pkl`. generate writes `<out>/rb_demos.pt` (or
`--demos`), train writes `<out>/vision_student.pt`, eval prints one JSON
line with the JAX script's keys. Runs on the CUDA device unless `--device
cpu` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from . import config as C
from . import resolve_device
from .learn import ddpg_demos as D


def build_env(num_envs, seed, terrain="mixed", easy_mode=False,
              overrides=(), device=None):
    """The parkour env of `scripts/train_vision.py:21-34`: the course of the
    `terrain` preset, `overrides` over ParkourCfg."""
    from .envs.parkour_env import ParkourCfg, ParkourEnv
    from .models import load_robot
    from .terrain import ParkourTerrainCfg
    from .train_parkour import TERRAIN_PRESETS
    cfg = ParkourCfg(num_envs=num_envs, terrain=ParkourTerrainCfg(
        proportions=TERRAIN_PRESETS[terrain], easy_mode=easy_mode))
    cfg = C.apply_overrides(cfg, overrides)
    return ParkourEnv(cfg, load_robot(cfg.robot), seed=seed,
                      device=resolve_device(device))


def load_expert(path, env):
    """The expert's action mean on normalized obs (a JAX CaT `.pkl[.gz]` or
    the port's parkour `.pt`)."""
    from .diag_parkour import load_cat_policy
    return load_cat_policy(path, env)


def load_student(path, num_actions, args: D.DDPGArgs, device):
    """A depth student: the port's `vision_student.pt` or the JAX script's
    `vision_student.pkl` (plain numpy dicts, read without JAX)."""
    from .convert import vision_params_from_jax
    from .learn import jax_checkpoint
    if jax_checkpoint.is_jax_checkpoint(path):
        sd = vision_params_from_jax(jax_checkpoint.load(path))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)["student"]
    student = D.Student(num_actions, args)
    student.load_state_dict(sd)
    return student.to(device).eval()


@torch.no_grad()
def evaluate(env, args: D.DDPGArgs, steps: int, seed: int, student=None,
             expert=None):
    """Roll the depth student (or the expert) from `env.init_state(seed)`
    and report the parkour success metrics (`scripts/train_vision.py
    :115-195`): the mean step reward, the mean length of completed
    episodes, and the track-crossing rate (dist > 0.8 track_length at
    termination, go2_parkour.py:1158-1186). The student's frame is rendered
    every step, its latent refreshed every `vision_update_interval`."""
    N, dev = env.num_envs, env.device
    world = env.init_state(seed)
    obs = env.get_observations(world)
    hidden = torch.zeros(N, args.rnn_hidden, device=dev)
    vlat = torch.zeros(N, args.vision_latent, device=dev)
    render = D._renderer(env, args) if student is not None else None
    trace = {k: [] for k in ("td", "dist", "eplen", "rew")}
    for step in range(steps):
        if student is not None:
            vobs = D._frame(render, world)
            if step % args.vision_update_interval == 0:
                vlat = student.vision(vobs)
            acts, hidden = student.actor(obs[:, :args.proprio_dim], vlat,
                                         hidden)
        else:
            acts = expert(obs)
        world, obs, rew, _, info = env.step(world, acts)
        td = info["true_dones"].float()
        if student is not None:
            hidden = hidden * (1.0 - td)[:, None]
        for k, v in (("td", td), ("dist", info["dist_at_done"]),
                     ("eplen", info["episode_len_at_reset"]),
                     ("rew", rew.mean())):
            trace[k].append(v)
    tr = {k: torch.stack(v).cpu().numpy() for k, v in trace.items()}
    # the JAX script's host arithmetic, step by step
    n_done = n_cross = done_len = 0.0
    for t in range(steps):
        td, dist = tr["td"][t], tr["dist"][t]
        n_done += td.sum()
        n_cross += (td * (dist > 0.8 * env.track_length)).sum()
        done_len += float(tr["eplen"][t])
    rews = [float(r) for r in tr["rew"]]
    return {
        "policy": "student" if student is not None else "expert",
        "num_envs": N, "steps": steps,
        "mean_step_reward": round(float(np.mean(rews)), 4),
        # over COMPLETED episodes only; censored (still-alive) episodes are
        # reported separately rather than biasing the mean
        "mean_episode_len_s": round(
            float(done_len / max(n_done, 1) * env.dt), 2),
        "episodes": int(n_done),
        "censored_episodes": int(N),
        "track_cross_rate": round(float(n_cross / max(n_done, 1)), 4),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["generate", "train", "eval"])
    ap.add_argument("--student", default=None,
                    help="eval: the student from the train stage")
    ap.add_argument("--checkpoint", default=None,
                    help="parkour CaT checkpoint of the expert")
    ap.add_argument("--demos", default=None, help="demo buffer file")
    ap.add_argument("--num-envs", type=int, default=256)
    ap.add_argument("--steps", type=int, default=512,
                    help="generate: env steps of demos to record")
    ap.add_argument("--env-steps", type=int, default=100_000)
    ap.add_argument("--ring-steps", type=int, default=256,
                    help="online replay ring length in env steps (train)")
    ap.add_argument("--actor-delay", type=int, default=None,
                    help="env steps to hold actor updates after a BC warm "
                         "start (default: DDPGArgs.actor_delay_env_steps, "
                         "capped at 12.5%% of --env-steps)")
    ap.add_argument("--bc-steps", type=int, default=0,
                    help="behavior-cloning warm-start batches on the demo "
                         "buffer before the DDPG phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/vision")
    ap.add_argument("--terrain", default="mixed",
                    help="terrain preset (must match the expert's training "
                         "terrain so obs statistics line up)")
    ap.add_argument("--easy-mode", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    metavar="FIELD=VALUE",
                    help="cfg overrides, e.g. --set only_forwards=true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    env = build_env(args.num_envs, args.seed, terrain=args.terrain,
                    easy_mode=args.easy_mode, overrides=args.set,
                    device=args.device)
    if env.device.type == "cuda":
        # true fp32 everywhere: TF32 is below the engine's precision
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    # keep the post-BC actor hold proportionate to the run
    delay = (args.actor_delay if args.actor_delay is not None else
             min(D.DDPGArgs.actor_delay_env_steps, args.env_steps // 8))
    # generate records args.steps steps, so its buffer must hold them all;
    # train's online ring is sized apart (--ring-steps)
    ring = max(args.steps, 64) if args.mode == "generate" \
        else max(args.ring_steps, 64)
    ddpg_args = D.DDPGArgs(buffer_steps=ring, actor_delay_env_steps=delay)

    if args.mode == "generate":
        if args.checkpoint:
            expert = load_expert(args.checkpoint, env)
        else:
            print("WARNING: no --checkpoint, recording a zero-action expert")
            zeros = torch.zeros(env.num_envs, env.num_actions,
                                device=env.device)
            expert = lambda obs: zeros
        buf = D.generate_demos(expert, env, args.steps, args.seed, ddpg_args)
        out = args.demos or os.path.join(args.out, "rb_demos.pt")
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        D.save_buffer(buf, out)
        print(f"demo buffer ({buf.filled} steps x {env.num_envs} envs) "
              f"-> {out}")
        return {"out": out, "filled": buf.filled, "nbytes": buf.nbytes()}
    if args.mode == "eval":
        if args.student:
            student = load_student(args.student, env.num_actions, ddpg_args,
                                   env.device)
            out = evaluate(env, ddpg_args, args.steps, args.seed,
                           student=student)
        else:
            if not args.checkpoint:
                ap.error("--student or --checkpoint required")
            out = evaluate(env, ddpg_args, args.steps, args.seed,
                           expert=load_expert(args.checkpoint, env))
        print(json.dumps(out))
        return out
    if not args.demos:
        ap.error("--demos required for train")
    demos = D.load_buffer(args.demos, env.device)
    learner, rb = D.train_vision_student(
        env, demos, total_env_steps=args.env_steps, seed=args.seed,
        args=ddpg_args, bc_batches=args.bc_steps)
    os.makedirs(args.out, exist_ok=True)
    out = os.path.join(args.out, "vision_student.pt")
    torch.save({"student": learner.student.state_dict(),
                "ddpg_args": dataclasses.asdict(ddpg_args)}, out)
    print(f"vision student -> {out}")
    return {"out": out, "learner": learner, "ring": rb, "demos": demos}


if __name__ == "__main__":
    main()
