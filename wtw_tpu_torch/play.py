"""Evaluate a trained checkpoint: command a gait and report metrics (the
counterpart of `scripts/play.py`; reference scripts/{go1,go2,b1}/play.py:
89-157, plus the eval_metrics DR sweeps):

    python -m wtw_tpu_torch.play --checkpoint runs/go1_mob/seed0/checkpoints/state_last.pt
    python -m wtw_tpu_torch.play --checkpoint checkpoints/go1_mob_r5b_cot.pkl.gz \
        --vx 0.5 --freq 2.5 --gait-stats
    python -m wtw_tpu_torch.play --checkpoint ... --sweep rand_large

`--checkpoint` takes the port's `state_<tag>.pt` or a JAX runner's `.pkl` /
`.pkl.gz`. The env is rebuilt from the file's config (or `--preset` where
the file has none) with every domain randomization off except the actuator
lag, as the reference's play.py evaluates (:49-72). Prints the summary as
JSON, with the JAX script's keys. Runs on the CUDA device unless
`--device cpu` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from . import config as C
from . import resolve_device

# (phase, offset, bound) per reference scripts/go1/play.py:102-105:
# trotting=[.5,0,0], bounding=[0,.5,0], pacing=[0,0,.5]
GAIT_CMD = {"trot": (0.5, 0.0, 0.0), "bound": (0.0, 0.5, 0.0),
            "pace": (0.0, 0.0, 0.5), "pronk": (0.0, 0.0, 0.0)}


def load_checkpoint_policy(path: str, device):
    """(cfg or None, actor-critic state_dict, iteration) of a Stack-A
    checkpoint: the port's `state_<tag>.pt` or a JAX runner's `.pkl` /
    `.pkl.gz` (weights through `convert.params_from_jax`)."""
    from .convert import params_from_jax
    from .learn import jax_checkpoint
    from .learn.runner import load_checkpoint
    blob = load_checkpoint(path, device)
    if jax_checkpoint.is_jax_checkpoint(path):
        ts = blob["ts"]
        return (blob.get("cfg"), params_from_jax(ts.params),
                int(np.asarray(ts.iteration)))
    return blob.get("cfg"), blob["ac"], int(blob["iteration"])


def _hidden(sd, net):
    """Hidden widths of the MLP `net` in an ActorCritic state_dict."""
    n = sum(1 for k in sd if k.startswith(f"{net}.") and k.endswith(".weight"))
    return tuple(int(sd[f"{net}.{2 * i}.weight"].shape[0])
                 for i in range(n - 1))


def make_policy(env, state_dict):
    """The student policy fn(obs_dict) -> action means of an actor-critic
    state_dict (its widths read from the weights)."""
    from .models.actor_critic import ACArgs, ActorCritic
    args = ACArgs(actor_hidden_dims=_hidden(state_dict, "actor"),
                  critic_hidden_dims=_hidden(state_dict, "critic"),
                  adaptation_hidden_dims=_hidden(state_dict, "adaptation"))
    model = ActorCritic(env.num_obs, env.num_privileged_obs,
                        env.num_obs_history, env.num_actions, args)
    model.load_state_dict({k: v.float() for k, v in state_dict.items()})
    model.to(env.device).eval()

    @torch.no_grad()
    def policy(obs_dict):
        return model.act_student(obs_dict["obs_history"])[0]
    return policy


def eval_cfg(cfg, num_envs: int, sweep=None):
    """The eval env's config: `num_envs` envs, none split off for eval,
    every domain randomization off except the actuator lag (the round-5 eval
    protocol, scripts/go1/play.py:49-72), then the DR sweep `sweep` over
    `base_set` where given."""
    from .learn.eval_metrics import DR_SWEEPS, base_set
    cfg = dataclasses.replace(cfg, env=dataclasses.replace(
        cfg.env, num_envs=num_envs, num_eval_envs=0))
    cfg = dataclasses.replace(cfg, domain_rand=dataclasses.replace(
        cfg.domain_rand,
        randomize_friction=False, randomize_restitution=False,
        randomize_base_mass=False, randomize_com_displacement=False,
        randomize_motor_strength=False, randomize_motor_offset=False,
        randomize_Kp_factor=False, randomize_Kd_factor=False,
        randomize_gravity=False, randomize_lag_timesteps=True))
    if sweep:
        cfg = DR_SWEEPS[sweep](base_set(cfg))
    return cfg


def command_vector(nc: int, vx: float, yaw: float = 0.0, gait="trot",
                   freq: float = 3.0, footswing: float = 0.08):
    """vx, 0, yaw, and for a 15-dim MoB command the gait defaults of
    play.py:101-117 (duration 0.5, stance width 0.25, stance length 0.40,
    inside the training range [0.35, 0.45])."""
    c = np.zeros(nc, np.float32)
    c[0] = vx
    if nc > 2:
        c[2] = yaw
    if nc >= 15:
        c[4] = freq
        c[5:8] = GAIT_CMD[gait]
        c[8] = 0.5
        c[9] = footswing
        c[12] = 0.25
        c[13] = 0.40
    return c


def build(checkpoint: str, num_envs: int = 64, sweep=None, seed: int = 0,
          device=None, preset: str = "go1_flat"):
    """(env, policy, cfg, iteration) for a checkpoint."""
    from .envs import make_legged_env
    dev = resolve_device(device)
    if dev.type == "cuda":
        # true fp32 everywhere: TF32 is below the engine's precision
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg, sd, it = load_checkpoint_policy(checkpoint, dev)
    if cfg is None:
        cfg = C.PRESETS[preset]()
    cfg = eval_cfg(cfg, num_envs, sweep)
    env = make_legged_env(cfg, device=dev, seed=seed)
    return env, make_policy(env, sd), cfg, it


def interactive(env, policy, commands, args):
    """A live keyboard-commanded rollout: one policy step a frame, the
    command re-pinned from the keyboard every step."""
    import time

    from .learn.eval_metrics import pin_commands
    from .utils.keyboard import KeyboardCommandSource
    nc = commands.shape[0]
    world = env.init_state(args.seed)
    world, obs = env.get_observations(world)
    src = KeyboardCommandSource(nc, vx=args.vx, freq=args.freq,
                                footswing=args.footswing)
    src.cmd[:] = commands
    with src, torch.no_grad():
        print("interactive: w/s vx  a/d vy  q/e yaw  1-4 gait  "
              "z/x height  t/g pitch  f/h swing  space stop  ESC quit")
        for step in range(args.steps if args.steps > 0 else 10 ** 9):
            t0 = time.time()
            cmd = torch.as_tensor(src.poll(), device=env.device)
            if src.quit:
                break
            world = pin_commands(world, cmd.expand_as(world.env.commands))
            world, obs, rew, done, info = env.step(world, policy(obs))
            if step % 10 == 0:
                phys = world.env.phys
                vx, vy, wz, h = torch.stack([
                    phys.base_lin_vel[:, 0].mean(),
                    phys.base_lin_vel[:, 1].mean(),
                    phys.base_ang_vel[:, 2].mean(),
                    phys.base_pos[:, 2].mean()]).tolist()
                print(f"\r[{step:5d}] {src.status()} || realized "
                      f"vx {vx:+.2f} vy {vy:+.2f} yaw {wz:+.2f} "
                      f"h {h:.2f}   ", end="", flush=True)
            time.sleep(max(0.0, env.dt - (time.time() - t0)))
    print()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True,
                    help="state_<tag>.pt of the port, or a JAX .pkl/.pkl.gz")
    ap.add_argument("--preset", default="go1_flat",
                    help="the config of a file that carries none")
    ap.add_argument("--num-envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--vx", type=float, default=1.5)
    ap.add_argument("--yaw", type=float, default=0.0)
    ap.add_argument("--sweep", default=None,
                    help="DR sweep preset (rand_regular, rand_large, ...)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gait", default="trot", choices=sorted(GAIT_CMD),
                    help="commanded gait of a 15-dim MoB policy")
    ap.add_argument("--freq", type=float, default=3.0,
                    help="commanded step frequency (Hz)")
    ap.add_argument("--footswing", type=float, default=0.08)
    ap.add_argument("--gait-stats", action="store_true",
                    help="measure duty factor / stride freq / trot phase")
    ap.add_argument("--video", default=None,
                    help="render a rollout video to this path (mp4 through "
                         "ffmpeg, else a GIF beside it; needs matplotlib)")
    ap.add_argument("--interactive", action="store_true",
                    help="drive the policy live from the keyboard (WASD "
                         "velocities, 1-4 gaits; utils/keyboard.py)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.video:
        # fail before the rollout, not after it
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise SystemExit(f"--video renders with matplotlib, which does "
                             f"not import here: {e}") from None
    from .learn.eval_metrics import evaluate_policy, gait_stats

    env, policy, cfg, _ = build(args.checkpoint, args.num_envs, args.sweep,
                                args.seed, args.device, args.preset)
    nc = cfg.commands.num_commands
    commands = command_vector(nc, args.vx, args.yaw, args.gait, args.freq,
                              args.footswing)
    if args.interactive:
        interactive(env, policy, commands, args)
        return None
    summary, _ = evaluate_policy(env, policy, steps=args.steps,
                                 seed=args.seed, commands=commands)
    summary["commanded_vx"] = args.vx
    if nc >= 15:
        summary["commanded_gait"] = args.gait
        summary["commanded_freq_hz"] = args.freq
    summary["sweep"] = args.sweep or "train-distribution"
    if args.gait_stats:
        summary["gait"] = gait_stats(env, policy, steps=args.steps,
                                     seed=args.seed, commands=commands)
    if args.video:
        from .utils.video import record_rollout, render_trajectory
        traj = record_rollout(env, policy, steps=min(args.steps, 250),
                              seed=args.seed, commands=commands)
        summary["video"] = render_trajectory(traj, env.model, hf=env.hf,
                                             path=args.video)
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
