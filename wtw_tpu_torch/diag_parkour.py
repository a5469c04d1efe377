"""Parkour failure diagnostics (the counterpart of `tools/diag_parkour.py`):
roll a trained CaT policy on ONE track type pinned at ONE difficulty level
and attribute every termination.

    python -m wtw_tpu_torch.diag_parkour --checkpoint checkpoints/parkour_v2_r5.pkl.gz \
        --terrain gap --level 0 --num-envs 64 --steps 700

For each env's FIRST completed episode (every env starts freshly reset at
the pinned level, so first episodes are untouched by curriculum moves):

- the distance along the track at termination (the promotion rule needs
  > 0.8 x the 12 m track; go2_parkour.py:1158-1186),
- the hard-done reason (base/knee contact, lava, upsidedown, low base,
  timeout, diverged),
- the binding CaT constraint at the final step,
- the death-x histogram over the track.

`--checkpoint` takes the port's parkour `state_<tag>.pt` or a JAX script's
`.pkl` / `.pkl.gz`; the policy is its action mean (`--stochastic` samples
as in training) on observations normalized by the file's frozen obs
normalizer. The env is built as `scripts/train_vision.py` builds it (the
course of `--terrain` plus `--set` overrides). Prints one JSON line with
the JAX tool's keys. Runs on the CUDA device unless `--device cpu` is
given.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .train_vision import build_env

# the order in which a first episode's hard-done reason is named: physical
# deaths before the timeout
REASONS = ("diverged", "lava", "upsidedown", "base_contact", "knee_contact",
           "base_height", "timeout")


def load_cat_policy(path: str, env, stochastic=False, seed=0):
    """fn(obs) -> actions of a CaT checkpoint (the port's `.pt` or a JAX
    `.pkl` / `.pkl.gz`): the action mean on obs normalized by the file's
    obs normalizer, plus the policy's noise under `stochastic`."""
    from .convert import cat_params_from_jax
    from .learn import jax_checkpoint
    from .learn.cat_ppo import CatAgent, RMSState, rms_norm
    from .learn.runner import load_checkpoint
    dev = env.device
    blob = load_checkpoint(path, dev)
    if jax_checkpoint.is_jax_checkpoint(path):
        ts = blob["ts"]
        sd = cat_params_from_jax(ts.params)
        rms = {f: torch.from_numpy(np.array(getattr(ts.obs_rms, f),
                                            np.float32))
               for f in ("mean", "var", "count")}
    else:
        sd, rms = blob["agent"], blob["obs_rms"]
    n = sum(1 for k in sd if k.startswith("actor_mean.")
            and k.endswith(".weight"))
    hidden = tuple(int(sd[f"actor_mean.{2 * i}.weight"].shape[0])
                   for i in range(n - 1))
    agent = CatAgent(env.num_obs, env.num_actions, hidden)
    # the heads only: a PPO+ or PPO-RNN file's other modules are not read
    agent.load_state_dict({k: v for k, v in sd.items()
                           if k.split(".")[0] in ("critic", "actor_mean",
                                                  "actor_logstd")})
    agent.to(dev).eval()
    obs_rms = RMSState(**{k: v.to(dev) for k, v in rms.items()})
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) + 7)

    @torch.no_grad()
    def policy(obs):
        acts = agent.actor_mean(rms_norm(obs_rms, obs))
        if stochastic:
            acts = acts + torch.exp(agent.actor_logstd) * torch.randn(
                acts.shape, generator=gen, device=dev)
        return acts
    return policy


def attribute_first_episodes(true_dones, dist_at_done, reasons, argmax_col,
                             progress, alive_x, col_names, dt, track):
    """The attribution of each env's first episode from (T, N) traces of a
    rollout: `true_dones` (bool), `dist_at_done`, `reasons` {name: (T, N)
    bool}, `argmax_col` (the binding constraint column), `progress` (the
    episode step after each step) and `alive_x` (the base x over the env's
    origin). -> the JAX tool's dict, without its run keys."""
    T, N = true_dones.shape
    first_done = np.zeros(N, bool)
    first_dist = np.zeros(N, np.float32)
    first_len = np.zeros(N, np.float32)
    first_reason = np.array(["none"] * N, dtype=object)
    first_cstr = np.array(["none"] * N, dtype=object)
    ep_progress_prev = np.zeros(N, np.int32)
    max_x = np.zeros(N, np.float32)
    for t in range(T):
        td = true_dones[t]
        max_x = np.maximum(max_x, np.where(~first_done, alive_x[t], max_x))
        new = td & ~first_done
        if new.any():
            first_dist[new] = dist_at_done[t][new]
            first_len[new] = ep_progress_prev[new] * dt
            for nm in REASONS:
                sel = new & reasons[nm][t] & (first_reason == "none")
                first_reason[sel] = nm
            for i in np.where(new)[0]:
                first_cstr[i] = col_names[int(argmax_col[t, i])]
            first_done |= new
        ep_progress_prev = progress[t]
        if first_done.all():
            break
    done_n = int(first_done.sum())
    cross = first_dist > 0.8 * track
    done = first_dist[first_done]
    return {
        "first_episodes_done": done_n,
        "still_alive": int((~first_done).sum()),
        "alive_max_x_mean": round(float(max_x[~first_done].mean()), 2)
        if (~first_done).any() else None,
        "cross_rate": round(float(cross.sum() / max(done_n, 1)), 3),
        "dist_mean": round(float(done.mean()), 2) if done_n else None,
        "dist_p50": round(float(np.median(done)), 2) if done_n else None,
        "dist_p90": round(float(np.percentile(done, 90)), 2)
        if done_n else None,
        "eplen_mean_s": round(float(first_len[first_done].mean()), 2)
        if done_n else None,
        "reasons": {k: int((first_reason == k).sum())
                    for k in sorted(set(first_reason)) if k != "none"},
        "binding_cstr": {k: int((first_cstr == k).sum())
                         for k in sorted(set(first_cstr)) if k != "none"},
        "death_x_hist_1m_bins": [
            int(((first_dist >= i) & (first_dist < i + 1)
                 & first_done).sum()) for i in range(int(track) + 1)],
    }


@torch.no_grad()
def run(env, policy, level: int, steps: int, seed: int = 0,
        check_every: int = 50):
    """Roll `policy` from every env re-seated at `level`; the traces stay
    on the device and are read back in blocks of `check_every` steps, when
    the run also stops once every env's first episode is over (what the
    attribution reads is then complete). -> ({name: (T, N) numpy},
    steps run)."""
    world = env.init_state(seed)
    lvl = torch.full((env.num_envs,), level, dtype=torch.long,
                     device=env.device)
    world = env.restore_terrain_state(world, lvl)
    obs = env.get_observations(world)
    first_done = torch.zeros(env.num_envs, dtype=torch.bool,
                             device=env.device)
    keys = ("true_dones", "dist_at_done", "argmax_col", "progress",
            "alive_x") + REASONS
    traces = {k: [] for k in keys}
    t = 0
    while t < steps:
        world, obs, rew, done, info = env.step(world, policy(obs))
        td = info["true_dones"]
        first_done |= td
        e = world.env       # the env's state arena on a card: copy
        for k, v in (("true_dones", td), ("dist_at_done",
                                          info["dist_at_done"]),
                     ("argmax_col", info["cstr_argmax_col"]),
                     ("progress", e.progress.clone()),
                     ("alive_x", e.phys.base_pos[:, 0] - e.env_origin[:, 0]),
                     *info["done_reasons"].items()):
            traces[k].append(v)
        t += 1
        if t % check_every == 0 and bool(first_done.all()):
            break
    return {k: torch.stack(v).cpu().numpy() for k, v in traces.items()}, t


def diagnose(env, policy, level: int, steps: int, seed: int = 0):
    """(attribution dict, steps run) of one pinned-level run."""
    col_names = []
    for n in env.cstr.names:
        a, b = env.cstr.offsets[n]
        col_names += [n] * (b - a)
    tr, ran = run(env, policy, level, steps, seed)
    out = attribute_first_episodes(
        tr["true_dones"].astype(bool), tr["dist_at_done"],
        {k: tr[k].astype(bool) for k in REASONS}, tr["argmax_col"],
        tr["progress"], tr["alive_x"], col_names, env.dt, env.track_length)
    return out, ran


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--terrain", default="gap")
    ap.add_argument("--level", type=int, default=0)
    ap.add_argument("--num-envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=700)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--easy-mode", action="store_true")
    ap.add_argument("--stochastic", action="store_true",
                    help="sample actions from the policy distribution "
                         "instead of the mean (training-time behavior)")
    ap.add_argument("--set", action="append", default=[], metavar="K=V")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    overrides = [f"terrain.min_init_map_level={args.level}",
                 f"terrain.max_init_map_level={args.level}",
                 "only_forwards=true", "only_forwards_velocity=0.8",
                 *args.set]
    env = build_env(args.num_envs, args.seed, terrain=args.terrain,
                    easy_mode=args.easy_mode, overrides=overrides,
                    device=args.device)
    if env.device.type == "cuda":
        # true fp32 everywhere: TF32 is below the engine's precision
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    policy = load_cat_policy(args.checkpoint, env, args.stochastic,
                             args.seed)
    diag, _ = diagnose(env, policy, args.level, args.steps, args.seed)
    out = {"terrain": args.terrain, "level": args.level,
           "easy_mode": args.easy_mode, "envs": env.num_envs, **diag}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
