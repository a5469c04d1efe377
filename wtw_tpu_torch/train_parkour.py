"""Train a Go2 parkour or rough-terrain policy with
Constraints-as-Terminations on the PyTorch/CUDA port (the counterpart of
`scripts/train_parkour.py`, reference newtrain.py task=Go2Parkour
train=SoloTerrainPPO):

    python -m wtw_tpu_torch.train_parkour --num-envs 4096 --iterations 8000
    python -m wtw_tpu_torch.train_parkour --terrain jump --easy-mode
    python -m wtw_tpu_torch.train_parkour --task terrain [--reward-mode full]
    python -m wtw_tpu_torch.train_parkour --algo ppo_plus|ppornn

`--task terrain` is Go2Terrain: the Stack-A rough-terrain map, the fixed
trot clock (observed), the Go2 actuator net; CaT with the tracking reward
unless `--reward-mode full`. `--algo ppo_plus` adds the Q head and the
zeroth-order action improvement, `--algo ppornn` the GRU memories; either
combines with both tasks. Runs on the CUDA device unless `--device cpu` is
given. Writes `<run-dir>/metrics.csv` with the JAX script's columns
(per-track-type `lvl_*` / `cross_*` included; `--algo ppo_plus|ppornn`
write what the JAX script writes for them: a terrain level and episode
length of 0.0 and no `cross_*`, `ep_*` or `cstr_*` columns) and
exact-resume checkpoints `<run-dir>/state_<tag>.pt`. `--resume` takes one
of those, or a checkpoint of the JAX script (`state_<tag>.pkl`, or a slim
`.pkl.gz` of `tools/slim_checkpoint.py`) for the same `--algo`:

    python -m wtw_tpu_torch.train_parkour --resume checkpoints/parkour_v2_r5.pkl.gz
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import time

import numpy as np
import torch

from . import config as C
from . import resolve_device

TERRAIN_PRESETS = {
    # mirrors the proportions blocks in cfg/task/Go2Parkour.yaml:38-52
    "mixed": (("gap_parkour", 0.2), ("jump_parkour", 0.2),
              ("stairs_parkour", 0.2), ("hurdle_parkour", 0.2),
              ("crawl_parkour", 0.2), ("random_uniform", 0.0), ("flat", 0.0)),
    "jump": (("gap_parkour", 0.0), ("jump_parkour", 1.0),
             ("stairs_parkour", 0.0), ("hurdle_parkour", 0.0),
             ("crawl_parkour", 0.0), ("random_uniform", 0.0), ("flat", 0.0)),
    "gap": (("gap_parkour", 1.0), ("jump_parkour", 0.0),
            ("stairs_parkour", 0.0), ("hurdle_parkour", 0.0),
            ("crawl_parkour", 0.0), ("random_uniform", 0.0), ("flat", 0.0)),
    "flat": (("gap_parkour", 0.0), ("jump_parkour", 0.0),
             ("stairs_parkour", 0.0), ("hurdle_parkour", 0.0),
             ("crawl_parkour", 0.0), ("random_uniform", 0.0), ("flat", 1.0)),
    "stairs": (("gap_parkour", 0.0), ("jump_parkour", 0.0),
               ("stairs_parkour", 1.0), ("hurdle_parkour", 0.0),
               ("crawl_parkour", 0.0), ("random_uniform", 0.0), ("flat", 0.0)),
    "hurdle": (("gap_parkour", 0.0), ("jump_parkour", 0.0),
               ("stairs_parkour", 0.0), ("hurdle_parkour", 1.0),
               ("crawl_parkour", 0.0), ("random_uniform", 0.0), ("flat", 0.0)),
    "crawl": (("gap_parkour", 0.0), ("jump_parkour", 0.0),
              ("stairs_parkour", 0.0), ("hurdle_parkour", 0.0),
              ("crawl_parkour", 1.0), ("random_uniform", 0.0), ("flat", 0.0)),
}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def column_kinds(tcfg):
    """Terrain column -> generator kind, by the cumulated-proportions walk
    of `build_parkour` (terrainParkour.py:24-33): {kind: [columns]}."""
    keys, cum, tot = [], [], 0.0
    for k, v in tcfg.proportions:
        if v != 0.0:
            tot += float(v)
            keys.append(k)
            cum.append(round(tot, 2))
    kind_cols = {}
    for j in range(tcfg.num_terrains):
        c, k = j / tcfg.num_terrains, 0
        while k < len(cum) and c >= cum[k]:
            k += 1
        kind = keys[k] if k < len(keys) else "flat"
        kind_cols.setdefault(kind.replace("_parkour", ""), []).append(j)
    return kind_cols


class ParkourRunner:
    """The training loop of `scripts/train_parkour.py`: iterations of the
    CaT learner over the env, CSV rows and `.pt` checkpoints."""

    def __init__(self, env, learner, run_dir: str, seed: int = 0,
                 log_freq: int = 10, save_interval: int = 400):
        self.env, self.learner = env, learner
        self.run_dir, self.log_freq, self.seed = run_dir, log_freq, seed
        self.save_interval = save_interval
        os.makedirs(run_dir, exist_ok=True)
        self.world = env.init_state(seed)
        self.obs_n = learner.observe(env.get_observations(self.world))
        # the JAX script labels the columns with the parkour course's kinds
        # on either task; a map with fewer columns keeps the ones it has
        n_types = env.terrain_origins.shape[1]
        self.kind_cols = {
            k: [c for c in cols if c < n_types]
            for k, cols in column_kinds(env.cfg.terrain).items()
            if min(cols) < n_types}
        self._csv_path = os.path.join(run_dir, "metrics.csv")
        self._csv_keys = None
        self.last_stats = None

    def learn(self, iterations: int, log_fn=print):
        """Returns the per-iteration wall seconds (device work finished at
        the end of each)."""
        env, ln = self.env, self.learner
        steps_per_iter = ln.args.num_steps * env.num_envs
        it0 = ln.iteration
        t_start = time.perf_counter()
        walls = []
        for it in range(it0, it0 + iterations):
            t0 = time.perf_counter()
            self.world, self.obs_n, stats = ln.train_iteration(self.world,
                                                               self.obs_n)
            _sync(env.device)
            walls.append(time.perf_counter() - t0)
            self.last_stats = stats
            if it % self.log_freq == 0 or it == it0 + iterations - 1:
                row = self._row(it, stats, steps_per_iter / walls[-1],
                                time.perf_counter() - t_start)
                self._write_csv(row)
                by_type = " ".join(
                    f"{k[:2]}{row[f'lvl_{k}']:.1f}"
                    for k in sorted(self.kind_cols) if f"lvl_{k}" in row)
                log_fn(f"it {it:5d} | {row['steps_per_s']:.0f} steps/s | "
                       f"rew {row['mean_step_reward']:.3f} | "
                       f"lvl {row['terrain_level']:.2f} {by_type}| "
                       f"eplen {row['mean_episode_length']:.1f}s | "
                       f"vloss {row['value_loss']:.3f}")
            if self.save_interval and it > it0 and it % self.save_interval == 0:
                self.save(it)
        self.save("last")
        return walls

    def _row(self, it, stats, steps_per_s, wall_s):
        """One CSV row (scripts/train_parkour.py:215-258). The PPO+ and
        PPO-RNN learners report no terrain level, episode length,
        crossings or episode sums: 0.0 for the first two and no columns
        for the others, as the JAX script writes."""
        f = lambda k: float(stats.get(k, 0.0))
        row = {"iteration": it, "steps_per_s": steps_per_s, "wall_s": wall_s,
               "mean_step_reward": f("mean_step_reward"),
               "terrain_level": f("terrain_level_mean"),
               "mean_episode_length": f("mean_episode_length"),
               "value_loss": f("value_loss"), "pg_loss": f("pg_loss"),
               "lr": f("lr")}
        if len(self.kind_cols) > 1:
            lvl = self.world.env.terrain_level.cpu().numpy()
            typ = self.world.env.terrain_type.cpu().numpy()
            for kind, cols in sorted(self.kind_cols.items()):
                m = np.isin(typ, cols)
                row[f"lvl_{kind}"] = float(lvl[m].mean()) if m.any() else -1.0
                if "crossings_by_type" in stats:
                    d = float(stats["dones_by_type"][cols].sum())
                    row[f"cross_{kind}"] = (
                        float(stats["crossings_by_type"][cols].sum()) / d
                        if d else 0.0)
        if "episode_sums" in stats:
            ep = stats["episode_sums"].cpu().numpy()
            row["ep_rew_lin_vel"] = float(ep[0])
            row["ep_rew_ang_vel"] = float(ep[1])
            for i, name in enumerate(self.env.cstr_names):
                row[f"cstr_{name}"] = float(ep[2 + i])
        return row

    def _write_csv(self, row):
        new = self._csv_keys is None and not (
            os.path.exists(self._csv_path)
            and os.path.getsize(self._csv_path) > 0)
        if self._csv_keys is None:
            if not new:
                with open(self._csv_path, newline="") as f:
                    self._csv_keys = next(csv.reader(f))
            else:
                self._csv_keys = list(row.keys())
        with open(self._csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._csv_keys,
                               extrasaction="ignore")
            if new:
                w.writeheader()
            w.writerow(row)

    def save(self, tag):
        """Exact-resume checkpoint: learner (optimizer, normalizers, the Q
        head or the GRU hiddens included), env world and both
        generators."""
        ln, w = self.learner, self.world
        path = os.path.join(self.run_dir, f"state_{tag}.pt")
        env_state = dataclasses.asdict(w.env)
        torch.save({
            **ln.state(),
            "world": {"env": env_state, "cat": w.cat.running_max,
                      "soft_p_progress": w.soft_p_progress,
                      "hist_obs": w.hist_obs, "common_step": w.common_step,
                      "gen_state": w.gen.get_state()},
            "obs_n": self.obs_n, "cfg": self.env.cfg}, path)
        return path

    def load(self, path):
        """Restore a checkpoint of this runner's (`state_<tag>.pt`) or of
        the JAX script (`.pkl`, `.pkl.gz`)."""
        from .envs.constraints import CaTState
        from .envs.parkour_env import ParkourEnvState, ParkourWorld
        from .learn import jax_checkpoint
        from .learn.runner import load_checkpoint
        from .physics import PhysicsState
        dev = self.env.device
        blob = load_checkpoint(path, dev)
        if jax_checkpoint.is_jax_checkpoint(path):
            return self._load_jax(blob)
        self.learner.load_state(blob)
        wb = blob["world"]
        env = dict(wb["env"])
        env["phys"] = PhysicsState(**env["phys"])
        gen = torch.Generator(device=dev)
        gen.set_state(wb["gen_state"])
        self.world = ParkourWorld(
            env=ParkourEnvState(**env), cat=CaTState(running_max=wb["cat"]),
            soft_p_progress=wb["soft_p_progress"], hist_obs=wb["hist_obs"],
            common_step=wb["common_step"], gen=gen)
        self.obs_n = blob["obs_n"]
        return self

    def _load_jax(self, blob: dict):
        """The JAX script's resume (scripts/train_parkour.py:151-183). A
        slim file carries the learner, the CaT running maxima, the soft-p
        progress and the anneal clock, with the carried dones zeroed and
        every env re-seated at the file's terrain levels and types (fitted
        to this env count by `np.resize`; a level or type past this map
        takes its last, as the JAX gather clamps); a full file carries the
        learner, the world and the normalized observations. Iterations
        continue from the learner's count, which the JAX script's
        `iteration` equals."""
        from .convert import parkour_world_from_jax
        from .envs.constraints import CaTState
        from .learn import jax_checkpoint
        from .learn.cat_ppo import rms_norm
        from .learn.runner import _reseed_note
        env, ln, dev = self.env, self.learner, self.env.device
        n = env.num_envs
        slim = bool(blob.get("slim"))
        ln.load_state(jax_checkpoint.learner_state(
            blob["ts"], ln, self.seed, num_envs=n if slim else None))
        if slim:
            n_lvl, n_typ = env.terrain_origins.shape[:2]

            def fit_n(a, top):
                a = np.resize(np.asarray(a), (n,) + np.shape(a)[1:])
                return torch.from_numpy(np.minimum(a, top - 1)).to(dev)

            world = dataclasses.replace(
                self.world,
                cat=CaTState(running_max=torch.from_numpy(np.array(
                    blob["cat"].running_max, np.float32)).to(dev)),
                soft_p_progress=np.float32(np.asarray(
                    blob["soft_p_progress"])),
                common_step=int(np.asarray(blob["common_step"])))
            self.world = env.restore_terrain_state(
                world, fit_n(blob["terrain_level"], n_lvl),
                fit_n(blob["terrain_type"], n_typ))
            self.obs_n = rms_norm(ln.obs_rms,
                                  env.get_observations(self.world))
        else:
            self.world = parkour_world_from_jax(blob["world"], dev,
                                                self.seed)
            self.obs_n = torch.from_numpy(np.array(
                blob["obs_n"], np.float32)).to(dev)
        print(_reseed_note(self.seed))
        return self


def build(num_envs=4096, overrides=(), device=None, seed=0, run_dir=None,
          horizon=24, iterations=8000, anneal_iterations=None,
          terrain="mixed", easy_mode=False, soft_start=False, std_floor=0.0,
          log_freq=10, save_interval=400, task="parkour",
          reward_mode=None, algo="ppo") -> ParkourRunner:
    """The env, the learner and the runner of `scripts/train_parkour.py`:
    `algo` "ppo" (CaT PPO), "ppo_plus" or "ppornn". `overrides` are
    `field=value` strings: `ppo.*` go to the learner's args, the rest to
    ParkourCfg (on the terrain task `rough_terrain.*` sizes its map). As in
    the JAX script, `std_floor` reaches only "ppo"."""
    from .envs.parkour_env import ParkourCfg, ParkourEnv, rough_terrain_cfg
    from .learn.cat_ppo import CatPPO, CatPPOArgs
    from .learn.cat_ppo_plus import CatPPOPlus, PPOPlusArgs
    from .learn.cat_ppornn import CatPPORNN, RNNArgs
    from .models import load_robot
    from .terrain import ParkourTerrainCfg

    dev = resolve_device(device)
    if dev.type == "cuda":
        # true fp32 everywhere: TF32 is below the engine's precision
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    anneal = anneal_iterations or iterations
    extra = {}
    if task == "terrain":
        # Go2Terrain defaults (cfg/task/Go2Terrain.yaml): gait clock on,
        # actuator net on, CaT with the tracking reward by default
        extra = dict(task="terrain", use_gait_clocks=True,
                     observe_clock_inputs=True, use_actuator_net=True,
                     rough_terrain=rough_terrain_cfg())
    if reward_mode:
        extra["reward_mode"] = reward_mode
    cfg = ParkourCfg(
        num_envs=num_envs,
        # soft_p ramps over the GLOBAL horizon (chunked runs pass it)
        soft_p_total_steps=horizon * anneal,
        terrain=ParkourTerrainCfg(proportions=TERRAIN_PRESETS[terrain],
                                  easy_mode=easy_mode, soft_start=soft_start),
        **extra)
    cfg = C.apply_overrides(cfg, [s for s in overrides
                                  if not s.startswith("ppo.")])
    if algo == "ppo_plus":
        learner_cls, args = CatPPOPlus, PPOPlusArgs(
            num_steps=horizon, num_iterations=anneal)
    elif algo == "ppornn":
        learner_cls, args = CatPPORNN, RNNArgs(num_steps=horizon,
                                               num_iterations=anneal)
    else:
        learner_cls, args = CatPPO, CatPPOArgs(
            num_steps=horizon, num_iterations=anneal, std_floor=std_floor)
    args = C.apply_overrides(
        args, [s[len("ppo."):] for s in overrides if s.startswith("ppo.")])
    env = ParkourEnv(cfg, load_robot(cfg.robot), seed=seed, device=dev)
    learner = learner_cls(env, args, seed=seed)
    return ParkourRunner(env, learner,
                         run_dir or f"runs/parkour_{terrain}/seed{seed}",
                         seed=seed, log_freq=log_freq,
                         save_interval=save_interval)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--iterations", type=int, default=8000)
    ap.add_argument("--anneal-iterations", type=int, default=None,
                    help="LR-anneal horizon in global iterations (chunked "
                         "runs: the total run length)")
    ap.add_argument("--horizon", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--terrain", default="mixed", choices=TERRAIN_PRESETS)
    ap.add_argument("--task", default="parkour",
                    choices=["parkour", "terrain"])
    ap.add_argument("--algo", default="ppo",
                    choices=["ppo", "ppo_plus", "ppornn"])
    ap.add_argument("--reward-mode", default=None, choices=["cat", "full"])
    ap.add_argument("--easy-mode", action="store_true")
    ap.add_argument("--soft-start", action="store_true")
    ap.add_argument("--std-floor", type=float, default=0.0)
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--log-freq", type=int, default=10)
    ap.add_argument("--save-interval", type=int, default=400)
    ap.add_argument("--resume", default=None,
                    help="a state_<tag>.pt written by this script, or a "
                         "JAX checkpoint (.pkl, .pkl.gz) of the same --algo")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="ParkourCfg override (ppo.* for CatPPOArgs), e.g. "
                         "--set only_forwards=true --set terrain.num_levels=6")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    runner = build(args.num_envs, args.set, args.device, args.seed,
                   args.run_dir, args.horizon, args.iterations,
                   args.anneal_iterations, args.terrain, args.easy_mode,
                   args.soft_start, args.std_floor, args.log_freq,
                   args.save_interval, task=args.task,
                   reward_mode=args.reward_mode, algo=args.algo)
    if args.resume:
        runner.load(args.resume)
    env = runner.env
    print(f"{args.task} terrain={args.terrain} algo={args.algo} "
          f"envs={env.num_envs} obs={env.num_obs} device={env.device} -> "
          f"{runner.run_dir}")
    runner.learn(args.iterations)


if __name__ == "__main__":
    main()
