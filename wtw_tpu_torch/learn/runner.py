"""Training driver (port of `wtw_tpu/learn/runner.py`; reference
go1_gym_learn/ppo_cse/__init__.py Runner:107-296).

Runs train iterations, writes one CSV row per logged iteration to
`<run_dir>/metrics.csv` (with `eval_rew_total` and `eval_num_episodes` when
the env splits off eval envs, and a console table of the reward terms every
`console_table_freq` iterations), and saves exact-resume checkpoints
(`checkpoints/state_<tag>.pt`: learner, optimizers, env state and both
generators) plus the deployment export `checkpoints/policy_<tag>.npz` in the
JAX runner's key layout (`adaptation/w{i}`, `actor/b{i}`, ..., weights
stored (in, out)), which `wtw_tpu/deploy/policy.py` loads unchanged.
`load` also takes the JAX runner's checkpoints (`.pkl`, `.pkl.gz`; see
`jax_checkpoint.py`). As the JAX runner does, it also writes TensorBoard
events under `<run_dir>/tb` with the same custom-scalar layout (CSV only
where `torch.utils.tensorboard` does not import), a `torch.profiler`
trace of iterations [profile_start, profile_start + profile_iters) to
`<run_dir>/profile`, and a rendered rollout `video_<it>.mp4` (or `.gif`)
every `save_video_interval` iterations (`utils/video.py`).
"""
from __future__ import annotations

import csv
import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import convert
from ..models import actor_critic as ac
from . import jax_checkpoint, ppo_cse
from .ppo_rma import RMA


@dataclass
class RunnerArgs:
    save_video_interval: int = 0          # a rendered rollout every N its
    log_freq: int = 10
    save_interval: int = 400
    run_dir: str = "runs/default"
    resume: bool = False
    resume_path: Optional[str] = None
    tensorboard: bool = True              # events under <run_dir>/tb
    # torch.profiler trace of iterations [profile_start, profile_start +
    # profile_iters) into <run_dir>/profile (-1: off)
    profile_start: int = -1
    profile_iters: int = 3
    console_table_freq: int = 0           # the reward terms as a table


# the JAX runner's TensorBoard "Custom Scalars" layout (the reference's
# .charts.yml dashboard, scripts/go1/train.py:227-253)
TB_LAYOUT = {
    "training": {
        "episode reward": ["Multiline", ["rew_total"]],
        "tracking": ["Multiline", [
            "rew_tracking_lin_vel", "rew_tracking_ang_vel"]],
        "gait shaping": ["Multiline", [
            "rew_tracking_contacts_shaped_force",
            "rew_tracking_contacts_shaped_vel", "rew_orientation_control"]],
        "smoothness": ["Multiline", [
            "rew_action_smoothness_1", "rew_action_smoothness_2",
            "rew_dof_pos"]],
        "adaptation loss": ["Multiline", ["adaptation_loss"]],
    },
    "optimization": {
        "losses": ["Multiline", ["value_loss", "surrogate_loss"]],
        "kl / lr": ["Multiline", ["kl_mean", "lr"]],
        "throughput": ["Multiline", ["steps_per_s"]],
    },
    "eval": {
        "train vs eval reward": ["Multiline", ["rew_total",
                                               "eval_rew_total"]],
    },
}


def _summary_writer(run_dir: str):
    """A SummaryWriter on <run_dir>/tb with TB_LAYOUT, or None where
    `torch.utils.tensorboard` (or its `tensorboard` package) is absent."""
    try:
        from torch.utils.tensorboard import SummaryWriter
        tb = SummaryWriter(os.path.join(run_dir, "tb"))
        tb.add_custom_scalars(TB_LAYOUT)
        return tb
    except Exception:
        return None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def world_blob(world) -> dict:
    """WorldState -> a torch.save-able dict (the generator as its state).
    A wrapped env's world, (WorldState, wrapper state), keeps the wrapper
    state under "wrapper"."""
    if isinstance(world, tuple):
        world, ws = world
        return {**world_blob(world), "wrapper": dataclasses.asdict(ws)}
    return {"env": dataclasses.asdict(world.env),
            "curriculum_weights": world.curriculum_weights,
            "obs_history": world.obs_history,
            "gravity_offset": world.gravity_offset,
            "common_step": world.common_step,
            "gen_state": world.gen.get_state()}


def world_from_blob(blob: dict, device):
    from ..envs.legged_env import EnvState, WorldState
    from ..physics import PhysicsState
    if "wrapper" in blob:
        from ..envs.wrappers import ActuatorModelState
        blob = dict(blob)
        ws = ActuatorModelState(**blob.pop("wrapper"))
        return world_from_blob(blob, device), ws
    env = dict(blob["env"])
    env["phys"] = PhysicsState(**env["phys"])
    gen = torch.Generator(device=device)
    gen.set_state(blob["gen_state"])
    return WorldState(env=EnvState(**env),
                      curriculum_weights=blob["curriculum_weights"],
                      obs_history=blob["obs_history"],
                      gravity_offset=blob["gravity_offset"],
                      common_step=blob["common_step"], gen=gen)


def load_checkpoint(path: str, device) -> dict:
    """`torch.load` of one of the port's own checkpoints, or the blob of a
    JAX one (`.pkl`, `.pkl.gz`: numpy arrays and records,
    `jax_checkpoint.load`)."""
    if jax_checkpoint.is_jax_checkpoint(path):
        return jax_checkpoint.load(path)
    return torch.load(path, map_location=device, weights_only=False)


def _no_jax_state(path: str, what: str):
    if jax_checkpoint.is_jax_checkpoint(path):
        raise ValueError(f"{path}: the JAX package writes no {what} state to "
                         f"resume (scripts/train.py); resume from the port's "
                         f"own .pt")


def _reseed_note(seed: int) -> str:
    return (f"resumed a JAX checkpoint: the generators restart from seed "
            f"{seed} (a JAX PRNG key has no torch counterpart)")


class Runner:
    def __init__(self, env, args: ppo_cse.PPOArgs = ppo_cse.PPOArgs(),
                 ac_args: ac.ACArgs = ac.ACArgs(),
                 runner_args: RunnerArgs = RunnerArgs(), seed: int = 0):
        self.env, self.args, self.runner_args = env, args, runner_args
        self.seed = seed
        self.world = env.init_state(seed)
        self.world, self.obs_dict = env.get_observations(self.world)
        self.ppo = ppo_cse.PPO(env, args, ac_args, seed=seed)
        os.makedirs(os.path.join(runner_args.run_dir, "checkpoints"),
                    exist_ok=True)
        self._csv_path = os.path.join(runner_args.run_dir, "metrics.csv")
        self._csv_keys = None
        self._tb = (_summary_writer(runner_args.run_dir)
                    if runner_args.tensorboard else None)
        self.last_stats = None
        if runner_args.resume and runner_args.resume_path:
            self.load(runner_args.resume_path)

    def _profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.env.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        return prof

    def learn(self, num_learning_iterations: int, log_fn=print):
        """ppo_cse/__init__.py:107-229 analog. Returns the per-iteration
        wall seconds (device work finished at the end of each)."""
        ra, dev = self.runner_args, self.env.device
        steps_per_iter = self.args.num_steps_per_env * self.env.num_envs
        it0 = self.ppo.iteration
        t_start = time.perf_counter()
        walls = []
        prof = None
        for it in range(it0, it0 + num_learning_iterations):
            t0 = time.perf_counter()
            if it == ra.profile_start:
                prof = self._profiler()
            self.world, self.obs_dict, stats = self.ppo.train_iteration(
                self.world, self.obs_dict)
            _sync(dev)
            walls.append(time.perf_counter() - t0)
            if prof is not None and (
                    it == ra.profile_start + ra.profile_iters - 1
                    or it == it0 + num_learning_iterations - 1):
                prof.__exit__(None, None, None)
                out = os.path.join(ra.run_dir, "profile")
                os.makedirs(out, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    out, f"trace_{ra.profile_start}.json"))
                prof = None
                log_fn(f"profiler trace -> {out}")
            self.last_stats = stats
            if it % ra.log_freq == 0 or it == it0 + num_learning_iterations - 1:
                f = lambda k: float(stats[k])
                row = {
                    "iteration": it,
                    "steps_per_s": steps_per_iter / walls[-1],
                    "total_env_steps": (it + 1) * steps_per_iter,
                    "wall_s": time.perf_counter() - t_start,
                    "mean_step_reward": f("mean_step_reward"),
                    "num_episodes": f("num_episodes"),
                    "value_loss": f("value_loss"),
                    "surrogate_loss": f("surrogate_loss"),
                    "adaptation_loss": f("adaptation_loss"),
                    "kl_mean": f("kl_mean"),
                    "lr": f("lr"),
                }
                ep = stats["episode_reward_sums"].cpu().numpy()
                for i, name in enumerate(self.env.reward_names):
                    row[f"rew_{name}"] = float(ep[i])
                row["rew_total"] = float(ep[-1])
                # the eval stream (ppo_cse/__init__.py:163-180)
                if getattr(self.env, "num_eval_envs", 0) > 0:
                    row["eval_rew_total"] = float(
                        stats["eval_episode_reward_sums"][-1])
                    row["eval_num_episodes"] = f("eval_num_episodes")
                self._write_csv(row)
                if self._tb is not None:
                    for k, v in row.items():
                        if k != "iteration":
                            self._tb.add_scalar(k, v, it)
                    self._tb.flush()
                log_fn(f"it {it:6d} | {row['steps_per_s']:.0f} steps/s | "
                       f"rew {row['mean_step_reward']:.4f} | "
                       f"ep_rew {row['rew_total']:.2f} | "
                       f"vloss {row['value_loss']:.4f} | "
                       f"adapt {row['adaptation_loss']:.5f}")
                if ra.console_table_freq and it % ra.console_table_freq == 0:
                    from ..utils.monitor import monitor_table
                    log_fn(monitor_table(
                        {k: v for k, v in row.items()
                         if k.startswith("rew_")}, title=f"iter {it}"))
            if ra.save_interval and it % ra.save_interval == 0 and it > 0:
                self.save(it)
            if ra.save_video_interval and it % ra.save_video_interval == 0 \
                    and it > 0:
                self.record_video(tag=it)
        self.save("last")
        return walls

    def record_video(self, tag="last", steps: int = 250) -> str:
        """Record and render a rollout of the current student policy (the
        reference's camera mp4 every save_video_interval,
        ppo_cse/__init__.py:277-296); -> the file written."""
        from ..utils.video import record_rollout, render_trajectory
        policy = self.get_inference_policy()
        traj = record_rollout(
            self.env, lambda obs: policy(obs["obs_history"]), steps=steps)
        path = os.path.join(self.runner_args.run_dir, f"video_{tag}.mp4")
        return render_trajectory(traj, self.env.model, hf=self.env.hf,
                                 path=path)

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
        """Exact-resume checkpoint + deployment export."""
        ck = os.path.join(self.runner_args.run_dir, "checkpoints")
        path = os.path.join(ck, f"state_{tag}.pt")
        p = self.ppo
        torch.save({**p.state(), "world": world_blob(self.world),
                    "obs_dict": self.obs_dict, "cfg": self.env.cfg}, path)
        export = {}
        for net in ("adaptation", "actor"):
            lins = [m for m in getattr(p.ac, net)
                    if isinstance(m, torch.nn.Linear)]
            for i, lin in enumerate(lins):
                export[f"{net}/w{i}"] = lin.weight.detach().T.cpu().numpy()
                export[f"{net}/b{i}"] = lin.bias.detach().cpu().numpy()
        np.savez(os.path.join(ck, f"policy_{tag}.npz"), **export)
        return path

    def load(self, path):
        """Restore a checkpoint of the port's own (`state_<tag>.pt`), or a
        JAX runner's (`.pkl`, `.pkl.gz`)."""
        blob = load_checkpoint(path, self.env.device)
        if jax_checkpoint.is_jax_checkpoint(path):
            return self._load_jax(blob)
        self.ppo.load_state(blob)
        world = world_from_blob(blob["world"], self.env.device)
        # a run that adds or drops the actuator-model wrapper starts or
        # drops the wrapper's state
        wrapped = hasattr(self.env, "init_wrapper_state")
        if wrapped and not isinstance(world, tuple):
            world = (world, self.env.init_wrapper_state())
        elif not wrapped and isinstance(world, tuple):
            world = world[0]
        self.world = world
        self.obs_dict = blob["obs_dict"]
        return self

    def _load_jax(self, blob: dict):
        """The JAX runner's `load` (`wtw_tpu/learn/runner.py:240-270`): the
        learner state (the adaptive lr and the iteration included; the
        pre-round-3 adaptation moments migrated); a slim file
        (`tools/slim_checkpoint.py`) carries the curriculum weights and the
        reward-anneal clock onto fresh envs, whose observations are
        recomputed; a full file carries the world and its observations."""
        env, dev = self.env, self.env.device
        self.ppo.load_state(jax_checkpoint.learner_state(
            blob["ts"], self.ppo, self.seed))
        wrapped = hasattr(env, "init_wrapper_state")
        if blob.get("slim"):
            world = self.world[0] if wrapped else self.world
            world = dataclasses.replace(
                world, curriculum_weights=torch.from_numpy(np.array(
                    blob["curriculum"].weights, np.float32)).to(dev),
                common_step=int(np.asarray(blob["common_step"])))
            if wrapped:
                world = (world, self.world[1])
            self.world, self.obs_dict = env.get_observations(world)
        else:
            jw = blob["world"]
            world = convert.world_from_jax(
                jw[0] if isinstance(jw, tuple) else jw, dev, self.seed)
            if wrapped:
                world = (world, convert.actuator_state_from_jax(jw[1], dev)
                         if isinstance(jw, tuple)
                         else env.init_wrapper_state())
            self.world = world
            self.obs_dict = {k: torch.from_numpy(np.array(
                v, np.float32)).to(dev) for k, v in blob["obs_dict"].items()}
        print(_reseed_note(self.seed))
        return self

    def get_inference_policy(self):
        """Student policy fn(obs_history) -> actions."""
        model = self.ppo.ac

        @torch.no_grad()
        def policy(obs_history):
            return model.act_student(obs_history)[0]
        return policy


class RMARunner:
    """The `--algo rma` loop of `scripts/train.py`: iterations of the RMA
    learner, the JAX script's line every `log_freq` iterations, and the
    exact-resume state `<run_dir>/rma_state.pt` at the end."""

    def __init__(self, env, args: ppo_cse.PPOArgs = ppo_cse.PPOArgs(),
                 run_dir: str = "runs/rma", seed: int = 0, log_freq: int = 10,
                 resume: Optional[str] = None):
        self.env, self.args = env, args
        self.run_dir, self.log_freq = run_dir, log_freq
        self.world = env.init_state(seed)
        self.world, self.obs_dict = env.get_observations(self.world)
        self.learner = RMA(env, args, seed=seed)
        self.last_stats = None
        os.makedirs(run_dir, exist_ok=True)
        if resume:
            self.load(resume)

    def learn(self, iterations: int, log_fn=print):
        """Returns the per-iteration wall seconds (device work finished at
        the end of each)."""
        ln, dev = self.learner, self.env.device
        it0 = ln.iteration
        walls = []
        for it in range(it0, it0 + iterations):
            t0 = time.perf_counter()
            self.world, self.obs_dict, stats = ln.train_iteration(
                self.world, self.obs_dict)
            _sync(dev)
            walls.append(time.perf_counter() - t0)
            self.last_stats = stats
            if it % self.log_freq == 0 or it == it0 + iterations - 1:
                log_fn(f"it {it:6d} | rew {float(stats['mean_step_reward']):.4f}"
                       f" | vloss {float(stats['value_loss']):.4f}"
                       f" | adapt {float(stats['adaptation_loss']):.5f}")
        self.save()
        return walls

    def save(self):
        path = os.path.join(self.run_dir, "rma_state.pt")
        torch.save({**self.learner.state(), "world": world_blob(self.world),
                    "obs_dict": self.obs_dict, "cfg": self.env.cfg}, path)
        return path

    def load(self, path):
        _no_jax_state(path, "RMA")
        blob = load_checkpoint(path, self.env.device)
        self.learner.load_state(blob)
        self.world = world_from_blob(blob["world"], self.env.device)
        self.obs_dict = blob["obs_dict"]
        return self
