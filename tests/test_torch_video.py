"""The port's video recorder and renderer (`wtw_tpu_torch/utils/video.py`)
and the runner's `save_video_interval`, `profile_start` and `tensorboard`,
held against the JAX package on the CPU.

- `_leg_chains` equal to JAX's for the four robots;
- the skeleton points (forward kinematics) of each frame against JAX's
  `engine.fk` at 1e-5;
- one `Trajectory` rendered by both packages: GIFs here (no ffmpeg), the
  same frame count, and at most 0.1% of the decoded pixels differing;
- `record_rollout` over 4 policy steps of go1_flat (4 envs, observation
  noise off, every env's command pinned) from the JAX env's initial world
  carried across (`world_from_jax`), under one linear policy on both
  sides, JAX un-jitted on its XLA physics path: the recorded trajectory
  within 1e-3 (the bar tests/test_parallel.py uses for chained states);
- `Runner` with `save_video_interval=1` writing `video_1.*` after 2
  iterations, `profile_start=0` writing a trace, and `tensorboard=True`
  running (CSV only) where `torch.utils.tensorboard` does not import.
"""
import dataclasses
import glob
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtw_tpu import config as jcfg
from wtw_tpu.envs import LeggedEnv as JaxLeggedEnv
from wtw_tpu.models import load_robot as jax_load_robot
from wtw_tpu.physics import engine as jengine
from wtw_tpu.physics import flat_heightfield as jax_flat_hf
from wtw_tpu.utils import video as jvideo

from wtw_tpu_torch import config as tcfg
from wtw_tpu_torch.convert import world_from_jax
from wtw_tpu_torch.envs import LeggedEnv
from wtw_tpu_torch.models import load_robot
from wtw_tpu_torch.physics import flat_heightfield
from wtw_tpu_torch.physics.engine import fk
from wtw_tpu_torch.utils import video as tvideo

ROBOTS = {"go1": "go1", "go2": "go2", "b1": "b1",
          "mini_cheetah": "mini_cheetah"}


def _trajectory(model, T=6, seed=0) -> tvideo.Trajectory:
    rng = np.random.RandomState(seed)
    q = np.tile(np.float32([0.0, 0.8, -1.6]), 4)
    quat = rng.randn(T, 4).astype(np.float32) * 0.05
    quat[:, 0] += 1.0
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    return tvideo.Trajectory(
        base_pos=(np.array([0.0, 0.0, 0.3], np.float32)
                  + 0.02 * rng.randn(T, 3)).astype(np.float32)
        + np.arange(T, dtype=np.float32)[:, None] * [0.01, 0.0, 0.0],
        base_quat=quat,
        joint_q=(q + 0.3 * rng.randn(T, model.nj)).astype(np.float32))


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_leg_chains_match_jax(robot):
    chains = tvideo._leg_chains(load_robot(robot))
    assert chains == jvideo._leg_chains(jax_load_robot(robot))
    assert len(chains) == 4 and all(c[0] == 0 for c in chains)


def test_skeleton_points_match_jax_fk():
    model, jmodel = load_robot("go1"), jax_load_robot("go1")
    tr = _trajectory(model)
    for t in range(len(tr.base_pos)):
        got = fk(model, *(torch.from_numpy(x[t]) for x in (
            tr.base_pos, tr.base_quat, tr.joint_q)))[0]
        want = jengine.fk(jmodel, jnp.asarray(tr.base_pos[t]),
                          jnp.asarray(tr.base_quat[t]),
                          jnp.asarray(tr.joint_q[t]))[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_render_matches_jax(tmp_path):
    """The same trajectory through both renderers, over a flat field: GIFs
    with the same frame count, at most 0.1% of the pixels differing."""
    from PIL import Image, ImageSequence
    model = load_robot("go1")
    tr = _trajectory(model)
    jtr = jvideo.Trajectory(tr.base_pos, tr.base_quat, tr.joint_q)
    got = tvideo.render_trajectory(tr, model, hf=flat_heightfield(),
                                   path=str(tmp_path / "port.mp4"))
    want = jvideo.render_trajectory(jtr, jax_load_robot("go1"),
                                    hf=jax_flat_hf(),
                                    path=str(tmp_path / "jax.mp4"))
    frames = []
    for path in (got, want):
        with Image.open(path) as im:
            frames.append([np.asarray(f.convert("RGB"))
                           for f in ImageSequence.Iterator(im)])
    assert len(frames[0]) == len(frames[1]) == 3
    diff = np.mean([np.any(a != b, axis=-1).mean()
                    for a, b in zip(*frames)])
    print(f"pixels differing: {diff:.6f}")
    assert diff <= 1e-3


def _go1(module, n):
    cfg = module.go1_flat_config(num_envs=n)
    return dataclasses.replace(cfg, noise=dataclasses.replace(
        cfg.noise, add_noise=False))


def test_record_rollout_matches_jax(monkeypatch):
    N, steps = 4, 4
    jenv = JaxLeggedEnv(_go1(jcfg, N), jax_load_robot("go1"),
                        physics_backend="xla")
    tenv = LeggedEnv(_go1(tcfg, N), load_robot("go1"), device="cpu")
    with jax.disable_jit():
        jworld0 = jenv.init_state(jax.random.PRNGKey(0))
    monkeypatch.setattr(tenv, "init_state", lambda seed: world_from_jax(
        jax.tree.map(np.asarray, jworld0)))
    w = (0.01 * np.random.RandomState(1).randn(tenv.num_obs_history, 12)
         ).astype(np.float32)
    cmd = np.zeros(tcfg.go1_flat_config().commands.num_commands, np.float32)
    cmd[0] = 0.5
    with jax.disable_jit():
        want = jvideo.record_rollout(
            jenv, lambda o: jnp.tanh(o["obs_history"] @ jnp.asarray(w)),
            steps=steps, env_index=1, commands=cmd)
    got = tvideo.record_rollout(
        tenv, lambda o: torch.tanh(o["obs_history"] @ torch.from_numpy(w)),
        steps=steps, env_index=1, commands=cmd)
    for f in ("base_pos", "base_quat", "joint_q"):
        g, v = getattr(got, f), np.asarray(getattr(want, f))
        assert g.shape == v.shape == (steps,) + v.shape[1:]
        np.testing.assert_allclose(g, v, atol=1e-3, err_msg=f)


def _runner(tmp_path, **ra):
    from wtw_tpu_torch.learn import PPOArgs, Runner, RunnerArgs
    from wtw_tpu_torch.models.actor_critic import ACArgs
    env = LeggedEnv(tcfg.go1_flat_config(num_envs=4), load_robot("go1"),
                    device="cpu")
    narrow = ACArgs(actor_hidden_dims=(16,), critic_hidden_dims=(16,),
                    adaptation_hidden_dims=(8,))
    return Runner(env, PPOArgs(num_steps_per_env=2, num_learning_epochs=1,
                               num_mini_batches=1), narrow,
                  RunnerArgs(run_dir=str(tmp_path), log_freq=1,
                             save_interval=0, **ra))


def test_runner_writes_video_and_profile(tmp_path, monkeypatch):
    """save_video_interval=1: a rendered rollout after iteration 1 (a
    shortened recording: 4 steps); profile_start=0, profile_iters=1: a
    chrome trace under <run_dir>/profile."""
    from wtw_tpu_torch.learn import runner as trunner
    real = trunner.Runner.record_video
    monkeypatch.setattr(trunner.Runner, "record_video",
                        lambda self, tag="last", steps=250: real(self, tag,
                                                                 4))
    r = _runner(tmp_path, save_video_interval=1, profile_start=0,
                profile_iters=1, tensorboard=False)
    lines = []
    r.learn(2, log_fn=lines.append)
    videos = glob.glob(str(tmp_path / "video_*"))
    assert [os.path.basename(v).split(".")[0] for v in videos] == ["video_1"]
    assert os.path.getsize(videos[0]) > 0
    traces = glob.glob(str(tmp_path / "profile" / "*.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    assert any(line.startswith("profiler trace -> ") for line in lines)
    assert not os.path.exists(tmp_path / "tb")


def test_runner_tensorboard_falls_back_to_csv(tmp_path, monkeypatch):
    """tensorboard=True where `torch.utils.tensorboard` does not import:
    the run goes on with the CSV only, as the JAX runner's does."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    r = _runner(tmp_path, tensorboard=True)
    assert r._tb is None
    r.learn(1, log_fn=lambda *a: None)
    assert os.path.getsize(tmp_path / "metrics.csv") > 0
    assert not os.path.exists(tmp_path / "tb")
