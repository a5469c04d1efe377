"""The port's actuator-net trainer (wtw_tpu_torch.learn.actuator_train) and
grid sweep (wtw_tpu_torch.sweep) on the CPU, against the JAX package's
`wtw_tpu/learn/actuator_train.py` and `scripts/sweep.py`.

- tests/test_eval_tools.py's synthetic fit repeated on the port (MAE under
  0.5 N m after 30 epochs);
- one epoch against JAX's from JAX's initial weights, the split and the
  epoch's permutation from numpy fed to both sides (JAX's by patching
  `jax.random.permutation`): weights at 1e-5, the test MAE at 1e-5;
- the `.npz` the port's CLI writes loads through both packages'
  `models/actuator_net.py` and gives the same torques;
- the sweep's `--dry-run` prints the JAX script's grid (the same tags, run
  dirs and overrides) with `python -m wtw_tpu_torch.train` in place of
  `scripts/train.py`, and one real 2-point sweep of go1_flat at 16 envs
  writes a summary.csv of 2 rows.
"""
import csv
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtw_tpu.learn import actuator_train as jat
from wtw_tpu.models import actuator_net as jnet

from wtw_tpu_torch import sweep
from wtw_tpu_torch.learn import actuator_train as tat
from wtw_tpu_torch.models import actuator_net as tnet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _synthetic(T=2000, nj=12, seed=0):
    """tests/test_eval_tools.py's law: tau = clip(25 err - 0.6 vel, +-20)."""
    rng = np.random.default_rng(seed)
    q_target = rng.normal(size=(T, nj)).astype(np.float32) * 0.3
    q = q_target + rng.normal(size=(T, nj)).astype(np.float32) * 0.1
    qd = rng.normal(size=(T, nj)).astype(np.float32) * 2.0
    x = tat.build_features(q_target, q, qd)
    np.testing.assert_array_equal(x, jat.build_features(q_target, q, qd))
    tau = np.clip(25.0 * x[..., 0] - 0.6 * x[..., 3], -20, 20)
    return (q_target, q, qd), x.reshape(-1, 6), tau.reshape(-1)


def test_actuator_training_fits_synthetic():
    _, xs, ys = _synthetic()
    params, mae = tat.train_actuator_network(xs, ys, epochs=30,
                                             log_fn=lambda s: None)
    assert mae < 0.5, f"actuator net did not fit, mae={mae}"
    assert set(params) == {"w0", "b0", "w1", "b1", "w2", "b2"}


def test_one_epoch_matches_jax(monkeypatch):
    _, xs, ys = _synthetic(T=400)
    n = len(ys)
    n_train = n // 5 * 4
    rng = np.random.RandomState(3)
    split, order = rng.permutation(n), rng.permutation(n_train)
    key = jax.random.PRNGKey(0)
    _, _, k_init = jax.random.split(key, 3)
    init = jax.tree.map(np.asarray, jnet.init_actuator_net(k_init))
    feed = iter([split, order])
    monkeypatch.setattr(jax.random, "permutation",
                        lambda k, m: jnp.asarray(next(feed)))
    jparams, jmae = jat.train_actuator_network(xs, ys, epochs=1,
                                               log_fn=lambda s: None)
    monkeypatch.undo()
    logs = []
    params, mae = tat.train_actuator_network(
        xs, ys, epochs=1, params=init, split=split, perms=[order],
        log_fn=logs.append)
    for k, v in jparams.items():
        np.testing.assert_allclose(params[k].numpy(), np.asarray(v),
                                   atol=1e-5, err_msg=k)
    assert mae == pytest.approx(jmae, abs=1e-5)
    assert logs[0].startswith("epoch   0 | loss ")


def test_cli_exports_a_net_both_packages_load(tmp_path):
    (q_target, q, qd), _, _ = _synthetic(T=300)
    x = tat.build_features(q_target, q, qd)
    tau = np.zeros_like(q)
    tau[4:] = np.clip(25.0 * x[..., 0] - 0.6 * x[..., 3], -20, 20)
    log = tmp_path / "episode.pkl"
    with open(log, "wb") as f:
        pickle.dump({"joint_pos_target": q_target, "joint_pos": q,
                     "joint_vel": qd, "tau_est": tau}, f)
    out = tmp_path / "net.npz"
    res = tat.main(["--log", str(log), "--out", str(out), "--epochs", "2",
                    "--device", "cpu"])
    assert res["samples"] == 296 * 12 and np.isfinite(res["mae"])
    tp = tnet.load_actuator_net(str(out))
    jp = jnet.load_actuator_net(str(out))
    feats = [np.asarray(x[:5, :, i]) for i in range(6)]
    got = tnet.apply_actuator_net(tp, *map(torch.from_numpy, feats))
    want = jnet.apply_actuator_net(jp, *map(jnp.asarray, feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert got.shape == (5, 12)


SWEEP_ARGS = ["--preset", "go1_flat", "--num-envs", "16", "--iterations",
              "1", "-a", "ppo.learning_rate=1e-3,5e-4", "-a",
              "ppo.gamma=0.99,0.95", "--set", "ppo.num_steps_per_env=2"]


def test_sweep_dry_run_prints_the_jax_grid(tmp_path):
    d = str(tmp_path / "sw")
    jax_out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "sweep.py"),
         "--dry-run", "--sweep-dir", d] + SWEEP_ARGS, capture_output=True,
        text=True, timeout=300, cwd=ROOT)
    assert jax_out.returncode == 0, jax_out.stderr[-2000:]
    port = subprocess.run(
        [sys.executable, "-m", "wtw_tpu_torch.sweep", "--dry-run",
         "--sweep-dir", d] + SWEEP_ARGS, capture_output=True, text=True,
        timeout=300, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert port.returncode == 0, port.stderr[-2000:]
    jl = [ln.split() for ln in jax_out.stdout.splitlines()]
    pl = [ln.split() for ln in port.stdout.splitlines()]
    assert jl[0] == pl[0] == ["4", "grid", "points", "over",
                              "ppo.learning_rate[2]", "x", "ppo.gamma[2]"]
    assert len(jl) == len(pl) == 5
    for j, p in zip(jl[1:], pl[1:]):
        assert j[2].endswith(os.path.join("scripts", "train.py"))
        assert p[2:4] == ["-m", "wtw_tpu_torch.train"]
        assert j[3:] == p[4:]
    assert pl[1][-1] == "ppo.gamma=0.99" and f"{d}/learning_rate1e-3_gamma0.99" \
        in pl[1]


def test_sweep_runs_two_points_on_the_cpu(tmp_path, monkeypatch):
    # the runs' subprocesses inherit one OpenMP thread (16 envs)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    d = str(tmp_path / "sw")
    narrow = ["ac.actor_hidden_dims=32,16", "ac.critic_hidden_dims=32,16",
              "ac.adaptation_hidden_dims=16", "ppo.num_steps_per_env=2"]
    cmds, rows = sweep.main(
        ["--preset", "go1_flat", "--num-envs", "16", "--iterations", "1",
         "--device", "cpu", "--sweep-dir", d,
         "-a", "ppo.learning_rate=1e-3,5e-4"]
        + [a for s in narrow for a in ("--set", s)])
    assert len(cmds) == 2 and len(rows) == 2
    with open(os.path.join(d, "summary.csv")) as f:
        summary = list(csv.DictReader(f))
    assert [r["ppo.learning_rate"] for r in summary] == ["1e-3", "5e-4"]
    assert [r["run_dir"] for r in summary] == [
        os.path.join(d, "learning_rate1e-3"),
        os.path.join(d, "learning_rate5e-4")]
    assert all(np.isfinite(float(r["mean_step_reward"])) for r in summary)
