"""Parity of the port's PPO+ and PPO-RNN learners (wtw_tpu_torch.learn
.cat_ppo_plus / .cat_ppornn, on the CPU) against the JAX package, and the
parkour CLI with `--algo ppo_plus|ppornn`.

Weights go across with `convert.plus_params_from_jax` /
`rnn_params_from_jax`; every draw comes from numpy with a seed and is fed
to both sides (the JAX side by patching `jax.random.normal` and
`jax.random.permutation`, served in the order the JAX learner draws them).
One train iteration runs on a scripted env, a duck-typed stub whose step
returns numpy-made observations (moved by the actions), rewards, soft
dones and one hard done (env 2 at step 1 of 3), so the recurrent
learner's hard-done masks are exercised; and once on the real parkour env
(un-jitted, the JAX package's XLA physics path, draws off).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtw_tpu.envs.parkour_env import ParkourCfg as JaxParkourCfg
from wtw_tpu.envs.parkour_env import ParkourEnv as JaxParkourEnv
from wtw_tpu.learn import cat_ppo as jcat
from wtw_tpu.learn import cat_ppo_plus as jplus
from wtw_tpu.learn import cat_ppornn as jrnn
from wtw_tpu.models import load_robot as jax_load_robot
from wtw_tpu.terrain import ParkourTerrainCfg as JaxTerrainCfg

from wtw_tpu_torch.convert import (parkour_world_from_jax,
                                   plus_params_from_jax, rnn_params_from_jax)
from wtw_tpu_torch.envs.parkour_env import ParkourCfg, ParkourEnv
from wtw_tpu_torch.learn import cat_ppo_plus as tplus
from wtw_tpu_torch.learn import cat_ppornn as trnn
from wtw_tpu_torch.models import load_robot
from wtw_tpu_torch.terrain import ParkourTerrainCfg

SMALL = dict(num_levels=3, num_terrains=5, border_size=4.0)
HIDDEN = (32, 16)
np_tree = lambda tree: jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the heads
# ---------------------------------------------------------------------------


def test_q_head_and_gru_cell_forward_match_jax():
    """Converted weights at full width: the Q head (201-512-256-128-1) and
    both GRU memories (189 -> 256) with the heads over [gru_out, obs], at
    1e-6 absolute."""
    rng = np.random.RandomState(0)
    O, A, N = 189, 12, 16
    obs = rng.randn(N, O).astype(np.float32)
    act = rng.randn(N, A).astype(np.float32)
    h = rng.randn(2, N, 256).astype(np.float32)

    pargs = jplus.PPOPlusArgs()
    params = jplus.init_plus_agent(jax.random.PRNGKey(0), O, A, pargs)
    agent = tplus.PlusAgent(O, A)
    agent.load_state_dict(plus_params_from_jax(np_tree(params)))
    with torch.no_grad():
        q = agent.q_value(torch.from_numpy(obs), torch.from_numpy(act))
    np.testing.assert_allclose(
        q.numpy(), np.asarray(jplus.q_value(params, obs, act)), atol=1e-6)

    rparams = jrnn.init_agent(jax.random.PRNGKey(1), O, A, jrnn.RNNArgs())
    ragent = trnn.RNNAgent(O, A)
    ragent.load_state_dict(rnn_params_from_jax(np_tree(rparams)))
    want = jrnn.forward(rparams, jnp.asarray(obs), jnp.asarray(h[0]),
                        jnp.asarray(h[1]))
    with torch.no_grad():
        got = ragent(torch.from_numpy(obs), torch.from_numpy(h[0]),
                     torch.from_numpy(h[1]))
        cell = ragent.actor_memory(torch.from_numpy(obs),
                                   torch.from_numpy(h[0]))
    np.testing.assert_allclose(
        cell.numpy(), np.asarray(jrnn.gru_cell(rparams["actor_memory"], obs,
                                               h[0])), atol=1e-6)
    for g, w, name in zip(got, want, ("mean", "value", "ac_h", "cr_h")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   err_msg=name)


def test_improve_actions_matches_jax(monkeypatch):
    """Two rounds of 8 perturbations on 16 actions, the standard normal
    draws fed to both sides: improved actions at 1e-5, and Q rises on
    average (tests/test_learners.py's check)."""
    args = jplus.PPOPlusArgs(n_perturbations=8, sigma=0.1, alpha=0.5,
                             num_improvement_steps=2, hidden=HIDDEN)
    O, A, N = 10, 4, 16
    params = jplus.init_plus_agent(jax.random.PRNGKey(0), O, A, args)
    agent = tplus.PlusAgent(O, A, HIDDEN)
    agent.load_state_dict(plus_params_from_jax(np_tree(params)))
    rng = np.random.RandomState(1)
    obs = rng.randn(N, O).astype(np.float32)
    a0 = rng.randn(N, A).astype(np.float32)
    noise = rng.randn(2, 8, N, A).astype(np.float32)
    feed = iter(noise)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jnp.asarray(next(feed)))
    with jax.disable_jit():
        want = jplus.improve_actions(params, jax.random.PRNGKey(3),
                                     jnp.asarray(obs), jnp.asarray(a0), args)
    monkeypatch.undo()
    with torch.no_grad():
        got = tplus.improve_actions(agent, torch.from_numpy(obs),
                                    torch.from_numpy(a0),
                                    torch.from_numpy(noise), args)
        q0 = agent.q_value(torch.from_numpy(obs), torch.from_numpy(a0))
        q1 = agent.q_value(torch.from_numpy(obs), got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(q1.mean()) > float(q0.mean())


# ---------------------------------------------------------------------------
# one train iteration on a scripted env
# ---------------------------------------------------------------------------

T, NS, OS, AS = 3, 8, 6, 4      # the stub's steps, envs, obs, actions
HARD_ENV, HARD_STEP = 2, 1


class _Script:
    """The stub's numpy tables: step t returns obs[t] + tanh(a) @ M,
    rew[t] - 0.01 |a|^2, soft dones in [0, 0.3] and the hard dones."""

    def __init__(self, seed=0):
        rng = np.random.RandomState(seed)
        f = lambda *s: rng.randn(*s).astype(np.float32)
        self.obs0, self.obs = f(NS, OS), f(T, NS, OS)
        self.m = 0.1 * f(AS, OS)
        self.rew = f(T, NS)
        self.done = rng.uniform(0, 0.3, (T, NS)).astype(np.float32)
        self.hard = np.zeros((T, NS), bool)
        self.hard[HARD_STEP, HARD_ENV] = True


class _JaxStub:
    num_envs, num_obs, num_actions = NS, OS, AS

    def __init__(self, s):
        self.s = s

    def step(self, t, a):
        s = self.s
        obs = jnp.asarray(s.obs)[t] + jnp.tanh(a) @ jnp.asarray(s.m)
        rew = jnp.asarray(s.rew)[t] - 0.01 * jnp.sum(a * a, -1)
        return (t + 1, obs, rew, jnp.asarray(s.done)[t],
                {"true_dones": jnp.asarray(s.hard)[t]})


class _TorchStub:
    num_envs, num_obs, num_actions = NS, OS, AS
    device, dt = torch.device("cpu"), 0.02

    def __init__(self, s):
        self.s = s

    def step(self, t, a):
        s = self.s
        obs = torch.from_numpy(s.obs[t]) + torch.tanh(a) @ torch.from_numpy(
            s.m)
        rew = torch.from_numpy(s.rew[t]) - 0.01 * (a * a).sum(-1)
        z = torch.zeros(())
        info = {"true_dones": torch.from_numpy(s.hard[t]),
                "episode_sums_at_reset": torch.zeros(2), "num_resets": z,
                "episode_len_at_reset": z, "crossings_by_type": torch.zeros(2),
                "dones_by_type": torch.zeros(2), "terrain_level_mean": z}
        return t + 1, obs, rew, torch.from_numpy(s.done[t]), info


def _draws(algo, rng, n, n_act, epochs, perm_n, args):
    """(action noise (T, n, A), improvement noise or None, permutations)
    from numpy, and the JAX learner's draws in its order."""
    noise = (0.5 * rng.randn(args.num_steps, n, n_act)).astype(np.float32)
    imp = None
    jax_normals = list(noise)
    if algo == "ppo_plus":
        imp = rng.randn(args.num_steps, args.num_improvement_steps,
                        args.n_perturbations, n, noise.shape[-1]).astype(
                            np.float32)
        jax_normals = [x for t in range(args.num_steps)
                       for x in [noise[t]] + list(imp[t])]
    perms = np.stack([rng.permutation(perm_n) for _ in range(epochs)])
    return noise, imp, perms, jax_normals


def _run_both(algo, jenv, tenv, jworld, tworld, jobs, tobs, monkeypatch,
              T_=T, epochs=2, mbs=2, h0=None):
    """One iteration of `algo` on both sides from the same weights and
    draws; -> (JAX state, JAX stats, port learner, port stats)."""
    common = dict(num_steps=T_, num_iterations=10, update_epochs=epochs,
                  num_minibatches=mbs, hidden=HIDDEN)
    n = jenv.num_envs
    if algo == "ppo_plus":
        jmod, tcls = jplus, tplus.CatPPOPlus
        jargs = jplus.PPOPlusArgs(n_perturbations=4, **common)
        targs = tplus.PPOPlusArgs(n_perturbations=4, **common)
        convert, perm_n = plus_params_from_jax, T_ * n
    else:
        jmod, tcls = jrnn, trnn.CatPPORNN
        jargs = jrnn.RNNArgs(rnn_hidden_dim=16, **common)
        targs = trnn.RNNArgs(rnn_hidden_dim=16, **common)
        convert, perm_n = rnn_params_from_jax, n
    rng = np.random.RandomState(4)
    noise, imp, perms, jax_normals = _draws(algo, rng, n, jenv.num_actions,
                                            epochs, perm_n, jargs)

    ts = jmod.init_train_state(jax.random.PRNGKey(1), jenv, jargs)
    ts = ts.replace(obs_rms=jcat.rms_update(ts.obs_rms, jnp.asarray(jobs)))
    obs_n = jcat.rms_norm(ts.obs_rms, jnp.asarray(jobs))
    learner = tcls(tenv, targs)
    learner.agent.load_state_dict(convert(np_tree(ts.params)))
    tobs_n = learner.observe(tobs)
    if h0 is not None:
        ts = ts.replace(ac_hidden=jnp.asarray(h0[0]),
                        cr_hidden=jnp.asarray(h0[1]))
        learner.ac_hidden, learner.cr_hidden = map(torch.from_numpy, h0)

    feed = {"normal": iter(jax_normals), "permutation": iter(perms)}
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jnp.asarray(next(feed["normal"])))
    monkeypatch.setattr(
        jax.random, "permutation",
        lambda key, m: jnp.asarray(next(feed["permutation"])))
    with jax.disable_jit():
        ts, _, _, jstats = jmod.make_train_fn(jenv, jargs)(ts, jworld, obs_n)
    monkeypatch.undo()
    assert next(feed["normal"], None) is None      # every draw was served
    draws = {"improve_noise": torch.from_numpy(imp)} if imp is not None else {}
    _, _, tstats = learner.train_iteration(
        tworld, tobs_n, noise=torch.from_numpy(noise),
        perms=torch.from_numpy(perms), **draws)
    return ts, jstats, learner, tstats, convert


def _check(ts, jstats, learner, tstats, convert, keys):
    """Weights and normalizers at 1e-5 absolute, losses at 1e-4 relative,
    the carried GRU hiddens at 1e-5."""
    got = learner.agent.state_dict()
    for k, v in convert(np_tree(ts.params)).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=k)
    for s_t, s_j in ((learner.obs_rms, ts.obs_rms),
                     (learner.value_rms, ts.value_rms)):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(s_t, f).numpy(),
                                       np.asarray(getattr(s_j, f)),
                                       rtol=1e-5, atol=1e-5, err_msg=f)
    for k in keys:
        assert float(tstats[k]) == pytest.approx(float(jstats[k]), rel=1e-4,
                                                 abs=1e-6), k
    assert set(tstats) == set(jstats)
    assert float(tstats["lr"]) == pytest.approx(float(jstats["lr"]))
    assert learner.iteration == int(ts.iteration) == 1
    for a, b in ((learner.next_done, ts.next_done),
                 (learner.next_true_done, ts.next_true_done)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    if hasattr(ts, "ac_hidden"):
        for a, b in ((learner.ac_hidden, ts.ac_hidden),
                     (learner.cr_hidden, ts.cr_hidden)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


LOSS_KEYS = {"ppo_plus": ("loss", "pg_loss", "value_loss", "q_loss",
                          "mean_step_reward"),
             "ppornn": ("loss", "pg_loss", "value_loss", "mean_step_reward")}


@pytest.mark.parametrize("algo", ["ppo_plus", "ppornn"])
def test_iteration_on_scripted_env_matches_jax(algo, monkeypatch):
    """One train iteration (3 steps x 8 envs, a hard done for env 2 at step
    1; 2 epochs x 2 minibatches) on the scripted env, from random
    iteration-start hiddens for the GRUs. The recurrent replay zeroes the
    hiddens one step after the rollout did (the JAX learner's mask), so the
    first update's ratio is not 1 on env 2's last step: the port must
    compute the same."""
    s = _Script()
    h0 = (0.5 * np.random.RandomState(2).randn(2, NS, 16)).astype(np.float32)
    ts, jstats, learner, tstats, convert = _run_both(
        algo, _JaxStub(s), _TorchStub(s), jnp.int32(0), 0, s.obs0,
        torch.from_numpy(s.obs0), monkeypatch,
        h0=h0 if algo == "ppornn" else None)
    _check(ts, jstats, learner, tstats, convert, LOSS_KEYS[algo])
    if algo == "ppornn":
        # every env's carried hiddens are nonzero (env 2's restarted from
        # zero after its hard done)
        assert bool((learner.ac_hidden.abs().sum(1) > 0).all())


def test_rnn_replay_masks_one_step_late():
    """The property of the JAX learner the port reproduces: from the same
    weights, the replay's action means equal the rollout's until the step
    after a hard done, where the rollout had zeroed the env's hiddens and
    the replay has not yet; every other env's means are equal."""
    s = _Script()
    env = _TorchStub(s)
    args = trnn.RNNArgs(num_steps=T, hidden=HIDDEN, rnn_hidden_dim=16)
    learner = trnn.CatPPORNN(env, args)
    h0 = torch.from_numpy(
        (0.5 * np.random.RandomState(2).randn(2, NS, 16)).astype(np.float32))
    learner.ac_hidden, learner.cr_hidden = h0[0], h0[1]
    obs_n = learner.observe(torch.from_numpy(s.obs0))
    # no action noise: the rollout's actions are its action means
    _, _, traj, _ = learner.rollout(0, obs_n, noise=torch.zeros(T, NS, AS))
    with torch.no_grad():
        means, _ = learner.replay(traj.obs, traj.ac_h0, traj.cr_h0,
                                  traj.true_dones)
    diff = (means - traj.actions).abs().amax(-1)            # (T, N)
    assert float(diff[:HARD_STEP + 1].max()) < 1e-6
    assert float(diff[HARD_STEP + 1, HARD_ENV]) > 1e-4
    others = [e for e in range(NS) if e != HARD_ENV]
    assert float(diff[:, others].max()) < 1e-6


# ---------------------------------------------------------------------------
# one train iteration on the real parkour env
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def parkour():
    """(JAX env, port env, JAX world, port world) with the draws off."""
    kw = dict(num_envs=8, add_noise=False, push_robots=False,
              only_forwards=True)
    jenv = JaxParkourEnv(JaxParkourCfg(terrain=JaxTerrainCfg(**SMALL), **kw),
                         jax_load_robot("go2"), seed=0, physics_backend="xla")
    tenv = ParkourEnv(ParkourCfg(terrain=ParkourTerrainCfg(**SMALL), **kw),
                      load_robot("go2"), seed=0, device="cpu")
    with jax.disable_jit():
        jworld = jenv.init_state(jax.random.PRNGKey(0))
    return jenv, tenv, jworld


@pytest.mark.parametrize("algo", ["ppo_plus", "ppornn"])
def test_iteration_on_parkour_env_matches_jax(algo, parkour, monkeypatch):
    """One train iteration (2 env steps x 8 envs of Go2 parkour, 2 epochs x
    2 minibatches) from one carried-over world, at the scripted test's
    bars. No hard done may occur (asserted): a reset draws from the
    generator, which the JAX keys cannot match."""
    jenv, tenv, jworld = parkour
    tworld = parkour_world_from_jax(np_tree(jworld))
    ts, jstats, learner, tstats, convert = _run_both(
        algo, jenv, tenv, jworld, tworld, jenv.get_observations(jworld),
        tenv.get_observations(tworld), monkeypatch, T_=2)
    assert not bool(learner.next_true_done.any())
    _check(ts, jstats, learner, tstats, convert, LOSS_KEYS[algo])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli(run_dir, algo, task, iterations, *extra):
    from wtw_tpu_torch.train_parkour import main
    small = (["--set", "terrain.num_levels=3", "--set",
              "terrain.num_terrains=5", "--set", "terrain.border_size=4.0"]
             if task == "parkour" else
             ["--set", "rough_terrain.num_rows=3", "--set",
              "rough_terrain.num_cols=3", "--set",
              "rough_terrain.border_size=1.0"])
    main(["--algo", algo, "--task", task, "--device", "cpu", "--num-envs",
          "8", "--iterations", str(iterations), "--anneal-iterations", "2",
          "--horizon", "2",
          "--log-freq", "1", "--run-dir", str(run_dir), "--set",
          "ppo.hidden=16,8", "--set", "ppo.num_minibatches=2", "--set",
          "ppo.update_epochs=1"] + small + (
              ["--set", "ppo.n_perturbations=2"] if algo == "ppo_plus" else
              ["--set", "ppo.rnn_hidden_dim=8"]) + list(extra))


@pytest.mark.parametrize("task", ["parkour", "terrain"])
@pytest.mark.parametrize("algo", ["ppo_plus", "ppornn"])
def test_parkour_cli_trains_and_resumes_each_algo(algo, task, tmp_path):
    """`train_parkour --algo ppo_plus|ppornn` (each task) trains and resumes
    its own `state_last.pt` exactly: 2 iterations straight equal 1, resume,
    1 (weights and, for ppornn, the carried hiddens; one LR-anneal horizon
    of 2 iterations for all three runs). The CSV
    has the JAX script's columns for these learners: terrain level and
    episode length 0.0, `lvl_*` on the parkour course, no `cross_*`,
    `ep_*` or `cstr_*`. (Resuming a JAX `.pkl` of these learners is
    tests/test_torch_checkpoint.py's.)"""
    a, b = tmp_path / "a", tmp_path / "b"
    _cli(a, algo, task, 2)
    _cli(b, algo, task, 1)
    _cli(b, algo, task, 1, "--resume", str(b / "state_last.pt"))
    sa = torch.load(a / "state_last.pt", weights_only=False)
    sb = torch.load(b / "state_last.pt", weights_only=False)
    assert sa["iteration"] == sb["iteration"] == 2
    for k in sa["agent"]:
        torch.testing.assert_close(sa["agent"][k], sb["agent"][k], rtol=0,
                                   atol=0)
    assert ("q_net.0.weight" in sa["agent"]) == (algo == "ppo_plus")
    if algo == "ppornn":
        assert float(sa["ac_hidden"].abs().max()) > 0
        torch.testing.assert_close(sa["ac_hidden"], sb["ac_hidden"], rtol=0,
                                   atol=0)
    with open(os.path.join(b, "metrics.csv")) as f:
        lines = f.read().splitlines()
    cols = lines[0].split(",")
    rows = [dict(zip(cols, line.split(","))) for line in lines[1:]]
    assert [r["iteration"] for r in rows] == ["0", "1"]
    assert all(float(r["terrain_level"]) == 0.0
               and float(r["mean_episode_length"]) == 0.0 for r in rows)
    assert not any(c.startswith(("cross_", "ep_", "cstr_")) for c in cols)
    assert any(c.startswith("lvl_") for c in cols) == (task == "parkour")
