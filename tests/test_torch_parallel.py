"""Env-sharded data-parallel training of the port (`wtw_tpu_torch.parallel`,
the counterpart of `wtw_tpu/parallel/mesh.py`) on the CPU.

- `sharding_invariant` on one process against the JAX package's, one
  iteration of `ppo_cse` and of `cat_ppo` on scripted envs (duck-typed
  stubs driven by numpy tables), the per-env action noise of the JAX side
  (drawn from each env's key) computed here and fed to the port, JAX
  un-jitted: at the learner bars of tests/test_torch_stack_a_learners.py
  and tests/test_torch_parkour.py (weights 1e-5, losses 1e-4 relative).
- 2 gloo ranks against 1 (`chip_smoke.phase_dist`, the card phases run
  here at the sizes of tests/test_parallel.py: go1_flat 16 envs, 4 steps,
  4 minibatches, 1 epoch, 3 iterations; Go2 parkour 8 envs on 2 levels x
  2 track types, 2 minibatches), at that test's bars (parameters 3e-3,
  base_pos 1e-3, loss 1e-3 relative, CaT's running max and the
  normalizers 1e-3 relative, terrain levels equal), with the ranks'
  parameters bitwise equal after every iteration.
- one spawn in which `ppo_rma`, `cat_ppo_plus` and `cat_ppornn` each run
  one iteration on 2 ranks with bitwise-equal replicas.
- `shard_world` / `shard_parkour_world` and the per-env draws, on a stub
  group (rank 1 of 2) in this process.

The ranks are processes of chip_smoke.py (`--dist-worker`), one OpenMP
thread each, meeting through a `file://` rendezvous under a fresh
temporary directory, so concurrent test workers do not collide.
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

from wtw_tpu_torch.parallel import mesh  # noqa: E402


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Group:
    """A stand-in for a process group: a rank and a size, no transport."""

    def __init__(self, rank, size):
        self._r, self._s = rank, size

    def rank(self):
        return self._r

    def size(self):
        return self._s


# ---------------------------------------------------------------------------
# shards on one process
# ---------------------------------------------------------------------------
def test_shard_world_takes_rows_and_keeps_shared_state():
    from wtw_tpu_torch import config as C
    from wtw_tpu_torch.envs import make_legged_env
    from wtw_tpu_torch.envs.parkour_env import ParkourCfg, ParkourEnv
    from wtw_tpu_torch.models import load_robot
    g = _Group(1, 2)
    env = make_legged_env(C.go1_flat_config(num_envs=8), device="cpu")
    world = env.init_state(0)
    world, obs = env.get_observations(world)
    part, pobs = mesh.shard_world(world, obs, g)
    rows = slice(4, 8)
    assert torch.equal(part.env.phys.base_pos, world.env.phys.base_pos[rows])
    assert torch.equal(part.env.commands, world.env.commands[rows])
    assert torch.equal(part.obs_history, world.obs_history[rows])
    assert all(torch.equal(pobs[k], obs[k][rows]) for k in obs)
    assert torch.equal(part.curriculum_weights, world.curriculum_weights)
    assert torch.equal(part.gravity_offset, world.gravity_offset)
    assert part.common_step == world.common_step
    assert part.gen is not world.gen and torch.equal(
        part.gen.get_state(), world.gen.get_state())
    # a grouped env steps its 4 rows, and draws the rows of the whole
    # env's draws from a generator in the same state
    genv = make_legged_env(C.go1_flat_config(num_envs=8), device="cpu",
                           group=g)
    assert (genv.num_envs, genv.num_envs_global) == (4, 8)
    assert torch.equal(genv.env_origins, env.env_origins[rows])
    a, b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert torch.equal(genv._uniform(a, (4, 3), -1.0, 2.0),
                       env._uniform(b, (8, 3), -1.0, 2.0)[rows])
    assert torch.equal(a.get_state(), b.get_state())

    from wtw_tpu_torch.terrain import ParkourTerrainCfg
    cfg = ParkourCfg(num_envs=8, terrain=ParkourTerrainCfg(
        num_levels=2, num_terrains=2, border_size=4.0))
    penv = ParkourEnv(cfg, load_robot("go2"), device="cpu")
    pw = penv.init_state(0)
    pobs = penv.get_observations(pw)
    part, po = mesh.shard_parkour_world(pw, pobs, g)
    assert torch.equal(part.env.terrain_level, pw.env.terrain_level[rows])
    assert torch.equal(part.hist_obs, pw.hist_obs[rows])
    assert torch.equal(po, pobs[rows])
    assert torch.equal(part.cat.running_max, pw.cat.running_max)
    assert part.soft_p_progress == pw.soft_p_progress
    gpenv = ParkourEnv(cfg, load_robot("go2"), device="cpu", group=g)
    assert torch.equal(gpenv.init_origins, penv.init_origins[rows])
    assert torch.equal(gpenv.init_levels, penv.init_levels[rows])


def test_ungrouped_collectives_are_identities():
    x = torch.arange(6.0)
    assert mesh.all_sum(x, None) is x and mesh.all_mean(x, None) is x
    assert mesh.all_max(x, None) is x
    assert torch.equal(mesh.draw_rows(lambda s: torch.ones(s), (3, 2), None),
                       torch.ones(3, 2))
    with pytest.raises(ValueError, match="backend"):
        mesh.init_group("mpi", "file:///nonexistent", 1, 0)


# ---------------------------------------------------------------------------
# sharding_invariant on one process against JAX
# ---------------------------------------------------------------------------
T, N, SO, SP, SA, HIST = 5, 4, 6, 2, 4, 3


def _jax_env_noise(rng_keys, fold, n_act, steps):
    """The JAX learners' sharding_invariant action noise: each env's key
    folded with `fold`, a normal draw of the action width, the same every
    step on a stub whose keys do not advance."""
    import jax
    keys = jax.numpy.asarray(rng_keys)
    one = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, fold),
                                               (n_act,)))(keys)
    return np.repeat(np.asarray(one)[None], steps, 0)


def test_sharding_invariant_ppo_cse_matches_jax():
    """One ppo_cse iteration with sharding_invariant (env-strided
    minibatches, the timestep-aligned adaptation split, per-env noise):
    the port on one process against JAX, 2 epochs x 2 minibatches."""
    import jax
    import jax.numpy as jnp
    from flax import struct
    from wtw_tpu.learn import ppo_cse as jppo
    from wtw_tpu.models import actor_critic as jac
    from wtw_tpu_torch.convert import params_from_jax
    from wtw_tpu_torch.learn import ppo_cse as tppo
    from wtw_tpu_torch.models import actor_critic as tac

    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    hist, priv, rew0 = f(T + 1, N, SO * HIST), f(T + 1, N, SP), f(T, N)
    m = 0.1 * f(SA)

    @struct.dataclass
    class JEnvState:
        rng: jnp.ndarray

    @struct.dataclass
    class JWorld:
        t: jnp.ndarray
        env: JEnvState

    class Dims:
        num_obs, num_privileged_obs, num_actions = SO, SP, SA
        num_obs_history = SO * HIST
        num_envs = num_train_envs = N
        num_eval_envs, n_terms = 0, 1
        device = torch.device("cpu")

    def obs(t, lib):
        pick = ((lambda x: jnp.asarray(x)[t]) if lib is jnp
                else (lambda x: torch.from_numpy(x[t])))
        h = pick(hist)
        return {"obs": h[:, -SO:], "privileged_obs": pick(priv),
                "obs_history": h}

    def info(lib, z):
        return {"time_outs": z(N), "episode_sums_at_reset": z(2),
                "num_resets": z(()), "eval_episode_sums_at_reset": z(2),
                "eval_num_resets": z(()), "mean_episode_length": z(())}

    class JStub(Dims):
        def step(self, w, a):
            t = w.t
            r = jnp.asarray(rew0)[t] - 0.01 * jnp.sum(a * a, -1) + a @ m
            return (w.replace(t=t + 1), obs(t + 1, jnp), r,
                    jnp.zeros(N, bool), info(jnp, jnp.zeros))

    class TStub(Dims):
        def step(self, t, a):
            r = (torch.from_numpy(rew0[t]) - 0.01 * (a * a).sum(-1)
                 + a @ torch.from_numpy(m))
            return (t + 1, obs(t + 1, torch), r, torch.zeros(N, dtype=bool),
                    info(torch, torch.zeros))

    narrow = dict(actor_hidden_dims=(32, 16), critic_hidden_dims=(32, 16),
                  adaptation_hidden_dims=(16,))
    kw = dict(num_steps_per_env=T, num_learning_epochs=2, num_mini_batches=2,
              sharding_invariant=True)
    jargs, targs = jppo.PPOArgs(**kw), tppo.PPOArgs(**kw)
    ts = jppo.init_train_state(jax.random.PRNGKey(1), JStub(), jargs,
                               jac.ACArgs(**narrow))
    learner = tppo.PPO(TStub(), targs, tac.ACArgs(**narrow))
    learner.ac.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                            ts.params)))
    keys = jax.random.split(jax.random.PRNGKey(5), N)
    noise = _jax_env_noise(keys, 29, SA, T)
    with jax.disable_jit():
        ts, _, _, jstats = jppo.make_train_fns(JStub(), jargs,
                                               jac.ACArgs(**narrow))(
            ts, JWorld(t=jnp.int32(0), env=JEnvState(rng=keys)),
            obs(0, jnp))
    _, _, tstats = learner.train_iteration(0, obs(0, torch),
                                           noise=torch.from_numpy(noise))
    got = learner.ac.state_dict()
    for k, v in params_from_jax(jax.tree.map(np.asarray,
                                             ts.params)).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=k)
    for k in ("loss", "surrogate_loss", "value_loss", "kl_mean",
              "adaptation_loss", "adaptation_test_loss", "mean_step_reward"):
        assert float(tstats[k]) == pytest.approx(float(jstats[k]), rel=1e-4,
                                                 abs=1e-7), k
    # the strided order: env n in minibatch n % M, timesteps in order
    base = np.arange(T * N).reshape(T, N)
    order = np.concatenate([base[:, i::2].reshape(-1) for i in range(2)])
    assert order[:T * N // 2].tolist() == [0, 2, 4, 6, 8, 10, 12, 14, 16, 18]


def test_sharding_invariant_cat_ppo_matches_jax():
    """One cat_ppo iteration with sharding_invariant (per-env noise,
    env-strided minibatches in every epoch): the port on one process
    against JAX, 2 epochs x 2 minibatches, normalizers included."""
    import jax
    import jax.numpy as jnp
    from flax import struct
    from wtw_tpu.learn import cat_ppo as jcat
    from wtw_tpu_torch.convert import cat_params_from_jax
    from wtw_tpu_torch.learn import cat_ppo as tcat

    rng = np.random.RandomState(1)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    obs0, obs_t, rew0 = f(N, SO), f(T, N, SO), f(T, N)
    mix = 0.1 * f(SA, SO)
    soft = rng.uniform(0, 0.3, (T, N)).astype(np.float32)
    hard = np.zeros((T, N), bool)
    hard[1, 2] = True

    @struct.dataclass
    class JEnvState:
        rng: jnp.ndarray

    @struct.dataclass
    class JWorld:
        t: jnp.ndarray
        env: JEnvState

    class JStub:
        num_envs, num_obs, num_actions, dt = N, SO, SA, 0.02

        def step(self, w, a):
            t = w.t
            o = jnp.asarray(obs_t)[t] + jnp.tanh(a) @ jnp.asarray(mix)
            r = jnp.asarray(rew0)[t] - 0.01 * jnp.sum(a * a, -1)
            z = jnp.zeros(())
            return (w.replace(t=t + 1), o, r, jnp.asarray(soft)[t], {
                "true_dones": jnp.asarray(hard)[t],
                "terrain_level_mean": z, "episode_sums_at_reset": jnp.zeros(2),
                "num_resets": z, "episode_len_at_reset": z})

    class TStub:
        num_envs, num_obs, num_actions = N, SO, SA
        device, dt = torch.device("cpu"), 0.02

        def step(self, t, a):
            o = torch.from_numpy(obs_t[t]) + torch.tanh(a) @ torch.from_numpy(
                mix)
            r = torch.from_numpy(rew0[t]) - 0.01 * (a * a).sum(-1)
            z = torch.zeros(())
            return t + 1, o, r, torch.from_numpy(soft[t]), {
                "true_dones": torch.from_numpy(hard[t]),
                "terrain_level_mean": z, "episode_sums_at_reset": torch.zeros(
                    2), "num_resets": z, "episode_len_at_reset": z,
                "crossings_by_type": torch.zeros(2),
                "dones_by_type": torch.zeros(2)}

    kw = dict(num_steps=T, num_iterations=10, update_epochs=2,
              num_minibatches=2, hidden=(32, 16), sharding_invariant=True)
    jargs, targs = jcat.CatPPOArgs(**kw), tcat.CatPPOArgs(**kw)
    ts = jcat.init_train_state(jax.random.PRNGKey(1), JStub(), jargs)
    ts = ts.replace(obs_rms=jcat.rms_update(ts.obs_rms, jnp.asarray(obs0)))
    obs_n = jcat.rms_norm(ts.obs_rms, jnp.asarray(obs0))
    learner = tcat.CatPPO(TStub(), targs)
    learner.agent.load_state_dict(cat_params_from_jax(
        jax.tree.map(np.asarray, ts.params)))
    tobs_n = learner.observe(torch.from_numpy(obs0))
    keys = jax.random.split(jax.random.PRNGKey(5), N)
    noise = _jax_env_noise(keys, 977, SA, T)
    with jax.disable_jit():
        ts, _, _, jstats = jcat.make_train_fn(JStub(), jargs)(
            ts, JWorld(t=jnp.int32(0), env=JEnvState(rng=keys)), obs_n)
    _, _, tstats = learner.train_iteration(0, tobs_n,
                                           noise=torch.from_numpy(noise))
    got = learner.agent.state_dict()
    for k, v in cat_params_from_jax(jax.tree.map(np.asarray,
                                                 ts.params)).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=k)
    for s_t, s_j in ((learner.obs_rms, ts.obs_rms),
                     (learner.value_rms, ts.value_rms)):
        for fld in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(s_t, fld).numpy(),
                                       np.asarray(getattr(s_j, fld)),
                                       rtol=1e-5, atol=1e-5, err_msg=fld)
    for k in ("loss", "pg_loss", "value_loss", "mean_step_reward"):
        assert float(tstats[k]) == pytest.approx(float(jstats[k]), rel=1e-4,
                                                 abs=1e-6), k


# ---------------------------------------------------------------------------
# 2 gloo ranks against 1
# ---------------------------------------------------------------------------
def test_two_ranks_match_one_go1_flat(one_thread):
    r = chip_smoke.phase_dist("go1_flat", device="cpu", num_envs=16,
                              iterations=3, num_steps=4, num_minibatches=4)
    assert r["replicas_bitwise_equal"] and r["num_envs_per_rank"] == 8
    assert r["max_abs_err"]["params"] <= 3e-3
    assert r["max_abs_err"]["base_pos"] <= 1e-3
    assert r["launches"] == {"fk": 0, "dynamics": 0}
    for rec in r["per_rank"]:
        assert len(set(rec["param_digests"])) == 3    # they moved
        assert all(n > 0 for n in rec["collectives_per_iteration"])


def test_two_ranks_match_one_parkour(one_thread):
    r = chip_smoke.phase_dist(
        "parkour", device="cpu", num_envs=8, iterations=3, num_steps=4,
        num_minibatches=2, overrides=["terrain.num_levels=2",
                                      "terrain.num_terrains=2",
                                      "terrain.border_size=4.0"])
    assert r["replicas_bitwise_equal"] and r["num_envs_per_rank"] == 4
    errs = r["max_abs_err"]
    assert errs["params"] <= 3e-3 and errs["base_pos"] <= 1e-3
    assert errs["obs_rms_count"] == 0.0


def test_other_learners_keep_bitwise_replicas(one_thread):
    course = ["terrain.num_levels=2", "terrain.num_terrains=2",
              "terrain.border_size=4.0", "ppo.hidden=32,16"]
    r = chip_smoke.phase_dist_learners(
        device="cpu", num_envs=8, num_steps=4, num_minibatches=2,
        overrides_by_task={
            "rma": ["ac.actor_hidden_dims=32,16",
                    "ac.critic_hidden_dims=32,16",
                    "ac.encoder_hidden_dims=16",
                    "ac.adaptation_hidden_dims=16"],
            "ppo_plus": course, "ppornn": course + ["ppo.rnn_hidden_dim=16"]})
    assert set(r) == {"rma", "ppo_plus", "ppornn"}
    for rec in r.values():
        assert rec["replicas_bitwise_equal"]
        assert all(np.isfinite(rec["losses"]))


def test_failed_rank_fails_the_phase(tmp_path):
    """A rank that raises makes the phase raise (every rank's exit code is
    read), with its error in the message."""
    spec = dict(tasks=["no_such_task"], device="cpu", num_envs=8,
                num_steps=2, num_minibatches=2, iterations=1,
                init_method="file://" + str(tmp_path / "rendezvous"),
                out=str(tmp_path / "out"))
    with pytest.raises(AssertionError, match="no_such_task"):
        chip_smoke._spawn_ranks(spec, 2, str(tmp_path), timeout=120)


def test_distributed_train_fn_needs_the_grouped_env():
    from wtw_tpu_torch import config as C
    from wtw_tpu_torch.envs import make_legged_env
    from wtw_tpu_torch.learn import PPOArgs
    from wtw_tpu_torch.models.actor_critic import ACArgs
    env = make_legged_env(C.go1_flat_config(num_envs=4), device="cpu")
    with pytest.raises(ValueError, match="same group"):
        mesh.make_distributed_train_fn(env, PPOArgs(), ACArgs(), _Group(0, 2))
    with pytest.raises(ValueError, match="do not shard"):
        make_legged_env(C.go1_flat_config(num_envs=5), device="cpu",
                        group=_Group(0, 2))
