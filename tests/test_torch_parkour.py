"""Parity of the port's parkour slice (terrain, CaT, ParkourEnv, the CaT PPO
learner; wtw_tpu_torch on the CPU) against the JAX package.

Inputs come from numpy with a seed and go to both sides. The JAX env runs
un-jitted (`jax.disable_jit()`) on its batched XLA path
(`physics_backend="xla"`, the JAX package's plain reference of its Pallas
kernels), at the small terrain of tests/test_parkour.py: 3 levels x 5
track types with a 4 m border, so column 4 is a crawl track and the
ceiling field is not flat. Random draws that torch cannot reproduce are
switched off (observation noise, pushes, in-episode command updates via
`only_forwards`) or fed from numpy to both sides (action noise and
minibatch permutations of the learner).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtw_tpu.envs.constraints import CaTManager as JaxCaTManager
from wtw_tpu.envs.parkour_env import ParkourCfg as JaxParkourCfg
from wtw_tpu.envs.parkour_env import ParkourEnv as JaxParkourEnv
from wtw_tpu.learn import cat_ppo as jcat
from wtw_tpu.models import load_robot as jax_load_robot
from wtw_tpu.terrain import ParkourTerrainCfg as JaxTerrainCfg
from wtw_tpu.terrain import assign_parkour_origins as jax_assign_origins
from wtw_tpu.terrain import build_parkour as jax_build_parkour
from wtw_tpu.terrain import ceiling_heightfield as jax_ceiling_hf
from wtw_tpu.terrain import to_heightfield as jax_to_hf

from wtw_tpu_torch.convert import cat_params_from_jax, parkour_world_from_jax
from wtw_tpu_torch.envs.constraints import CaTManager
from wtw_tpu_torch.envs.parkour_env import ParkourCfg, ParkourEnv
from wtw_tpu_torch.learn import cat_ppo as tcat
from wtw_tpu_torch.models import load_robot
from wtw_tpu_torch.physics import kernels as K
from wtw_tpu_torch.physics.batched import _hf_height
from wtw_tpu_torch.terrain import (ParkourTerrainCfg, assign_parkour_origins,
                                   build_parkour, ceiling_heightfield,
                                   to_heightfield)
from wtw_tpu_torch.train_parkour import TERRAIN_PRESETS

N = 8
SMALL = dict(num_levels=3, num_terrains=5, border_size=4.0)
# the env placed under the crawl ceiling: env 7 runs the crawl column (4)
CRAWL_ENV = 7


@pytest.mark.parametrize("preset,extra", [
    ("mixed", {}), ("mixed", {"soft_start": True}),
    ("jump", {"easy_mode": True}), ("crawl", {}),
])
def test_build_parkour_is_bit_identical(preset, extra):
    """Heights, ceilings, the ceiling grid, origins and the per-env
    (level, type) assignment for one seed: exact."""
    kw = dict(SMALL, proportions=TERRAIN_PRESETS[preset], **extra)
    jm = jax_build_parkour(JaxTerrainCfg(**kw), seed=3)
    tm = build_parkour(ParkourTerrainCfg(**kw), seed=3)
    for f in ("heights", "ceilings", "ceilings_grid", "env_origins",
              "origin"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f),
                                      err_msg=f)
    assert (tm.horizontal_scale, tm.num_rows, tm.num_cols) == (
        jm.horizontal_scale, jm.num_rows, jm.num_cols)
    for a, b in zip(assign_parkour_origins(tm, 37, ParkourTerrainCfg(**kw), 3),
                    jax_assign_origins(jm, 37, JaxTerrainCfg(**kw), 3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("preset", ["mixed", "jump"])
def test_heightfields_match_jax(preset):
    """Ground and ceiling HeightFields: packed corners exact, flat flags
    equal (the jump preset's ceiling is all open sky, hence flat)."""
    kw = dict(SMALL, proportions=TERRAIN_PRESETS[preset])
    jm = jax_build_parkour(JaxTerrainCfg(**kw), seed=0)
    tm = build_parkour(ParkourTerrainCfg(**kw), seed=0)
    for jf, tf in ((jax_to_hf(jm), to_heightfield(tm)),
                   (jax_ceiling_hf(jm), ceiling_heightfield(tm))):
        np.testing.assert_array_equal(tf.corners.numpy(),
                                      np.asarray(jf.corners))
        assert (tf.is_flat, tf.flat_value) == (jf.is_flat, jf.flat_value)
    assert ceiling_heightfield(tm).is_flat == (preset == "jump")


def test_cat_manager_matches_jax():
    """Two steps of the running maxima, probabilities, violation fractions
    and binding columns: float32 elementwise, atol 1e-6."""
    decls = [("a", 1), ("b", 3), ("c", 2)]
    rng = np.random.RandomState(0)
    jm, tm = JaxCaTManager(decls, tau=0.95), CaTManager(decls, tau=0.95)
    js, ts = jm.init_state(), tm.init_state()
    for step in range(2):
        cs = {n: (rng.randn(16, w) if w > 1 else rng.randn(16)).astype(
            np.float32) for n, w in decls}
        ps = {"a": 0.3, "b": 1.0, "c": 0.07 + step}
        js, jp, jv, ja = jm.step(js, {k: jnp.asarray(v) for k, v in
                                      cs.items()}, ps)
        maxp = torch.tensor([ps[n] for n, w in decls for _ in range(w)])
        ts, tp, tv, ta = tm.step(ts, {k: torch.from_numpy(v) for k, v in
                                      cs.items()}, maxp)
        np.testing.assert_allclose(ts.running_max.numpy(),
                                   np.asarray(js.running_max), atol=1e-6)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        for n in jv:
            assert float(tv[n]) == pytest.approx(float(jv[n]), abs=1e-6)


def test_cat_gae_matches_jax():
    """Float-done GAE over 6 steps x 5 envs: atol 1e-5."""
    rng = np.random.RandomState(1)
    T, n = 6, 5
    r, v = rng.randn(T, n), rng.randn(T, n)
    d = rng.uniform(0, 0.3, (T, n))
    td = (rng.uniform(size=(T, n)) < 0.2).astype(np.float64)
    nv, nd, ntd = rng.randn(n), rng.uniform(0, 0.3, n), np.zeros(n)
    ins = [x.astype(np.float32) for x in (r, d, td, v, nv, nd, ntd)]
    ja, jr = jcat.cat_gae(*map(jnp.asarray, ins), 0.99, 0.95)
    ta, tr = tcat.cat_gae(*map(torch.from_numpy, ins), 0.99, 0.95)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)


def test_rms_matches_jax():
    """RunningMeanStd update twice, then normalize: rtol 1e-5."""
    rng = np.random.RandomState(2)
    xs = [(3.0 + 2.0 * rng.randn(32, 7)).astype(np.float32) for _ in range(2)]
    js, ts = jcat.RMSState.create((7,)), tcat.RMSState.create((7,))
    for x in xs:
        js = jcat.rms_update(js, jnp.asarray(x))
        ts = tcat.rms_update(ts, torch.from_numpy(x))
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-5)
    np.testing.assert_allclose(
        tcat.rms_norm(ts, torch.from_numpy(xs[0])).numpy(),
        np.asarray(jcat.rms_norm(js, jnp.asarray(xs[0]))), rtol=1e-5,
        atol=1e-6)


def _agent(num_obs, hidden=(64, 32)):
    args = jcat.CatPPOArgs(hidden=hidden)
    params = jcat.init_agent(jax.random.PRNGKey(0), num_obs, 12, args)
    agent = tcat.CatAgent(num_obs, 12, hidden)
    agent.load_state_dict(cat_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return params, agent


def test_agent_forward_matches_jax():
    """Converted weights at full width (189-512-256-128): value, action
    mean, log-probability and entropy at atol 1e-5."""
    params, agent = _agent(189, (512, 256, 128))
    rng = np.random.RandomState(3)
    obs = rng.randn(16, 189).astype(np.float32)
    act = rng.randn(16, 12).astype(np.float32)
    with torch.no_grad():
        mean = agent.actor_mean(torch.from_numpy(obs))
        logp = agent.log_prob(mean, torch.from_numpy(act))
        value = agent.value(torch.from_numpy(obs))
        ent = float(agent.entropy())
    jlogp, jent = jcat.log_prob_entropy(params, jnp.asarray(obs),
                                        jnp.asarray(act))
    np.testing.assert_allclose(
        mean.numpy(), np.asarray(jcat.get_action_mean(params, obs)),
        atol=1e-5)
    np.testing.assert_allclose(
        value.numpy(), np.asarray(jcat.get_value(params, obs)), atol=1e-5)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), atol=1e-5)
    assert ent == pytest.approx(float(jent[0]), abs=1e-5)


# ---------------------------------------------------------------------------
# the env and the learner, from one carried-over world
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def envs():
    """(JAX env, port env, JAX world) with the draws off and one env under
    the first crawl barrier: its base at x = 1.75 m along its level-0
    track, so the head spheres (0.285 m ahead of the base) are under the
    0.34 m ceiling (barrier over x in [2, 3) m) while the base's own
    spheres are not (a base contact would hard-reset the env)."""
    kw = dict(num_envs=N, add_noise=False, push_robots=False,
              only_forwards=True)
    jenv = JaxParkourEnv(JaxParkourCfg(terrain=JaxTerrainCfg(**SMALL), **kw),
                         jax_load_robot("go2"), seed=0, physics_backend="xla")
    tenv = ParkourEnv(ParkourCfg(terrain=ParkourTerrainCfg(**SMALL), **kw),
                      load_robot("go2"), seed=0, device="cpu")
    with jax.disable_jit():
        jworld = jenv.init_state(jax.random.PRNGKey(0))
    assert int(jworld.env.terrain_type[CRAWL_ENV]) == 4
    assert int(jworld.env.terrain_level[CRAWL_ENV]) == 0
    pos = np.array(jworld.env.phys.base_pos)
    pos[CRAWL_ENV, 0] = 1.75
    jworld = jworld.replace(env=jworld.env.replace(
        phys=jworld.env.phys.replace(base_pos=jnp.asarray(pos))))
    return jenv, tenv, jworld


def test_parkour_env_steps_match_jax(envs):
    """3 policy steps (12 substeps through both heightfields) from one
    carried-over world, with the crawl env under its ceiling. No hard done
    may occur (asserted): a reset draws from the generator, which the JAX
    keys cannot match. Bars: observations, rewards and done probabilities
    at 1e-4 absolute, as tests/test_torch_env.py holds the legged env (12
    float32 substeps of a contact solver, each side at ~1e-6 a substep);
    CaT running maxima at 1e-4 relative; hard dones, commands and the
    history exactly as the observations."""
    jenv, tenv, jworld = envs
    tworld = parkour_world_from_jax(jax.tree.map(np.asarray, jworld))
    # the crawl env's spheres reach above the ceiling over them
    ph = tworld.env.phys
    _, fk_p = K.fk_plain(tenv.model, torch.cat(
        [ph.base_pos, ph.base_quat, ph.joint_q], 1).T.contiguous())
    over = fk_p[2] + tenv.model.sph_radius[:, None] - _hf_height(
        tenv.hf_ceiling, fk_p[0], fk_p[1])
    assert int((over[:, CRAWL_ENV] > 0).sum()) > 0
    np.testing.assert_array_equal(tenv.get_observations(tworld).numpy(),
                                  np.asarray(jenv.get_observations(jworld)))
    rng = np.random.RandomState(0)
    for step in range(3):
        a = (0.3 * rng.randn(N, 12)).astype(np.float32)
        with jax.disable_jit():
            jworld, jobs, jrew, jdone, jinfo = jenv.step(jworld,
                                                         jnp.asarray(a))
        tworld, tobs, trew, tdone, tinfo = tenv.step(tworld,
                                                     torch.from_numpy(a))
        assert not np.asarray(jinfo["true_dones"]).any(), step
        np.testing.assert_array_equal(tinfo["true_dones"].numpy(),
                                      np.asarray(jinfo["true_dones"]))
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4,
                                   err_msg=f"obs @ {step}")
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-4,
                                   err_msg=f"rew @ {step}")
        np.testing.assert_allclose(tdone.numpy(), np.asarray(jdone),
                                   atol=1e-4, err_msg=f"done prob @ {step}")
        np.testing.assert_allclose(tworld.cat.running_max.numpy(),
                                   np.asarray(jworld.cat.running_max),
                                   rtol=1e-4, atol=1e-9)
        np.testing.assert_allclose(tworld.env.episode_sums.numpy(),
                                   np.asarray(jworld.env.episode_sums),
                                   atol=1e-4)
        np.testing.assert_array_equal(tworld.env.commands.numpy(),
                                      np.asarray(jworld.env.commands))
    # the crawl env observes its cell's ceiling (0.34 m) and stayed in
    # front of the barrier's base-height part
    assert float(tobs[CRAWL_ENV, -1]) == pytest.approx(0.34)
    assert float(tworld.env.phys.base_pos[CRAWL_ENV, 0]) < 2.0


def test_one_gather_per_heightfield_per_policy_step(envs, monkeypatch):
    """A parkour policy step gathers the ground's and the ceiling's corner
    rows once each, on its first substep, and none on the other three: the
    substep that returns the cache reads its own rows from that cache
    rather than gathering them a second time. Its state, contacts and
    cache are bit-identical to a gather followed by `hf_gather_cache`."""
    from wtw_tpu_torch.envs import parkour_env
    from wtw_tpu_torch.physics import batched, physics_step_batched
    from wtw_tpu_torch.physics.batched import hf_gather_cache
    _, tenv, jworld = envs
    tworld = parkour_world_from_jax(jax.tree.map(np.asarray, jworld))
    assert not tenv.hf.is_flat and not tenv.hf_ceiling.is_flat
    assert tenv.cfg.hf_substep_cache
    calls = []
    real_gather, real_step = batched._gather_at, parkour_env.physics_step_batched

    def gather(hf, u, v):
        calls.append(hf)
        return real_gather(hf, u, v)

    def step(*a, **kw):
        calls.append("substep")
        return real_step(*a, **kw)

    monkeypatch.setattr(batched, "_gather_at", gather)
    monkeypatch.setattr(parkour_env, "physics_step_batched", step)
    a = torch.from_numpy(
        (0.3 * np.random.RandomState(0).randn(N, 12)).astype(np.float32))
    tenv.step(tworld, a)
    assert tenv.cfg.decimation == 4
    assert calls[:3] == ["substep", tenv.hf, tenv.hf_ceiling]
    assert calls[3:] == ["substep"] * 3
    monkeypatch.undo()

    env = tworld.env
    args = (tenv.model, tenv.hf, tenv.engine_params, env.phys,
            tenv._compute_tau(env, a), env.friction, 0.0)
    new_state, new_info, cache = physics_step_batched(
        *args, hf_ceiling=tenv.hf_ceiling, return_hf_cache=True)
    old_state, old_info = physics_step_batched(
        *args, hf_ceiling=tenv.hf_ceiling)
    ph = env.phys
    _, fk_p = K.fk_plain(tenv.model, torch.cat(
        [ph.base_pos, ph.base_quat, ph.joint_q], 1).T.contiguous())
    old_cache = hf_gather_cache(tenv.hf, fk_p, tenv.hf_ceiling)
    for got, ref in ((new_state, old_state), (new_info, old_info)):
        for f in dataclasses.fields(ref):
            assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), \
                f.name
    assert cache.keys() == old_cache.keys() == {"g", "c"}
    for k in cache:
        for got, ref in zip(cache[k], old_cache[k]):
            assert torch.equal(got, ref), k


def test_observation_blocks_match_jax(envs):
    """Every observation block the port builds, the optional ones (base
    linear velocity, gait phases) switched on, from one state and the same
    numpy inputs: 3 + 3 + 3 + 39 + 143 + 1 + 8 = 200 columns at 1e-6."""
    _, _, jworld = envs
    kw = dict(num_envs=N, add_noise=False, observe_base_lin_vel=True,
              observe_phases=True)
    jenv = JaxParkourEnv(JaxParkourCfg(terrain=JaxTerrainCfg(**SMALL), **kw),
                         jax_load_robot("go2"), seed=0, physics_backend="xla")
    tenv = ParkourEnv(ParkourCfg(terrain=ParkourTerrainCfg(**SMALL), **kw),
                      load_robot("go2"), seed=0, device="cpu")
    assert tenv.num_obs == jenv.num_obs == 200
    rng = np.random.RandomState(5)
    progress = rng.randint(0, 500, N).astype(np.int32)
    jworld = jworld.replace(env=jworld.env.replace(
        progress=jnp.asarray(progress)))
    tworld = parkour_world_from_jax(jax.tree.map(np.asarray, jworld))
    ins = [rng.randn(N, 3), rng.randn(N, 3), rng.randn(N, 3),
           0.1 * rng.randn(N, 143), rng.uniform(0.26, 0.4, N)]
    ins = [x.astype(np.float32) for x in ins]
    with jax.disable_jit():
        ref = jenv._build_obs(jworld.env, *map(jnp.asarray, ins), None)
    got = tenv._build_obs(tworld.env, *map(torch.from_numpy, ins),
                          tworld.gen)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_restore_terrain_state_reseats_envs(envs):
    """Slim-checkpoint resume: every env at the given (level, type), at its
    cell's origin, fresh episode, move-up flags cleared."""
    _, tenv, jworld = envs
    world = parkour_world_from_jax(jax.tree.map(np.asarray, jworld))
    world.env.move_up_flag[:] = True
    world.env.progress += 7
    lvl = torch.tensor([0, 1, 2, 2, 1, 0, 1, 2])
    typ = torch.arange(N) % 5
    world = tenv.restore_terrain_state(world, lvl, typ)
    e = world.env
    assert torch.equal(e.terrain_level, lvl) and torch.equal(e.terrain_type,
                                                             typ)
    torch.testing.assert_close(e.env_origin, tenv.terrain_origins[lvl, typ])
    assert not e.move_up_flag.any() and not e.progress.any()
    # respawned within 5 cm of the origin, at the spawn height
    off = e.phys.base_pos - e.env_origin - tenv.base_init_pos
    assert float(off.abs().max()) <= 0.05


def test_cat_ppo_iteration_matches_jax(envs, monkeypatch):
    """One train iteration (2 env steps x 8 envs, GAE, value normalization,
    2 epochs x 2 minibatches) from the same world and weights, with the
    action noise and the per-epoch permutations drawn by numpy and fed to
    both sides. Bars: weights after the updates and the normalizers at
    1e-5 absolute (Adam moves each weight by at most ~lr = 3e-4 a step),
    losses at 1e-4 relative."""
    jenv, tenv, jworld = envs
    T, epochs, mbs = 2, 2, 2
    hidden = (64, 32)
    jargs = jcat.CatPPOArgs(num_steps=T, num_iterations=10,
                            update_epochs=epochs, num_minibatches=mbs,
                            hidden=hidden)
    targs = tcat.CatPPOArgs(num_steps=T, num_iterations=10,
                            update_epochs=epochs, num_minibatches=mbs,
                            hidden=hidden)
    rng = np.random.RandomState(4)
    noise = (0.3 * rng.randn(T, N, 12)).astype(np.float32)
    perms = np.stack([rng.permutation(T * N) for _ in range(epochs)])

    ts = jcat.init_train_state(jax.random.PRNGKey(1), jenv, jargs)
    obs = jenv.get_observations(jworld)
    ts = ts.replace(obs_rms=jcat.rms_update(ts.obs_rms, obs))
    obs_n = jcat.rms_norm(ts.obs_rms, obs)
    tworld = parkour_world_from_jax(jax.tree.map(np.asarray, jworld))
    learner = tcat.CatPPO(tenv, targs)
    learner.agent.load_state_dict(cat_params_from_jax(
        jax.tree.map(np.asarray, ts.params)))
    tobs_n = learner.observe(tenv.get_observations(tworld))

    draws = {"normal": iter(noise), "permutation": iter(perms)}
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jnp.asarray(next(draws["normal"])))
    monkeypatch.setattr(
        jax.random, "permutation",
        lambda key, n: jnp.asarray(next(draws["permutation"])))
    with jax.disable_jit():
        ts, jworld2, jobs_n, jstats = jcat.make_train_fn(jenv, jargs)(
            ts, jworld, obs_n)
    monkeypatch.undo()
    _, tobs_n2, tstats = learner.train_iteration(
        tworld, tobs_n, noise=torch.from_numpy(noise),
        perms=torch.from_numpy(perms))

    want = cat_params_from_jax(jax.tree.map(np.asarray, ts.params))
    got = learner.agent.state_dict()
    moved = 0.0
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=k)
    for k, v in cat_params_from_jax(jax.tree.map(
            np.asarray, jcat.init_train_state(jax.random.PRNGKey(1), jenv,
                                              jargs).params)).items():
        moved = max(moved, float((got[k] - v).abs().max()))
    assert moved > 1e-4            # the updates changed the weights
    for s_t, s_j in ((learner.obs_rms, ts.obs_rms),
                     (learner.value_rms, ts.value_rms)):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(s_t, f).numpy(),
                                       np.asarray(getattr(s_j, f)),
                                       rtol=1e-5, atol=1e-5, err_msg=f)
    for k in ("loss", "pg_loss", "value_loss", "mean_step_reward"):
        assert float(tstats[k]) == pytest.approx(float(jstats[k]), rel=1e-4,
                                                 abs=1e-6), k
    assert float(tstats["lr"]) == pytest.approx(float(jstats["lr"]))
    assert learner.iteration == int(ts.iteration) == 1
