"""Parity of the port's env pieces (wtw_tpu_torch.envs, on the CPU) against
the JAX package, plus torch-side checks of the env's own behaviour.

Inputs come from numpy with a seed and go to both sides. The JAX env runs
un-jitted on its batched XLA path (`physics_backend="xla"`, the plain
reference of its Pallas path).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtw_tpu import config as jcfg
from wtw_tpu.envs import LeggedEnv as JaxLeggedEnv
from wtw_tpu.envs import curriculum as jcurr
from wtw_tpu.envs import observations as jobs
from wtw_tpu.envs import rewards as jrew
from wtw_tpu.models import load_robot as jax_load_robot

from wtw_tpu_torch import config as tcfg
from wtw_tpu_torch.convert import world_from_jax
from wtw_tpu_torch.envs import LeggedEnv
from wtw_tpu_torch.envs import curriculum as tcurr
from wtw_tpu_torch.envs import observations as tobs
from wtw_tpu_torch.envs import rewards as trew
from wtw_tpu_torch.models import load_robot


def _flat_cfg(module, n, noise=True):
    cfg = module.go1_flat_config(num_envs=n)
    return dataclasses.replace(cfg, noise=dataclasses.replace(
        cfg.noise, add_noise=noise))


@pytest.mark.parametrize("lag", [False, True])
def test_env_steps_match_jax_from_one_state(lag):
    """go1_flat, 4 envs, 3 policy steps from one carried-over state; with
    `lag` the actuator-lag buffer (6 policy steps, go1_mob's setting) is on.

    Random draws switched off so both sides are deterministic and equal:
    observation noise (noise.add_noise=False); command resampling and the
    periodic DR re-draw are not due (episode_length stays far below the
    500- and 200-step intervals); no env resets (asserted: no base contact,
    no timeout); pushes and gravity randomization are off in go1_flat (the
    lag buffer draws nothing). Bars: obs and rewards at 1e-4 absolute — 12
    float32 substeps of a contact solver, each side at ~1e-6 per substep
    (the single-substep test holds 2e-4 on the raw state)."""
    N = 4
    with_lag = lambda c: dataclasses.replace(c, domain_rand=dataclasses.replace(
        c.domain_rand, randomize_lag_timesteps=lag))
    jenv = JaxLeggedEnv(with_lag(_flat_cfg(jcfg, N, noise=False)),
                        jax_load_robot("go1"), physics_backend="xla")
    tenv = LeggedEnv(with_lag(_flat_cfg(tcfg, N, noise=False)),
                     load_robot("go1"), device="cpu")
    with jax.disable_jit():
        jworld = jenv.init_state(jax.random.PRNGKey(0))
        jworld, jod = jenv.get_observations(jworld)
    tworld = world_from_jax(jax.tree.map(np.asarray, jworld))
    tobs_now, tpriv = tenv.observe(tworld)
    np.testing.assert_allclose(tobs_now.numpy(), np.asarray(jod["obs"]),
                               atol=1e-6)
    rng = np.random.RandomState(0)
    for step in range(3):
        a = (0.3 * rng.randn(N, 12)).astype(np.float32)
        with jax.disable_jit():
            jworld, jod, jrew_, jdone, jinfo = jenv.step(jworld,
                                                         jnp.asarray(a))
        tworld, tod, trew_, tdone, tinfo = tenv.step(tworld,
                                                     torch.from_numpy(a))
        assert not np.asarray(jdone).any() and not tdone.any(), step
        for k in ("obs", "privileged_obs", "obs_history"):
            np.testing.assert_allclose(tod[k].numpy(), np.asarray(jod[k]),
                                       atol=1e-4, err_msg=f"{k} @ {step}")
        np.testing.assert_allclose(trew_.numpy(), np.asarray(jrew_),
                                   atol=1e-4, err_msg=f"rew @ {step}")
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_allclose(
            tworld.env.episode_sums.numpy(),
            np.asarray(jworld.env.episode_sums), atol=1e-4)
        np.testing.assert_array_equal(tworld.env.commands.numpy(),
                                      np.asarray(jworld.env.commands))


def test_env_shapes_and_determinism():
    cfg = tcfg.go1_flat_config(num_envs=8)

    def run(seed):
        env = LeggedEnv(cfg, load_robot("go1"), device="cpu")
        world = env.init_state(seed)
        world, od = env.get_observations(world)
        assert od["obs"].shape == (8, 42)
        assert od["privileged_obs"].shape == (8, 2)
        assert od["obs_history"].shape == (8, 15 * 42)
        gen = torch.Generator().manual_seed(1)
        for _ in range(3):
            a = 0.1 * torch.randn(8, 12, generator=gen)
            world, od, rew, done, info = env.step(world, a)
        assert torch.isfinite(od["obs"]).all() and torch.isfinite(rew).all()
        return od["obs"], rew, world.env.commands

    for x, y in zip(run(0), run(0)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_commands_within_ranges():
    cfg = tcfg.go1_flat_config(num_envs=64)
    env = LeggedEnv(cfg, load_robot("go1"), device="cpu")
    cmds = env.init_state(3).env.commands.numpy()
    assert cmds.shape == (64, 3)
    c = cfg.commands
    for d, (lo, hi) in enumerate([c.limit_vel_x, c.limit_vel_y,
                                  c.limit_vel_yaw]):
        assert np.all(cmds[:, d] >= lo - 1e-6) and np.all(cmds[:, d] <= hi + 1e-6)
    small = np.linalg.norm(cmds[:, :2], axis=1) <= c.vel_deadband
    assert np.all(cmds[small, :2] == 0.0)


def test_episode_reset_on_timeout():
    cfg = tcfg.go1_flat_config(num_envs=4)
    env = LeggedEnv(cfg, load_robot("go1"), device="cpu")
    world = env.init_state(3)
    world = dataclasses.replace(world, env=dataclasses.replace(
        world.env, episode_length=torch.full(
            (4,), env.max_episode_length, dtype=torch.int32)))
    world2, od, rew, done, info = env.step(world, torch.zeros(4, 12))
    assert bool(done.all()) and bool(info["time_outs"].all())
    assert bool((world2.env.episode_length == 0).all())
    assert bool((world2.env.episode_sums == 0).all())
    assert int(info["num_resets"]) == 4


@pytest.mark.parametrize("env", ["legged", "parkour"])
def test_unported_configs_raise(env, tmp_path):
    """Every preset and both tasks are ported; what stays unported is an
    actuator net the port does not ship. A robot with no net of its own
    (its model and config renamed to an invented robot) raises
    NotImplementedError in `LeggedEnv` (go1_mob's actuator-net control)
    and in `ParkourEnv` (`use_actuator_net`), where the JAX package would
    fail to find the file."""
    import dataclasses as dc
    from wtw_tpu_torch.envs.parkour_env import ParkourCfg, ParkourEnv
    from wtw_tpu_torch.terrain import ParkourTerrainCfg
    name = "quadruped_x"
    model = dc.replace(load_robot("go1" if env == "legged" else "go2"),
                       name=name).to("cpu")
    with pytest.raises(NotImplementedError, match=name):
        if env == "legged":
            cfg = tcfg.go1_mob_config(num_envs=4)
            cfg = dc.replace(cfg, asset=dc.replace(cfg.asset, robot=name))
            LeggedEnv(cfg, model, device="cpu")
        else:
            ParkourEnv(ParkourCfg(num_envs=2, robot=name,
                                  use_actuator_net=True,
                                  terrain=ParkourTerrainCfg(
                                      num_levels=3, num_terrains=5,
                                      border_size=4.0)),
                       model, device="cpu")


def test_cuda_default_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        LeggedEnv(tcfg.go1_flat_config(num_envs=2), load_robot("go1"))


# ---------------------------------------------------------------------------
# rewards, observations, curriculum: function by function
# ---------------------------------------------------------------------------


def _reward_inputs(N=16, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    q = f(N, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    jm = jax_load_robot("go1")
    soft = np.stack([np.asarray(jm.joint_lower) * 0.9,
                     np.asarray(jm.joint_upper) * 0.9], -1).astype(np.float32)
    side = np.sign(np.asarray(jm.joint_pos)[[0, 3, 6, 9], 1]).astype(np.float32)
    cmds = f(N, 15)
    cmds[:, 4] = rng.uniform(2.0, 4.0, N)          # gait frequency > 0
    return dict(
        base_pos=f(N, 3) * 0.1 + np.float32([0, 0, 0.3]), base_quat=q,
        base_lin_vel=f(N, 3), base_ang_vel=f(N, 3),
        projected_gravity=f(N, 3) * 0.2, commands=cmds,
        joint_q=f(N, 12), joint_qd=f(N, 12) * 3, last_joint_qd=f(N, 12) * 3,
        torques=f(N, 12) * 10, actions=f(N, 12),
        last_actions=np.where(rng.rand(N, 12) < 0.2, 0.0, f(N, 12)).astype(np.float32),
        last_last_actions=f(N, 12), joint_pos_target=f(N, 12),
        last_joint_pos_target=f(N, 12), last_last_joint_pos_target=f(N, 12),
        default_joint_q=np.tile(np.float32([0.1, 0.8, -1.5] * 4), (N, 1)),
        soft_pos_limits=np.tile(soft[None], (N, 1, 1)),
        foot_forces=f(N, 4, 3) * 50, foot_velocities=f(N, 4, 3),
        prev_foot_velocities=f(N, 4, 3),
        foot_positions=f(N, 4, 3) * 0.2 + np.float32([0, 0, 0.02]),
        desired_contact_states=rng.rand(N, 4).astype(np.float32),
        foot_indices=rng.rand(N, 4).astype(np.float32),
        contact_filt=rng.rand(N, 4) < 0.5,
        thigh_contact=np.abs(f(N, 4)) * (rng.rand(N, 4) < 0.5),
        calf_contact=np.abs(f(N, 4)) * (rng.rand(N, 4) < 0.5),
        feet_air_time=rng.rand(N, 4).astype(np.float32),
        first_contact=rng.rand(N, 4) < 0.3,
        dt=np.full(N, 0.02, np.float32), foot_side=np.tile(side, (N, 1)))


@pytest.mark.parametrize("name", sorted(trew.REWARD_FNS))
def test_reward_term_matches_jax(name):
    """Each CoRL reward term on shared random inputs (15-command space so
    every command index is live): rtol 1e-5, atol 1e-5 (float32)."""
    inp = _reward_inputs()
    jcfg_ = jcfg.go1_mob_config(num_envs=16)
    ref = jax.vmap(lambda c: jrew.REWARD_FNS[name](c, jcfg_))(
        jrew.RewardCtx(**{k: jnp.asarray(v) for k, v in inp.items()}))
    tin = {k: torch.from_numpy(np.asarray(v)) for k, v in inp.items()}
    tin["default_joint_q"] = tin["default_joint_q"][0]
    tin["soft_pos_limits"] = tin["soft_pos_limits"][0]
    tin["foot_side"] = tin["foot_side"][0]
    tin["dt"] = 0.02
    got = trew.REWARD_FNS[name](trew.RewardCtx(**tin),
                                tcfg.go1_mob_config(num_envs=16))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def _all_obs_flags(module, preset):
    cfg = module.PRESETS[preset]()
    on = {f.name: True for f in dataclasses.fields(cfg.env)
          if f.name.startswith("priv_observe_")}
    return dataclasses.replace(cfg, env=dataclasses.replace(
        cfg.env, observe_vel=True, observe_yaw=True,
        observe_contact_states=True, observe_timing_parameter=True, **on))


@pytest.mark.parametrize("preset", ["go1_flat", "go1_mob"])
def test_observations_match_jax(preset):
    """build_obs / build_privileged_obs / noise_scale_vec with every
    observation flag on: atol 1e-6."""
    jc, tc = _all_obs_flags(jcfg, preset), _all_obs_flags(tcfg, preset)
    N, nc = 8, jc.commands.num_commands
    rng = np.random.RandomState(2)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    q = f(N, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    o = dict(projected_gravity=f(N, 3), commands=f(N, nc), joint_q=f(N, 12),
             joint_qd=f(N, 12), default_joint_q=f(12), actions=f(N, 12),
             last_actions=f(N, 12), clock_inputs=f(N, 4),
             gait_index=f(N), base_lin_vel=f(N, 3), base_ang_vel=f(N, 3),
             base_quat=q, contact_states=rng.rand(N, 4) < 0.5)
    p = dict(friction=f(N), restitution=f(N), payload=f(N),
             com_displacement=f(N, 3), motor_strength=f(N, 12),
             motor_offset=f(N, 12), Kp_factor=f(N, 12), Kd_factor=f(N, 12),
             base_lin_vel=f(N, 3), base_height=f(N), gravity_offset=f(3),
             clock_inputs=f(N, 4), desired_contact_states=f(N, 4))
    axes = {k: (None if k == "default_joint_q" else 0) for k in o}
    ref_o = jax.vmap(lambda d: jobs.build_obs(jc, **d),
                     in_axes=(axes,))({k: jnp.asarray(v) for k, v in o.items()})
    paxes = {k: (None if k == "gravity_offset" else 0) for k in p}
    ref_p = jax.vmap(lambda d: jobs.build_privileged_obs(jc, **d),
                     in_axes=(paxes,))({k: jnp.asarray(v) for k, v in p.items()})
    got_o = tobs.build_obs(tc, **{k: torch.from_numpy(np.asarray(v))
                                  for k, v in o.items()})
    got_p = tobs.build_privileged_obs(tc, **{k: torch.from_numpy(v)
                                             for k, v in p.items()})
    np.testing.assert_allclose(got_o.numpy(), np.asarray(ref_o), atol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), atol=1e-6)
    np.testing.assert_array_equal(tobs.noise_scale_vec(tc),
                                  jobs.noise_scale_vec(jc))


@pytest.mark.parametrize("preset", ["go1_flat", "go1_mob"])
def test_curriculum_grid_and_sampler_match_jax(preset):
    """Grid, initial weights and the inverse-CDF sampler fed JAX's own
    uniform draws: identical bins, commands at atol 1e-6."""
    jc, tc = jcfg.PRESETS[preset]().commands, tcfg.PRESETS[preset]().commands
    jg, tg = jcurr.build_grid(jc), tcurr.build_grid(tc)
    for f in ("centers", "bin_sizes", "adjacency", "lows", "highs"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)))
    jw = jcurr.init_state(jc, jg)
    tw = tcurr.init_weights(tc, tg)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw.weights))
    # a non-trivial weight pattern
    rng = np.random.RandomState(0)
    w = (rng.rand(*tw.shape) < 0.3).astype(np.float32)
    w[:, 0] = 1.0
    N = 32
    cats = rng.randint(0, w.shape[0], N)
    keys = jax.random.split(jax.random.PRNGKey(4), N)
    with jax.disable_jit():
        ref_cmd, ref_bin = jcurr.sample_commands_batched(
            jg, jcurr.CurriculumState(weights=jnp.asarray(w)),
            jnp.asarray(cats), keys)
        ks = jax.vmap(jax.random.split)(keys)
        u_bin = jax.vmap(jax.random.uniform)(ks[:, 0])
        u_jit = jax.vmap(lambda k: jax.random.uniform(
            k, (jg.centers.shape[0],)))(ks[:, 1])
    got_cmd, got_bin = tcurr.sample_commands_batched(
        tg, torch.from_numpy(w), torch.from_numpy(cats),
        torch.from_numpy(np.array(u_bin)), torch.from_numpy(np.array(u_jit)))
    np.testing.assert_array_equal(got_bin.numpy(), np.asarray(ref_bin))
    np.testing.assert_allclose(got_cmd.numpy(), np.asarray(ref_cmd), atol=1e-6)


def test_curriculum_update_and_gait_category_match_jax():
    jc, tc = jcfg.go1_mob_config().commands, tcfg.go1_mob_config().commands
    jg, tg = jcurr.build_grid(jc), tcurr.build_grid(tc)
    rng = np.random.RandomState(1)
    n_bins = tg.centers.shape[1]
    w = rng.rand(4, n_bins).astype(np.float32) * 0.5
    N = 64
    cat, bins = rng.randint(0, 4, N), rng.randint(0, n_bins, N)
    succ, mask = rng.rand(N) < 0.5, rng.rand(N) < 0.7
    ref = jcurr.update_weights(jg, jcurr.CurriculumState(jnp.asarray(w)),
                               jnp.asarray(cat), jnp.asarray(bins),
                               jnp.asarray(succ), jnp.asarray(mask))
    got = tcurr.update_weights(tg, torch.from_numpy(w), torch.from_numpy(cat),
                               torch.from_numpy(bins), torch.from_numpy(succ),
                               torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.weights), atol=1e-6)
    cmds = rng.rand(N, 15).astype(np.float32)
    for binary in (False, True):
        ref_c = jcurr.apply_gait_category_batched(jnp.asarray(cmds),
                                                  jnp.asarray(cat), binary)
        got_c = tcurr.apply_gait_category_batched(
            torch.from_numpy(cmds), torch.from_numpy(cat), binary)
        np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), atol=1e-6)
