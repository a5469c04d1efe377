"""Parity of the port's rough-terrain task (`train_parkour --task terrain`:
the Stack-A map with no ceiling, the fixed trot clock, the Go2 actuator
net, the imu and clock observations, the pre-reset observation and both
reward modes; wtw_tpu_torch on the CPU) against the JAX package, and of
the soft-p curriculum's float32 sum.

Inputs come from numpy with a seed and go to both sides. The JAX env runs
un-jitted (`jax.disable_jit()`) on its batched XLA path
(`physics_backend="xla"`, the plain reference of its Pallas kernels) on
the task's own map at its defaults (10 x 20 cells of 5 m at 0.1 m with an
8 m border: a 660 x 1160 field). Random draws that torch cannot reproduce
are switched off: observation noise, pushes, and the in-episode command
updates (`only_forwards`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtw_tpu.envs.parkour_env import ParkourCfg as JaxParkourCfg
from wtw_tpu.envs.parkour_env import ParkourEnv as JaxParkourEnv
from wtw_tpu.models import load_robot as jax_load_robot
from wtw_tpu.models.actuator_net import load_actuator_net as jax_load_net

from wtw_tpu_torch.convert import parkour_world_from_jax
from wtw_tpu_torch.envs.parkour_env import (ParkourCfg, ParkourEnv,
                                            soft_p_step)
from wtw_tpu_torch.models import load_robot
from wtw_tpu_torch.models.actuator_net import load_actuator_net
from wtw_tpu_torch.physics.heightfield import height_at

N = 4
# Go2Terrain's options (scripts/train_parkour.py:100-105) and the optional
# observations, with every random draw off
TASK = dict(num_envs=N, task="terrain", use_gait_clocks=True,
            observe_clock_inputs=True, use_actuator_net=True,
            observe_imu=True, provide_true_next_obs=True, add_noise=False,
            push_robots=False, only_forwards=True)


def test_soft_p_progress_sums_in_float32_as_jax():
    """The soft-p curriculum over 200,000 steps at the default
    soft_p_total_steps (24 x 8000): JAX's recurrence (a float32 scalar plus
    the weakly typed 1 / total, clipped; wtw_tpu/envs/parkour_env.py:
    755-760) in a jitted fori_loop, the port's `soft_p_step` step by step.
    The progress and soft_p carry the same float32 bits at every 1,000th
    step, and 1.0 is first reached at the same step (192,325, not the
    192,000 of an exact sum). soft_p is JAX's jitted value: XLA fuses the
    multiply-add of its denominator (one rounding), and so does the
    port."""
    cfg = ParkourCfg()
    total = cfg.soft_p_total_steps
    steps, every = 200_000, 1000

    def jax_step(p):
        p = jnp.clip(p + 1.0 / total, 0.0, 1.0)
        t_start, t_end = 25.0, 1.0 / cfg.soft_p
        return p, 1.0 / (t_start + p * (t_end - t_start))

    @jax.jit
    def jax_run():
        def inner(i, c):
            p, _, hit = c
            p, sp = jax_step(p)
            hit = jnp.where((hit < 0) & (p >= 1.0), i + 1, hit)
            return p, sp, hit

        def outer(c, k):
            c = jax.lax.fori_loop(k * every, (k + 1) * every, inner, c)
            return c, (c[0], c[1])

        c, (ps, sps) = jax.lax.scan(
            outer, (jnp.float32(0.0), jnp.float32(0.0), jnp.int32(-1)),
            jnp.arange(steps // every))
        return ps, sps, c[2]

    jps, jsps, jhit = jax_run()
    p, hit, ps, sps = np.float32(0.0), -1, [], []
    for i in range(steps):
        p, sp = soft_p_step(p, cfg)
        if hit < 0 and p >= 1.0:
            hit = i + 1
        if (i + 1) % every == 0:
            ps.append(p)
            sps.append(sp)
    assert all(type(x) is np.float32 for x in ps + sps)
    np.testing.assert_array_equal(np.array(ps).view(np.int32),
                                  np.asarray(jps).view(np.int32))
    np.testing.assert_array_equal(np.array(sps).view(np.int32),
                                  np.asarray(jsps).view(np.int32))
    assert hit == int(jhit) == 192_325


def test_parkour_cfg_tree_equals_jax(tmp_path):
    """The port's ParkourCfg is the JAX one field for field (the terrain
    task's reward scales and map config included), but for
    `survival_bonus`, which nothing reads; so is the config that
    `train_parkour --task terrain --reward-mode full` builds."""
    import dataclasses
    from wtw_tpu_torch.train_parkour import build
    ref = dataclasses.asdict(JaxParkourCfg())
    assert ref.pop("survival_bonus") == 0.5
    assert dataclasses.asdict(ParkourCfg()) == ref
    cfg = build(8, ["rough_terrain.num_rows=3", "rough_terrain.num_cols=3"],
                "cpu", task="terrain", reward_mode="full",
                run_dir=str(tmp_path)).env.cfg
    assert (cfg.task, cfg.reward_mode, cfg.use_gait_clocks,
            cfg.observe_clock_inputs, cfg.use_actuator_net) == (
        "terrain", "full", True, True, True)


def test_go2_actuator_net_is_the_jax_packages():
    """The port's copy of actuator_go2.npz is the JAX package's, array for
    array."""
    jp, tp = jax_load_net("actuator_go2"), load_actuator_net("actuator_go2")
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


@pytest.fixture(scope="module")
def terrain_envs():
    """Both envs for each reward mode, on the task's default map, and the
    JAX initial world with every base 0.31 m over the ground under it, so
    the feet (0.32 m below the base at the default angles) touch down in
    the first substep."""
    out = {}
    for mode in ("cat", "full"):
        jenv = JaxParkourEnv(JaxParkourCfg(reward_mode=mode, **TASK),
                             jax_load_robot("go2"), seed=0,
                             physics_backend="xla")
        tenv = ParkourEnv(ParkourCfg(reward_mode=mode, **TASK),
                          load_robot("go2"), seed=0, device="cpu")
        out[mode] = (jenv, tenv)
    with jax.disable_jit():
        jworld = out["cat"][0].init_state(jax.random.PRNGKey(0))
    pos = np.array(jworld.env.phys.base_pos)
    ground = height_at(out["cat"][1].hf, torch.from_numpy(pos[:, :2]))
    pos[:, 2] = ground.numpy() + 0.31
    jworld = jworld.replace(env=jworld.env.replace(
        phys=jworld.env.phys.replace(base_pos=jnp.asarray(pos))))
    return out, jworld


def test_terrain_task_layout_matches_jax(terrain_envs):
    """The map, origins, curriculum tables and observation layout equal
    JAX's; there is no ceiling field."""
    envs, jworld = terrain_envs
    jenv, tenv = envs["cat"]
    assert tenv.hf_ceiling is None and jenv.hf_ceiling is None
    assert tuple(tenv.hf.shape) == (660, 1160)
    np.testing.assert_array_equal(tenv.hf.heights.numpy(),
                                  np.asarray(jenv.hf.heights))
    for f in ("init_origins", "init_levels", "init_types", "terrain_origins",
              "terrain_ceilings"):
        np.testing.assert_array_equal(getattr(tenv, f).numpy(),
                                      np.asarray(getattr(jenv, f)), err_msg=f)
    assert (tenv.track_length, tenv.num_terrain_levels) == (
        jenv.track_length, jenv.num_terrain_levels) == (5.0, 10)
    # 3 + 3 + 39 + 143 + 1 + imu 3 + clock 4
    assert tenv.num_obs == jenv.num_obs == 196
    np.testing.assert_array_equal(tenv.noise_vec.numpy(),
                                  np.asarray(jenv.noise_vec))
    tworld = parkour_world_from_jax(jax.tree.map(np.asarray, jworld))
    np.testing.assert_array_equal(tenv.get_observations(tworld).numpy(),
                                  np.asarray(jenv.get_observations(jworld)))


@pytest.mark.parametrize("mode", ["cat", "full"])
def test_terrain_task_steps_match_jax(terrain_envs, mode):
    """Policy steps of the terrain task from one carried-over world, 4 envs
    on the task's map, with the gait clock, the actuator net, the imu and
    clock observations and the pre-reset observation on; CaT's tracking
    reward or the full battery (raibert term included). No hard done may
    occur (asserted): a reset draws from the generator. Bars: observations,
    the pre-reset observation, rewards and done probabilities at 1e-4
    absolute; the gait clock at 1e-4; the actuator history, the previous
    joint and base velocities at the state bar, 2e-4 (12 float32 substeps
    with the feet on the ground), torques at 100x that; CaT running maxima
    at 1e-4 relative; the soft-p progress bit-identical."""
    envs, jworld = terrain_envs
    jenv, tenv = envs[mode]
    tworld = parkour_world_from_jax(jax.tree.map(np.asarray, jworld))
    rng = np.random.RandomState(1)
    for step in range(3 if mode == "cat" else 2):
        a = (0.3 * rng.randn(N, 12)).astype(np.float32)
        with jax.disable_jit():
            jworld, jobs, jrew, jdone, jinfo = jenv.step(jworld,
                                                         jnp.asarray(a))
        tworld, tobs, trew, tdone, tinfo = tenv.step(tworld,
                                                     torch.from_numpy(a))
        assert not np.asarray(jinfo["true_dones"]).any(), step
        np.testing.assert_array_equal(tinfo["true_dones"].numpy(),
                                      np.asarray(jinfo["true_dones"]))
        for got, ref, what in (
                (tobs, jobs, "obs"), (trew, jrew, "rew"),
                (tdone, jdone, "done prob"),
                (tinfo["true_next_obs"], jinfo["true_next_obs"],
                 "true next obs")):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=1e-4, err_msg=f"{what} @ {step}")
        e, je = tworld.env, jworld.env
        for f, tol in (("gait_index", 1e-4), ("clock_inputs", 1e-4),
                       ("foot_indices", 1e-4), ("last_last_actions", 0.0),
                       ("joint_pos_err_last", 2e-4),
                       ("joint_pos_err_last_last", 2e-4),
                       ("joint_vel_last", 2e-4), ("joint_vel_last_last", 2e-4),
                       ("last_joint_qd", 2e-4), ("last_base_lin_vel", 2e-4),
                       ("torques", 2e-2)):
            np.testing.assert_allclose(
                getattr(e, f).numpy(), np.asarray(getattr(je, f)), atol=tol,
                err_msg=f"{f} @ {step}")
        np.testing.assert_allclose(tworld.cat.running_max.numpy(),
                                   np.asarray(jworld.cat.running_max),
                                   rtol=1e-4, atol=1e-9)
        np.testing.assert_allclose(e.episode_sums.numpy(),
                                   np.asarray(je.episode_sums), atol=1e-4)
        assert tworld.soft_p_progress == np.asarray(jworld.soft_p_progress)
        # the un-jitted JAX step rounds soft_p's multiply and add apart
        assert float(tinfo["soft_p"]) == pytest.approx(
            float(jinfo["soft_p"]), rel=3e-7)
    # the clock advanced, the actuator net drove the joints, and every
    # env's feet are on the ground (touchdown zeroes their swing time)
    assert float(tworld.env.gait_index.abs().max()) > 0.0
    assert float(tworld.env.joint_pos_err_last.abs().max()) > 0.0
    assert bool((tworld.env.feet_swing_time == 0).any(dim=1).all())


def test_full_reward_battery_matches_jax(terrain_envs):
    """`_full_rewards` and `_raibert_error` (go2_terrain.py:612-646,
    :1024-1090) on one state and numpy contacts, on both sides: every term
    of the battery is active (random contact forces, calf contacts,
    touchdowns, swing times, previous actions and joint velocities), and
    the tracking terms are large enough that the total stays above the
    clip at 0, so the sum of the terms is compared. atol 1e-4 (the
    rewards' bar), raibert error at 1e-5."""
    from wtw_tpu.physics.state import ContactInfo as JaxContactInfo
    from wtw_tpu_torch.physics import ContactInfo
    envs, jworld = terrain_envs
    jenv, tenv = envs["full"]
    rng = np.random.RandomState(3)
    f = lambda *shape: rng.randn(*shape).astype(np.float32)
    je = jworld.env.replace(
        actions=jnp.asarray(f(N, 12)), last_actions=jnp.asarray(f(N, 12)),
        last_last_actions=jnp.asarray(f(N, 12)),
        last_joint_qd=jnp.asarray(f(N, 12)), torques=jnp.asarray(5 * f(N, 12)),
        foot_indices=jnp.asarray(rng.uniform(0, 1, (N, 4)).astype(np.float32)),
        commands=jnp.asarray(f(N, 3)),
        phys=jworld.env.phys.replace(joint_qd=jnp.asarray(8 * f(N, 12))))
    pos = np.asarray(je.phys.base_pos)
    ci = dict(foot_forces=8 * f(N, 4, 3),
              foot_positions=pos[:, None] + 0.3 * f(N, 4, 3),
              foot_velocities=f(N, 4, 3), thigh_contact=np.abs(f(N, 4)),
              calf_contact=np.abs(2 * f(N, 4)), base_contact=np.abs(f(N)),
              total_normal_force=np.abs(f(N)))
    blv, bav, pg = f(N, 3), f(N, 3), 0.2 * f(N, 3)
    touch = rng.rand(N, 4) > 0.5
    swing = rng.uniform(0, 0.5, (N, 4)).astype(np.float32)
    rew_lin = (50 + f(N)).astype(np.float32)
    rew_ang = f(N)
    te = parkour_world_from_jax(jax.tree.map(
        np.asarray, jworld.replace(env=je))).env
    jci = JaxContactInfo(**{k: jnp.asarray(v) for k, v in ci.items()})
    tci = ContactInfo(**{k: torch.from_numpy(v) for k, v in ci.items()})
    T = torch.from_numpy
    with jax.disable_jit():
        jr = jenv._full_rewards(je, jci, *map(jnp.asarray, (blv, bav, pg)),
                                jnp.asarray(touch), jnp.asarray(swing),
                                jnp.asarray(rew_lin), jnp.asarray(rew_ang),
                                jenv.cfg.terrain_rewards)
        jr_err = jenv._raibert_error(je, jci)
    tr = tenv._full_rewards(te, tci, T(blv), T(bav), T(pg), T(touch),
                            T(swing), T(rew_lin), T(rew_ang))
    np.testing.assert_allclose(tenv._raibert_error(te, tci).numpy(),
                               np.asarray(jr_err), atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4)
    assert float(np.asarray(jr).min()) > 0.0


def test_terrain_resets_clear_the_gait_and_actuator_history(terrain_envs):
    """`_reset_envs_at_origin` (go2_parkour.py:1035-1124) zeroes the gait
    index, the actuator history, the previous actions and joint velocities
    of the envs it resets and leaves the others as they were: envs 0 and 2
    reset, from one state with every such field non-zero, as in JAX."""
    envs, jworld = terrain_envs
    jenv, tenv = envs["cat"]
    rng = np.random.RandomState(2)
    fields = ("gait_index", "joint_pos_err_last", "joint_pos_err_last_last",
              "joint_vel_last", "joint_vel_last_last", "last_joint_qd",
              "last_last_actions", "last_actions", "actions")
    je = jworld.env.replace(**{
        f: jnp.asarray(rng.uniform(0.1, 0.9, np.shape(getattr(jworld.env, f)))
                       .astype(np.float32)) for f in fields})
    mask = np.array([True, False, True, False])
    with jax.disable_jit():
        jr = jenv._reset_envs_at_origin(je, jnp.asarray(mask))
    te = parkour_world_from_jax(jax.tree.map(
        np.asarray, jworld.replace(env=je))).env
    tr = tenv._reset_envs_at_origin(te, torch.from_numpy(mask),
                                    torch.Generator().manual_seed(0))
    for f in fields:
        got, ref = getattr(tr, f).numpy(), np.asarray(getattr(jr, f))
        np.testing.assert_array_equal(got[~mask], ref[~mask], err_msg=f)
        np.testing.assert_array_equal(got[mask], 0.0, err_msg=f)
        np.testing.assert_array_equal(ref[mask], 0.0, err_msg=f)



def test_train_parkour_cli_trains_the_terrain_task(tmp_path):
    """`python -m wtw_tpu_torch.train_parkour --task terrain` on the CPU, on
    a 3 x 3-cell map with a 1 m border, at narrow widths: Go2Terrain's
    options are on (gait clock observed, actuator net, no ceiling), an
    iteration writes the CSV and the exact-resume state with a finite
    value loss, and `--reward-mode full` continues from that state (the
    iteration count goes on in the same CSV)."""
    import csv
    import os
    from wtw_tpu_torch.train_parkour import build, main
    small = ["--set", "rough_terrain.num_rows=3", "--set",
             "rough_terrain.num_cols=3", "--set",
             "rough_terrain.border_size=1.0", "--set", "ppo.hidden=32,16"]
    base = ["--task", "terrain", "--device", "cpu", "--num-envs", "8",
            "--horizon", "4", "--log-freq", "1", "--run-dir", str(tmp_path)]
    runner = build(8, small[1::2], "cpu", horizon=4, run_dir=str(tmp_path),
                   task="terrain")
    cfg = runner.env.cfg
    assert (cfg.task, cfg.use_gait_clocks, cfg.observe_clock_inputs,
            cfg.use_actuator_net, cfg.reward_mode) == (
        "terrain", True, True, True, "cat")
    assert runner.env.hf_ceiling is None and runner.env.num_obs == 193
    assert tuple(runner.env.hf.shape) == (170, 170)
    main(base + ["--iterations", "1"] + small)
    state = os.path.join(str(tmp_path), "state_last.pt")
    main(base + ["--iterations", "1", "--reward-mode", "full", "--resume",
                 state] + small)
    with open(os.path.join(str(tmp_path), "metrics.csv")) as fh:
        rows = list(csv.DictReader(fh))
    assert [int(r["iteration"]) for r in rows] == [0, 1]
    assert all(np.isfinite(float(r["value_loss"])) for r in rows)
