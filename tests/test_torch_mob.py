"""Parity of the port's go1_mob slice (Stack-A terrain, the gait clock, the
actuator net, the actuator-model wrapper and the env on a heightfield;
wtw_tpu_torch on the CPU) against the JAX package.

Inputs come from numpy with a seed and go to both sides. The JAX env runs
un-jitted (`jax.disable_jit()`) on its batched XLA path
(`physics_backend="xla"`, the plain reference of its Pallas kernels) on a
reduced map: 3 x 3 cells of the preset's 5 m at 0.1 m (a 150 x 150 field).
Random draws that torch cannot reproduce are switched off: observation
noise, and every periodic draw is not due in the 3-step window (see the
env test's docstring).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtw_tpu import config as jcfg
from wtw_tpu.envs import LeggedEnv as JaxLeggedEnv
from wtw_tpu.envs import gait as jgait
from wtw_tpu.envs.wrappers import ActuatorModelArgs as JaxArgs
from wtw_tpu.envs.wrappers import ActuatorModelWrapper as JaxWrapper
from wtw_tpu.models import load_robot as jax_load_robot
from wtw_tpu.models.actuator_net import apply_actuator_net as jax_apply_net
from wtw_tpu.models.actuator_net import load_actuator_net as jax_load_net
from wtw_tpu.physics import batched as jbatched
from wtw_tpu.physics.heightfield import height_min3 as jax_height_min3
from wtw_tpu.physics.heightfield import make_heightfield as jax_make_hf
from wtw_tpu.terrain import assign_env_origins as jax_assign_origins
from wtw_tpu.terrain import build_terrain as jax_build_terrain
from wtw_tpu.terrain import to_heightfield as jax_to_hf

from wtw_tpu_torch import config as tcfg
from wtw_tpu_torch.convert import actuator_params_from_jax, world_from_jax
from wtw_tpu_torch.envs import gait as tgait
from wtw_tpu_torch.envs import make_legged_env
from wtw_tpu_torch.envs.parkour_env import rough_terrain_cfg
from wtw_tpu_torch.envs.wrappers import (ActuatorModelArgs,
                                         ActuatorModelWrapper)
from wtw_tpu_torch.models.actuator_net import (apply_actuator_net,
                                               load_actuator_net)
from wtw_tpu_torch.physics.batched import _hf_gather, _hf_rows
from wtw_tpu_torch.physics.heightfield import height_min3, make_heightfield
from wtw_tpu_torch.terrain import (assign_env_origins, build_terrain,
                                   to_heightfield)

N = 4
SMALL = dict(num_rows=3, num_cols=3)


def _mob_cfg(module, **terrain):
    cfg = module.go1_mob_config(num_envs=N)
    return dataclasses.replace(
        cfg, terrain=dataclasses.replace(cfg.terrain, **SMALL, **terrain),
        noise=dataclasses.replace(cfg.noise, add_noise=False))


# ---------------------------------------------------------------------------
# terrain
# ---------------------------------------------------------------------------

# every generator branch of _make_subterrain, with random choices
_MIXED = dict(terrain_proportions=(0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1,
                                   0.1, 0.1), terrain_length=4.0,
              terrain_width=4.0, num_rows=4, num_cols=5, border_size=1.0)


@pytest.mark.parametrize("case", ["go1_mob", "mixed", "curriculum",
                                  "eval_rows", "terrain_task"])
def test_build_terrain_and_origins_are_bit_identical(case):
    """Heights, origins, cell origins and the per-env (level, type)
    assignment for one seed: exact. Cases: go1_mob's terrain on 3 x 3
    cells; every sub-terrain kind drawn at random, with a border; the
    curriculum layout (difficulty by row, type by column) with origins over
    the initial levels; go1_mob with the eval rows of a second config; the
    map of `train_parkour --task terrain` at its defaults (the port's
    `rough_terrain_cfg()`, equal to the config of wtw_tpu/envs/
    parkour_env.py:301-305: 10 x 20 cells of 5 m with an 8 m border, a
    660 x 1160 field, robots at the cell starts on level 0)."""
    base = jcfg.go1_mob_config().terrain
    kw, eval_kw, seed = dict(SMALL), None, 5
    if case == "terrain_task":
        base = jcfg.TerrainCfg(
            curriculum=True, num_rows=10, num_cols=20, border_size=8.0,
            center_robots=False, max_init_terrain_level=0,
            terrain_proportions=(0.2, 0.2, 0.2, 0.2, 0.2, 0, 0, 0, 0))
        assert dataclasses.asdict(rough_terrain_cfg()) \
            == dataclasses.asdict(base)
        kw = {}
    elif case == "mixed":
        kw = dict(_MIXED)
    elif case == "curriculum":
        kw = dict(_MIXED, curriculum=True, center_robots=False,
                  max_init_terrain_level=2)
    elif case == "eval_rows":
        eval_kw = dict(_MIXED, num_rows=2, num_cols=3, terrain_length=5.0,
                       terrain_width=5.0, border_size=0.0)
    jc = dataclasses.replace(base, **kw)
    tc = (rough_terrain_cfg() if case == "terrain_task" else
          dataclasses.replace(tcfg.go1_mob_config().terrain, **kw))
    je = (dataclasses.replace(base, **eval_kw) if eval_kw else None)
    te = (dataclasses.replace(tcfg.go1_mob_config().terrain, **eval_kw)
          if eval_kw else None)
    jm = jax_build_terrain(jc, seed=seed, eval_cfg=je)
    tm = build_terrain(tc, seed=seed, eval_cfg=te)
    for f in ("heights", "env_origins", "origin"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f),
                                      err_msg=f)
    assert (tm.horizontal_scale, tm.num_rows, tm.num_cols,
            tm.num_eval_rows) == (jm.horizontal_scale, jm.num_rows,
                                  jm.num_cols, jm.num_eval_rows)
    assert float(np.abs(tm.heights).max()) > 0.0
    for a, b in zip(assign_env_origins(tm, 37, tc, seed=seed),
                    jax_assign_origins(jm, 37, jc, seed=seed)):
        np.testing.assert_array_equal(a, b)
    if case == "terrain_task":
        assert tm.heights.shape == (660, 1160)
    np.testing.assert_array_equal(to_heightfield(tm).corners.numpy(),
                                  np.asarray(jax_to_hf(jm).corners))


@pytest.mark.parametrize("cached", [False, True])
def test_corner_rows_at_and_past_the_edges_match_jax(cached):
    """Kernel B's inputs for spheres over the field's last cells and up to
    1 m beyond each edge (go1_mob has a 0 m border): the cell coordinates
    clamp as JAX clamps them (`_hf_uv`), so the corner rows are exact and
    the in-cell offsets agree at 1e-6; with `cached` the rows come from a
    gather at other points and the offsets are clamped to [0, 1]."""
    rng = np.random.RandomState(4)
    hts = (0.1 * rng.randn(40, 30)).astype(np.float32)
    jhf = jax_make_hf(jnp.asarray(hts), 0.1, [0.0, 0.0])
    thf = make_heightfield(hts, 0.1, [0.0, 0.0])
    P, B = 6, 64
    edge = lambda hi: np.concatenate([rng.uniform(-1.0, 0.3, B // 2),
                                      rng.uniform(hi - 0.3, hi + 1.0, B // 2)])
    x = np.stack([rng.permutation(edge(4.0)) for _ in range(P)])
    y = np.stack([rng.permutation(edge(3.0)) for _ in range(P)])
    x, y = x.astype(np.float32), y.astype(np.float32)
    jcache = tcache = None
    if cached:
        x0 = (x + rng.uniform(-0.15, 0.15, x.shape)).astype(np.float32)
        y0 = (y + rng.uniform(-0.15, 0.15, y.shape)).astype(np.float32)
        jcache = jbatched._hf_gather(jhf, jnp.asarray(x0), jnp.asarray(y0))
        tcache = _hf_gather(thf, torch.from_numpy(x0), torch.from_numpy(y0))
    jhc, jdu, jdv = jbatched._hf_rows(jhf, jnp.asarray(x), jnp.asarray(y),
                                      cached=jcache)
    thc, tduv = _hf_rows(thf, torch.from_numpy(x), torch.from_numpy(y),
                         cached=tcache)
    for k in range(4):
        np.testing.assert_array_equal(thc[k].numpy(), np.asarray(jhc[k]))
    np.testing.assert_allclose(tduv[0].numpy(), np.asarray(jdu), atol=1e-6)
    np.testing.assert_allclose(tduv[1].numpy(), np.asarray(jdv), atol=1e-6)
    assert float(tduv.min()) >= 0.0 and float(tduv.max()) <= 1.0


# ---------------------------------------------------------------------------
# gait clock, actuator net, actuator-model wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pacing_offset", [False, True])
def test_step_gait_matches_jax(pacing_offset):
    """All six outputs of one gait-clock step for 64 envs over the MoB
    command ranges (durations 0.2-0.8 to reach both warp branches):
    atol 1e-6."""
    rng = np.random.RandomState(3)
    n = 64
    cmds = rng.uniform(-1, 1, (n, 15)).astype(np.float32)
    cmds[:, 4] = rng.uniform(2.0, 4.0, n)
    cmds[:, 5:8] = rng.uniform(0.0, 1.0, (n, 3))
    cmds[:, 8] = rng.uniform(0.2, 0.8, n)
    gi = rng.uniform(0, 1, n).astype(np.float32)
    ref = jax.vmap(lambda g, c: jgait.step_gait(
        g, c, 0.02, 0.07, pacing_offset))(jnp.asarray(gi), jnp.asarray(cmds))
    got = tgait.step_gait(torch.from_numpy(gi), torch.from_numpy(cmds), 0.02,
                          0.07, pacing_offset)
    for k, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6,
                                   err_msg=str(k))


def test_actuator_net_matches_jax():
    """The shipped go1 net (the port's copy of actuator_go1.npz is the JAX
    package's, byte for byte) on position errors of ~1e-2 rad and
    velocities of ~10 rad/s for (64, 12) joints: atol 1e-5."""
    jp = jax_load_net("actuator_go1")
    tp = load_actuator_net("actuator_go1")
    conv = actuator_params_from_jax(jax.tree.map(np.asarray, jp))
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
        np.testing.assert_array_equal(conv[k].numpy(), tp[k].numpy())
    rng = np.random.RandomState(6)
    ins = [(0.02 * rng.randn(64, 12)).astype(np.float32) for _ in range(3)]
    ins += [(10.0 * rng.randn(64, 12)).astype(np.float32) for _ in range(3)]
    ref = jax.vmap(lambda *a: jax_apply_net(jp, *a))(*map(jnp.asarray, ins))
    got = apply_actuator_net(tp, *map(torch.from_numpy, ins))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert float(np.abs(np.asarray(ref)).max()) > 1.0


class _Recorder:
    """An env whose step returns the actions it was given as its obs."""

    def __init__(self):
        self.num_envs, self.num_actions = 5, 12
        self.device = torch.device("cpu")

    def step(self, world, actions):
        return world, actions, 0.0, 0.0, {}


def _qd_world(qd):
    phys = type("P", (), {"joint_qd": qd})()
    return type("W", (), {"env": type("E", (), {"phys": phys})()})()


@pytest.mark.parametrize("delay", [1.0, 1.6])
def test_actuator_model_wrapper_step_matches_jax(delay):
    """Five wrapper steps (Catmull-Rom delay, stiction and viscous
    friction, low-pass filter) on the same actions and joint velocities:
    the actions the env receives at atol 1e-6. `delay` 1.6 policy steps
    reaches the cubic's fractional branch."""
    jw = JaxWrapper(_Recorder(), JaxArgs(delay_steps=delay))
    tw = ActuatorModelWrapper(_Recorder(), ActuatorModelArgs(
        delay_steps=delay))
    jws = jw.init_wrapper_state()
    tws = tw.init_wrapper_state()
    rng = np.random.RandomState(7)
    for step in range(5):
        a = rng.randn(5, 12).astype(np.float32)
        qd = (3.0 * rng.randn(5, 12)).astype(np.float32)
        (_, jws), jout, *_ = jw.step((_qd_world(jnp.asarray(qd)), jws),
                                     jnp.asarray(a))
        (_, tws), tout, *_ = tw.step((_qd_world(torch.from_numpy(qd)), tws),
                                     torch.from_numpy(a))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-6,
                                   err_msg=f"step {step}")
    np.testing.assert_allclose(tws.action_buffer.numpy(),
                               np.asarray(jws.action_buffer), atol=0)


# ---------------------------------------------------------------------------
# the env on a heightfield
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mob():
    """The JAX env on the reduced go1_mob map (xla backend) and its initial
    world after `get_observations`, with the map's origins."""
    cfg = _mob_cfg(jcfg)
    jm = jax_build_terrain(cfg.terrain, seed=0)
    origins, _, _ = jax_assign_origins(jm, N, cfg.terrain, seed=0)
    jenv = JaxLeggedEnv(cfg, jax_load_robot("go1"), heightfield=jax_to_hf(jm),
                        env_origins=origins, physics_backend="xla")
    with jax.disable_jit():
        jworld = jenv.init_state(jax.random.PRNGKey(0))
        jworld, jod = jenv.get_observations(jworld)
    return jm, origins, jenv, jworld, jod


def _jax_env(jm, origins, cfg):
    return JaxLeggedEnv(cfg, jax_load_robot("go1"), heightfield=jax_to_hf(jm),
                        env_origins=origins, physics_backend="xla")


def _run_both(jenv, tenv, jworld, tworld, steps, check=True, seed=0):
    rng = np.random.RandomState(seed)
    for step in range(steps):
        a = (0.3 * rng.randn(N, 12)).astype(np.float32)
        with jax.disable_jit():
            jworld, jod, jrew, jdone, _ = jenv.step(jworld, jnp.asarray(a))
        tworld, tod, trew, tdone, _ = tenv.step(tworld, torch.from_numpy(a))
        if not check:
            continue
        assert not np.asarray(jdone).any() and not tdone.any(), step
        for k in ("obs", "privileged_obs", "obs_history"):
            np.testing.assert_allclose(tod[k].numpy(), np.asarray(jod[k]),
                                       atol=1e-4, err_msg=f"{k} @ {step}")
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-4,
                                   err_msg=f"rew @ {step}")
        np.testing.assert_allclose(tworld.env.episode_sums.numpy(),
                                   np.asarray(jworld.env.episode_sums),
                                   atol=1e-4, err_msg=f"sums @ {step}")
        for f in ("gait_index", "clock_inputs", "desired_contact_states",
                  "foot_indices", "joint_pos_err_last", "joint_vel_last",
                  "joint_vel_last_last", "torques"):
            np.testing.assert_allclose(
                getattr(tworld.env, f).numpy(),
                np.asarray(getattr(jworld.env, f)),
                atol=1e-4 * (200.0 if f == "torques" else 1.0),
                err_msg=f"{f} @ {step}")
        np.testing.assert_array_equal(tworld.env.commands.numpy(),
                                      np.asarray(jworld.env.commands))
    return jworld, tworld, jdone, tdone


def test_mob_env_steps_match_jax_from_one_state(mob):
    """go1_mob (actuator net, gait clock, 15 commands, 70 x 30 history,
    lag buffer) on the reduced map, 4 envs, 3 policy steps from one
    carried-over state. The map and origins of the port's
    `make_legged_env` equal JAX's, and each env spawns at its cell's
    maximum height plus the init pose.

    Random draws are switched off or not due, so both sides are
    deterministic and equal: observation noise is off; command resampling
    (500 steps), the DR re-draw (200) and the gravity draw and its reset
    (every 400 steps, at common steps 400 k and 400 k + 396) are not due in
    the 3-step window; no env resets (asserted); pushes are off in go1_mob
    and the lag buffer draws nothing. Bars: obs, rewards, episode sums and
    the gait and actuator-history fields at 1e-4 absolute, torques at 200x
    that (the physics tests' force scale)."""
    jm, origins, jenv, jworld, jod = mob
    tenv = make_legged_env(_mob_cfg(tcfg), device="cpu", seed=0)
    np.testing.assert_array_equal(tenv.hf.heights.numpy(), jm.heights)
    np.testing.assert_array_equal(tenv.env_origins.numpy(), origins)
    assert not tenv.hf.is_flat and tenv.actuator_params is not None
    tworld = world_from_jax(jax.tree.map(np.asarray, jworld))
    z0 = tworld.env.phys.base_pos[:, 2] - tenv.env_origins[:, 2]
    np.testing.assert_allclose(z0.numpy(), 0.34, atol=1e-6)
    tobs, _ = tenv.observe(tworld)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jod["obs"]),
                               atol=1e-6)
    _run_both(jenv, tenv, jworld, tworld, 3)


def test_mob_env_options_match_jax(mob):
    """The options go1_mob leaves off, on together for 2 policy steps from
    the same state: pushes due every step at zero velocity (so the draw is
    the same on both sides and sets each base's xy velocity to 0), edge
    teleport with env 0 placed 0.1 m from the map's low-x edge and env 1
    0.1 m from its high-y edge, and the terminal-height check over the
    measured terrain (min-of-3 samples on the 17 x 11 yaw-rotated grid).
    Bars as in the 3-step test; the teleported bases at 1e-4."""
    jm, origins, _, jworld, _ = mob
    over = dict(domain_rand=dict(push_robots=True, push_interval_s=0.02,
                                 max_push_vel_xy=0.0),
                terrain=dict(teleport_robots=True, measure_heights=True))

    def cfg_of(module):
        cfg = _mob_cfg(module)
        return dataclasses.replace(cfg, **{
            k: dataclasses.replace(getattr(cfg, k), **v)
            for k, v in over.items()})
    jenv = _jax_env(jm, origins, cfg_of(jcfg))
    t = cfg_of(tcfg).terrain
    pos = np.array(jworld.env.phys.base_pos)
    pos[0, 0] = 0.1
    pos[1, 1] = t.terrain_width * t.num_cols - 0.1
    jworld = jworld.replace(env=jworld.env.replace(
        phys=jworld.env.phys.replace(base_pos=jnp.asarray(pos))))
    tenv = make_legged_env(cfg_of(tcfg), device="cpu", seed=0)
    tworld = world_from_jax(jax.tree.map(np.asarray, jworld))
    jworld, tworld, _, _ = _run_both(jenv, tenv, jworld, tworld, 2, seed=1)
    tpos = tworld.env.phys.base_pos.numpy()
    np.testing.assert_allclose(tpos, np.asarray(jworld.env.phys.base_pos),
                               atol=1e-4)
    # both teleports happened: env 0 moved up a span in x, env 1 down in y
    assert tpos[0, 0] > t.terrain_length and tpos[1, 1] < t.terrain_width * 2


def test_rigid_redraw_on_reset_matches_jax(mob):
    """Rigid-body DR re-drawn on reset (randomize_rigids_after_start):
    envs 0 and 2 time out on this step and draw friction, restitution,
    payload and CoM offset from one-point ranges (the same values on both
    sides); envs 1 and 3 keep their initial draws. Those four fields and
    the done flags: exact."""
    jm, origins, _, jworld, _ = mob
    dr = dict(randomize_rigids_after_start=True, friction_range=(0.7, 0.7),
              restitution_range=(0.3, 0.3), added_mass_range=(1.5, 1.5),
              randomize_com_displacement=True,
              com_displacement_range=(0.05, 0.05))
    cfg_of = lambda m: dataclasses.replace(
        _mob_cfg(m), domain_rand=dataclasses.replace(
            _mob_cfg(m).domain_rand, **dr))
    jenv = _jax_env(jm, origins, cfg_of(jcfg))
    tenv = make_legged_env(cfg_of(tcfg), device="cpu", seed=0)
    ep = np.zeros(N, np.int32)
    ep[[0, 2]] = tenv.max_episode_length - 1
    jworld = jworld.replace(env=jworld.env.replace(
        episode_length=jnp.asarray(ep)))
    tworld = world_from_jax(jax.tree.map(np.asarray, jworld))
    jworld, tworld, jdone, tdone = _run_both(jenv, tenv, jworld, tworld, 1,
                                             check=False)
    np.testing.assert_array_equal(tdone.numpy(), [True, False, True, False])
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    for f in ("friction", "restitution", "payload", "com_displacement"):
        got = getattr(tworld.env, f).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(jworld.env, f)),
                                      err_msg=f)
    assert tworld.env.friction[0] == np.float32(0.7) != tworld.env.friction[1]


def test_measured_body_height_matches_jax(mob):
    """The terminal check's body height over the measured terrain: the
    17 x 11 yaw-rotated grid under 64 random bases and the mean of the
    min-of-3 samples (`_height_points`, `height_min3`): atol 1e-6."""
    jm, origins, jenv, _, _ = mob
    tenv = make_legged_env(_mob_cfg(tcfg, measure_heights=True),
                           device="cpu", seed=0)
    rng = np.random.RandomState(8)
    pos = np.concatenate([rng.uniform(-0.5, 15.5, (64, 2)),
                          rng.uniform(0.2, 0.5, (64, 1))], 1).astype(np.float32)
    q = rng.randn(64, 4)
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    jpts = jenv._height_points(jnp.asarray(pos), jnp.asarray(q))
    ref = pos[:, 2] - np.asarray(jax.vmap(
        lambda p: jax_height_min3(jenv.hf, p))(jpts[..., :2])).mean(-1)
    tpts = tenv._height_points(torch.from_numpy(pos), torch.from_numpy(q))
    np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), atol=1e-6)
    got = pos[:, 2] - height_min3(tenv.hf, tpts[..., :2]).mean(-1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_one_gather_per_policy_step_on_the_mob_map(monkeypatch):
    """A go1_mob policy step gathers the ground's corner rows once, on its
    first substep, and none on the other three (the per-policy-step corner
    cache of `LeggedEnv.step`); a flat-ground step gathers none."""
    from wtw_tpu_torch.envs import legged_env
    from wtw_tpu_torch.physics import batched
    calls = []
    real_gather, real_step = batched._gather_at, legged_env.physics_step_batched

    def gather(hf, u, v):
        calls.append("gather")
        return real_gather(hf, u, v)

    def step(*a, **kw):
        calls.append("substep")
        return real_step(*a, **kw)

    monkeypatch.setattr(batched, "_gather_at", gather)
    monkeypatch.setattr(legged_env, "physics_step_batched", step)
    a = torch.zeros(N, 12)
    tenv = make_legged_env(_mob_cfg(tcfg), device="cpu", seed=0)
    assert tenv.cfg.control.decimation == 4
    tenv.step(tenv.init_state(0), a)
    assert calls == ["substep", "gather"] + ["substep"] * 3
    calls.clear()
    flat = make_legged_env(tcfg.go1_flat_config(num_envs=N), device="cpu")
    flat.step(flat.init_state(0), a)
    assert calls == ["substep"] * 4
