"""Mixed-robot batches in the port (wtw_tpu_torch.models.multi,
physics.engine, envs.multi_env, train_multi) on the CPU, against the JAX
package.

Inputs are drawn with numpy from a seed and fed to both sides. The JAX
side runs its per-robot engine mapped over the per-env model
(`jax.vmap(physics_step, in_axes=(0, ...))`, what its `vmap` physics
backend runs) under `jax.jit`: un-jitted, that map takes ~20 s a substep on
the CPU, a jit of it a few seconds to compile. Bars: the JAX repo's own
(tests/test_physics_batched.py:65-76: state 2e-4, contact forces and foot
kinematics 200x that; tests/test_multi_embodiment.py: 1e-5 between a mixed
and a pure batch); env observations and rewards at 1e-4, as in
tests/test_torch_env.py.
"""
import csv
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtw_tpu import config as jcfg
from wtw_tpu.envs.multi_env import make_multi_legged_env as jax_make_multi
from wtw_tpu.models import load_robot as jax_load_robot
from wtw_tpu.models.multi import assign_robots as jax_assign
from wtw_tpu.models.multi import stack_models as jax_stack
from wtw_tpu.physics import EngineParams as JaxEngineParams
from wtw_tpu.physics import PhysicsState as JaxPhysicsState
from wtw_tpu.physics import flat_heightfield as jax_flat_heightfield
from wtw_tpu.physics.engine import physics_step as jax_physics_step

from wtw_tpu_torch import config as tcfg
from wtw_tpu_torch.convert import world_from_jax
from wtw_tpu_torch.envs.multi_env import make_multi_legged_env
from wtw_tpu_torch.models import load_robot
from wtw_tpu_torch.models.multi import PAD_RADIUS, assign_robots, stack_models
from wtw_tpu_torch.models.robot import ARRAY_FIELDS
from wtw_tpu_torch.physics import (EngineParams, PhysicsState,
                                   flat_heightfield, physics_step_batched)
from wtw_tpu_torch.physics import engine

ROBOTS = ("go1", "go2", "b1", "mini_cheetah")
STATE_FIELDS = ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel",
                "joint_q", "joint_qd")
INFO_FIELDS = ("foot_forces", "foot_positions", "foot_velocities",
               "thigh_contact", "calf_contact", "base_contact",
               "total_normal_force")
# base heights a little below each robot's standing height, so that most
# envs touch the ground
Z = {"go1": 0.30, "go2": 0.30, "b1": 0.49, "mini_cheetah": 0.45}


@pytest.mark.parametrize("proportions", [None, (0.4, 0.3, 0.2, 0.1)],
                         ids=["arange", "proportions"])
def test_stack_and_assign_match_jax(proportions):
    """stack_models pads every robot's spheres to the mini-cheetah's 52
    (radius -1e3, label 0, leg -1) and stacks every array field;
    assign_robots gives each env its robot, arange(N) % R or drawn with
    `proportions`: leaf by leaf equal to the JAX package's."""
    jstack = jax_stack([jax_load_robot(r) for r in ROBOTS])
    tstack = stack_models([load_robot(r) for r in ROBOTS])
    jper, ja = jax_assign(jstack, 37, proportions, seed=3)
    tper, ta = assign_robots(tstack, 37, proportions, seed=3)
    np.testing.assert_array_equal(ta, ja)
    assert (tper.nb, tper.nj, tper.P) == (13, 12, 52) and tper.batched
    assert tstack.parent_static == jstack.parent_static
    assert tstack.joint_names == jstack.joint_names
    for name in ARRAY_FIELDS:
        for t, j in ((tstack, jstack), (tper, jper)):
            np.testing.assert_array_equal(t.static[name],
                                          np.asarray(getattr(j, name)),
                                          err_msg=name)
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)),
                                          err_msg=name)
    np.testing.assert_array_equal(tper.robot.numpy(), ja)
    assert tper.stack is not None
    pad = tstack.static["sph_radius"] == PAD_RADIUS
    assert pad.sum() == (52 - 39) + (52 - 51) + (52 - 31)
    assert (tstack.static["sph_leg"][pad] == -1).all()


def _mixed_states(rng, robots, a):
    """Near-standing random states at each env's robot's height."""
    B = len(a)
    q = rng.randn(B, 4) * 0.1 + np.array([0.0, 0.0, 0.0, 1.0])
    z = np.array([Z[robots[r]] for r in a])
    f = lambda x: np.asarray(x, np.float32)
    return dict(
        base_pos=f(np.stack([rng.uniform(-1, 1, B), rng.uniform(-1, 1, B),
                             z + rng.uniform(-0.05, 0.05, B)], 1)),
        base_quat=f(q / np.linalg.norm(q, axis=1, keepdims=True)),
        base_lin_vel=f(0.3 * rng.randn(B, 3)),
        base_ang_vel=f(0.3 * rng.randn(B, 3)),
        joint_q=f(np.tile([0.0, 0.8, -1.6] * 4, (B, 1))
                  + 0.1 * rng.randn(B, 12)),
        joint_qd=f(0.3 * rng.randn(B, 12)))


@functools.lru_cache(maxsize=None)
def _mixed_engine_case():
    """A go1/go2/b1/mini-cheetah batch of 8 (arange % 4) on both sides, the
    env draws, and the jitted JAX map of physics_step over the per-env
    model (compiled once for the tests that share it)."""
    B = 8
    jper, a = jax_assign(jax_stack([jax_load_robot(r) for r in ROBOTS]), B)
    tper, _ = assign_robots(stack_models([load_robot(r) for r in ROBOTS]), B)
    ea = np.array([0.1, -0.2, 0.3], np.float32)
    jhf = jax_flat_heightfield()
    jstep = jax.jit(jax.vmap(
        lambda m, s, t, f, r, p, c: jax_physics_step(
            m, jhf, JaxEngineParams(), s, t, f, r, payload_mass=p,
            com_offset=c, external_accel=jnp.asarray(ea))))
    return dict(
        B=B, a=a, jper=jper, tper=tper, jstep=jstep, ea=ea,
        thf=flat_heightfield(),
        fric=np.linspace(0.3, 2.0, B).astype(np.float32),
        rest=np.linspace(0.0, 0.4, B).astype(np.float32),
        pay=np.linspace(-0.5, 2.0, B).astype(np.float32),
        com=np.tile([[0.01, -0.005, 0.002]], (B, 1)).astype(np.float32))


def _both_steps(case, st, tau, jax_side=True, torch_side=True):
    """One substep of the case's batch from states `st` (numpy) under
    `tau` on each side: ((JAX state, info), (port state, info))."""
    c, T = case, torch.from_numpy
    j = t = None
    if jax_side:
        j = c["jstep"](c["jper"], JaxPhysicsState(**{
            n: jnp.asarray(v) for n, v in st.items()}), jnp.asarray(tau),
            *(jnp.asarray(c[k]) for k in ("fric", "rest", "pay", "com")))
    if torch_side:
        t = engine.physics_step(
            c["tper"], c["thf"], EngineParams(),
            PhysicsState(**{n: T(np.asarray(v)) for n, v in st.items()}),
            T(tau), T(c["fric"]), T(c["rest"]), payload_mass=T(c["pay"]),
            com_offset=T(c["com"]), external_accel=T(c["ea"]))
    return j, t


def _assert_step_close(ts, ti, js, ji, where):
    """State at 2e-4, contact forces and foot kinematics at 200x
    (tests/test_physics_batched.py:65-76)."""
    for n in STATE_FIELDS:
        np.testing.assert_allclose(getattr(ts, n).numpy(),
                                   np.asarray(getattr(js, n)), atol=2e-4,
                                   err_msg=f"{n} {where}")
    for n in INFO_FIELDS:
        np.testing.assert_allclose(getattr(ti, n).numpy(),
                                   np.asarray(getattr(ji, n)),
                                   atol=2e-4 * 200.0, err_msg=f"{n} {where}")


def test_engine_mixed_batch_matches_jax_vmap():
    """The port's per-robot engine (`physics.engine.physics_step`) on a
    go1/go2/b1/mini-cheetah batch of 8 with a per-env model, with contacts,
    payload, CoM offsets and an external acceleration, against
    `jax.vmap(physics_step, in_axes=(0, ...))` on the JAX per-env model:
    three substeps, each from its own random near-standing states drawn
    like tests/test_physics_batched.py's, where its bars hold: state at
    2e-4, contact forces and foot kinematics at 200x. Each robot's envs
    also give exactly what the single-robot path gives them: the per-env
    model changes nothing of the arithmetic. (Chained, the third substep
    puts a mini-cheetah's joint qd ~2.2e-4 (5e-5 relative) off JAX's,
    by the same amount in the single-robot path.)"""
    rng = np.random.RandomState(0)
    case = _mixed_engine_case()
    a, B, T = case["a"], case["B"], torch.from_numpy
    fric, rest, pay, com, ea, thf = (case[k] for k in (
        "fric", "rest", "pay", "com", "ea", "thf"))
    touched = [0.0] * len(ROBOTS)
    for k in range(3):
        st = _mixed_states(rng, ROBOTS, a)
        tau = (3.0 * rng.randn(B, 12)).astype(np.float32)
        (js, ji), (ts, ti) = _both_steps(case, st, tau)
        ts0 = PhysicsState(**{n: T(v) for n, v in st.items()})
        _assert_step_close(ts, ti, js, ji, f"@ {k}")
        for r, name in enumerate(ROBOTS):
            i = torch.from_numpy(np.flatnonzero(a == r))
            one, _ = physics_step_batched(
                load_robot(name), thf, EngineParams(),
                PhysicsState(**{n: getattr(ts0, n)[i] for n in STATE_FIELDS}),
                T(tau)[i], T(fric)[i], T(rest)[i], payload_mass=T(pay)[i],
                com_offset=T(com)[i], external_accel=T(ea))
            for n in STATE_FIELDS:
                assert torch.equal(getattr(one, n), getattr(ts, n)[i]), \
                    (name, n)
        fn = ti.total_normal_force
        for r in range(len(ROBOTS)):
            touched[r] = max(touched[r],
                             float(fn[torch.from_numpy(a == r)].max()))
    # every robot's contacts were exercised
    assert min(touched) > 10.0, touched


def test_engine_mixed_batch_chained_matches_jax_vmap():
    """The mixed engine against JAX's vmapped engine over two chained
    substeps (each side from its own previous state), at the bars of
    test_engine_mixed_batch_matches_jax_vmap: a drift that builds up over
    steps in the mixed path alone shows here."""
    rng = np.random.RandomState(0)
    case = _mixed_engine_case()
    a, B, T = case["a"], case["B"], torch.from_numpy
    st = _mixed_states(rng, ROBOTS, a)
    taus = [(3.0 * rng.randn(B, 12)).astype(np.float32) for _ in range(2)]
    jst, tst = st, st
    touched = np.zeros(len(ROBOTS))
    for k, tau in enumerate(taus):
        (js, ji), _ = _both_steps(case, jst, tau, torch_side=False)
        _, (ts, ti) = _both_steps(case, tst, tau, jax_side=False)
        _assert_step_close(ts, ti, js, ji, f"@ substep {k}")
        jst = {n: np.asarray(getattr(js, n)) for n in STATE_FIELDS}
        tst = {n: getattr(ts, n).numpy() for n in STATE_FIELDS}
        fn = ti.total_normal_force.numpy()
        touched = np.maximum(touched, [fn[a == r].max()
                                       for r in range(len(ROBOTS))])
    assert touched.min() > 10.0, touched


def test_engine_one_env_matches_jax():
    """One env through the per-robot engine with no env axis (a batch of
    one inside) against JAX's un-mapped physics_step on the same robot:
    state at 2e-4, forces at 200x."""
    rng = np.random.RandomState(4)
    st = {k: v[0] for k, v in _mixed_states(rng, ("go2",), [0]).items()}
    tau = (3.0 * rng.randn(12)).astype(np.float32)
    js, ji = jax.jit(lambda s, t: jax_physics_step(
        jax_load_robot("go2"), jax_flat_heightfield(), JaxEngineParams(), s,
        t, jnp.float32(0.8), jnp.float32(0.1), payload_mass=0.5))(
        JaxPhysicsState(**{k: jnp.asarray(v) for k, v in st.items()}),
        jnp.asarray(tau))
    ts, ti = engine.physics_step(
        load_robot("go2"), flat_heightfield(), EngineParams(),
        PhysicsState(**{k: torch.from_numpy(v) for k, v in st.items()}),
        torch.from_numpy(tau), 0.8, 0.1, payload_mass=0.5)
    for n in STATE_FIELDS:
        assert getattr(ts, n).shape == np.asarray(getattr(js, n)).shape
        np.testing.assert_allclose(getattr(ts, n).numpy(),
                                   np.asarray(getattr(js, n)), atol=2e-4,
                                   err_msg=n)
    for n in INFO_FIELDS:
        np.testing.assert_allclose(getattr(ti, n).numpy(),
                                   np.asarray(getattr(ji, n)), atol=4e-2,
                                   err_msg=n)
    assert float(ti.total_normal_force) > 10.0
    jb = jax.jit(lambda s: __import__("wtw_tpu.physics.engine", fromlist=[
        "fk"]).fk(jax_load_robot("go2"), s.base_pos, s.base_quat,
                  s.joint_q))(JaxPhysicsState(**{k: jnp.asarray(v)
                                                 for k, v in st.items()}))
    tb = engine.fk(load_robot("go2"), *(torch.from_numpy(st[k]) for k in (
        "base_pos", "base_quat", "joint_q")))
    for j, t in zip(jb, tb):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


def test_mixed_batch_matches_single_robot():
    """Env 0 (go1) of a go1+b1 batch follows a pure-go1 batch over 20
    substeps from standing at 1e-5 (JAX
    test_mixed_batch_matches_single_robot): B1's model and the padding do
    not reach go1's env."""
    B = 2
    per_env, _ = assign_robots(stack_models([load_robot("go1"),
                                             load_robot("b1")]), B)
    go1 = load_robot("go1")
    hf, p = flat_heightfield(), EngineParams()
    q0 = torch.tensor([0.1, 0.8, -1.5, -0.1, 0.8, -1.5,
                       0.1, 1.0, -1.5, -0.1, 1.0, -1.5]).expand(B, 12)
    s0 = PhysicsState(base_pos=torch.tensor([0.0, 0.0, 0.35]).expand(B, 3),
                      base_quat=torch.tensor([0.0, 0, 0, 1.0]).expand(B, 4),
                      base_lin_vel=torch.zeros(B, 3),
                      base_ang_vel=torch.zeros(B, 3), joint_q=q0.clone(),
                      joint_qd=torch.zeros(B, 12))
    mixed, pure = s0, s0
    ones, zeros = torch.ones(B), torch.zeros(B)
    for _ in range(20):
        mixed, _ = engine.physics_step(per_env, hf, p, mixed,
                                       torch.zeros(B, 12), ones, zeros)
        pure, info = physics_step_batched(go1, hf, p, pure,
                                          torch.zeros(B, 12), ones, zeros)
    for n in ("base_pos", "joint_q"):
        np.testing.assert_allclose(getattr(mixed, n)[0].numpy(),
                                   getattr(pure, n)[0].numpy(), atol=1e-5)
    assert float(info.total_normal_force[0]) > 10.0


def _no_noise(module, n):
    cfg = module.go1_flat_config(num_envs=n)
    return dataclasses.replace(cfg, noise=dataclasses.replace(
        cfg.noise, add_noise=False))


def test_multi_env_constants_match_jax():
    """make_multi_legged_env's per-env constants equal the JAX factory's:
    the assignment, default joint angles (each robot's own joint order),
    PD gains and spawn positions of each robot's flat preset, effort and
    soft position limits, and the foot sides (go1 lists FR first, go2 FL
    first)."""
    N = 8
    jenv = jax_make_multi(_no_noise(jcfg, N), ROBOTS, seed=0)
    tenv = make_multi_legged_env(_no_noise(tcfg, N), ROBOTS, device="cpu")
    np.testing.assert_array_equal(tenv.robot_assignment,
                                  jenv.robot_assignment)
    assert tenv.robot_names == jenv.robot_names
    for name in ("default_joint_q", "p_gains", "d_gains", "base_init_pos",
                 "soft_pos_limits", "foot_side"):
        t, j = getattr(tenv, name), np.asarray(getattr(jenv, name))
        assert tuple(t.shape) == j.shape, name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    np.testing.assert_array_equal(tenv.model.effort_limit.numpy(),
                                  np.asarray(jenv.model.effort_limit))
    # go1 (env 0) and go2 (env 1) differ in leg order; B1 gets its gains
    assert tenv.foot_side[0, 0] == -tenv.foot_side[1, 0]
    assert float(tenv.p_gains[2, 0]) == 100.0
    assert float(tenv.base_init_pos[2, 2]) == np.float32(0.8)


def test_multi_env_steps_match_jax():
    """One go1/go2/b1/mini-cheetah env of 4, two policy steps from one
    carried-over state with the draws off (no observation noise; command
    resampling and DR re-draws not due; no resets, asserted), against the
    JAX env's vmap path: obs, privileged obs and rewards at 1e-4, dones
    equal (the bars of tests/test_torch_env.py)."""
    N = 4
    jenv = jax_make_multi(_no_noise(jcfg, N), ROBOTS, seed=0)
    tenv = make_multi_legged_env(_no_noise(tcfg, N), ROBOTS, device="cpu")
    with jax.disable_jit():
        jworld = jenv.init_state(jax.random.PRNGKey(0))
        jworld, _ = jenv.get_observations(jworld)
    tworld = world_from_jax(jax.tree.map(np.asarray, jworld))
    jstep = jax.jit(jenv.step)
    rng = np.random.RandomState(0)
    for step in range(2):
        a = (0.3 * rng.randn(N, 12)).astype(np.float32)
        jworld, jod, jrew, jdone, _ = jstep(jworld, jnp.asarray(a))
        tworld, tod, trew, tdone, _ = tenv.step(tworld, torch.from_numpy(a))
        assert not np.asarray(jdone).any() and not tdone.any(), step
        for k in ("obs", "privileged_obs", "obs_history"):
            np.testing.assert_allclose(tod[k].numpy(), np.asarray(jod[k]),
                                       atol=1e-4, err_msg=f"{k} @ {step}")
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-4,
                                   err_msg=f"rew @ {step}")
        np.testing.assert_allclose(tworld.env.phys.base_pos.numpy(),
                                   np.asarray(jworld.env.phys.base_pos),
                                   atol=1e-4)


def test_train_multi_iteration_writes_the_scripts_outputs(tmp_path,
                                                          monkeypatch):
    """`python -m wtw_tpu_torch.train_multi --cpu` for one tiny iteration
    writes the JAX script's metrics.csv columns (scripts/train_multi.py:
    iteration, wall_s, mean_step_reward, ep_rew_total, value_loss,
    adaptation_loss, rew_<robot>) with finite values, and state_last.pt;
    each physics kernel's wrapper is called (num_steps_per_env + 1) x
    decimation times: the rollout and the per-robot reward step."""
    from wtw_tpu_torch import train_multi
    from wtw_tpu_torch.physics import kernels as K
    calls = {"fk": 0, "dynamics": 0}
    for name in calls:
        real = getattr(K, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(K, name, counted)
    run = tmp_path / "run"
    train_multi.main(["--cpu", "--robots", "go1,go2,b1", "--num-envs", "6",
                      "--iterations", "1", "--run-dir", str(run),
                      "--set", "ppo.num_steps_per_env=2"])
    with open(run / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["iteration", "wall_s", "mean_step_reward",
                             "ep_rew_total", "value_loss", "adaptation_loss",
                             "rew_go1", "rew_go2", "rew_b1"]
    assert len(rows) == 1 and all(np.isfinite(float(v))
                                  for v in rows[0].values())
    blob = torch.load(run / "state_last.pt", weights_only=False)
    assert blob["robots"] == ["go1", "go2", "b1"] and "ac" in blob
    assert calls == {"fk": 3 * 4, "dynamics": 3 * 4}
    assert os.path.getsize(run / "state_last.pt") > 0
