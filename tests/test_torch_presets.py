"""Parity of the Stack-A presets beyond go1 (go2_flat, go2_mob, b1_flat,
b1_mob, mini_cheetah_flat; wtw_tpu_torch on the CPU) against the JAX
package: the presets' configuration trees, env steps on each robot, and
the training CLI on each preset.

Inputs come from numpy with a seed and go to both sides. The JAX env runs
un-jitted (`jax.disable_jit()`) on its batched XLA path
(`physics_backend="xla"`, the plain reference of its Pallas kernels); the
MoB presets run on 3 x 3 cells of their map (a 150 x 150 field at 0.1 m).
Random draws that torch cannot reproduce are switched off: observation
noise, and every periodic draw is not due in the 2-step window (see
tests/test_torch_env.py and tests/test_torch_mob.py).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtw_tpu import config as jcfg
from wtw_tpu.envs import LeggedEnv as JaxLeggedEnv
from wtw_tpu.models import load_robot as jax_load_robot
from wtw_tpu.terrain import assign_env_origins as jax_assign_origins
from wtw_tpu.terrain import build_terrain as jax_build_terrain
from wtw_tpu.terrain import to_heightfield as jax_to_hf

from wtw_tpu_torch import config as tcfg
from wtw_tpu_torch.convert import world_from_jax
from wtw_tpu_torch.envs import make_legged_env
from wtw_tpu_torch.physics import kernels as K
from wtw_tpu_torch.physics.heightfield import height_at

N = 4
SMALL = dict(num_rows=3, num_cols=3)
NEW_PRESETS = ("go2_flat", "go2_mob", "b1_flat", "b1_mob",
               "mini_cheetah_flat")


@pytest.mark.parametrize("preset", sorted(jcfg.PRESETS))
def test_preset_config_tree_equals_jax(preset):
    """Every preset's whole configuration tree (`dataclasses.asdict`) is the
    JAX package's, field for field, at its default env count and at 4."""
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    for kw in ({}, {"num_envs": N}):
        assert dataclasses.asdict(tcfg.PRESETS[preset](**kw)) \
            == dataclasses.asdict(jcfg.PRESETS[preset](**kw))


def _cfg(module, preset):
    cfg = module.PRESETS[preset](num_envs=N)
    cfg = dataclasses.replace(cfg, noise=dataclasses.replace(
        cfg.noise, add_noise=False))
    if cfg.terrain.mesh_type == "heightfield":
        cfg = dataclasses.replace(
            cfg, terrain=dataclasses.replace(cfg.terrain, **SMALL))
    if preset == "b1_mob":
        # the MoB recipe ends an episode when the base is below
        # terminal_body_height, absolute (wtw_tpu/envs/legged_env.py:
        # 710-718); B1's 0.55 m is above its standing height at its
        # default pose (0.52 m), so a standing B1 resets at once, and a
        # reset draws: 0.45 m on both sides
        cfg = dataclasses.replace(cfg, rewards=dataclasses.replace(
            cfg.rewards, terminal_body_height=0.45))
    return cfg


def _standing_z(model, world) -> np.ndarray:
    """Per env, the base height over the ground at which the lowest sphere
    of its current pose just touches (FK of the port's plain kernel A)."""
    ph = world.env.phys
    _, fk_p = K.fk_plain(model, torch.cat(
        [ph.base_pos, ph.base_quat, ph.joint_q], 1).T.contiguous())
    bottom = (fk_p[2] - model.sph_radius[:, None]).min(dim=0).values
    return (ph.base_pos[:, 2] - bottom).numpy()


@pytest.mark.parametrize("preset", NEW_PRESETS)
def test_preset_env_steps_match_jax(preset):
    """Two policy steps of each preset, 4 envs, from one carried-over world
    in the preset's standing pose with every base lowered (or raised) to
    1 cm below the height at which its lowest sphere touches the ground
    under it, so the feet load in the first substep: B1's 55.7 kg at
    kp 100 / kd 2.5, the mini-cheetah's 52 spheres and long calves, Go2 on
    flat ground and, with the go2 actuator net, on the MoB map. The map
    and origins equal JAX's. No env resets (asserted). Bars: observations,
    privileged observations, the history, rewards and episode sums at
    1e-4 absolute (tests/test_torch_env.py), the joint state at the state
    bar, 2e-4, torques at 100x that."""
    jc, tc = _cfg(jcfg, preset), _cfg(tcfg, preset)
    tenv = make_legged_env(tc, device="cpu", seed=0)
    jrobot = jax_load_robot(jc.asset.robot)
    if jc.terrain.mesh_type == "heightfield":
        jm = jax_build_terrain(jc.terrain, seed=0)
        origins, _, _ = jax_assign_origins(jm, N, jc.terrain, seed=0)
        jenv = JaxLeggedEnv(jc, jrobot, heightfield=jax_to_hf(jm),
                            env_origins=origins, physics_backend="xla")
        np.testing.assert_array_equal(tenv.hf.heights.numpy(), jm.heights)
        np.testing.assert_array_equal(tenv.env_origins.numpy(), origins)
    else:
        jenv = JaxLeggedEnv(jc, jrobot, physics_backend="xla")
    assert (tenv.actuator_params is not None) == (
        tc.control.control_type == "actuator_net")
    np.testing.assert_array_equal(tenv.default_joint_q.numpy(),
                                  np.asarray(jenv.default_joint_q))
    with jax.disable_jit():
        jworld = jenv.init_state(jax.random.PRNGKey(0))
    # the preset's standing pose, 1 cm into the ground under each base
    q = np.tile(np.asarray(jenv.default_joint_q), (N, 1))
    jworld = jworld.replace(env=jworld.env.replace(
        phys=jworld.env.phys.replace(joint_q=jnp.asarray(q))))
    tworld = world_from_jax(jax.tree.map(np.asarray, jworld))
    pos = np.array(jworld.env.phys.base_pos)
    ground = height_at(tenv.hf, torch.from_numpy(pos[:, :2])).numpy()
    pos[:, 2] = ground + _standing_z(tenv.model, tworld) - 0.01
    jworld = jworld.replace(env=jworld.env.replace(
        phys=jworld.env.phys.replace(base_pos=jnp.asarray(pos))))
    with jax.disable_jit():
        jworld, _ = jenv.get_observations(jworld)
    tworld = world_from_jax(jax.tree.map(np.asarray, jworld))
    rng = np.random.RandomState(0)
    for step in range(2):
        a = (0.3 * rng.randn(N, 12)).astype(np.float32)
        with jax.disable_jit():
            jworld, jod, jrew, jdone, _ = jenv.step(jworld, jnp.asarray(a))
        tworld, tod, trew, tdone, _ = tenv.step(tworld, torch.from_numpy(a))
        assert not np.asarray(jdone).any() and not tdone.any(), step
        for k in ("obs", "privileged_obs", "obs_history"):
            np.testing.assert_allclose(tod[k].numpy(), np.asarray(jod[k]),
                                       atol=1e-4, err_msg=f"{k} @ {step}")
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-4,
                                   err_msg=f"rew @ {step}")
        np.testing.assert_allclose(tworld.env.episode_sums.numpy(),
                                   np.asarray(jworld.env.episode_sums),
                                   atol=1e-4, err_msg=f"sums @ {step}")
        te, je = tworld.env, jworld.env
        for f, tol in (("joint_q", 2e-4), ("joint_qd", 2e-4),
                       ("base_pos", 2e-4), ("base_lin_vel", 2e-4)):
            np.testing.assert_allclose(
                getattr(te.phys, f).numpy(), np.asarray(getattr(je.phys, f)),
                atol=tol, err_msg=f"{f} @ {step}")
        np.testing.assert_allclose(te.torques.numpy(),
                                   np.asarray(je.torques), atol=2e-2,
                                   err_msg=f"torques @ {step}")
        np.testing.assert_array_equal(te.commands.numpy(),
                                      np.asarray(je.commands))
    # every env stands on its feet at the end of the window
    assert bool(tworld.env.last_contacts.any(dim=1).all())


@pytest.mark.parametrize("preset", NEW_PRESETS)
def test_train_cli_trains_preset(preset, tmp_path):
    """`python -m wtw_tpu_torch.train --preset <preset>` on the CPU at
    narrow widths (the MoB presets on 3 x 3 cells; go2_mob with
    `--actuator-model-wrapper`): one iteration writes the policy export and
    the exact-resume state, with finite losses."""
    from wtw_tpu_torch.train import main
    extra = ["--set", "terrain.num_rows=3", "--set", "terrain.num_cols=3"] \
        if preset.endswith("_mob") else []
    if preset == "go2_mob":
        extra.append("--actuator-model-wrapper")
    main(["--preset", preset, "--device", "cpu", "--num-envs", "4",
          "--iterations", "1", "--log-freq", "1", "--run-dir", str(tmp_path),
          "--set", "ppo.num_steps_per_env=2", "--set",
          "ac.actor_hidden_dims=16", "--set", "ac.critic_hidden_dims=16",
          "--set", "ac.adaptation_hidden_dims=8", *extra])
    ck = os.path.join(str(tmp_path), "checkpoints")
    for f in ("policy_last.npz", "state_last.pt"):
        assert os.path.exists(os.path.join(ck, f)), f
    import csv
    with open(os.path.join(str(tmp_path), "metrics.csv")) as fh:
        rows = list(csv.DictReader(fh))
    assert rows and all(np.isfinite(float(rows[-1][k])) for k in (
        "value_loss", "surrogate_loss"))
