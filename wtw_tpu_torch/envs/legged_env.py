"""The legged environment, batched backend (port of
`wtw_tpu/envs/legged_env.py`).

Same semantics as the JAX env's batched path: fixed-shape masked updates for
command resampling, domain randomization, resets and episode metrics, a
Python loop of `decimation` physics substeps per policy step, the CoRL
reward stack, and the observation history ring (reference
legged_robot.py:60-239, history_wrapper.py:18-30).

Randomness comes from one `torch.Generator` per world (`WorldState.gen`),
seeded by `init_state(seed)`; the JAX env's per-env key streams cannot be
reproduced in torch, so the two envs agree only where no draw is made.

Env sharding (`group`, a `torch.distributed` process group): the env steps
this rank's equal share of `cfg.env.num_envs` (`num_envs` is the shard's
count, `num_envs_global` the total). Every per-env draw is made at the
global width from the world's generator, seeded alike on every rank, and
the rank keeps its own rows, so a sharded run draws what the unsharded
one draws. The reward-sign test's term totals and the curriculum's
success counts are summed over the group, and the train/eval split is
proportional per shard, as in the JAX env under an `axis_name`.

Ported: flat ground and Stack-A heightfield terrain (the corner rows
gathered once per policy step and reused by the other substeps), PD
control and the actuator net, the gait clock, pushes, rigid-body DR
re-draws on reset, edge teleport and the measured-height terminal check,
and mixed-robot batches: a per-env model (`models/multi.py`) with per-env
default joint angles, PD gains and spawn positions (`envs/multi_env.py`),
whose effort limits, soft position limits and foot sides follow each env's
robot. The JAX env maps its per-robot engine over such a model (its `vmap`
backend); here the batched engine takes it, and on the card both kernels
read each env's robot from its index.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import Cfg
from ..models.actuator_net import apply_actuator_net, load_actuator_net
from ..models.robot import RobotModel, default_joint_angles
from ..parallel.mesh import all_sum, draw_rows, group_size, shard_rows
from ..physics import (EngineParams, HeightField, PhysicsState,
                       flat_heightfield, physics_step_batched)
from ..physics.heightfield import height_min3
from ..utils import quat as quat_util
from ..utils import spans
from . import curriculum as curr
from . import gait, observations
from .rewards import REWARD_FNS, RewardCtx, active_reward_terms

# command_sums metric tail (legged_robot.py:1425-1429)
EXTRA_CMD_METRICS = ("lin_vel_raw", "ang_vel_raw", "lin_vel_residual",
                     "ang_vel_residual", "ep_timesteps")


@dataclasses.dataclass
class EnvState:
    """Per-env state, leading (N,) axis everywhere (field names follow the
    JAX EnvState; its per-env `rng` keys become WorldState.gen)."""
    phys: PhysicsState
    episode_length: torch.Tensor       # int32
    commands: torch.Tensor             # (N, nc)
    env_bin: torch.Tensor              # int64 curriculum cell
    env_category: torch.Tensor         # int64 gait category
    gait_index: torch.Tensor
    clock_inputs: torch.Tensor         # (N, 4)
    doubletime_clock: torch.Tensor
    halftime_clock: torch.Tensor
    foot_indices: torch.Tensor
    desired_contact_states: torch.Tensor
    actions: torch.Tensor
    last_actions: torch.Tensor
    last_last_actions: torch.Tensor
    joint_pos_target: torch.Tensor
    last_joint_pos_target: torch.Tensor
    last_last_joint_pos_target: torch.Tensor
    last_joint_qd: torch.Tensor
    torques: torch.Tensor
    lag_buffer: torch.Tensor           # (N, lag+1, nj)
    # actuator-net history (legged_robot.py:1255-1258)
    joint_pos_err_last: torch.Tensor
    joint_pos_err_last_last: torch.Tensor
    joint_vel_last: torch.Tensor
    joint_vel_last_last: torch.Tensor
    friction: torch.Tensor
    restitution: torch.Tensor
    payload: torch.Tensor
    com_displacement: torch.Tensor     # (N, 3)
    motor_strength: torch.Tensor       # (N, nj)
    motor_offset: torch.Tensor
    Kp_factor: torch.Tensor
    Kd_factor: torch.Tensor
    last_contacts: torch.Tensor        # (N, 4) bool
    feet_air_time: torch.Tensor        # (N, 4)
    prev_foot_velocities: torch.Tensor  # (N, 4, 3)
    episode_sums: torch.Tensor         # (N, n_terms + 1) incl. total
    command_sums: torch.Tensor         # (N, n_terms + 5)
    env_origin: torch.Tensor           # (N, 3)
    timed_out: torch.Tensor            # bool


@dataclasses.dataclass
class WorldState:
    env: EnvState
    curriculum_weights: torch.Tensor   # (n_categories, n_bins)
    obs_history: torch.Tensor          # (N, H * num_obs)
    gravity_offset: torch.Tensor       # (3,)
    common_step: int
    gen: torch.Generator


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Masked select with the (N,) mask broadcast over trailing dims."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


class LeggedEnv:
    """Static env definition; `step` maps a WorldState to the next one."""

    def __init__(self, cfg: Cfg, model: RobotModel,
                 heightfield: Optional[HeightField] = None,
                 env_origins: Optional[np.ndarray] = None, device=None,
                 default_joint_q_override=None,
                 per_env_control: Optional[dict] = None, group=None):
        """default_joint_q_override: (N, nj) default joint angles of a
        mixed-robot batch (robots list their legs in different orders).
        per_env_control: its per-env control constants, optional keys
        'p_gains' and 'd_gains' (N, nj) and 'init_pos' (N, 3)
        (`envs.multi_env.make_multi_legged_env` builds all three).
        group: a process group to shard the envs over (`env_origins`, if
        given, holds every env's row)."""
        if cfg.control.control_type not in ("P", "actuator_net"):
            raise NotImplementedError(
                f"control_type={cfg.control.control_type!r}: the port has "
                f"PD control and the actuator net")
        # a mixed-robot batch: a per-env model (leading env axis on every
        # array field)
        if model.batched and group is not None:
            raise ValueError("env sharding takes one robot model")
        if model.batched:
            if cfg.control.control_type != "P":
                raise ValueError("a mixed-robot batch uses PD control (per-"
                                 "robot actuator nets would need per-env "
                                 "weights)")
            if default_joint_q_override is None:
                raise ValueError("a mixed-robot batch needs per-env default "
                                 "joint angles (the robots' leg orders "
                                 "differ): use envs.multi_env."
                                 "make_multi_legged_env")
        self.device = resolve_device(device)
        dev = self.device
        self.cfg = cfg
        self.model = model.to(dev)
        model = self.model
        self._nj = model.nj
        self.hf = (heightfield if heightfield is not None
                   else flat_heightfield(device=dev)).to(dev)
        self.group = group
        W = group_size(group)
        if cfg.env.num_envs % W:
            raise ValueError(f"{cfg.env.num_envs} envs do not shard over "
                             f"{W} ranks")
        self.num_envs_global = cfg.env.num_envs
        self.num_envs = cfg.env.num_envs // W
        # eval split: the LAST num_eval_envs envs (base_task.py:43-46), of
        # each shard in proportion
        n_eval = min(cfg.env.num_eval_envs, cfg.env.num_envs - 1)
        self.num_train_envs = (self.num_envs * (cfg.env.num_envs - n_eval)
                               // cfg.env.num_envs)
        self.num_eval_envs = self.num_envs - self.num_train_envs
        self.num_obs = cfg.env.num_observations
        self.num_privileged_obs = cfg.env.num_privileged_obs
        self.num_actions = cfg.env.num_actions
        self.num_obs_history = cfg.env.num_observation_history * self.num_obs
        self.dt = cfg.dt

        s = cfg.sim
        self.engine_params = EngineParams(
            dt=s.dt, gravity=tuple(float(g) for g in s.gravity),
            contact_stiffness=s.contact_stiffness,
            contact_damping=s.contact_damping,
            friction_vel_eps=s.friction_vel_eps, armature=s.armature,
            max_depenetration_velocity=s.max_depenetration_velocity)

        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        self.default_joint_q = (
            f32(default_joint_q_override)
            if default_joint_q_override is not None
            else default_joint_angles(model,
                                      cfg.init_state.default_joint_angles))
        pec = per_env_control or {}
        self.p_gains = (f32(pec["p_gains"]) if "p_gains" in pec else
                        torch.full((self._nj,), cfg.control.stiffness,
                                   device=dev))
        self.d_gains = (f32(pec["d_gains"]) if "d_gains" in pec else
                        torch.full((self._nj,), cfg.control.damping,
                                   device=dev))
        # soft position limits (legged_robot.py:603-607), (nj, 2) or per
        # env (N, nj, 2)
        mid = (model.joint_lower + model.joint_upper) / 2
        rng = model.joint_upper - model.joint_lower
        lim = cfg.rewards.soft_dof_pos_limit
        self.soft_pos_limits = torch.stack(
            [mid - 0.5 * rng * lim, mid + 0.5 * rng * lim], dim=-1)
        # hip action scaling (legged_robot.py:919-920)
        hip = np.zeros(self._nj, np.float32)
        hip[[0, 3, 6, 9]] = 1.0
        self.action_scale_vec = f32(
            cfg.control.action_scale
            * (hip * cfg.control.hip_scale_reduction + (1 - hip)))
        # per-foot lateral side from the hip joint y offsets (raibert), in
        # each robot's own leg order: (4,), or (N, 4) in a mixed batch
        self.foot_side = torch.sign(model.joint_pos[..., (0, 3, 6, 9), 1])
        self.gravity = f32(cfg.sim.gravity)

        self.noise_vec = f32(observations.noise_scale_vec(cfg))
        self.reward_terms = active_reward_terms(cfg)    # [(name, scale*dt)]
        self.reward_names = [n for n, _ in self.reward_terms]
        self.n_terms = len(self.reward_terms)
        self.shaped_bias = f32(
            [sc if n in ("tracking_contacts_shaped_force",
                         "tracking_contacts_shaped_vel") else 0.0
             for n, sc in self.reward_terms])
        self.term_scales = f32([sc for _, sc in self.reward_terms])

        self.grid = curr.build_grid(cfg.commands, device=dev)
        self.n_categories = (len(curr.CATEGORIES)
                             if cfg.commands.gaitwise_curricula else 1)
        # success metrics for the curriculum update (legged_robot.py:727-732)
        idx, thr = [], []
        th = cfg.curriculum_thresholds
        for key, t in [("tracking_lin_vel", th.tracking_lin_vel),
                       ("tracking_ang_vel", th.tracking_ang_vel),
                       ("tracking_contacts_shaped_force",
                        th.tracking_contacts_shaped_force),
                       ("tracking_contacts_shaped_vel",
                        th.tracking_contacts_shaped_vel)]:
            if key in self.reward_names:
                i = self.reward_names.index(key)
                idx.append(i)
                thr.append(t * float(self.reward_terms[i][1]))
        self.curr_metric_idx = tuple(idx)
        self.curr_thresholds = f32(thr)

        # timing in policy steps (_parse_cfg legged_robot.py:1716-1732)
        self.max_episode_length = cfg.max_episode_length
        i32 = 2 ** 31 - 1
        dr = cfg.domain_rand
        self.resample_interval = min(
            int(cfg.commands.resampling_time / self.dt), i32)
        self.rand_interval = min(int(np.ceil(dr.rand_interval_s / self.dt)), i32)
        self.grav_interval = min(
            int(np.ceil(dr.gravity_rand_interval_s / self.dt)), i32)
        self.grav_duration = int(np.ceil(
            self.grav_interval * dr.gravity_impulse_duration))
        self.ep_len_for_curriculum = min(self.max_episode_length,
                                         self.resample_interval)

        # env origins on a grid for the plane (legged_robot.py:1705-1714)
        if env_origins is None:
            n = self.num_envs_global
            cols = int(np.floor(np.sqrt(n)))
            xx, yy = np.meshgrid(np.arange(int(np.ceil(n / cols))),
                                 np.arange(cols), indexing="ij")
            org = np.zeros((n, 3), np.float32)
            org[:, 0] = 3.0 * xx.flatten()[:n]
            org[:, 1] = 3.0 * yy.flatten()[:n]
            env_origins = org
        self.env_origins = shard_rows(f32(env_origins), group)
        # spawn position over the origin: (3,), or (N, 3) in a mixed batch
        self.base_init_pos = f32(pec.get("init_pos", cfg.init_state.pos))
        self.push_interval = min(
            int(np.ceil(dr.push_interval_s / self.dt)), i32)

        # actuator net (legged_robot.py:1238-1253): the JAX package's
        # converted weights, of which the port ships its own copies
        self.actuator_params = None
        if cfg.control.control_type == "actuator_net":
            for name in (model.name, cfg.asset.robot):
                try:
                    self.actuator_params = load_actuator_net(
                        f"actuator_{name}", device=dev)
                    break
                except FileNotFoundError:
                    pass
            else:
                raise NotImplementedError(
                    f"no actuator net for robot {cfg.asset.robot!r} in the "
                    f"port yet")

    # ------------------------------------------------------------------
    def _rand(self, gen, shape):
        """Uniform [0, 1) per-env draws (rows = envs): at the group's
        global width, this rank's rows kept."""
        return draw_rows(lambda s: torch.rand(s, generator=gen,
                                              device=self.device),
                         shape, self.group)

    def _uniform(self, gen, shape, lo, hi):
        return self._rand(gen, shape) * (hi - lo) + lo

    def init_state(self, seed: int = 0) -> WorldState:
        cfg = self.cfg
        N, nj, dev = self.num_envs, self._nj, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        zj = lambda: torch.zeros(N, nj, device=dev)
        z4 = lambda: torch.zeros(N, 4, device=dev)
        env = EnvState(
            phys=self._reset_phys(gen, self.env_origins),
            episode_length=torch.zeros(N, dtype=torch.int32, device=dev),
            commands=torch.zeros(N, cfg.commands.num_commands, device=dev),
            env_bin=torch.zeros(N, dtype=torch.long, device=dev),
            env_category=torch.zeros(N, dtype=torch.long, device=dev),
            gait_index=torch.zeros(N, device=dev), clock_inputs=z4(),
            doubletime_clock=z4(), halftime_clock=z4(), foot_indices=z4(),
            desired_contact_states=z4(),
            actions=zj(), last_actions=zj(), last_last_actions=zj(),
            joint_pos_target=zj(), last_joint_pos_target=zj(),
            last_last_joint_pos_target=zj(), last_joint_qd=zj(),
            torques=zj(),
            lag_buffer=torch.zeros(N, cfg.domain_rand.lag_timesteps + 1, nj,
                                   device=dev),
            joint_pos_err_last=zj(), joint_pos_err_last_last=zj(),
            joint_vel_last=zj(), joint_vel_last_last=zj(),
            **self._sample_rigid_dr(gen), **self._sample_dof_dr(gen),
            last_contacts=torch.zeros(N, 4, dtype=torch.bool, device=dev),
            feet_air_time=z4(),
            prev_foot_velocities=torch.zeros(N, 4, 3, device=dev),
            episode_sums=torch.zeros(N, self.n_terms + 1, device=dev),
            command_sums=torch.zeros(
                N, self.n_terms + len(EXTRA_CMD_METRICS), device=dev),
            env_origin=self.env_origins.clone(),
            timed_out=torch.zeros(N, dtype=torch.bool, device=dev))
        world = WorldState(
            env=env, curriculum_weights=curr.init_weights(cfg.commands,
                                                          self.grid),
            obs_history=torch.zeros(N, self.num_obs_history, device=dev),
            gravity_offset=torch.zeros(3, device=dev), common_step=0, gen=gen)
        # initial command resample for every env (reference reset at startup)
        return self._resample_commands(
            world, torch.ones(N, dtype=torch.bool, device=dev))

    # ------------------------------------------------------------------
    # domain randomization draws
    # ------------------------------------------------------------------
    def _sample_rigid_dr(self, gen):
        """_randomize_rigid_body_props (legged_robot.py:611-633)."""
        dr, N, dev = self.cfg.domain_rand, self.num_envs, self.device
        u = lambda on, rng, shape, off: (
            self._uniform(gen, shape, *rng) if on
            else torch.full(shape, off, device=dev))
        return dict(
            friction=u(dr.randomize_friction, dr.friction_range, (N,), 1.0),
            restitution=u(dr.randomize_restitution, dr.restitution_range,
                          (N,), 0.0),
            payload=u(dr.randomize_base_mass, dr.added_mass_range, (N,), 0.0),
            com_displacement=u(dr.randomize_com_displacement,
                               dr.com_displacement_range, (N, 3), 0.0))

    def _sample_dof_dr(self, gen):
        """_randomize_dof_props (legged_robot.py:645-665): motor strength and
        Kp/Kd factors are per-env scalars over joints, offsets per joint."""
        dr, N, nj, dev = self.cfg.domain_rand, self.num_envs, self._nj, \
            self.device
        per_env = lambda on, rng: (
            self._uniform(gen, (N, 1), *rng).expand(N, nj).contiguous() if on
            else torch.ones(N, nj, device=dev))
        return dict(
            motor_strength=per_env(dr.randomize_motor_strength,
                                   dr.motor_strength_range),
            motor_offset=(self._uniform(gen, (N, nj), *dr.motor_offset_range)
                          if dr.randomize_motor_offset
                          else torch.zeros(N, nj, device=dev)),
            Kp_factor=per_env(dr.randomize_Kp_factor, dr.Kp_factor_range),
            Kd_factor=per_env(dr.randomize_Kd_factor, dr.Kd_factor_range))

    def _reset_phys(self, gen, origin) -> PhysicsState:
        """_reset_dofs + _reset_root_states (legged_robot.py:948-1001)."""
        t, N, nj, dev = self.cfg.terrain, self.num_envs, self._nj, self.device
        joint_q = self.default_joint_q * self._uniform(gen, (N, nj), 0.5, 1.5)
        xy = torch.stack([
            self._uniform(gen, (N,), -t.x_init_range, t.x_init_range)
            + t.x_init_offset,
            self._uniform(gen, (N,), -t.y_init_range, t.y_init_range)
            + t.y_init_offset], dim=-1)
        pos = origin + self.base_init_pos + torch.cat(
            [xy, torch.zeros(N, 1, device=dev)], dim=-1)
        yaw = self._uniform(gen, (N,), -t.yaw_init_range, t.yaw_init_range)
        quat = quat_util.quat_from_angle_axis(
            yaw, spans.tensor([0.0, 0.0, 1.0], dev))
        vel6 = self._uniform(gen, (N, 6), -0.5, 0.5)
        return PhysicsState(base_pos=pos, base_quat=quat,
                            base_lin_vel=vel6[:, :3], base_ang_vel=vel6[:, 3:],
                            joint_q=joint_q,
                            joint_qd=torch.zeros(N, nj, device=dev))

    # ------------------------------------------------------------------
    # command resampling + curriculum update (legged_robot.py:710-824)
    # ------------------------------------------------------------------
    def _resample_commands(self, world: WorldState,
                           mask: torch.Tensor) -> WorldState:
        env, cfg, gen = world.env, self.cfg, world.gen
        N, dev = self.num_envs, self.device
        weights = world.curriculum_weights
        if cfg.commands.command_curriculum and self.curr_metric_idx:
            metrics = env.command_sums[:, spans.tensor(
                list(self.curr_metric_idx), dev)]
            rates = metrics / self.ep_len_for_curriculum
            success = torch.all(rates > self.curr_thresholds[None, :], dim=-1)
            weights = curr.update_weights(self.grid, weights,
                                          env.env_category, env.env_bin,
                                          success, mask, self.group)
        cat = draw_rows(lambda s: torch.randint(
            0, self.n_categories, s, generator=gen, device=dev), (N,),
            self.group)
        n_dims = self.grid.centers.shape[0]
        cmd, bin_idx = curr.sample_commands_batched(
            self.grid, weights, cat, self._rand(gen, (N,)),
            self._rand(gen, (N, n_dims)))
        cmd = cmd[:, :cfg.commands.num_commands]
        if cfg.commands.num_commands > 5 and cfg.commands.gaitwise_curricula:
            cmd = curr.apply_gait_category_batched(
                cmd, cat, cfg.commands.binary_phases)
        # zero small xy commands (:820)
        small = torch.linalg.norm(cmd[:, :2], dim=1) <= cfg.commands.vel_deadband
        keep = torch.ones_like(cmd)
        keep[:, :2] = (~small).float()[:, None]
        cmd = cmd * keep
        env = dataclasses.replace(
            env,
            commands=_where(mask, cmd, env.commands),
            env_bin=torch.where(mask, bin_idx, env.env_bin),
            env_category=torch.where(mask, cat, env.env_category),
            command_sums=_where(mask, torch.zeros_like(env.command_sums),
                                env.command_sums))
        return dataclasses.replace(world, env=env, curriculum_weights=weights)

    # ------------------------------------------------------------------
    # torque model (legged_robot.py:907-946)
    # ------------------------------------------------------------------
    @spans.spanned("env.torques")
    def _compute_torques(self, s: EnvState, actions_scaled: torch.Tensor):
        """One substep's torques: (torques, lag buffer, joint_pos_target,
        actuator-net history updates)."""
        if self.cfg.domain_rand.randomize_lag_timesteps:
            lag = torch.cat([s.lag_buffer[:, 1:], actions_scaled[:, None]],
                            dim=1)
            target = lag[:, 0] + self.default_joint_q
        else:
            lag = s.lag_buffer
            target = actions_scaled + self.default_joint_q
        q, qd = s.phys.joint_q, s.phys.joint_qd
        if self.actuator_params is not None:
            pos_err = q - target + s.motor_offset
            tau = apply_actuator_net(
                self.actuator_params, pos_err, s.joint_pos_err_last,
                s.joint_pos_err_last_last, qd, s.joint_vel_last,
                s.joint_vel_last_last)
            hist = dict(joint_pos_err_last=pos_err,
                        joint_pos_err_last_last=s.joint_pos_err_last,
                        joint_vel_last=qd,
                        joint_vel_last_last=s.joint_vel_last)
        else:
            tau = (self.p_gains * s.Kp_factor * (target - q + s.motor_offset)
                   - self.d_gains * s.Kd_factor * qd)
            hist = {}
        lim = self.model.effort_limit
        tau = torch.clamp(tau * s.motor_strength, -lim, lim)
        return tau, lag, target, hist

    def _substep(self, s: EnvState, actions_scaled, grav_off, **cache_kw):
        tau, lag, target, hist = self._compute_torques(s, actions_scaled)
        res = physics_step_batched(
            self.model, self.hf, self.engine_params, s.phys, tau,
            s.friction, s.restitution, payload_mass=s.payload,
            com_offset=s.com_displacement, external_accel=grav_off,
            **cache_kw)
        s = dataclasses.replace(s, phys=res[0], lag_buffer=lag,
                                joint_pos_target=target, torques=tau, **hist)
        return s, res[1:]

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    @spans.spanned("env.step")
    def step(self, world: WorldState, actions: torch.Tensor):
        """actions (N, nj) -> (world', obs_dict, rew (N,), done (N,), info)."""
        cfg, dev = self.cfg, self.device
        clip_act = cfg.normalization.clip_actions
        actions = torch.clamp(actions, -clip_act, clip_act)
        grav_off = world.gravity_offset
        prev_foot_vel = world.env.prev_foot_velocities
        actions_scaled = actions * self.action_scale_vec

        # decimation loop: both physics kernels once per substep; on a
        # heightfield the corner rows gathered at the first substep serve
        # the other three (ControlCfg.hf_substep_cache)
        s = dataclasses.replace(world.env, actions=actions)
        if cfg.control.hf_substep_cache and not self.hf.is_flat:
            s, (cinfo, hfc) = self._substep(s, actions_scaled, grav_off,
                                            return_hf_cache=True)
            for _ in range(cfg.control.decimation - 1):
                s, (cinfo,) = self._substep(s, actions_scaled, grav_off,
                                            hf_cache=hfc)
        else:
            for _ in range(cfg.control.decimation):
                s, (cinfo,) = self._substep(s, actions_scaled, grav_off)
        env = dataclasses.replace(s, episode_length=s.episode_length + 1)
        common_step = world.common_step + 1
        world = dataclasses.replace(world, env=env, common_step=common_step)

        # ---- body-frame quantities (legged_robot.py:106-115) ----
        spans.phase("env.reward")
        phys = env.phys
        base_lin_vel = quat_util.quat_rotate_inverse(phys.base_quat,
                                                     phys.base_lin_vel)
        base_ang_vel = quat_util.quat_rotate_inverse(phys.base_quat,
                                                     phys.base_ang_vel)
        g_world = self.gravity + grav_off
        projected_gravity = quat_util.quat_rotate_inverse(
            phys.base_quat, (g_world / torch.linalg.norm(g_world)).expand(
                phys.base_quat.shape[0], 3))

        # ---- callback: resample + DR (legged_robot.py:675-708) ----
        world = self._resample_commands(
            world, (env.episode_length % self.resample_interval) == 0)
        env = world.env
        gen = world.gen

        if cfg.env.observe_gait_commands:
            g_idx, f_idx, clock, dclock, hclock, desired = gait.step_gait(
                env.gait_index, env.commands, self.dt,
                cfg.rewards.kappa_gait_probs, cfg.commands.pacing_offset)
            env = dataclasses.replace(
                env, gait_index=g_idx, foot_indices=f_idx,
                clock_inputs=clock, doubletime_clock=dclock,
                halftime_clock=hclock, desired_contact_states=desired)

        # pushes (legged_robot.py:1017-1026)
        dr = cfg.domain_rand
        if dr.push_robots:
            push = (env.episode_length % self.push_interval) == 0
            vel = self._uniform(gen, (self.num_envs, 2), -dr.max_push_vel_xy,
                                dr.max_push_vel_xy)
            lin = env.phys.base_lin_vel
            lin = _where(push, torch.cat([vel, lin[:, 2:]], dim=-1), lin)
            env = dataclasses.replace(env, phys=dataclasses.replace(
                env.phys, base_lin_vel=lin))

        # edge wrap-around teleport (_teleport_robots,
        # legged_robot.py:1028-1051)
        t = cfg.terrain
        if t.teleport_robots and t.mesh_type == "heightfield":
            pos = env.phys.base_pos
            x, y = pos[:, 0], pos[:, 1]
            span_x = t.terrain_length * (t.num_rows - 1)
            hi_x = t.terrain_length * t.num_rows
            span_y = t.terrain_width * (t.num_cols - 1)
            hi_y = t.terrain_width * t.num_cols
            th = t.teleport_thresh
            x = x + span_x * (x < th).float() - span_x * (x > hi_x - th).float()
            y = y + span_y * (y < th).float() - span_y * (y > hi_y - th).float()
            env = dataclasses.replace(env, phys=dataclasses.replace(
                env.phys, base_pos=torch.stack([x, y, pos[:, 2]], dim=-1)))

        # periodic dof-property re-randomization (legged_robot.py:697-699)
        dr_mask = (env.episode_length % self.rand_interval) == 0
        new_dof = self._sample_dof_dr(gen)
        env = dataclasses.replace(env, **{
            k: _where(dr_mask, v, getattr(env, k)) for k, v in new_dof.items()})

        # global gravity randomization (legged_robot.py:701-705)
        if cfg.domain_rand.randomize_gravity:
            if common_step % self.grav_interval == 0:
                lo, hi = cfg.domain_rand.gravity_range
                grav_off = torch.rand(3, generator=gen, device=dev) \
                    * (hi - lo) + lo
            if (common_step - self.grav_duration) % self.grav_interval == 0:
                grav_off = torch.zeros(3, device=dev)

        # ---- contact-derived foot state ----
        foot_contact = cinfo.foot_forces[..., 2] > 1.0
        contact_filt = foot_contact | env.last_contacts
        air_time = env.feet_air_time + self.dt
        first_contact = (air_time > 0) & contact_filt
        new_air_time = torch.where(contact_filt, torch.zeros_like(air_time),
                                   air_time)

        # ---- termination (legged_robot.py:138-148) ----
        timed_out = env.episode_length >= self.max_episode_length
        reset = (cinfo.base_contact > 1.0) | timed_out
        if cfg.rewards.use_terminal_body_height:
            # over the measured terrain when height sensing is on, else the
            # world z (measured heights 0)
            body_height = phys.base_pos[:, 2]
            if cfg.terrain.measure_heights:
                pts = self._height_points(phys.base_pos, phys.base_quat)
                body_height = body_height - height_min3(
                    self.hf, pts[..., :2]).mean(-1)
            reset |= body_height < cfg.rewards.terminal_body_height
        if cfg.rewards.use_terminal_roll_pitch:
            roll, pitch, _ = quat_util.quat_to_euler_xyz(phys.base_quat)
            ori = cfg.rewards.terminal_body_ori
            reset |= (torch.abs(roll) > ori) | (torch.abs(pitch) > ori)

        # ---- rewards ----
        ctx = RewardCtx(
            base_pos=phys.base_pos, base_quat=phys.base_quat,
            base_lin_vel=base_lin_vel, base_ang_vel=base_ang_vel,
            projected_gravity=projected_gravity, commands=env.commands,
            joint_q=phys.joint_q, joint_qd=phys.joint_qd,
            last_joint_qd=env.last_joint_qd, torques=env.torques,
            actions=env.actions, last_actions=env.last_actions,
            last_last_actions=env.last_last_actions,
            joint_pos_target=env.joint_pos_target,
            last_joint_pos_target=env.last_joint_pos_target,
            last_last_joint_pos_target=env.last_last_joint_pos_target,
            default_joint_q=self.default_joint_q,
            soft_pos_limits=self.soft_pos_limits,
            foot_forces=cinfo.foot_forces,
            foot_velocities=cinfo.foot_velocities,
            prev_foot_velocities=prev_foot_vel,
            foot_positions=cinfo.foot_positions,
            desired_contact_states=env.desired_contact_states,
            foot_indices=env.foot_indices, contact_filt=contact_filt,
            thigh_contact=cinfo.thigh_contact,
            calf_contact=cinfo.calf_contact,
            feet_air_time=air_time, first_contact=first_contact,
            dt=self.dt, foot_side=self.foot_side)
        if self.reward_terms:
            raw = torch.stack([REWARD_FNS[n](ctx, cfg)
                               for n, _ in self.reward_terms], dim=-1)
        else:
            raw = torch.zeros(self.num_envs, 0, device=dev)
        scaled = raw * self.term_scales[None, :]

        # ji22-style positive/negative split by batch-total sign
        # (legged_robot.py:271-287), the group's total under sharding
        sign_pos = all_sum(scaled.sum(0), self.group) >= 0.0
        zero = torch.zeros_like(scaled)
        rew_pos = torch.where(sign_pos[None, :], scaled, zero).sum(-1)
        rew_neg = torch.where(sign_pos[None, :], zero, scaled).sum(-1)
        rw = cfg.rewards
        if rw.only_positive_rewards:
            rew = torch.clamp(rew_pos + rew_neg, min=0.0)
        elif rw.only_positive_rewards_ji22_style:
            sigma = rw.sigma_rew_neg
            if rw.sigma_rew_neg_init is not None:
                frac = min(max(common_step / rw.sigma_rew_neg_anneal_steps,
                               0.0), 1.0)
                sigma = (rw.sigma_rew_neg_init
                         + frac * (sigma - rw.sigma_rew_neg_init))
            rew = rew_pos * torch.exp(rew_neg / sigma)
        else:
            rew = rew_pos + rew_neg

        episode_sums = env.episode_sums + torch.cat([scaled, rew[:, None]], -1)
        cmd_tail = torch.stack([
            base_lin_vel[:, 0], base_ang_vel[:, 2],
            torch.square(base_lin_vel[:, 0] - env.commands[:, 0]),
            torch.square(base_ang_vel[:, 2] - env.commands[:, 2]),
            torch.ones_like(rew)], dim=-1)
        command_sums = env.command_sums + torch.cat(
            [scaled + self.shaped_bias[None, :], cmd_tail], dim=-1)
        env = dataclasses.replace(
            env, last_contacts=foot_contact, feet_air_time=new_air_time,
            prev_foot_velocities=cinfo.foot_velocities,
            episode_sums=episode_sums, command_sums=command_sums,
            timed_out=timed_out)
        world = dataclasses.replace(world, env=env, gravity_offset=grav_off)

        # ---- episode metrics before reset wipes the sums ----
        # (train/eval split, ppo_cse/__init__.py:156-180)
        is_train = torch.arange(self.num_envs, device=dev) < self.num_train_envs
        reset_tr, reset_ev = reset & is_train, reset & ~is_train
        no_sums = torch.zeros_like(episode_sums)
        ep_at_reset = _where(reset_tr, episode_sums, no_sums)
        ep_at_reset_ev = _where(reset_ev, episode_sums, no_sums)

        # ---- masked reset (reset_idx, legged_robot.py:150-239) ----
        spans.phase("env.reset")
        world = self._reset_envs(world, reset)
        env = world.env

        # ---- observations after reset (compute_observations at :124) ----
        spans.phase("env.observe")
        obs, priv_obs = self.observe(world, grav_off)
        # history ring (history_wrapper.py:18-24; not zeroed on resets)
        obs_history = torch.cat([world.obs_history[:, self.num_obs:], obs],
                                dim=-1)
        # action history shift (legged_robot.py:126-130)
        env = dataclasses.replace(
            env, last_last_actions=env.last_actions,
            last_actions=env.actions,
            last_last_joint_pos_target=env.last_joint_pos_target,
            last_joint_pos_target=env.joint_pos_target,
            last_joint_qd=env.phys.joint_qd)
        world = dataclasses.replace(world, env=env, obs_history=obs_history)

        obs_dict = {"obs": obs, "privileged_obs": priv_obs,
                    "obs_history": obs_history}
        info = {
            "time_outs": env.timed_out,
            "episode_sums_at_reset": ep_at_reset.sum(0),
            "num_resets": reset_tr.sum(),
            "eval_episode_sums_at_reset": ep_at_reset_ev.sum(0),
            "eval_num_resets": reset_ev.sum(),
            "mean_episode_length": torch.where(
                is_train, env.episode_length.float(),
                torch.zeros((), device=dev)).sum()
            / max(self.num_train_envs, 1),
        }
        return world, obs_dict, rew, reset, info

    # ------------------------------------------------------------------
    def _reset_envs(self, world: WorldState, mask: torch.Tensor) -> WorldState:
        """Masked env reset, the analog of reset_idx (legged_robot.py:150-239)."""
        world = self._resample_commands(world, mask)
        env, gen = world.env, world.gen
        new_phys = self._reset_phys(gen, env.env_origin)
        new_dof = self._sample_dof_dr(gen)
        zeroed = lambda x: _where(mask, torch.zeros_like(x), x)
        phys = PhysicsState(**{
            f.name: _where(mask, getattr(new_phys, f.name),
                           getattr(env.phys, f.name))
            for f in dataclasses.fields(PhysicsState)})
        env = dataclasses.replace(
            env, phys=phys,
            episode_length=zeroed(env.episode_length),
            gait_index=zeroed(env.gait_index),
            actions=zeroed(env.actions), last_actions=zeroed(env.last_actions),
            last_last_actions=zeroed(env.last_last_actions),
            last_joint_qd=zeroed(env.last_joint_qd),
            lag_buffer=zeroed(env.lag_buffer),
            joint_pos_err_last=zeroed(env.joint_pos_err_last),
            joint_pos_err_last_last=zeroed(env.joint_pos_err_last_last),
            joint_vel_last=zeroed(env.joint_vel_last),
            joint_vel_last_last=zeroed(env.joint_vel_last_last),
            feet_air_time=zeroed(env.feet_air_time),
            last_contacts=zeroed(env.last_contacts),
            episode_sums=zeroed(env.episode_sums),
            **{k: _where(mask, v, getattr(env, k)) for k, v in new_dof.items()})
        # rigid-body DR re-draw on reset (legged_robot.py:166-168)
        dr = self.cfg.domain_rand
        if dr.randomize_rigids_after_start and (dr.randomize_friction
                                                or dr.randomize_restitution):
            env = dataclasses.replace(env, **{
                k: _where(mask, v, getattr(env, k))
                for k, v in self._sample_rigid_dr(gen).items()})
        return dataclasses.replace(world, env=env)

    def observe(self, world: WorldState, gravity_offset=None):
        """(obs, privileged_obs) from the current state, the analog of
        compute_observations (legged_robot.py:302-491)."""
        cfg, env = self.cfg, world.env
        if gravity_offset is None:
            gravity_offset = world.gravity_offset
        phys = env.phys
        N = self.num_envs
        g_world = self.gravity + gravity_offset
        blv = quat_util.quat_rotate_inverse(phys.base_quat, phys.base_lin_vel)
        bav = quat_util.quat_rotate_inverse(phys.base_quat, phys.base_ang_vel)
        pg = quat_util.quat_rotate_inverse(
            phys.base_quat, (g_world / torch.linalg.norm(g_world)).expand(N, 3))
        obs = observations.build_obs(
            cfg, projected_gravity=pg, commands=env.commands,
            joint_q=phys.joint_q, joint_qd=phys.joint_qd,
            default_joint_q=self.default_joint_q, actions=env.actions,
            last_actions=env.last_actions, clock_inputs=env.clock_inputs,
            gait_index=env.gait_index, base_lin_vel=blv, base_ang_vel=bav,
            base_quat=phys.base_quat,
            contact_states=torch.zeros(N, 4, device=self.device))
        if cfg.noise.add_noise:
            obs = obs + (2 * self._rand(world.gen, obs.shape) - 1) \
                * self.noise_vec
        priv = observations.build_privileged_obs(
            cfg, friction=env.friction, restitution=env.restitution,
            payload=env.payload, com_displacement=env.com_displacement,
            motor_strength=env.motor_strength, motor_offset=env.motor_offset,
            Kp_factor=env.Kp_factor, Kd_factor=env.Kd_factor,
            base_lin_vel=blv, base_height=phys.base_pos[:, 2],
            gravity_offset=gravity_offset, clock_inputs=env.clock_inputs,
            desired_contact_states=env.desired_contact_states)
        c = cfg.normalization.clip_observations
        return torch.clamp(obs, -c, c), torch.clamp(priv, -c, c)

    def _height_points(self, base_pos, base_quat):
        """Yaw-rotated height measurement grid (legged_robot.py:1756-1770):
        (N, P, 3) world points."""
        t, dev = self.cfg.terrain, self.device
        gx, gy = torch.meshgrid(
            spans.tensor(t.measured_points_x, dev, torch.float32),
            spans.tensor(t.measured_points_y, dev, torch.float32),
            indexing="ij")
        pts = torch.stack([gx.reshape(-1), gy.reshape(-1),
                           torch.zeros(gx.numel(), device=dev)], -1)
        N, P = base_pos.shape[0], pts.shape[0]
        q = base_quat[:, None].expand(N, P, 4)
        return (quat_util.quat_apply_yaw(q, pts.expand(N, P, 3))
                + base_pos[:, None])

    def get_observations(self, world: WorldState):
        """HistoryWrapper.get_observations (history_wrapper.py:26-30):
        append the current obs to the history ring and return the dict."""
        obs, priv = self.observe(world)
        obs_history = torch.cat([world.obs_history[:, self.num_obs:], obs], -1)
        world = dataclasses.replace(world, obs_history=obs_history)
        return world, {"obs": obs, "privileged_obs": priv,
                       "obs_history": obs_history}


def make_legged_env(cfg: Cfg, robot: Optional[RobotModel] = None,
                    device=None, seed: int = 0,
                    eval_terrain_cfg=None, group=None) -> LeggedEnv:
    """Build a LeggedEnv, generating the Stack-A terrain and the env
    origins on it when `cfg.terrain.mesh_type` is 'heightfield'
    (`wtw_tpu/envs/__init__.py`; the reference's LeggedRobot.create_sim,
    legged_robot.py:493-515, 1675-1714). The map is built on the host with
    numpy and moved to the env's device."""
    from ..models.robot import load_robot
    if robot is None:
        robot = load_robot(cfg.asset.robot)
    if cfg.terrain.mesh_type == "heightfield":
        from ..terrain import (assign_env_origins, build_terrain,
                               to_heightfield)
        dev = resolve_device(device)
        tm = build_terrain(cfg.terrain, seed=seed, eval_cfg=eval_terrain_cfg)
        origins, _, _ = assign_env_origins(tm, cfg.env.num_envs, cfg.terrain,
                                           seed=seed)
        return LeggedEnv(cfg, robot, heightfield=to_heightfield(tm, dev),
                         env_origins=origins, device=dev, group=group)
    return LeggedEnv(cfg, robot, device=device, group=group)
