"""Parkour and rough-terrain environment with Constraints-as-Terminations
(Stack B; port of `wtw_tpu/envs/parkour_env.py`, batched backend).

Same semantics as the JAX env's batched path (reference
tasks/go2_parkour.py:21-1697, and tasks/go2_terrain.py for
`task="terrain"`):

- PD torques, or the learned actuator net, with the torque clip and
  stiction/viscous motor friction, inside a loop of `decimation` physics
  substeps that reuses the corner rows gathered at the policy-step start
  (`hf_substep_cache`);
- `task="parkour"`: the ground AND the ceiling heightfield in every
  substep (crawl tracks put overhead barriers over 20% of the mixed
  course); `task="terrain"`: the Stack-A slope/stair/obstacle grid, with
  no ceiling, so kernel B runs its ground-only path;
- the divergence guard, pushes, the fixed-trot gait clock, ceiling
  tracking and the move-up flag, contact bookkeeping, hard terminations
  and the full CaT battery (a probabilistic done per env for the learner's
  GAE and a hard reset);
- the velocity-tracking reward (`reward_mode="cat"`) or the full
  rough-terrain battery with the raibert term (`reward_mode="full"`);
- the optional pre-reset observation (`provide_true_next_obs`), the imu
  and clock observations;
- episode metrics, per-track-type crossings, the masked reset with the
  terrain curriculum, stochastic command updates, and the post-reset
  observation with its history refresh.

Randomness comes from one `torch.Generator` per world (`ParkourWorld.gen`,
on the env's device), seeded by `init_state(seed)`. JAX's per-env key
streams cannot be reproduced in torch, so the two envs agree only where no
draw is made (tests switch the draws off).
"""
from __future__ import annotations

import dataclasses
import weakref
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from .. import resolve_device
from ..config import TerrainCfg
from ..models.actuator_net import apply_actuator_net, load_actuator_net
from ..models.robot import RobotModel, default_joint_angles
from ..parallel.mesh import draw_rows, group_size, shard_rows
from ..physics import EngineParams, PhysicsState, physics_step_batched
from ..physics.heightfield import height_min3
from ..terrain import (ParkourTerrainCfg, assign_env_origins,
                       assign_parkour_origins, build_parkour, build_terrain,
                       ceiling_heightfield, to_heightfield)
from ..utils import quat as quat_util
from ..utils import graphs, spans
from . import gait
from .constraints import CaTManager, CaTState, sqrt_func

GO2_DEFAULT_JOINT_ANGLES = (
    ("FL_hip_joint", 0.1), ("RL_hip_joint", 0.1), ("FR_hip_joint", -0.1),
    ("RR_hip_joint", -0.1), ("FL_thigh_joint", 0.8), ("RL_thigh_joint", 1.0),
    ("FR_thigh_joint", 0.8), ("RR_thigh_joint", 1.0), ("FL_calf_joint", -1.5),
    ("RL_calf_joint", -1.5), ("FR_calf_joint", -1.5), ("RR_calf_joint", -1.5),
)  # cfg/task/Go2Parkour.yaml defaultJointAngles


@dataclass(frozen=True)
class ParkourLimits:
    # cfg/task/Go2Parkour.yaml learn.limits (:139-152)
    torque: float = 35.0
    vel: float = 16.0
    action_rate: float = 120.0
    base_orientation: float = 0.1
    foot_contact_force: float = 120.0
    HFE: float = 1.9
    HFE_min: float = -0.2
    HAA: float = 0.3
    min_base_height: float = 0.06
    heading: float = 0.1
    KFE_min: float = -2.8       # hard-coded at go2_parkour.py:920


@dataclass(frozen=True)
class TerrainRewardScales:
    """Full reward battery for the rough-terrain task when CaT is off
    (tasks/go2_terrain.py:43-74 / compute_reward :1024-1090). Values from
    cfg/task/Go2Terrain.yaml."""
    termination: float = 0.0
    lin_vel_xy: float = 1.0
    ang_vel_z: float = 0.5
    lin_vel_z: float = -4.0
    ang_vel_xy: float = -0.05
    orient: float = -1.0
    base_height: float = 0.0
    torque: float = -0.00002
    joint_acc: float = -0.0005
    air_time: float = 1.0
    collision: float = -0.25
    stumble: float = -2.0
    action_rate: float = -0.01
    dof_pos: float = -0.1
    dof_vel_limit: float = -0.1
    hip: float = -0.1
    raibert: float = -10.0
    foot2contact: float = 0.0
    stand_still: float = 0.0


def rough_terrain_cfg() -> TerrainCfg:
    """The terrain task's map when `ParkourCfg.rough_terrain` is None
    (wtw_tpu/envs/parkour_env.py:301-305): 10 levels x 20 columns of 5 m
    cells at 0.1 m with an 8 m border, robots at the cell starts, all on
    level 0 at first, five kinds of ground at 0.2 each."""
    return TerrainCfg(
        curriculum=True, num_rows=10, num_cols=20, border_size=8.0,
        center_robots=False, max_init_terrain_level=0,
        terrain_proportions=(0.2, 0.2, 0.2, 0.2, 0.2, 0, 0, 0, 0))


@dataclass(frozen=True)
class ParkourCfg:
    # cfg/task/Go2Parkour.yaml; with task='terrain' this becomes the
    # Go2Terrain rough-terrain task (tasks/go2_terrain.py + Go2Terrain.yaml).
    # The JAX ParkourCfg's fields, without survival_bonus, which nothing
    # reads.
    robot: str = "go2"
    task: str = "parkour"            # 'parkour' | 'terrain'
    num_envs: int = 4096
    num_actions: int = 12
    # terrain-task extras (tasks/go2_terrain.py)
    use_gait_clocks: bool = False    # fixed 3 Hz trot clock (:582-611)
    observe_clock_inputs: bool = False
    use_actuator_net: bool = False   # unitree_go2 net (:177-203)
    reward_mode: str = "cat"         # 'cat' | 'full'
    provide_true_next_obs: bool = False  # go2_terrain.py:734 (off-policy)
    terrain_rewards: TerrainRewardScales = dataclasses.field(
        default_factory=TerrainRewardScales)
    # the terrain task's map; None: rough_terrain_cfg()
    rough_terrain: Optional[TerrainCfg] = None
    num_history_samples: int = 1      # numHistorySamples
    num_history_step: int = 1         # numHistoryStep (0 in yaml == 1 in effect)
    episode_length_s: float = 25.0
    # commands (randomCommandVelocityRanges)
    lin_vel_x: Tuple[float, float] = (0.0, 0.6)
    lin_vel_y: Tuple[float, float] = (-0.6, 0.6)
    ang_vel_yaw: Tuple[float, float] = (-0.78, 0.78)
    only_forwards: bool = False
    only_forwards_velocity: float = 0.6
    # control
    stiffness: float = 20.0
    damping: float = 0.5
    action_scale: float = 0.25
    decimation: int = 4
    # reuse the policy-step-start terrain corner rows across the substeps
    hf_substep_cache: bool = True
    torque_clip: float = 100.0        # hard clip (pre_physics_step :1237)
    # divergence guard: a diverged env is terminated and reset like an
    # instant fall (limits far above any physical value)
    divergence_lin_vel_limit: float = 100.0    # m/s
    divergence_joint_vel_limit: float = 1000.0  # rad/s
    # rewards (learn block)
    lin_vel_xy_scale: float = 1.0
    ang_vel_z_scale: float = 0.5
    lin_vel_delta: float = 0.25
    ang_vel_delta: float = 0.25
    # constraints (learn.constraints_CaT + limits)
    cat_tau: float = 0.95
    cat_min_p: float = 0.0
    soft_p: float = 0.1
    use_soft_p_curriculum: bool = True
    soft_p_total_steps: int = 24 * 8000  # horizon_length * max_epochs
    air_time_target: float = 0.25
    limits: ParkourLimits = dataclasses.field(default_factory=ParkourLimits)
    allow_knee_contacts: bool = False
    flat_terrain_threshold: float = 0.001
    vel_deadzone: float = 0.2
    base_height_target: float = 0.245
    # observations (learn.observe flags :160-172)
    observe_base_lin_vel: bool = False
    observe_base_ang_vel: bool = True
    observe_commands: bool = True
    observe_misc: bool = True
    observe_heights: bool = True
    observe_ceilings: bool = True
    observe_phases: bool = False
    observe_imu: bool = False
    measured_points_step: float = 0.08
    measured_points_x: Tuple[int, ...] = tuple(range(-3, 10))
    measured_points_y: Tuple[int, ...] = tuple(range(-5, 6))
    phases_freq: float = 2.0
    # scales
    lin_vel_scale: float = 2.0
    ang_vel_scale: float = 0.25
    dof_pos_scale: float = 1.0
    dof_vel_scale: float = 0.05
    height_meas_scale: float = 5.0
    imu_scale: float = 0.1
    # noise
    add_noise: bool = True
    noise_level: float = 1.0
    dof_pos_noise: float = 0.01
    dof_vel_noise: float = 0.2
    lin_vel_noise: float = 0.0
    ang_vel_noise: float = 0.001
    gravity_noise: float = 0.05
    height_meas_noise: float = 0.01
    # domain randomization
    randomize_friction: bool = True
    friction_range: Tuple[float, float] = (0.5, 1.25)
    randomize_motor_friction: bool = True
    mu_v_range: Tuple[float, float] = (0.0, 0.3)
    Fs_range: Tuple[float, float] = (0.0, 2.5)
    push_robots: bool = True
    push_interval_s: float = 8.0
    # sim
    dt: float = 0.005
    contact_stiffness: float = 10_000.0
    contact_damping: float = 300.0
    armature: float = 0.01
    # terrain
    terrain: ParkourTerrainCfg = dataclasses.field(
        default_factory=ParkourTerrainCfg)
    init_pos: Tuple[float, float, float] = (0.0, 0.0, 0.34)

    @property
    def policy_dt(self) -> float:
        return self.decimation * self.dt

    @property
    def max_episode_length(self) -> int:
        return int(np.ceil(self.episode_length_s / self.policy_dt))


@dataclasses.dataclass
class ParkourEnvState:
    """Per-env state, leading (N,) axis everywhere (field names follow the
    JAX ParkourEnvState; its per-env `rng` keys become ParkourWorld.gen)."""
    phys: PhysicsState
    progress: torch.Tensor           # int32 episode step
    commands: torch.Tensor           # (N, 3) world-frame vx, vy, wz
    actions: torch.Tensor
    last_actions: torch.Tensor
    last_last_actions: torch.Tensor  # terrain action_rate 2nd diff (:1058)
    last_joint_qd: torch.Tensor      # joint_acc reward (:1047)
    last_base_lin_vel: torch.Tensor  # (N, 3) world; imu accel obs (:864-868)
    torques: torch.Tensor
    # gait clock (terrain task, go2_terrain.py:582-611)
    gait_index: torch.Tensor         # (N,)
    clock_inputs: torch.Tensor       # (N, 4)
    foot_indices: torch.Tensor       # (N, 4)
    # actuator-net joint-state history (go2_terrain.py:1480-1490)
    joint_pos_err_last: torch.Tensor
    joint_pos_err_last_last: torch.Tensor
    joint_vel_last: torch.Tensor
    joint_vel_last_last: torch.Tensor
    # per-episode DR draws
    friction: torch.Tensor
    motor_Fs: torch.Tensor           # (N, nj) stiction torque
    motor_mu_v: torch.Tensor         # (N, nj) viscous coefficient
    # contact bookkeeping (process_contacts :1187-1209)
    feet_swing_time: torch.Tensor    # (N, 4)
    feet_swing_apex: torch.Tensor
    feet_clearance: torch.Tensor
    # terrain curriculum
    terrain_level: torch.Tensor      # int64
    terrain_type: torch.Tensor       # int64
    env_origin: torch.Tensor         # (N, 3)
    move_up_flag: torch.Tensor       # bool
    # episode metric accumulators: [rew_lin_vel, rew_ang_vel, cstr_0..n-1]
    episode_sums: torch.Tensor
    timed_out: torch.Tensor          # bool


@dataclasses.dataclass
class ParkourWorld:
    env: ParkourEnvState
    cat: CaTState
    soft_p_progress: np.float32      # in [0, 1], summed in float32 as in JAX
    hist_obs: torch.Tensor           # (N, hist_len * sample_obs)
    common_step: int
    gen: torch.Generator


# constraint battery declaration (names + column widths), in the exact
# order the reference adds them (go2_parkour.py:976-1016)
def _constraint_decls(nj: int):
    return [
        ("heading", 1), ("stumble", 4),
        ("dof_pos_lower", nj), ("dof_pos_upper", nj),
        ("torque", nj), ("joint_vel", nj), ("action_rate", nj),
        ("knee_contact", 4), ("base_contact", 1), ("foot_contact", 4),
        ("upsidedown", 1), ("lava", 1),
        ("HFE", 2), ("HFE_min", 2), ("KFE", 4), ("KFE_min", 4), ("HAA", 4),
        ("base_ori", 1), ("air_time", 4), ("no_move", 1),
        ("2footcontact", 1),
    ]


# constraints whose termination probability is 1, and the one at
# 0.1 + soft_p (go2_parkour.py:1005-1016); the rest run at soft_p
_HARD_P = ("knee_contact", "base_contact", "foot_contact", "upsidedown",
           "lava")


def _where(mask: torch.Tensor, a, b):
    """Masked select with the (N,) mask broadcast over trailing dims; `a`
    a tensor or a Python number (of b's kind: no host-to-device copy)."""
    if not torch.is_tensor(a):
        a = (float(a) if b.is_floating_point()
             else bool(a) if b.dtype == torch.bool else int(a))
    return torch.where(mask.reshape(mask.shape + (1,) * (b.dim() - 1)), a, b)


def soft_p_step(progress: np.float32, cfg: ParkourCfg):
    """One step of the soft-p curriculum (go2_parkour.py:966-974): ->
    (progress', soft_p), both float32 (elementwise for an array of
    progresses). The progress is carried and summed in float32 exactly as
    the JAX env sums it (a float32 scalar plus the weakly typed 1 /
    soft_p_total_steps, rounded to float32 first), so the schedule reaches
    1.0 at the same step on both sides."""
    f32 = np.float32
    progress = np.clip(f32(progress) + f32(1.0 / cfg.soft_p_total_steps),
                       f32(0.0), f32(1.0)).astype(f32)
    if cfg.use_soft_p_curriculum:
        # 1 / (T_start + progress (T_end - T_start)) with T_start 25 and
        # T_end 1 / soft_p, their difference rounded to float32. The jitted
        # JAX step fuses the multiply-add (one rounding): the product and
        # sum are exact in float64, so one rounding to float32 matches it
        slope = float(f32(1.0 / cfg.soft_p - 25.0))
        soft_p = f32(1.0) / (25.0 + progress.astype(np.float64)
                             * slope).astype(f32)
    else:
        soft_p = f32(cfg.soft_p)
    return progress, f32(soft_p)


def soft_p_mirror(progress: torch.Tensor, cfg: ParkourCfg):
    """`soft_p_step` on a float32 tensor of progresses (the env step's
    device mirror, a 0-d tensor, or a whole sequence at once), with the
    same roundings: the float32 clip-add, then 25 + progress * slope in
    float64 as two separate ops, rounded to float32, and its float32
    reciprocal. -> (progress', soft_p), float32, bit for bit the host's."""
    f32 = np.float32
    inc = float(f32(1.0 / cfg.soft_p_total_steps))
    progress = torch.clamp(progress + inc, 0.0, 1.0)
    if cfg.use_soft_p_curriculum:
        slope = float(f32(1.0 / cfg.soft_p - 25.0))
        t = progress.double() * slope
        soft_p = torch.reciprocal((t + 25.0).float())
    else:
        soft_p = torch.full_like(progress, float(f32(cfg.soft_p)))
    return progress, soft_p


def graph_engages(device, group) -> bool:
    """Whether `ParkourEnv.step` replays a CUDA graph: on a CUDA device and
    unsharded (a sharded rank's collectives cannot be captured)."""
    return torch.device(device).type == "cuda" and group is None


class ParkourEnv:
    """step(world, actions) -> (world', obs (N, num_obs), rew (N,),
    done_prob (N,), info)."""

    def __init__(self, cfg: ParkourCfg, model: RobotModel, seed: int = 0,
                 device=None, group=None):
        """group: a process group to shard the envs over: this rank steps
        its equal share of `cfg.num_envs` (`num_envs`; the total is
        `num_envs_global`), draws every per-env tensor at the global width
        keeping its own rows, and takes CaT's batch max and violation
        fractions over the group."""
        if cfg.task not in ("parkour", "terrain"):
            raise ValueError(f"task {cfg.task!r}: 'parkour' or 'terrain'")
        if cfg.reward_mode not in ("cat", "full"):
            raise ValueError(f"reward_mode {cfg.reward_mode!r}: 'cat' or "
                             f"'full'")
        self.device = resolve_device(device)
        dev = self.device
        self.cfg = cfg
        self.model = model.to(dev)
        model = self.model
        self.group = group
        W = group_size(group)
        if cfg.num_envs % W:
            raise ValueError(f"{cfg.num_envs} envs do not shard over {W} "
                             f"ranks")
        self.num_envs_global = cfg.num_envs
        self.num_envs = cfg.num_envs // W
        self.num_actions = cfg.num_actions
        self.dt = cfg.policy_dt
        self.max_episode_length = cfg.max_episode_length

        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        if cfg.task == "terrain":
            # rough-terrain task: the Stack-A slope/stair/obstacle grid
            # (tasks/terrain.py), no ceilings, no lava
            tcfg = cfg.rough_terrain or rough_terrain_cfg()
            tm = build_terrain(tcfg, seed=seed)
            origins, levels, types = assign_env_origins(
                tm, cfg.num_envs, tcfg, seed=seed)
            self.hf_ceiling = None
            self.terrain_ceilings = torch.full(
                (tm.num_rows, tm.num_cols), cfg.terrain.default_ceiling,
                device=dev)
            self.track_length = tcfg.terrain_length
            self.num_terrain_levels = tm.num_rows
        else:
            tm = build_parkour(cfg.terrain, seed=seed)
            self.hf_ceiling = ceiling_heightfield(tm, device=dev)
            origins, levels, types = assign_parkour_origins(
                tm, cfg.num_envs, cfg.terrain, seed=seed)
            self.terrain_ceilings = f32(tm.ceilings)         # (lvl, type)
            self.track_length = cfg.terrain.map_length
            self.num_terrain_levels = cfg.terrain.num_levels
        self.hf = to_heightfield(tm, device=dev)
        self.terrain_origins = f32(tm.env_origins)           # (lvl, type, 3)
        self.init_origins = shard_rows(f32(origins), group)
        self.init_levels = shard_rows(torch.as_tensor(
            levels, dtype=torch.long, device=dev), group)
        self.init_types = shard_rows(torch.as_tensor(
            types, dtype=torch.long, device=dev), group)

        self.engine_params = EngineParams(
            dt=cfg.dt, contact_stiffness=cfg.contact_stiffness,
            contact_damping=cfg.contact_damping, armature=cfg.armature)
        self.default_joint_q = default_joint_angles(
            model, dict(GO2_DEFAULT_JOINT_ANGLES))
        self.base_init_pos = f32(cfg.init_pos)
        # constants of the step, made once (a per-step copy from the host
        # would be a host sync)
        self.g_unit = f32([0.0, 0.0, -1.0])
        self.forward_command = f32([cfg.only_forwards_velocity, 0.0, 0.0])
        self.command_obs_scale = f32([cfg.lin_vel_scale, cfg.lin_vel_scale,
                                      cfg.ang_vel_scale])
        self.phase_offsets = f32([0.0, np.pi, np.pi, 0.0])
        # raibert: nominal stance x and y per foot, and the side of the y
        # offset (go2_terrain.py:612-646)
        self.raibert_nom = f32([[0.225, 0.225, -0.225, -0.225],
                                [0.125, -0.125, 0.125, -0.125]])
        self.raibert_side = f32([1.0, 1.0, -1.0, -1.0])
        self.hfe_ix = torch.tensor([1, 4], device=dev)
        self.kfe_ix = torch.tensor([2, 5, 8, 11], device=dev)
        self.haa_ix = torch.tensor([0, 3, 6, 9], device=dev)

        # height-scan grid, robot frame (learn.measured_points_* :167-169)
        xs = np.asarray(cfg.measured_points_x) * cfg.measured_points_step
        ys = np.asarray(cfg.measured_points_y) * cfg.measured_points_step
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        self.height_points = f32(
            np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], -1))
        self.num_height_points = gx.size

        # optional learned actuator model (go2_terrain.py:177-203): the JAX
        # package's converted weights, of which the port ships copies
        self.actuator_params = None
        if cfg.use_actuator_net:
            try:
                self.actuator_params = load_actuator_net(
                    f"actuator_{cfg.robot}", device=dev)
            except FileNotFoundError:
                raise NotImplementedError(
                    f"no actuator net for robot {cfg.robot!r} in the "
                    f"port") from None
        # the terrain task's fixed 3 Hz trot (go2_terrain.py:582-611) as
        # step_gait commands: frequency 3, phase 0.5, duration 0.5
        self.trot_command = torch.tensor(
            [0, 0, 0, 0, 3.0, 0.5, 0.0, 0.0, 0.5, 0, 0, 0, 0, 0, 0],
            dtype=torch.float32, device=dev)

        self.cstr = CaTManager(_constraint_decls(model.nj), tau=cfg.cat_tau,
                               min_p=cfg.cat_min_p, device=dev, group=group)
        self.cstr_names = list(self.cstr.names)
        self.n_metrics = 2 + len(self.cstr_names)
        # per-column max termination probabilities: 1 on the hard columns,
        # soft_p elsewhere, 0.1 more on stumble's (go2_parkour.py:1005-1016)
        self.hard_cols = self.cstr.columns(_HARD_P)
        self.stumble_add = self.cstr.columns(["stumble"]).float() * float(
            np.float32(0.1))

        # observation layout
        self.sample_obs_size = self._sample_obs_dim()
        self.hist_len = max(cfg.num_history_samples, 1) * max(
            cfg.num_history_step, 1)
        self.num_obs = cfg.num_history_samples * self.sample_obs_size
        self.noise_vec = f32(self._noise_vec())
        step = max(cfg.num_history_step, 1) * self.sample_obs_size
        self.obs_index = torch.cat([
            torch.arange(i * step, i * step + self.sample_obs_size)
            for i in range(cfg.num_history_samples)]).to(dev)
        self._donated = (DonatedStep(self) if graph_engages(dev, group)
                         else None)

    # ------------------------------------------------------------------
    def _sample_obs_dim(self) -> int:
        cfg = self.cfg
        n = 0
        if cfg.observe_base_lin_vel:
            n += 3
        if cfg.observe_base_ang_vel:
            n += 3
        if cfg.observe_commands:
            n += 3
        if cfg.observe_misc:
            n += 3 + 3 * self.model.nj      # projected gravity + q + qd + actions
        if cfg.observe_heights:
            n += self.num_height_points
        if cfg.observe_ceilings:
            n += 1
        if cfg.observe_phases:
            n += 8
        if cfg.observe_imu:
            n += 3
        if cfg.observe_clock_inputs:
            n += 4
        return n

    def _noise_vec(self) -> np.ndarray:
        """get_noise_scale_vec analog (go2_parkour.py yaml noise)."""
        cfg = self.cfg
        nj = self.model.nj
        parts = []
        if cfg.observe_base_lin_vel:
            parts.append(np.full(3, cfg.lin_vel_noise * cfg.lin_vel_scale))
        if cfg.observe_base_ang_vel:
            parts.append(np.full(3, cfg.ang_vel_noise * cfg.ang_vel_scale))
        if cfg.observe_commands:
            parts.append(np.zeros(3))
        if cfg.observe_misc:
            parts.append(np.concatenate([
                np.full(3, cfg.gravity_noise),
                np.full(nj, cfg.dof_pos_noise * cfg.dof_pos_scale),
                np.full(nj, cfg.dof_vel_noise * cfg.dof_vel_scale),
                np.zeros(nj)]))
        if cfg.observe_heights:
            parts.append(np.full(self.num_height_points,
                                 cfg.height_meas_noise * cfg.height_meas_scale))
        if cfg.observe_ceilings:
            parts.append(np.zeros(1))
        if cfg.observe_phases:
            parts.append(np.zeros(8))
        if cfg.observe_imu:
            parts.append(np.zeros(3))
        if cfg.observe_clock_inputs:
            parts.append(np.zeros(4))
        return np.concatenate(parts).astype(np.float32) * cfg.noise_level

    def _rand(self, gen, shape):
        """Uniform [0, 1) per-env draws (rows = envs): at the group's
        global width, this rank's rows kept."""
        return draw_rows(lambda s: torch.rand(s, generator=gen,
                                              device=self.device),
                         shape, self.group)

    def _uniform(self, gen, shape, lo, hi):
        return self._rand(gen, shape) * (hi - lo) + lo

    def _bernoulli(self, gen, p, n):
        return self._rand(gen, (n,)) < p

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> ParkourWorld:
        N, nj, dev = self.num_envs, self.model.nj, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        zero_j = torch.zeros(N, nj, device=dev)
        zero4 = torch.zeros(N, 4, device=dev)
        env = ParkourEnvState(
            phys=self._reset_phys(gen, self.init_origins),
            progress=torch.zeros(N, dtype=torch.int32, device=dev),
            commands=self._sample_commands(gen, N),
            actions=zero_j, last_actions=zero_j, last_last_actions=zero_j,
            last_joint_qd=zero_j,
            last_base_lin_vel=torch.zeros(N, 3, device=dev), torques=zero_j,
            gait_index=torch.zeros(N, device=dev), clock_inputs=zero4,
            foot_indices=zero4, joint_pos_err_last=zero_j,
            joint_pos_err_last_last=zero_j, joint_vel_last=zero_j,
            joint_vel_last_last=zero_j,
            **self._sample_dr(gen, N),
            feet_swing_time=zero4, feet_swing_apex=zero4,
            feet_clearance=zero4,
            terrain_level=self.init_levels.clone(),
            terrain_type=self.init_types.clone(),
            env_origin=self.init_origins.clone(),
            move_up_flag=torch.zeros(N, dtype=torch.bool, device=dev),
            episode_sums=torch.zeros(N, self.n_metrics, device=dev),
            timed_out=torch.zeros(N, dtype=torch.bool, device=dev))
        return ParkourWorld(
            env=env, cat=self.cstr.init_state(),
            soft_p_progress=np.float32(0.0),
            hist_obs=torch.zeros(N, self.hist_len * self.sample_obs_size,
                                 device=dev),
            common_step=0, gen=gen)

    def _sample_dr(self, gen, N) -> Dict[str, torch.Tensor]:
        cfg, nj, dev = self.cfg, self.model.nj, self.device
        friction = (self._uniform(gen, (N,), *cfg.friction_range)
                    if cfg.randomize_friction
                    else torch.ones(N, device=dev))
        if cfg.randomize_motor_friction:
            Fs = self._uniform(gen, (N, nj), *cfg.Fs_range)
            mu_v = self._uniform(gen, (N, nj), *cfg.mu_v_range)
        else:
            Fs = mu_v = torch.zeros(N, nj, device=dev)
        return dict(friction=friction, motor_Fs=Fs, motor_mu_v=mu_v)

    def _reset_phys(self, gen, origin) -> PhysicsState:
        """reset_idx state randomization (go2_parkour.py:1039-1057)."""
        N, nj, dev = origin.shape[0], self.model.nj, self.device
        joint_q = self.default_joint_q * self._uniform(gen, (N, nj),
                                                       0.95, 1.05)
        joint_qd = self._uniform(gen, (N, nj), -0.05, 0.05)
        xy = self._uniform(gen, (N, 2), -0.05, 0.05)
        yaw_half = self._uniform(gen, (N,), -0.001, 0.001)
        zero = torch.zeros(N, device=dev)
        quat = torch.stack([zero, zero, torch.sin(yaw_half),
                            torch.cos(yaw_half)], dim=-1)
        pos = origin + self.base_init_pos + torch.cat(
            [xy, zero[:, None]], dim=1)
        return PhysicsState(
            base_pos=pos, base_quat=quat,
            base_lin_vel=torch.zeros(N, 3, device=dev),
            base_ang_vel=torch.zeros(N, 3, device=dev),
            joint_q=joint_q, joint_qd=joint_qd)

    def _sample_commands(self, gen, N) -> torch.Tensor:
        """resample_commands (go2_parkour.py:1127-1156): vx, vy uniform;
        wz = 0 at resample (flipped stochastically later); deadzone."""
        cfg, dev = self.cfg, self.device
        if cfg.only_forwards:
            return self.forward_command.expand(N, 3).clone()
        vx = self._uniform(gen, (N,), *cfg.lin_vel_x)
        vy = self._uniform(gen, (N,), *cfg.lin_vel_y)
        cmd = torch.stack([vx, vy, torch.zeros_like(vx)], dim=-1)
        keep = ((torch.linalg.vector_norm(cmd[:, :2], dim=1) > cfg.vel_deadzone)
                & (vx > cfg.vel_deadzone)).float()
        return cmd * torch.stack([keep, keep, torch.ones_like(keep)], -1)

    # ------------------------------------------------------------------
    def _robot_command(self, base_quat, commands):
        """World xy command rotated into the yaw frame (get_robot_command,
        go2_parkour.py:622-631)."""
        yaw = quat_util.quat_yaw(base_quat)
        c, s = torch.cos(yaw), torch.sin(yaw)
        vx = c * commands[:, 0] + s * commands[:, 1]
        vy = -s * commands[:, 0] + c * commands[:, 1]
        return torch.stack([vx, vy, commands[:, 2]], dim=-1)

    def _measured_heights(self, base_pos, base_quat):
        """Yaw-rotated grid raycast (get_heights; go2_parkour.py:1600-1650):
        -> (N, num_height_points) terrain heights under the scan points."""
        N, n = base_pos.shape[0], self.num_height_points
        yq = quat_util.yaw_quat(base_quat)[:, None].expand(N, n, 4)
        pts = quat_util.quat_rotate(
            yq, self.height_points.expand(N, n, 3)) + base_pos[:, None]
        return height_min3(self.hf, pts[..., :2])

    def _ceilings(self, env: ParkourEnvState):
        """Ceiling observation: the cell's ceiling inside the crawl windows
        of the track, 0.4 elsewhere (go2_parkour.py:1313-1316)."""
        pos_x = torch.remainder(env.phys.base_pos[:, 0], self.track_length)
        crawl = (((pos_x > 1.55) & (pos_x < 3.45))
                 | ((pos_x > 5.55) & (pos_x < 7.45))).float()
        cell = self.terrain_ceilings[env.terrain_level, env.terrain_type]
        return crawl * cell + (1.0 - crawl) * 0.4

    @spans.spanned("env.torques")
    def _compute_tau(self, s: ParkourEnvState, actions, hist=None):
        """PD or the actuator net, the clip, then motor friction
        (:1218-1265) -> tau. With the actuator net, the history fields to
        carry into the next substep go into the dict `hist`."""
        cfg = self.cfg
        q, qd = s.phys.joint_q, s.phys.joint_qd
        target = cfg.action_scale * actions + self.default_joint_q
        if self.actuator_params is not None:
            pos_err = q - target
            tau = apply_actuator_net(
                self.actuator_params, pos_err, s.joint_pos_err_last,
                s.joint_pos_err_last_last, qd, s.joint_vel_last,
                s.joint_vel_last_last)
            if hist is not None:
                hist.update(joint_pos_err_last=pos_err,
                            joint_pos_err_last_last=s.joint_pos_err_last,
                            joint_vel_last=qd,
                            joint_vel_last_last=s.joint_vel_last)
        else:
            tau = cfg.stiffness * (target - q) - cfg.damping * qd
        tau = torch.clamp(tau, -cfg.torque_clip, cfg.torque_clip)
        # stiction + viscous motor friction (:1242-1245)
        return tau - (s.motor_Fs * torch.tanh(qd / 0.1) + s.motor_mu_v * qd)

    def _substep(self, s: ParkourEnvState, actions, **cache_kw):
        hist = {}
        tau = self._compute_tau(s, actions, hist)
        # hf_ceiling is None on the terrain task: kernel B's ground-only path
        res = physics_step_batched(
            self.model, self.hf, self.engine_params, s.phys, tau, s.friction,
            0.0, hf_ceiling=self.hf_ceiling, **cache_kw)
        return dataclasses.replace(s, phys=res[0], torques=tau, **hist), \
            res[1:]

    # ------------------------------------------------------------------
    @spans.spanned("env.step")
    def step(self, world: ParkourWorld, actions: torch.Tensor):
        """On a CUDA device and unsharded (`graph_engages`), the replay of
        one CUDA graph over a donated world (`DonatedStep`): the world
        returned is the env's state arena, which the next step overwrites.
        Elsewhere the functional step: fresh tensors out."""
        if self._donated is not None:
            return self._donated.step(world, actions)
        return self.functional_step(world, actions)

    def functional_step(self, world: ParkourWorld, actions: torch.Tensor):
        """The step as a function of the world (the eager step)."""
        soft_p_progress, soft_p = soft_p_step(world.soft_p_progress, self.cfg)
        common_step = world.common_step + 1
        env, cat_state, hist, obs, rew, done_prob, info = self._step_body(
            world, actions, float(soft_p), common_step == 1)
        info["soft_p"] = soft_p
        world = ParkourWorld(env=env, cat=cat_state,
                             soft_p_progress=soft_p_progress, hist_obs=hist,
                             common_step=common_step, gen=world.gen)
        return world, obs, rew, done_prob, info

    def _step_body(self, world: ParkourWorld, actions: torch.Tensor, soft_p,
                   first_step):
        """The step's device work, with no host sync: `soft_p` is this
        step's soft p and `first_step` whether common_step is now 1, each a
        host value or a 0-d device tensor (the graph's mirrors); the
        world's host fields are not read. -> (env', CaT state', history',
        obs, rew, done_prob, info without "soft_p")."""
        cfg, model = self.cfg, self.model
        N = actions.shape[0]
        gen = world.gen
        dev = self.device

        # ---- decimation loop: PD + motor friction, both heightfields ----
        env = dataclasses.replace(world.env, actions=actions)
        if cfg.hf_substep_cache and not self.hf.is_flat:
            # substeps reuse the corner rows gathered at the step's start
            env, (cinfo, hfc) = self._substep(env, actions,
                                              return_hf_cache=True)
            for _ in range(cfg.decimation - 1):
                env, (cinfo,) = self._substep(env, actions, hf_cache=hfc)
        else:
            for _ in range(cfg.decimation):
                env, (cinfo,) = self._substep(env, actions)
        env = dataclasses.replace(env, progress=env.progress + 1)

        phys = env.phys
        # ---- divergence guard (see ParkourCfg.divergence_*) ----
        spans.phase("env.reward")
        finite_state = torch.ones(N, dtype=torch.bool, device=dev)
        for f in ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel",
                  "joint_q", "joint_qd"):
            finite_state &= torch.isfinite(getattr(phys, f)).all(-1)
        in_bounds = ((phys.base_lin_vel.abs().amax(-1)
                      < cfg.divergence_lin_vel_limit)
                     & (phys.joint_qd.abs().amax(-1)
                        < cfg.divergence_joint_vel_limit))
        diverged = ~(finite_state & in_bounds)
        base_lin_vel = quat_util.quat_rotate_inverse(phys.base_quat,
                                                     phys.base_lin_vel)
        base_ang_vel = quat_util.quat_rotate_inverse(phys.base_quat,
                                                     phys.base_ang_vel)
        projected_gravity = quat_util.quat_rotate_inverse(
            phys.base_quat, self.g_unit.expand(N, 3))

        # ---- pushes (push_robots :1211-1216) ----
        if cfg.push_robots:
            do_push = self._bernoulli(gen, self.dt / cfg.push_interval_s,
                                      N).float()[:, None]
            dv = self._uniform(gen, (N, 6), -0.5, 0.5)
            phys = dataclasses.replace(
                phys, base_lin_vel=phys.base_lin_vel + dv[:, :3] * do_push,
                base_ang_vel=phys.base_ang_vel + dv[:, 3:] * do_push)
            env = dataclasses.replace(env, phys=phys)

        # ---- fixed-trot gait clock (terrain task, go2_terrain.py:582-611)
        if cfg.use_gait_clocks:
            g_idx, f_idx, clock, _, _, _ = gait.step_gait(
                env.gait_index, self.trot_command.expand(N, -1), self.dt,
                0.07)
            env = dataclasses.replace(env, gait_index=g_idx,
                                      foot_indices=f_idx, clock_inputs=clock)

        # ---- heights / ceilings / flat-terrain flags (:1308-1322) ----
        measured_heights = self._measured_heights(phys.base_pos,
                                                  phys.base_quat)
        ceilings = self._ceilings(env)
        heights_var = torch.var(measured_heights, dim=1, correction=0)
        base_z = phys.base_pos[:, 2]

        # ---- move-up flag (:1325-1327) ----
        dist = torch.linalg.vector_norm(
            phys.base_pos[:, :2] - env.env_origin[:, :2], dim=1)
        env = dataclasses.replace(
            env, move_up_flag=env.move_up_flag
            | (dist > 0.8 * self.track_length))

        # ---- contacts (process_contacts :1187-1209) ----
        contacts_filt = cinfo.foot_forces[..., 2] > 1.0          # (N, 4)
        feet_swing_time = env.feet_swing_time + self.dt
        contacts_touchdown = (env.feet_swing_time > 0) & contacts_filt
        foot_h = cinfo.foot_positions[..., 2] - height_min3(
            self.hf, cinfo.foot_positions[..., :2])
        feet_swing_apex = torch.maximum(env.feet_swing_apex, foot_h)
        feet_clearance = torch.where(contacts_touchdown, feet_swing_apex,
                                     env.feet_clearance)

        # ---- hard terminations (check_termination :489-499) ----
        base_contact = cinfo.base_contact > 1.0
        knee_contact_any = (cinfo.calf_contact > 1.0).any(dim=1)
        timed_out = env.progress >= self.max_episode_length - 1

        # ---- CaT constraint battery (:849-1029) ----
        lim = cfg.limits
        cmd = env.commands
        zero_cmd = (((torch.linalg.vector_norm(cmd[:, :2], dim=1)
                      < cfg.vel_deadzone)
                     & (cmd[:, 2].abs() < cfg.vel_deadzone))
                    | (cmd[:, 0] < cfg.vel_deadzone))
        nz = (~zero_cmd).float()

        yaw = quat_util.quat_yaw(phys.base_quat)
        yaw_cmd = torch.atan2(cmd[:, 1], cmd[:, 0])
        yaw_diff = torch.atan2(torch.sin(yaw - yaw_cmd),
                               torch.cos(yaw - yaw_cmd))
        cstr_heading = (yaw_diff.abs() - lim.heading) * nz

        q, qd = phys.joint_q, phys.joint_qd
        q_hfe, q_kfe = q[:, self.hfe_ix], q[:, self.kfe_ix]
        ff = cinfo.foot_forces
        cstr_upsidedown = (projected_gravity[:, 2] > 0).float()
        cstr_lava = (base_z < -0.05).float()
        cstr_minbaseheight = (lim.min_base_height - base_z) * (
            ceilings >= 0.34).float()
        hard_base_height = cstr_minbaseheight > 0

        calm = (heights_var < cfg.flat_terrain_threshold) & (ceilings >= 0.34)
        is_flat = (calm | (env.terrain_level <= 1)).float()
        flat_style = calm.float()
        n_contacts = contacts_filt.float().sum(dim=1)

        constraints = {
            "heading": sqrt_func(cstr_heading),
            "stumble": sqrt_func(torch.linalg.vector_norm(ff[..., :2], dim=-1)
                                 - 4.0 * ff[..., 2].abs()),
            "dof_pos_lower": model.joint_lower[None, :] - q,
            "dof_pos_upper": q - model.joint_upper[None, :],
            "torque": env.torques.abs() - lim.torque,
            "joint_vel": qd.abs() - lim.vel,
            "action_rate": sqrt_func((env.actions - env.last_actions).abs()
                                     / self.dt - lim.action_rate),
            "knee_contact": sqrt_func(cinfo.calf_contact),
            "base_contact": sqrt_func(cinfo.base_contact),
            "foot_contact": sqrt_func(torch.linalg.vector_norm(ff, dim=-1)
                                      - lim.foot_contact_force),
            "upsidedown": cstr_upsidedown, "lava": cstr_lava,
            "HFE": sqrt_func(q_hfe - lim.HFE),
            "HFE_min": sqrt_func(lim.HFE_min - q_hfe),
            "KFE": sqrt_func(q_kfe),
            "KFE_min": sqrt_func(lim.KFE_min - q_kfe),
            "HAA": sqrt_func((q[:, self.haa_ix]
                              - self.default_joint_q[self.haa_ix]).abs()
                             - lim.HAA),
            "base_ori": sqrt_func((torch.linalg.vector_norm(
                projected_gravity[:, :2], dim=1) - lim.base_orientation)
                * is_flat),
            "air_time": ((cfg.air_time_target - feet_swing_time)
                         * contacts_touchdown.float() * nz[:, None]),
            "no_move": sqrt_func((n_contacts - 4).abs() * zero_cmd.float()
                                 * flat_style),
            "2footcontact": (n_contacts - 2).abs() * nz * flat_style,
        }
        maxp = torch.where(self.hard_cols, 1.0, self.stumble_add + soft_p)

        # a diverged env contributes nothing to the constraint stream: its
        # values would poison the Polyak running maxes for good
        constraints = {n: _where(diverged, 0.0, c)
                       for n, c in constraints.items()}
        cat_state, cstr_prob, viol, cstr_argmax = self.cstr.step(
            world.cat, constraints, maxp)

        # float dones for GAE + hard resets (:1021-1025)
        done_prob = torch.where(diverged, torch.ones_like(cstr_prob),
                                cstr_prob)
        term_contacts = base_contact | (knee_contact_any
                                        & (not cfg.allow_knee_contacts))
        hard_done = (timed_out | (cstr_upsidedown > 0) | (cstr_lava > 0)
                     | term_contacts | hard_base_height | diverged)

        # ---- reward ----
        robot_cmd = self._robot_command(phys.base_quat, cmd)
        lin_err = ((robot_cmd[:, :2] - base_lin_vel[:, :2]) ** 2).sum(dim=1)
        ang_err = (cmd[:, 2] - base_ang_vel[:, 2]) ** 2
        rew_lin = torch.exp(-lin_err / cfg.lin_vel_delta) * cfg.lin_vel_xy_scale
        rew_ang = torch.exp(-ang_err / cfg.ang_vel_delta) * cfg.ang_vel_z_scale
        rew_lin = _where(diverged, 0.0, rew_lin)
        rew_ang = _where(diverged, 0.0, rew_ang)
        if cfg.reward_mode == "full":
            # the full battery of the rough-terrain task without CaT
            # (go2_terrain.py compute_reward :1024-1090); its terms read raw
            # torques and velocities, so a diverged env is masked again
            rew = self._full_rewards(
                env, cinfo, base_lin_vel, base_ang_vel, projected_gravity,
                contacts_touchdown, feet_swing_time, rew_lin, rew_ang)
            rew = _where(diverged, 0.0, rew)
        else:
            # CaT: tracking only (:841-845)
            rew = torch.clamp(rew_lin, min=0.0)

        viol_vec = torch.stack([viol[n] for n in self.cstr_names])
        episode_sums = env.episode_sums + torch.cat(
            [torch.stack([rew_lin, rew_ang], -1),
             viol_vec.expand(N, len(self.cstr_names))], dim=-1)

        # zero swing accumulators on contact AFTER constraint/reward use
        env = dataclasses.replace(
            env, feet_swing_time=feet_swing_time * (~contacts_filt),
            feet_swing_apex=feet_swing_apex * (~contacts_filt),
            feet_clearance=feet_clearance, episode_sums=episode_sums,
            timed_out=timed_out)

        # ---- the observation BEFORE resets, for off-policy bootstrapping
        # (compute_true_next_observations, go2_terrain.py:734-756), with
        # diverged rows zeroed ----
        true_next_obs = None
        if cfg.provide_true_next_obs:
            true_next_obs = _where(diverged, 0.0, self._build_obs(
                env, base_lin_vel, base_ang_vel, projected_gravity,
                measured_heights, ceilings, gen))

        # ---- episode metrics at reset ----
        ep_sums_at_reset = torch.where(hard_done[:, None], episode_sums,
                                       torch.zeros_like(episode_sums)).sum(0)
        ep_len_at_reset = torch.where(hard_done, env.progress,
                                      torch.zeros_like(env.progress)).sum()
        n_reset = hard_done.sum()

        # post-step, PRE-reset distance from the track origin
        dist_pre_reset = torch.linalg.vector_norm(
            env.phys.base_pos[:, :2] - env.env_origin[:, :2], dim=1)
        # per-track-TYPE crossings (>80% of the track at done: the
        # promotion rule, go2_parkour.py:1158-1186) and dones
        n_types = self.terrain_origins.shape[1]
        hard_f = hard_done.float()
        crossings_by_type = torch.zeros(n_types, device=dev).index_add_(
            0, env.terrain_type,
            hard_f * (dist_pre_reset > 0.8 * self.track_length).float())
        dones_by_type = torch.zeros(n_types, device=dev).index_add_(
            0, env.terrain_type, hard_f)

        # ---- masked reset (reset_idx :1035-1124) ----
        spans.phase("env.reset")
        env = self._reset_envs(env, hard_done, gen)

        # ---- stochastic command updates (:1362-1402) ----
        env = self._update_commands(env, gen)

        # ---- observations of the post-reset state ----
        spans.phase("env.observe")
        obs_sample = self._observe(env, gen)
        # refresh history for just-reset envs (compute_observations
        # :601-605; the first step after a global reset too)
        resetted = (env.progress == 0) | first_step
        hist = _where(resetted, obs_sample.repeat(1, self.hist_len),
                      world.hist_obs)
        hist = torch.cat([obs_sample, hist[:, :-self.sample_obs_size]],
                         dim=-1)
        obs = hist[:, self.obs_index]

        env = dataclasses.replace(
            env, last_last_actions=env.last_actions, last_actions=env.actions,
            last_joint_qd=env.phys.joint_qd,
            last_base_lin_vel=env.phys.base_lin_vel)
        info = {
            "true_dones": hard_done,
            "truncateds": timed_out,
            "constraint_violations": viol,
            "terrain_level_mean": env.terrain_level.float().mean(),
            "terrain_level_max": env.terrain_level.max(),
            "episode_sums_at_reset": ep_sums_at_reset,
            "episode_len_at_reset": ep_len_at_reset,
            "num_resets": n_reset,
            "dist_at_done": dist_pre_reset,
            "crossings_by_type": crossings_by_type,
            "dones_by_type": dones_by_type,
            "done_reasons": {
                "timeout": timed_out, "base_contact": base_contact,
                "knee_contact": knee_contact_any,
                "lava": cstr_lava > 0, "upsidedown": cstr_upsidedown > 0,
                "base_height": hard_base_height, "diverged": diverged},
            "cstr_prob": cstr_prob,
            "cstr_argmax_col": cstr_argmax,
        }
        if true_next_obs is not None:
            info["true_next_obs"] = true_next_obs
        return env, cat_state, hist, obs, rew, done_prob, info

    # ------------------------------------------------------------------
    def _full_rewards(self, env, cinfo, blv, bav, pg, contacts_touchdown,
                      feet_swing_time, rew_lin, rew_ang):
        """Rough-terrain reward battery (go2_terrain.py:1024-1090), the
        raibert heuristic (:612-646) included: -> (N,) total clipped at 0."""
        cfg, rs = self.cfg, self.cfg.terrain_rewards
        phys = env.phys
        q, qd = phys.joint_q, phys.joint_qd
        sq = torch.square
        rew = rew_lin + rew_ang
        rew = rew + sq(blv[:, 2]) * rs.lin_vel_z
        rew = rew + sq(bav[:, :2]).sum(-1) * rs.ang_vel_xy
        rew = rew + sq(pg[:, :2]).sum(-1) * rs.orient
        rew = rew + sq(phys.base_pos[:, 2]
                       - cfg.base_height_target) * rs.base_height
        rew = rew + sq(env.torques).sum(-1) * rs.torque
        rew = rew + sq(qd - env.last_joint_qd).sum(-1) * rs.joint_acc
        rew = rew + (cinfo.calf_contact > 1.0).sum(-1) * rs.collision
        stumble = ((torch.linalg.vector_norm(cinfo.foot_forces[..., :2],
                                             dim=-1) > 5.0)
                   & (cinfo.foot_forces[..., 2].abs() < 1.0))
        rew = rew + stumble.sum(-1) * rs.stumble
        rew = rew + (sq(env.actions - env.last_actions)
                     + sq(env.actions - 2 * env.last_actions
                          + env.last_last_actions)).sum(-1) \
            * (cfg.action_scale ** 2) * rs.action_rate
        rew = rew + sq(q - self.default_joint_q[None, :]).sum(-1) * rs.dof_pos
        air = ((feet_swing_time - 0.25) * contacts_touchdown.float()).sum(-1) \
            * rs.air_time
        rew = rew + air * (torch.linalg.vector_norm(env.commands, dim=1)
                           > cfg.vel_deadzone)
        rew = rew + torch.clamp(qd.abs() - 12.0, 0.0, 1.0).sum(-1) \
            * rs.dof_vel_limit
        hip = q[:, self.haa_ix] - self.default_joint_q[self.haa_ix]
        rew = rew + hip.abs().sum(-1) * rs.hip
        if rs.raibert != 0.0:
            rew = rew + self._raibert_error(env, cinfo) * rs.raibert
        return torch.clamp(rew, min=0.0)

    def _raibert_error(self, env, cinfo):
        """Raibert footstep-placement error (go2_terrain.py:612-646): the
        squared distance of the yaw-frame footsteps from the nominal stance
        advanced by the gait phase."""
        phys = env.phys
        N = phys.base_pos.shape[0]
        rel = cinfo.foot_positions - phys.base_pos[:, None, :]    # (N, 4, 3)
        inv_yaw = quat_util.quat_conjugate(quat_util.yaw_quat(phys.base_quat))
        feet_body = quat_util.quat_rotate(inv_yaw[:, None].expand(N, 4, 4),
                                          rel)
        xs_nom, ys_nom = self.raibert_nom
        phases = (1.0 - env.foot_indices * 2.0).abs() - 0.5      # (N, 4)
        freq = 3.0
        x_vel = env.commands[:, 0:1]
        y_vel = env.commands[:, 2:3] * 0.45 / 2
        ys_off = phases * y_vel * (0.5 / freq) * self.raibert_side
        xs_off = phases * x_vel * (0.5 / freq)
        des_x = xs_nom[None, :] + xs_off
        des_y = ys_nom[None, :] + ys_off
        err = (torch.square(des_x - feet_body[..., 0])
               + torch.square(des_y - feet_body[..., 1]))
        return err.sum(dim=1)

    # ------------------------------------------------------------------
    def _update_terrain_level(self, env: ParkourEnvState, mask, gen):
        """update_terrain_level (:1158-1186)."""
        N = mask.shape[0]
        dist = torch.linalg.vector_norm(
            env.phys.base_pos[:, :2] - env.env_origin[:, :2], dim=1)
        move_up = dist > self.track_length * 0.8
        move_down = dist < self.track_length * 0.5
        lvl = env.terrain_level + move_up.long() - move_down.long()
        rand_lvl = draw_rows(lambda s: torch.randint(
            0, self.num_terrain_levels, s, generator=gen,
            device=self.device), (N,), self.group)
        lvl = torch.where(lvl >= self.num_terrain_levels, rand_lvl,
                          torch.clamp(lvl, min=0))
        # 1% teleport back to level 0 when not moving up (:1180)
        back = self._bernoulli(gen, 0.01, N) & ~move_up
        lvl = torch.where(back, torch.zeros_like(lvl), lvl)
        lvl = torch.where(mask, lvl, env.terrain_level)
        return dataclasses.replace(
            env, terrain_level=lvl,
            env_origin=self.terrain_origins[lvl, env.terrain_type],
            move_up_flag=env.move_up_flag & ~mask)

    def restore_terrain_state(self, world: ParkourWorld, terrain_level,
                              terrain_type=None) -> ParkourWorld:
        """Re-seat every env at the given curriculum levels (and optionally
        types) and hard-reset them there (slim-checkpoint resume)."""
        env = world.env
        lvl = torch.as_tensor(terrain_level, dtype=torch.long,
                              device=self.device)
        typ = (env.terrain_type if terrain_type is None
               else torch.as_tensor(terrain_type, dtype=torch.long,
                                    device=self.device))
        env = dataclasses.replace(
            env, terrain_level=lvl, terrain_type=typ,
            env_origin=self.terrain_origins[lvl, typ],
            move_up_flag=torch.zeros_like(env.move_up_flag))
        env = self._reset_envs_at_origin(
            env, torch.ones(lvl.shape[0], dtype=torch.bool,
                            device=self.device), world.gen)
        return dataclasses.replace(world, env=env)

    def _reset_envs(self, env: ParkourEnvState, mask, gen):
        env = self._update_terrain_level(env, mask, gen)
        return self._reset_envs_at_origin(env, mask, gen)

    def _reset_envs_at_origin(self, env: ParkourEnvState, mask, gen):
        N = mask.shape[0]
        new_phys = self._reset_phys(gen, env.env_origin)
        new_dr = self._sample_dr(gen, N)
        new_cmd = self._sample_commands(gen, N)
        phys = PhysicsState(**{
            f: _where(mask, getattr(new_phys, f), getattr(env.phys, f))
            for f in ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel",
                      "joint_q", "joint_qd")})
        z = lambda x: _where(mask, 0.0, x)
        return dataclasses.replace(
            env, phys=phys, progress=z(env.progress),
            commands=_where(mask, new_cmd, env.commands),
            actions=z(env.actions), last_actions=z(env.last_actions),
            last_last_actions=z(env.last_last_actions),
            last_joint_qd=z(env.last_joint_qd), gait_index=z(env.gait_index),
            joint_pos_err_last=z(env.joint_pos_err_last),
            joint_pos_err_last_last=z(env.joint_pos_err_last_last),
            joint_vel_last=z(env.joint_vel_last),
            joint_vel_last_last=z(env.joint_vel_last_last),
            friction=_where(mask, new_dr["friction"], env.friction),
            motor_Fs=_where(mask, new_dr["motor_Fs"], env.motor_Fs),
            motor_mu_v=_where(mask, new_dr["motor_mu_v"], env.motor_mu_v),
            feet_swing_time=z(env.feet_swing_time),
            feet_swing_apex=z(env.feet_swing_apex),
            feet_clearance=z(env.feet_clearance),
            episode_sums=z(env.episode_sums))

    def _update_commands(self, env: ParkourEnvState, gen):
        """Stochastic in-episode command dynamics (:1362-1402)."""
        cfg = self.cfg
        if cfg.only_forwards:
            return env
        N = env.commands.shape[0]
        cmd = env.commands
        # resample with p = 1% (slow command) + 0.2%
        p_res = 0.01 * (torch.linalg.vector_norm(cmd[:, :2], dim=1)
                        < 0.5).float() + 0.002
        do_res = self._rand(gen, (N,)) < p_res
        cmd = _where(do_res, self._sample_commands(gen, N), cmd)
        # ang-vel sign flips with p = dt / episode_length_s
        flip = self._bernoulli(gen, self.dt / cfg.episode_length_s, N)
        wz = cmd[:, 2] * (1.0 - 2.0 * flip.float())
        # lava-avoidance y commands
        y_off = env.phys.base_pos[:, 1] - env.env_origin[:, 1]
        vy = torch.where(y_off < -1.0, cmd[:, 1].abs(), cmd[:, 1])
        vy = torch.where(y_off > 1.0, -vy.abs(), vy)
        cmd = torch.stack([cmd[:, 0], vy, wz], dim=-1)
        # zero-command episodes with p = (1/3) dt / episode_length_s
        zero = self._bernoulli(
            gen, (1.0 / 3.0) * self.dt / cfg.episode_length_s, N)
        return dataclasses.replace(env, commands=_where(zero, 0.0, cmd))

    # ------------------------------------------------------------------
    def _observe(self, env: ParkourEnvState, gen):
        """One observation sample of the current state (compute_observations
        :576-620, heights and ceilings re-read after the reset)."""
        phys = env.phys
        N = phys.base_pos.shape[0]
        rot_inv = lambda v: quat_util.quat_rotate_inverse(phys.base_quat, v)
        return self._build_obs(
            env, rot_inv(phys.base_lin_vel), rot_inv(phys.base_ang_vel),
            rot_inv(self.g_unit.expand(N, 3)),
            self._measured_heights(phys.base_pos, phys.base_quat),
            self._ceilings(env), gen)

    def _build_obs(self, env, base_lin_vel, base_ang_vel, projected_gravity,
                   measured_heights, ceilings, gen):
        cfg = self.cfg
        phys = env.phys
        blocks = []
        if cfg.observe_base_lin_vel:
            blocks.append(base_lin_vel * cfg.lin_vel_scale)
        if cfg.observe_base_ang_vel:
            blocks.append(base_ang_vel * cfg.ang_vel_scale)
        if cfg.observe_commands:
            rc = self._robot_command(phys.base_quat, env.commands)
            blocks.append(rc * self.command_obs_scale)
        if cfg.observe_misc:
            blocks += [projected_gravity, phys.joint_q * cfg.dof_pos_scale,
                       phys.joint_qd * cfg.dof_vel_scale, env.actions]
        if cfg.observe_heights:
            rel = torch.clamp(phys.base_pos[:, 2:3] - cfg.base_height_target
                              - measured_heights, -1.0, 1.0)
            blocks.append(rel * cfg.height_meas_scale)
        if cfg.observe_ceilings:
            blocks.append(ceilings[:, None])
        if cfg.observe_phases:
            ph = (2 * np.pi * cfg.phases_freq
                  * env.progress[:, None].float() * self.dt
                  + self.phase_offsets)
            blocks += [torch.cos(ph), torch.sin(ph)]
        if cfg.observe_imu:
            # base proper acceleration: the finite-difference world
            # acceleration of the base in the body frame (the reference reads
            # a base force sensor, go2_terrain.py:864-868)
            accel_w = (phys.base_lin_vel - env.last_base_lin_vel) / self.dt
            blocks.append(quat_util.quat_rotate_inverse(
                phys.base_quat, accel_w) * cfg.imu_scale)
        if cfg.observe_clock_inputs:
            blocks.append(env.clock_inputs)
        obs = torch.cat(blocks, dim=-1)
        if cfg.add_noise:
            noise = 2 * self._rand(gen, obs.shape) - 1
            obs = obs + noise * self.noise_vec
        return obs

    def get_observations(self, world: ParkourWorld) -> torch.Tensor:
        """Initial observation from the current history buffer."""
        return world.hist_obs[:, self.obs_index]


# ---------------------------------------------------------------------------
# the step over a donated world, replayed as one CUDA graph
# ---------------------------------------------------------------------------

_PHYS_FIELDS = [f.name for f in dataclasses.fields(PhysicsState)]
_ENV_FIELDS = [f.name for f in dataclasses.fields(ParkourEnvState)
               if f.name != "phys"]


def _leaves(world: ParkourWorld) -> list:
    """The world's tensors, in a fixed order: the physics state, the other
    env fields, the CaT running maxima and the observation history."""
    e = world.env
    return ([getattr(e.phys, n) for n in _PHYS_FIELDS]
            + [getattr(e, n) for n in _ENV_FIELDS]
            + [world.cat.running_max, world.hist_obs])


def _copy_all(dsts, srcs):
    """dst.copy_(src) for every pair, as one multi-tensor copy per source
    dtype (a few launches on a CUDA device)."""
    groups = {}
    for d, s in zip(dsts, srcs):
        g = groups.setdefault(s.dtype, ([], []))
        g[0].append(d)
        g[1].append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


class DonatedStep:
    """`ParkourEnv.step` over a donated world, as the JAX runner donates
    its carried state (wtw_tpu/learn/runner.py:62): the world's tensors
    live in one static arena, which is the step's input and its output.

    - The first call runs the functional step (on a CUDA device on a side
      stream, as the warm-up of the capture), makes the arena in the
      layout of its world (`empty_like`), copies that world in, and on a
      CUDA device captures `_arena_step` as one CUDA graph, with the
      world's generator registered with it: a replay draws what the
      functional step draws and advances the generator as far.
    - A later call copies in each incoming world field whose storage is
      not the arena's (the world of `init_state`, a restored checkpoint, a
      caller's `dataclasses.replace`; a comparison of data pointers, no
      device work), and a foreign generator's state; then copies the
      actions in and replays the graph (on the CPU, where the tests hold
      the write-back to the functional step, runs `_arena_step`). The
      spans record counts both (`env_graph_replays`,
      `env_state_copy_ins`).
    - The host keeps `soft_p_progress` and `common_step` exactly as the
      functional step does; the graph reads device mirrors of both, which
      it advances, and which are rewritten from the host only when the
      incoming world's values are not the ones they hold.
    - obs, rew, done_prob and the tensors of info come back fresh: obs
      gathered from the arena's history (as the step gathers it), the
      rest packed into a few static buffers, grouped by how long callers
      keep them, each cloned in one launch a call (`_pack_layout`). The
      world returned is the arena: the next step overwrites it.
    - The hand-written kernels' launches that the capture made are kept
      (`captured`: per kernel its launches and, of kernel B's, those that
      ran the ceiling pass); each replay adds them to the kernels'
      `replayed` counts, not to the launches their wrappers count.

    It holds its env by a weak reference (the env holds it), so that a
    dropped env and its graph are freed at once, by reference counting,
    and never by a collection that may run inside another env's capture.
    """

    def __init__(self, env: "ParkourEnv"):
        self._env = weakref.ref(env)
        self.arena = None           # the world's tensors (`_leaves`)
        self.mirrors = None         # soft_p_progress and common_step
        self.graph = None
        self.captured = []          # (kernel, launches, ceiling launches)

    @property
    def env(self) -> "ParkourEnv":
        return self._env()

    # -- the world over the arena -------------------------------------
    def _world(self, soft_p_progress, common_step) -> ParkourWorld:
        leaves = self.arena
        n = len(_PHYS_FIELDS)
        env = ParkourEnvState(
            phys=PhysicsState(**dict(zip(_PHYS_FIELDS, leaves[:n]))),
            **dict(zip(_ENV_FIELDS, leaves[n:n + len(_ENV_FIELDS)])))
        return ParkourWorld(env=env, cat=CaTState(running_max=leaves[-2]),
                            soft_p_progress=soft_p_progress,
                            hist_obs=leaves[-1], common_step=common_step,
                            gen=self.gen)

    # -- the outputs, packed ------------------------------------------
    def _pack_layout(self, rew, done_prob, info):
        """The step's outputs but obs in static buffers grouped by how long
        callers keep them, so that a kept tensor holds no large clone
        alive: rew and done_prob (kept by a rollout), the pre-reset
        observation, the rest of info. The same tensor in two places of
        info is packed once. (obs is read from the arena's history.)"""
        flat, self.out_tree = tree_flatten((rew, done_prob, info))
        group = {id(rew): 0, id(done_prob): 0,
                 id(info.get("true_next_obs")): 1}
        first, members = {}, [[], [], []]
        for k, t in enumerate(flat):
            if id(t) not in first:
                first[id(t)] = k
                members[group.get(id(t), 2)].append(t)
        members = [m for m in members if m]
        self.packs = [_Packed(m, self.env.device) for m in members]
        slot = {id(t): (i, j) for i, m in enumerate(members)
                for j, t in enumerate(m)}
        self.out_index = [slot[id(t)] for t in flat]
        # flat positions in the packs' order, and the packs' views
        self.pack_order = [first[id(t)] for m in members for t in m]
        self.out_views = [v for p in self.packs for v in p.views]

    def _outputs(self):
        """obs, gathered from the arena's history as the step gathers it,
        and the packed outputs, cloned (one launch a buffer): (obs, rew,
        done_prob, info)."""
        obs = self.arena[-1][:, self.env.obs_index]    # get_observations
        views = [p.unpack(p.buf.clone()) for p in self.packs]
        flat = [views[i][j] for i, j in self.out_index]
        return (obs,) + tree_unflatten(flat, self.out_tree)

    # -- the step --------------------------------------------------------
    def _arena_step(self):
        """One step from the arena into the arena (what the graph holds):
        the step's outputs go into the packed buffer first, then the new
        world and mirrors into the arena, a source that shares storage with
        the arena cloned before any write."""
        env, cfg = self.env, self.env.cfg
        sp, cs = self.mirrors
        sp_new, soft_p = soft_p_mirror(sp, cfg)
        cs_new = cs + 1
        e, cat, hist, obs, rew, done_prob, info = env._step_body(
            self._world(None, None), self.actions, soft_p, cs_new == 1)
        flat, _ = tree_flatten((rew, done_prob, info))
        _copy_all(self.out_views, [flat[k] for k in self.pack_order])
        new = _leaves(ParkourWorld(env=e, cat=cat, soft_p_progress=None,
                                   hist_obs=hist, common_step=None,
                                   gen=None)) + [sp_new, cs_new]
        state = self.arena + self.mirrors
        mine = {a.untyped_storage().data_ptr() for a in state}
        pairs = [(a, t.clone() if t.untyped_storage().data_ptr() in mine
                  else t) for a, t in zip(state, new) if t is not a]
        _copy_all([a for a, _ in pairs], [t for _, t in pairs])

    def _first(self, world, actions):
        """The functional step (the capture's warm-up, on the stream that
        captures), then the arena, the packed outputs and the capture."""
        dev = self.env.device
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        if stream is None:
            out = self.env.functional_step(world, actions)
        else:
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                out = self.env.functional_step(world, actions)
            torch.cuda.current_stream(dev).wait_stream(stream)
        w1, obs, rew, done_prob, info = out
        self.gen = w1.gen
        leaves = _leaves(w1)
        self.arena = [torch.empty_like(t) for t in leaves]
        _copy_all(self.arena, leaves)
        self.mirrors = [
            torch.full((), float(w1.soft_p_progress), device=dev),
            torch.full((), w1.common_step, dtype=torch.long, device=dev)]
        self.actions = torch.empty_like(actions)
        self._pack_layout(rew, done_prob,
                          {k: v for k, v in info.items() if k != "soft_p"})
        if stream is not None:
            self._capture(stream)
        return out

    def _capture(self, stream):
        from ..physics import kernels as K
        before = [(k.launches, k.ceiling_launches) for k in K.KERNELS]
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(self.gen)
        with torch.cuda.graph(self.graph, stream=stream):
            self._arena_step()
        # the capture launched nothing on the device: a replay launches
        # what it recorded
        self.captured = [(k, k.launches - n, k.ceiling_launches - c)
                         for k, (n, c) in zip(K.KERNELS, before)]
        for k, (n, c) in zip(K.KERNELS, before):
            k.launches, k.ceiling_launches = n, c

    def _copy_in(self, world):
        n = 0
        for a, t in zip(self.arena, _leaves(world)):
            if t is not a and t.data_ptr() != a.data_ptr():
                a.copy_(t)
                n += 1
        if world.gen is not self.gen:
            self.gen.set_state(world.gen.get_state())
            n += 1
        if (world.soft_p_progress, world.common_step) != self.expect:
            self.mirrors[0].fill_(float(world.soft_p_progress))
            self.mirrors[1].fill_(int(world.common_step))
            n += 1
        if n:
            spans.count("env_state_copy_ins", n)

    @torch.no_grad()
    def step(self, world: ParkourWorld, actions: torch.Tensor):
        soft_p_progress, soft_p = soft_p_step(world.soft_p_progress,
                                              self.env.cfg)
        common_step = world.common_step + 1
        if self.arena is None:
            _, obs, rew, done_prob, info = self._first(world, actions)
        else:
            self._copy_in(world)
            self.actions.copy_(actions)
            if self.graph is not None:
                graphs.replay(self.graph)
                spans.count("env_graph_replays")
                for k, n, c in self.captured:
                    k.replayed += n
                    k.replayed_ceiling += c
            else:
                self._arena_step()
            obs, rew, done_prob, info = self._outputs()
            info["soft_p"] = soft_p
        self.expect = (soft_p_progress, common_step)
        return (self._world(soft_p_progress, common_step), obs, rew,
                done_prob, info)


class _Packed:
    """Tensors of several dtypes in one static uint8 buffer: a region a
    dtype (16-byte aligned), each tensor a view of its region."""

    def __init__(self, ts, device):
        sizes, at = {}, []
        for t in ts:
            at.append(sizes.get(t.dtype, 0))
            sizes[t.dtype] = at[-1] + t.numel()
        self.regions, nbytes = [], 0
        for dt, n in sizes.items():
            size = dt.itemsize * n
            self.regions.append((dt, nbytes, nbytes + size))
            nbytes += -(-size // 16) * 16
        region = {dt: i for i, (dt, _, _) in enumerate(self.regions)}
        self.slots = [(region[t.dtype], o, t.numel(), t.shape)
                      for t, o in zip(ts, at)]
        self.buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
        self.views = self.unpack(self.buf)

    def unpack(self, buf) -> list:
        """The tensors' views of `buf` (this buffer or a clone of it)."""
        typed = [buf[a:b].view(dt) for dt, a, b in self.regions]
        return [typed[r][o:o + n].view(shape)
                for r, o, n, shape in self.slots]
