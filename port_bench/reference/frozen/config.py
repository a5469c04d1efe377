"""Typed, frozen configuration tree (the port's own copy of
`wtw_tpu/config.py`, kept field-for-field identical so both packages read
the same presets; the port imports nothing of `wtw_tpu`).

Replaces the reference's two config systems (SURVEY.md §5.6):
- params_proto `Cfg` singleton mutated by per-robot functions and ~190 inline
  overrides per train script (go1_gym/envs/base/legged_robot_config.py:6-421,
  scripts/go1/train.py:21-205),
- Hydra yaml for the Stack-B tasks (cfg/).

Here a config is a plain frozen dataclass tree, constructed by preset
functions (`go1_flat_config`, `go1_mob_config`, ...) and then frozen before
jit. Every field maps to a reference field; citations inline.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple


def _f(x):
    return field(default_factory=lambda: x)


@dataclass(frozen=True)
class EnvCfg:
    # legged_robot_config.py:7-62
    num_envs: int = 4096
    # trailing eval envs (reference: eval_cfg appended after train envs,
    # base_task.py:43-46): excluded from PPO updates, logged as eval/episode
    # metrics, optionally teacher-driven (ppo_cse/__init__.py:140-145)
    num_eval_envs: int = 0
    num_observations: int = 42
    num_privileged_obs: int = 2
    num_actions: int = 12
    num_observation_history: int = 30
    episode_length_s: float = 20.0
    observe_vel: bool = False
    observe_only_ang_vel: bool = False
    observe_only_lin_vel: bool = False
    observe_yaw: bool = False
    observe_contact_states: bool = False
    observe_command: bool = True
    observe_gait_commands: bool = False
    observe_timing_parameter: bool = False
    observe_clock_inputs: bool = False
    observe_two_prev_actions: bool = False
    # privileged obs flags (:39-62)
    priv_observe_friction: bool = True
    priv_observe_restitution: bool = True
    priv_observe_base_mass: bool = False
    priv_observe_com_displacement: bool = False
    priv_observe_motor_strength: bool = False
    priv_observe_motor_offset: bool = False
    priv_observe_Kp_factor: bool = False
    priv_observe_Kd_factor: bool = False
    priv_observe_body_velocity: bool = False
    priv_observe_body_height: bool = False
    priv_observe_gravity: bool = False
    priv_observe_clock_inputs: bool = False
    priv_observe_desired_contact_states: bool = False


@dataclass(frozen=True)
class TerrainCfg:
    # legged_robot_config.py:64-102
    mesh_type: str = "heightfield"   # 'plane' | 'heightfield'
    horizontal_scale: float = 0.10
    vertical_scale: float = 0.005
    border_size: float = 0.0
    curriculum: bool = False
    static_friction: float = 1.0
    dynamic_friction: float = 1.0
    restitution: float = 0.0
    terrain_noise_magnitude: float = 0.1
    terrain_smoothness: float = 0.005
    measure_heights: bool = False
    measured_points_x: Tuple[float, ...] = tuple(
        [-0.8, -0.7, -0.6, -0.5, -0.4, -0.3, -0.2, -0.1, 0.0,
         0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8])
    measured_points_y: Tuple[float, ...] = tuple(
        [-0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5])
    min_init_terrain_level: int = 0
    max_init_terrain_level: int = 5
    terrain_length: float = 5.0
    terrain_width: float = 5.0
    num_rows: int = 30   # levels
    num_cols: int = 30   # types
    # proportions over terrain generators (go1_gym/utils/terrain.py:114-159):
    # [smooth_slope, rough_slope, stairs_up, stairs_down, discrete, stepping
    #  stones, gap, pit, flat]
    terrain_proportions: Tuple[float, ...] = (0, 0, 0, 0, 0, 0, 0, 0, 1.0)
    slope_treshold: float = 0.75
    difficulty_scale: float = 1.0
    x_init_range: float = 0.2
    y_init_range: float = 0.2
    yaw_init_range: float = 3.14
    x_init_offset: float = 0.0
    y_init_offset: float = 0.0
    teleport_robots: bool = False
    teleport_thresh: float = 0.3
    center_robots: bool = True
    center_span: int = 4


@dataclass(frozen=True)
class CommandsCfg:
    # legged_robot_config.py:104-193 with scripts/go1/train.py:153-196 values
    command_curriculum: bool = True
    num_commands: int = 15
    resampling_time: float = 10.0
    heading_command: bool = False
    curriculum_seed: int = 100
    # sampled ranges (initial curriculum support)
    lin_vel_x: Tuple[float, float] = (-1.0, 1.0)
    lin_vel_y: Tuple[float, float] = (-0.6, 0.6)
    ang_vel_yaw: Tuple[float, float] = (-1.0, 1.0)
    body_height_cmd: Tuple[float, float] = (-0.25, 0.15)
    gait_frequency_cmd_range: Tuple[float, float] = (2.0, 4.0)
    gait_phase_cmd_range: Tuple[float, float] = (0.0, 1.0)
    gait_offset_cmd_range: Tuple[float, float] = (0.0, 1.0)
    gait_bound_cmd_range: Tuple[float, float] = (0.0, 1.0)
    gait_duration_cmd_range: Tuple[float, float] = (0.5, 0.5)
    footswing_height_range: Tuple[float, float] = (0.03, 0.35)
    body_pitch_range: Tuple[float, float] = (-0.4, 0.4)
    body_roll_range: Tuple[float, float] = (0.0, 0.0)
    stance_width_range: Tuple[float, float] = (0.10, 0.45)
    stance_length_range: Tuple[float, float] = (0.35, 0.45)
    aux_reward_coef_range: Tuple[float, float] = (0.0, 0.01)
    # curriculum grid limits
    limit_vel_x: Tuple[float, float] = (-5.0, 5.0)
    limit_vel_y: Tuple[float, float] = (-0.6, 0.6)
    limit_vel_yaw: Tuple[float, float] = (-5.0, 5.0)
    limit_body_height: Tuple[float, float] = (-0.25, 0.15)
    limit_gait_frequency: Tuple[float, float] = (2.0, 4.0)
    limit_gait_phase: Tuple[float, float] = (0.0, 1.0)
    limit_gait_offset: Tuple[float, float] = (0.0, 1.0)
    limit_gait_bound: Tuple[float, float] = (0.0, 1.0)
    limit_gait_duration: Tuple[float, float] = (0.5, 0.5)
    limit_footswing_height: Tuple[float, float] = (0.03, 0.35)
    limit_body_pitch: Tuple[float, float] = (-0.4, 0.4)
    limit_body_roll: Tuple[float, float] = (0.0, 0.0)
    limit_stance_width: Tuple[float, float] = (0.10, 0.45)
    limit_stance_length: Tuple[float, float] = (0.35, 0.45)
    limit_aux_reward_coef: Tuple[float, float] = (0.0, 0.01)
    # grid resolution (scripts/go1/train.py:183-196)
    num_bins_vel_x: int = 21
    num_bins_vel_y: int = 1
    num_bins_vel_yaw: int = 21
    num_bins_body_height: int = 1
    num_bins_gait_frequency: int = 1
    num_bins_gait_phase: int = 1
    num_bins_gait_offset: int = 1
    num_bins_gait_bound: int = 1
    num_bins_gait_duration: int = 1
    num_bins_footswing_height: int = 1
    num_bins_body_pitch: int = 1
    num_bins_body_roll: int = 1
    num_bins_stance_width: int = 1
    num_bins_stance_length: int = 1
    num_bins_aux_reward_coef: int = 1
    # gait category logic (legged_robot.py:763-817)
    exclusive_phase_offset: bool = False
    binary_phases: bool = True
    pacing_offset: bool = False
    balance_gait_distribution: bool = True
    gaitwise_curricula: bool = True
    vel_deadband: float = 0.2   # :820 small commands zeroed


@dataclass(frozen=True)
class CurriculumThresholds:
    # legged_robot_config.py:195-199, overridden scripts/go1/train.py:23-26
    tracking_lin_vel: float = 0.8
    tracking_ang_vel: float = 0.7
    tracking_contacts_shaped_force: float = 0.9
    tracking_contacts_shaped_vel: float = 0.9


@dataclass(frozen=True)
class InitStateCfg:
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.34)
    default_joint_angles: Tuple[Tuple[str, float], ...] = ()


@dataclass(frozen=True)
class ControlCfg:
    # legged_robot_config.py:209-218, go1_config.py:29-37
    control_type: str = "P"   # 'P' | 'actuator_net'
    stiffness: float = 20.0
    damping: float = 0.5
    action_scale: float = 0.25
    hip_scale_reduction: float = 0.5
    decimation: int = 4
    # reuse the policy-step-start terrain corner rows across the decimation
    # substeps (NOT in the reference — a TPU optimization: the per-substep
    # heightfield gather was ~14% of device step time; spheres move ~5 mm
    # per substep vs ≥0.1 m terrain cells, and bilinear patches are C0-
    # continuous across cell edges, so the extrapolation error when a
    # sphere crosses a cell mid-step is ≪1 cm of height). Only affects
    # non-flat terrain with the batched engine; False restores the exact
    # per-substep gather.
    hf_substep_cache: bool = True


@dataclass(frozen=True)
class DomainRandCfg:
    # legged_robot_config.py:243-270, scripts/go1/train.py:30-76
    rand_interval_s: float = 4.0
    randomize_rigids_after_start: bool = False
    randomize_friction: bool = True
    friction_range: Tuple[float, float] = (0.1, 3.0)
    randomize_restitution: bool = True
    restitution_range: Tuple[float, float] = (0.0, 0.4)
    randomize_base_mass: bool = True
    added_mass_range: Tuple[float, float] = (-1.0, 3.0)
    randomize_com_displacement: bool = False
    com_displacement_range: Tuple[float, float] = (-0.1, 0.1)
    randomize_motor_strength: bool = True
    motor_strength_range: Tuple[float, float] = (0.9, 1.1)
    randomize_motor_offset: bool = True
    motor_offset_range: Tuple[float, float] = (-0.02, 0.02)
    randomize_Kp_factor: bool = False
    Kp_factor_range: Tuple[float, float] = (0.8, 1.3)
    randomize_Kd_factor: bool = False
    Kd_factor_range: Tuple[float, float] = (0.5, 1.5)
    gravity_rand_interval_s: float = 8.0
    gravity_impulse_duration: float = 0.99
    randomize_gravity: bool = True
    gravity_range: Tuple[float, float] = (-1.0, 1.0)
    push_robots: bool = False
    push_interval_s: float = 15.0
    max_push_vel_xy: float = 0.5
    randomize_lag_timesteps: bool = True
    lag_timesteps: int = 6


@dataclass(frozen=True)
class RewardsCfg:
    # legged_robot_config.py:272-295, scripts/go1/train.py:109-149
    only_positive_rewards: bool = False
    only_positive_rewards_ji22_style: bool = True
    sigma_rew_neg: float = 0.02
    # Annealed penalty sharpness (NOT in the reference; deliberate
    # stabilizer): when sigma_rew_neg_init is set, the ji22 exp sigma
    # anneals linearly from it to sigma_rew_neg over
    # sigma_rew_neg_anneal_steps policy steps. At the reference's fixed
    # sigma=0.02 the early MoB rewards are ~1e-7/step (pos*exp(neg/0.02)
    # with neg ~ -0.3) — below PPO's signal-to-noise threshold here; the
    # policy degenerates to instant falls. With sigma 0.25 the identical
    # recipe trains stably (tracking reward rises, near-full episodes);
    # annealing recovers the reference's final objective.
    sigma_rew_neg_init: Optional[float] = None
    # Anneal horizon ~ the reference's full training scale (100k iterations
    # x 24 steps): sharpening faster than the policy improves re-enters the
    # degenerate near-zero-reward regime (measured: at 10k-iteration anneal
    # the run degrades once sigma < ~0.08).
    sigma_rew_neg_anneal_steps: int = 2_400_000
    tracking_sigma: float = 0.25
    tracking_sigma_yaw: float = 0.25
    soft_dof_pos_limit: float = 0.9
    soft_dof_vel_limit: float = 1.0
    soft_torque_limit: float = 1.0
    base_height_target: float = 0.30
    max_contact_force: float = 100.0
    use_terminal_body_height: bool = True
    terminal_body_height: float = 0.05
    use_terminal_foot_height: bool = False
    terminal_foot_height: float = -0.005
    use_terminal_roll_pitch: bool = True
    terminal_body_ori: float = 1.6
    kappa_gait_probs: float = 0.07
    gait_force_sigma: float = 100.0
    gait_vel_sigma: float = 10.0
    footswing_height: float = 0.09


@dataclass(frozen=True)
class RewardScalesCfg:
    # legged_robot_config.py:297-332 with go1_config.py:52-57 and
    # scripts/go1/train.py:117-144 (the MoB recipe)
    termination: float = 0.0
    tracking_lin_vel: float = 1.0
    tracking_ang_vel: float = 0.5
    lin_vel_z: float = -0.02
    ang_vel_xy: float = -0.001
    orientation: float = 0.0
    orientation_control: float = -5.0
    torques: float = -0.0001
    dof_vel: float = -1e-4
    dof_acc: float = -2.5e-7
    dof_pos: float = 0.0
    base_height: float = 0.0
    feet_air_time: float = 0.0
    collision: float = -5.0
    action_rate: float = -0.01
    jump: float = 10.0
    tracking_contacts_shaped_force: float = 4.0
    tracking_contacts_shaped_vel: float = 4.0
    dof_pos_limits: float = -10.0
    feet_contact_forces: float = 0.0
    feet_slip: float = -0.04
    feet_clearance_cmd_linear: float = -30.0
    feet_impact_vel: float = 0.0
    feet_contact_vel: float = 0.0
    action_smoothness_1: float = -0.1
    action_smoothness_2: float = -0.1
    raibert_heuristic: float = -10.0

    def items(self):
        return dataclasses.asdict(self).items()


@dataclass(frozen=True)
class NormalizationCfg:
    # legged_robot_config.py:334-354
    clip_observations: float = 100.0
    clip_actions: float = 10.0
    friction_range: Tuple[float, float] = (0.0, 1.0)
    restitution_range: Tuple[float, float] = (0.0, 1.0)
    added_mass_range: Tuple[float, float] = (-1.0, 3.0)
    com_displacement_range: Tuple[float, float] = (-0.1, 0.1)
    motor_strength_range: Tuple[float, float] = (0.9, 1.1)
    motor_offset_range: Tuple[float, float] = (-0.05, 0.05)
    Kp_factor_range: Tuple[float, float] = (0.8, 1.3)
    Kd_factor_range: Tuple[float, float] = (0.5, 1.5)
    body_velocity_range: Tuple[float, float] = (-6.0, 6.0)
    body_height_range: Tuple[float, float] = (0.0, 0.60)
    gravity_range: Tuple[float, float] = (-1.0, 1.0)


@dataclass(frozen=True)
class ObsScalesCfg:
    # legged_robot_config.py:356-376
    lin_vel: float = 2.0
    ang_vel: float = 0.25
    dof_pos: float = 1.0
    dof_vel: float = 0.05
    imu: float = 0.1
    height_measurements: float = 5.0
    body_height_cmd: float = 2.0
    gait_phase_cmd: float = 1.0
    gait_freq_cmd: float = 1.0
    footswing_height_cmd: float = 0.15
    body_pitch_cmd: float = 0.3
    body_roll_cmd: float = 0.3
    aux_reward_cmd: float = 1.0
    compliance_cmd: float = 1.0
    stance_width_cmd: float = 1.0
    stance_length_cmd: float = 1.0


@dataclass(frozen=True)
class NoiseCfg:
    add_noise: bool = True
    noise_level: float = 1.0
    # noise_scales (legged_robot_config.py:382-394)
    dof_pos: float = 0.01
    dof_vel: float = 1.5
    lin_vel: float = 0.1
    ang_vel: float = 0.2
    gravity: float = 0.05
    contact_states: float = 0.05
    height_measurements: float = 0.1


@dataclass(frozen=True)
class SimCfg:
    dt: float = 0.005
    substeps: int = 1
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    # penalty-contact engine knobs (replaces the physx block :410-421)
    contact_stiffness: float = 10_000.0
    contact_damping: float = 300.0
    friction_vel_eps: float = 0.05
    armature: float = 0.01
    max_depenetration_velocity: float = 1.0


@dataclass(frozen=True)
class AssetCfg:
    robot: str = "go1"
    foot_radius_offset: float = 0.02   # foot sphere radius for clearance reward


@dataclass(frozen=True)
class Cfg:
    env: EnvCfg = _f(EnvCfg())
    terrain: TerrainCfg = _f(TerrainCfg())
    commands: CommandsCfg = _f(CommandsCfg())
    curriculum_thresholds: CurriculumThresholds = _f(CurriculumThresholds())
    init_state: InitStateCfg = _f(InitStateCfg())
    control: ControlCfg = _f(ControlCfg())
    asset: AssetCfg = _f(AssetCfg())
    domain_rand: DomainRandCfg = _f(DomainRandCfg())
    rewards: RewardsCfg = _f(RewardsCfg())
    reward_scales: RewardScalesCfg = _f(RewardScalesCfg())
    normalization: NormalizationCfg = _f(NormalizationCfg())
    obs_scales: ObsScalesCfg = _f(ObsScalesCfg())
    noise: NoiseCfg = _f(NoiseCfg())
    sim: SimCfg = _f(SimCfg())

    @property
    def dt(self) -> float:
        """Policy dt = decimation × sim dt (reference _parse_cfg :1717)."""
        return self.control.decimation * self.sim.dt

    @property
    def max_episode_length(self) -> int:
        import math
        return int(math.ceil(self.env.episode_length_s / self.dt))


GO1_DEFAULT_JOINT_ANGLES = (
    ("FL_hip_joint", 0.1), ("RL_hip_joint", 0.1), ("FR_hip_joint", -0.1),
    ("RR_hip_joint", -0.1), ("FL_thigh_joint", 0.8), ("RL_thigh_joint", 1.0),
    ("FR_thigh_joint", 0.8), ("RR_thigh_joint", 1.0), ("FL_calf_joint", -1.5),
    ("RL_calf_joint", -1.5), ("FR_calf_joint", -1.5), ("RR_calf_joint", -1.5),
)  # go1_config.py:12-27


def go1_flat_config(num_envs: int = 16) -> Cfg:
    """Minimal Go1 flat-ground velocity tracking (BASELINE config #1; analog
    of scripts/go1/test.py). 3-command space, no gait conditioning."""
    return Cfg(
        env=EnvCfg(num_envs=num_envs, num_observations=42,
                   num_privileged_obs=2, num_observation_history=15,
                   observe_clock_inputs=False, observe_two_prev_actions=False),
        commands=CommandsCfg(
            num_commands=3, command_curriculum=False,
            num_bins_vel_x=30, num_bins_vel_yaw=30,
            limit_vel_x=(-1.0, 1.0), limit_vel_y=(-0.6, 0.6),
            limit_vel_yaw=(-1.0, 1.0), gaitwise_curricula=False,
            binary_phases=False),
        init_state=InitStateCfg(default_joint_angles=GO1_DEFAULT_JOINT_ANGLES),
        terrain=TerrainCfg(mesh_type="plane"),
        domain_rand=DomainRandCfg(
            randomize_gravity=False, randomize_motor_offset=False,
            randomize_lag_timesteps=False, randomize_base_mass=True,
            friction_range=(0.05, 4.5), restitution_range=(0.0, 1.0)),
        rewards=RewardsCfg(only_positive_rewards=True,
                           only_positive_rewards_ji22_style=False,
                           use_terminal_body_height=False,
                           use_terminal_roll_pitch=False,
                           base_height_target=0.34),
        reward_scales=RewardScalesCfg(
            # go1_config.py:52-57 (plain velocity-tracking recipe)
            tracking_lin_vel=1.0, tracking_ang_vel=0.5, lin_vel_z=-2.0,
            ang_vel_xy=-0.05, torques=-0.0001, dof_acc=-2.5e-7,
            # go1_config.py sets feet_air_time=1.0 / base_height=-30.0 but
            # CoRLRewards implements neither, so the reference silently drops
            # them (legged_robot.py:1408-1409); we zero them for parity.
            feet_air_time=0.0, collision=-1.0, action_rate=-0.01,
            dof_pos_limits=-10.0, orientation=-5.0, base_height=0.0,
            orientation_control=0.0, raibert_heuristic=0.0, jump=0.0,
            tracking_contacts_shaped_force=0.0,
            tracking_contacts_shaped_vel=0.0,
            feet_slip=0.0, action_smoothness_1=0.0, action_smoothness_2=0.0,
            dof_vel=0.0, feet_clearance_cmd_linear=0.0),
        normalization=NormalizationCfg(clip_actions=100.0,
                                       friction_range=(0.05, 4.5)),
    )


B1_DEFAULT_JOINT_ANGLES = (
    # b1_gym/envs/b1/b1_config.py:29-42
    ("FL_hip_joint", 0.2), ("RL_hip_joint", 0.2), ("FR_hip_joint", -0.2),
    ("RR_hip_joint", -0.2), ("FL_thigh_joint", 0.8), ("RL_thigh_joint", 1.0),
    ("FR_thigh_joint", 0.8), ("RR_thigh_joint", 1.0), ("FL_calf_joint", -1.5),
    ("RL_calf_joint", -1.6), ("FR_calf_joint", -1.5), ("RR_calf_joint", -1.6),
)


def go2_flat_config(num_envs: int = 16) -> Cfg:
    """Go2 flat-ground velocity tracking. Identical recipe to Go1
    (go2_gym/envs/go2/go2_config.py differs from go1_config only in asset
    path, head-contact terminations, and the actuator net)."""
    cfg = go1_flat_config(num_envs)
    return replace(cfg, asset=AssetCfg(robot="go2"))


def go2_mob_config(num_envs: int = 4000) -> Cfg:
    """Go2 gait-conditioned MoB (scripts/go2/train.py recipe)."""
    cfg = go1_mob_config(num_envs)
    return replace(cfg, asset=AssetCfg(robot="go2"))


def b1_flat_config(num_envs: int = 16) -> Cfg:
    """B1 velocity tracking — the heavy 50 kg quadruped. Scale constants
    from b1_gym/envs/b1/b1_config.py: init z 0.8, kp 100 / kd 2.5,
    base_height_target 0.55, torque penalty /8; terminal_body_height 0.55
    and max_contact_force 300 from b1_gym legged_robot_config.py:287-290."""
    cfg = go1_flat_config(num_envs)
    return replace(
        cfg,
        asset=AssetCfg(robot="b1"),
        init_state=InitStateCfg(pos=(0.0, 0.0, 0.8),
                                default_joint_angles=B1_DEFAULT_JOINT_ANGLES),
        control=replace(cfg.control, stiffness=100.0, damping=2.5),
        rewards=replace(cfg.rewards, base_height_target=0.55,
                        terminal_body_height=0.55, max_contact_force=300.0),
        reward_scales=replace(cfg.reward_scales, torques=-0.0001 / 8),
    )


def b1_mob_config(num_envs: int = 4096) -> Cfg:
    """B1 gait-conditioned MoB (scripts/b1/train.py recipe: the Go1 MoB
    config with B1 scale constants; deploys via checkpoints/B1)."""
    cfg = go1_mob_config(num_envs)
    flat = b1_flat_config()
    return replace(
        cfg,
        asset=AssetCfg(robot="b1"),
        init_state=flat.init_state,
        control=replace(cfg.control, control_type="P",
                        stiffness=100.0, damping=2.5),
        rewards=replace(cfg.rewards, base_height_target=0.55,
                        terminal_body_height=0.55, max_contact_force=300.0),
        reward_scales=replace(cfg.reward_scales, torques=-0.0001 / 8),
    )


def mini_cheetah_flat_config(num_envs: int = 16) -> Cfg:
    """MIT mini-cheetah asset (resources/robots/mini_cheetah/urdf) with the
    Go1 flat recipe — the reference ships the URDF with no config."""
    cfg = go1_flat_config(num_envs)
    return replace(cfg, asset=AssetCfg(robot="mini_cheetah"),
                   init_state=replace(cfg.init_state, pos=(0.0, 0.0, 0.30)))


PRESETS = {}  # name -> Cfg factory; filled below


def go1_mob_config(num_envs: int = 4000) -> Cfg:
    """The flagship gait-conditioned MoB recipe (scripts/go1/train.py:21-205):
    15 commands, 70 obs, clock inputs, gait curricula, actuator net."""
    return Cfg(
        env=EnvCfg(num_envs=num_envs, num_observations=70,
                   num_privileged_obs=2, num_observation_history=30,
                   observe_gait_commands=True, observe_clock_inputs=True,
                   observe_two_prev_actions=True),
        commands=CommandsCfg(),
        init_state=InitStateCfg(default_joint_angles=GO1_DEFAULT_JOINT_ANGLES),
        control=ControlCfg(control_type="actuator_net"),
        terrain=TerrainCfg(),
        domain_rand=DomainRandCfg(),
        rewards=RewardsCfg(sigma_rew_neg_init=0.25),
        reward_scales=RewardScalesCfg(),
        normalization=NormalizationCfg(),
    )


PRESETS.update({
    # the analog of the reference's per-robot train scripts
    # (scripts/{go1,go2,b1}/train.py)
    "go1_flat": go1_flat_config,
    "go1_mob": go1_mob_config,
    "go2_flat": go2_flat_config,
    "go2_mob": go2_mob_config,
    "b1_flat": b1_flat_config,
    "b1_mob": b1_mob_config,
    "mini_cheetah_flat": mini_cheetah_flat_config,
})


def apply_overrides(obj, overrides):
    """Generic `section.field=value` CLI overrides on the nested frozen
    config tree — the analog of the reference's Hydra override syntax
    (cfg/config.yaml:61-65, used by scripts/ppo_gridsearch.slurm:13-27).

    Values are parsed with the existing field's type (bool accepts
    true/false/1/0; tuples accept comma-separated items). Returns a new
    config; raises KeyError on unknown paths so typos fail loudly."""
    import dataclasses as _dc

    def set_path(node, path, raw):
        name = path[0]
        if not hasattr(node, name):
            raise KeyError(
                f"no config field '{name}' on {type(node).__name__}")
        cur = getattr(node, name)
        if len(path) > 1:
            return _dc.replace(node, **{name: set_path(cur, path[1:], raw)})
        return _dc.replace(node, **{name: _coerce(cur, raw)})

    def _coerce(cur, raw):
        if raw.lower() in ("none", "null"):
            # disable Optional features (e.g. rewards.sigma_rew_neg_init=none
            # turns the anneal stabilizer off; ppo.std_range=none drops the
            # policy-std clamp — the reference-exact hyperparameters)
            return None
        if isinstance(cur, bool):
            return raw.lower() in ("1", "true", "yes", "on")
        if isinstance(cur, int) and not isinstance(cur, bool):
            return int(raw)
        if isinstance(cur, float):
            return float(raw)
        if isinstance(cur, (tuple, list)):
            parts = [p for p in raw.split(",") if p != ""]
            elem = cur[0] if len(cur) else 0.0
            return type(cur)(_coerce(elem, p) for p in parts)
        if cur is None:
            try:
                return float(raw)
            except ValueError:
                return raw
        return raw

    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' must be section.field=value")
        path, raw = ov.split("=", 1)
        obj = set_path(obj, path.split("."), raw)
    return obj
