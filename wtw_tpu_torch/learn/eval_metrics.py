"""Policy-quality evaluation: metric functions and canned DR sweeps (port of
`wtw_tpu/learn/eval_metrics.py`; reference
go1_gym_learn/eval_metrics/{metrics,domain_randomization}.py).

- METRICS_FNS: per-step (N,) metric tensors from the world: velocity
  tracking RMSE, raw velocities, base height, max torque, power, the Froude
  number (metrics.py:9-99); `make_cot` gives the cost of transport;
- DR sweep presets mutating a Cfg: rand_regular, rand_large,
  static_{low,medium,high}, only_base_mass (domain_randomization.py:4-148),
  and `base_set`, the eval world;
- evaluate_policy / gait_stats: roll a policy and return the metrics' means
  or the realized gait. The rollouts keep their traces on the device and
  read them back once at the end, as the jitted JAX loop does;
- classify_contacts / obedience_stats: numpy estimators on those traces.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from ..config import Cfg
from ..utils import quat as quat_util

G = 9.8


def _base_vels(world):
    phys = world.env.phys
    blv = quat_util.quat_rotate_inverse(phys.base_quat, phys.base_lin_vel)
    bav = quat_util.quat_rotate_inverse(phys.base_quat, phys.base_ang_vel)
    return blv, bav


def lin_vel_rmsd(world):
    blv, _ = _base_vels(world)
    return torch.sqrt((blv[:, 0] - world.env.commands[:, 0]) ** 2)


def ang_vel_rmsd(world):
    _, bav = _base_vels(world)
    return torch.sqrt((bav[:, 2] - world.env.commands[:, 2]) ** 2)


def lin_vel_x(world):
    return _base_vels(world)[0][:, 0]


def ang_vel_yaw(world):
    return _base_vels(world)[1][:, 2]


def base_height(world):
    return world.env.phys.base_pos[:, 2]


def max_torques(world):
    return torch.amax(torch.abs(world.env.torques), dim=1)


def power_consumption(world):
    return torch.sum(world.env.torques * world.env.phys.joint_qd, dim=1)


def make_cot(total_mass: float):
    """Cost of transport P / (m g v) (metrics.py:40-48)."""

    def CoT(world):
        P = power_consumption(world)
        blv, _ = _base_vels(world)
        v = torch.linalg.vector_norm(blv[:, :2], dim=1)
        m = total_mass + world.env.payload
        return P / torch.clamp(m * G * v, min=1e-6)

    return CoT


def froude_number(world, h: float = 0.30):
    v = lin_vel_x(world)
    return v ** 2 / (G * h)


METRICS_FNS: Dict[str, Callable] = {
    "lin_vel_rmsd": lin_vel_rmsd, "ang_vel_rmsd": ang_vel_rmsd,
    "lin_vel_x": lin_vel_x, "ang_vel_yaw": ang_vel_yaw,
    "base_height": base_height, "max_torques": max_torques,
    "power_consumption": power_consumption, "froude_number": froude_number,
}


# ----------------------------------------------------------------------
# DR sweep presets (domain_randomization.py:16-148) as pure Cfg -> Cfg
# ----------------------------------------------------------------------
def _dr(cfg: Cfg, **kw) -> Cfg:
    return dataclasses.replace(
        cfg, domain_rand=dataclasses.replace(cfg.domain_rand, **kw))


def base_set(cfg: Cfg) -> Cfg:
    """Eval world setup (:4-14): huge episodes, frozen commands."""
    return dataclasses.replace(
        cfg,
        commands=dataclasses.replace(cfg.commands, resampling_time=1e9,
                                     command_curriculum=False),
        env=dataclasses.replace(cfg.env, episode_length_s=500.0),
        rewards=dataclasses.replace(cfg.rewards, terminal_body_height=0.0,
                                    use_terminal_body_height=True))


def rand_regular(cfg: Cfg) -> Cfg:
    return _dr(cfg, randomize_friction=True, friction_range=(0.05, 4.5),
               randomize_restitution=True, restitution_range=(0.0, 1.0),
               randomize_base_mass=True, added_mass_range=(-1.0, 3.0),
               randomize_com_displacement=True,
               com_displacement_range=(-0.1, 0.1),
               randomize_motor_strength=True,
               motor_strength_range=(0.9, 1.1), push_robots=False)


def rand_large(cfg: Cfg) -> Cfg:
    return _dr(cfg, randomize_friction=True, friction_range=(0.04, 6.0),
               randomize_restitution=True, restitution_range=(0.0, 1.0),
               randomize_base_mass=True, added_mass_range=(-1.5, 4.0),
               randomize_com_displacement=True,
               com_displacement_range=(-0.13, 0.13),
               randomize_motor_strength=True,
               motor_strength_range=(0.88, 1.12), push_robots=False)


def static_low(cfg: Cfg) -> Cfg:
    return _dr(cfg, randomize_friction=True, friction_range=(0.05, 0.06),
               randomize_restitution=False, randomize_base_mass=False,
               randomize_com_displacement=False,
               randomize_motor_strength=False, push_robots=False)


def static_medium(cfg: Cfg) -> Cfg:
    return _dr(cfg, randomize_friction=True, friction_range=(1.0, 1.01),
               randomize_restitution=False, randomize_base_mass=False,
               randomize_com_displacement=False,
               randomize_motor_strength=False, push_robots=False)


def static_high(cfg: Cfg) -> Cfg:
    return _dr(cfg, randomize_friction=True, friction_range=(4.0, 4.01),
               randomize_restitution=False, randomize_base_mass=False,
               randomize_com_displacement=False,
               randomize_motor_strength=False, push_robots=False)


def only_base_mass(cfg: Cfg) -> Cfg:
    return _dr(cfg, randomize_friction=False, randomize_restitution=False,
               randomize_base_mass=True, added_mass_range=(-1.0, 3.0),
               randomize_com_displacement=False,
               randomize_motor_strength=False, push_robots=False)


DR_SWEEPS = {
    "rand_regular": rand_regular, "rand_large": rand_large,
    "static_low": static_low, "static_medium": static_medium,
    "static_high": static_high, "only_base_mass": only_base_mass,
}


# ----------------------------------------------------------------------
def pin_commands(world, cmds):
    """The world with every env's command set to `cmds` (N, nc)."""
    return dataclasses.replace(world, env=dataclasses.replace(
        world.env, commands=cmds))


def start(env, seed: int = 0, commands=None):
    """(world, obs, pinned commands or None) of a fresh eval rollout: the
    env's initial state from `seed`, every env's command set to `commands`
    where given."""
    world = env.init_state(seed)
    cmds = None
    if commands is not None:
        cmds = torch.as_tensor(np.asarray(commands, np.float32),
                               device=env.device).expand_as(
                                   world.env.commands).contiguous()
        world = pin_commands(world, cmds)
    world, obs = env.get_observations(world)
    return world, obs, cmds


@torch.no_grad()
def rollout(env, policy_fn, steps: int, seed: int, commands, record):
    """Roll `policy_fn(obs_dict) -> actions` for `steps` from a fresh
    world, re-pinning `commands` after every step (the eval command holds
    through resamples and resets, as play.py overwrites env.commands each
    step, :120-131). `record(world, rew)` -> {name: tensor} is taken after
    each step and stacked on the device: -> {name: (steps, ...)}."""
    world, obs, cmds = start(env, seed, commands)
    traces = {}
    for _ in range(steps):
        world, obs, rew, done, info = env.step(world, policy_fn(obs))
        if cmds is not None:
            world = pin_commands(world, cmds)
        for k, v in record(world, rew).items():
            traces.setdefault(k, []).append(v)
    return {k: torch.stack(v) for k, v in traces.items()}


def _record_state(world, rew):
    """What the metrics read from a step's world, by reference: the env's
    step makes new tensors, so recording launches nothing."""
    e, p = world.env, world.env.phys
    return {"base_pos": p.base_pos, "base_quat": p.base_quat,
            "base_lin_vel": p.base_lin_vel, "base_ang_vel": p.base_ang_vel,
            "joint_qd": p.joint_qd, "commands": e.commands,
            "torques": e.torques, "payload": e.payload, "rew": rew}


def state_metrics(tr, names, total_mass=None):
    """{name: (T, N)} of the metrics `names` (METRICS_FNS keys, "CoT")
    over the stacked per-step states of `_record_state`, computed once over
    the T x N rows (each metric is per env, so the values are the per-step
    ones)."""
    from types import SimpleNamespace
    T, N = tr["base_pos"].shape[:2]
    flat = {k: v.reshape((T * N,) + v.shape[2:]) for k, v in tr.items()}
    phys = SimpleNamespace(**{k: flat[k] for k in (
        "base_pos", "base_quat", "base_lin_vel", "base_ang_vel",
        "joint_qd")})
    world = SimpleNamespace(env=SimpleNamespace(
        phys=phys, commands=flat["commands"], torques=flat["torques"],
        payload=flat["payload"]))
    fns = {**METRICS_FNS, "CoT": make_cot(total_mass or 0.0)}
    return {k: fns[k](world).reshape(T, N) for k in names}


def evaluate_policy(env, policy_fn, steps: int = 250, seed: int = 0,
                    commands=None):
    """Roll `policy_fn(obs_dict) -> actions` for `steps` and return
    ({metric: mean}, {metric: (steps, N) trace}). The analog of
    scripts/go1/play.py's eval loop (:101-157)."""
    tr = rollout(env, policy_fn, steps, seed, commands, _record_state)
    traces = state_metrics(tr, list(METRICS_FNS) + ["CoT"],
                           float(env.model.mass.sum()))
    names = list(traces) + ["mean_reward"]
    # one read-back for every mean
    means = torch.stack([traces[k].mean() for k in traces]
                        + [tr["rew"].mean()]).tolist()
    return dict(zip(names, means)), traces


def gait_stats(env, policy_fn, steps: int = 400, seed: int = 0,
               commands=None):
    """The realized gait: per-foot contact duty factor, stride frequency
    (from contact onsets) and the phase correlations of `classify_contacts`
    (the quantitative analog of the reference's play.py contact plots,
    scripts/go1/play.py:139-157)."""
    tr = rollout(env, policy_fn, steps, seed, commands,
                 lambda world, rew: {"c": world.env.last_contacts})
    out = classify_contacts(tr["c"].cpu().numpy(), env.dt)
    # kept for round-1/2 table continuity: front/hind-pair correlation
    out["lateral_corr"] = out["pair_corr"]
    return out


def classify_contacts(c, dt):
    """Gait signature of a (T, N, 4) foot-contact sequence (foot order
    FR FL RR RL): duty factor, stride frequency from contact onsets, and
    three phase-correlation axes that classify the four MoB gaits
    (phases 0.5/0/0 = trot, 0/0.5/0 = pace, 0/0/0.5 = bound, 0/0/0 = pronk):
      trot:  diag +, pair -, side -      pace:  diag -, pair -, side +
      bound: diag -, pair +, side -      pronk: diag +, pair +, side +
    dominant_gait = nearest sign template to the measured axes."""
    c = np.asarray(c, np.float32)
    duty = c.mean(axis=0).mean(axis=0)            # (4,)
    # stride frequency from contact onsets of foot 0, averaged over envs
    onsets = np.diff(c[:, :, 0], axis=0) > 0
    freq = onsets.sum(axis=0) / (c.shape[0] * dt)

    def _corr(a, b):
        a = a - a.mean(axis=0, keepdims=True)
        b = b - b.mean(axis=0, keepdims=True)
        denom = np.sqrt((a * a).sum(axis=0) * (b * b).sum(axis=0)) + 1e-8
        return ((a * b).sum(axis=0) / denom).mean()

    diag = (_corr(c[:, :, 0], c[:, :, 3]) + _corr(c[:, :, 1], c[:, :, 2])) / 2
    pair = (_corr(c[:, :, 0], c[:, :, 1]) + _corr(c[:, :, 2], c[:, :, 3])) / 2
    side = (_corr(c[:, :, 0], c[:, :, 2]) + _corr(c[:, :, 1], c[:, :, 3])) / 2
    sig = {"trot": diag - pair - side, "pace": side - diag - pair,
           "bound": pair - diag - side, "pronk": diag + pair + side}
    return {
        "duty_factor": duty.tolist(),
        "stride_freq_hz": float(freq.mean()),
        "diag_corr": float(diag),
        "pair_corr": float(pair),
        "side_corr": float(side),
        "dominant_gait": max(sig, key=lambda k: float(sig[k])),
    }


def obedience_stats(tr, skip=50):
    """Realized command-obedience estimators from per-step traces.

    tr: dict of (T, N, ...) arrays: base_z/roll/pitch/vx/vy/wz (T, N),
    foot_z (T, N, 4) world foot heights, foot_xy (T, N, 4, 2) yaw-frame
    foot positions relative to the base (the raibert frame,
    corl_rewards.py:161-202), contact (T, N, 4) bool.

    - stance_width = 2 x the mean over contact samples of |foot y|;
    - stance_length = mean front-foot x - mean rear-foot x over contact
      samples;
    - foot_apex = the mean over swing segments of the max world foot z (an
      obedient apex is the command + 0.02, corl_rewards.py:127-146).
    """
    c = np.asarray(tr["contact"][skip:]).astype(bool)   # (T, N, 4)
    fz = np.asarray(tr["foot_z"][skip:])
    fxy = np.asarray(tr["foot_xy"][skip:])
    out = {k: float(np.mean(np.asarray(tr[k][skip:])))
           for k in ("base_z", "roll", "pitch", "vx", "vy", "wz")}
    cw = np.where(c, 1.0, np.nan)
    x_mean = np.nanmean(fxy[..., 0] * cw, axis=(0, 1))
    y_mean = np.nanmean(np.abs(fxy[..., 1]) * cw, axis=(0, 1))
    out["stance_width"] = float(2 * np.mean(y_mean))
    out["stance_length"] = float(np.mean(x_mean[:2]) - np.mean(x_mean[2:]))
    apexes = []
    for n in range(fz.shape[1]):
        for f in range(4):
            z, inc = fz[:, n, f], c[:, n, f]
            seg_max, in_swing = -1.0, False
            for t in range(len(z)):
                if not inc[t]:
                    seg_max = z[t] if not in_swing else max(seg_max, z[t])
                    in_swing = True
                elif in_swing:
                    apexes.append(seg_max)
                    in_swing = False
    out["foot_apex"] = float(np.mean(apexes)) if apexes else 0.0
    return out
