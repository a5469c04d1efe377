"""Env wrappers (port of `wtw_tpu/envs/wrappers.py`).

ActuatorModelWrapper — the JAX package's redesign of
go2_gym/envs/wrappers/actuator_model_wrapper.py:9-127: it simulates real
Go2-actuator latency effects outside the physics, on the action stream
before the env:

1. action delay: a fractional number of policy steps, interpolated with a
   Catmull-Rom cubic over the last 4 buffered actions (the reference
   interpolates a wall-clock buffer with a natural cubic spline);
2. stiction + viscous friction on the action signal:
   a -= Fs·tanh(qd/T) + mu_v·qd (compute_friction :105-112);
3. a first-order low-pass filter: a' = α·a + (1-α)·a_prev (apply_LPF
   :101-103).

The wrapper's state is carried beside the env's: its `init_state` and
`step` take and return `(world, ActuatorModelState)`.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ActuatorModelArgs:
    # reference defaults (actuator_model_wrapper.py:10)
    delay_steps: float = 1.0     # `delay` (in policy steps here)
    alpha: float = 0.9           # LPF coefficient
    mu_v: float = 0.1            # viscous friction
    Fs: float = 0.3              # stiction strength
    temperature: float = 0.1     # friction tanh temperature
    buffer_len: int = 4          # Catmull-Rom support


@dataclasses.dataclass
class ActuatorModelState:
    action_buffer: torch.Tensor  # (N, buffer_len, nj), newest last
    prev_actions: torch.Tensor   # (N, nj) previous filtered output


class ActuatorModelWrapper:
    """Wraps a LeggedEnv; the same step signature over (world, wrapper
    state). Every other attribute (num_obs, cfg, device, ...) is the
    env's."""

    def __init__(self, env, args: ActuatorModelArgs = ActuatorModelArgs()):
        self.env = env
        self.args = args

    def __getattr__(self, name):
        return getattr(self.env, name)

    def init_wrapper_state(self) -> ActuatorModelState:
        N, nj, dev = self.env.num_envs, self.env.num_actions, self.env.device
        return ActuatorModelState(
            action_buffer=torch.zeros(N, self.args.buffer_len, nj,
                                      device=dev),
            prev_actions=torch.zeros(N, nj, device=dev))

    def init_state(self, seed: int = 0):
        return self.env.init_state(seed), self.init_wrapper_state()

    def get_observations(self, state):
        world, ws = state
        world, obs = self.env.get_observations(world)
        return (world, ws), obs

    def _delayed(self, buf: torch.Tensor) -> torch.Tensor:
        """Catmull-Rom evaluation of the action signal at
        (newest - delay_steps). buf: (N, L, nj), L >= 4."""
        a = self.args
        L = buf.shape[1]
        # continuous index of the target sample; the newest is L - 1
        t = min(max(L - 1 - a.delay_steps, 1.0), L - 1.001)
        i1 = int(math.floor(t))
        u = t - i1
        p0, p1 = buf[:, i1 - 1], buf[:, i1]
        p2, p3 = buf[:, i1 + 1], buf[:, min(i1 + 2, L - 1)]
        return 0.5 * ((2 * p1) + (-p0 + p2) * u
                      + (2 * p0 - 5 * p1 + 4 * p2 - p3) * u ** 2
                      + (-p0 + 3 * p1 - 3 * p2 + p3) * u ** 3)

    def step(self, state, actions: torch.Tensor):
        """(world, wrapper state), actions -> the env step's 5-tuple, with
        the world as (world, wrapper state)."""
        world, ws = state
        a = self.args
        buf = torch.cat([ws.action_buffer[:, 1:], actions[:, None, :]], dim=1)
        delayed = self._delayed(buf)
        qd = world.env.phys.joint_qd                       # (N, nj)
        friction = a.Fs * torch.tanh(qd / a.temperature) + a.mu_v * qd
        filtered = (a.alpha * (delayed - friction)
                    + (1 - a.alpha) * ws.prev_actions)
        ws = ActuatorModelState(action_buffer=buf, prev_actions=filtered)
        world, obs, rew, done, info = self.env.step(world, filtered)
        return (world, ws), obs, rew, done, info
