"""What the check iterations record of the program, on the host: every
env step's actions and outputs (the reference's learner follows them), the
world before and after a few env steps (drawn from the seed, and the first
reset with the step after it; the env step is then checked by itself),
and the optimizer's first step."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def to_host(x):
    """A deep host copy of a world, an obs dict or a tensor: dataclasses
    become {"__class__": name, field: ...}, a generator its state."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, torch.Generator):
        return {"__generator__": x.get_state(), "device": str(x.device)}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        out = {"__class__": type(x).__name__}
        for f in dataclasses.fields(x):
            out[f.name] = to_host(getattr(x, f.name))
        return out
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_host(v) for v in x)
    if isinstance(x, np.ndarray):
        return x.copy()
    return x


def tree_fields(prefix: str, x) -> dict:
    """Every tensor, array and number of a host record (`to_host`) under a
    dotted name, a generator's state included: what the env check
    compares of a world."""
    if isinstance(x, torch.Tensor):
        return {prefix: x}
    if isinstance(x, (np.ndarray, np.generic, bool, int, float)):
        return {prefix: torch.as_tensor(np.asarray(x))}
    if isinstance(x, dict):
        if "__generator__" in x:
            return {prefix: x["__generator__"]}
        return {k: v for key, val in x.items() if key != "__class__"
                for k, v in tree_fields(f"{prefix}.{key}", val).items()}
    if isinstance(x, (tuple, list)):
        return {k: v for i, val in enumerate(x)
                for k, v in tree_fields(f"{prefix}.{i}", val).items()}
    return {}


def world_fields(world) -> dict:
    """What the env check compares of a world (`tree_fields`): the physics
    state, and every integer and boolean field (levels, flags, counters,
    the generator's state). The other float fields (commands, DR draws,
    torques, swing and air times, episode sums) enter the observations,
    rewards and physics that are compared; alone, a foot test decided the
    other way by rounding moves one of them by a few percent."""
    return {k: v for k, v in tree_fields("world", world).items()
            if ".phys." in k or not v.is_floating_point()}


class StepRecorder:
    """Wraps `env.step` on the instance while the check iterations run.
    `keep(world, obs, rew, done, info)` picks what the reference reads of
    each step; the steps numbered in `snapshot_at` (counted over the check
    iterations) also keep the world before and after, and so do the first
    step in which an env resets (`resets(kept)` any) and the step after
    it, so that the reset and curriculum paths are checked too."""

    def __init__(self, env, keep, resets, snapshot_at):
        self.env, self.keep = env, keep
        self.snapshot_at = set(snapshot_at)
        self.steps, self.snapshots = [], []
        self.reset_at = None
        self._orig = env.step

        def step(world, actions):
            t = len(self.steps)
            after_reset = self.reset_at is not None and t == self.reset_at + 1
            before = (to_host(world) if t in self.snapshot_at or after_reset
                      or self.reset_at is None else None)
            out = self._orig(world, actions)
            kept = to_host(self.keep(*out))
            self.steps.append({"actions": to_host(actions), **kept})
            if self.reset_at is None and bool(resets(kept).any()):
                self.reset_at = t
            if t in self.snapshot_at or after_reset or self.reset_at == t:
                self.snapshots.append({"t": t, "before": before,
                                       "actions": to_host(actions),
                                       "after": to_host(out)})
            return out
        env.step = step

    def close(self):
        del self.env.step
        self.env = None


class StepTrail:
    """The parameters after each optimizer step, on the host: what the
    look at a swinging number follows minibatch by minibatch
    (`calibrate.py --follow`; never in a benchmark run)."""

    def __init__(self, opt, named_params):
        self.params = []
        named = list(named_params)

        def hook(optimizer, args, kwargs):
            self.params.append({n: p.detach().to("cpu", copy=True)
                                for n, p in named})
        self._handle = opt.register_step_post_hook(hook)

    def close(self):
        self._handle.remove()


class FirstStep:
    """The optimizer's state after its first step: each leaf's first
    moment over (1 - beta1), the gradient the step was given."""

    BETA1 = 0.9     # torch.optim.Adam's default, which the learners use

    def __init__(self, opt, named_params):
        self.grads = None
        self._names = {id(p): n for n, p in named_params}

        def hook(optimizer, args, kwargs):
            if self.grads is None:
                self.grads = {
                    self._names[id(p)]: optimizer.state[p]["exp_avg"]
                    .detach().to("cpu", copy=True) / (1 - self.BETA1)
                    for g in optimizer.param_groups for p in g["params"]
                    if p in optimizer.state}
        self._handle = opt.register_step_post_hook(hook)

    def close(self):
        self._handle.remove()
