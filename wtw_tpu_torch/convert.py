"""Carry weights and env state across from the JAX package.

The helpers take the JAX objects with their array leaves already turned
into numpy (e.g. `jax.tree.map(np.asarray, tree)`); they read them by
attribute or key only, so this module imports nothing of JAX or wtw_tpu.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .envs.constraints import CaTState
from .envs.legged_env import EnvState, WorldState
from .envs.parkour_env import ParkourEnvState, ParkourWorld
from .physics import PhysicsState

_NETS = ("adaptation", "actor", "critic")


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX actor-critic parameter tree {'adaptation'|'actor'|'critic':
    [{'w': (in, out), 'b': (out,)}, ...], 'std': (A,)} -> a state_dict for
    `models.actor_critic.ActorCritic` (Linear weights are (out, in); the
    i-th Linear of a net sits at Sequential index 2 i)."""
    sd = _mlp_from_jax(tree, _NETS)
    sd["std"] = _f32(tree["std"])
    return sd


def _tensor(x, dev, dtype=None):
    a = np.array(x)
    if dtype is None:
        dtype = {np.dtype(np.bool_): torch.bool,
                 np.dtype(np.int32): torch.int32}.get(a.dtype, torch.float32)
    return torch.from_numpy(a).to(device=dev, dtype=dtype)


def _phys(p, dev) -> PhysicsState:
    return PhysicsState(**{f: _tensor(getattr(p, f), dev) for f in (
        "base_pos", "base_quat", "base_lin_vel", "base_ang_vel", "joint_q",
        "joint_qd")})


def _generator(dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return gen


def world_from_jax(world, device="cpu", seed: int = 0) -> WorldState:
    """JAX `WorldState` (numpy leaves) -> the port's WorldState: every env
    field, the gait clock and the actuator-net history included, the
    curriculum weights, the observation history, the gravity offset and the
    step counter. The JAX per-env RNG keys have no counterpart; the port's
    generator is seeded with `seed`."""
    dev = torch.device(device)
    t = lambda x, dtype=None: _tensor(x, dev, dtype)
    e = world.env
    phys = _phys(e.phys, dev)
    names = [f for f in EnvState.__dataclass_fields__ if f != "phys"]
    fields = {}
    for f in names:
        if f in ("env_bin", "env_category"):
            fields[f] = t(getattr(e, f), torch.long)
        else:
            fields[f] = t(getattr(e, f))
    return WorldState(env=EnvState(phys=phys, **fields),
                      curriculum_weights=t(world.curriculum.weights),
                      obs_history=t(world.obs_history),
                      gravity_offset=t(world.gravity_offset),
                      common_step=int(np.asarray(world.common_step)),
                      gen=_generator(dev, seed))


def actuator_state_from_jax(ws, device="cpu"):
    """JAX `ActuatorModelState` (numpy leaves) -> the port's."""
    from .envs.wrappers import ActuatorModelState
    dev = torch.device(device)
    return ActuatorModelState(action_buffer=_tensor(ws.action_buffer, dev),
                              prev_actions=_tensor(ws.prev_actions, dev))


def actuator_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX actuator-net parameters {'w0': (6, 32), 'b0': (32,), ...}
    (numpy leaves, as `wtw_tpu.models.actuator_net.load_actuator_net` gives
    them) -> the port's, for `models.actuator_net.apply_actuator_net`
    (the same keys and (in, out) layout, as float32 CPU tensors)."""
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in params.items()}


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _mlp_from_jax(tree, nets) -> Dict[str, torch.Tensor]:
    """[{'w': (in, out), 'b': (out,)}, ...] per net -> the entries of an
    nn.Sequential(Linear, act, ...) (weights (out, in), the i-th Linear at
    index 2 i)."""
    sd = {}
    for net in nets:
        for i, layer in enumerate(tree[net]):
            sd[f"{net}.{2 * i}.weight"] = _f32(np.asarray(layer["w"]).T)
            sd[f"{net}.{2 * i}.bias"] = _f32(layer["b"])
    return sd


def cat_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX CaT agent parameters {'critic'|'actor_mean': [{'w': (in, out),
    'b': (out,)}, ...], 'actor_logstd': (A,)} -> a state_dict for
    `learn.cat_ppo.CatAgent`."""
    sd = _mlp_from_jax(tree, ("critic", "actor_mean"))
    sd["actor_logstd"] = _f32(tree["actor_logstd"])
    return sd


def plus_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX PPO+ agent parameters (the CaT agent's and 'q_net') -> a
    state_dict for `learn.cat_ppo_plus.PlusAgent`."""
    return {**cat_params_from_jax(tree), **_mlp_from_jax(tree, ("q_net",))}


def rnn_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX PPO-RNN agent parameters (the CaT heads and the GRU memories
    {'w_ih': (in, 3H), 'w_hh': (H, 3H), 'b_ih', 'b_hh': (3H,)}) -> a
    state_dict for `learn.cat_ppornn.RNNAgent` (nn.GRUCell keeps the
    weights (3H, in), the gates in the same r, z, n order)."""
    sd = cat_params_from_jax(tree)
    for net in ("actor_memory", "critic_memory"):
        g = tree[net]
        sd[f"{net}.weight_ih"] = _f32(np.asarray(g["w_ih"]).T)
        sd[f"{net}.weight_hh"] = _f32(np.asarray(g["w_hh"]).T)
        sd[f"{net}.bias_ih"] = _f32(g["b_ih"])
        sd[f"{net}.bias_hh"] = _f32(g["b_hh"])
    return sd


def rma_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX RMA parameters {'encoder'|'adaptation'|'actor'|'critic': [...],
    'std': (A,)} -> a state_dict for `learn.ppo_rma.RMAModel`."""
    sd = _mlp_from_jax(tree, ("encoder", "adaptation", "actor", "critic"))
    sd["std"] = _f32(tree["std"])
    return sd


def parkour_world_from_jax(world, device="cpu", seed: int = 0) -> ParkourWorld:
    """JAX `ParkourWorld` (numpy leaves) -> the port's ParkourWorld: every
    env field (the gait clock, the actuator-net history, the previous
    actions, joint velocities and base velocity included), the CaT running
    maxima, the float32 soft-p progress, the observation history and the
    step counter. The JAX per-env RNG keys have no counterpart; the port's
    generator is seeded with `seed`."""
    dev = torch.device(device)
    e = world.env
    fields = {}
    for f in ParkourEnvState.__dataclass_fields__:
        if f == "phys":
            continue
        dtype = torch.long if f in ("terrain_level", "terrain_type") else None
        fields[f] = _tensor(getattr(e, f), dev, dtype)
    return ParkourWorld(
        env=ParkourEnvState(phys=_phys(e.phys, dev), **fields),
        cat=CaTState(running_max=_tensor(world.cat.running_max, dev)),
        soft_p_progress=np.float32(np.asarray(world.soft_p_progress)),
        hist_obs=_tensor(world.hist_obs, dev),
        common_step=int(np.asarray(world.common_step)),
        gen=_generator(dev, seed))


def _vision_from_jax(v) -> Dict[str, torch.Tensor]:
    """Conv weights HWIO -> OIHW; `l1`/`l2` (in, out) -> (out, in), `l1`'s
    1568 inputs kept in the JAX net's H, W, C order (`VisionNet` flattens
    its conv output in that order)."""
    sd = {}
    for c in ("c1", "c2", "c3"):
        sd[f"{c}.weight"] = _f32(np.transpose(np.asarray(v[c]["w"]),
                                              (3, 2, 0, 1)))
        sd[f"{c}.bias"] = _f32(v[c]["b"])
    for lyr in ("l1", "l2"):
        sd[f"{lyr}.weight"] = _f32(np.asarray(v[lyr]["w"]).T)
        sd[f"{lyr}.bias"] = _f32(v[lyr]["b"])
    return sd


def _student_actor_from_jax(a) -> Dict[str, torch.Tensor]:
    g = a["memory"]
    sd = {"memory.weight_ih": _f32(np.asarray(g["w_ih"]).T),
          "memory.weight_hh": _f32(np.asarray(g["w_hh"]).T),
          "memory.bias_ih": _f32(g["b_ih"]), "memory.bias_hh": _f32(g["b_hh"])}
    sd.update(_mlp_from_jax({"head": a["head"]}, ("head",)))
    return sd


def vision_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The JAX vision student {'actor': {'memory': GRU, 'head': [...]},
    'vision': {'c1'..'c3', 'l1', 'l2'}} (numpy leaves, as
    `vision_student.pkl` holds it) -> a state_dict for
    `learn.ddpg_demos.Student`."""
    sd = {f"vision.{k}": v for k, v in _vision_from_jax(tree["vision"]).items()}
    sd.update({f"actor.{k}": v
               for k, v in _student_actor_from_jax(tree["actor"]).items()})
    return sd


def q_ensemble_from_jax(qs) -> Dict[str, torch.Tensor]:
    """The JAX critics, a list of layers whose leaves carry a leading critic
    axis ({'w': (C, in, out), 'b', 'ln_g', 'ln_b': (C, out)}, no LayerNorm
    on the last) -> a state_dict for `learn.ddpg_demos.QEnsemble`."""
    sd = {}
    for i, lyr in enumerate(qs):
        for k in ("w", "b", "ln_g", "ln_b"):
            if lyr.get(k) is not None:
                sd[f"{k}{i}"] = _f32(lyr[k])
    return sd


def ddpg_state_from_jax(ts, learner, seed: int = 0) -> dict:
    """A JAX `DDPGTrainState` (numpy leaves) -> the `state()` dict of the
    port's `learn.ddpg_demos.DDPGLearner`, for its `load_state`: the student,
    the critics and their targets, both optimizers' Adam moments and step
    counts (`(actor, vision)` and the critics), and the actor-update count.
    The JAX key has no counterpart: the learner's draws are reseeded from
    `seed`."""
    from .learn import jax_checkpoint as J
    student = lambda t: vision_params_from_jax({"actor": t[0],
                                                "vision": t[1]})
    gen = torch.Generator(device=learner.device)
    gen.manual_seed(int(seed))
    dev = learner.device
    on = lambda sd: {k: v.to(dev) for k, v in sd.items()}
    return {
        "student": on(vision_params_from_jax({"actor": ts.actor,
                                              "vision": ts.vision})),
        "qs": on(q_ensemble_from_jax(ts.qs)),
        "q_targets": on(q_ensemble_from_jax(ts.q_targets)),
        "actor_opt": J.optimizer_state(learner.actor_opt, learner.student,
                                       J.adam_state(ts.actor_opt), student),
        "q_opt": J.optimizer_state(learner.q_opt, learner.qs,
                                   J.adam_state(ts.q_opt),
                                   q_ensemble_from_jax),
        "step": int(np.asarray(ts.step)), "gen_state": gen.get_state()}
