"""Read the JAX package's checkpoints (`state_<tag>.pkl`, and the slim
`.pkl.gz` files of `tools/slim_checkpoint.py`) without JAX: the load half
of `wtw_tpu/learn/runner.py:240-270` and `scripts/train_parkour.py:151-183`.

The files are pickles of flax dataclasses, optax states, numpy arrays and
the `Cfg` tree. `JaxUnpickler` reads them with a restricted `find_class`:

- numpy's array, dtype and scalar reconstructors (the `numpy._core` and
  `numpy.core` spellings both, so a file written with numpy 2 reads under
  numpy 1);
- the learner, curriculum, CaT and world dataclasses of the JAX package
  and the vision pipeline's `SeqBuffer`,
  and optax's `ScaleByAdamState` and `EmptyState`, as plain records
  (`Record`: the fields as attributes; the optax states as named tuples);
- `ml_dtypes.bfloat16` (the dtype of the vision demo buffer's wide fields)
  as `numpy.uint16`: the raw 16-bit words, which `bf16_tensor` turns into
  a torch bfloat16 tensor with the same bits, so no `ml_dtypes` is needed;
- `wtw_tpu.config.*` as the port's own `config` classes, field by field: a
  field an older file lacks takes its default, a field the port does not
  know raises `UnpicklingError` naming it;
- every other global raises `UnpicklingError` naming it.

`learner_state` then maps a JAX train state onto the `state()` layout of
the port's learners: weights through `convert.py`, optax's Adam state
(`count`, `mu`, `nu`) onto `torch.optim.Adam`'s `step`, `exp_avg` and
`exp_avg_sq` with the same (in, out) -> (out, in) transpose as the weights.
The JAX PRNG key has no torch counterpart: the learner's generator is
reseeded from the caller's seed.

Imports nothing of jax, flax, optax, ml_dtypes or wtw_tpu.
"""
from __future__ import annotations

import dataclasses
import gzip
import pickle
from collections import namedtuple
from typing import Any, Dict

import numpy as np
import torch

from .. import config as C
from .. import convert

# numpy's pickle reconstructors, in both module spellings
_NUMPY = {(mod, name) for mod in ("numpy._core.multiarray",
                                  "numpy.core.multiarray")
          for name in ("_reconstruct", "scalar")} | {
    ("numpy", "ndarray"), ("numpy", "dtype")} | {
    (mod, "_frombuffer") for mod in ("numpy._core.numeric",
                                     "numpy.core.numeric")}

# the JAX package's dataclasses that checkpoints hold; each reads as a Record
_RECORDS = {
    ("wtw_tpu.learn.ppo_cse", "TrainState"),
    ("wtw_tpu.learn.cat_ppo", "CatTrainState"),
    ("wtw_tpu.learn.cat_ppo", "RMSState"),
    ("wtw_tpu.learn.cat_ppo_plus", "PlusTrainState"),
    ("wtw_tpu.learn.cat_ppornn", "RNNTrainState"),
    ("wtw_tpu.envs.curriculum", "CurriculumState"),
    ("wtw_tpu.envs.constraints", "CaTState"),
    # the world of a full (non-slim) file
    ("wtw_tpu.envs.legged_env", "WorldState"),
    ("wtw_tpu.envs.legged_env", "EnvState"),
    ("wtw_tpu.envs.parkour_env", "ParkourWorld"),
    ("wtw_tpu.envs.parkour_env", "ParkourEnvState"),
    ("wtw_tpu.envs.wrappers", "ActuatorModelState"),
    ("wtw_tpu.physics.state", "PhysicsState"),
    # the vision pipeline's demo buffer (`rb_demos.pkl`)
    ("wtw_tpu.learn.ddpg_demos", "SeqBuffer"),
}
# bfloat16 arrays (ml_dtypes, which JAX brings) read as their raw 16-bit
# words, uint16: `bf16_tensor` reinterprets them
_BF16 = ("ml_dtypes", "bfloat16")

ScaleByAdamState = namedtuple("ScaleByAdamState", ["count", "mu", "nu"])
EmptyState = namedtuple("EmptyState", [])
_OPTAX = {("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
          ("optax._src.base", "EmptyState"): EmptyState}


class Record:
    """A JAX dataclass read from a checkpoint: its fields as attributes;
    `jax_class` is the JAX package's `module.Name`."""

    jax_class = ""

    def __setstate__(self, state):
        self.__dict__.update(state)


_record_classes: Dict[tuple, type] = {}


def _record_class(module: str, name: str) -> type:
    key = (module, name)
    if key not in _record_classes:
        _record_classes[key] = type(name, (Record,),
                                    {"jax_class": f"{module}.{name}"})
    return _record_classes[key]


def _defaults(cls) -> Dict[str, Any]:
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = f.default_factory()
    return out


def _config_class(name: str) -> type:
    """`wtw_tpu.config.<name>` -> a loader class that becomes the port's
    `config.<name>` once the file's fields are set."""
    target = getattr(C, name, None)
    if not (isinstance(target, type) and dataclasses.is_dataclass(target)):
        raise pickle.UnpicklingError(
            f"wtw_tpu.config.{name}: the port has no such config class")

    def __setstate__(self, state):
        known = {f.name for f in dataclasses.fields(target)}
        unknown = sorted(set(state) - known)
        if unknown:
            raise pickle.UnpicklingError(
                f"wtw_tpu.config.{name}: the port's {name} has no field "
                f"{', '.join(unknown)}")
        # frozen dataclass: set the fields the way unpickling does
        self.__dict__.update({**_defaults(target), **state})
        self.__class__ = target

    return type(f"_Loading{name}", (target,), {"__setstate__": __setstate__})


class JaxUnpickler(pickle.Unpickler):
    """Unpickler of the JAX package's checkpoints (see the module doc)."""

    def find_class(self, module, name):
        if (module, name) in _NUMPY:
            return super().find_class(module, name)
        if (module, name) in _RECORDS:
            return _record_class(module, name)
        if (module, name) in _OPTAX:
            return _OPTAX[module, name]
        if (module, name) == _BF16:
            return np.uint16
        if module == "wtw_tpu.config":
            return _config_class(name)
        raise pickle.UnpicklingError(
            f"{module}.{name}: not a class a JAX checkpoint may hold")


def is_jax_checkpoint(path: str) -> bool:
    return str(path).endswith((".pkl", ".pkl.gz"))


def load(path: str) -> dict:
    """The blob of a JAX checkpoint (`.pkl` or `.pkl.gz`), arrays as numpy,
    dataclasses as `Record`s, `cfg` (where the file has one) as the port's
    `Cfg`."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        return JaxUnpickler(f).load()


def bf16_tensor(a) -> torch.Tensor:
    """A bfloat16 array as `load` reads it (its raw words, uint16) -> a
    torch bfloat16 tensor with the same bits; any other array as it is."""
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def load_seq_buffer(path: str):
    """The JAX package's `rb_demos.pkl` (a pickled
    `wtw_tpu.learn.ddpg_demos.SeqBuffer`; obs, priv and hidden_in in
    bfloat16, or float32 in older files) -> the port's `SeqBuffer` on the
    CPU, every field with the JAX file's bits."""
    from .ddpg_demos import SeqBuffer
    rec = load(path)
    return SeqBuffer(**{f: bf16_tensor(getattr(rec, f))
                        for f in SeqBuffer.TENSORS},
                     pos=int(np.asarray(rec.pos)),
                     filled=int(np.asarray(rec.filled)))


# ----------------------------------------------------------------------
# optax's Adam state -> torch.optim.Adam's
# ----------------------------------------------------------------------
def _adam_states(state):
    if all(hasattr(state, f) for f in ScaleByAdamState._fields):
        yield state
    elif isinstance(state, tuple):
        for s in state:
            yield from _adam_states(s)


def adam_state(opt_state):
    """The `ScaleByAdamState` of an optax chain's state, however nested:
    clip -> adam stores (EmptyState, ScaleByAdamState) or (EmptyState,
    (ScaleByAdamState, EmptyState)), `optax.adam` (ScaleByAdamState,
    EmptyState)."""
    found = list(_adam_states(opt_state))
    if len(found) != 1:
        raise ValueError(f"expected one ScaleByAdamState in the optimizer "
                         f"state, found {len(found)}")
    return found[0]


def migrate_adapt_opt_state(adapt_opt_state):
    """Pre-round-3 files hold the adaptation optimizer's moments for the
    whole parameter tree; the optimizer holds only the adaptation module's
    (`wtw_tpu/learn/runner.py:249-256`): keep that subtree."""
    pick = lambda t: (t["adaptation"] if isinstance(t, dict)
                      and "adaptation" in t else t)
    return tuple(ScaleByAdamState(s.count, pick(s.mu), pick(s.nu))
                 if hasattr(s, "mu") else s for s in adapt_opt_state)


def optimizer_state(opt: torch.optim.Optimizer, module: torch.nn.Module,
                    adam: ScaleByAdamState, to_state_dict,
                    prefix: str = "") -> dict:
    """A `state_dict` for `opt` (an Adam over `module.parameters()`) from
    optax's Adam state: `to_state_dict` maps a JAX tree shaped like the
    parameters (mu or nu) to the port's parameter names, as it maps the
    weights. The step is optax's count (both bias-correct with it)."""
    mu, nu = to_state_dict(adam.mu), to_state_dict(adam.nu)
    sd = opt.state_dict()
    names = [prefix + n for n, _ in module.named_parameters()]
    if sorted(names) != sorted(mu):
        raise ValueError(f"optimizer moments do not match the parameters: "
                         f"{sorted(set(names) ^ set(mu))}")
    step = float(np.asarray(adam.count))
    state = {}
    for i, (n, p) in enumerate(module.named_parameters()):
        n = prefix + n
        if mu[n].shape != p.shape or nu[n].shape != p.shape:
            raise ValueError(f"{n}: moments of shape {tuple(mu[n].shape)} "
                             f"for a parameter of {tuple(p.shape)}")
        state[i] = {"step": torch.tensor(step),
                    "exp_avg": mu[n].to(p.device),
                    "exp_avg_sq": nu[n].to(p.device)}
    ids = sd["param_groups"][0]["params"]
    return {"state": {ids[i]: s for i, s in state.items()},
            "param_groups": sd["param_groups"]}


def _tensor(x, device):
    return convert._f32(x).to(device)


def _module_state(sd: Dict[str, torch.Tensor], device):
    return {k: v.to(device) for k, v in sd.items()}


def _reseeded(learner, seed: int):
    gen = torch.Generator(device=learner.gen.device)
    gen.manual_seed(int(seed) + 1)
    return gen.get_state()


_CAT_PARAMS = {"CatTrainState": convert.cat_params_from_jax,
               "PlusTrainState": convert.plus_params_from_jax,
               "RNNTrainState": convert.rnn_params_from_jax}


def learner_state(ts, learner, seed: int = 0, num_envs=None) -> dict:
    """A JAX train state (`ppo_cse.TrainState`, `cat_ppo.CatTrainState`,
    `cat_ppo_plus.PlusTrainState` or `cat_ppornn.RNNTrainState`, as
    `Record`s) -> the `state()` dict of the matching port learner
    (`learn.ppo_cse.PPO` or the CaT family), for its `load_state`. The
    generator is reseeded from `seed` (the JAX key has no counterpart).
    `num_envs` (slim files): the carried dones start at zero for that many
    envs and the GRU hiddens are fitted to it, as `fit_n` does."""
    kind = type(ts).__name__
    dev = learner.gen.device
    if kind == "TrainState":
        model = learner.ac
        adapt = migrate_adapt_opt_state(ts.adapt_opt_state)
        return {
            "ac": _module_state(convert.params_from_jax(ts.params), dev),
            "opt": optimizer_state(learner.opt, model,
                                   adam_state(ts.opt_state),
                                   convert.params_from_jax),
            "adapt_opt": optimizer_state(
                learner.adapt_opt, model.adaptation, adam_state(adapt),
                lambda t: convert._mlp_from_jax({"adaptation": t},
                                                ("adaptation",)),
                prefix="adaptation."),
            "lr": float(np.asarray(ts.lr)),
            "iteration": int(np.asarray(ts.iteration)),
            "gen_state": _reseeded(learner, seed)}
    if kind not in _CAT_PARAMS:
        raise ValueError(f"{getattr(ts, 'jax_class', kind)}: not a train "
                         f"state the port's learners load")
    to_sd = _CAT_PARAMS[kind]
    rms = lambda s: {f: _tensor(getattr(s, f), dev)
                     for f in ("mean", "var", "count")}
    n = num_envs
    fit = lambda a: (np.resize(np.asarray(a), (n,) + np.shape(a)[1:])
                     if n is not None else np.asarray(a))
    blob = {"agent": _module_state(to_sd(ts.params), dev),
            "opt": optimizer_state(learner.opt, learner.agent,
                                   adam_state(ts.opt_state), to_sd),
            "obs_rms": rms(ts.obs_rms), "value_rms": rms(ts.value_rms),
            "iteration": int(np.asarray(ts.iteration)),
            "gen_state": _reseeded(learner, seed)}
    if n is None:
        blob["next_done"] = _tensor(ts.next_done, dev)
        blob["next_true_done"] = _tensor(ts.next_true_done, dev)
    else:
        blob["next_done"] = torch.zeros(n, device=dev)
        blob["next_true_done"] = torch.zeros(n, device=dev)
    if kind == "RNNTrainState":
        blob["ac_hidden"] = _tensor(fit(ts.ac_hidden), dev)
        blob["cr_hidden"] = _tensor(fit(ts.cr_hidden), dev)
    return blob
