"""The port reads the JAX package's checkpoints (wtw_tpu_torch.learn
.jax_checkpoint, `Runner.load`, `ParkourRunner.load`, on the CPU), held
against the JAX package reading the same files.

Files: for each learner (ppo_cse, cat_ppo, ppo_plus, ppornn) a tiny JAX run
(one update with numpy-fed draws, so the Adam moments are nonzero) writes a
full `.pkl` through the JAX package's own save (`Runner.save`,
`scripts/train_parkour.py`'s `_save`), and `tools/slim_checkpoint.py`
makes its slim copy. Both packages load each file. Exact: the Adam step
and moments (after the (in, out) -> (out, in) transpose), the normalizers,
the curriculum weights, terrain levels and types, the CaT state. Action
means on the same numpy observations at 1e-5. Then one more iteration on
each side from the loaded state, with the draws patched as the learner
tests do, at those tests' bars. The committed checkpoints load the same
way (skipped, naming the file, where `checkpoints/` is absent).
"""
import dataclasses
import gzip
import importlib.util
import os
import pickle
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtw_tpu import config as jcfg
from wtw_tpu.envs import LeggedEnv as JaxLeggedEnv
from wtw_tpu.envs.parkour_env import ParkourCfg as JaxParkourCfg
from wtw_tpu.envs.parkour_env import ParkourEnv as JaxParkourEnv
from wtw_tpu.learn import cat_ppo as jcat
from wtw_tpu.learn import cat_ppo_plus as jplus
from wtw_tpu.learn import cat_ppornn as jrnn
from wtw_tpu.learn import ppo_cse as jppo
from wtw_tpu.learn.runner import Runner as JaxRunner
from wtw_tpu.models import actor_critic as jac
from wtw_tpu.models import load_robot as jax_load_robot
from wtw_tpu.terrain import ParkourTerrainCfg as JaxTerrainCfg

from wtw_tpu_torch import config as tcfg
from wtw_tpu_torch import convert
from wtw_tpu_torch.learn import jax_checkpoint as jc
from wtw_tpu_torch.learn.cat_ppo import rms_norm
from wtw_tpu_torch.learn.ppo_cse import Rollout
from wtw_tpu_torch.train import build as build_stack_a
from wtw_tpu_torch.train_parkour import build as build_parkour

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
np_tree = lambda tree: jax.tree.map(np.asarray, tree)


def _script_module(relpath, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _slim(full, slim, monkeypatch):
    """`tools/slim_checkpoint.py full slim`."""
    tool = _script_module("tools/slim_checkpoint.py", "slim_checkpoint_tool")
    monkeypatch.setattr(sys, "argv", ["slim_checkpoint.py", full, slim])
    tool.main()


def _load_jax_pickle(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return pickle.load(f)


def _adam_rows(opt):
    """[(step, exp_avg, exp_avg_sq)] of a torch Adam in parameter order."""
    sd = opt.state_dict()
    return [(float(sd["state"][i]["step"]), sd["state"][i]["exp_avg"],
             sd["state"][i]["exp_avg_sq"])
            for i in sd["param_groups"][0]["params"]]


def _check_adam(opt, module, adam, to_sd, prefix=""):
    """The torch Adam over `module` holds optax's state exactly: step ==
    count, moments equal to optax's after the weights' transpose."""
    mu, nu = to_sd(np_tree(adam.mu)), to_sd(np_tree(adam.nu))
    names = [prefix + n for n, _ in module.named_parameters()]
    assert sorted(names) == sorted(mu)
    for n, (step, m, v) in zip(names, _adam_rows(opt)):
        assert step == float(np.asarray(adam.count)), n
        np.testing.assert_array_equal(m.numpy(), mu[n].numpy(), err_msg=n)
        np.testing.assert_array_equal(v.numpy(), nu[n].numpy(), err_msg=n)


# ---------------------------------------------------------------------------
# what the unpickler refuses and fills
# ---------------------------------------------------------------------------


class _Evil:
    def __reduce__(self):
        return (os.system, ("true",))


@pytest.mark.parametrize("case", ["os.system", "eval", "jax_runner"])
def test_unpickler_refuses_foreign_globals(case, tmp_path):
    """A global that is not numpy's, one of the listed JAX dataclasses,
    optax's two states or a config class raises UnpicklingError naming it
    (the file is never executed)."""
    obj = {"os.system": _Evil(), "eval": eval,
           "jax_runner": JaxRunner}[case]
    path = str(tmp_path / "x.pkl")
    with open(path, "wb") as f:
        pickle.dump({"ts": obj}, f)
    want = {"os.system": r"posix\.system|os\.system", "eval": "builtins.eval",
            "jax_runner": "wtw_tpu.learn.runner.Runner"}[case]
    with pytest.raises(pickle.UnpicklingError, match=want):
        jc.load(path)


def test_cfg_field_missing_from_an_old_file_takes_its_default(tmp_path):
    """A Cfg whose file lacks fields (a `default_factory` sub-config and a
    plain default) reads as the port's Cfg with those defaults; every other
    field keeps the file's value."""
    cfg = jcfg.go1_mob_config(num_envs=77)
    del cfg.__dict__["domain_rand"]          # default_factory: no class attr
    del cfg.env.__dict__["num_eval_envs"]
    path = str(tmp_path / "old.pkl")
    with open(path, "wb") as f:
        pickle.dump({"cfg": cfg}, f)
    got = jc.load(path)["cfg"]
    assert type(got) is tcfg.Cfg and type(got.env) is tcfg.EnvCfg
    assert got.domain_rand == tcfg.DomainRandCfg()
    assert got.env.num_eval_envs == tcfg.EnvCfg().num_eval_envs
    assert got.env.num_envs == 77
    assert got.commands == tcfg.go1_mob_config().commands
    assert dataclasses.replace(got, env=dataclasses.replace(
        got.env, num_envs=3)).env.num_envs == 3


def test_cfg_field_the_port_does_not_know_raises(tmp_path):
    cfg = jcfg.go1_flat_config()
    cfg.rewards.__dict__["a_field_from_the_future"] = 1.0
    path = str(tmp_path / "new.pkl")
    with open(path, "wb") as f:
        pickle.dump({"cfg": cfg}, f)
    with pytest.raises(pickle.UnpicklingError, match="RewardsCfg has no "
                       "field a_field_from_the_future"):
        jc.load(path)


def test_pre_round_3_adaptation_moments_are_migrated():
    """Adaptation-optimizer moments over the whole tree keep only the
    adaptation subtree (wtw_tpu/learn/runner.py:249-256); scoped ones pass
    unchanged."""
    sub = [{"w": np.ones((3, 2), np.float32), "b": np.zeros(2, np.float32)}]
    full = {"actor": [], "adaptation": sub, "critic": [], "std": np.ones(2)}
    old = (jc.ScaleByAdamState(np.int32(4), full, full), jc.EmptyState())
    new = jc.migrate_adapt_opt_state(old)
    assert new[0].mu is sub and new[0].nu is sub and int(new[0].count) == 4
    assert jc.migrate_adapt_opt_state(new)[0].mu is sub


# ---------------------------------------------------------------------------
# ppo_cse (the Stack-A runner's files)
# ---------------------------------------------------------------------------

NARROW = ["ac.actor_hidden_dims=32,16", "ac.critic_hidden_dims=32,16",
          "ac.adaptation_hidden_dims=16", "ppo.num_steps_per_env=4",
          "ppo.num_learning_epochs=1", "ppo.num_mini_batches=1"]
J_AC = jac.ACArgs(actor_hidden_dims=(32, 16), critic_hidden_dims=(32, 16),
                  adaptation_hidden_dims=(16,))
J_PPO = jppo.PPOArgs(num_learning_epochs=1, num_mini_batches=1,
                     num_steps_per_env=4)
NE = 4


_UPDATES = {}


def _j_update(jenv):
    """The JAX learner's update (jitted once per env: un-jitted it takes
    ~18 s on one core)."""
    if id(jenv) not in _UPDATES:
        fn = jppo.make_train_fns(jenv, J_PPO, J_AC)
        _UPDATES[id(jenv)] = jax.jit(dict(zip(
            fn.__code__.co_freevars,
            (c.cell_contents for c in fn.__closure__)))["update"])
    return _UPDATES[id(jenv)]


def _ppo_batch(env, seed):
    """A numpy rollout batch (T, N) at the env's widths and the next obs."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    T, N = J_PPO.num_steps_per_env, NE
    mu = 0.3 * f(T, N, env.num_actions)
    actions = mu + f(T, N, env.num_actions)
    logp = np.asarray(jac.log_prob(jnp.asarray(mu), jnp.ones(
        env.num_actions), jnp.asarray(actions)))
    batch = dict(obs_history=f(T, N, env.num_obs_history),
                 privileged_obs=f(T, N, env.num_privileged_obs),
                 actions=actions, rewards=f(T, N),
                 dones=rng.rand(T, N) < 0.1, values=f(T, N),
                 log_probs=logp, mu=mu)
    last = {"obs_history": f(N, env.num_obs_history),
            "privileged_obs": f(N, env.num_privileged_obs)}
    traj = jppo.Transition(obs=f(T, N, env.num_obs),
                           **{k: jnp.asarray(v) for k, v in batch.items()})
    return batch, last, traj


@pytest.fixture(scope="module")
def stack_a_files(tmp_path_factory):
    """A full and a slim ppo_cse checkpoint of a go1_flat run (4 envs,
    narrow widths) after one JAX update, and the JAX env."""
    d = tmp_path_factory.mktemp("stack_a")
    cfg = jcfg.go1_flat_config(num_envs=NE)
    jenv = JaxLeggedEnv(cfg, jax_load_robot("go1"), physics_backend="xla")
    world = jax.jit(jenv.init_state)(jax.random.PRNGKey(0))
    world, obs = jax.jit(jenv.get_observations)(world)
    ts = jppo.init_train_state(jax.random.PRNGKey(1), jenv, J_PPO, J_AC)
    _, last, traj = _ppo_batch(jenv, 0)
    ts, _ = _j_update(jenv)(ts, traj, {k: jnp.asarray(v)
                                       for k, v in last.items()})
    os.makedirs(d / "checkpoints")
    runner = SimpleNamespace(ts=ts, world=world, obs_dict=obs, env=jenv,
                             runner_args=SimpleNamespace(run_dir=str(d)))
    full = JaxRunner.save(runner, "last")
    return SimpleNamespace(full=full, slim=str(d / "slim.pkl.gz"), jenv=jenv,
                           world=world)


def _port_stack_a(run_dir, resume):
    return build_stack_a("go1_flat", num_envs=NE, overrides=NARROW,
                         device="cpu", run_dir=str(run_dir), log_freq=1,
                         save_interval=0, resume=resume)


@pytest.mark.parametrize("kind", ["full", "slim"])
def test_ppo_cse_checkpoint_loads_and_trains_on(kind, stack_a_files,
                                                monkeypatch, tmp_path):
    """`Runner.load` of the JAX runner's file against `Runner.load` of the
    JAX package: the learner state exactly (both Adams, lr, iteration), the
    world (full: every env field and the observations; slim: the curriculum
    weights and the anneal clock), action means at 1e-5; then one update
    on each side from the loaded state on the same batch and permutation,
    at `tests/test_torch_learn.py`'s bars (losses rtol 1e-5, parameters
    atol 1e-6)."""
    path = stack_a_files.full
    if kind == "slim":
        path = stack_a_files.slim
        if not os.path.exists(path):
            _slim(stack_a_files.full, path, monkeypatch)
    jenv = stack_a_files.jenv
    ref = SimpleNamespace(world=stack_a_files.world, env=jenv)
    JaxRunner.load(ref, path)
    env, runner = _port_stack_a(tmp_path, path)
    ppo = runner.ppo
    # learner state
    assert ppo.iteration == int(ref.ts.iteration) == 1
    assert ppo.lr == float(ref.ts.lr)
    _check_adam(ppo.opt, ppo.ac, jc.adam_state(ref.ts.opt_state),
                convert.params_from_jax)
    _check_adam(ppo.adapt_opt, ppo.ac.adaptation,
                jc.adam_state(ref.ts.adapt_opt_state),
                lambda t: convert._mlp_from_jax({"adaptation": t},
                                                ("adaptation",)),
                prefix="adaptation.")
    # world
    np.testing.assert_array_equal(runner.world.curriculum_weights.numpy(),
                                  np.asarray(ref.world.curriculum.weights))
    assert runner.world.common_step == int(ref.world.common_step)
    if kind == "full":
        np.testing.assert_array_equal(
            runner.world.env.phys.base_pos.numpy(),
            np.asarray(ref.world.env.phys.base_pos))
        np.testing.assert_array_equal(runner.world.env.commands.numpy(),
                                      np.asarray(ref.world.env.commands))
        for k, v in ref.obs_dict.items():
            np.testing.assert_array_equal(runner.obs_dict[k].numpy(),
                                          np.asarray(v), err_msg=k)
    # action means on the same observations
    oh = np.random.RandomState(5).randn(6, env.num_obs_history).astype(
        np.float32)
    want = np.asarray(jac.act_student(ref.ts.params, jnp.asarray(oh),
                                      J_AC)[0])
    got = runner.get_inference_policy()(torch.from_numpy(oh)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # one more update on each side
    batch, last, traj = _ppo_batch(jenv, 1)
    j_ts, j_stats = _j_update(jenv)(ref.ts, traj, {
        k: jnp.asarray(v) for k, v in last.items()})
    _, k_perm = jax.random.split(ref.ts.key)
    perm = np.array(jax.random.permutation(k_perm, J_PPO.num_steps_per_env
                                           * NE))
    t_stats = ppo.update(
        Rollout(**{k: torch.from_numpy(np.array(v))
                   for k, v in batch.items()}),
        {k: torch.from_numpy(v) for k, v in last.items()},
        perm=torch.from_numpy(perm).long())
    for k in ("loss", "surrogate_loss", "value_loss", "kl_mean",
              "adaptation_loss"):
        np.testing.assert_allclose(float(t_stats[k]), float(j_stats[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert t_stats["lr"] == pytest.approx(float(j_stats["lr"]), rel=1e-6)
    sd = ppo.ac.state_dict()
    for k, v in convert.params_from_jax(np_tree(j_ts.params)).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-6,
                                   err_msg=k)
    assert ppo.iteration == int(j_ts.iteration) == 2


def test_train_cli_resumes_a_jax_checkpoint(stack_a_files, tmp_path):
    """`train --resume <JAX .pkl>`: the run continues from the file's
    iteration in the CSV."""
    from wtw_tpu_torch.train import main
    args = ["--preset", "go1_flat", "--device", "cpu", "--num-envs", str(NE),
            "--iterations", "1", "--log-freq", "1", "--run-dir",
            str(tmp_path), "--resume", stack_a_files.full]
    for s in NARROW:
        args += ["--set", s]
    main(args)
    with open(tmp_path / "metrics.csv") as f:
        its = [line.split(",")[0] for line in f.read().splitlines()[1:]]
    assert its == ["1"]


@pytest.mark.parametrize("mode", ["rma", "pbt"])
def test_stack_a_learners_without_a_jax_state_refuse_a_pkl(
        mode, stack_a_files, tmp_path):
    """The JAX package writes no resumable RMA or PBT state: `--resume` of
    a `.pkl` with `--algo rma` or `--pbt` raises, naming it."""
    kw = dict(algo="rma") if mode == "rma" else dict(pbt=2)
    with pytest.raises(ValueError, match="writes no"):
        build_stack_a("go1_flat", num_envs=NE, overrides=NARROW,
                      device="cpu", run_dir=str(tmp_path),
                      resume=stack_a_files.full, **kw)


# ---------------------------------------------------------------------------
# the CaT learners (the parkour script's files)
# ---------------------------------------------------------------------------

SMALL = dict(num_levels=3, num_terrains=5, border_size=4.0)
HIDDEN = (32, 16)
T, NS = 3, 8                    # the scripted env's steps and envs
CAT = {"cat_ppo": (jcat, jcat.CatPPOArgs, convert.cat_params_from_jax),
       "ppo_plus": (jplus, jplus.PPOPlusArgs, convert.plus_params_from_jax),
       "ppornn": (jrnn, jrnn.RNNArgs, convert.rnn_params_from_jax)}
ALGO = {"cat_ppo": "ppo", "ppo_plus": "ppo_plus", "ppornn": "ppornn"}


class _Script:
    """A scripted env at the parkour env's widths (the learner tests' stub,
    `tests/test_torch_cat_learners.py`): step t returns obs[t] + tanh(a) M,
    rew[t] - 0.01 |a|^2, soft dones in [0, 0.3] and one hard done (env 2 at
    step 1)."""

    def __init__(self, n_obs, n_act, seed=0):
        rng = np.random.RandomState(seed)
        f = lambda *s: rng.randn(*s).astype(np.float32)
        self.num_obs, self.num_actions = n_obs, n_act
        self.obs0, self.obs = f(NS, n_obs), f(T, NS, n_obs)
        self.m = 0.1 * f(n_act, n_obs)
        self.rew = f(T, NS)
        self.done = rng.uniform(0, 0.3, (T, NS)).astype(np.float32)
        self.hard = np.zeros((T, NS), bool)
        self.hard[1, 2] = True


class _JaxStub:
    num_envs, dt = NS, 0.02

    def __init__(self, s):
        self.s, self.num_obs, self.num_actions = s, s.num_obs, s.num_actions

    def step(self, t, a):
        s = self.s
        obs = jnp.asarray(s.obs)[t] + jnp.tanh(a) @ jnp.asarray(s.m)
        rew = jnp.asarray(s.rew)[t] - 0.01 * jnp.sum(a * a, -1)
        z = jnp.zeros(())
        return (t + 1, obs, rew, jnp.asarray(s.done)[t],
                {"true_dones": jnp.asarray(s.hard)[t],
                 "terrain_level_mean": z, "episode_sums_at_reset":
                 jnp.zeros(2), "num_resets": z, "episode_len_at_reset": z,
                 "crossings_by_type": jnp.zeros(2),
                 "dones_by_type": jnp.zeros(2)})


class _TorchStub:
    num_envs, device, dt = NS, torch.device("cpu"), 0.02

    def __init__(self, s):
        self.s, self.num_obs, self.num_actions = s, s.num_obs, s.num_actions

    def step(self, t, a):
        s = self.s
        obs = torch.from_numpy(s.obs[t]) + torch.tanh(a) @ torch.from_numpy(
            s.m)
        rew = torch.from_numpy(s.rew[t]) - 0.01 * (a * a).sum(-1)
        z = torch.zeros(())
        info = {"true_dones": torch.from_numpy(s.hard[t]),
                "episode_sums_at_reset": torch.zeros(2), "num_resets": z,
                "episode_len_at_reset": z, "crossings_by_type": torch.zeros(2),
                "dones_by_type": torch.zeros(2), "terrain_level_mean": z}
        return t + 1, obs, rew, torch.from_numpy(s.done[t]), info


def _cat_args(algo, module_args):
    extra = {"ppo_plus": dict(n_perturbations=4),
             "ppornn": dict(rnn_hidden_dim=16)}.get(algo, {})
    return module_args(num_steps=T, num_iterations=10, update_epochs=2,
                       num_minibatches=2, hidden=HIDDEN, **extra)


def _cat_overrides(algo):
    extra = {"ppo_plus": ["ppo.n_perturbations=4"],
             "ppornn": ["ppo.rnn_hidden_dim=16"]}.get(algo, [])
    return ["terrain.num_levels=3", "terrain.num_terrains=5",
            "terrain.border_size=4.0", "ppo.hidden=32,16",
            "ppo.num_minibatches=2", "ppo.update_epochs=2"] + extra


def _draws(algo, seed, n_act, args):
    """(action noise (T, N, A), PPO+'s improvement noise or None,
    permutations (epochs, T N or N)) from numpy, and the JAX learner's
    normal draws in its order."""
    rng = np.random.RandomState(seed)
    noise = (0.5 * rng.randn(T, NS, n_act)).astype(np.float32)
    imp, normals = None, list(noise)
    if algo == "ppo_plus":
        imp = rng.randn(T, args.num_improvement_steps, args.n_perturbations,
                        NS, n_act).astype(np.float32)
        normals = [x for t in range(T) for x in [noise[t]] + list(imp[t])]
    perm_n = NS if algo == "ppornn" else T * NS
    perms = np.stack([rng.permutation(perm_n)
                      for _ in range(args.update_epochs)])
    return noise, imp, perms, normals


def _jax_cat_iteration(algo, ts, script, monkeypatch, seed):
    """One JAX iteration of `algo` on the scripted env with numpy draws;
    -> (ts, stats, (action noise, improvement noise, permutations))."""
    jmod, jargs_cls, _ = CAT[algo]
    jargs = _cat_args(algo, jargs_cls)
    noise, imp, perms, normals = _draws(algo, seed, script.num_actions, jargs)
    obs_n = jcat.rms_norm(ts.obs_rms, jnp.asarray(script.obs0))
    feed = {"normal": iter(normals), "permutation": iter(perms)}
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jnp.asarray(next(feed["normal"])))
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, m: jnp.asarray(next(feed["permutation"])))
    with jax.disable_jit():
        ts, _, _, stats = jmod.make_train_fn(_JaxStub(script), jargs)(
            ts, jnp.int32(0), obs_n)
    monkeypatch.undo()
    assert next(feed["normal"], None) is None      # every draw was served
    return ts, stats, (noise, imp, perms)


@pytest.fixture(scope="module")
def parkour_world():
    """The JAX parkour env and world (8 envs on a 3 x 5 course, draws off)
    that the full files carry, and the scripted env at its widths."""
    kw = dict(num_envs=NS, add_noise=False, push_robots=False,
              only_forwards=True)
    jenv = JaxParkourEnv(JaxParkourCfg(terrain=JaxTerrainCfg(**SMALL), **kw),
                         jax_load_robot("go2"), seed=0, physics_backend="xla")
    world = jax.jit(jenv.init_state)(jax.random.PRNGKey(0))
    return jenv, world, _Script(jenv.num_obs, jenv.num_actions)


@pytest.fixture(scope="module")
def cat_files(parkour_world, tmp_path_factory):
    """Per CaT learner: a full `.pkl` written by the JAX script's `_save`
    after one JAX iteration on the scripted env, and its slim copy."""
    save = _script_module("scripts/train_parkour.py",
                          "jax_train_parkour_script")._save
    jenv, world, script = parkour_world
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for algo, (jmod, jargs_cls, _) in CAT.items():
            d = str(tmp_path_factory.mktemp(algo))
            jargs = _cat_args(algo, jargs_cls)
            with jax.disable_jit():
                ts = jmod.init_train_state(jax.random.PRNGKey(1),
                                           _JaxStub(script), jargs)
                obs = jenv.get_observations(world)
                ts = ts.replace(obs_rms=jcat.rms_update(ts.obs_rms, obs))
            ts, _, _ = _jax_cat_iteration(algo, ts, script, mp, seed=3)
            obs_n = jcat.rms_norm(ts.obs_rms, jenv.get_observations(world))
            save(d, "last", ts, world, obs_n, 1)
            full = os.path.join(d, "state_last.pkl")
            slim = os.path.join(d, "slim.pkl.gz")
            _slim(full, slim, mp)
            out[algo] = SimpleNamespace(full=full, slim=slim)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("kind", ["full", "slim"])
@pytest.mark.parametrize("algo", ["cat_ppo", "ppo_plus", "ppornn"])
def test_cat_checkpoint_loads_and_trains_on(algo, kind, cat_files,
                                            parkour_world, monkeypatch,
                                            tmp_path):
    """`ParkourRunner.load` of the JAX script's file against the JAX
    script's own load (scripts/train_parkour.py:151-183): the learner state
    exactly (weights, Adam, both normalizers, iteration; the carried dones
    zeroed for a slim file, the GRU hiddens), the world (full: every env
    field; slim: terrain levels and types re-seated, the CaT maxima, the
    soft-p progress, the anneal clock) and action means at 1e-5; then one
    more iteration on each side from the loaded state on the scripted env
    with numpy draws, at `tests/test_torch_cat_learners.py`'s bars."""
    jmod, jargs_cls, to_sd = CAT[algo]
    path = getattr(cat_files[algo], kind)
    jenv, jworld, script = parkour_world
    blob = _load_jax_pickle(path)
    ts = blob["ts"]
    if kind == "slim":      # the JAX script's slim branch
        ts = ts.replace(next_done=jnp.zeros((NS,), jnp.float32),
                        next_true_done=jnp.zeros((NS,), jnp.float32))
    runner = build_parkour(NS, _cat_overrides(algo), "cpu",
                           run_dir=str(tmp_path), horizon=T, iterations=10,
                           algo=ALGO[algo])
    runner.load(path)
    ln = runner.learner
    # learner state
    assert ln.iteration == int(ts.iteration) == 1
    _check_adam(ln.opt, ln.agent, jc.adam_state(ts.opt_state), to_sd)
    for s_t, s_j in ((ln.obs_rms, ts.obs_rms), (ln.value_rms, ts.value_rms)):
        for f in ("mean", "var", "count"):
            np.testing.assert_array_equal(getattr(s_t, f).numpy(),
                                          np.asarray(getattr(s_j, f)))
    np.testing.assert_array_equal(ln.next_done.numpy(),
                                  np.asarray(ts.next_done))
    if algo == "ppornn":
        np.testing.assert_array_equal(ln.ac_hidden.numpy(),
                                      np.asarray(ts.ac_hidden))
        assert float(ln.ac_hidden.abs().max()) > 0
    # world
    w, env = runner.world, runner.env
    np.testing.assert_array_equal(w.cat.running_max.numpy(),
                                  np.asarray(jworld.cat.running_max))
    assert w.soft_p_progress == np.float32(jworld.soft_p_progress)
    assert w.common_step == int(jworld.common_step)
    for f in ("terrain_level", "terrain_type"):
        np.testing.assert_array_equal(getattr(w.env, f).numpy(),
                                      np.asarray(getattr(jworld.env, f)))
    if kind == "full":
        np.testing.assert_array_equal(w.env.phys.base_pos.numpy(),
                                      np.asarray(jworld.env.phys.base_pos))
        np.testing.assert_array_equal(runner.obs_n.numpy(),
                                      np.asarray(blob["obs_n"]))
    else:
        # re-seated at the file's levels: every env reset at its origin
        np.testing.assert_array_equal(
            w.env.env_origin.numpy(), env.terrain_origins[
                w.env.terrain_level, w.env.terrain_type].numpy())
        assert int(w.env.progress.abs().sum()) == 0
    # action means on the same observations (PPO-RNN: from the carried
    # hiddens)
    obs = np.random.RandomState(5).randn(NS, env.num_obs).astype(np.float32)
    with torch.no_grad():
        if algo == "ppornn":
            want = np.asarray(jrnn.forward(ts.params, jnp.asarray(obs),
                                           ts.ac_hidden, ts.cr_hidden)[0])
            got = ln.agent(torch.from_numpy(obs), ln.ac_hidden,
                           ln.cr_hidden)[0].numpy()
        else:
            want = np.asarray(jcat.get_action_mean(ts.params,
                                                   jnp.asarray(obs)))
            got = ln.agent.actor_mean(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # one more iteration on each side, on the scripted env
    j_ts, j_stats, (noise, imp, perms) = _jax_cat_iteration(
        algo, ts, script, monkeypatch, seed=4)
    stub_ln = type(ln)(_TorchStub(script), _cat_args(algo, type(ln.args)))
    stub_ln.load_state(jc.learner_state(
        jc.load(path)["ts"], stub_ln, num_envs=NS if kind == "slim" else None))
    obs_n = rms_norm(stub_ln.obs_rms, torch.from_numpy(script.obs0))
    draws = {"improve_noise": torch.from_numpy(imp)} if imp is not None else {}
    _, _, t_stats = stub_ln.train_iteration(
        0, obs_n, noise=torch.from_numpy(noise),
        perms=torch.from_numpy(perms), **draws)
    sd = stub_ln.agent.state_dict()
    for k, v in to_sd(np_tree(j_ts.params)).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=k)
    for k in ("loss", "pg_loss", "value_loss"):
        assert float(t_stats[k]) == pytest.approx(float(j_stats[k]),
                                                  rel=1e-4, abs=1e-6), k
    assert float(t_stats["lr"]) == pytest.approx(float(j_stats["lr"]))
    assert stub_ln.iteration == int(j_ts.iteration) == 2


def test_parkour_cli_resumes_a_jax_checkpoint(cat_files, tmp_path):
    """`train_parkour --resume <JAX .pkl>`: the run continues from the
    file's iteration in the CSV."""
    from wtw_tpu_torch.train_parkour import main
    args = ["--device", "cpu", "--num-envs", str(NS), "--iterations", "1",
            "--horizon", str(T), "--log-freq", "1", "--run-dir",
            str(tmp_path), "--resume", cat_files["cat_ppo"].full]
    for s in _cat_overrides("cat_ppo"):
        args += ["--set", s]
    main(args)
    with open(tmp_path / "metrics.csv") as f:
        its = [line.split(",")[0] for line in f.read().splitlines()[1:]]
    assert its == ["1"]


# ---------------------------------------------------------------------------
# the committed checkpoints
# ---------------------------------------------------------------------------


def _committed(name):
    path = os.path.join(ROOT, "checkpoints", name)
    if not os.path.exists(path):
        pytest.skip(f"{path} is absent (checkpoints/ is not in this "
                    f"checkout)")
    return path


def test_committed_go1_mob_checkpoint_loads_in_both_packages(tmp_path):
    """checkpoints/go1_mob_r2b_50k.pkl.gz, a round-2 file whose adaptation
    moments span the whole tree (migrated on load): action means on the
    same observations at 1e-5, both Adams, lr, iteration and the curriculum
    weights exactly, the config field by field."""
    path = _committed("go1_mob_r2b_50k.pkl.gz")
    jblob = _load_jax_pickle(path)
    tblob = jc.load(path)
    jts = jblob["ts"]
    assert "adaptation" in jts.adapt_opt_state[0].mu     # needs the migration
    assert dataclasses.asdict(tblob["cfg"]) == dataclasses.asdict(
        jblob["cfg"])
    env, runner = build_stack_a(
        "go1_mob", num_envs=4, device="cpu", run_dir=str(tmp_path),
        overrides=["terrain.num_rows=3", "terrain.num_cols=3",
                   "ppo.num_steps_per_env=2"], resume=path)
    ppo = runner.ppo
    assert ppo.iteration == int(jts.iteration) and ppo.lr == float(jts.lr)
    _check_adam(ppo.opt, ppo.ac, jc.adam_state(jts.opt_state),
                convert.params_from_jax)
    migrated = jc.migrate_adapt_opt_state(tblob["ts"].adapt_opt_state)
    _check_adam(ppo.adapt_opt, ppo.ac.adaptation, jc.adam_state(migrated),
                lambda t: convert._mlp_from_jax({"adaptation": t},
                                                ("adaptation",)),
                prefix="adaptation.")
    np.testing.assert_array_equal(runner.world.curriculum_weights.numpy(),
                                  np.asarray(jblob["curriculum"].weights))
    # the env's own observation histories (unit-scale noise over all 2100
    # inputs drives the trained net's means to ~20, where fp32 sums of
    # that width differ by ~1e-5 between the two packages)
    oh = runner.obs_dict["obs_history"].numpy()
    want = np.asarray(jac.act_student(jts.params, jnp.asarray(oh))[0])
    got = runner.get_inference_policy()(torch.from_numpy(oh)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_committed_parkour_checkpoint_loads_in_both_packages(tmp_path):
    """checkpoints/parkour_v2_r5.pkl.gz (slim, iteration 8000) on the full
    course at 16 envs: action means at 1e-5, the Adam state, normalizers,
    CaT maxima, soft-p progress and the terrain levels and types (fitted
    to 16 envs by `np.resize`, as `fit_n` does) exactly."""
    path = _committed("parkour_v2_r5.pkl.gz")
    jblob = _load_jax_pickle(path)
    jts = jblob["ts"]
    runner = build_parkour(16, [], "cpu", run_dir=str(tmp_path))
    runner.load(path)
    ln, w = runner.learner, runner.world
    assert ln.iteration == int(jts.iteration) == int(jblob["iteration"])
    _check_adam(ln.opt, ln.agent, jc.adam_state(jts.opt_state),
                convert.cat_params_from_jax)
    for f in ("mean", "var", "count"):
        np.testing.assert_array_equal(getattr(ln.obs_rms, f).numpy(),
                                      np.asarray(getattr(jts.obs_rms, f)))
    np.testing.assert_array_equal(w.cat.running_max.numpy(),
                                  np.asarray(jblob["cat"].running_max))
    assert w.soft_p_progress == np.float32(jblob["soft_p_progress"])
    fit = lambda a: np.resize(np.asarray(a), (16,))
    np.testing.assert_array_equal(w.env.terrain_level.numpy(),
                                  fit(jblob["terrain_level"]))
    np.testing.assert_array_equal(w.env.terrain_type.numpy(),
                                  fit(jblob["terrain_type"]))
    # the env's own observations (unit-scale noise, normalized, drives the
    # means to ~70, where fp32 rounding alone is ~1e-5)
    obs = runner.env.get_observations(w).numpy()
    obs_n = np.asarray(jcat.rms_norm(jts.obs_rms, jnp.asarray(obs)))
    want = np.asarray(jcat.get_action_mean(jts.params, jnp.asarray(obs_n)))
    with torch.no_grad():
        got = ln.agent.actor_mean(rms_norm(
            ln.obs_rms, torch.from_numpy(obs))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("cli", ["train", "train_parkour"])
def test_cli_continues_a_committed_checkpoint(cli, tmp_path):
    """The two commands of the acceptance list, on the CPU at small N:
    `train --preset go1_mob --resume checkpoints/go1_mob_r5b_cot.pkl.gz`
    and `train_parkour --resume checkpoints/parkour_v2_r5.pkl.gz` each
    continue from the file's iteration."""
    if cli == "train":
        from wtw_tpu_torch.train import main
        path = _committed("go1_mob_r5b_cot.pkl.gz")
        main(["--preset", "go1_mob", "--device", "cpu", "--num-envs", "4",
              "--iterations", "1", "--run-dir", str(tmp_path), "--set",
              "terrain.num_rows=3", "--set", "terrain.num_cols=3", "--set",
              "ppo.num_steps_per_env=2", "--resume", path])
        want = "109500"
    else:
        from wtw_tpu_torch.train_parkour import main
        path = _committed("parkour_v2_r5.pkl.gz")
        main(["--device", "cpu", "--num-envs", "8", "--iterations", "1",
              "--horizon", "2", "--run-dir", str(tmp_path), "--set",
              "terrain.num_levels=3", "--set", "terrain.num_terrains=5",
              "--set", "terrain.border_size=4.0", "--resume", path])
        want = "8000"
    with open(tmp_path / "metrics.csv") as f:
        assert f.read().splitlines()[1].split(",")[0] == want
