"""Parity of the port's RMA and PBT learners (wtw_tpu_torch.learn.ppo_rma /
.pbt, on the CPU) against the JAX package, and `train --algo rma` /
`--pbt N`.

Weights go across with `convert.rma_params_from_jax` / `params_from_jax`;
every draw comes from numpy with a seed and is fed to both sides. The RMA
iteration runs on go1_flat at 4 envs, the JAX env un-jitted on its XLA
physics path with the env's draws off (observation noise; no reset, no
command resampling within the rollout), as tests/test_torch_env.py holds
the env.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtw_tpu import config as jcfg
from wtw_tpu.envs import LeggedEnv as JaxLeggedEnv
from wtw_tpu.learn import pbt as jpbt
from wtw_tpu.learn import ppo_cse as jppo
from wtw_tpu.learn import ppo_rma as jrma
from wtw_tpu.models import actor_critic as jac
from wtw_tpu.models import load_robot as jax_load_robot

from wtw_tpu_torch import config as tcfg
from wtw_tpu_torch.convert import (params_from_jax, rma_params_from_jax,
                                   world_from_jax)
from wtw_tpu_torch.envs import LeggedEnv
from wtw_tpu_torch.learn import pbt as tpbt
from wtw_tpu_torch.learn import ppo_cse as tppo
from wtw_tpu_torch.learn import ppo_rma as trma
from wtw_tpu_torch.models import actor_critic as tac
from wtw_tpu_torch.models import load_robot

np_tree = lambda tree: jax.tree.map(np.asarray, tree)
NARROW = dict(actor_hidden_dims=(32, 16), critic_hidden_dims=(32, 16),
              encoder_hidden_dims=(16,), adaptation_hidden_dims=(16,))


def test_rma_forward_matches_jax():
    """Converted weights at full width (go1_flat: obs 42, privileged 2,
    history 630, latent 18): teacher latent, student latent, action means
    of both and the value at 1e-5."""
    O, P, H, A = 42, 2, 630, 12
    params = jrma.init_rma(jax.random.PRNGKey(0), O, P, H, A)
    model = trma.RMAModel(O, P, H, A)
    model.load_state_dict(rma_params_from_jax(np_tree(params)))
    rng = np.random.RandomState(0)
    obs, priv, oh = (rng.randn(16, n).astype(np.float32) for n in (O, P, H))
    t = torch.from_numpy
    with torch.no_grad():
        lat = model.encoder(t(priv))
        got = [lat, model.actor_mean(t(obs), lat),
               model.evaluate(t(obs), lat), *model.act_student(t(obs), t(oh))]
    want = [jrma.encode(params, priv), jrma.act_teacher(params, obs, priv),
            jrma.evaluate(params, obs, jrma.encode(params, priv)),
            *jrma.act_student(params, obs, oh)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_rma_iteration_matches_jax(monkeypatch):
    """One RMA iteration on go1_flat (3 env steps x 4 envs, 2 epochs x 2
    minibatches, narrow widths) from one carried-over world, the action
    noise and the permutation drawn by numpy and fed to both sides. Bars:
    weights at 1e-5 absolute, losses at 1e-4 relative, the adapted learning
    rate at 1e-6 relative."""
    N, T = 4, 3
    cfg = lambda m: dataclasses.replace(
        m.go1_flat_config(num_envs=N), noise=dataclasses.replace(
            m.go1_flat_config(num_envs=N).noise, add_noise=False))
    jenv = JaxLeggedEnv(cfg(jcfg), jax_load_robot("go1"),
                        physics_backend="xla")
    tenv = LeggedEnv(cfg(tcfg), load_robot("go1"), device="cpu")
    with jax.disable_jit():
        jworld = jenv.init_state(jax.random.PRNGKey(0))
        jworld, jod = jenv.get_observations(jworld)
    # the world after get_observations, and its observations, go across
    tworld = world_from_jax(np_tree(jworld))
    tod = {k: torch.from_numpy(np.array(v)) for k, v in jod.items()}

    jargs = jppo.PPOArgs(num_steps_per_env=T, num_learning_epochs=2,
                         num_mini_batches=2)
    targs = tppo.PPOArgs(num_steps_per_env=T, num_learning_epochs=2,
                         num_mini_batches=2)
    jr, tr = jrma.RMAArgs(**NARROW), trma.RMAArgs(**NARROW)
    ts = jrma.init_train_state(jax.random.PRNGKey(1), jenv, jargs, jr)
    learner = trma.RMA(tenv, targs, tr)
    learner.model.load_state_dict(rma_params_from_jax(np_tree(ts.params)))

    rng = np.random.RandomState(3)
    noise = (0.3 * rng.randn(T, N, 12)).astype(np.float32)
    perm = rng.permutation(T * N)
    feed = iter(noise)
    monkeypatch.setattr(jrma, "sample_actions",
                        lambda key, mean, std: mean + std * jnp.asarray(
                            next(feed)))
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, n: jnp.asarray(perm))
    with jax.disable_jit():
        ts, jworld, jod, jstats = jrma.make_train_fn(jenv, jargs, jr)(
            ts, jworld, jod)
    monkeypatch.undo()
    _, _, tstats = learner.train_iteration(
        tworld, tod, noise=torch.from_numpy(noise),
        perm=torch.from_numpy(perm))
    assert not np.asarray(jworld.env.episode_length == 0).any()  # no reset
    got = learner.model.state_dict()
    for k, v in rma_params_from_jax(np_tree(ts.params)).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=k)
    for k in ("loss", "surrogate_loss", "value_loss", "kl_mean",
              "adaptation_loss", "mean_step_reward"):
        assert float(tstats[k]) == pytest.approx(float(jstats[k]), rel=1e-4,
                                                 abs=1e-7), k
    assert set(tstats) == set(jstats)
    assert tstats["lr"] == pytest.approx(float(ts.lr), rel=1e-6)
    assert learner.iteration == int(ts.iteration) == 1


class _Dims:
    """What ppo_cse reads from an env (go1_flat-like, narrow)."""
    num_obs, num_privileged_obs, num_actions = 6, 2, 4
    num_obs_history = 18
    num_envs = num_train_envs = 4
    device = torch.device("cpu")


SMALL_AC = dict(actor_hidden_dims=(8,), critic_hidden_dims=(8,),
                adaptation_hidden_dims=(8,))


@pytest.mark.parametrize("P,frac", [(2, 0.25), (4, 0.5)])
def test_exploit_explore_matches_jax(P, frac, monkeypatch):
    """Truncation PBT on P members with the source choice and the lr
    perturbations drawn by numpy and fed to both sides: every member's
    weights (exactly), lr (1e-6 relative) and iteration as JAX's. The
    copies own their optimizer state (an Adam step of one leaves its
    source's state as it was)."""
    pbt = jpbt.PBTArgs(population=P, exploit_frac=frac)
    n_cut = max(1, int(P * frac))
    args = jppo.PPOArgs()
    j_ac = jac.ACArgs(**SMALL_AC)
    keys = jax.random.split(jax.random.PRNGKey(0), P)
    ts = jax.vmap(lambda k: jppo.init_train_state(k, _Dims(), args, j_ac))(
        keys)
    lr0 = (1e-3 * 2.0 ** (np.arange(P) - P / 2)).astype(np.float32)
    ts = ts.replace(lr=jnp.asarray(lr0),
                    iteration=jnp.arange(P, dtype=jnp.int32) * 3)
    rng = np.random.RandomState(P)
    fitness = rng.randn(P).astype(np.float32)
    choice = rng.randint(0, n_cut, n_cut)
    u = rng.uniform(np.log(0.8), np.log(1.25), P).astype(np.float32)

    members = []
    for i in range(P):
        m = tppo.PPO(_Dims(), tppo.PPOArgs(), tac.ACArgs(**SMALL_AC), seed=i)
        # an Adam state of its own, then the JAX member's weights
        m.opt.zero_grad()
        sum(p.sum() for p in m.ac.parameters()).backward()
        m.opt.step()
        m.ac.load_state_dict(params_from_jax(np_tree(
            jax.tree.map(lambda x: x[i], ts.params))))
        m.lr, m.iteration = float(lr0[i]), 3 * i
        members.append(m)
    adam_before = [copy.deepcopy(m.opt.state_dict()) for m in members]

    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(choice))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, minval, maxval: jnp.asarray(u))
    want = jpbt.exploit_explore(jax.random.PRNGKey(1), ts,
                                jnp.asarray(fitness), pbt)
    monkeypatch.undo()
    rec = tpbt.exploit_explore(members, fitness, tpbt.PBTArgs(
        population=P, exploit_frac=frac), choice=choice, perturb=np.exp(u))

    assert rec["bottom"] == list(np.argsort(fitness, kind="stable")[:n_cut])
    for i, m in enumerate(members):
        got = m.ac.state_dict()
        for k, v in params_from_jax(np_tree(jax.tree.map(
                lambda x: x[i], want.params))).items():
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(),
                                          err_msg=f"{i} {k}")
        assert m.lr == pytest.approx(float(want.lr[i]), rel=1e-6)
        assert m.iteration == int(want.iteration[i])
    for b, s in zip(rec["bottom"], rec["src"]):
        dst, src = members[b].opt.state_dict(), adam_before[s]
        for pid, st in src["state"].items():
            torch.testing.assert_close(dst["state"][pid]["exp_avg"],
                                       st["exp_avg"], rtol=0, atol=0)
        members[b].opt.zero_grad()
        sum(p.sum() for p in members[b].ac.parameters()).backward()
        members[b].opt.step()
        if s not in rec["bottom"]:
            for pid, st in members[s].opt.state_dict()["state"].items():
                torch.testing.assert_close(
                    st["exp_avg"], adam_before[s]["state"][pid]["exp_avg"],
                    rtol=0, atol=0)


def _pbt_env():
    from wtw_tpu_torch.envs import make_legged_env
    return make_legged_env(tcfg.go1_flat_config(num_envs=4), device="cpu")


def test_train_pbt_on_go1_flat():
    """`train_pbt` over 2 members of a 4-env go1_flat for 3 iterations with
    an exploit every 2: finite fitness, lr of shape (P,), and after the
    exploit the bottom member's lr its source's times a factor in
    [0.8, 1.25]."""
    args = tppo.PPOArgs(num_steps_per_env=4, num_learning_epochs=1,
                        num_mini_batches=2)
    lines = []
    pop, fitness = tpbt.train_pbt(
        _pbt_env(), args, tpbt.PBTArgs(population=2, exploit_interval=2), 3,
        log_fn=lines.append, log_freq=1)
    assert fitness.shape == (2,) and np.isfinite(fitness).all()
    assert pop.lr.shape == (2,) and pop.iteration == 3
    rec = pop.last_exploit
    (b,), (s,) = rec["bottom"], rec["src"]
    assert b != s
    assert 0.8 <= rec["lr_after"][b] / rec["lr_before"][s] <= 1.25
    assert len(lines) == 3 and lines[0].startswith("pbt it     0 | fitness ")


def _train_cli(run_dir, iterations, *extra):
    from wtw_tpu_torch.train import main
    main(["--device", "cpu", "--num-envs", "4", "--iterations",
          str(iterations), "--log-freq", "1", "--run-dir", str(run_dir),
          "--set", "ppo.num_steps_per_env=2", "--set",
          "ppo.num_learning_epochs=1"] + list(extra))


@pytest.mark.parametrize("mode", ["rma", "pbt"])
def test_train_cli_rma_and_pbt_train_and_resume(mode, tmp_path):
    """`train --algo rma` and `train --pbt 2` on the CPU: 2 iterations
    straight equal 1, `--resume` of the port's own state, 1 (every weight,
    the iteration count); a JAX `.pkl` is refused: the JAX package writes
    no resumable RMA or PBT state."""
    flag = ["--algo", "rma"] if mode == "rma" else ["--pbt", "2"]
    name = "rma_state.pt" if mode == "rma" else "pbt_state.pt"
    a, b = tmp_path / "a", tmp_path / "b"
    _train_cli(a, 2, *flag)
    _train_cli(b, 1, *flag)
    _train_cli(b, 1, *flag, "--resume", str(b / name))
    sa = torch.load(a / name, weights_only=False)
    sb = torch.load(b / name, weights_only=False)
    pairs = ([(sa, sb)] if mode == "rma"
             else list(zip(sa["members"], sb["members"])))
    for x, y in pairs:
        assert x["iteration"] == y["iteration"] == 2
        net = "model" if mode == "rma" else "ac"
        for k in x[net]:
            torch.testing.assert_close(x[net][k], y[net][k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="writes no"):
        _train_cli(b, 1, *flag, "--resume", str(b / "state_last.pkl"))
