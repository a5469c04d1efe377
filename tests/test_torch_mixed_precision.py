"""The port's bf16 actor-critic products (`ACArgs.compute_dtype`) and the
`ppo_cse` options that came with them (the bf16 history buffer,
`fused_adaptation_substep`), held against the JAX package on the CPU.

Weights go across with `convert.params_from_jax`; inputs come from numpy
with a seed. One `ppo_cse` iteration runs on a scripted env (a duck-typed
stub whose observations are numpy tables indexed by the step and whose
reward depends on the actions), JAX un-jitted, the action noise and the
permutation drawn by numpy and fed to both sides.

Bars: fp32 at 1e-5 (the split first layer against the concat GEMM at
1e-6, as tests/test_mixed_precision.py holds JAX's); bf16 against JAX bf16
at 1e-2 absolute on O(1) outputs (the two round the same fp32-accumulated
products to bf16, so most outputs agree to the bit and the rest by a bf16
ulp or so); bf16 against fp32 at JAX's 0.05. The bf16 iteration: the stored
bf16 history bit-equal to JAX's, the losses within 2% and the weights
within 5e-3 of JAX's (bf16 rounding flips move gradients by ~1e-2
relative, which Adam's normalised step passes on at up to ~lr = 1e-3 a
step over the 4 steps); the fused iteration at the fp32 learner bars of
tests/test_torch_stack_a_learners.py (weights 1e-5, losses 1e-4
relative).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtw_tpu.learn import ppo_cse as jppo
from wtw_tpu.learn import runner as jrunner
from wtw_tpu.models import actor_critic as jac

from wtw_tpu_torch.convert import params_from_jax
from wtw_tpu_torch.learn import cat_ppo as tcat
from wtw_tpu_torch.learn import ppo_cse as tppo
from wtw_tpu_torch.learn import runner as trunner
from wtw_tpu_torch.models import actor_critic as tac

np_tree = lambda tree: jax.tree.map(np.asarray, tree)
# go1_mob's shapes: obs 70 x 30 history, privileged 2, 12 actions
O, P, H, A = 70, 2, 2100, 12


def _pair(dtype, key=0, **widths):
    """(JAX params, JAX args, port model) with the same weights."""
    ja = jac.ACArgs(compute_dtype=dtype, **widths)
    params = jac.init_actor_critic(jax.random.PRNGKey(key), O, P, H, A, ja)
    model = tac.ActorCritic(O, P, H, A, tac.ACArgs(compute_dtype=dtype,
                                                   **widths))
    model.load_state_dict(params_from_jax(np_tree(params)))
    return params, ja, model


def _inputs(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, H).astype(np.float32),
            rng.randn(n, P).astype(np.float32),
            rng.randn(n, P).astype(np.float32))


FNS = {
    "distribution": (lambda p, a, oh, lat, pr: jac.distribution(p, oh, a)[0],
                     lambda m, oh, lat, pr: m.distribution(oh)[0]),
    "adaptation_module": (
        lambda p, a, oh, lat, pr: jac.adaptation_module(p, oh, a),
        lambda m, oh, lat, pr: m.adaptation_module(oh)),
    "evaluate": (lambda p, a, oh, lat, pr: jac.evaluate(p, oh, pr, a),
                 lambda m, oh, lat, pr: m.evaluate(oh, pr)),
    "actor_critic_heads": (
        lambda p, a, oh, lat, pr: jnp.concatenate([
            x.reshape(oh.shape[0], -1)
            for x in jac.actor_critic_heads(p, oh, lat, pr, a)], -1),
        lambda m, oh, lat, pr: torch.cat([
            x.reshape(oh.shape[0], -1)
            for x in m.actor_critic_heads(oh, lat, pr)], -1)),
}


def _run(fn_name, params, ja, model, ins):
    jfn, tfn = FNS[fn_name]
    want = np.asarray(jfn(params, ja, *ins), np.float32)
    with torch.no_grad():
        got = tfn(model, *map(torch.from_numpy, ins))
    return got, want


def test_split_first_layer_matches_concat_fp32():
    """The first layer as per-part products (`_apply_mlp_parts`, the bf16
    path's order of additions) equals the concat GEMM of the fp32 towers
    at 1e-6, for the actor and the critic."""
    _, _, model = _pair("float32")
    oh, lat, pr = map(torch.from_numpy, _inputs(17))
    with torch.no_grad():
        for seq, part, want in (
                (model.critic, pr, model.evaluate(oh, pr)[:, None]),
                (model.actor, lat, model.actor_mean(oh, lat))):
            got = tac._apply_mlp_parts(seq, [oh, part], "float32")
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("fn_name", sorted(FNS))
def test_fp32_matches_jax(fn_name):
    got, want = _run(fn_name, *_pair("float32"), _inputs())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("fn_name", sorted(FNS))
def test_bf16_matches_jax_bf16(fn_name):
    """bf16 outputs (fp32 tower outputs) against JAX's bf16 at 1e-2; the
    share of outputs that differ at all is printed (`-s`)."""
    got, want = _run(fn_name, *_pair("bfloat16"), _inputs())
    assert got.dtype == torch.float32
    g = got.numpy()
    np.testing.assert_allclose(g, want, atol=1e-2)
    print(f"{fn_name}: {np.mean(g != want):.4f} of the outputs differ, "
          f"max {np.abs(g - want).max():.3g}")


def test_bf16_tracks_fp32():
    """The port's bf16 against its fp32 on the same weights within JAX's
    0.05 (tests/test_mixed_precision.py:53-54); the hidden activations are
    bf16, the outputs fp32, and the parameters stay fp32."""
    _, _, m32 = _pair("float32", key=3)
    _, _, m16 = _pair("bfloat16", key=3)
    oh, lat, pr = map(torch.from_numpy, _inputs(33, seed=4))
    acts = []
    hooks = [m.register_forward_hook(lambda m, i, o: acts.append(o.dtype))
             for m in m16.modules() if isinstance(m, torch.nn.ELU)]
    with torch.no_grad():
        for fn in ("distribution", "adaptation_module", "evaluate"):
            a = FNS[fn][1](m16, oh, lat, pr)
            b = FNS[fn][1](m32, oh, lat, pr)
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0.05,
                                       atol=0.05)
    for h in hooks:
        h.remove()
    assert set(acts) == {torch.bfloat16}
    assert {p.dtype for p in m16.parameters()} == {torch.float32}


def test_bf16_gradients_reach_fp32_parameters():
    """The backward runs through the casts: every parameter gets an fp32
    gradient close to the fp32 model's (bf16 resolution)."""
    _, _, m32 = _pair("float32", key=5, actor_hidden_dims=(64, 32),
                      critic_hidden_dims=(64, 32),
                      adaptation_hidden_dims=(32,))
    _, _, m16 = _pair("bfloat16", key=5, actor_hidden_dims=(64, 32),
                      critic_hidden_dims=(64, 32),
                      adaptation_hidden_dims=(32,))
    oh, _, pr = map(torch.from_numpy, _inputs(32, seed=6))
    for m in (m32, m16):
        mean, _ = m.distribution(oh)
        (mean.square().mean() + m.evaluate(oh, pr).square().mean()).backward()
    for (k, p32), p16 in zip(m32.named_parameters(), m16.parameters()):
        if p32.grad is None:
            continue
        assert p16.grad.dtype == torch.float32, k
        scale = float(p32.grad.abs().max()) + 1e-8
        assert float((p16.grad - p32.grad).abs().max()) <= 0.1 * scale, k


@pytest.mark.parametrize("pair", [
    (jppo.PPOArgs, tppo.PPOArgs), (jac.ACArgs, tac.ACArgs),
    (jrunner.RunnerArgs, trunner.RunnerArgs),
    ("cat", "cat")], ids=["PPOArgs", "ACArgs", "RunnerArgs", "CatPPOArgs"])
def test_args_have_every_jax_field(pair):
    """The port's argument dataclasses hold every field of the JAX ones,
    with the same defaults."""
    j, t = pair
    if j == "cat":
        from wtw_tpu.learn import cat_ppo as jcat
        j, t = jcat.CatPPOArgs, tcat.CatPPOArgs
    jf = {f.name: f.default for f in dataclasses.fields(j)}
    tf = {f.name: f.default for f in dataclasses.fields(t)}
    assert set(jf) <= set(tf), set(jf) - set(tf)
    for k, v in jf.items():
        assert tf[k] == v, (k, tf[k], v)


# ---------------------------------------------------------------------------
# one ppo_cse iteration on a scripted env
# ---------------------------------------------------------------------------
T, N, SO, SP, SA, HIST = 5, 4, 6, 2, 4, 3   # steps, envs, obs, priv, act


class _Script:
    """Numpy tables of the stub: the observation history and the
    privileged observations at each step (independent of the actions), a
    base reward, and the dones."""

    def __init__(self, seed=0):
        rng = np.random.RandomState(seed)
        f = lambda *s: rng.randn(*s).astype(np.float32)
        self.hist = f(T + 1, N, SO * HIST)
        self.priv = f(T + 1, N, SP)
        self.rew = f(T, N)
        self.m = 0.1 * f(SA)
        self.done = np.zeros((T, N), bool)
        self.done[2, 1] = True
        self.timeout = np.zeros((T, N), bool)
        self.timeout[3, 3] = True

    def obs_dict(self, t, lib):
        pick = ((lambda x: jnp.asarray(x)[t]) if lib is jnp
                else (lambda x: torch.from_numpy(x[t])))
        hist = pick(self.hist)
        return {"obs": hist[:, -SO:], "privileged_obs": pick(self.priv),
                "obs_history": hist}


class _Dims:
    num_obs, num_privileged_obs, num_actions = SO, SP, SA
    num_obs_history = SO * HIST
    num_envs = num_train_envs = N
    num_eval_envs, n_terms = 0, 1
    device = torch.device("cpu")


class _JaxStub(_Dims):
    def __init__(self, s):
        self.s = s

    def step(self, t, a):
        s = self.s
        rew = jnp.asarray(s.rew)[t] - 0.01 * jnp.sum(a * a, -1) + a @ \
            jnp.asarray(s.m)
        z = jnp.zeros(())
        info = {"time_outs": jnp.asarray(s.timeout)[t].astype(jnp.float32),
                "episode_sums_at_reset": jnp.zeros(2), "num_resets": z,
                "eval_episode_sums_at_reset": jnp.zeros(2),
                "eval_num_resets": z, "mean_episode_length": z}
        return (t + 1, s.obs_dict(t + 1, jnp), rew, jnp.asarray(s.done)[t],
                info)


class _TorchStub(_Dims):
    def __init__(self, s):
        self.s = s

    def step(self, t, a):
        s = self.s
        rew = (torch.from_numpy(s.rew[t]) - 0.01 * (a * a).sum(-1)
               + a @ torch.from_numpy(s.m))
        z = torch.zeros(())
        info = {"time_outs": torch.from_numpy(s.timeout[t]).float(),
                "episode_sums_at_reset": torch.zeros(2), "num_resets": z,
                "eval_episode_sums_at_reset": torch.zeros(2),
                "eval_num_resets": z, "mean_episode_length": z}
        return (t + 1, s.obs_dict(t + 1, torch), rew,
                torch.from_numpy(s.done[t]), info)


NARROW = dict(actor_hidden_dims=(32, 16), critic_hidden_dims=(32, 16),
              adaptation_hidden_dims=(16,))


def _iteration(dtype, monkeypatch, **ppo_kw):
    """One iteration on both sides (2 epochs x 2 minibatches) from the
    same weights and draws; -> (JAX state, JAX stats, JAX stored
    histories, port learner, port stats, port rollout)."""
    s = _Script()
    jenv, tenv = _JaxStub(s), _TorchStub(s)
    jargs = jppo.PPOArgs(num_steps_per_env=T, num_learning_epochs=2,
                         num_mini_batches=2, **ppo_kw)
    targs = tppo.PPOArgs(num_steps_per_env=T, num_learning_epochs=2,
                         num_mini_batches=2, **ppo_kw)
    ja = jac.ACArgs(compute_dtype=dtype, **NARROW)
    ts = jppo.init_train_state(jax.random.PRNGKey(1), jenv, jargs, ja)
    learner = tppo.PPO(tenv, targs, tac.ACArgs(compute_dtype=dtype,
                                               **NARROW))
    learner.ac.load_state_dict(params_from_jax(np_tree(ts.params)))
    rng = np.random.RandomState(7)
    noise = (0.5 * rng.randn(T, N, SA)).astype(np.float32)
    perm = rng.permutation(T * N)
    feed = iter(noise)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jnp.asarray(next(feed)))
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, n: jnp.asarray(perm))
    stored = []
    real_tr = jppo.Transition

    def transition(**kw):
        stored.append(np.asarray(kw["obs_history"]))
        return real_tr(**kw)
    monkeypatch.setattr(jppo, "Transition", transition)
    with jax.disable_jit():
        ts, _, _, jstats = jppo.make_train_fns(jenv, jargs, ja)(
            ts, 0, s.obs_dict(0, jnp))
    monkeypatch.undo()
    _, obs, traj, metrics = learner.rollout(0, s.obs_dict(0, torch),
                                            torch.from_numpy(noise))
    tstats = learner.update(traj, obs, torch.from_numpy(perm))
    tstats.update(metrics)
    return ts, jstats, stored, learner, tstats, traj


def test_bf16_iteration_matches_jax(monkeypatch):
    """One bf16 iteration: the stored history bf16 and bit-equal to JAX's,
    the losses within 2% and the weights within 5e-3 of JAX's (the
    module docstring has the reasoning), every weight still fp32."""
    ts, jstats, stored, learner, tstats, traj = _iteration("bfloat16",
                                                           monkeypatch)
    assert traj.obs_history.dtype == torch.bfloat16
    want = np.stack(stored)
    assert want.dtype.name == "bfloat16"
    np.testing.assert_array_equal(
        traj.obs_history.view(torch.int16).numpy(),
        want.view(np.int16))
    for k, v in params_from_jax(np_tree(ts.params)).items():
        got = learner.ac.state_dict()[k]
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), v.numpy(), atol=5e-3,
                                   err_msg=k)
    for k in ("loss", "surrogate_loss", "value_loss", "adaptation_loss",
              "mean_step_reward"):
        assert float(tstats[k]) == pytest.approx(float(jstats[k]), rel=2e-2,
                                                 abs=1e-4), k


def test_fused_adaptation_substep_matches_jax(monkeypatch):
    """`fused_adaptation_substep=True` in fp32: the adaptation gradient
    taken at the pre-step parameters in the PPO pass, one iteration
    against JAX's at the learner bars (weights 1e-5, losses 1e-4
    relative); it differs from the unfused update."""
    ts, jstats, _, learner, tstats, _ = _iteration(
        "float32", monkeypatch, fused_adaptation_substep=True)
    got = learner.ac.state_dict()
    for k, v in params_from_jax(np_tree(ts.params)).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=k)
    for k in ("loss", "surrogate_loss", "value_loss", "kl_mean",
              "adaptation_loss", "adaptation_test_loss"):
        assert float(tstats[k]) == pytest.approx(float(jstats[k]), rel=1e-4,
                                                 abs=1e-7), k
    ts2, _, _, learner2, _, _ = _iteration("float32", monkeypatch)
    ad = "adaptation.0.weight"
    assert not torch.equal(learner2.ac.state_dict()[ad], got[ad])


def test_train_cli_bf16(tmp_path):
    """`train --set ac.compute_dtype=bfloat16` at 8 envs, 2 iterations:
    finite, with the weights and Adam's moments fp32 afterwards, as JAX's
    test_train_iteration_bf16 holds its runner."""
    from wtw_tpu_torch.train import build
    _, runner = build("go1_flat", 8, [
        "ac.compute_dtype=bfloat16", "ppo.num_steps_per_env=8",
        "ppo.num_mini_batches=2", "ppo.num_learning_epochs=2",
        "runner.tensorboard=False"], device="cpu", run_dir=str(tmp_path),
        log_freq=1, save_interval=0)
    runner.learn(2, log_fn=lambda *a: None)
    ps = list(runner.ppo.ac.parameters())
    assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
               for p in ps)
    moments = [v for st in runner.ppo.opt.state.values() for v in st.values()
               if torch.is_tensor(v) and v.dim() > 0]
    assert moments and all(v.dtype == torch.float32 for v in moments)
    assert runner.ppo.ac.compute_dtype == "bfloat16"
