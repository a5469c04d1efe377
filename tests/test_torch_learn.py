"""Parity of the port's learner (wtw_tpu_torch.learn, models.actor_critic,
on the CPU) against the JAX package, and the runner's checkpoints/export.

Weights go across with `convert.params_from_jax`; batches come from numpy
with a seed and are fed to both sides.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtw_tpu.deploy.policy import DeployedPolicy
from wtw_tpu.learn import ppo_cse as jppo
from wtw_tpu.models import actor_critic as jac

from wtw_tpu_torch.convert import params_from_jax
from wtw_tpu_torch.learn import PPO, PPOArgs, compute_gae
from wtw_tpu_torch.learn.ppo_cse import Rollout
from wtw_tpu_torch.models import actor_critic as tac
from wtw_tpu_torch.train import build


def test_compute_gae_matches_jax():
    """GAE recursion + advantage normalization: atol 2e-5 (float32, the
    JAX repo's own GAE bar)."""
    rng = np.random.RandomState(0)
    T, N = 7, 5
    rew = rng.randn(T, N).astype(np.float32)
    done = rng.rand(T, N) < 0.2
    val = rng.randn(T, N).astype(np.float32)
    last = rng.randn(N).astype(np.float32)
    ja, jr = jppo.compute_gae(jnp.asarray(rew), jnp.asarray(done),
                              jnp.asarray(val), jnp.asarray(last), 0.99, 0.95)
    ta, tr = compute_gae(*map(torch.from_numpy, (rew, done, val, last)),
                         0.99, 0.95)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=2e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-5)


def test_actor_critic_forward_with_converted_weights():
    """Full go1_flat widths (630-dim history, 512-256-128 towers): student
    action, latent, value, log-prob and entropy at atol 1e-5."""
    H, P, A = 15 * 42, 2, 12
    params = jac.init_actor_critic(jax.random.PRNGKey(0), 42, P, H, A)
    model = tac.ActorCritic(42, P, H, A)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    rng = np.random.RandomState(1)
    oh = rng.randn(16, H).astype(np.float32)
    priv = rng.randn(16, P).astype(np.float32)
    act = rng.randn(16, A).astype(np.float32)
    j_mean, j_lat = jac.act_student(params, jnp.asarray(oh))
    j_val = jac.evaluate(params, jnp.asarray(oh), jnp.asarray(priv))
    with torch.no_grad():
        t_mean, t_lat = model.act_student(torch.from_numpy(oh))
        t_val = model.evaluate(torch.from_numpy(oh), torch.from_numpy(priv))
        t_std = model.std.detach().expand_as(t_mean)
    np.testing.assert_allclose(t_lat.numpy(), np.asarray(j_lat), atol=1e-5)
    np.testing.assert_allclose(t_mean.numpy(), np.asarray(j_mean), atol=1e-5)
    np.testing.assert_allclose(t_val.numpy(), np.asarray(j_val), atol=1e-5)
    j_std = jnp.broadcast_to(params["std"], j_mean.shape)
    np.testing.assert_allclose(
        tac.log_prob(t_mean, t_std, torch.from_numpy(act)).numpy(),
        np.asarray(jac.log_prob(j_mean, j_std, jnp.asarray(act))), atol=1e-4)
    np.testing.assert_allclose(tac.entropy(t_std).numpy(),
                               np.asarray(jac.entropy(j_std)), atol=1e-5)


class _Dims:
    """What the learners read from an env (go1_flat-like, narrow)."""
    num_obs, num_privileged_obs, num_actions = 6, 2, 4
    num_obs_history = 18
    num_envs = num_train_envs = 16
    n_terms = 1
    device = torch.device("cpu")


class _MobDims(_Dims):
    """go1_mob's shapes: obs 70 x 30 history, 2 privileged obs, 12
    actions."""
    num_obs, num_privileged_obs, num_actions = 70, 2, 12
    num_obs_history = 30 * 70


def _check_minibatch_step(d, param_atol=1e-6):
    """One PPO minibatch step + adaptation substep (1 epoch x 1 minibatch)
    on the same batch, permutation and weights, against JAX. Losses, KL and
    the adapted learning rate at rtol 1e-5; parameters after the step at
    `param_atol` (Adam's first step moves each weight by ~lr x sign(grad) =
    1e-3 x 1.5, so 1e-6 catches any wrong sign, scale or clip)."""
    T, N = 4, d.num_envs
    small = dict(actor_hidden_dims=(32, 16), critic_hidden_dims=(32, 16),
                 adaptation_hidden_dims=(16,))
    jargs = jppo.PPOArgs(num_learning_epochs=1, num_mini_batches=1,
                         num_steps_per_env=T)
    j_ac = jac.ACArgs(**small)
    ts = jppo.init_train_state(jax.random.PRNGKey(0), d, jargs, j_ac)
    fn = jppo.make_train_fns(d, jargs, j_ac)
    j_update = dict(zip(fn.__code__.co_freevars,
                        (c.cell_contents for c in fn.__closure__)))["update"]

    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    oh, priv = f(T, N, d.num_obs_history), f(T, N, d.num_privileged_obs)
    mu, _ = jac.act_student(ts.params, jnp.asarray(oh), j_ac)
    mu = np.asarray(mu) + 0.01 * f(T, N, d.num_actions)
    actions = mu + f(T, N, d.num_actions)
    std = np.ones(d.num_actions, np.float32)
    logp = np.asarray(jac.log_prob(jnp.asarray(mu), jnp.asarray(std),
                                   jnp.asarray(actions)))
    batch = dict(obs_history=oh, privileged_obs=priv, actions=actions,
                 rewards=f(T, N), dones=rng.rand(T, N) < 0.1,
                 values=f(T, N), log_probs=logp, mu=mu)
    last = {"obs_history": f(N, d.num_obs_history),
            "privileged_obs": f(N, d.num_privileged_obs)}
    traj = jppo.Transition(obs=f(T, N, d.num_obs), **{
        k: jnp.asarray(v) for k, v in batch.items()})
    j_ts, j_stats = j_update(ts, traj, {k: jnp.asarray(v)
                                        for k, v in last.items()})
    _, k_perm = jax.random.split(ts.key)
    perm = np.array(jax.random.permutation(k_perm, T * N))

    learner = PPO(d, PPOArgs(num_learning_epochs=1, num_mini_batches=1,
                             num_steps_per_env=T), tac.ACArgs(**small))
    learner.ac.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, ts.params)))
    t_stats = learner.update(
        Rollout(**{k: torch.from_numpy(np.array(v))
                   for k, v in batch.items()}),
        {k: torch.from_numpy(v) for k, v in last.items()},
        perm=torch.from_numpy(perm).long())
    for k in ("loss", "surrogate_loss", "value_loss", "kl_mean",
              "adaptation_loss", "adaptation_test_loss"):
        np.testing.assert_allclose(float(t_stats[k]), float(j_stats[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(t_stats["lr"], float(j_stats["lr"]), rtol=1e-6)
    got = learner.ac.state_dict()
    for k, v in params_from_jax(jax.tree.map(np.asarray, j_ts.params)).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                   atol=param_atol, err_msg=k)


def test_ppo_minibatch_step_matches_jax():
    """`_check_minibatch_step` at narrow go1_flat-like shapes."""
    _check_minibatch_step(_Dims())


def test_ppo_minibatch_step_matches_jax_on_go1_mob_shapes():
    """`_check_minibatch_step` at go1_mob's shapes (a 2100-wide history
    into the adaptation module and the actor) and narrow widths.
    Parameters at atol 1e-5: in the PPO step, 15 of the adaptation
    module's 33,600 first-layer weights have gradients of 2e-9 to 3e-8, at
    Adam's eps (1e-8), where the step lr g / (|g| + eps) turns on the last
    bits of an fp32 sum (they land up to 6e-6 apart on the two sides); 1e-5
    is still 150x below one step, so a wrong sign, scale or clip fails."""
    _check_minibatch_step(_MobDims(), param_atol=1e-5)


def _tiny_runner(tmp_path, seed=0):
    return build("go1_flat", num_envs=8, device="cpu", seed=seed,
                 run_dir=str(tmp_path), log_freq=1, save_interval=0,
                 overrides=["ppo.num_steps_per_env=4",
                            "ac.actor_hidden_dims=32,16",
                            "ac.critic_hidden_dims=32,16",
                            "ac.adaptation_hidden_dims=16"])


def test_runner_checkpoint_resume_is_exact(tmp_path):
    """2 iterations straight == 1 iteration, save, load, 1 iteration."""
    _, straight = _tiny_runner(tmp_path / "a")
    straight.learn(2, log_fn=lambda *a: None)
    _, first = _tiny_runner(tmp_path / "b")
    first.learn(1, log_fn=lambda *a: None)
    ckpt = os.path.join(str(tmp_path / "b"), "checkpoints", "state_last.pt")
    _, resumed = _tiny_runner(tmp_path / "c", seed=7)
    resumed.load(ckpt)
    resumed.learn(1, log_fn=lambda *a: None)
    a, b = straight.ppo.ac.state_dict(), resumed.ppo.ac.state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    torch.testing.assert_close(straight.world.env.phys.base_pos,
                               resumed.world.env.phys.base_pos, rtol=0, atol=0)
    assert straight.ppo.iteration == resumed.ppo.iteration == 2
    rows = open(os.path.join(str(tmp_path / "a"), "metrics.csv")).read()
    assert rows.count("\n") == 3 and "rew_total" in rows


def test_policy_export_drives_deploy_policy(tmp_path):
    """The .npz export loads into wtw_tpu/deploy/policy.py unchanged and
    gives the torch student's actions (atol 1e-5)."""
    env, runner = _tiny_runner(tmp_path)
    path = runner.save("export")
    assert os.path.exists(path)
    deployed = DeployedPolicy(os.path.join(str(tmp_path), "checkpoints",
                                           "policy_export.npz"))
    oh = np.random.RandomState(0).randn(5, env.num_obs_history).astype(
        np.float32)
    want = runner.get_inference_policy()(torch.from_numpy(oh)).numpy()
    np.testing.assert_allclose(deployed(oh), want, atol=1e-5)


def test_train_cli_runs_one_iteration(tmp_path):
    from wtw_tpu_torch.train import main
    main(["--device", "cpu", "--num-envs", "4", "--iterations", "1",
          "--run-dir", str(tmp_path), "--set", "ppo.num_steps_per_env=2",
          "--set", "ac.actor_hidden_dims=16", "--set",
          "ac.critic_hidden_dims=16", "--set", "ac.adaptation_hidden_dims=8"])
    assert os.path.exists(os.path.join(str(tmp_path), "checkpoints",
                                       "policy_last.npz"))


def _mob_cli(run_dir, *extra):
    from wtw_tpu_torch.train import main
    main(["--preset", "go1_mob", "--device", "cpu", "--num-envs", "4",
          "--iterations", "1", "--log-freq", "1", "--run-dir", str(run_dir),
          "--set", "terrain.num_rows=3", "--set", "terrain.num_cols=3",
          "--set", "ppo.num_steps_per_env=2", "--set",
          "ac.actor_hidden_dims=16", "--set", "ac.critic_hidden_dims=16",
          "--set", "ac.adaptation_hidden_dims=8", *extra])


def test_train_cli_go1_mob_runs_and_resumes(tmp_path):
    """go1_mob through the CLI on a 3 x 3-cell map at narrow widths: one
    iteration writes `policy_last.npz` and `state_last.pt`; `--resume` of
    that state continues the iteration count (1, not 0) in the same CSV;
    the same with `--actuator-model-wrapper`, which starts the wrapper's
    state beside the resumed world. (Resuming a JAX `.pkl` is
    tests/test_torch_checkpoint.py's.)"""
    ck = os.path.join(str(tmp_path), "checkpoints")
    _mob_cli(tmp_path)
    assert os.path.exists(os.path.join(ck, "policy_last.npz"))
    state = os.path.join(ck, "state_last.pt")
    _mob_cli(tmp_path, "--resume", state)
    _mob_cli(tmp_path, "--resume", state, "--actuator-model-wrapper")
    with open(os.path.join(str(tmp_path), "metrics.csv")) as f:
        its = [line.split(",")[0] for line in f.read().splitlines()[1:]]
    assert its == ["0", "1", "2"]
