"""Parity of the port's eval tools (wtw_tpu_torch.learn.eval_metrics,
.metrics_caches, utils.monitor, utils.keyboard, and the `play`,
`eval_gaits`, `diag_parkour` and `smoke` entry points, on the CPU) against
the JAX package, and the learning outcome of a committed checkpoint in the
port's simulator.

Inputs come from numpy with a seed and go to both sides. The JSON that the
entry points print carries the key sets of the JAX tools' committed
outputs under `results/`.

The outcome bars come from the JAX package's own seed-to-seed spread at
the test's N; `python tests/test_torch_eval.py --spread` measures them
again (JAX on the CPU, ~25 s a seed).
"""
import dataclasses
import gzip
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtw_tpu import config as jcfg
from wtw_tpu.envs import LeggedEnv as JaxLeggedEnv
from wtw_tpu.learn import eval_metrics as jem
from wtw_tpu.learn import metrics_caches as jmc
from wtw_tpu.learn import ppo_cse as jppo
from wtw_tpu.models import actor_critic as jac
from wtw_tpu.models import load_robot as jax_load_robot
from wtw_tpu.utils import keyboard as jkb
from wtw_tpu.utils import monitor as jmon

from wtw_tpu_torch import config as tcfg
from wtw_tpu_torch import diag_parkour, eval_gaits, play, smoke
from wtw_tpu_torch.convert import world_from_jax
from wtw_tpu_torch.envs import LeggedEnv
from wtw_tpu_torch.learn import eval_metrics as tem
from wtw_tpu_torch.learn import metrics_caches as tmc
from wtw_tpu_torch.models import load_robot
from wtw_tpu_torch.utils import keyboard as tkb
from wtw_tpu_torch.utils import monitor as tmon

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(ROOT, "results")


# ---------------------------------------------------------------------------
# metric functions, estimators, caches, DR presets
# ---------------------------------------------------------------------------


def _worlds(n=16, seed=0):
    """The same random world as JAX arrays and as torch tensors (only the
    fields the metrics read)."""
    from types import SimpleNamespace as NS
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    q = f(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    a = dict(base_pos=f(n, 3), base_quat=q, base_lin_vel=f(n, 3),
             base_ang_vel=f(n, 3), joint_qd=f(n, 12))
    e = dict(commands=f(n, 15), torques=10 * f(n, 12),
             payload=rng.uniform(-1, 3, n).astype(np.float32))
    mk = lambda t: NS(env=NS(phys=NS(**{k: t(v) for k, v in a.items()}),
                             **{k: t(v) for k, v in e.items()}))
    return mk(jnp.asarray), mk(torch.from_numpy)


@pytest.mark.parametrize("name", sorted(tem.METRICS_FNS) + ["CoT"])
def test_metric_fn_matches_jax(name):
    """Each METRICS_FNS function and the cost of transport on the same
    random world: 1e-5 relative."""
    jw, tw = _worlds()
    if name == "CoT":
        jfn, tfn = jem.make_cot(12.0), tem.make_cot(12.0)
    else:
        jfn, tfn = jem.METRICS_FNS[name], tem.METRICS_FNS[name]
    np.testing.assert_allclose(tfn(tw).numpy(), np.asarray(jfn(jw)),
                               rtol=1e-5, atol=1e-7)
    assert sorted(tem.METRICS_FNS) == sorted(jem.METRICS_FNS)


def test_classify_contacts_is_identical():
    rng = np.random.RandomState(1)
    c = rng.rand(120, 9, 4) < 0.5
    c[:, :3] = (np.arange(120)[:, None, None] // 10 % 2
                == np.array([0, 1, 1, 0]))          # three trotting envs
    assert tem.classify_contacts(c, 0.02) == jem.classify_contacts(c, 0.02)


def test_obedience_stats_are_identical():
    rng = np.random.RandomState(2)
    T, N = 90, 5
    tr = {k: rng.randn(T, N).astype(np.float32)
          for k in ("base_z", "roll", "pitch", "vx", "vy", "wz")}
    tr["foot_z"] = rng.rand(T, N, 4).astype(np.float32)
    tr["foot_xy"] = rng.randn(T, N, 4, 2).astype(np.float32)
    tr["contact"] = rng.rand(T, N, 4) < 0.5
    assert tem.obedience_stats(tr) == jem.obedience_stats(tr)


def test_dist_cache_is_identical():
    rng = np.random.RandomState(3)
    t, j = tmc.DistCache(), jmc.DistCache()
    for _ in range(5):
        kv = {"a": rng.randn(4), "b": float(rng.randn())}
        t.log(**kv)
        j.log(**kv)
    assert t.get_summary() == j.get_summary()
    assert t.get_summary() == {}


def test_slot_cache_is_identical():
    rng = np.random.RandomState(4)
    t, j = tmc.SlotCache(6), jmc.SlotCache(6)
    for _ in range(4):
        slots, v = rng.randint(0, 6, 10), rng.randn(10)
        t.log(slots, rew=v, len=2 * v)
        j.log(slots, rew=v, len=2 * v)
    ts, js = t.get_summary(), j.get_summary()
    assert sorted(ts) == sorted(js)
    for k in ts:
        np.testing.assert_array_equal(ts[k], js[k])


@pytest.mark.parametrize("sweep", ["base_set"] + sorted(tem.DR_SWEEPS))
def test_dr_sweep_gives_jax_config(sweep):
    """Each DR preset (over `base_set`, as play --sweep applies it) and
    `base_set` alone give the JAX package's config, field by field."""
    for preset in ("go1_flat", "go1_mob"):
        tc, jc = tcfg.PRESETS[preset](), jcfg.PRESETS[preset]()
        if sweep == "base_set":
            got, want = tem.base_set(tc), jem.base_set(jc)
        else:
            got = tem.DR_SWEEPS[sweep](tem.base_set(tc))
            want = jem.DR_SWEEPS[sweep](jem.base_set(jc))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _jax_eval_cfg(cfg, n):
    """The eval config of scripts/play.py:70-88."""
    cfg = dataclasses.replace(cfg, env=dataclasses.replace(
        cfg.env, num_envs=n, num_eval_envs=0))
    return dataclasses.replace(cfg, domain_rand=dataclasses.replace(
        cfg.domain_rand,
        randomize_friction=False, randomize_restitution=False,
        randomize_base_mass=False, randomize_com_displacement=False,
        randomize_motor_strength=False, randomize_motor_offset=False,
        randomize_Kp_factor=False, randomize_Kd_factor=False,
        randomize_gravity=False, randomize_lag_timesteps=True))


def test_eval_config_is_the_jax_scripts():
    """play's and eval_gaits' env config (every DR off except the lag)
    equals the one scripts/play.py builds, for each preset."""
    for preset in tcfg.PRESETS:
        got = play.eval_cfg(tcfg.PRESETS[preset](), 7)
        want = _jax_eval_cfg(jcfg.PRESETS[preset](), 7)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), preset


def test_evaluate_policy_matches_jax(monkeypatch):
    """`evaluate_policy` on go1_flat (4 envs, 5 steps, the eval config with
    the observation noise off; commands pinned; no reset, resample or DR
    re-draw is due) from one carried-over world under the same fixed
    policy: every metric's trace and mean at the state bar, 2e-4
    (tests/test_physics_batched.py:65-76), relative for the large ones."""
    N, steps = 4, 5
    cfgs = [_jax_eval_cfg(m.go1_flat_config(), N) for m in (jcfg, tcfg)]
    cfgs = [dataclasses.replace(c, noise=dataclasses.replace(
        c.noise, add_noise=False)) for c in cfgs]
    jenv = JaxLeggedEnv(cfgs[0], jax_load_robot("go1"), physics_backend="xla")
    tenv = LeggedEnv(cfgs[1], load_robot("go1"), device="cpu")
    jworld = jax.jit(jenv.init_state)(jax.random.PRNGKey(0))
    monkeypatch.setattr(tenv, "init_state", lambda seed=0: world_from_jax(
        jax.tree.map(np.asarray, jworld)))
    monkeypatch.setattr(jenv, "init_state", lambda key: jworld)
    w = 0.05 * np.random.RandomState(0).randn(
        jenv.num_obs_history, jenv.num_actions).astype(np.float32)
    cmd = np.array([0.6, 0.0, 0.2], np.float32)
    with jax.disable_jit():
        jout, jtr = jem.evaluate_policy(
            jenv, lambda o: jnp.tanh(o["obs_history"] @ w), steps=steps,
            commands=cmd)
    tw = torch.from_numpy(w)
    tout, ttr = tem.evaluate_policy(
        tenv, lambda o: torch.tanh(o["obs_history"] @ tw), steps=steps,
        commands=cmd)
    assert list(tout) == list(jout)
    assert sorted(ttr) == sorted(jtr)
    for k in jtr:
        np.testing.assert_allclose(ttr[k].numpy(), np.asarray(jtr[k]),
                                   rtol=2e-4, atol=2e-4, err_msg=k)
    for k in jout:
        assert tout[k] == pytest.approx(jout[k], rel=2e-4, abs=2e-4), k


# ---------------------------------------------------------------------------
# the entry points: checkpoints, JSON keys
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    """One intra-op thread: the rollouts' ops are small, and a pool of
    threads per test worker spins against the other workers (the outcome
    test took 734 s in a 6-worker run, ~40 s alone on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MOB_SMALL = ["terrain.num_rows=3", "terrain.num_cols=3",
             "ppo.num_steps_per_env=2", "ac.actor_hidden_dims=32,16",
             "ac.critic_hidden_dims=32,16", "ac.adaptation_hidden_dims=16"]


@pytest.fixture(scope="module")
def mob_pt(tmp_path_factory):
    """A go1_mob checkpoint of the port (`state_last.pt`) after one
    iteration at 4 envs on a 3 x 3-cell map."""
    from wtw_tpu_torch.train import build
    d = tmp_path_factory.mktemp("mob")
    _, runner = build("go1_mob", num_envs=4, overrides=MOB_SMALL,
                      device="cpu", run_dir=str(d), log_freq=1,
                      save_interval=0)
    runner.learn(1, log_fn=lambda *a: None)
    return os.path.join(str(d), "checkpoints", "state_last.pt")


def _keys(obj):
    """The nested key structure of a JSON object (lists by their first
    element)."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [_keys(obj[0])]
    return None


def test_play_prints_the_jax_scripts_keys(mob_pt, capsys):
    """`play --gait-stats` on a go1_mob checkpoint prints the keys of
    results/go1_mob_r5b_cot/play_f2.5_s0.08.json, in its order."""
    out = play.main(["--checkpoint", mob_pt, "--device", "cpu",
                     "--num-envs", "4", "--steps", "4", "--vx", "0.5",
                     "--freq", "2.5", "--gait-stats"])
    printed = json.loads(capsys.readouterr().out)
    with open(os.path.join(RESULTS, "go1_mob_r5b_cot",
                           "play_f2.5_s0.08.json")) as f:
        want = json.load(f)
    assert list(printed) == list(want) and _keys(printed) == _keys(want)
    assert printed == json.loads(json.dumps(out))
    assert all(np.isfinite(v) for v in out.values()
               if isinstance(v, float))


def test_play_writes_video(mob_pt, tmp_path, one_thread):
    """`play --video` records env 0 over the rollout (4 steps here) and
    renders it: an mp4 through ffmpeg, else a GIF beside the path asked
    for, with one frame every second step."""
    from PIL import Image
    out = play.main(["--checkpoint", mob_pt, "--device", "cpu",
                     "--num-envs", "4", "--steps", "4", "--video",
                     str(tmp_path / "v.mp4")])
    path = out["video"]
    assert os.path.exists(path) and os.path.getsize(path) > 0
    assert path.rsplit(".", 1)[0] == str(tmp_path / "v")
    if path.endswith(".gif"):
        assert Image.open(path).n_frames == 2


def test_eval_gaits_writes_the_jax_scripts_lines(mob_pt, tmp_path,
                                                 monkeypatch, one_thread):
    """`eval_gaits --out` appends one JSON line with the keys of
    results/go1_mob_r5_cot/gait_evals.jsonl, and with `--obedience` those
    of results/go1_mob_r5b_cot/obedience.jsonl (one obedience case here:
    each case is a 51+-step rollout on the CPU)."""
    out = str(tmp_path / "gaits.jsonl")
    eval_gaits.main(["--checkpoint", mob_pt, "--device", "cpu",
                     "--num-envs", "4", "--steps", "4", "--out", out])
    sweep = eval_gaits.OBEDIENCE_SWEEPS[2]           # the footswing height
    monkeypatch.setattr(eval_gaits, "OBEDIENCE_SWEEPS",
                        [(sweep[0], sweep[1], [0.15], sweep[3], sweep[4])])
    eval_gaits.main(["--checkpoint", mob_pt, "--device", "cpu",
                     "--num-envs", "4", "--steps", "55", "--obedience",
                     "--out", out])
    with open(out) as f:
        gaits, obed = [json.loads(line) for line in f]
    for got, path in ((gaits, ("go1_mob_r5_cot", "gait_evals.jsonl")),
                      (obed, ("go1_mob_r5b_cot", "obedience.jsonl"))):
        with open(os.path.join(RESULTS, *path)) as f:
            want = json.loads(f.readline())
        assert list(got) == list(want) and _keys(got) == _keys(want), path
    assert len(gaits["rows"]) == 5 and gaits["gaits_matched"].endswith("/4")
    assert obed["obedience"][0]["command"] == "footswing_height"
    assert np.isfinite(obed["obedience"][0]["realized"])


def test_diag_parkour_prints_the_jax_tools_keys(tmp_path, capsys):
    """`diag_parkour` on a parkour checkpoint of the port prints the keys
    of results/parkour_v2_r5/diag_gap_L0.json."""
    from wtw_tpu_torch.train_parkour import main as train_parkour
    small = ["--set", "terrain.num_levels=3", "--set",
             "terrain.num_terrains=5", "--set", "terrain.border_size=4.0"]
    train_parkour(["--device", "cpu", "--num-envs", "8", "--iterations",
                   "1", "--horizon", "2", "--run-dir", str(tmp_path),
                   "--set", "ppo.hidden=16,8"] + small)
    capsys.readouterr()
    out = diag_parkour.main(["--checkpoint",
                             str(tmp_path / "state_last.pt"), "--device",
                             "cpu", "--num-envs", "8", "--steps", "3",
                             "--stochastic"] + small)
    printed = json.loads(capsys.readouterr().out)
    with open(os.path.join(RESULTS, "parkour_v2_r5", "diag_gap_L0.json")) as f:
        want = json.load(f)
    assert list(printed) == list(want)
    assert printed["first_episodes_done"] + printed["still_alive"] == 8
    assert out["envs"] == 8


def test_diag_attribution_of_first_episodes():
    """`attribute_first_episodes` on scripted traces: env 0 dies at step 1
    of a knee and a base contact at once (base contact is named first),
    env 1 crosses the track and times out at step 2, env 2 dies twice
    (only its first episode counts), env 3 never finishes."""
    T, N, track = 4, 4, 12.0
    td = np.zeros((T, N), bool)
    td[1, 0] = td[2, 1] = td[0, 2] = td[3, 2] = True
    dist = np.zeros((T, N), np.float32)
    dist[1, 0], dist[2, 1], dist[0, 2], dist[3, 2] = 1.5, 11.0, 0.2, 7.0
    reasons = {k: np.zeros((T, N), bool) for k in diag_parkour.REASONS}
    reasons["knee_contact"][1, 0] = reasons["base_contact"][1, 0] = True
    reasons["timeout"][2, 1] = reasons["lava"][0, 2] = True
    reasons["lava"][3, 2] = True
    amax = np.zeros((T, N), np.int64)
    amax[1, 0], amax[2, 1], amax[0, 2] = 1, 2, 0
    progress = np.array([[1, 1, 0, 1], [0, 2, 1, 2], [1, 0, 2, 3],
                         [2, 1, 0, 4]], np.int32)
    alive_x = np.array([[0.5, 1.0, 0.1, 0.3], [1.5, 4.0, 0.2, 0.6],
                        [0.2, 11.0, 0.3, 0.9], [0.4, 0.2, 7.0, 1.2]],
                       np.float32)
    out = diag_parkour.attribute_first_episodes(
        td, dist, reasons, amax, progress, alive_x,
        ["heading", "stumble", "lava"], 0.02, track)
    assert out["first_episodes_done"] == 3 and out["still_alive"] == 1
    assert out["alive_max_x_mean"] == 1.2
    assert out["reasons"] == {"base_contact": 1, "lava": 1, "timeout": 1}
    assert out["binding_cstr"] == {"heading": 1, "lava": 1, "stumble": 1}
    assert out["cross_rate"] == round(1 / 3, 3)
    assert out["eplen_mean_s"] == round((1 + 2 + 0) * 0.02 / 3, 2)
    hist = out["death_x_hist_1m_bins"]
    assert len(hist) == 13 and hist[0] == hist[1] == hist[11] == 1


# ---------------------------------------------------------------------------
# a JAX file through play, the console table, the keyboard, the smoke
# ---------------------------------------------------------------------------


def test_play_reads_a_jax_slim_checkpoint(tmp_path):
    """A slim go1_mob file as tools/slim_checkpoint.py writes it (JAX
    weights at narrow widths, the curriculum, the config): play's policy
    gives the JAX student's action means at 1e-5 on the same observations,
    and its env is the file's config."""
    cfg = jcfg.go1_mob_config(num_envs=4)

    class Dims:
        num_obs, num_privileged_obs, num_actions = 70, 2, 12
        num_obs_history = 70 * 30
    j_ac = jac.ACArgs(actor_hidden_dims=(32, 16), critic_hidden_dims=(32, 16),
                      adaptation_hidden_dims=(16,))
    ts = jppo.init_train_state(jax.random.PRNGKey(3), Dims, jppo.PPOArgs(),
                               j_ac)
    path = str(tmp_path / "mob_slim.pkl.gz")
    with gzip.open(path, "wb") as f:
        pickle.dump({"slim": True, "ts": jax.device_get(ts),
                     "curriculum": None, "common_step": np.int32(5),
                     "cfg": cfg}, f)
    env, policy, got_cfg, it = play.build(path, num_envs=4, device="cpu")
    assert it == 0 and got_cfg.terrain.num_rows == cfg.terrain.num_rows
    oh = np.random.RandomState(0).rand(5, Dims.num_obs_history).astype(
        np.float32)
    want = np.asarray(jac.act_student(ts.params, jnp.asarray(oh), j_ac)[0])
    got = policy({"obs_history": torch.from_numpy(oh)}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_monitor_table_is_identical():
    rows = {"rew_a": 1.23456, "rew_b": -0.5, "label": "x"}
    assert tmon.monitor_table(rows, title="it 3") == jmon.monitor_table(
        rows, title="it 3")


def test_keyboard_source_is_identical():
    t, j = tkb.KeyboardCommandSource(15, vx=0.3), jkb.KeyboardCommandSource(
        15, vx=0.3)
    for keys in ("ww2", "dq=", "zt]", " 3f", "r.x"):
        t.feed(keys)
        j.feed(keys)
        np.testing.assert_array_equal(t.poll(), j.poll())
        assert t.status() == j.status() and t.gait == j.gait


def test_smoke_runs_on_the_cpu(capsys):
    world = smoke.main(["--device", "cpu", "--steps", "5"])
    assert "OK" in capsys.readouterr().out
    assert bool(torch.isfinite(world.env.phys.base_pos).all())


def test_runner_writes_the_eval_stream_and_table(tmp_path):
    """With eval envs split off, the runner's CSV has `eval_rew_total` and
    `eval_num_episodes` (wtw_tpu/learn/runner.py:162-168); under
    `eval_expert` the eval envs act with the teacher; the console table of
    the reward terms prints every `console_table_freq` iterations."""
    from wtw_tpu_torch.train import build
    lines = []
    _, runner = build("go1_flat", num_envs=6, device="cpu",
                      run_dir=str(tmp_path), log_freq=1, save_interval=0,
                      overrides=["env.num_eval_envs=2",
                                 "ppo.num_steps_per_env=2",
                                 "ppo.eval_expert=true",
                                 "runner.console_table_freq=1",
                                 "ac.actor_hidden_dims=16",
                                 "ac.critic_hidden_dims=16",
                                 "ac.adaptation_hidden_dims=8"])
    assert runner.ppo.args.eval_expert and runner.env.num_eval_envs == 2
    runner.learn(2, log_fn=lines.append)
    with open(tmp_path / "metrics.csv") as f:
        header = f.readline().strip().split(",")
        rows = [r.split(",") for r in f.read().splitlines()]
    assert header[-2:] == ["eval_rew_total", "eval_num_episodes"]
    assert len(rows) == 2 and all(np.isfinite(float(x)) for r in rows
                                  for x in r)
    assert sum("Mean Value" in line for line in lines) == 2


# ---------------------------------------------------------------------------
# the outcome: a committed JAX policy trots in the port's simulator
# ---------------------------------------------------------------------------

# results/go1_mob_r5b_cot/play_f2.5_s0.08.json (the JAX package, 64 envs)
COMMITTED = {"lin_vel_x": 0.4216121435165405,
             "base_height": 0.28211599588394165, "stride_freq_hz": 2.64375}
# JAX's own play --gait-stats on the CPU at this test's N (16 envs, 250
# steps, seeds 0-15, `--spread` below): mean, sample std. The port must
# land within three JAX stds of the JAX mean. The committed file is offset
# from that mean (at 64 envs, seed 0, JAX on the CPU gives lin_vel_x
# 0.4655, base_height 0.2893, stride 2.553 Hz), so its distance from the
# port is held to that offset plus the same three stds.
JAX_SPREAD_N16 = {"lin_vel_x": (0.46164731681346893, 0.01576715096189913),
                  "base_height": (0.28992665000259876, 0.0029372206752073713),
                  "stride_freq_hz": (2.57578125, 0.04862028683241873)}
BARS = {k: 3 * s for k, (m, s) in JAX_SPREAD_N16.items()}
COMMITTED_BARS = {k: abs(m - COMMITTED[k]) + 3 * s
                  for k, (m, s) in JAX_SPREAD_N16.items()}
OUTCOME_ARGS = ["--num-envs", "16", "--steps", "250", "--vx", "0.5",
                "--freq", "2.5", "--footswing", "0.08", "--gait", "trot",
                "--gait-stats"]


def test_committed_policy_trots_in_the_port(one_thread, capsys):
    """`play --gait-stats` of checkpoints/go1_mob_r5b_cot.pkl.gz on the CPU
    (16 envs, 250 steps, trot at 2.5 Hz, footswing 0.08, vx 0.5) trots,
    its lin_vel_x, base_height and stride_freq_hz within three stds of
    JAX's mean at the same N, and (a consequence, kept as a record of the
    committed JSON) within the committed values' bars. Skipped where
    checkpoints/ is absent."""
    path = os.path.join(ROOT, "checkpoints", "go1_mob_r5b_cot.pkl.gz")
    if not os.path.exists(path):
        pytest.skip(f"{path} is absent (checkpoints/ is not in this "
                    f"checkout)")
    out = play.main(["--checkpoint", path, "--device", "cpu"]
                    + OUTCOME_ARGS)
    got = {"lin_vel_x": out["lin_vel_x"], "base_height": out["base_height"],
           "stride_freq_hz": out["gait"]["stride_freq_hz"]}
    assert out["gait"]["dominant_gait"] == "trot"
    for k, v in got.items():
        mean = JAX_SPREAD_N16[k][0]
        assert abs(v - mean) <= BARS[k], (k, v, mean, BARS[k])
        assert abs(v - COMMITTED[k]) <= COMMITTED_BARS[k], (
            k, v, COMMITTED[k], COMMITTED_BARS[k])


def _jax_spread(seeds, n=16):
    """JAX's play --gait-stats on the committed checkpoint at the outcome
    test's settings, one JSON line per seed (the seed also draws the
    map, as scripts/play.py's does)."""
    from wtw_tpu.envs import make_legged_env
    with gzip.open(os.path.join(ROOT, "checkpoints",
                                "go1_mob_r5b_cot.pkl.gz")) as f:
        blob = pickle.load(f)
    params = jax.tree.map(jnp.asarray, blob["ts"].params)
    policy = lambda o: jac.act_student(params, o["obs_history"])[0]
    cmd = play.command_vector(15, 0.5, gait="trot", freq=2.5,
                              footswing=0.08)
    for seed in seeds:
        env = make_legged_env(_jax_eval_cfg(blob["cfg"], n), seed=seed)
        s, _ = jem.evaluate_policy(env, policy, steps=250, seed=seed,
                                   commands=cmd)
        s["gait"] = jem.gait_stats(env, policy, steps=250, seed=seed,
                                   commands=cmd)
        print(json.dumps({"seed": seed, "n": n, **s}), flush=True)


if __name__ == "__main__" and "--spread" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    _jax_spread(range(16))
