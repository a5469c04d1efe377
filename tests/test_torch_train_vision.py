"""The port's `train_vision` CLI (wtw_tpu_torch.train_vision, on the CPU)
against the JAX package's `scripts/train_vision.py`.

- eval: both scripts run as their `main` on the committed student
  (`results/vision_v2_r5/vision_student.pkl`) and on the committed expert
  (`checkpoints/parkour_v2_r5.pkl.gz`; skipped where a checkout has no
  `checkpoints/`), at 8 envs on the small course (3 levels x 5 track
  types), the observation noise, the pushes and the command dynamics off,
  and must print the same JSON. The JAX side runs un-jitted on its batched
  XLA path (jitting the parkour step takes ~3 min on the CPU; un-jitted a
  student step takes ~15 s, so the runs are 3 steps). Its initial world is
  scripted (three envs time out on the last step) and handed to the port
  through `parkour_world_from_jax`; every episode ends on the last step,
  before a reset draws from a generator the other side cannot match. The
  rest of the eval's arithmetic (dones and crossings on several steps, the
  latent held between refreshes, the hiddens zeroed on dones) is held to
  the JAX script's on a scripted env whose poses, observations, rewards,
  dones and distances come from numpy tables, 8 steps with the committed
  student.
- generate -> train: the JAX script writes an `rb_demos.pkl` (its bf16
  fields are `ml_dtypes.bfloat16` arrays); the port reads it bit for bit,
  and its `train` runs on it in a subprocess where `jax`, `flax`, `optax`,
  `ml_dtypes` and `wtw_tpu` cannot be imported.
- The port's CLI on the CPU for all three modes: generate with a JAX CaT
  expert (actor 32-16) into the port's `rb_demos.pt`, train from it (a BC
  warm start, warm-up steps, the actor hold and live updates), eval of the
  student it writes.
"""
import gzip
import importlib.util
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from wtw_tpu_torch import train_vision
from wtw_tpu_torch.convert import parkour_world_from_jax
from wtw_tpu_torch.learn import ddpg_demos as D

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, STEPS = 8, 3
SMALL = ["terrain.num_levels=3", "terrain.num_terrains=5",
         "terrain.border_size=4.0", "add_noise=false", "push_robots=false",
         "only_forwards=true"]
STUDENT = os.path.join(ROOT, "results", "vision_v2_r5", "vision_student.pkl")
EXPERT = os.path.join(ROOT, "checkpoints", "parkour_v2_r5.pkl.gz")
sets = lambda xs: [a for x in xs for a in ("--set", x)]


def _jax_script(monkeypatch):
    """scripts/train_vision.py as a module (scripts/ on sys.path for its
    `train_parkour` import)."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "scripts"))
    spec = importlib.util.spec_from_file_location(
        "jax_train_vision_script", os.path.join(ROOT, "scripts",
                                                "train_vision.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _script(world, env):
    """Envs 0, 2 and 3 timed out on the last step."""
    e = world.env
    progress = np.array(e.progress)
    progress[[0, 2, 3]] = env.max_episode_length - STEPS - 1
    return world.replace(env=e.replace(progress=jax.numpy.asarray(progress)))


@pytest.mark.parametrize("policy", ["student", "expert"])
def test_eval_prints_the_jax_json(policy, monkeypatch, capsys):
    path = STUDENT if policy == "student" else EXPERT
    if not os.path.exists(path):
        pytest.skip(f"needs {os.path.relpath(path, ROOT)} (not in a "
                    f"checkout of only what .gitignore leaves)")
    flag = "--student" if policy == "student" else "--checkpoint"
    argv = ["eval", flag, path, "--num-envs", str(N), "--steps",
            str(STEPS)] + sets(SMALL)
    tool = _jax_script(monkeypatch)
    monkeypatch.setenv("WTW_PHYSICS_BACKEND", "xla")
    seen, jax_build = {}, tool.build_env

    def build_jax(*a, **kw):
        env = jax_build(*a, **kw)
        init = env.init_state

        def scripted(key):
            seen["world"] = _script(init(key), env)
            return seen["world"]
        monkeypatch.setattr(env, "init_state", scripted)
        return env
    monkeypatch.setattr(tool, "build_env", build_jax)
    monkeypatch.setattr(sys, "argv", ["train_vision.py"] + argv)
    with jax.disable_jit():
        tool.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    port_build = train_vision.build_env

    def build_port(*a, **kw):
        env = port_build(*a, **kw)
        monkeypatch.setattr(env, "init_state", lambda seed: (
            parkour_world_from_jax(jax.tree.map(np.asarray, seen["world"]))))
        return env
    monkeypatch.setattr(train_vision, "build_env", build_port)
    got = train_vision.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == got
    assert got == want
    assert want["episodes"] == 3 and want["mean_episode_len_s"] > 0


class _Tables:
    """A scripted course: poses over a bumpy field, obs[t] + tanh(a) @ M,
    rewards moved by the actions, hard dones with their distances (two past
    0.8 of the 12 m track) and episode lengths."""
    T = 8

    def __init__(self, seed=0):
        rng = np.random.RandomState(seed)
        f = lambda *s: rng.randn(*s).astype(np.float32)
        T = self.T
        self.heights = 0.05 * f(40, 40)
        self.heights[25:, :] += 0.3
        self.pos = np.stack([np.c_[0.2 * t + rng.uniform(-.1, .1, N),
                                   rng.uniform(-.5, .5, N),
                                   0.32 + 0.02 * rng.randn(N)]
                             for t in range(T + 1)]).astype(np.float32)
        q = np.c_[0.03 * rng.randn((T + 1) * N, 3), np.ones((T + 1) * N)]
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        self.quat = q.reshape(T + 1, N, 4).astype(np.float32)
        self.jq = (np.tile([0.1, 0.8, -1.5, -0.1, 0.8, -1.5, 0.1, 1.0, -1.5,
                            -0.1, 1.0, -1.5], (T + 1, N, 1))
                   + 0.2 * rng.randn(T + 1, N, 12)).astype(np.float32)
        self.obs0, self.obs = f(N, 60), f(T, N, 60)
        self.m = 0.1 * f(12, 60)
        self.rew = f(T, N)
        self.hard = np.zeros((T, N), bool)
        self.hard[[1, 3, 3, 6, 7], [2, 0, 5, 2, 4]] = True
        self.dist = rng.uniform(0, 9, (T, N)).astype(np.float32)
        self.dist[3, 0], self.dist[6, 2] = 10.1, 11.0
        self.eplen = rng.randint(0, 500, T).astype(np.int32)


def _world(tb, t, mk):
    import types
    phys = types.SimpleNamespace(base_pos=mk(tb.pos[t]),
                                 base_quat=mk(tb.quat[t]),
                                 joint_q=mk(tb.jq[t]))
    return types.SimpleNamespace(t=t, env=types.SimpleNamespace(phys=phys))


def _stub_env(tb, jax_side):
    """The scripted course as either package's env."""
    import types
    if jax_side:
        import jax.numpy as jnp
        from wtw_tpu.models import load_robot
        from wtw_tpu.physics.heightfield import make_heightfield
        mk, tanh, model = jnp.asarray, jnp.tanh, load_robot("go2")
        hf = make_heightfield(jnp.asarray(tb.heights), 0.1,
                              jnp.asarray([-1.0, -2.0]))
    else:
        from wtw_tpu_torch.models import load_robot
        from wtw_tpu_torch.physics.heightfield import make_heightfield
        mk, tanh, model = torch.from_numpy, torch.tanh, load_robot("go2")
        hf = make_heightfield(tb.heights, 0.1, [-1.0, -2.0])

    def step(world, a):
        t = world.t
        obs = mk(tb.obs[t]) + tanh(a) @ mk(tb.m)
        rew = mk(tb.rew[t]) - 0.01 * (a * a).sum(-1)
        return (_world(tb, t + 1, mk), obs, rew, mk(np.zeros(N, np.float32)),
                {"true_dones": mk(tb.hard[t]), "dist_at_done": mk(tb.dist[t]),
                 "episode_len_at_reset": mk(np.asarray(tb.eplen[t]))})
    return types.SimpleNamespace(
        num_envs=N, num_actions=12, dt=0.02, track_length=12.0, hf=hf,
        model=model, device=torch.device("cpu"), step=step,
        init_state=lambda key: _world(tb, 0, mk),
        get_observations=lambda world: mk(tb.obs0))


def test_eval_on_a_scripted_env_prints_the_jax_json(monkeypatch, capsys):
    tb = _Tables()
    argv = ["eval", "--student", STUDENT, "--num-envs", str(N), "--steps",
            str(tb.T)]
    tool = _jax_script(monkeypatch)
    monkeypatch.setattr(tool, "build_env", lambda *a, **k: _stub_env(tb,
                                                                     True))
    monkeypatch.setattr(sys, "argv", ["train_vision.py"] + argv)
    with jax.disable_jit():
        tool.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(train_vision, "build_env",
                        lambda *a, **k: _stub_env(tb, False))
    got = train_vision.main(argv + ["--device", "cpu"])
    assert got == want
    assert want["episodes"] == 5 and want["track_cross_rate"] == 0.4


BLOCKED = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "wtw_tpu"):
    sys.modules[name] = None
from wtw_tpu_torch import train_vision
train_vision.main(sys.argv[1:])
leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "flax", "optax", "ml_dtypes",
                                        "wtw_tpu"))
print("LEAKED", leaked)
"""


def test_port_trains_from_a_jax_demo_file_without_ml_dtypes(tmp_path,
                                                            monkeypatch,
                                                            capsys):
    tool = _jax_script(monkeypatch)
    monkeypatch.setenv("WTW_PHYSICS_BACKEND", "xla")
    monkeypatch.setattr(sys, "argv", [
        "train_vision.py", "generate", "--num-envs", str(N), "--steps", "1",
        "--out", str(tmp_path)] + sets(SMALL))
    with jax.disable_jit():
        tool.main()
    capsys.readouterr()
    pkl = str(tmp_path / "rb_demos.pkl")
    with open(pkl, "rb") as f:
        jbuf = pickle.load(f)
    assert jbuf.obs.dtype.name == "bfloat16"
    buf = D.load_buffer(pkl)
    for f in D.SeqBuffer.TENSORS:
        got, want = getattr(buf, f), np.asarray(getattr(jbuf, f))
        if got.dtype == torch.bfloat16:
            got, want = got.view(torch.int16), want.view(np.int16)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    assert (buf.pos, buf.filled) == (1, 1)
    assert buf.obs.shape == (64, N, 45) and buf.priv.shape == (64, N, 189)

    out = tmp_path / "student"
    res = subprocess.run(
        [sys.executable, "-c", BLOCKED, "train", "--demos", pkl, "--device",
         "cpu", "--num-envs", str(N), "--env-steps", "72", "--bc-steps", "2",
         "--out", str(out)] + sets(SMALL), cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
        capture_output=True,
        text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "LEAKED []" in res.stdout
    assert "bc     2/2" in res.stdout and "vision student ->" in res.stdout
    blob = torch.load(out / "vision_student.pt", weights_only=True)
    assert set(blob) == {"student", "ddpg_args"}


def test_cli_on_the_cpu(tmp_path, capsys):
    """generate (a JAX CaT expert, actor 32-16) -> train -> eval."""
    from wtw_tpu.learn import cat_ppo as jcat
    env = train_vision.build_env(N, 0, overrides=SMALL, device="cpu")
    ts = jcat.init_train_state(jax.random.PRNGKey(1), env,
                               jcat.CatPPOArgs(hidden=(32, 16)))
    expert = str(tmp_path / "cat.pkl.gz")
    with gzip.open(expert, "wb") as f:
        pickle.dump({"ts": jax.device_get(ts)}, f)
    common = ["--device", "cpu", "--num-envs", str(N)] + sets(SMALL)
    gen = train_vision.main(["generate", "--checkpoint", expert, "--steps",
                             "6", "--out", str(tmp_path)] + common)
    assert gen["filled"] == 6 and gen["out"].endswith("rb_demos.pt")
    assert gen["nbytes"] == 64 * N * (45 * 2 + 189 * 2 + 48 * 48 + 12 * 4
                                      + 3 * 4 + 256 * 2)
    demos = D.load_buffer(gen["out"])
    assert float(demos.actions[:6].abs().sum()) > 0     # the expert acted
    tr = train_vision.main(["train", "--demos", gen["out"], "--env-steps",
                            "96", "--bc-steps", "3", "--ring-steps", "16",
                            "--actor-delay", "80", "--out",
                            str(tmp_path)] + common)
    ln = tr["learner"]
    assert tr["ring"].obs.shape[0] == 64          # --ring-steps floor: 64
    assert ln.step == 2                           # steps 10 and 11 live
    assert all(np.isfinite(float(v)) for v in ln.last_losses.values())
    out = capsys.readouterr().out
    assert "bc     3/3" in out and "vision student ->" in out
    ev = train_vision.main(["eval", "--student", tr["out"], "--steps", "3"]
                           + common)
    assert ev["policy"] == "student" and ev["num_envs"] == N
    assert json.loads(capsys.readouterr().out.strip()) == ev
    with pytest.raises(SystemExit):
        train_vision.main(["eval"] + common)
