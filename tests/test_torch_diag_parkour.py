"""Parity of the port's `diag_parkour` (on the CPU) with the JAX package's
`tools/diag_parkour.py`: both tools run on the same JAX `.pkl`, from the
same world, and must print the same JSON.

The JAX tool runs as its `main`, un-jitted (`jax.disable_jit()`: jitting
the parkour step takes ~3 min on the CPU) on its batched XLA path
(`WTW_PHYSICS_BACKEND=xla`), at the small course of tests/test_parkour.py
(3 levels x 5 track types, a 4 m border) with the observation noise and
the pushes off. Its world after `restore_terrain_state` is scripted so
that first episodes end on the first step for known reasons (upside down,
a timeout short of or past 0.8 of the track) and is handed to the port
through `parkour_world_from_jax`. Every first episode ends on step 1,
before any reset has drawn from a generator that the other side cannot
match, so the attribution is exact on both sides; the other envs run on.
"""
import gzip
import importlib.util
import json
import os
import pickle
import sys

import jax
import numpy as np
import pytest

from wtw_tpu.learn import cat_ppo as jcat

from wtw_tpu_torch import diag_parkour
from wtw_tpu_torch.convert import parkour_world_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8
SMALL = ["terrain.num_levels=3", "terrain.num_terrains=5",
         "terrain.border_size=4.0", "add_noise=false", "push_robots=false"]
# per env: (upside down, timeout on step 1, x along the track in m)
SCRIPTS = {
    "mixed": [(True, False, None), (False, True, 10.5), (False, True, 3.0),
              (True, True, 6.0)] + [(False, False, None)] * 4,
    "all_done": [(True, False, None), (False, True, 10.5), (False, True, 3.0),
                 (True, True, 6.0), (False, True, 11.0), (False, True, 0.0),
                 (True, False, None), (False, True, 7.5)],
}


def _jax_tool():
    """tools/diag_parkour.py as a module (it puts scripts/ on sys.path, so
    `train_vision` imports after it)."""
    spec = importlib.util.spec_from_file_location(
        "jax_diag_parkour_tool", os.path.join(ROOT, "tools", "diag_parkour.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    import train_vision
    return mod, train_vision


def _script(world, env, rows):
    """The JAX world after `restore_terrain_state`, with each env's base
    turned upside down, its progress one step short of the episode's end,
    and its base moved along the track, as `rows` says."""
    e = world.env
    pos, quat = np.array(e.phys.base_pos), np.array(e.phys.base_quat)
    progress = np.array(e.progress)
    origin = np.asarray(e.env_origin)
    for i, (flip, timeout, x) in enumerate(rows):
        if flip:
            quat[i] = (1.0, 0.0, 0.0, 0.0)            # (x, y, z, w): pi about x
        if timeout:
            progress[i] = env.max_episode_length - 1
        if x is not None:
            pos[i, 0] = origin[i, 0] + x
    phys = e.phys.replace(base_pos=jax.numpy.asarray(pos),
                          base_quat=jax.numpy.asarray(quat))
    return world.replace(env=e.replace(
        phys=phys, progress=jax.numpy.asarray(progress)))


@pytest.fixture(scope="module")
def cat_pkl(tmp_path_factory):
    """A JAX CaT train state at its init (actor 32-16), pickled as the JAX
    scripts write it (`{"ts": ...}`)."""
    env = diag_parkour.build_env(N, 0, terrain="gap", overrides=SMALL,
                                 device="cpu")
    ts = jcat.init_train_state(jax.random.PRNGKey(1), env,
                               jcat.CatPPOArgs(hidden=(32, 16)))
    path = str(tmp_path_factory.mktemp("diag") / "cat.pkl.gz")
    with gzip.open(path, "wb") as f:
        pickle.dump({"ts": jax.device_get(ts)}, f)
    return path


@pytest.mark.parametrize("case,steps", [("mixed", 4), ("all_done", 10)])
def test_diag_parkour_matches_the_jax_tool(cat_pkl, case, steps, monkeypatch,
                                           capsys):
    """The port's `diag_parkour.main` prints the JAX tool's JSON, key for
    key and value for value, on the same file and world. In "mixed" four
    envs are still alive after the 4 steps (their furthest x is compared);
    in "all_done" every first episode is over on step 1: the JAX tool
    stops there, the port at its next check (every 2 steps here), and the
    attribution is the same."""
    tool, train_vision = _jax_tool()
    monkeypatch.setenv("WTW_PHYSICS_BACKEND", "xla")
    seen = {}
    jax_build = train_vision.build_env

    def build_jax(*a, **kw):
        env = jax_build(*a, **kw)
        restore = env.restore_terrain_state

        def scripted(world, lvl):
            seen["world"] = _script(restore(world, lvl), env, SCRIPTS[case])
            return seen["world"]
        monkeypatch.setattr(env, "restore_terrain_state", scripted)
        return env
    monkeypatch.setattr(train_vision, "build_env", build_jax)
    flags = ["--checkpoint", cat_pkl, "--terrain", "gap", "--level", "0",
             "--num-envs", str(N), "--steps", str(steps)]
    for s in SMALL:
        flags += ["--set", s]
    monkeypatch.setattr(sys, "argv", ["diag_parkour.py"] + flags)
    with jax.disable_jit():
        tool.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    port_build, port_run, ran = diag_parkour.build_env, diag_parkour.run, []

    def build_port(*a, **kw):
        env = port_build(*a, **kw)
        monkeypatch.setattr(env, "restore_terrain_state", lambda w, lvl:
                            parkour_world_from_jax(jax.tree.map(
                                np.asarray, seen["world"])))
        return env

    def run_port(*a, **kw):
        traces, t = port_run(*a, check_every=2, **kw)
        ran.append(t)
        return traces, t
    monkeypatch.setattr(diag_parkour, "build_env", build_port)
    monkeypatch.setattr(diag_parkour, "run", run_port)
    got = diag_parkour.main(flags + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == got
    assert got == want
    rows = SCRIPTS[case]
    done = sum(1 for flip, timeout, _ in rows if flip or timeout)
    assert want["first_episodes_done"] == done
    assert want["still_alive"] == N - done
    assert want["reasons"]["upsidedown"] == sum(r[0] for r in rows)
    assert want["cross_rate"] > 0.0
    assert ran == [2 if case == "all_done" else steps]
