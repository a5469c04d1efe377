"""The port stands alone: no module of wtw_tpu_torch, and not chip_smoke.py,
imports jax, flax, optax or the JAX package (the GPU machine has none of
them). A subprocess blocks those names with a meta-path finder, imports
every module of the port and chip_smoke, and runs chip_smoke's training
phases (go1_flat, Go2 parkour on a 3 x 5 course, go1_mob on a 3 x 3-cell
map, Go2Terrain on a 3 x 3-cell map in both reward modes, the presets
go2_flat, b1_flat, mini_cheetah_flat, go2_mob and b1_mob, the last two on
3 x 3 cells, and the learners ppo_plus and ppornn on the 3 x 5 course,
rma and a 2-member pbt on go1_flat) on the CPU at 16 envs, 1 iteration
(2 for pbt, which ends with an exploit) and narrow widths, and one
iteration of `train_multi` (go1/go2/b1 at 12 envs). A second subprocess,
with the same block, resumes JAX checkpoints (`.pkl`, written by this test
with the JAX package) through both training CLIs and runs chip_smoke's
eval phases (play, eval_gaits, diag_parkour) on the CPU on policies it
trains, then its vision phases (train_vision generate, train, eval of the
student and of the expert, at 8 envs on the 3 x 5 course), actuator_train
(3 epochs) and a 2-point sweep of go1_flat at 16 envs. A third, with the
same block, runs the tenth slice's phases at small size: go1_mob with bf16
products (16 envs, a 3 x 3-cell map, narrow widths), 2 gloo ranks against
1 on go1_flat (16 envs) and on the 3 x 5 parkour course (8 envs), each
rank a process of chip_smoke.py on CPU tensors, and `record_rollout` of a
go1_mob policy (8 envs, 8 steps); matplotlib and
`torch.utils.tensorboard` are imported only where they are used.
`ml_dtypes` is blocked too: the port reads JAX's bf16 demo files without
it. The subprocesses run with one OpenMP thread: at 8-16 envs they gain
nothing from more, and the suite's other workers share the cores.
"""
import gzip
import json
import os
import pickle
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, json, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "wtw_tpu")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import wtw_tpu_torch
names = ["wtw_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(wtw_tpu_torch.__path__,
                                          "wtw_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
narrow = ["ac.actor_hidden_dims=32,16", "ac.critic_hidden_dims=32,16",
          "ac.adaptation_hidden_dims=16", "ppo.num_steps_per_env=4"]
small_map = ["terrain.num_rows=3", "terrain.num_cols=3"]
train = lambda preset, extra=(): chip_smoke.phase_preset_training(
    preset, "cpu", num_envs=16, iterations=1, warmup=0,
    overrides=narrow + list(extra))
rec = train("go1_flat")
pk = chip_smoke.phase_parkour_training(
    "cpu", num_envs=16, iterations=1, warmup=0,
    overrides=["terrain.num_levels=3", "terrain.num_terrains=5",
               "terrain.border_size=4.0", "ppo.hidden=32,16"])
mob = train("go1_mob", small_map)
terrain_small = ["rough_terrain.num_rows=3", "rough_terrain.num_cols=3",
                 "rough_terrain.border_size=1.0", "ppo.hidden=32,16"]
terrain = {mode: chip_smoke.phase_parkour_training(
    "cpu", num_envs=16, iterations=1, warmup=0, overrides=terrain_small,
    task="terrain", reward_mode=mode) for mode in ("cat", "full")}
presets = {p: train(p, small_map if p.endswith("_mob") else ())
           for p in ("go2_flat", "b1_flat", "mini_cheetah_flat", "go2_mob",
                     "b1_mob")}
course = ["terrain.num_levels=3", "terrain.num_terrains=5",
          "terrain.border_size=4.0", "ppo.hidden=32,16"]
learners = {algo: chip_smoke.phase_parkour_training(
    "cpu", num_envs=16, iterations=1, warmup=0, overrides=course,
    algo=algo) for algo in ("ppo_plus", "ppornn")}
learners["rma"] = chip_smoke.phase_preset_training(
    "go1_flat", "cpu", num_envs=16, iterations=1, warmup=0,
    overrides=narrow, algo="rma")
learners["pbt"] = chip_smoke.phase_pbt_training(
    "cpu", num_envs=16, overrides=narrow)
import tempfile
from wtw_tpu_torch.train_multi import build as build_multi
_, multi = build_multi(("go1", "go2", "b1"), 12, narrow, "cpu",
                       run_dir=tempfile.mkdtemp(), log_freq=1)
multi.learn(1, log_fn=lambda *a: None)
multi_rew = multi.last_per_robot.tolist()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"modules": names, "leaked": leaked,
                  "losses": rec["losses"], "launches": rec["launches"],
                  "parkour": pk, "mob": mob, "terrain": terrain,
                  "presets": presets, "learners": learners,
                  "multi_rew": multi_rew}))
"""


def test_port_imports_no_jax_and_trains_on_cpu():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    for mod in ("wtw_tpu_torch.physics.kernels", "wtw_tpu_torch.train",
                "wtw_tpu_torch.convert", "wtw_tpu_torch.learn.runner",
                "wtw_tpu_torch.terrain", "wtw_tpu_torch.terrain.parkour",
                "wtw_tpu_torch.terrain.generators",
                "wtw_tpu_torch.envs.parkour_env",
                "wtw_tpu_torch.envs.constraints",
                "wtw_tpu_torch.learn.cat_ppo", "wtw_tpu_torch.train_parkour",
                "wtw_tpu_torch.terrain.stack_a", "wtw_tpu_torch.envs.gait",
                "wtw_tpu_torch.envs.wrappers",
                "wtw_tpu_torch.models.actuator_net",
                "wtw_tpu_torch.learn.cat_ppo_plus",
                "wtw_tpu_torch.learn.cat_ppornn",
                "wtw_tpu_torch.learn.ppo_rma", "wtw_tpu_torch.learn.pbt",
                "wtw_tpu_torch.models.multi", "wtw_tpu_torch.envs.multi_env",
                "wtw_tpu_torch.train_multi",
                "wtw_tpu_torch.learn.jax_checkpoint",
                "wtw_tpu_torch.learn.eval_metrics",
                "wtw_tpu_torch.learn.metrics_caches",
                "wtw_tpu_torch.utils.monitor", "wtw_tpu_torch.utils.keyboard",
                "wtw_tpu_torch.play", "wtw_tpu_torch.eval_gaits",
                "wtw_tpu_torch.diag_parkour", "wtw_tpu_torch.smoke",
                "wtw_tpu_torch.envs.depth", "wtw_tpu_torch.learn.ddpg_demos",
                "wtw_tpu_torch.learn.actuator_train",
                "wtw_tpu_torch.train_vision", "wtw_tpu_torch.sweep",
                "wtw_tpu_torch.parallel", "wtw_tpu_torch.parallel.mesh",
                "wtw_tpu_torch.utils.video"):
        assert mod in out["modules"]
    assert len(out["multi_rew"]) == 3
    assert all(abs(v) < 1e6 for v in out["multi_rew"])
    pk, mob, terrain = out["parkour"], out["mob"], out["terrain"]
    presets, learners = out["presets"], out["learners"]
    for losses in [out["losses"], pk["losses"], mob["losses"]] + [
            r["losses"] for r in list(terrain.values())
            + list(presets.values()) + list(learners.values())]:
        assert all(abs(v) < 1e6 for v in losses.values())
    assert set(learners["ppo_plus"]["losses"]) == {"loss", "pg_loss",
                                                   "value_loss", "q_loss"}
    imp = learners["ppo_plus"]["improvement"]
    assert imp["q_after"] > imp["q_before"]
    assert learners["ppornn"]["hiddens"]["ac_hidden_mean_abs"] > 0
    for algo in ("ppo_plus", "ppornn"):
        assert learners[algo]["dynamics_calls_with_ceiling"] == 96
    assert learners["rma"]["algo"] == "rma"
    ex = learners["pbt"]["exploit"]
    assert len(ex["bottom"]) == 1 and 0.8 <= ex["lr_factor"][0] <= 1.25
    for r in learners.values():
        assert r["launches"] == {"fk": 0, "dynamics": 0}
    assert pk["num_obs"] == 189 and not pk["ceiling_flat"]
    # every kernel B call of the 24 x 4 substeps carries the ceiling
    assert pk["dynamics_calls_with_ceiling"] == 96
    for mode, rec in terrain.items():
        assert (rec["task"], rec["reward_mode"]) == ("terrain", mode)
        assert not rec["has_ceiling"] and rec["ceiling_flat"] is None
        assert rec["dynamics_calls_with_ceiling"] == 0
        assert rec["actuator_net"] and rec["gait_clock"]
        assert rec["num_obs"] == 193 and rec["heightfield_shape"] == [170, 170]
        assert rec["launches"] == {"fk": 0, "dynamics": 0}
    robots = {"go2_flat": "go2_description", "b1_flat": "b1_description",
              "mini_cheetah_flat": "mini_cheetah",
              "go2_mob": "go2_description", "b1_mob": "b1_description"}
    for preset, rec in presets.items():
        assert rec["robot"] == robots[preset]
        assert rec["heightfield_flat"] == preset.endswith("_flat")
        assert rec["launches"] == {"fk": 0, "dynamics": 0}
    assert presets["go2_mob"]["control_type"] == "actuator_net"
    assert presets["b1_mob"]["control_type"] == "P"
    assert presets["b1_mob"]["heightfield_shape"] == [150, 150]
    assert (mob["num_obs"], mob["num_obs_history"]) == (70, 2100)
    assert mob["control_type"] == "actuator_net"
    assert mob["heightfield_shape"] == [150, 150]
    assert not mob["heightfield_flat"]
    # the CPU path runs the plain versions: no kernel launches
    assert out["launches"] == {"fk": 0, "dynamics": 0}
    assert pk["launches"] == {"fk": 0, "dynamics": 0}
    assert mob["launches"] == {"fk": 0, "dynamics": 0}


EVAL_SCRIPT = r"""
import json, os, sys, tempfile
BLOCKED = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "wtw_tpu")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import chip_smoke
from wtw_tpu_torch.train import main as train
from wtw_tpu_torch.train_parkour import main as train_parkour
stack_a, parkour, out_dir = sys.argv[1:4]
narrow = ["ac.actor_hidden_dims=32,16", "ac.critic_hidden_dims=32,16",
          "ac.adaptation_hidden_dims=16", "ppo.num_steps_per_env=4"]
course = ["terrain.num_levels=3", "terrain.num_terrains=5",
          "terrain.border_size=4.0"]
sets = lambda xs: [a for x in xs for a in ("--set", x)]
train(["--device", "cpu", "--num-envs", "16", "--iterations", "1",
       "--run-dir", os.path.join(out_dir, "a"), "--resume", stack_a]
      + sets(narrow))
train_parkour(["--device", "cpu", "--num-envs", "16", "--iterations", "1",
               "--horizon", "4", "--run-dir", os.path.join(out_dir, "b"),
               "--resume", parkour] + sets(course + ["ppo.hidden=32,16"]))
ck = {k: os.path.join(out_dir, k + ".pt") for k in ("mob", "parkour")}
chip_smoke.phase_preset_training(
    "go1_mob", "cpu", num_envs=16, iterations=1, warmup=0,
    overrides=narrow + ["terrain.num_rows=3", "terrain.num_cols=3"],
    checkpoint_to=ck["mob"])
chip_smoke.phase_parkour_training(
    "cpu", num_envs=16, iterations=1, warmup=0,
    overrides=course + ["ppo.hidden=32,16"], checkpoint_to=ck["parkour"])
play = chip_smoke.phase_eval_play(
    ck["mob"], "cpu", runs=((8, None, True), (12, None, False),
                            (8, "rand_large", False)), steps=4)
gaits = chip_smoke.phase_eval_gaits(ck["mob"], "cpu", num_envs=8, steps=4)
diag = chip_smoke.phase_diag_parkour(ck["parkour"], "cpu", num_envs=16,
                                     steps=8, overrides=course)
demos = os.path.join(out_dir, "rb_demos.pt")
vision = {"generate": chip_smoke.phase_vision_generate(
    ck["parkour"], demos, "cpu", num_envs=8, steps=6, overrides=course)}
vision["train"] = chip_smoke.phase_vision_train(
    demos, out_dir, "cpu", num_envs=8, env_steps=80, bc_steps=2,
    actor_delay=72, overrides=course)
vision["eval_student"] = chip_smoke.phase_vision_eval(
    os.path.join(out_dir, "vision_student.pt"), "cpu", num_envs=8, steps=4,
    overrides=course)
vision["eval_expert"] = chip_smoke.phase_vision_eval(
    ck["parkour"], "cpu", num_envs=8, steps=4, student=False,
    overrides=course)
for r in vision.values():
    r.pop("result", None)
act = chip_smoke.phase_actuator_train("cpu", epochs=3)
sw = chip_smoke.phase_sweep("cpu", num_envs=16, overrides=narrow)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
rows = lambda d: open(os.path.join(out_dir, d, "metrics.csv")).read()
print(json.dumps({"leaked": leaked, "play": play, "gaits": gaits,
                  "diag": diag, "vision": vision, "actuator": act,
                  "sweep": sw,
                  "first_row": {d: rows(d).splitlines()[1].split(",")[0]
                                for d in ("a", "b")}}))
"""


def _jax_slim_files(tmp_path):
    """Slim checkpoints as tools/slim_checkpoint.py writes them, made with
    the JAX package at the port's go1_flat and parkour widths (narrow
    hidden layers): -> (Stack-A path, parkour path)."""
    import jax
    import numpy as np
    from wtw_tpu import config as jcfg
    from wtw_tpu.envs.constraints import CaTState
    from wtw_tpu.envs.curriculum import CurriculumState
    from wtw_tpu.learn import cat_ppo as jcat
    from wtw_tpu.learn import ppo_cse as jppo
    from wtw_tpu.models import actor_critic as jac
    from wtw_tpu_torch.envs import make_legged_env
    from wtw_tpu_torch.train_parkour import build as build_parkour
    from wtw_tpu_torch import config as tcfg

    env = make_legged_env(tcfg.go1_flat_config(num_envs=16), device="cpu")
    ts = jppo.init_train_state(
        jax.random.PRNGKey(0), env, jppo.PPOArgs(),
        jac.ACArgs(actor_hidden_dims=(32, 16), critic_hidden_dims=(32, 16),
                   adaptation_hidden_dims=(16,)))
    weights = env.init_state(0).curriculum_weights.numpy()
    stack_a = str(tmp_path / "go1_flat_slim.pkl.gz")
    with gzip.open(stack_a, "wb") as f:
        pickle.dump({"slim": True, "ts": jax.device_get(ts),
                     "curriculum": CurriculumState(weights=weights + 0.5),
                     "common_step": np.int32(7),
                     "cfg": jcfg.go1_flat_config()}, f)
    runner = build_parkour(16, ["terrain.num_levels=3",
                                "terrain.num_terrains=5",
                                "terrain.border_size=4.0"], "cpu",
                           run_dir=str(tmp_path / "p"))
    penv = runner.env
    cts = jcat.init_train_state(jax.random.PRNGKey(1), penv,
                                jcat.CatPPOArgs(hidden=(32, 16)))
    parkour = str(tmp_path / "parkour_slim.pkl.gz")
    with gzip.open(parkour, "wb") as f:
        pickle.dump({"slim": True, "stack": "b", "ts": jax.device_get(cts),
                     "terrain_level": np.full(16, 1, np.int32),
                     "terrain_type": np.arange(16, dtype=np.int32) % 5,
                     "cat": CaTState(running_max=np.ones_like(
                         penv.cstr.init_state().running_max.numpy())),
                     "soft_p_progress": np.float32(0.25),
                     "common_step": np.int32(3), "iteration": 0}, f)
    return stack_a, parkour


def test_port_resumes_jax_files_and_evaluates_without_jax(tmp_path):
    stack_a, parkour = _jax_slim_files(tmp_path)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", EVAL_SCRIPT, stack_a,
                          parkour, str(tmp_path)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    assert out["first_row"] == {"a": "0", "b": "0"}
    runs = out["play"]["runs"]
    assert sorted(runs) == ["12_envs", "8_envs", "8_envs_rand_large"]
    assert runs["8_envs"]["summary"]["gait"]["dominant_gait"] in (
        "trot", "pace", "bound", "pronk")
    assert runs["8_envs_rand_large"]["summary"]["sweep"] == "rand_large"
    assert out["gaits"]["cases"] == 5
    diag = out["diag"]
    assert diag["steps_run"] == 8
    assert diag["diag"]["first_episodes_done"] + diag["diag"][
        "still_alive"] == 16
    # every kernel B call of the run carries the parkour ceiling
    assert diag["dynamics_calls_with_ceiling"] == 8 * 4
    # the CPU path runs the plain versions: no kernel launches
    for r in (out["play"], out["gaits"], diag):
        assert r["launches"] == {"fk": 0, "dynamics": 0}
    # each eval run's last kernel B inputs were held against the plain
    # versions at the run's env count, and its seconds split into set-up
    # and rollouts
    for r, n in [(runs[k], runs[k]["num_envs"]) for k in runs] + [
            (out["gaits"], 8), (diag, 16)]:
        assert r["last_call"]["num_envs"] == n
        assert r["last_call"]["kernel_a_same_bits"]
        assert 0 < r["rollout_s"] <= r["seconds"]
        assert r["build_s"] > 0 and r["env_steps_per_s"] > 0
    assert diag["last_call"]["with_ceiling"]
    assert not runs["8_envs"]["last_call"]["with_ceiling"]
    # the vision phases: every kernel B call with the ceiling (4 a step),
    # a frame a step where the student drives (kernel A's fifth call on
    # the card), both kernels held on each run's last inputs and kernel A
    # on the renderer's
    vision = out["vision"]
    for name, steps, frames in (("generate", 6, 6), ("train", 10, 10),
                                ("eval_student", 4, 4),
                                ("eval_expert", 4, 0)):
        r = vision[name]
        assert r["launches"] == {"fk": 0, "dynamics": 0}
        assert r["dynamics_calls_with_ceiling"] == 4 * steps
        assert r["last_call"]["num_envs"] == 8
        assert r["last_call"]["kernel_a_same_bits"]
        if frames:
            assert r["renderer"]["frames"] == frames
            assert r["renderer"]["kernel_a_max_abs_err"] == 0.0
    tr = vision["train"]
    # rounds from step 8 (8 envs, 64 env steps first), the actor from 9
    assert (tr["bc_batches"], tr["update_rounds"], tr["actor_updates"]) == (
        2, 2, 1)
    assert tr["moved_tensors"] == tr["saved_tensors"] == 22
    assert vision["generate"]["buffer_bytes"] == 64 * 8 * 3344
    assert out["actuator"]["test_mae"] < out["actuator"]["label_std"]
    assert out["sweep"]["rows"] == 2


SLICE_SCRIPT = r"""
import importlib, json, os, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "wtw_tpu")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import wtw_tpu_torch
for m in pkgutil.walk_packages(wtw_tpu_torch.__path__, "wtw_tpu_torch."):
    importlib.import_module(m.name)
lazy = sorted(m for m in ("matplotlib", "torch.utils.tensorboard")
              if m in sys.modules)
import chip_smoke
out_dir = sys.argv[1]
ac = ["ac.actor_hidden_dims=32,16", "ac.critic_hidden_dims=32,16",
      "ac.adaptation_hidden_dims=16"]
small = ac + ["ppo.num_steps_per_env=4", "terrain.num_rows=3",
              "terrain.num_cols=3"]
course = ["terrain.num_levels=3", "terrain.num_terrains=5",
          "terrain.border_size=4.0", "ppo.hidden=32,16"]
bf = chip_smoke.phase_bf16_training("cpu", num_envs=16, iterations=1,
                                    warmup=0, overrides=small)
ck = os.path.join(out_dir, "mob.pt")
chip_smoke.phase_preset_training("go1_mob", "cpu", num_envs=16, iterations=1,
                                 warmup=0, overrides=small, checkpoint_to=ck)
dist = {"go1_flat": chip_smoke.phase_dist(
            "go1_flat", "cpu", num_envs=16, iterations=1, num_steps=4,
            num_minibatches=4, overrides=ac),
        "parkour": chip_smoke.phase_dist(
            "parkour", "cpu", num_envs=8, iterations=1, num_steps=4,
            num_minibatches=2, overrides=course)}
video = chip_smoke.phase_video_record(ck, "cpu", num_envs=8, steps=8)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"leaked": leaked, "lazy": lazy, "bf16": bf,
                  "dist": dist, "video": video}))
"""


def test_port_runs_the_tenth_slice_phases_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", SLICE_SCRIPT, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["leaked"] == [] and out["lazy"] == []
    bf = out["bf16"]
    assert bf["stored_history_dtype"] == "torch.bfloat16"
    assert bf["parameter_dtypes"] == bf["adam_moment_dtypes"] == [
        "torch.float32"]
    assert bf["hidden_activation_dtypes"] == ["torch.bfloat16"]
    assert bf["tower_output_dtypes"] == ["torch.float32"] * 2
    assert bf["first_obs_mean_max_abs_err_vs_fp32"] <= 0.05
    assert bf["last_call"]["kernel_a_same_bits"]
    for name, n_rank in (("go1_flat", 8), ("parkour", 4)):
        d = out["dist"][name]
        assert d["replicas_bitwise_equal"] and d["num_envs_per_rank"] == n_rank
        for rec in d["per_rank"] + [d["one_rank"]]:
            assert rec["launches"] == {"fk": 0, "dynamics": 0}
            assert rec["last_call"]["kernel_a_same_bits"]
    # the course has crawl tracks: every kernel B call carries the ceiling
    for rec in out["dist"]["parkour"]["per_rank"]:
        assert rec["ceiling"] and rec["dynamics_calls_with_ceiling"] == 16
    v = out["video"]
    assert v["shapes"] == [[8, 3], [8, 4], [8, 12]]
    assert v["bitwise_repeatable"] and v["launches"] == {"fk": 0,
                                                         "dynamics": 0}
    assert v["last_call"]["num_envs"] == 8
