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
iteration of `train_multi` (go1/go2/b1 at 12 envs).
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, json, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "wtw_tpu")

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
    env = dict(os.environ, PYTHONPATH=ROOT)
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
                "wtw_tpu_torch.train_multi"):
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
