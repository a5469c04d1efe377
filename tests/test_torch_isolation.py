"""The port stands alone: no module of wtw_tpu_torch, and not chip_smoke.py,
imports jax, flax, optax or the JAX package (the GPU machine has none of
them). A subprocess blocks those names with a meta-path finder, imports
every module of the port and chip_smoke, and runs chip_smoke's three
training phases (go1_flat, Go2 parkour on a 3 x 5 course, and go1_mob on a
3 x 3-cell map) on the CPU at 16 envs, 1 iteration and narrow widths.
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
rec = chip_smoke.phase_training(
    "cpu", num_envs=16, iterations=1, warmup=0,
    overrides=["ac.actor_hidden_dims=32,16", "ac.critic_hidden_dims=32,16",
               "ac.adaptation_hidden_dims=16"])
pk = chip_smoke.phase_parkour_training(
    "cpu", num_envs=16, iterations=1, warmup=0,
    overrides=["terrain.num_levels=3", "terrain.num_terrains=5",
               "terrain.border_size=4.0", "ppo.hidden=32,16"])
mob = chip_smoke.phase_mob_training(
    "cpu", num_envs=16, iterations=1, warmup=0,
    overrides=["terrain.num_rows=3", "terrain.num_cols=3",
               "ac.actor_hidden_dims=32,16", "ac.critic_hidden_dims=32,16",
               "ac.adaptation_hidden_dims=16"])
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"modules": names, "leaked": leaked,
                  "losses": rec["losses"], "launches": rec["launches"],
                  "parkour": pk, "mob": mob}))
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
                "wtw_tpu_torch.models.actuator_net"):
        assert mod in out["modules"]
    pk, mob = out["parkour"], out["mob"]
    for losses in (out["losses"], pk["losses"], mob["losses"]):
        assert all(abs(v) < 1e6 for v in losses.values())
    assert pk["num_obs"] == 189 and not pk["ceiling_flat"]
    assert (mob["num_obs"], mob["num_obs_history"]) == (70, 2100)
    assert mob["control_type"] == "actuator_net"
    assert mob["heightfield_shape"] == [150, 150]
    assert not mob["heightfield_flat"]
    # the CPU path runs the plain versions: no kernel launches
    assert out["launches"] == {"fk": 0, "dynamics": 0}
    assert pk["launches"] == {"fk": 0, "dynamics": 0}
    assert mob["launches"] == {"fk": 0, "dynamics": 0}
