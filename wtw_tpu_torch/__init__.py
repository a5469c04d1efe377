"""wtw_tpu_torch — the PyTorch/CUDA port of `wtw_tpu`.

A second package beside the JAX one, with the same module layout so each
port module has an obvious counterpart:

- ``wtw_tpu_torch.physics`` — the batched env-minor engine; its two Pallas
  kernels (`wtw_tpu/physics/batched.py` `_pallas_fk`, `_pallas_dynamics`)
  are CUDA C++ kernels under ``csrc/`` with plain-PyTorch versions beside
  them (`physics/kernels.py`).
- ``wtw_tpu_torch.envs``    — `LeggedEnv` (batched backend, flat ground or
  Stack-A terrain, PD control or the actuator net, the gait clock, or a
  mixed-robot batch from `envs.multi_env`), `ParkourEnv`, the
  actuator-model wrapper, and the depth camera (`envs.depth`).
- ``wtw_tpu_torch.terrain`` — the Stack-A and parkour maps (numpy).
- ``wtw_tpu_torch.learn``   — PPO with concurrent state estimation and the
  `Runner`, the CaT learners, RMA, PBT, DDPG with demos for the depth
  student (`learn.ddpg_demos`) and the actuator-net trainer.
- ``wtw_tpu_torch.models``  — robot specs (one robot, or stacked and
  assigned to envs by `models.multi`), the actor-critic and the actuator
  net.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. The
package imports torch and numpy only — never jax, flax, optax or wtw_tpu.
"""
import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when CUDA is asked for (or defaulted to) and no
    card is present — there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "wtw_tpu_torch: no CUDA device; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
