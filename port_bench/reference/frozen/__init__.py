"""A frozen copy of the port's plain code at the commit that defined the
benchmark: the config tree, the two envs (`LeggedEnv`, `ParkourEnv`), the
terrain builders, the robot data and the plain physics (`fk_core`,
`dynamics_core`), with `physics/kernels.py` replaced by the plain
versions. The benchmark's reference runs it in place of the program's env
step, so a later change to the program is held to this code and not to
itself. Imports torch and numpy only, and nothing of the port."""
import torch


def resolve_device(device=None) -> torch.device:
    return torch.device("cuda" if device is None else device)
