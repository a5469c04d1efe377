"""Learned actuator network: the per-joint torque model (port of
`wtw_tpu/models/actuator_net.py`).

The reference ships TorchScript MLPs (resources/actuator_nets/unitree_go1.pt,
loaded at legged_robot.py:1238-1253) with architecture 6->32->32->1 and
softsign activations (scripts/actuator_net/utils.py:91): inputs are
(pos_err, pos_err@t-1, pos_err@t-2, vel, vel@t-1, vel@t-2) per joint.

The weights are the JAX package's converted `.npz` files (w0, b0, w1, b1,
w2, b2; weights stored (in, out)), of which the port keeps its own copies
under `models/data/`. The three products are plain `torch.matmul` in fp32
(the callers switch TF32 off on CUDA).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def load_actuator_net(name_or_path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Load converted weights (.npz with w0, b0, w1, b1, w2, b2): a path, or
    a name under the port's `models/data/` (e.g. "actuator_go1")."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(_DATA_DIR, f"{name_or_path}.npz")
    raw = np.load(path)
    return {k: torch.as_tensor(np.asarray(raw[k], np.float32), device=device)
            for k in raw.files}


def softsign(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + torch.abs(x))


def apply_actuator_net(params: Dict[str, torch.Tensor], pos_err, pos_err_last,
                       pos_err_last_last, vel, vel_last,
                       vel_last_last) -> torch.Tensor:
    """Evaluate the torque model for all joints at once.

    Inputs share one shape ((N, nj) in the env); the net runs per joint on
    the 6-feature vector (legged_robot.py:1242-1251). Returns torques of the
    inputs' shape."""
    x = torch.stack([pos_err, pos_err_last, pos_err_last_last,
                     vel, vel_last, vel_last_last], dim=-1)     # (..., 6)
    n_layers = len(params) // 2
    for i in range(n_layers):
        x = torch.matmul(x, params[f"w{i}"]) + params[f"b{i}"]
        if i < n_layers - 1:
            x = softsign(x)
    return x[..., 0]
