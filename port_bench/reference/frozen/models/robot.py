"""Robot model: URDF-derived arrays consumed by the physics engine (port of
`wtw_tpu/models/robot.py`).

`load_robot` reads the port's own copy of the JSON spec under
`wtw_tpu_torch/models/data/` and returns a `RobotModel` holding torch
tensors on the requested device plus a static numpy copy (`model.static`)
that the kernels' constant buffer and the plain versions' Python loops read.

A mixed-robot batch (`models/multi.py`) holds every array field with a
leading env axis, as the JAX package's per-env `RobotModel` does; such a
per-env model also carries the stacked robots it was taken from (`stack`)
and each env's robot index (`assignment`, and `robot` on the device), which
is what the kernels read.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

# contact group labels, fixed ordering
LABELS = ("base", "hip", "thigh", "calf", "foot")

# array fields of the model, in declaration order
ARRAY_FIELDS = (
    "parent", "anc", "joint_pos", "joint_quat", "joint_axis", "joint_lower",
    "joint_upper", "effort_limit", "velocity_limit", "joint_damping",
    "joint_friction", "mass", "com", "inertia", "sph_body", "sph_pos",
    "sph_radius", "sph_label", "sph_leg", "feet_body", "feet_pos",
    "foot_radius")


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Static quadruped description: nb bodies, nj joints, P spheres.

    Every array field is a tensor on `device`; `static` holds the same
    arrays as numpy (int32 / float32). Array fields may carry a leading
    axis (robots of a stack, or envs of a per-env model); the sizes come
    from the names and the last sphere axis. A per-env model has `stack`
    (the R stacked robots) and `assignment` ((N,) robot of each env), and
    `robot` is the assignment as an int32 tensor on `device`."""
    name: str
    joint_names: Tuple[str, ...]
    body_names: Tuple[str, ...]
    fixed_base: bool
    static: Dict[str, np.ndarray]
    device: torch.device
    stack: Optional["RobotModel"] = None
    assignment: Optional[np.ndarray] = None

    def __getattr__(self, key):
        # array fields resolve to device tensors (built once, see load_robot)
        tensors = self.__dict__.get("_tensors")
        if tensors is not None and key in tensors:
            return tensors[key]
        raise AttributeError(key)

    @property
    def nb(self) -> int:
        return len(self.body_names)

    @property
    def nj(self) -> int:
        return len(self.joint_names)

    @property
    def nv(self) -> int:
        return 6 + self.nj

    @property
    def P(self) -> int:
        return int(self.static["sph_body"].shape[-1])

    @property
    def batched(self) -> bool:
        """True when the array fields carry a leading robot or env axis."""
        return self.static["mass"].ndim == 2

    @property
    def parent_static(self) -> Tuple[int, ...]:
        # the tree is one for every robot of a stack or env of a batch
        return tuple(int(p) for p in self.static["parent"].reshape(
            -1, self.nb)[0])

    def to(self, device) -> "RobotModel":
        device = torch.device(device)
        return _make(self.name, self.joint_names, self.body_names,
                     self.fixed_base, self.static, device,
                     None if self.stack is None else self.stack.to(device),
                     self.assignment)

    def take(self, index) -> "RobotModel":
        """The per-env model of a stack: env i gets robot `index[i]`."""
        a = np.asarray(index.cpu() if torch.is_tensor(index) else index,
                       np.int64)
        return _make(self.name, self.joint_names, self.body_names,
                     self.fixed_base, {k: v[a] for k, v in self.static.items()},
                     self.device, self, a.astype(np.int32))


def _make(name, joint_names, body_names, fixed_base, static, device,
          stack=None, assignment=None):
    model = RobotModel(name=name, joint_names=joint_names,
                       body_names=body_names, fixed_base=fixed_base,
                       static=static, device=device, stack=stack,
                       assignment=assignment)
    tensors = {k: torch.as_tensor(v, device=device) for k, v in static.items()}
    if assignment is not None:
        tensors["robot"] = torch.as_tensor(assignment, device=device)
    object.__setattr__(model, "_tensors", tensors)
    return model


def _ancestor_mask(parent: np.ndarray, nj: int) -> np.ndarray:
    """anc[i, d] = 1 if dof d is an ancestor-or-self dof of body i.

    dofs 0..5 are the floating base (always ancestors); dof 6+j moves body
    1+j (moving joint j's child is body j+1 by construction of the
    extractor)."""
    nb = parent.shape[0]
    anc = np.zeros((nb, 6 + nj), dtype=np.float32)
    anc[:, :6] = 1.0
    for i in range(1, nb):
        b = i
        while b > 0:
            anc[i, 6 + (b - 1)] = 1.0
            b = parent[b]
    return anc


def load_robot(name_or_path: str, device="cpu") -> RobotModel:
    """Load a robot spec by name ('go1') or by path to a spec JSON."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(_DATA_DIR, f"{name_or_path}.json")
    with open(path) as f:
        s = json.load(f)

    parent = np.asarray(s["parent"], np.int32)
    nj = len(s["joint_names"])
    sph = s["collision_spheres"]
    f32 = lambda x: np.asarray(x, np.float32)
    i32 = lambda x: np.asarray(x, np.int32)
    label_idx = {l: i for i, l in enumerate(LABELS)}
    static = dict(
        parent=parent,
        anc=_ancestor_mask(parent, nj),
        joint_pos=f32(s["joint_pos"]),
        joint_quat=f32(s["joint_quat"]),
        joint_axis=f32(s["joint_axis"]),
        joint_lower=f32(s["joint_lower"]),
        joint_upper=f32(s["joint_upper"]),
        effort_limit=f32(s["effort_limit"]),
        velocity_limit=f32(s["velocity_limit"]),
        joint_damping=f32(s["joint_damping"]),
        joint_friction=f32(s["joint_friction"]),
        mass=f32(s["mass"]),
        com=f32(s["com"]),
        inertia=f32(s["inertia"]),
        sph_body=i32([c["body"] for c in sph]),
        sph_pos=f32([c["pos"] for c in sph]),
        sph_radius=f32([c["radius"] for c in sph]),
        sph_label=i32([label_idx[c["label"]] for c in sph]),
        sph_leg=i32([c["leg"] for c in sph]),
        feet_body=i32([fs["body"] for fs in s["foot_sites"]]),
        feet_pos=f32([fs["pos"] for fs in s["foot_sites"]]),
        foot_radius=f32([next(c["radius"] for c in sph
                              if c["label"] == "foot" and c["leg"] == i)
                         for i in range(4)]),
    )
    return _make(s["name"], tuple(s["joint_names"]), tuple(s["body_names"]),
                 False, static, torch.device(device))


def default_joint_angles(model: RobotModel, angles_by_name) -> torch.Tensor:
    """Map a {joint_name: angle} mapping to the model's joint order
    (reference: legged_robot.py:1220-1236)."""
    angles_by_name = dict(angles_by_name)
    out = []
    for jn in model.joint_names:
        matches = [v for k, v in angles_by_name.items() if k == jn or k in jn]
        out.append(matches[0] if matches else 0.0)
    return torch.tensor(out, dtype=torch.float32, device=model.device)

