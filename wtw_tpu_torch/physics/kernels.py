"""The two physics kernels, their wrappers, plain versions and launch counts.

Kernel A (`fk`) replaces `_pallas_fk` (wtw_tpu/physics/batched.py:882,
pallas_call at :908): FK over the static tree plus the world xyz of every
collision sphere. Source: `wtw_tpu_torch/csrc/fk.cu`.

Kernel B (`dynamics`) replaces `_pallas_dynamics` (batched.py:926,
pallas_call at :1024): the whole contact-dynamics substep of
`dynamics_core`. Source: `wtw_tpu_torch/csrc/dynamics.cu`.

Both are CUDA C++ for `sm_90a` over struct-of-arrays rows (env index
fastest), with the robot as one read-only constant buffer (`WtwModel`,
mirrored below, which also carries the tree's level order). Each env gets a
team of lanes inside one warp (kernel B a warp, kernel A 8 lanes) and a
block holds several envs: the block stages its envs' input rows and the
robot model in shared memory with coalesced loads, each team works
through its env in phases with lanes over bodies, a level of the tree,
dofs, matrix entries or contact candidates, and the block writes the output
rows coalesced. No floating-point atomics: a launch's result does not
depend on scheduling. What bounds each on the H100 and what its design does
about it is written at the top of its source file; both are bound by bytes
(kernel A ~1.3 KB/env against ~3 k flops, kernel B ~3.3 KB/env against a
few thousand to ~30 k). `launch_shape()` reports each kernel's lanes, envs
per block, shared bytes per block and resident blocks per SM.

Row layouts (all float32, shape (rows, B)):
  fk_in    7 + nj: base_pos 3, base_quat 4 (xyzw), joint_q nj
  fk_b     nb*7 + nj*6: body_pos nb x 3, body_quat nb x 4, anchors nj x 3,
           world joint axes nj x 3
  fk_p     (3, P, B): sphere world x, y, z
  state    3 + 4 + nj + nv + nj: base_pos, base_quat, joint_q,
           u = (ang vel 3, lin vel 3, joint qd), tau
  hc       (4, P, B) corner heights; duv (2, P, B) in-cell offsets
  ceil_h   (P, B) ceiling height over each sphere, or None (no ceiling)
  env      9: friction, restitution, payload, com_off 3, g_ext 3
  out      `dyn_out_layout(nj)`

Build: one `nvcc` call over both `.cu` files into `wtw_tpu_torch/_build/`
at first use, loaded with ctypes (plain C interface, no torch headers — a
few seconds instead of minutes). A CUDA tensor goes to the kernel or
raises; a CPU tensor goes to the plain version. There is no fallback.

Mixed-robot batches (`models/multi.py`): both wrappers also take a per-env
model (`stack.take(index)`), which carries the stack of R robots and each
env's robot index (int32 (B,) on the card). The model buffer then holds R
`WtwModel`s, one per robot, each built by `model_struct` from that robot's
sphere-padded model, and the kernel reads the envs through a slot table
(`slot_table`): the envs sorted by robot, each robot's run padded with
empty slots to a multiple of SLOT_GROUP, so that every block of either
kernel holds envs of one robot and stages one model, as a single-robot
block does. A block's envs are then strided columns of the rows instead of
neighbouring ones. A single-robot call launches the same kernel as before.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.multi import robot_of
from ..models.robot import RobotModel
from .batched import dynamics_core, fk_core, sphere_groups, sphere_pos_core
from .engine import EngineParams

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("fk.cu", "dynamics.cu")
BUILD_DIR = os.path.join(_PKG, "_build")

MAX_BODIES, MAX_JOINTS, MAX_DOFS, MAX_SPHERES = 16, 15, 21, 64
# envs of one robot per run of the slot table: a multiple of both kernels'
# envs per block (16 and 8)
SLOT_GROUP = 16


@dataclasses.dataclass
class Kernel:
    """A hand-written kernel's identity and its launch counts: `launches`,
    incremented by its wrapper where, and only where, it launches the
    kernel (inside a CUDA-graph capture too), and `ceiling_launches`, those
    of kernel B's launches that ran its ceiling pass; `replayed` and
    `replayed_ceiling`, the same counts of the launches that replays of a
    captured graph made (each replay adds what its capture launched:
    `envs.parkour_env.DonatedStep`)."""
    name: str
    source: str
    replaces: str
    launches: int = 0
    ceiling_launches: int = 0
    replayed: int = 0
    replayed_ceiling: int = 0


FK = Kernel("fk", "wtw_tpu_torch/csrc/fk.cu",
            "wtw_tpu/physics/batched.py:882")
DYNAMICS = Kernel("dynamics", "wtw_tpu_torch/csrc/dynamics.cu",
                  "wtw_tpu/physics/batched.py:926")
KERNELS = (FK, DYNAMICS)


def dyn_out_layout(nj: int) -> List[Tuple[str, int]]:
    """Kernel B's output rows, in order."""
    return [("base_pos", 3), ("base_quat", 4), ("base_lin_vel", 3),
            ("base_ang_vel", 3), ("joint_q", nj), ("joint_qd", nj),
            ("foot_forces", 12), ("foot_positions", 12),
            ("foot_velocities", 12), ("thigh_contact", 4),
            ("calf_contact", 4), ("base_contact", 1),
            ("total_normal_force", 1)]


def unpack_rows(rows: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    """(R, B) rows -> {name: (B, n) view} following `layout`."""
    cols, at = {}, 0
    t = rows.T
    for name, n in layout:
        cols[name] = t[:, at:at + n]
        at += n
    return cols


# ---------------------------------------------------------------------------
# the robot as a constant buffer (mirror of WtwModel in csrc/wtw_model.cuh)
# ---------------------------------------------------------------------------

_i, _f = ctypes.c_int, ctypes.c_float


class WtwModel(ctypes.Structure):
    _fields_ = [
        ("nb", _i), ("nj", _i), ("nv", _i), ("P", _i), ("lo", _i),
        ("parent", _i * MAX_BODIES),
        ("n_anc", _i * MAX_BODIES),
        ("anc_dofs", (_i * MAX_DOFS) * MAX_BODIES),
        ("sph_body", _i * MAX_SPHERES),
        ("sph_group", _i * MAX_SPHERES),
        ("feet_body", _i * 4),
        ("joint_pos", (_f * 3) * MAX_JOINTS),
        ("joint_quat", (_f * 4) * MAX_JOINTS),
        ("joint_axis", (_f * 3) * MAX_JOINTS),
        ("joint_damping", _f * MAX_JOINTS),
        ("mass", _f * MAX_BODIES),
        ("com", (_f * 3) * MAX_BODIES),
        ("inertia", (_f * 9) * MAX_BODIES),
        ("sph_pos", (_f * 3) * MAX_SPHERES),
        ("sph_radius", _f * MAX_SPHERES),
        ("feet_pos", (_f * 3) * 4),
        ("dt", _f), ("gravity", _f * 3),
        ("k_contact", _f), ("c_contact", _f), ("vel_eps", _f),
        ("v_maxdep", _f), ("armature", _f),
        ("n_lvl", _i), ("lvl_off", _i * (MAX_BODIES + 1)),
        ("lvl_body", _i * MAX_BODIES), ("child_off", _i * MAX_BODIES),
        ("n_child", _i * MAX_BODIES), ("anc_mask", _i * MAX_BODIES),
    ]


def tree_levels(parent) -> List[List[int]]:
    """Bodies grouped by depth from the base (body 0), in breadth-first
    order: each level lists the children of the previous level's bodies
    parent by parent, each parent's children in ascending index, so one
    parent's children sit together."""
    levels = [[0]]
    while True:
        nxt = [c for p in levels[-1] for c in range(1, len(parent))
               if int(parent[c]) == p]
        if not nxt:
            return levels
        levels.append(nxt)


def model_struct(model: RobotModel, params: EngineParams) -> WtwModel:
    """Fill the constant buffer; raises for a robot above the maxima."""
    s = model.static
    nb, nj, nv, P = model.nb, model.nj, model.nv, model.P
    if nb > MAX_BODIES or nj > MAX_JOINTS or nv > MAX_DOFS \
            or P > MAX_SPHERES or nb != nj + 1:
        raise ValueError(
            f"robot {model.name!r} (nb={nb}, nj={nj}, P={P}) exceeds the "
            f"kernels' maxima (bodies {MAX_BODIES}, joints {MAX_JOINTS}, "
            f"spheres {MAX_SPHERES}) or is not one joint per body")
    m = WtwModel()
    m.nb, m.nj, m.nv, m.P = nb, nj, nv, P
    m.lo = 6 if model.fixed_base else 0
    anc = s["anc"]
    for b in range(nb):
        m.parent[b] = int(s["parent"][b])
        dofs = [d for d in range(nv) if anc[b, d] > 0.5]
        m.n_anc[b] = len(dofs)
        for a, d in enumerate(dofs):
            m.anc_dofs[b][a] = d
        m.mass[b] = float(s["mass"][b])
        for k in range(3):
            m.com[b][k] = float(s["com"][b, k])
        for k in range(9):
            m.inertia[b][k] = float(s["inertia"][b].reshape(9)[k])
    for j in range(nj):
        for k in range(3):
            m.joint_pos[j][k] = float(s["joint_pos"][j, k])
            m.joint_axis[j][k] = float(s["joint_axis"][j, k])
        for k in range(4):
            m.joint_quat[j][k] = float(s["joint_quat"][j, k])
        m.joint_damping[j] = float(s["joint_damping"][j])
    grp = sphere_groups(model)
    for p in range(P):
        m.sph_body[p] = int(s["sph_body"][p])
        m.sph_group[p] = int(grp[p])
        m.sph_radius[p] = float(s["sph_radius"][p])
        for k in range(3):
            m.sph_pos[p][k] = float(s["sph_pos"][p, k])
    for l in range(4):
        m.feet_body[l] = int(s["feet_body"][l])
        for k in range(3):
            m.feet_pos[l][k] = float(s["feet_pos"][l, k])
    m.dt = float(params.dt)
    for k in range(3):
        m.gravity[k] = float(params.gravity[k])
    m.k_contact = float(params.contact_stiffness)
    m.c_contact = float(params.contact_damping)
    m.vel_eps = float(params.friction_vel_eps)
    m.v_maxdep = float(params.max_depenetration_velocity)
    m.armature = float(params.armature)
    levels = tree_levels(s["parent"])
    order = [b for lv in levels for b in lv]
    if sorted(order) != list(range(nb)) or any(
            int(s["parent"][b]) >= b for b in range(1, nb)):
        raise ValueError(f"robot {model.name!r}: not a tree rooted at body 0 "
                         f"with every parent numbered before its child")
    # kernel B factors a level's dofs together: they may share no ancestor
    # dof but the base's
    for bodies in levels[1:]:
        seen = set()
        for b in bodies:
            own = {d for d in range(6, nv) if anc[b, d] > 0.5} - {b + 5}
            if own & seen:
                raise ValueError(f"robot {model.name!r}: bodies of one tree "
                                 f"level share a joint ancestor")
            seen |= own
    m.n_lvl = len(levels)
    at = 0
    for lv, bodies in enumerate(levels):
        m.lvl_off[lv] = at
        at += len(bodies)
    m.lvl_off[len(levels)] = at
    for k, b in enumerate(order):
        m.lvl_body[k] = b
        kids = [x for x, c in enumerate(order) if int(s["parent"][c]) == b
                and c != 0]
        m.n_child[b] = len(kids)
        m.child_off[b] = kids[0] if kids else 0
        m.anc_mask[b] = sum(1 << d for d in range(nv) if anc[b, d] > 0.5)
    return m


def _model_buffer(model: RobotModel, params: EngineParams,
                  device: torch.device) -> torch.Tensor:
    """The WtwModel bytes on `device`, built once per (params, device): one
    struct, or for a stack of R robots R structs back to back."""
    cache = model.__dict__.setdefault("_kernel_buffers", {})
    key = (params, str(device))
    if key not in cache:
        robots = ([robot_of(model, r) for r in range(_n_robots(model))]
                  if model.batched else [model])
        raw = bytearray(b"".join(bytes(model_struct(m, params))
                                 for m in robots))
        cache[key] = torch.frombuffer(raw, dtype=torch.uint8).to(device)
    return cache[key]


def slot_table(robot: torch.Tensor, n_robots: int):
    """The kernels' view of a mixed batch: (slot_env, slot_robot), int32 on
    the robot index's device. slot_env lists the envs robot by robot (in
    env order within a robot), each robot's run padded with -1 to a
    multiple of SLOT_GROUP; slot_robot is the robot of each slot. Built on
    the host once per index tensor and kept on it."""
    key = (n_robots, robot._version)
    got = getattr(robot, "_wtw_slots", None)
    if got is not None and got[0] == key:
        return got[1]
    a = robot.cpu().numpy().astype(np.int64)
    if a.size and (a.min() < 0 or a.max() >= n_robots):
        raise ValueError(f"robot index outside [0, {n_robots})")
    env, rob = [], []
    for r in range(n_robots):
        idx = np.flatnonzero(a == r)
        pad = -len(idx) % SLOT_GROUP
        env.append(np.concatenate([idx, np.full(pad, -1)]))
        rob.append(np.full(len(idx) + pad, r))
    t = lambda x: torch.as_tensor(np.concatenate(x).astype(np.int32),
                                  device=robot.device)
    table = (t(env), t(rob))
    robot._wtw_slots = (key, table)
    return table


def _kernel_model(model: RobotModel):
    """-> (the model whose buffer the kernel reads, the robot index or
    None): a single robot, or the stack and index of a per-env model."""
    if model.stack is not None:
        return model.stack, model.robot
    if model.batched:
        raise ValueError(f"{model.name}: the kernels take a per-env model "
                         f"(`stack.take(index)`), not a bare stack")
    return model, None


def _n_robots(stack: RobotModel) -> int:
    return int(stack.static["mass"].shape[0])


# ---------------------------------------------------------------------------
# build (nvcc -> .so -> ctypes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Library:
    lib: ctypes.CDLL
    path: str
    build_seconds: float      # 0.0 when the library was already built
    ptxas: List[str]          # the compiler's -Xptxas -v lines


_LIBRARY: Optional[Library] = None


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then PyTorch's CUDA_HOME guess."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources_digest() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = True) -> Library:
    """Compile both kernels with one nvcc call (sm_90a) into BUILD_DIR,
    keyed by the sources' digest, and load the library."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libwtw_kernels_{_sources_digest()}.so")
    seconds, ptxas = 0.0, []
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp]
        cmd += [os.path.join(CSRC, s) for s in SOURCES]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)
        ptxas = [l for l in (res.stdout + res.stderr).splitlines()
                 if "ptxas" in l]
        if verbose:
            print(f"wtw_tpu_torch: built {os.path.basename(so)} in "
                  f"{seconds:.1f} s", flush=True)
    lib = ctypes.CDLL(so)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wtw_model_bytes.argtypes = []
    lib.wtw_model_bytes.restype = ci
    lib.wtw_fk_launch.argtypes = [vp, vp, vp, vp, ci, vp]
    lib.wtw_fk_launch.restype = ci
    lib.wtw_fk_multi_launch.argtypes = [vp, vp, vp, ci, vp, vp, vp, ci, vp]
    lib.wtw_fk_multi_launch.restype = ci
    lib.wtw_dynamics_launch.argtypes = [vp] * 8 + [cf, vp, ci, vp]
    lib.wtw_dynamics_launch.restype = ci
    lib.wtw_dynamics_multi_launch.argtypes = ([vp, vp, vp, ci] + [vp] * 7
                                              + [cf, vp, ci, vp])
    lib.wtw_dynamics_multi_launch.restype = ci
    for fn in (lib.wtw_fk_info, lib.wtw_dynamics_info,
               lib.wtw_fk_multi_info, lib.wtw_dynamics_multi_info):
        fn.argtypes = [ctypes.POINTER(ci)]
        fn.restype = ci
    if lib.wtw_model_bytes() != ctypes.sizeof(WtwModel):
        raise RuntimeError("WtwModel layout differs between csrc and "
                           "physics/kernels.py")
    _LIBRARY = Library(lib, so, seconds, ptxas)
    return _LIBRARY


def launch_shape() -> Dict[str, Dict[str, int]]:
    """Per kernel: lanes per env, envs per block, shared bytes per block and
    resident blocks per SM on the current device (builds the library);
    `<name>_multi` the same for its mixed-robot path, which stages one
    model a block and runs a block per SLOT_GROUP-aligned run of slots."""
    lib = build().lib
    shapes = {}
    for name, fn, multi in (
            (FK.name, lib.wtw_fk_info, False),
            (DYNAMICS.name, lib.wtw_dynamics_info, False),
            (f"{FK.name}_multi", lib.wtw_fk_multi_info, True),
            (f"{DYNAMICS.name}_multi", lib.wtw_dynamics_multi_info, True)):
        info = (ctypes.c_int * 4)()
        rc = fn(info)
        if rc != 0:
            raise RuntimeError(f"{name}: occupancy query failed: "
                               f"cudaError {rc}")
        shapes[name] = dict(lanes_per_env=info[0], envs_per_block=info[1],
                            shared_bytes_per_block=info[2],
                            blocks_per_sm=info[3])
        if multi:
            shapes[name].update(models_per_block=1, slot_group=SLOT_GROUP)
    return shapes


def _check(t: torch.Tensor, shape, name: str):
    if t.dtype != torch.float32 or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected contiguous float32 {tuple(shape)},"
                         f" got {t.dtype} {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' non-contiguous'}")


def _on_card(t: torch.Tensor) -> bool:
    """True: launch the kernel. CPU tensors take the plain version; any
    other device is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# kernel A: FK + sphere positions
# ---------------------------------------------------------------------------


def fk_plain(model: RobotModel, fk_in: torch.Tensor):
    """Plain PyTorch version of kernel A: rows in, (fk_b, fk_p) rows out;
    `model` is one robot or a per-env model."""
    nj = model.nj
    t = fk_in.T
    body_pos, body_quat, anchors, axes = fk_core(
        model, t[:, 0:3], t[:, 3:7], t[:, 7:7 + nj])
    xp, _ = sphere_pos_core(model, body_pos, body_quat)
    B = fk_in.shape[1]
    fk_b = torch.cat([body_pos.reshape(B, -1), body_quat.reshape(B, -1),
                      anchors.reshape(B, -1), axes.reshape(B, -1)], dim=1)
    return fk_b.T.contiguous(), xp.permute(2, 1, 0).contiguous()


def _check_robot(robot: Optional[torch.Tensor], B: int, dev):
    if robot is not None and (robot.dtype != torch.int32
                              or tuple(robot.shape) != (B,)
                              or robot.device != dev):
        raise ValueError(f"robot: expected int32 ({B},) on {dev}, got "
                         f"{robot.dtype} {tuple(robot.shape)} on "
                         f"{robot.device}")


def fk(model: RobotModel, fk_in: torch.Tensor):
    """Kernel A on a CUDA tensor, its plain version on a CPU tensor. A
    per-env model (`stack.take(index)`) brings the stack whose robots the
    kernel stages and each env's robot index."""
    B = fk_in.shape[-1]
    _check(fk_in, (7 + model.nj, B), "fk_in")
    kmodel, robot = _kernel_model(model)
    if not _on_card(fk_in):
        return fk_plain(model, fk_in)
    dev = fk_in.device
    _check_robot(robot, B, dev)
    lib = build().lib
    mbuf = _model_buffer(kmodel, EngineParams(), dev)
    fk_b = torch.empty(model.nb * 7 + model.nj * 6, B, device=dev)
    fk_p = torch.empty(3, model.P, B, device=dev)
    if B == 0:
        return fk_b, fk_p
    if robot is None:
        rc = lib.wtw_fk_launch(mbuf.data_ptr(), fk_in.data_ptr(),
                               fk_b.data_ptr(), fk_p.data_ptr(), B,
                               _stream(dev))
    else:
        slot_env, slot_robot = slot_table(robot, _n_robots(kmodel))
        rc = lib.wtw_fk_multi_launch(
            mbuf.data_ptr(), slot_env.data_ptr(), slot_robot.data_ptr(),
            slot_env.numel(), fk_in.data_ptr(), fk_b.data_ptr(),
            fk_p.data_ptr(), B, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"kernel A launch failed: cudaError {rc}")
    FK.launches += 1
    return fk_b, fk_p


# ---------------------------------------------------------------------------
# kernel B: the dynamics substep
# ---------------------------------------------------------------------------


def dynamics_plain(model: RobotModel, params: EngineParams,
                   state: torch.Tensor, fk_b: torch.Tensor,
                   fk_p: torch.Tensor, hc: torch.Tensor, duv: torch.Tensor,
                   env: torch.Tensor, inv_hscale: float,
                   ceil_h: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel B, same rows in and out; `model` is
    one robot or a per-env model."""
    nb, nj, nv = model.nb, model.nj, model.nv
    B = state.shape[1]
    s, fb, ev = state.T, fk_b.T, env.T
    o = 7 + nj
    I = dict(
        base_pos=s[:, 0:3], base_quat=s[:, 3:7], joint_q=s[:, 7:o],
        u=s[:, o:o + nv], tau=s[:, o + nv:o + nv + nj],
        body_pos=fb[:, :nb * 3].reshape(B, nb, 3),
        body_quat=fb[:, nb * 3:nb * 7].reshape(B, nb, 4),
        anchors=fb[:, nb * 7:nb * 7 + nj * 3].reshape(B, nj, 3),
        axes=fb[:, nb * 7 + nj * 3:].reshape(B, nj, 3),
        xp=fk_p.permute(2, 1, 0), hc=hc.transpose(1, 2),
        du=duv[0].T, dv=duv[1].T, fric=ev[:, 0], rest=ev[:, 1],
        payload=ev[:, 2], com_off=ev[:, 3:6], g_ext=ev[:, 6:9],
        inv_hscale=inv_hscale,
        ceil_h=None if ceil_h is None else ceil_h.T)
    out = dynamics_core(model, params, I)
    return torch.cat([out[name].reshape(B, n)
                      for name, n in dyn_out_layout(nj)], dim=1).T.contiguous()


def dynamics(model: RobotModel, params: EngineParams, state: torch.Tensor,
             fk_b: torch.Tensor, fk_p: torch.Tensor, hc: torch.Tensor,
             duv: torch.Tensor, env: torch.Tensor, inv_hscale: float,
             ceil_h: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel B on CUDA tensors, its plain version on CPU tensors. With
    `ceil_h` (P, B) the kernel also runs its ceiling contact pass. A
    per-env model (`stack.take(index)`) brings the stack whose robots the
    kernel stages and each env's robot index."""
    nb, nj, nv, P = model.nb, model.nj, model.nv, model.P
    B = state.shape[-1]
    _check(state, (7 + nj + nv + nj, B), "state")
    _check(fk_b, (nb * 7 + nj * 6, B), "fk_b")
    _check(fk_p, (3, P, B), "fk_p")
    _check(hc, (4, P, B), "hc")
    _check(duv, (2, P, B), "duv")
    _check(env, (9, B), "env")
    ins = [state, fk_b, fk_p, hc, duv, env]
    if ceil_h is not None:
        _check(ceil_h, (P, B), "ceil_h")
        ins.append(ceil_h)
    devs = {t.device for t in ins}
    if len(devs) != 1:
        raise ValueError(f"kernel B inputs on several devices: {devs}")
    kmodel, robot = _kernel_model(model)
    if not _on_card(state):
        return dynamics_plain(model, params, state, fk_b, fk_p, hc, duv, env,
                              inv_hscale, ceil_h)
    dev = state.device
    _check_robot(robot, B, dev)
    lib = build().lib
    mbuf = _model_buffer(kmodel, params, dev)
    n_out = sum(n for _, n in dyn_out_layout(nj))
    out = torch.empty(n_out, B, device=dev)
    if B == 0:
        return out
    ins = (state.data_ptr(), fk_b.data_ptr(), fk_p.data_ptr(),
           hc.data_ptr(), duv.data_ptr(),
           None if ceil_h is None else ceil_h.data_ptr(), env.data_ptr(),
           float(inv_hscale), out.data_ptr(), B, _stream(dev))
    if robot is None:
        rc = lib.wtw_dynamics_launch(mbuf.data_ptr(), *ins)
    else:
        slot_env, slot_robot = slot_table(robot, _n_robots(kmodel))
        rc = lib.wtw_dynamics_multi_launch(
            mbuf.data_ptr(), slot_env.data_ptr(), slot_robot.data_ptr(),
            slot_env.numel(), *ins)
    if rc != 0:
        raise RuntimeError(f"kernel B launch failed: cudaError {rc}")
    DYNAMICS.launches += 1
    DYNAMICS.ceiling_launches += ceil_h is not None
    return out
