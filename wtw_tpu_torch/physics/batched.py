"""Batched physics step (port of `wtw_tpu/physics/batched.py`).

Same dynamics as the JAX batched engine: FK over the static tree, compact
spatial inertias with payload/CoM randomization on the base, RNEA bias
forces with the gravity trick, the joint-space mass matrix, sphere contacts
against a heightfield (normal measured along the surface normal, elastic
force capped by `max_depenetration_velocity`, implicit normal and friction
damping), one Cholesky solve, semi-implicit Euler.

Two layers:

- `fk_core`, `sphere_pos_core`, `dynamics_core`: the plain PyTorch versions,
  written over env-major tensors ((B, ...) leading env axis). They are what
  the CPU runs and what the CUDA kernels are held against. The model is one
  robot shared by every env, or a per-env model (`models/multi.py`) whose
  array fields carry the env axis too.
- `physics_step_batched`: the public entry. It packs the state into the
  struct-of-arrays rows the kernels read (`physics/kernels.py` documents the
  row layouts) and calls `kernels.fk` / `kernels.dynamics`, which launch
  the CUDA kernels for CUDA tensors and run the plain versions for CPU
  tensors.

The mass matrix here is the Jacobian form Σ_b J_bᵀ I_b J_b of the CRBA the
kernel (and the JAX engine) runs over the tree; both give the same matrix.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..models.robot import RobotModel
from ..utils import spans
from ..utils.quat import quat_mul, quat_to_matrix
from .engine import EngineParams
from .heightfield import HeightField, _cell_coords
from .linalg import cholesky_solve
from .state import ContactInfo, PhysicsState


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def _rot(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R @ v over trailing (3, 3) / (3,) dims, broadcasting."""
    return (R * v[..., None, :]).sum(-1)


def _qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    xyz, w = q[..., :3], q[..., 3:4]
    t = 2.0 * _cross(xyz, v)
    return v + w * t + _cross(xyz, t)


def _env(x: torch.Tensor, nd: int) -> torch.Tensor:
    """A model field with `nd` dims of its own, with a leading env axis: a
    shared field gets a broadcast axis of 1."""
    return x[None] if x.dim() == nd else x


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows idx of x (B, n, ...) along axis 1: a shared index (k,) or a
    per-env one (B, k) -> (B, k, ...)."""
    if idx.dim() == 1:
        return x[:, idx]
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                       dim=-1).reshape(v.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# plain versions (env-major)
# ---------------------------------------------------------------------------


def fk_core(model: RobotModel, base_pos, base_quat, joint_q):
    """FK over the static tree (`wtw_tpu/physics/batched.py:242`).
    (B,3), (B,4), (B,nj) -> body_pos (B,nb,3), body_quat (B,nb,4),
    anchors (B,nj,3), axes (B,nj,3)."""
    nb, nj = model.nb, model.nj
    parent = model.parent_static
    pos, quat = [None] * nb, [None] * nb
    anchors, axes = [], []
    pos[0], quat[0] = base_pos, base_quat
    for j in range(nj):
        child, p = j + 1, parent[j + 1]
        qp = quat[p]
        axis = model.joint_axis[..., j, :]
        anchor = pos[p] + _qrot(qp, model.joint_pos[..., j, :].expand_as(pos[p]))
        q_frame = quat_mul(qp, model.joint_quat[..., j, :].expand_as(qp))
        half = 0.5 * joint_q[:, j:j + 1]
        q_j = torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)
        quat[child] = quat_mul(q_frame, q_j)
        axes.append(_qrot(q_frame, axis.expand_as(anchor)))
        pos[child] = anchor
        anchors.append(anchor)
    return (torch.stack(pos, 1), torch.stack(quat, 1),
            torch.stack(anchors, 1), torch.stack(axes, 1))


def sphere_pos_core(model: RobotModel, body_pos, body_quat):
    """World xyz of all collision spheres (`batched.py:277`):
    -> xp (B, P, 3), R (B, nb, 3, 3)."""
    R = quat_to_matrix(body_quat)
    sb = model.sph_body.long()
    xp = _at(body_pos, sb) + _rot(_at(R, sb), model.sph_pos)
    return xp, R


def dynamics_core(model: RobotModel, params: EngineParams,
                  I: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Everything after FK and the heightfield gather (`batched.py:314`).

    Inputs (env-major): base_pos (B,3) base_quat (B,4) joint_q (B,nj)
    u (B,nv) [ang, lin, joint] tau (B,nj) body_pos (B,nb,3) body_quat
    (B,nb,4) anchors/axes (B,nj,3) xp (B,P,3) hc (4,B,P) du/dv (B,P)
    ceil_h (B,P) or absent fric rest payload (B,) com_off g_ext (B,3)
    inv_hscale (float).

    With `ceil_h`, every sphere also meets the overhead obstacle above it
    (`batched.py:516-533`): normal (0, 0, -1), depth z + r - ceil_h. The
    contact set is the ground set followed by the ceiling set, and a
    sphere's ceiling copy keeps its contact group."""
    dev = I["base_pos"].device
    nb, nj, nv = model.nb, model.nj, model.nv
    dt = float(params.dt)
    base_pos, u = I["base_pos"], I["u"]
    B = base_pos.shape[0]
    eye3 = torch.eye(3, device=dev)

    # ---- dof spatial axes S_i = (sw, sv) about base_pos ----
    S = torch.zeros(B, nv, 6, device=dev)
    S[:, 0:3, 0:3] = eye3
    S[:, 3:6, 3:6] = eye3
    S[:, 6:, :3] = I["axes"]
    S[:, 6:, 3:] = _cross(I["anchors"] - base_pos[:, None], I["axes"])
    anc = _env(model.anc, 2)                            # (1|B, nb, nv)
    Jb = anc[..., None] * S[:, None]                    # (B, nb, nv, 6)
    V = torch.einsum("bnik,bi->bnk", Jb, u)             # body velocities
    Vw, Vv = V[..., :3], V[..., 3:]

    # ---- compact spatial inertias with base payload / CoM offset ----
    R = quat_to_matrix(I["body_quat"])                  # (B, nb, 3, 3)
    c = I["body_pos"] + _rot(R, model.com) - base_pos[:, None]
    c = torch.cat([c[:, :1] + _rot(R[:, 0], I["com_off"])[:, None],
                   c[:, 1:]], dim=1)
    m0 = _env(model.mass, 1).expand(B, nb)
    mass = torch.cat([m0[:, :1] + I["payload"][:, None], m0[:, 1:]], dim=1)
    Iw = R @ model.inertia @ R.transpose(-1, -2)
    c2 = (c * c).sum(-1)
    Io = Iw + mass[..., None, None] * (c2[..., None, None] * eye3
                                       - c[..., :, None] * c[..., None, :])
    h = mass[..., None] * c
    I6 = torch.zeros(B, nb, 6, 6, device=dev)
    I6[..., :3, :3] = Io
    I6[..., :3, 3:] = _skew(h)
    I6[..., 3:, :3] = _skew(h).transpose(-1, -2)
    I6[..., 3:, 3:] = mass[..., None, None] * eye3

    # ---- mass matrix (+ armature on the joint diagonal) ----
    M = torch.einsum("bnik,bnkl,bnjl->bij", Jb, I6, Jb)
    arm = torch.cat([torch.zeros(6, device=dev),
                     torch.full((nj,), float(params.armature), device=dev)])
    M = M + torch.diag(arm)

    # ---- bias forces: RNEA with the gravity trick ----
    g = torch.as_tensor(params.gravity, dtype=torch.float32,
                        device=dev) + I["g_ext"]
    avp = [None] * nb
    avp[0] = torch.cat([torch.zeros_like(g), -g], dim=-1)
    parent = model.parent_static
    for j in range(nj):
        child, p = j + 1, parent[j + 1]
        sqd = u[:, 6 + j:7 + j] * S[:, 6 + j]
        w, vo = Vw[:, child], Vv[:, child]
        cw = _cross(w, sqd[:, :3])
        cv = _cross(w, sqd[:, 3:]) + _cross(vo, sqd[:, :3])
        avp[child] = avp[p] + torch.cat([cw, cv], dim=-1)
    avp = torch.stack(avp, 1)
    IA = (I6 * avp[..., None, :]).sum(-1)
    IV = (I6 * V[..., None, :]).sum(-1)
    f = IA + torch.cat([_cross(Vw, IV[..., :3]) + _cross(Vv, IV[..., 3:]),
                        _cross(Vw, IV[..., 3:])], dim=-1)
    C = torch.einsum("bnik,bnk->bi", Jb, f)

    # ---- sphere contacts against the heightfield ----
    k_c = float(params.contact_stiffness)
    rest, fric = I["rest"], I["fric"]
    c_n_imp = float(params.contact_damping) * (1.0 - rest) + dt * k_c
    h00, h10, h01, h11 = I["hc"]
    du, dv = I["du"], I["dv"]
    inv_s = float(I["inv_hscale"])
    hgt = (h00 * (1 - du) * (1 - dv) + h10 * du * (1 - dv)
           + h01 * (1 - du) * dv + h11 * du * dv)
    dhdx = ((h10 - h00) * (1 - dv) + (h11 - h01) * dv) * inv_s
    dhdy = ((h01 - h00) * (1 - du) + (h11 - h10) * du) * inv_s
    inv_n = torch.rsqrt(dhdx * dhdx + dhdy * dhdy + 1.0)
    n = torch.stack([-dhdx * inv_n, -dhdy * inv_n, inv_n], dim=-1)
    xp = I["xp"]
    depth = (xp[..., 2] - hgt) * (-inv_n) + model.sph_radius
    sb = model.sph_body.long()
    r_p = xp - base_pos[:, None]
    vel = _at(Vv, sb) + _cross(_at(Vw, sb), r_p)
    groups = contact_groups(model).to(dev)              # (13, P) | (B, 13, P)
    if I.get("ceil_h") is not None:
        depth = torch.cat([depth, xp[..., 2] + model.sph_radius
                           - I["ceil_h"]], dim=1)
        down = torch.tensor([0.0, 0.0, -1.0], device=dev).expand_as(n)
        n = torch.cat([n, down], dim=1)
        r_p, vel = torch.cat([r_p, r_p], dim=1), torch.cat([vel, vel], dim=1)
        sb = torch.cat([sb, sb], dim=-1)
        groups = torch.cat([groups, groups], dim=-1)
    active = (depth > 0.0).float()
    f_cap = c_n_imp * float(params.max_depenetration_velocity)
    f_n0 = torch.minimum(torch.clamp(k_c * depth, min=0.0),
                         f_cap[:, None]) * active
    vn = (vel * n).sum(-1)
    v_t = vel - vn[..., None] * n
    eps2 = float(params.friction_vel_eps) ** 2
    c_t = fric[:, None] * f_n0 * torch.rsqrt((v_t * v_t).sum(-1) + eps2)
    cn_eff = active * c_n_imp[:, None]
    coef = cn_eff - c_t
    # contact Jacobian rows J_i(p) = anc[body_p, i] (sv_i + sw_i x r_p)
    Jc = _at(anc, sb)[..., None] * (
        S[:, None, :, 3:] + _cross(S[:, None, :, :3], r_p[:, :, None]))
    wn = (Jc * n[:, :, None]).sum(-1)                    # (B, P, nv)
    A_c = (torch.einsum("bp,bpi,bpj->bij", coef, wn, wn)
           + torch.einsum("bp,bpik,bpjk->bij", c_t, Jc, Jc))
    rhs_c = torch.einsum("bpi,bp->bi", wn, f_n0)

    # ---- implicit solve over the free dofs ----
    damp = torch.cat([torch.zeros(B, 6, device=dev),
                      _env(model.joint_damping, 1).expand(B, nj)], dim=1)
    tau_full = torch.cat([torch.zeros(B, 6, device=dev), I["tau"]], dim=1)
    rhs = ((M * u[:, None, :]).sum(-1) + dt * (tau_full - C) + dt * rhs_c)
    A = M + dt * torch.diag_embed(damp) + dt * A_c
    lo = 6 if model.fixed_base else 0
    u_new = torch.zeros(B, nv, device=dev)
    u_new[:, lo:] = cholesky_solve(A[:, lo:, lo:], rhs[:, lo:])

    # ---- realized contact forces (diagnostics) ----
    cv_new = torch.einsum("bpik,bi->bpk", Jc, u_new)
    vn_new = (cv_new * n).sum(-1)
    vt_new = cv_new - vn_new[..., None] * n
    fn_lin = f_n0 - cn_eff * vn_new
    c_force = fn_lin[..., None] * n - c_t[..., None] * vt_new
    total_fn = torch.clamp(fn_lin, min=0.0).sum(-1)
    g_acc = torch.einsum("gp,bpk->bgk" if groups.dim() == 2
                         else "bgp,bpk->bgk", groups, c_force)
    norm3 = lambda v: torch.sqrt((v * v).sum(-1) + 1e-30)

    # ---- semi-implicit Euler ----
    w_new, v_sp, qd_new = u_new[:, 0:3], u_new[:, 3:6], u_new[:, 6:]
    dpos = dt * v_sp
    theta = torch.sqrt((w_new * w_new).sum(-1, keepdim=True) + 1e-30)
    half = 0.5 * dt * theta
    kfac = torch.where(theta > 1e-9, torch.sin(half) / theta.clamp_min(1e-9),
                       torch.full_like(theta, 0.5 * dt))
    qn = quat_mul(torch.cat([w_new * kfac, torch.cos(half)], dim=-1),
                  I["base_quat"])
    qn = qn * torch.rsqrt((qn * qn).sum(-1, keepdim=True))

    # ---- foot kinematics ----
    fb = model.feet_body.long()
    fpos = _at(I["body_pos"], fb) + _rot(_at(R, fb), model.feet_pos)
    fvel = _at(Vv, fb) + _cross(_at(Vw, fb), fpos - base_pos[:, None])

    return dict(
        base_pos=base_pos + dpos, base_quat=qn,
        base_lin_vel=v_sp + _cross(w_new, dpos), base_ang_vel=w_new,
        joint_q=I["joint_q"] + dt * qd_new, joint_qd=qd_new,
        foot_forces=g_acc[:, 0:4], foot_positions=fpos, foot_velocities=fvel,
        thigh_contact=norm3(g_acc[:, 4:8]), calf_contact=norm3(g_acc[:, 8:12]),
        base_contact=norm3(g_acc[:, 12]), total_normal_force=total_fn)


def sphere_groups(model: RobotModel) -> np.ndarray:
    """Contact group per sphere (`batched.py:640-643`): foot of leg l -> l,
    thigh of leg l -> 4 + l, calf of leg l -> 8 + l, base -> 12, other -1.
    (P,), or (B, P) for a per-env model; a padded sphere (label 0) is in
    the base group, as in the JAX engine's base force, and adds exactly
    zero to it."""
    lbl, leg = model.static["sph_label"], model.static["sph_leg"]
    grp = np.full(lbl.shape, -1, np.int32)
    for l in range(4):
        grp[(lbl == 4) & (leg == l)] = l
        grp[(lbl == 2) & (leg == l)] = 4 + l
        grp[(lbl == 3) & (leg == l)] = 8 + l
    grp[lbl == 0] = 12
    return grp


def contact_groups(model: RobotModel) -> torch.Tensor:
    """(13, P) 0/1 masks of `sphere_groups`; (B, 13, P) per env."""
    grp = sphere_groups(model)
    return torch.from_numpy(
        (grp[..., None, :] == np.arange(13)[:, None]).astype(np.float32))


# ---------------------------------------------------------------------------
# heightfield rows (gathers stay outside the kernels, as in the JAX engine)
# ---------------------------------------------------------------------------


# span around kernel B's corner-row gathers (`trace.py` reads their device
# time from its profiler ranges)
GATHER_RANGE = "hf_corner_gather"


def _gather_at(hf: HeightField, u: torch.Tensor, v: torch.Tensor):
    """Corner rows of the cells holding continuous coordinates (u, v)."""
    with spans.span(GATHER_RANGE):
        u0f, v0f = torch.floor(u), torch.floor(v)
        base = u0f.long() * hf.shape[1] + v0f.long()
        return u0f, v0f, hf.corners[base].permute(2, 0, 1).contiguous()


def _hf_gather(hf: HeightField, x: torch.Tensor, y: torch.Tensor):
    """Sphere xy (P, B) -> (u0f, v0f, hc (4, P, B)): one packed corner-row
    gather per sphere, with the float cell coordinates it was taken at (the
    cache's anchor; `batched.py:731`)."""
    return _gather_at(hf, *_cell_coords(hf, x, y))


def _hf_rows(hf: HeightField, x: torch.Tensor, y: torch.Tensor, cached=None):
    """Corner rows + in-cell offsets at sphere xy (P, B) for kernel B:
    -> hc (4, P, B), duv (2, P, B) (`batched.py:742`). Three regimes:
    a flat field fills the rows from `flat_value` (no gather); `cached`
    (u0f, v0f, hc) from `hf_gather_cache` reuses the rows gathered at the
    policy-step start, with du/dv against the cached cell clamped to
    [0, 1]; otherwise one packed row gather per sphere."""
    if hf.is_flat:
        hc = torch.full((4,) + tuple(x.shape), hf.flat_value,
                        device=x.device)
        return hc, torch.zeros((2,) + tuple(x.shape), device=x.device)
    u, v = _cell_coords(hf, x, y)
    if cached is not None:
        u0f, v0f, hc = cached
        return hc, torch.stack([torch.clamp(u - u0f, 0.0, 1.0),
                                torch.clamp(v - v0f, 0.0, 1.0)])
    u0f, v0f, hc = _gather_at(hf, u, v)
    return hc, torch.stack([u - u0f, v - v0f])


def _hf_height(hf: HeightField, x: torch.Tensor, y: torch.Tensor,
               cached=None) -> torch.Tensor:
    """Bilinear heights only (the ceiling query): (P, B) -> (P, B)
    (`batched.py:770`)."""
    (h00, h10, h01, h11), (du, dv) = _hf_rows(hf, x, y, cached=cached)
    if hf.is_flat:
        return h00
    return (h00 * (1 - du) * (1 - dv) + h10 * du * (1 - dv)
            + h01 * (1 - du) * dv + h11 * du * dv)


def hf_gather_cache(hf: HeightField, xp: torch.Tensor,
                    hf_ceiling: Optional[HeightField] = None) -> Dict:
    """Gather the terrain (and ceiling) corner rows once at the sphere
    positions xp (3, P, B), for reuse across the substeps of one policy
    step through `physics_step_batched(hf_cache=...)` (`batched.py:780`).
    Flat fields need no cache."""
    cache = {}
    if not hf.is_flat:
        cache["g"] = _hf_gather(hf, xp[0], xp[1])
    if hf_ceiling is not None and not hf_ceiling.is_flat:
        cache["c"] = _hf_gather(hf_ceiling, xp[0], xp[1])
    return cache


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def pack_state_rows(state: PhysicsState, joint_torque) -> torch.Tensor:
    """(3+4+nj+nv+nj, B) rows: base_pos, base_quat, joint_q, u (ang, lin,
    joint), tau."""
    return torch.cat([state.base_pos, state.base_quat, state.joint_q,
                      state.base_ang_vel, state.base_lin_vel,
                      state.joint_qd, joint_torque], dim=1).T.contiguous()


@spans.spanned("physics.step")
def physics_step_batched(model: RobotModel, hf: HeightField,
                         params: EngineParams, state: PhysicsState,
                         joint_torque, friction, restitution,
                         payload_mass=None, com_offset=None,
                         external_accel=None,
                         hf_ceiling: Optional[HeightField] = None,
                         hf_cache: Optional[Dict] = None,
                         return_hf_cache: bool = False):
    """One substep for B envs (`batched.py:1048`): state fields carry a
    leading (B,) env axis; returns (PhysicsState, ContactInfo), and with
    `return_hf_cache` also the corner-row cache gathered at this call's
    sphere positions.

    hf_ceiling: overhead obstacles as a second heightfield (its bilinear
    height under each sphere goes to kernel B's ceiling pass). hf_cache:
    rows from `hf_gather_cache` (or an earlier `return_hf_cache`) reused
    instead of a gather per substep.

    CUDA tensors run kernel A (FK + sphere positions) and kernel B (the
    dynamics); CPU tensors run their plain versions."""
    from . import kernels

    B = state.joint_q.shape[0]
    nj = model.nj
    dev = state.joint_q.device

    def bcast(x, shape):
        # a Python number is a device fill, not a host-to-device copy
        if x is None or isinstance(x, (int, float)):
            return torch.full(shape, float(x or 0.0), device=dev)
        return spans.as_tensor(x, dtype=torch.float32,
                               device=dev).expand(shape)

    fk_in = torch.cat([state.base_pos, state.base_quat, state.joint_q],
                      dim=1).T.contiguous()
    fk_b, fk_p = kernels.fk(model, fk_in)
    # the cache to return is gathered once, and this substep reads its rows
    # from it unless a cache was passed: JAX leaves the merge of the two
    # gathers to XLA's CSE, eager torch has none
    new_cache = (hf_gather_cache(hf, fk_p, hf_ceiling) if return_hf_cache
                 else None)
    cache = hf_cache or new_cache or {}
    hc, duv = _hf_rows(hf, fk_p[0], fk_p[1], cached=cache.get("g"))
    ceil_h = None
    if hf_ceiling is not None:
        ceil_h = _hf_height(hf_ceiling, fk_p[0], fk_p[1],
                            cached=cache.get("c"))
    env_rows = torch.cat([
        bcast(friction, (B,))[None], bcast(restitution, (B,))[None],
        bcast(payload_mass, (B,))[None], bcast(com_offset, (B, 3)).T,
        bcast(external_accel, (B, 3)).T], dim=0).contiguous()
    out = kernels.dynamics(model, params, pack_state_rows(state, joint_torque),
                           fk_b, fk_p, hc, duv, env_rows,
                           1.0 / hf.horizontal_scale, ceil_h=ceil_h)

    cols = kernels.unpack_rows(out, kernels.dyn_out_layout(nj))
    new_state = PhysicsState(
        base_pos=cols["base_pos"], base_quat=cols["base_quat"],
        base_lin_vel=cols["base_lin_vel"], base_ang_vel=cols["base_ang_vel"],
        joint_q=cols["joint_q"], joint_qd=cols["joint_qd"])
    info = ContactInfo(
        foot_forces=cols["foot_forces"].reshape(B, 4, 3),
        foot_positions=cols["foot_positions"].reshape(B, 4, 3),
        foot_velocities=cols["foot_velocities"].reshape(B, 4, 3),
        thigh_contact=cols["thigh_contact"], calf_contact=cols["calf_contact"],
        base_contact=cols["base_contact"][:, 0],
        total_normal_force=cols["total_normal_force"][:, 0])
    if return_hf_cache:
        return new_state, info, new_cache
    return new_state, info
