"""The plain versions of kernels A and B (copied from the port's
`physics/kernels.py`): the same rows in and out, on any device."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .batched import dynamics_core, fk_core, sphere_pos_core


def dyn_out_layout(nj: int) -> List[Tuple[str, int]]:
    """Kernel B's output rows, in order."""
    return [("base_pos", 3), ("base_quat", 4), ("base_lin_vel", 3),
            ("base_ang_vel", 3), ("joint_q", nj), ("joint_qd", nj),
            ("foot_forces", 12), ("foot_positions", 12),
            ("foot_velocities", 12), ("thigh_contact", 4),
            ("calf_contact", 4), ("base_contact", 1),
            ("total_normal_force", 1)]


def unpack_rows(rows: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    cols, at = {}, 0
    t = rows.T
    for name, n in layout:
        cols[name] = t[:, at:at + n]
        at += n
    return cols


def fk(model, fk_in: torch.Tensor):
    nj = model.nj
    t = fk_in.T
    body_pos, body_quat, anchors, axes = fk_core(
        model, t[:, 0:3], t[:, 3:7], t[:, 7:7 + nj])
    xp, _ = sphere_pos_core(model, body_pos, body_quat)
    B = fk_in.shape[1]
    fk_b = torch.cat([body_pos.reshape(B, -1), body_quat.reshape(B, -1),
                      anchors.reshape(B, -1), axes.reshape(B, -1)], dim=1)
    return fk_b.T.contiguous(), xp.permute(2, 1, 0).contiguous()


def dynamics(model, params, state, fk_b, fk_p, hc, duv, env, inv_hscale,
             ceil_h=None):
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
