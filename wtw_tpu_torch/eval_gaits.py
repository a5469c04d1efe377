"""Commanded-gait differentiation sweep for a MoB checkpoint (the
counterpart of `scripts/eval_gaits.py`):

    python -m wtw_tpu_torch.eval_gaits --checkpoint checkpoints/go1_mob_r5b_cot.pkl.gz
    python -m wtw_tpu_torch.eval_gaits --checkpoint ... --obedience --out obedience.jsonl

Runs the four gaits of the 15-dim command space (trot, pace, bound, pronk
at 3 Hz) plus the trot frequency sweep `--freqs`, and reports each
command's realized gait signature; the flagship "walk these ways" check is
that each commanded gait dominates its own correlation axis and tracks the
commanded stride frequency. `--obedience` sweeps the non-gait command dims
instead (body height and pitch, footswing height, stance width and length,
vy, yaw rate) and reports realized against commanded. `--out` appends one
JSON line with the JAX script's keys. `--checkpoint` takes the port's
`state_<tag>.pt` or a JAX runner's `.pkl` / `.pkl.gz`; the env is the
file's config with every domain randomization off except the actuator lag.
Runs on the CUDA device unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .play import build, command_vector


def gait_rollout(env, policy, cmd, steps, seed):
    """(lin_vel_rmsd (steps, N), contacts (steps, N, 4)) of one commanded
    rollout, read back once."""
    from .learn.eval_metrics import _record_state, rollout, state_metrics
    tr = rollout(env, policy, steps, seed, cmd, lambda world, rew: {
        **_record_state(world, rew), "c": world.env.last_contacts})
    rmsd = state_metrics(tr, ["lin_vel_rmsd"])["lin_vel_rmsd"]
    return rmsd.cpu().numpy(), tr["c"].cpu().numpy()


def gait_rows(env, policy, it, vx=0.5, freqs=(2.0, 3.0), steps=300,
              seed=0):
    """The four gaits at 3 Hz and the trot at each other frequency of
    `freqs`: one row each, as the JAX script prints them."""
    from .learn.eval_metrics import classify_contacts
    nc = env.cfg.commands.num_commands
    cases = [(g, 3.0) for g in ("trot", "pace", "bound", "pronk")]
    cases += [("trot", float(f)) for f in freqs if float(f) != 3.0]
    rows = []
    for gait, freq in cases:
        rmsd, contacts = gait_rollout(
            env, policy, command_vector(nc, vx, gait=gait, freq=freq), steps,
            seed)
        g = classify_contacts(contacts, env.dt)
        rows.append({
            "iteration": it, "cmd_gait": gait, "cmd_freq_hz": freq,
            "cmd_vx": vx,
            "vx_rmse": round(float(np.mean(rmsd)), 4),
            "diag": round(g["diag_corr"], 3),
            "pair": round(g["pair_corr"], 3),
            "side": round(g["side_corr"], 3),
            "stride_hz": round(g["stride_freq_hz"], 2),
            "duty": round(float(np.mean(g["duty_factor"])), 3),
            "dominant": g["dominant_gait"],
            "match": g["dominant_gait"] == gait,
        })
    return rows


def obedience_traces(env, policy, cmd, steps, seed):
    """Per-step traces of one commanded rollout for `obedience_stats`:
    base height, roll, pitch, body-frame vx and vy, yaw rate, the world foot
    heights, the yaw-frame foot xy relative to the base (the raibert frame,
    corl_rewards.py:161-202; feet from the plain FK, as the JAX script
    computes them) and the contacts; read back once."""
    from .learn.eval_metrics import rollout
    from .physics.engine import fk
    from .utils import quat as qu
    model = env.model
    feet_body = torch.as_tensor(np.asarray(model.static["feet_body"]),
                                dtype=torch.long, device=env.device)
    feet_pos = model.feet_pos

    def record(world, rew):
        phys = world.env.phys
        body_pos, body_quat, _, _ = fk(model, phys.base_pos, phys.base_quat,
                                       phys.joint_q)
        feet_R = qu.quat_to_matrix(body_quat[:, feet_body])
        feet_w = body_pos[:, feet_body] + torch.einsum(
            "nlij,lj->nli", feet_R, feet_pos)
        rel = feet_w - phys.base_pos[:, None, :]
        qc = qu.quat_conjugate(phys.base_quat)
        feet_b = qu.quat_apply_yaw(qc[:, None, :].expand(-1, 4, -1), rel)
        roll, pitch, _ = qu.quat_to_euler_xyz(phys.base_quat)
        vel_b = qu.quat_rotate_inverse(phys.base_quat, phys.base_lin_vel)
        return {"base_z": phys.base_pos[:, 2], "roll": roll, "pitch": pitch,
                "vx": vel_b[:, 0], "vy": vel_b[:, 1],
                "wz": phys.base_ang_vel[:, 2], "foot_z": feet_w[..., 2],
                "foot_xy": feet_b[..., :2],
                "contact": world.env.last_contacts}

    tr = rollout(env, policy, steps, seed, cmd, record)
    return {k: v.cpu().numpy() for k, v in tr.items()}


def _pitch_target(v: float) -> float:
    """The euler pitch that orientation_control drives toward for the
    pitch command v: it builds the desired base quat from -v about +y
    (corl_rewards.py:148-159)."""
    from .utils import quat as qu
    q = qu.quat_from_angle_axis(torch.tensor(-v, dtype=torch.float32),
                                torch.tensor([0.0, 1.0, 0.0]))
    return float(qu.quat_to_euler_xyz(q)[1])


# the command-obedience sweep over the non-gait dims of the 15-dim MoB
# command (limits: the reference's scripts/go1/train.py:153-182): (dim,
# label, values, target_fn(value, base height target), realized key)
OBEDIENCE_SWEEPS = [
    (3, "body_height", [-0.15, 0.0, 0.10], lambda v, h: h + v, "base_z"),
    (10, "body_pitch", [-0.3, 0.0, 0.3], lambda v, h: _pitch_target(v),
     "pitch"),
    (9, "footswing_height", [0.06, 0.15, 0.30], lambda v, h: v + 0.02,
     "foot_apex"),
    (12, "stance_width", [0.15, 0.25, 0.40], lambda v, h: v, "stance_width"),
    (13, "stance_length", [0.35, 0.45], lambda v, h: v, "stance_length"),
    (1, "vy", [-0.4, 0.4], lambda v, h: v, "vy"),
    (2, "yaw_rate", [-0.8, 0.8], lambda v, h: v, "wz"),
]


def obedience_rows(env, policy, it, vx=0.5, steps=300, seed=0):
    """One row per (dim, value) of `OBEDIENCE_SWEEPS`, each from a trot at
    3 Hz with that one dim changed."""
    from .learn.eval_metrics import obedience_stats
    nc = env.cfg.commands.num_commands
    base_h = env.cfg.rewards.base_height_target
    rows = []
    for dim, label, values, target_fn, key in OBEDIENCE_SWEEPS:
        for v in values:
            cmd = command_vector(nc, vx, gait="trot", freq=3.0)
            cmd[dim] = v
            st = obedience_stats(obedience_traces(env, policy, cmd, steps,
                                                  seed))
            target = float(target_fn(v, base_h))
            realized = st[key]
            rows.append({
                "iteration": it, "dim": dim, "command": label,
                "value": round(v, 3), "target": round(target, 3),
                "realized": round(realized, 4),
                "err": round(realized - target, 4),
                "vx_err": round(st["vx"] - vx, 3),
            })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--num-envs", type=int, default=32)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--vx", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--freqs", default="2.0,3.0",
                    help="trot frequency sweep, comma-separated Hz")
    ap.add_argument("--out", default=None, help="append one JSON line here")
    ap.add_argument("--obedience", action="store_true",
                    help="sweep the non-gait command dims and report "
                         "realized against commanded")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    env, policy, _, it = build(args.checkpoint, args.num_envs,
                               seed=args.seed, device=args.device)
    if args.obedience:
        rows = obedience_rows(env, policy, it, args.vx, args.steps,
                              args.seed)
        for r in rows:
            print(json.dumps(r))
        fixed = {"gait_duration(8)": 0.5, "body_roll(11)": 0.0,
                 "aux_reward_coef(14)": 0.0}
        result = {"checkpoint": args.checkpoint, "iteration": it,
                  "obedience": rows, "fixed_reference_dims": fixed}
        print(json.dumps({"iteration": it, "n_cases": len(rows)}))
    else:
        rows = gait_rows(env, policy, it, args.vx,
                         [float(f) for f in args.freqs.split(",")],
                         args.steps, args.seed)
        for r in rows:
            print(json.dumps(r))
        n_match = sum(r["match"] for r in rows[:4])
        result = {"checkpoint": args.checkpoint, "iteration": it,
                  "gaits_matched": f"{n_match}/4", "rows": rows}
        print(json.dumps({"iteration": it,
                          "gaits_matched": f"{n_match}/4"}))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(result) + "\n")
    return result


if __name__ == "__main__":
    main()
