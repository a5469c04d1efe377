"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. device: the card's name, and its power limit from nvidia-smi;
2. build: both kernels with one nvcc call, with the ptxas lines;
3. kernel A (FK + sphere positions) against its plain PyTorch version at
   4096 envs on random states from a seed;
4. kernel B (the dynamics substep) against its plain version at 4096 envs,
   on flat and on rough ground;
5. 100 substeps from standing through both kernels: finite, base height in
   (0.15, 0.45);
6. training: go1_flat at full width (4096 envs, actor/critic 512-256-128,
   adaptation 256-128, 24 steps x 4 substeps per iteration) for 1 warm-up
   and 3 measured iterations; each kernel's launch count over the measured
   iterations must be iterations x 24 x 4.

Then the kernels line, the nvidia-smi line, and the result line. Exits
non-zero, with no result line, when there is no CUDA device, when the port
cannot be imported, or when any phase fails.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

B = 4096
SEED = 0
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# kernel B vs its plain version: the bars of tests/test_physics_batched.py
# (lin vel 1e-4, joint qd 1e-3, foot forces 1e-1) and the same scale for
# the other outputs (positions 1e-5, angular velocity like joint qd,
# contact force norms like foot forces)
DYN_TOL = {"base_pos": 1e-5, "base_quat": 1e-5, "base_lin_vel": 1e-4,
           "base_ang_vel": 1e-3, "joint_q": 1e-5, "joint_qd": 1e-3,
           "foot_forces": 1e-1, "foot_positions": 1e-5,
           "foot_velocities": 1e-4, "thigh_contact": 1e-1,
           "calf_contact": 1e-1, "base_contact": 1e-1,
           "total_normal_force": 1e-1}
FK_TOL = 1e-5   # tests/test_physics_batched.py:162-188


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean ms per call from CUDA events around `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def random_states(rng, n, device, z=0.30):
    """Random near-standing go1 states (tests/test_physics_batched.py:19-39)."""
    from wtw_tpu_torch.physics import PhysicsState
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
    q = rng.randn(n, 4) * 0.1 + np.array([0.0, 0.0, 0.0, 1.0])
    return PhysicsState(
        base_pos=t(np.concatenate([rng.uniform(-1, 1, (n, 2)),
                                   z + rng.uniform(-0.05, 0.1, (n, 1))], 1)),
        base_quat=t(q / np.linalg.norm(q, axis=1, keepdims=True)),
        base_lin_vel=t(0.5 * rng.randn(n, 3)),
        base_ang_vel=t(0.5 * rng.randn(n, 3)),
        joint_q=t(np.tile([0.0, 0.8, -1.6] * 4, (n, 1))
                  + 0.1 * rng.randn(n, 12)),
        joint_qd=t(0.5 * rng.randn(n, 12)))


def fk_flops(model) -> int:
    """fp32 operations of kernel A per env, counted from csrc/fk.cu: per
    joint two quaternion rotations (30 each), two Hamilton products (28
    each), sin/cos and the anchor (8); per body a rotation matrix (30); per
    sphere a 3x3 product and add (18)."""
    return model.nj * (2 * 30 + 2 * 28 + 8) + model.nb * 30 + model.P * 18


def dynamics_flops(model, active_spheres_per_env: float) -> float:
    """fp32 operations of kernel B per env, counted from csrc/dynamics.cu.
    Fixed part: axes and velocities (24/joint), inertias (~180/body), RNEA
    (45/joint + 117/body), composites and CRBA (~150/joint), rhs (2 nv^2),
    sphere geometry in both passes (~70/sphere), Cholesky (nv^3/3 fma) and
    the two solves (2 nv^2), integration and feet (~250). Per touching
    sphere with its na ancestor dofs: 12 na + 10 na^2 + 60 (rank update)
    and 15 na + 40 (realized force)."""
    nb, nj, nv, P = model.nb, model.nj, model.nv, model.P
    fixed = (24 * nj + 180 * nb + 45 * nj + 117 * nb + 150 * nj
             + 2 * nv * nv + 70 * P + 2 * nv ** 3 / 3 + 2 * nv * nv + 250)
    na = 9
    per_sphere = 12 * na + 10 * na * na + 60 + 15 * na + 40
    return fixed + per_sphere * active_spheres_per_env


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_flops / PEAK_FP32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernel_a(model, dev):
    from wtw_tpu_torch.physics import kernels as K
    rng = np.random.RandomState(SEED)
    st = random_states(rng, B, dev)
    fk_in = torch.cat([st.base_pos, st.base_quat, st.joint_q],
                      1).T.contiguous()
    fb, fp = K.fk(model, fk_in)
    rb, rp = K.fk_plain(model, fk_in)
    torch.cuda.synchronize()
    err = max(float((fb - rb).abs().max()), float((fp - rp).abs().max()))
    if not err <= FK_TOL:
        raise AssertionError(f"kernel A differs from its plain version: "
                             f"{err} > {FK_TOL}")
    ms = cuda_ms(lambda: K.fk(model, fk_in))
    plain = cuda_ms(lambda: K.fk_plain(model, fk_in))
    n_bytes = 4 * (fk_in.numel() + fb.numel() + fp.numel())
    bms, by = bound_ms(n_bytes, fk_flops(model) * B)
    return dict(max_abs_err=err, tolerance=FK_TOL, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, bytes=n_bytes)


def phase_kernel_b(model, dev):
    from wtw_tpu_torch.physics import (EngineParams, flat_heightfield,
                                       make_heightfield)
    from wtw_tpu_torch.physics import kernels as K
    from wtw_tpu_torch.physics.batched import _hf_rows, pack_state_rows
    rng = np.random.RandomState(SEED + 1)
    params = EngineParams()
    st = random_states(rng, B, dev)
    tau = torch.tensor(3.0 * rng.randn(B, 12).astype(np.float32), device=dev)
    fk_in = torch.cat([st.base_pos, st.base_quat, st.joint_q],
                      1).T.contiguous()
    fk_b, fk_p = K.fk_plain(model, fk_in)
    lin = lambda a, b: torch.linspace(a, b, B, device=dev)[None]
    col = lambda v: torch.tensor(v, device=dev)[:, None].expand(3, B)
    env = torch.cat([lin(0.3, 2.0), lin(0.0, 0.4), lin(-0.5, 2.0),
                     col([0.01, -0.005, 0.002]), col([0.1, -0.2, 0.3])],
                    0).contiguous()
    rough = (0.06 * np.random.RandomState(3).randn(80, 80)).astype(np.float32)
    out = {}
    for terrain, hf in (("flat", flat_heightfield(20.0, 0.5, device=dev)),
                        ("rough", make_heightfield(rough, 0.25, [-10.0, -10.0],
                                                   device=dev))):
        hc, duv = _hf_rows(hf, fk_p[0], fk_p[1])
        args = (model, params, pack_state_rows(st, tau), fk_b, fk_p,
                hc.contiguous(), duv.contiguous(), env,
                1.0 / hf.horizontal_scale)
        got = K.dynamics(*args)
        ref = K.dynamics_plain(*args)
        torch.cuda.synchronize()
        lay = K.dyn_out_layout(model.nj)
        g, r = K.unpack_rows(got, lay), K.unpack_rows(ref, lay)
        errs = {k: float((g[k] - r[k]).abs().max()) for k in g}
        bad = {k: e for k, e in errs.items() if not e <= DYN_TOL[k]}
        if bad:
            raise AssertionError(f"kernel B differs from its plain version "
                                 f"on {terrain} ground: {bad}")
        # touching spheres in this run's data: depth along the normal > 0
        (h00, h10, h01, h11), (du, dv) = hc, duv
        h = (h00 * (1 - du) * (1 - dv) + h10 * du * (1 - dv)
             + h01 * (1 - du) * dv + h11 * du * dv)
        inv_s = 1.0 / hf.horizontal_scale
        dhdx = ((h10 - h00) * (1 - dv) + (h11 - h01) * dv) * inv_s
        dhdy = ((h01 - h00) * (1 - du) + (h11 - h10) * du) * inv_s
        depth = ((h - fk_p[2]) * torch.rsqrt(dhdx ** 2 + dhdy ** 2 + 1)
                 + model.sph_radius[:, None])
        active = float((depth > 0).float().sum(0).mean())
        n_bytes = 4 * (sum(a.numel() for a in args[2:8]) + got.numel())
        bms, by = bound_ms(n_bytes, dynamics_flops(model, active) * B)
        out[terrain] = dict(
            max_abs_err=max(errs.values()), errors=errs,
            ms=cuda_ms(lambda: K.dynamics(*args)),
            plain_ms=cuda_ms(lambda: K.dynamics_plain(*args), iters=5),
            bound_ms=bms, bound_by=by, bytes=n_bytes,
            touching_spheres_per_env=active)
    return out


def phase_rollout(model, dev, substeps=100):
    """100 substeps from standing under PD control through both kernels
    (test_batched_multistep_stability)."""
    from wtw_tpu_torch.physics import (EngineParams, PhysicsState,
                                       flat_heightfield, physics_step_batched)
    from wtw_tpu_torch.physics import kernels as K
    hf = flat_heightfield(20.0, 0.5, device=dev)
    q0 = torch.tensor([0.0, 0.8, -1.6] * 4, device=dev).expand(B, 12)
    s = PhysicsState(
        base_pos=torch.tensor([0.0, 0.0, 0.32], device=dev).expand(B, 3),
        base_quat=torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).expand(B, 4),
        base_lin_vel=torch.zeros(B, 3, device=dev),
        base_ang_vel=torch.zeros(B, 3, device=dev),
        joint_q=q0.clone(), joint_qd=torch.zeros(B, 12, device=dev))
    ones, zeros = torch.ones(B, device=dev), torch.zeros(B, device=dev)
    before = (K.FK.launches, K.DYNAMICS.launches)
    for _ in range(substeps):
        tau = 20.0 * (q0 - s.joint_q) - 0.5 * s.joint_qd
        s, _ = physics_step_batched(model, hf, EngineParams(), s, tau, ones,
                                    zeros)
    torch.cuda.synchronize()
    z = s.base_pos[:, 2]
    finite = all(bool(torch.isfinite(getattr(s, f)).all()) for f in (
        "base_pos", "base_quat", "base_lin_vel", "base_ang_vel", "joint_q",
        "joint_qd"))
    launched = (K.FK.launches - before[0], K.DYNAMICS.launches - before[1])
    if not (finite and bool((z > 0.15).all()) and bool((z < 0.45).all())
            and launched == (substeps, substeps)):
        raise AssertionError(f"roll-out failed: finite={finite} z in "
                             f"[{float(z.min())}, {float(z.max())}] "
                             f"launches={launched}")
    return dict(substeps=substeps, z_min=float(z.min()), z_max=float(z.max()),
                launches=launched)


def phase_training(device="cuda", num_envs=B, iterations=3, warmup=1,
                   overrides=()):
    """go1_flat through the port's entry points (`wtw_tpu_torch.train.build`
    and `Runner.learn`). Counts are set to 0 after the warm-up, just before
    the measured iterations, and read just after them."""
    from wtw_tpu_torch.physics import kernels as K
    from wtw_tpu_torch.train import build
    dev = torch.device(device)
    run_dir = tempfile.mkdtemp(prefix="wtw_chip_smoke_")
    try:
        env, runner = build("go1_flat", num_envs, list(overrides), dev,
                            seed=SEED, run_dir=run_dir, log_freq=1,
                            save_interval=0)
        quiet = lambda *a: None
        warm_walls = runner.learn(warmup, log_fn=quiet) if warmup else []
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for k in K.KERNELS:
            k.launches = 0
        walls = runner.learn(iterations, log_fn=quiet)
        launches = {k.name: k.launches for k in K.KERNELS}
        stats = runner.last_stats
        losses = {k: float(stats[k]) for k in (
            "loss", "surrogate_loss", "value_loss", "adaptation_loss",
            "kl_mean")}
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"non-finite losses: {losses}")
        steps = runner.args.num_steps_per_env * env.num_envs
        expected = iterations * runner.args.num_steps_per_env \
            * env.cfg.control.decimation
        return dict(
            num_envs=env.num_envs, iterations=iterations,
            warmup_wall_s=warm_walls, iteration_wall_s=walls,
            env_steps_per_s=[steps / w for w in walls],
            max_memory_allocated=(torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
            losses=losses, launches=launches,
            expected_launches_per_kernel=expected,
            mean_step_reward=float(stats["mean_step_reward"]))
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from wtw_tpu_torch.models import load_robot
        from wtw_tpu_torch.physics import kernels as K
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "unavailable"
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    lib = K.build()
    emit({"phase": "build", "library": os.path.basename(lib.path),
          "nvcc_seconds": lib.build_seconds, "ptxas": lib.ptxas,
          "seconds": time.perf_counter() - t0})

    model = load_robot("go1", device=dev)
    results = {}
    for phase, fn in (("kernel_a", phase_kernel_a), ("kernel_b", phase_kernel_b),
                      ("rollout", phase_rollout)):
        t0 = time.perf_counter()
        results[phase] = fn(model, dev)
        emit({"phase": phase, **results[phase],
              "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    tr = phase_training()
    emit({"phase": "training", **tr, "seconds": time.perf_counter() - t0})
    exp = tr["expected_launches_per_kernel"]
    short = {k: n for k, n in tr["launches"].items() if n < exp}
    if short:
        raise AssertionError(f"kernels launched fewer than {exp} times in "
                             f"training: {short}")
    if any(n != exp for n in tr["launches"].values()):
        emit({"other_launches": {k: n - exp for k, n in
                                 tr["launches"].items()}})

    ka, kb = results["kernel_a"], results["kernel_b"]
    worst_b = max(kb.values(), key=lambda r: r["max_abs_err"])
    kernels = [
        dict(name=K.FK.name, route="cuda", source=K.FK.source,
             replaces=K.FK.replaces, launches=tr["launches"][K.FK.name],
             max_abs_err=ka["max_abs_err"], tolerance=ka["tolerance"],
             ms=ka["ms"], kernel_ms=ka["ms"], plain_ms=ka["plain_ms"],
             bound_ms=ka["bound_ms"], bound_by=ka["bound_by"],
             library_ms=None),
        dict(name=K.DYNAMICS.name, route="cuda", source=K.DYNAMICS.source,
             replaces=K.DYNAMICS.replaces,
             launches=tr["launches"][K.DYNAMICS.name],
             max_abs_err=worst_b["max_abs_err"], tolerance=DYN_TOL,
             ms=kb["flat"]["ms"], kernel_ms=kb["flat"]["ms"],
             plain_ms=kb["flat"]["plain_ms"],
             bound_ms=kb["flat"]["bound_ms"], bound_by=kb["flat"]["bound_by"],
             rough_ms=kb["rough"]["ms"], library_ms=None),
    ]
    emit({"kernels": kernels})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
