"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. device: the card's name, and its power limit from nvidia-smi;
2. build: both kernels with one nvcc call, with the ptxas lines (registers,
   stack, shared memory) and each kernel's launch shape (lanes per env,
   envs per block, shared bytes per block, resident blocks per SM);
3. kernel A (FK + sphere positions) against its plain PyTorch version at
   4096 envs on random states from a seed;
4. kernel B (the dynamics substep) against its plain version at 4096 envs,
   on flat and on rough ground;
5. ragged: both kernels at 4000 envs (not a multiple of a block's envs)
   against their plain versions, on rough ground;
6. 100 substeps from standing through both kernels: finite, base height in
   (0.15, 0.45);
7. training: go1_flat at full width (4096 envs, actor/critic 512-256-128,
   adaptation 256-128, 24 steps x 4 substeps per iteration) for 1 warm-up
   and 3 measured iterations; each kernel's launch count over the measured
   iterations must be iterations x 24 x 4;
8. kernel_a_go2: kernel A against its plain version on Go2 (51 spheres) at
   4096 envs;
9. kernel_b_ceiling: kernel B against its plain version on Go2 at 4096 envs
   over rough ground, under a rough ceiling that some spheres touch (the
   phase fails if none does) and without it;
10. parkour_rollout: 100 substeps of Go2 under PD from standing under the
   crawl barriers of the full parkour course, through both kernels with
   both heightfields: finite, base height over the ground in (0.05, 0.45);
11. parkour_training: Go2 parkour with CaT at full width
   (`wtw_tpu_torch.train_parkour`: 4096 envs, the full 10 x 20 course,
   actor/critic 189-512-256-128) for 1 warm-up and 3 measured iterations;
   each kernel's launch count must grow by exactly iterations x 24 x 4;
12. kernel_b_edges: kernel B against its plain version on go1 at 4000 envs
   over go1_mob's own map (`build_terrain` at its defaults: 30 x 30 cells,
   a 1500 x 1500 field at 0.1 m with a 0 m border), every base within
   0.8 m of an edge or past it, so spheres sit over the last cells and
   beyond them, where the cell coordinates clamp;
13. mob_training: go1_mob, the gait-conditioned MoB recipe, at full width
   (`wtw_tpu_torch.train.build("go1_mob")`: 4000 envs, obs 70 x 30
   history, actor/critic 512-256-128, adaptation 256-128, the actuator net,
   the gait clock and the 1500 x 1500 heightfield on the card, kernel B on
   its go1 rough-ground path) for 1 warm-up and 3 measured iterations;
   each kernel's launch count over the measured iterations must be
   iterations x 24 x 4, and the field on the card must equal a second
   host build of the map (whose seconds it reports);
14. kernel_a_b1, kernel_b_b1, kernel_a_mini_cheetah, kernel_b_mini_cheetah:
   both kernels against their plain versions on B1 (31 spheres, 55.7 kg)
   and the mini-cheetah (52 spheres) at 4096 envs, kernel B on flat and
   rough ground, from random states near each robot's standing pose;
15. rollout_b1, rollout_mini_cheetah: 100 substeps from standing under the
   PD gains of each robot's preset through both kernels: finite, with the
   base height inside (0.4 h, 1.1 h) of the standing height h;
16. terrain_training: Go2Terrain (`train_parkour --task terrain`: 4096
   envs, the 10 x 20-cell Stack-A map with an 8 m border, a 660 x 1160
   field, the trot clock, the Go2 actuator net, no ceiling) for 1 warm-up
   and 3 measured iterations: each kernel launched exactly 288 times, and
   kernel B never given a ceiling (its wrapper's calls are watched); then
   one more measured iteration with `--reward-mode full`
   (terrain_training_full_rewards, 96 launches each);
17. presets_training: go2_flat, b1_flat and mini_cheetah_flat at 4096
   envs, go2_mob at its preset's 4000 (the Go2 actuator net) and b1_mob at
   its preset's 4096 (PD control), go2_mob and b1_mob on the full
   1500 x 1500 map, each for 1 warm-up and 1 measured iteration with
   exactly 96 launches of each kernel;
18. ppo_plus_training and ppornn_training: `train_parkour --algo ppo_plus`
   (the Q head 201-512-256-128, 10 perturbations of each action a policy
   step) and `--algo ppornn` (GRU memories of 256) on the full parkour
   course at 4096 envs, each for 1 warm-up and 2 measured iterations with
   exactly 192 launches of each kernel, every kernel B call with the
   ceiling; ppo_plus also holds `improve_actions` to raising the run's
   mean Q, ppornn its carried hiddens to being zero on exactly the rows of
   the envs whose last step ended in a hard done;
19. rma_training: `train --algo rma` on go1_flat at 4096 envs (obs 42,
   privileged 2, history 630, latent 18), 1 warm-up and 2 measured
   iterations, 192 launches each;
20. pbt_training: `train --pbt 2` on go1_flat, 2 members of 4096 envs, an
   exploit every 2 iterations, 2 measured iterations ending with one: 384
   launches of each kernel, and the bottom member holding its source's
   weights with its lr moved by a factor in [0.8, 1.25];
21. kernel_a_multi, kernel_b_multi: both kernels' mixed-robot path (the
   per-env robot index through the slot table) on go1, go2, b1 and the
   mini-cheetah interleaved (arange % 4) at 4096 envs, from random states
   near each robot's standing pose, against the plain versions on the
   per-env model under the same bars, kernel B on flat and rough ground,
   with the device ms and bound beside go1's single-robot kernel above;
   kernel_a_multi_train, kernel_b_multi_train: the same on train_multi's
   go1/go2/b1 (51 spheres, runs padded with empty slots, which the phase
   requires);
22. multi_pure_go1: every env go1 through the mixed path of a [go1, b1]
   stack, 100 substeps from standing with contacts: bit-identical to the
   single-robot path on the same inputs;
23. multi_rollout: go1/go2/b1/mini-cheetah interleaved at 4096 envs, 100
   substeps from standing under each robot's own preset PD gains: finite,
   and each robot's base height inside (0.4 h, 1.1 h) of its own standing
   height h;
24. multi_training: `train_multi --robots go1,go2,b1` at 4096 envs, actor
   and critic 512-256-128, adaptation 256-128, for 1 warm-up and 2
   measured iterations: exactly 2 x (24 + 1) x 4 = 200 launches of each
   kernel (the extra policy step is the per-robot reward's), finite
   losses, and every `rew_<robot>` finite and non-zero;
25. kernel_b_training_states: kernel B on the inputs of its last call in
   go1_flat's and in multi_training's measured iterations: the mixed case
   against its plain version at the bars and bit-repeatable, kernel A
   relaunched on its states giving the training launch's bits, each
   robot's envs given bit for bit what the single-robot kernel gives them
   on the model the mixed launch staged, and its device time taken apart (no empty slots, columns sorted by robot, each
   robot alone through the single-robot kernel on its own and on its
   padded model) beside go1_flat's, with the touching spheres of each;
26. eval_play: `wtw_tpu_torch.play` (its `main`) on the go1_mob policy of
   phase 13, saved as the runner's `.pt` and reloaded through play's
   loader: the env from the file's config on the full 1500 x 1500 map
   with every DR off except the lag, trot at 3 Hz and vx 1.5 (the JAX
   CLI's defaults), 250 steps at the JAX CLI's 64 envs with
   `--gait-stats`, at the preset's 4000 envs, and at 64 envs under
   `--sweep rand_large`; each kernel launched exactly steps x 4 per
   rollout, every metric finite;
27. eval_gaits: `wtw_tpu_torch.eval_gaits` (its `main`) on the same policy
   at its defaults (32 envs, 300 steps; the four gaits at 3 Hz and the
   trot at 2 Hz): exactly 5 x 300 x 4 launches of each kernel, every row
   finite;
28. diag_parkour: `wtw_tpu_torch.diag_parkour` on the policy of phase 11
   (its `.pt`) on the `gap` course pinned at level 0, 64 envs, up to 700
   steps (it stops once every env's first episode is over, checked every
   50 steps): exactly steps run x 4 launches, every kernel B call with the
   ceiling, and the first episodes' attributions summing to the 64 envs.

29. vision_generate: `wtw_tpu_torch.train_vision generate` (its `main`)
   with the policy of phase 11 as the expert, 1024 envs, 128 steps (the
   JAX run's 512 cut to 128: a 0.44 GB demo buffer), on the full parkour
   course: kernel B 4 launches a step, every call with the ceiling, kernel
   A 5 (4 substeps and the depth camera's frame);
30. vision_train: `train_vision train` on those demos at `DDPGArgs`'
   defaults (the 256-step ring, batch 64 x 5, 10 critics, 8 updates an
   env step), 1024 envs, 16,384 env steps (16 collect steps), 50 BC
   batches and an 8,192-step actor hold, so 8 update rounds hold the actor
   and 8 update it: the same launches a step, finite losses, the student
   moved off its initial weights;
31. vision_eval_student and vision_eval_expert: `train_vision eval`, 1024
   envs, 100 steps, on the student of phase 30 (a frame every step: 5
   kernel A launches a step) and on the expert (4); every value finite;
32. actuator_train: `wtw_tpu_torch.learn.actuator_train` (its `main`), 20
   epochs on a synthetic log from seed 0 on the card: its `.npz` loads
   through `models/actuator_net.py`, the test MAE below the labels' std;
33. sweep: `wtw_tpu_torch.sweep` (its `main`), a 2-point grid of go1_flat
   at 1024 envs, 1 iteration each, every point a subprocess: summary.csv
   with 2 rows.
34. train_go1_mob_bf16: phase 13's go1_mob with `--set
   ac.compute_dtype=bfloat16` (4000 envs, 1 warm-up and 3 measured
   iterations, 288 launches of each kernel): parameters and Adam's moments
   fp32, the stored history bf16, the hidden activations bf16 and the
   tower outputs fp32, the bf16 actor mean on the run's first
   observations within 0.05 of the fp32 one, finite losses, both kernels
   held on kernel B's last call; env steps/s and peak memory beside phase
   13's (`fp32_env_steps_per_s`, `fp32_max_memory_allocated`);
35. dist_go1_flat and dist_parkour: env-sharded data parallelism
   (`wtw_tpu_torch.parallel`), 2 gloo ranks x 2048 envs on the one card
   (worker processes of this script, `--dist-worker`) against 1 x 4096 in
   this one, from the same world and weights, `sharding_invariant`
   learners with 1 epoch (`ppo_cse` on go1_flat; CaT PPO on the full
   course with 4 minibatches, as 6 do not divide 2048 envs), 3
   iterations: every rank exits 0; the ranks' weights bitwise equal after
   every iteration; after the last, weights within 3e-3 of the 1-rank
   run's, base_pos within 1e-3, the loss within 1e-3 relative, and for
   parkour CaT's running max and both normalizers within 1e-3 relative,
   the terrain levels equal and the ceiling on every kernel B call; each
   rank's launches exact and both kernels held on its last call; each
   rank's env steps/s and collective ms an iteration (two ranks on one
   card: no scaling number), and whether the runs agree to the bit;
36. video_record: `utils/video.record_rollout` of phase 13's go1_mob
   policy (through play's loader, 4000 envs), 250 steps of env 0: 1000
   launches of each kernel, a finite (250, 3), (250, 4), (250, 12)
   trajectory, a second record bitwise equal, one device-to-host copy,
   both kernels held on the last call (no rendering: the card's machine
   has no matplotlib).

Each vision run also holds kernel A against its plain version on the
renderer's last inputs (under FK_TOL, or 2 fp32 ulps of the largest
coordinate where the envs sit far out: `_position_bar`) and times the renderer on them
(`render_ms`, CUDA events; `render_peak_bytes`), and reports env steps/s
over its rollout seconds (set-up apart: the env, the expert, the demo
file, and in train the BC batches), `max_memory_allocated`, and in train
the ms of a BC batch and of an update round and the ring's and demos'
bytes.

After each eval run (each of eval_play's three, eval_gaits, diag_parkour,
the four vision runs, and phases 34-36: the bf16 run, each rank and the
1-rank run of both dist phases, the record) both kernels are held against
their plain versions on the inputs of that run's last kernel B call, at
the run's own env count and under the bars of
kernel_b_training_states (diag_parkour's with the ceiling), and kernel A
relaunched on those states must give the bits that call was given
(`last_call`; the kernels line's `eval_states_max_abs_err`). Each eval run
reports its seconds split into set-up (`build_s`: the checkpoint, the env,
the map) and rollouts (`rollout_s`), and its env steps/s and ms per policy
step from the rollout seconds alone.

Every training phase reports env steps/s, `max_memory_allocated` and its
finite losses. With `--kernels` it runs phases 1-5, 8-9, 12, 14 and 21
only (14 where the checkout ships the B1 and mini-cheetah specs, 21 where
its kernels take a per-env model) and prints no result line. This is how two versions of the kernels are compared in one call:
copy this file into the other checkout and run it there with
`--kernels`, then here, on the same cases (an older checkout reports no
launch shape).

Every kernel case also launches the kernel twice on the same inputs and
fails unless the outputs are bit-identical (the single-robot cases print
the sha256 of their outputs, `output_sha256`, to compare two checkouts'
bits), and reports three times: the
device time per launch (`device_ms`: 20 launches captured in a CUDA graph
and replayed between CUDA events), the time per wrapper call (`call_ms`:
CUDA events around 20 back-to-back calls, the wrapper's host work
included) and the plain version's (`plain_ms`). In the kernels line `ms`
and the per-case times (`kernel_ms`, `ceiling_ms`, `go1_ms`, `flat_ms`,
`rough_ms`, `go2_no_ceiling_ms`, `ragged_4000_ms`, `edges_ms`, `b1_ms`,
`b1_flat_ms`, `mini_cheetah_rough_ms`, `multi_ms`, `multi_rough_ms`, ...)
are device times per launch;
before the kernels gave each env a team of lanes they were the
events-over-calls times that are now `call_ms`. The line's `launches` is
each kernel's count in the newest slice's paths (phases 34-36: the bf16
run, every rank and the 1-rank run of both dist phases, the record),
`launches_by_path` holds the counts of every training, eval, vision and
tenth-slice path, and `renderer_max_abs_err` and `render_ms` kernel A's
error and the renderer's ms on each vision run's last frame.

Then the kernels line, the nvidia-smi line, and the result line. Exits
non-zero, with no result line, when there is no CUDA device, when the port
cannot be imported, or when any phase fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

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
    """Mean ms per call from CUDA events around `iters` back-to-back calls
    (the wrapper's host work included: `call_ms`)."""
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


def device_ms(fn, iters=20, warmup=3):
    """Mean device ms per launch: `iters` calls captured in one CUDA graph,
    replayed between CUDA events, so the wrapper's host work drops out."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def check_deterministic(fn, what):
    """Two launches on the same inputs must give the same bits."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(
        a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple)
        else (b,)))
    if not same:
        raise AssertionError(f"{what}: two launches on the same inputs "
                             f"differ")
    return True


def digest(*tensors) -> str:
    """sha256 of the tensors' bytes, so two checkouts' kernels can be held
    to the same bits on the same inputs (`--kernels` in each)."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def timings(fn, plain, plain_iters=20):
    """The kernel's device ms per launch (the `ms` of the kernels line), its
    events-over-calls ms, and the plain version's ms."""
    dev_ms = device_ms(fn)
    return dict(ms=dev_ms, device_ms=dev_ms, call_ms=cuda_ms(fn),
                plain_ms=cuda_ms(plain, iters=plain_iters))


STAND_Q = {"go1": [0.0, 0.8, -1.6] * 4,
           "go2": [0.1, 0.8, -1.5, -0.1, 0.8, -1.5,
                   0.1, 1.0, -1.5, -0.1, 1.0, -1.5],
           # the presets' default poses (config.py: B1_DEFAULT_JOINT_ANGLES;
           # the mini-cheetah takes go1's), joints FR, FL, RR, RL
           "b1": [-0.2, 0.8, -1.5, 0.2, 0.8, -1.5,
                  -0.2, 1.0, -1.6, 0.2, 1.0, -1.6],
           "mini_cheetah": [-0.1, 0.8, -1.5, 0.1, 0.8, -1.5,
                            -0.1, 1.0, -1.5, 0.1, 1.0, -1.5]}
# base height of the random kernel cases: a little below the height at
# which the lowest sphere of the standing pose touches the ground (go1 and
# Go2 0.32 m, B1 0.52 m, the mini-cheetah 0.47 m), so most envs touch
KERNEL_Z = {"go1": 0.30, "go2": 0.30, "b1": 0.49, "mini_cheetah": 0.45}
# the preset each new robot trains with (its gains and default pose)
ROBOT_PRESET = {"b1": "b1_flat", "mini_cheetah": "mini_cheetah_flat"}


def robot_key(model) -> str:
    """go1, go2, b1 or mini_cheetah from the spec's name."""
    return model.name.replace("_description", "")


def random_states(rng, n, device, z=0.30, q0=STAND_Q["go1"]):
    """Random near-standing states (tests/test_physics_batched.py:19-39)."""
    from wtw_tpu_torch.physics import PhysicsState
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
    q = rng.randn(n, 4) * 0.1 + np.array([0.0, 0.0, 0.0, 1.0])
    return PhysicsState(
        base_pos=t(np.concatenate([rng.uniform(-1, 1, (n, 2)),
                                   z + rng.uniform(-0.05, 0.1, (n, 1))], 1)),
        base_quat=t(q / np.linalg.norm(q, axis=1, keepdims=True)),
        base_lin_vel=t(0.5 * rng.randn(n, 3)),
        base_ang_vel=t(0.5 * rng.randn(n, 3)),
        joint_q=t(np.tile(q0, (n, 1)) + 0.1 * rng.randn(n, 12)),
        joint_qd=t(0.5 * rng.randn(n, 12)))


def fk_flops(model) -> int:
    """fp32 operations of kernel A per env, counted from csrc/fk.cu: per
    joint two quaternion rotations (30 each), two Hamilton products (28
    each), sin/cos and the anchor (8); per body a rotation matrix (30); per
    sphere a 3x3 product and add (18)."""
    return model.nj * (2 * 30 + 2 * 28 + 8) + model.nb * 30 + model.P * 18


def dynamics_flops(model, active_spheres_per_env: float,
                   ceiling: bool = False) -> float:
    """fp32 operations of kernel B per env, counted from csrc/dynamics.cu.
    Fixed part: per body its pose, rotation and inertia (~180), bias force
    and momentum (~117), new velocity (12) and subtree sums (52 a non-root
    body); per joint its axis (9), velocity and acceleration (45), and
    composite and contact axis forces (~100); per dof its rhs row (~40);
    per nonzero lower entry of the system ~25; the factorization (3 per
    ancestor pair of each dof, ~150 for the base block) and the forward
    solve (2 per ancestor); ground geometry in both contact passes (~70 a
    sphere; the ceiling's depth is 3); integration and feet (~250). Per
    touching sphere, ground or ceiling: its terms and contact sums (~180)
    and its realized force (~60)."""
    nb, nj, nv, P = model.nb, model.nj, model.nv, model.P
    anc = model.static["anc"]
    n_anc = [int((anc[b] > 0.5).sum()) for b in range(nb)]
    nnz = 21 + sum(n_anc[1:])
    pairs = sum(3 * (n - 1) * n // 2 for n in n_anc[1:])
    fixed = (nb * (180 + 117 + 12) + 52 * (nb - 1) + nj * (9 + 45 + 100)
             + 40 * nv + 25 * nnz + pairs + 150 + 2 * sum(n_anc[1:])
             + 2 * (70 * P + (3 * P if ceiling else 0)) + 250)
    return fixed + 240 * active_spheres_per_env


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_flops / PEAK_FP32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernel_a(model, dev, n=B):
    from wtw_tpu_torch.physics import kernels as K
    rng = np.random.RandomState(SEED)
    st = random_states(rng, n, dev, z=KERNEL_Z[robot_key(model)],
                       q0=STAND_Q[robot_key(model)])
    fk_in = torch.cat([st.base_pos, st.base_quat, st.joint_q],
                      1).T.contiguous()
    fb, fp = K.fk(model, fk_in)
    rb, rp = K.fk_plain(model, fk_in)
    torch.cuda.synchronize()
    err = max(float((fb - rb).abs().max()), float((fp - rp).abs().max()))
    if not err <= FK_TOL:
        raise AssertionError(f"kernel A differs from its plain version "
                             f"({model.name}, {n} envs): {err} > {FK_TOL}")
    call = lambda: K.fk(model, fk_in)
    check_deterministic(call, f"kernel A ({model.name}, {n} envs)")
    n_bytes = 4 * (fk_in.numel() + fb.numel() + fp.numel())
    bms, by = bound_ms(n_bytes, fk_flops(model) * n)
    return dict(num_envs=n, max_abs_err=err, tolerance=FK_TOL,
                deterministic=True, output_sha256=digest(fb, fp),
                **timings(call, lambda: K.fk_plain(model, fk_in)),
                bound_ms=bms, bound_by=by, bytes=n_bytes)


def phase_kernel_b(model, dev, n=B, terrains=("flat", "rough")):
    from wtw_tpu_torch.physics import (EngineParams, flat_heightfield,
                                       make_heightfield)
    from wtw_tpu_torch.physics import kernels as K
    from wtw_tpu_torch.physics.batched import _hf_rows
    params = EngineParams()
    srows, fk_b, fk_p, env = _dyn_case(model, dev,
                                       np.random.RandomState(SEED + 1), n=n)
    rough = (0.06 * np.random.RandomState(3).randn(80, 80)).astype(np.float32)
    fields = {"flat": lambda: flat_heightfield(20.0, 0.5, device=dev),
              "rough": lambda: make_heightfield(rough, 0.25, [-10.0, -10.0],
                                                device=dev)}
    out = {}
    for terrain in terrains:
        hf = fields[terrain]()
        hc, duv = _hf_rows(hf, fk_p[0], fk_p[1])
        args = (model, params, srows, fk_b, fk_p, hc.contiguous(),
                duv.contiguous(), env, 1.0 / hf.horizontal_scale)
        got = K.dynamics(*args)
        ref = K.dynamics_plain(*args)
        torch.cuda.synchronize()
        what = f"on {terrain} ground ({model.name}, {n} envs)"
        errs = _compare_dyn(K, model, got, ref, what)
        call = lambda: K.dynamics(*args)
        check_deterministic(call, f"kernel B {what}")
        # touching spheres in this run's data: depth along the normal > 0
        active = _ground_touching(model, hf, hc, duv, fk_p)
        n_bytes = 4 * (sum(a.numel() for a in args[2:8]) + got.numel())
        bms, by = bound_ms(n_bytes, dynamics_flops(model, active) * n)
        out[terrain] = dict(
            num_envs=n, max_abs_err=max(errs.values()), errors=errs,
            deterministic=True, output_sha256=digest(got),
            **timings(call, lambda: K.dynamics_plain(*args), plain_iters=5),
            bound_ms=bms, bound_by=by, bytes=n_bytes,
            touching_spheres_per_env=active)
    return out


def phase_kernel_b_edges(model, dev, n=4000):
    """go1 over go1_mob's 150 m x 150 m map with every base within 0.8 m of
    one of its four edges or past it (the map has no border, and teleport
    is off in go1_mob, so a robot can walk off it): the corner rows come
    from the clamped cell coordinates, as in the env."""
    from wtw_tpu_torch.config import go1_mob_config
    from wtw_tpu_torch.physics import EngineParams
    from wtw_tpu_torch.physics import kernels as K
    from wtw_tpu_torch.physics.batched import _hf_rows, pack_state_rows
    from wtw_tpu_torch.terrain import build_terrain, to_heightfield
    hf = to_heightfield(build_terrain(go1_mob_config().terrain, seed=SEED),
                        dev)
    ext = hf.shape[0] * hf.horizontal_scale
    rng = np.random.RandomState(SEED + 4)
    st = random_states(rng, n, dev, z=0.32)
    edge = rng.randint(0, 4, n)
    near = np.where(edge % 2 == 0, rng.uniform(-0.8, 0.8, n),
                    ext + rng.uniform(-0.8, 0.8, n))
    along = rng.uniform(0.0, ext, n)
    xy = np.where((edge < 2)[:, None], np.stack([near, along], 1),
                  np.stack([along, near], 1)).astype(np.float32)
    st.base_pos[:, :2] = torch.from_numpy(xy).to(dev)
    tau = torch.tensor(3.0 * rng.randn(n, 12).astype(np.float32), device=dev)
    fk_in = torch.cat([st.base_pos, st.base_quat, st.joint_q],
                      1).T.contiguous()
    fk_b, fk_p = K.fk_plain(model, fk_in)
    srows = pack_state_rows(st, tau)
    _, _, _, env = _dyn_case(model, dev, np.random.RandomState(SEED + 1),
                             n=n)
    hc, duv = _hf_rows(hf, fk_p[0], fk_p[1])
    args = (model, EngineParams(), srows, fk_b, fk_p, hc.contiguous(),
            duv.contiguous(), env, 1.0 / hf.horizontal_scale)
    got, ref = K.dynamics(*args), K.dynamics_plain(*args)
    torch.cuda.synchronize()
    # world positions 150 m from the origin carry fp32 steps of 2^-16 m
    # (1.5e-5): positions are held to 1e-5 or 2 of those steps, whichever
    # is larger; every other output to DYN_TOL
    pos_tol = max(DYN_TOL["foot_positions"],
                  2.0 * float(np.spacing(np.float32(ext))))
    tol = dict(DYN_TOL, base_pos=pos_tol, foot_positions=pos_tol)
    errs = _compare_dyn(K, model, got, ref, "at the edges of go1_mob's map",
                        tol)
    call = lambda: K.dynamics(*args)
    check_deterministic(call, "kernel B at the edges of go1_mob's map")
    outside = ((fk_p[0] < 0) | (fk_p[0] > ext) | (fk_p[1] < 0)
               | (fk_p[1] > ext)).float().mean()
    active = _ground_touching(model, hf, hc, duv, fk_p)
    n_bytes = 4 * (sum(a.numel() for a in args[2:8]) + got.numel())
    bms, by = bound_ms(n_bytes, dynamics_flops(model, active) * n)
    return dict(num_envs=n, heightfield_shape=list(hf.shape),
                max_abs_err=max(errs.values()), errors=errs,
                position_tolerance=pos_tol,
                deterministic=True, spheres_outside_share=float(outside),
                **timings(call, lambda: K.dynamics_plain(*args),
                          plain_iters=5),
                bound_ms=bms, bound_by=by, bytes=n_bytes,
                touching_spheres_per_env=active)


def phase_ragged(model, dev, n=4000):
    """Both kernels at 4000 envs (go1_mob's default; not a multiple of a
    block's envs) against their plain versions, on rough ground."""
    return dict(kernel_a=phase_kernel_a(model, dev, n=n),
                kernel_b=phase_kernel_b(model, dev, n=n,
                                        terrains=("rough",))["rough"])


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


def standing_height(model, q0) -> float:
    """The base height at which the lowest sphere of pose q0 touches flat
    ground (kernel A's plain version on one env)."""
    from wtw_tpu_torch.physics import kernels as K
    dev = q0.device
    fk_in = torch.cat([torch.zeros(3, device=dev),
                       torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev),
                       q0])[:, None].contiguous()
    _, fk_p = K.fk_plain(model, fk_in)
    return float(-(fk_p[2, :, 0] - model.sph_radius).min())


def phase_robot_rollout(model, dev, substeps=100):
    """100 substeps from standing under the PD gains of the robot's preset
    (B1: kp 100, kd 2.5; the mini-cheetah: kp 20, kd 0.5) through both
    kernels, from the preset's default pose with the base at its standing
    height h (the lowest sphere on the ground): finite, and the base
    height in (0.4 h, 1.1 h). The plain versions settle B1 at ~0.57 h and
    the mini-cheetah at ~0.57 h in this window (go1 at ~0.88 h)."""
    from wtw_tpu_torch import config as C
    from wtw_tpu_torch.models.robot import default_joint_angles
    from wtw_tpu_torch.physics import (EngineParams, PhysicsState,
                                       flat_heightfield, physics_step_batched)
    from wtw_tpu_torch.physics import kernels as K
    ctrl = C.PRESETS[ROBOT_PRESET[robot_key(model)]]()
    q0 = default_joint_angles(model,
                              dict(ctrl.init_state.default_joint_angles))
    kp, kd = ctrl.control.stiffness, ctrl.control.damping
    h = standing_height(model, q0)
    lo, hi = 0.4 * h, 1.1 * h
    hf = flat_heightfield(20.0, 0.5, device=dev)
    s = PhysicsState(
        base_pos=torch.tensor([0.0, 0.0, h], device=dev).expand(B, 3),
        base_quat=torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).expand(B, 4),
        base_lin_vel=torch.zeros(B, 3, device=dev),
        base_ang_vel=torch.zeros(B, 3, device=dev),
        joint_q=q0.expand(B, 12).clone(),
        joint_qd=torch.zeros(B, 12, device=dev))
    ones, zeros = torch.ones(B, device=dev), torch.zeros(B, device=dev)
    before = (K.FK.launches, K.DYNAMICS.launches)
    for _ in range(substeps):
        tau = kp * (q0 - s.joint_q) - kd * s.joint_qd
        s, _ = physics_step_batched(model, hf, EngineParams(), s, tau, ones,
                                    zeros)
    torch.cuda.synchronize()
    z = s.base_pos[:, 2]
    finite = all(bool(torch.isfinite(getattr(s, f)).all()) for f in (
        "base_pos", "base_quat", "base_lin_vel", "base_ang_vel", "joint_q",
        "joint_qd"))
    launched = (K.FK.launches - before[0], K.DYNAMICS.launches - before[1])
    if not (finite and bool((z > lo).all()) and bool((z < hi).all())
            and launched == (substeps, substeps)):
        raise AssertionError(
            f"{model.name} roll-out failed: finite={finite} z in "
            f"[{float(z.min())}, {float(z.max())}], bounds ({lo}, {hi}), "
            f"launches={launched}")
    return dict(substeps=substeps, kp=kp, kd=kd, standing_height=h,
                z_bounds=[lo, hi], z_min=float(z.min()),
                z_max=float(z.max()), launches=launched)


def _dyn_case(model, dev, rng, n=B):
    """Kernel B's inputs at n envs from random near-standing states."""
    from wtw_tpu_torch.physics import kernels as K
    from wtw_tpu_torch.physics.batched import pack_state_rows
    key = robot_key(model)
    st = random_states(rng, n, dev, z=KERNEL_Z[key], q0=STAND_Q[key])
    tau = torch.tensor(3.0 * rng.randn(n, 12).astype(np.float32), device=dev)
    fk_in = torch.cat([st.base_pos, st.base_quat, st.joint_q],
                      1).T.contiguous()
    fk_b, fk_p = K.fk_plain(model, fk_in)
    lin = lambda a, b: torch.linspace(a, b, n, device=dev)[None]
    col = lambda v: torch.tensor(v, device=dev)[:, None].expand(3, n)
    env = torch.cat([lin(0.3, 2.0), lin(0.0, 0.4), lin(-0.5, 2.0),
                     col([0.01, -0.005, 0.002]), col([0.1, -0.2, 0.3])],
                    0).contiguous()
    return pack_state_rows(st, tau), fk_b, fk_p, env


def _ground_touching(model, hf, hc, duv, fk_p) -> float:
    """Spheres per env whose depth along the ground normal is > 0."""
    return float(_touching(model.sph_radius[:, None],
                           1.0 / hf.horizontal_scale, hc, duv, fk_p).mean())


def _compare_dyn(K, model, got, ref, what, tol=DYN_TOL):
    lay = K.dyn_out_layout(model.nj)
    g, r = K.unpack_rows(got, lay), K.unpack_rows(ref, lay)
    errs = {k: float((g[k] - r[k]).abs().max()) for k in g}
    bad = {k: e for k, e in errs.items() if not e <= tol[k]}
    if bad:
        raise AssertionError(f"kernel B differs from its plain version "
                             f"{what}: {bad}")
    return errs


def phase_kernel_b_ceiling(model, dev):
    """Go2 over rough ground under a rough ceiling at 0.36 +- 0.02 m: the
    base's top spheres (0.077 m above a base at 0.25-0.40 m) reach it."""
    from wtw_tpu_torch.physics import make_heightfield
    from wtw_tpu_torch.physics import kernels as K
    from wtw_tpu_torch.physics.batched import _hf_height, _hf_rows
    params = K.EngineParams()
    srows, fk_b, fk_p, env = _dyn_case(model, dev,
                                       np.random.RandomState(SEED + 2))
    ground = (0.03 * np.random.RandomState(3).randn(80, 80)).astype(
        np.float32)
    ceil = (0.36 + 0.02 * np.random.RandomState(5).randn(80, 80)).astype(
        np.float32)
    hf = make_heightfield(ground, 0.25, [-10.0, -10.0], device=dev)
    hf_c = make_heightfield(ceil, 0.25, [-10.0, -10.0], device=dev)
    hc, duv = _hf_rows(hf, fk_p[0], fk_p[1])
    ceil_h = _hf_height(hf_c, fk_p[0], fk_p[1]).contiguous()
    args = (model, params, srows, fk_b, fk_p, hc.contiguous(),
            duv.contiguous(), env, 1.0 / hf.horizontal_scale)
    got = K.dynamics(*args, ceil_h=ceil_h)
    ref = K.dynamics_plain(*args, ceil_h=ceil_h)
    got0, ref0 = K.dynamics(*args), K.dynamics_plain(*args)
    torch.cuda.synchronize()
    errs = _compare_dyn(K, model, got, ref, "under the ceiling")
    errs0 = _compare_dyn(K, model, got0, ref0, "on Go2 without the ceiling")
    call = lambda: K.dynamics(*args, ceil_h=ceil_h)
    call0 = lambda: K.dynamics(*args)
    check_deterministic(call, "kernel B under the ceiling")
    check_deterministic(call0, "kernel B on Go2 without the ceiling")
    touching_c = float((fk_p[2] + model.sph_radius[:, None] > ceil_h)
                       .float().sum(0).mean())
    if not touching_c > 0:
        raise AssertionError("no sphere touches the ceiling: the ceiling "
                             "pass would be compared vacuously")
    touching_g = _ground_touching(model, hf, hc, duv, fk_p)
    n_bytes = 4 * (sum(a.numel() for a in args[2:8]) + ceil_h.numel()
                   + got.numel())
    bms, by = bound_ms(n_bytes, dynamics_flops(
        model, touching_g + touching_c, ceiling=True) * B)
    n_bytes0 = n_bytes - 4 * ceil_h.numel()
    bms0, by0 = bound_ms(n_bytes0, dynamics_flops(model, touching_g) * B)
    t0 = timings(call0, lambda: K.dynamics_plain(*args), plain_iters=5)
    return dict(
        max_abs_err=max(errs.values()), errors=errs, deterministic=True,
        **timings(call, lambda: K.dynamics_plain(*args, ceil_h=ceil_h),
                  plain_iters=5),
        bound_ms=bms, bound_by=by, bytes=n_bytes,
        no_ceiling_max_abs_err=max(errs0.values()), no_ceiling_errors=errs0,
        no_ceiling_ms=t0["device_ms"], no_ceiling_call_ms=t0["call_ms"],
        no_ceiling_plain_ms=t0["plain_ms"],
        no_ceiling_bound_ms=bms0, no_ceiling_bound_by=by0,
        touching_ceiling_spheres_per_env=touching_c,
        touching_ground_spheres_per_env=touching_g)


def phase_parkour_rollout(model, dev, substeps=100):
    """100 substeps under PD from standing under the crawl barriers of the
    full parkour course (`build_parkour` at its defaults, seed 0), corner
    rows cached over each group of 4 substeps as in the env."""
    from wtw_tpu_torch.envs.parkour_env import GO2_DEFAULT_JOINT_ANGLES
    from wtw_tpu_torch.models.robot import default_joint_angles
    from wtw_tpu_torch.physics import (EngineParams, PhysicsState,
                                       physics_step_batched)
    from wtw_tpu_torch.physics import kernels as K
    from wtw_tpu_torch.physics.batched import _hf_height
    from wtw_tpu_torch.physics.heightfield import height_at
    from wtw_tpu_torch.terrain import (ParkourTerrainCfg, build_parkour,
                                       ceiling_heightfield, to_heightfield)
    from wtw_tpu_torch.train_parkour import column_kinds
    tcfg = ParkourTerrainCfg()
    tm = build_parkour(tcfg, seed=SEED)
    hf, hf_c = to_heightfield(tm, dev), ceiling_heightfield(tm, dev)
    crawl = column_kinds(tcfg)["crawl"]
    e = torch.arange(B, device=dev)
    lvl = e % tcfg.num_levels
    col = torch.tensor(crawl, device=dev)[(e // tcfg.num_levels) % len(crawl)]
    jit = torch.rand(B, 2, generator=torch.Generator(device=dev).manual_seed(
        SEED), device=dev) - 0.5
    # over the first barrier (x in [2, 3) m of each track), base at 0.30 m
    x = lvl * tcfg.map_length + 2.5 + 0.6 * jit[:, 0]
    y = (col + 0.5) * tcfg.map_width + 0.6 * jit[:, 1]
    q0 = default_joint_angles(model, dict(GO2_DEFAULT_JOINT_ANGLES))
    s = PhysicsState(
        base_pos=torch.stack([x, y, torch.full_like(x, 0.30)], -1),
        base_quat=torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).expand(B, 4),
        base_lin_vel=torch.zeros(B, 3, device=dev),
        base_ang_vel=torch.zeros(B, 3, device=dev),
        joint_q=q0.expand(B, 12).clone(),
        joint_qd=torch.zeros(B, 12, device=dev))
    fk_in = torch.cat([s.base_pos, s.base_quat, s.joint_q], 1).T.contiguous()
    _, fk_p = K.fk_plain(model, fk_in)
    touching = float((fk_p[2] + model.sph_radius[:, None]
                      > _hf_height(hf_c, fk_p[0], fk_p[1]))
                     .float().sum(0).mean())
    ones = torch.ones(B, device=dev)
    before = (K.FK.launches, K.DYNAMICS.launches)
    cache = None
    for i in range(substeps):
        tau = 20.0 * (q0 - s.joint_q) - 0.5 * s.joint_qd
        if i % 4 == 0:
            s, _, cache = physics_step_batched(
                model, hf, EngineParams(), s, tau, ones, 0.0,
                hf_ceiling=hf_c, return_hf_cache=True)
        else:
            s, _ = physics_step_batched(model, hf, EngineParams(), s, tau,
                                        ones, 0.0, hf_ceiling=hf_c,
                                        hf_cache=cache)
    torch.cuda.synchronize()
    rel_z = s.base_pos[:, 2] - height_at(hf, s.base_pos[:, :2])
    finite = all(bool(torch.isfinite(getattr(s, f)).all()) for f in (
        "base_pos", "base_quat", "base_lin_vel", "base_ang_vel", "joint_q",
        "joint_qd"))
    launched = (K.FK.launches - before[0], K.DYNAMICS.launches - before[1])
    if not (finite and bool((rel_z > 0.05).all())
            and bool((rel_z < 0.45).all()) and touching > 0
            and launched == (substeps, substeps)):
        raise AssertionError(
            f"parkour roll-out failed: finite={finite} base height in "
            f"[{float(rel_z.min())}, {float(rel_z.max())}] touching "
            f"ceiling at start={touching} launches={launched}")
    return dict(substeps=substeps, heightfield_cells=hf.heights.numel(),
                touching_ceiling_spheres_per_env_at_start=touching,
                base_height_min=float(rel_z.min()),
                base_height_max=float(rel_z.max()), launches=launched)


class Counted:
    """The kernels' launches inside the block, every count set to 0 on
    entry and read on exit, with the block's seconds: `launches`, each
    kernel's launches on the device, made by its wrapper or by the replays
    of a captured CUDA graph (the parkour env step); `replayed_launches`,
    the part the replays made (replays times the launches their capture
    made); `dynamics_launches_with_ceiling`, kernel B's launches, made or
    replayed, that ran its ceiling pass. Kernel B's wrapper
    `kernels.dynamics`, which the physics entry calls through the module,
    is wrapped meanwhile: `dynamics_calls_with_ceiling` counts its calls
    that pass a ceiling (`ceil_h`; on the CPU, where nothing launches, the
    plain version's calls), and `last` keeps the last call's arguments
    (the physics entry builds them anew for every call). A call inside a
    capture keeps clones of its tensors, made by the graph, so that after
    the block they hold the inputs of that call's last replay."""

    def __enter__(self):
        from wtw_tpu_torch.physics import kernels as K
        self.K, self.real = K, K.dynamics
        self.dynamics_calls_with_ceiling, self.last = 0, None
        for k in K.KERNELS:
            k.launches = k.ceiling_launches = 0
            k.replayed = k.replayed_ceiling = 0

        def watched(*args, **kw):
            if kw.get("ceil_h") is not None:
                self.dynamics_calls_with_ceiling += 1
            if (args[2].is_cuda
                    and torch.cuda.is_current_stream_capturing()):
                keep = lambda x: x.clone() if torch.is_tensor(x) else x
                self.last = ([keep(a) for a in args],
                             {n: keep(v) for n, v in kw.items()})
            else:
                self.last = (args, dict(kw))
            return self.real(*args, **kw)
        K.dynamics = watched
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        self.K.dynamics = self.real
        self.launches = {k.name: k.launches + k.replayed
                         for k in self.K.KERNELS}
        self.replayed_launches = {k.name: k.replayed for k in self.K.KERNELS}
        self.dynamics_launches_with_ceiling = (
            self.K.DYNAMICS.ceiling_launches
            + self.K.DYNAMICS.replayed_ceiling)

    def record(self):
        """The counts, as a phase's record holds them."""
        return dict(launches=self.launches,
                    replayed_launches=self.replayed_launches,
                    dynamics_calls_with_ceiling=(
                        self.dynamics_calls_with_ceiling),
                    dynamics_launches_with_ceiling=(
                        self.dynamics_launches_with_ceiling))


def _measure(runner_learn, dev, iterations, warmup, num_envs, num_steps,
             keep=None):
    """Warm-up, then the measured iterations inside `Counted`: -> (warm-up
    walls, walls, launches, calls of kernel B with a ceiling, env steps/s,
    peak memory). `keep` (a dict) receives the arguments of kernel B's
    last call in the measured iterations under "dynamics"."""
    quiet = lambda *a: None
    warm = runner_learn(warmup, log_fn=quiet) if warmup else []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with Counted() as c:
        walls = runner_learn(iterations, log_fn=quiet)
    if keep is not None:
        keep["dynamics"] = c.last
    return dict(warmup_wall_s=warm, iteration_wall_s=walls,
                env_steps_per_s=[num_steps * num_envs / w for w in walls],
                max_memory_allocated=(torch.cuda.max_memory_allocated(dev)
                                      if dev.type == "cuda" else None),
                **c.record())


def _finite(losses, what):
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{what}: non-finite losses: {losses}")
    return losses


def phase_parkour_training(device="cuda", num_envs=B, iterations=3, warmup=1,
                           overrides=(), task="parkour", reward_mode=None,
                           algo="ppo", checkpoint_to=None):
    """`train_parkour` through the port's entry points
    (`wtw_tpu_torch.train_parkour.build` and `ParkourRunner.learn`): Go2
    parkour on the full course, or with `task="terrain"` Go2Terrain on its
    Stack-A map (no ceiling), unless `overrides` cut them, with the learner
    `algo` (ppo, ppo_plus or ppornn). Counts are set to 0 after the
    warm-up, just before the measured iterations, and read just after;
    kernel B's calls that carried a ceiling are counted too. ppo_plus also
    checks that `improve_actions` (the CPU test's 64 perturbations, sigma
    0.1, alpha 0.5, 3 rounds) raises the run's mean Q on the run's last
    observations; ppornn that the carried hiddens are zero on the rows of
    the envs whose last step ended in a hard done and nonzero elsewhere.
    `checkpoint_to`: a path that receives the run's `state_last.pt`."""
    from wtw_tpu_torch.train_parkour import build
    dev = torch.device(device)
    run_dir = tempfile.mkdtemp(prefix=f"wtw_chip_smoke_{task}_{algo}_")
    try:
        t0 = time.perf_counter()
        runner = build(num_envs, list(overrides), dev, seed=SEED,
                       run_dir=run_dir, log_freq=1, save_interval=0,
                       task=task, reward_mode=reward_mode, algo=algo)
        build_s = time.perf_counter() - t0
        env, ln = runner.env, runner.learner
        with HardDoneWatch(env) as hard:
            rec = _measure(runner.learn, dev, iterations, warmup,
                           env.num_envs, ln.args.num_steps)
        stats = runner.last_stats
        losses = _finite({k: float(stats[k]) for k in ln.LOSS_KEYS},
                         f"{task} training ({algo})")
        checks = {}
        if algo == "ppo_plus":
            checks = _check_improvement(ln, runner.obs_n)
        elif algo == "ppornn":
            checks = _check_hiddens(ln, hard.total)
        if checkpoint_to:
            shutil.copy(os.path.join(run_dir, "state_last.pt"), checkpoint_to)
        return dict(
            task=task, algo=algo, reward_mode=env.cfg.reward_mode,
            num_envs=env.num_envs, num_obs=env.num_obs,
            heightfield_shape=list(env.hf.shape),
            has_ceiling=env.hf_ceiling is not None,
            ceiling_flat=(None if env.hf_ceiling is None
                          else env.hf_ceiling.is_flat),
            actuator_net=env.actuator_params is not None,
            gait_clock=env.cfg.use_gait_clocks, build_s=build_s,
            iterations=iterations, **rec, losses=losses, **checks,
            expected_launches_per_kernel=(
                iterations * ln.args.num_steps * env.cfg.decimation),
            terrain_level_mean=float(stats.get("terrain_level_mean", 0.0)),
            mean_step_reward=float(stats["mean_step_reward"]))
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


class HardDoneWatch:
    """Counts, on the device, the hard dones the env's steps return, by
    wrapping the env object's `step`; `total` is read after the run."""

    def __init__(self, env):
        self.env, self.count = env, 0

    def __enter__(self):
        real = self.env.step

        def watched(*args, **kw):
            out = real(*args, **kw)
            self.count = self.count + out[4]["true_dones"].sum()
            return out
        self.env.step = watched
        return self

    def __exit__(self, *exc):
        del self.env.step

    @property
    def total(self) -> int:
        return int(self.count)


@torch.no_grad()
def _check_improvement(ln, obs_n):
    """`improve_actions` with tests/test_learners.py's settings on the
    run's Q head and last observations must raise the mean Q."""
    from wtw_tpu_torch.learn.cat_ppo_plus import improve_actions
    args = dataclasses.replace(ln.args, n_perturbations=64, sigma=0.1,
                               alpha=0.5, num_improvement_steps=3)
    gen = torch.Generator(device=obs_n.device).manual_seed(SEED)
    agent = ln.agent
    mean = agent.actor_mean(obs_n)
    a0 = mean + torch.exp(agent.actor_logstd) * torch.randn(
        mean.shape, generator=gen, device=mean.device)
    noise = torch.randn((3, 64) + tuple(a0.shape), generator=gen,
                        device=a0.device)
    a1 = improve_actions(agent, obs_n, a0, noise, args)
    q0 = float(agent.q_value(obs_n, a0).mean())
    q1 = float(agent.q_value(obs_n, a1).mean())
    if not q1 > q0:
        raise AssertionError(f"improve_actions lowered the mean Q: {q0} -> "
                             f"{q1}")
    return dict(improvement={"q_before": q0, "q_after": q1, "rows": int(
        obs_n.shape[0])})


def _check_hiddens(ln, hard_dones_in_run):
    """The carried hiddens after the run: zero on the rows of the envs
    whose last step ended in a hard done, nonzero on every other row."""
    done = ln.next_true_done > 0.5
    out = {}
    for name in ("ac_hidden", "cr_hidden"):
        norm = getattr(ln, name).abs().sum(1)
        if bool((norm[done] != 0).any()) or not bool((norm[~done] > 0).all()):
            raise AssertionError(f"ppornn: {name} not zeroed on exactly the "
                                 f"hard-done rows")
        out[f"{name}_mean_abs"] = float(getattr(ln, name).abs().mean())
    return dict(hiddens={**out, "hard_done_rows_last_step": int(done.sum()),
                         "hard_dones_in_run": hard_dones_in_run})


def _check_launches(name, rec):
    """Each kernel of the path launched exactly iterations x 24 x 4 times
    in the measured iterations."""
    exp = rec["expected_launches_per_kernel"]
    off = {k: n for k, n in rec["launches"].items() if n != exp}
    if off:
        raise AssertionError(f"{name}: kernels launched other than {exp} "
                             f"times in the measured iterations: {off}")


def _check_ceiling(name, rec):
    """Kernel B launched in the measured iterations, and ran its ceiling
    pass in every launch, made or replayed."""
    n, m = rec["launches"]["dynamics"], rec["dynamics_launches_with_ceiling"]
    if n == 0 or m != n:
        raise AssertionError(f"{name}: kernel B ran without the ceiling ({m} "
                             f"of its {n} launches with it)")


def phase_preset_training(preset, device="cuda", num_envs=None, iterations=3,
                          warmup=1, overrides=(), algo="ppo_cse", keep=None,
                          checkpoint_to=None):
    """A preset of `wtw_tpu_torch.train` through the port's entry points
    (`train.build` and the runner's `learn`: `Runner`, or `RMARunner` with
    `algo="rma"`) at `num_envs`, or the preset's own count. On a Stack-A
    map, the field on the card must equal a second host build of the map
    (whose seconds it reports). Counts are set to 0 after the warm-up, just
    before the measured iterations, and read just after them. `keep`: see
    `_measure`. `checkpoint_to`: a path that receives the run's
    `state_last.pt`."""
    from wtw_tpu_torch.terrain import build_terrain
    from wtw_tpu_torch.train import build
    dev = torch.device(device)
    run_dir = tempfile.mkdtemp(prefix=f"wtw_chip_smoke_{preset}_")
    try:
        t0 = time.perf_counter()
        env, runner = build(preset, num_envs, list(overrides), dev,
                            seed=SEED, run_dir=run_dir, log_freq=1,
                            save_interval=0, algo=algo)
        build_s = time.perf_counter() - t0
        terrain = {}
        if not env.hf.is_flat:
            t0 = time.perf_counter()
            tm = build_terrain(env.cfg.terrain, seed=SEED)
            terrain = dict(heightfield_shape=list(env.hf.shape),
                           terrain_build_s=time.perf_counter() - t0)
            if not torch.equal(env.hf.heights.cpu(),
                               torch.from_numpy(tm.heights)):
                raise AssertionError(f"{preset}: the heightfield on the "
                                     f"device is not the host's map")
        rec = _measure(runner.learn, dev, iterations, warmup, env.num_envs,
                       runner.args.num_steps_per_env, keep)
        stats = runner.last_stats
        losses = _finite({k: float(stats[k]) for k in (
            "loss", "surrogate_loss", "value_loss", "adaptation_loss",
            "kl_mean")}, f"{preset} training ({algo})")
        if checkpoint_to:
            shutil.copy(os.path.join(run_dir, "checkpoints", "state_last.pt"),
                        checkpoint_to)
        return dict(
            preset=preset, algo=algo, robot=env.model.name,
            num_envs=env.num_envs,
            num_obs=env.num_obs, num_obs_history=env.num_obs_history,
            num_privileged_obs=env.num_privileged_obs,
            control_type=env.cfg.control.control_type,
            heightfield_flat=env.hf.is_flat, **terrain, build_s=build_s,
            iterations=iterations, **rec, losses=losses,
            expected_launches_per_kernel=(
                iterations * runner.args.num_steps_per_env
                * env.cfg.control.decimation),
            mean_step_reward=float(stats["mean_step_reward"]),
            mean_episode_length=(float(stats["mean_episode_length"])
                                 if "mean_episode_length" in stats else None),
            lr=float(stats["lr"]))
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def phase_pbt_training(device="cuda", num_envs=B, population=2, iterations=2,
                       warmup=0, overrides=()):
    """`train --pbt P` on go1_flat through the port's entry points
    (`train.build(..., pbt=P)` and `Population.learn`), with an exploit
    every 2 iterations: the measured run ends with one. Its bottom member
    must then hold its source's weights exactly, with an lr of the source's
    times a factor in [0.8, 1.25]. Each kernel launches P x iterations x
    24 x 4 times."""
    from wtw_tpu_torch.learn.pbt import PBTArgs
    from wtw_tpu_torch.train import build
    dev = torch.device(device)
    run_dir = tempfile.mkdtemp(prefix="wtw_chip_smoke_pbt_")
    try:
        t0 = time.perf_counter()
        env, pop = build("go1_flat", num_envs, list(overrides), dev,
                         seed=SEED, run_dir=run_dir, log_freq=1,
                         save_interval=0, pbt=population,
                         pbt_args=PBTArgs(exploit_interval=2))
        build_s = time.perf_counter() - t0
        T = pop.args.num_steps_per_env
        rec = _measure(pop.learn, dev, iterations, warmup,
                       population * env.num_envs, T)
        if (warmup + iterations) % 2 or pop.last_exploit is None:
            raise AssertionError("pbt training: the run did not end with an "
                                 "exploit")
        ex = pop.last_exploit
        for b, src in zip(ex["bottom"], ex["src"]):
            wb = pop.members[b].ac.state_dict()
            ws = pop.members[src].ac.state_dict()
            if not all(torch.equal(wb[k], ws[k]) for k in wb):
                raise AssertionError(f"pbt training: member {b} does not "
                                     f"hold its source {src}'s weights")
            factor = ex["lr_after"][b] / ex["lr_before"][src]
            if not 0.8 <= factor <= 1.25:
                raise AssertionError(f"pbt training: member {b}'s lr moved "
                                     f"by {factor}")
        losses = {f"{i}_{k}": float(s[k]) for i, s in enumerate(
            pop.last_stats) for k in ("loss", "surrogate_loss", "value_loss",
                                      "adaptation_loss")}
        return dict(
            preset="go1_flat", population=population, num_envs=env.num_envs,
            build_s=build_s, iterations=iterations, **rec,
            losses=_finite(losses, "pbt training"),
            fitness=[float(f) for f in pop.fitness], lr=pop.lr.tolist(),
            exploit=dict(ex, lr_factor=[
                ex["lr_after"][b] / ex["lr_before"][src]
                for b, src in zip(ex["bottom"], ex["src"])]),
            expected_launches_per_kernel=(
                population * iterations * T * env.cfg.control.decimation))
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


MIX = ("go1", "go2", "b1", "mini_cheetah")
# train_multi's default mix, as multi_training trains it: 51 spheres, runs
# of 1366/1365/1365 envs padded to 1376 slots each, so blocks hold empty
# slots
TRAIN_MIX = ("go1", "go2", "b1")


def _mixed_case(dev, robots=MIX, n=B, seed=SEED + 2):
    """The per-env model of a stack of `robots` interleaved (arange % R)
    at n envs, random states near each env's robot's standing pose and
    height: (per-env model, states, torques, fk_in)."""
    from wtw_tpu_torch.models import load_robot
    from wtw_tpu_torch.models.multi import assign_robots, stack_models
    from wtw_tpu_torch.physics import PhysicsState
    stack = stack_models([load_robot(r, device=dev) for r in robots])
    per_env, a = assign_robots(stack, n)
    rng = np.random.RandomState(seed)
    parts = [random_states(rng, n, dev, z=KERNEL_Z[r], q0=STAND_Q[r])
             for r in robots]
    pick = torch.as_tensor(a, device=dev)
    st = PhysicsState(**{f.name: torch.stack(
        [getattr(p, f.name) for p in parts])[pick, torch.arange(n, device=dev)]
        for f in dataclasses.fields(PhysicsState)})
    tau = torch.tensor(3.0 * rng.randn(n, 12).astype(np.float32), device=dev)
    fk_in = torch.cat([st.base_pos, st.base_quat, st.joint_q],
                      1).T.contiguous()
    return per_env, st, tau, fk_in


def _mix_layout(per_env):
    """Envs of each robot, and the slot table's slots and empty slots."""
    from wtw_tpu_torch.physics import kernels as K
    R = int(per_env.stack.static["mass"].shape[0])
    slot_env, _ = K.slot_table(per_env.robot, R)
    return dict(envs_per_robot=np.bincount(per_env.assignment,
                                           minlength=R).tolist(),
                spheres_padded_to=per_env.P, slots=slot_env.numel(),
                empty_slots=int((slot_env < 0).sum()))


def phase_kernel_a_multi(dev, n=B, robots=MIX):
    """Kernel A on `robots` interleaved at n envs through the per-env
    model (the slot table), against its plain version on the same model."""
    from wtw_tpu_torch.models.multi import robot_of
    from wtw_tpu_torch.physics import kernels as K
    per_env, st, tau, fk_in = _mixed_case(dev, robots, n=n)
    fb, fp = K.fk(per_env, fk_in)
    rb, rp = K.fk_plain(per_env, fk_in)
    torch.cuda.synchronize()
    err = max(float((fb - rb).abs().max()), float((fp - rp).abs().max()))
    if not err <= FK_TOL:
        raise AssertionError(f"kernel A differs from its plain version on a "
                             f"mixed batch of {robots} ({n} envs): {err} > "
                             f"{FK_TOL}")
    call = lambda: K.fk(per_env, fk_in)
    check_deterministic(call, f"kernel A on a mixed batch of {robots}")
    lay = _mix_layout(per_env)
    n_bytes = 4 * (fk_in.numel() + fb.numel() + fp.numel() + n)
    flops = sum(c * fk_flops(robot_of(per_env.stack, r))
                for r, c in enumerate(lay["envs_per_robot"]))
    bms, by = bound_ms(n_bytes, flops)
    return dict(num_envs=n, robots=list(robots), **lay, max_abs_err=err,
                tolerance=FK_TOL, deterministic=True,
                **timings(call, lambda: K.fk_plain(per_env, fk_in)),
                bound_ms=bms, bound_by=by, bytes=n_bytes)


def _touching(radius, inv_s, hc, duv, fk_p):
    """Spheres of each env whose depth along the ground normal is > 0
    (padded spheres never touch): (B,)."""
    (h00, h10, h01, h11), (du, dv) = hc, duv
    h = (h00 * (1 - du) * (1 - dv) + h10 * du * (1 - dv)
         + h01 * (1 - du) * dv + h11 * du * dv)
    dhdx = ((h10 - h00) * (1 - dv) + (h11 - h01) * dv) * inv_s
    dhdy = ((h01 - h00) * (1 - du) + (h11 - h10) * du) * inv_s
    depth = ((h - fk_p[2]) * torch.rsqrt(dhdx ** 2 + dhdy ** 2 + 1)
             + radius)
    return (depth > 0).float().sum(0)


def _touching_per_robot(per_env, inv_s, hc, duv, fk_p):
    """Touching spheres an env, averaged over each robot's envs."""
    count = _touching(per_env.sph_radius.T, inv_s, hc, duv, fk_p)
    R = int(per_env.stack.static["mass"].shape[0])
    return [float(count[per_env.robot == r].mean()) for r in range(R)]


def _dyn_bound(per_env, args, got, active):
    """Bound of one kernel B launch on a per-env model: its rows and the
    robot index moved once, each robot's counted operations."""
    from wtw_tpu_torch.models.multi import robot_of
    n_bytes = 4 * (sum(a.numel() for a in args[2:8]) + got.numel()
                   + got.shape[1])
    counts = np.bincount(per_env.assignment, minlength=len(active))
    flops = sum(int(c) * dynamics_flops(robot_of(per_env.stack, r), active[r])
                for r, c in enumerate(counts))
    return bound_ms(n_bytes, flops) + (n_bytes,)


def phase_kernel_b_multi(dev, n=B, terrains=("flat", "rough"), robots=MIX):
    """Kernel B on `robots` interleaved at n envs through the per-env model
    (the slot table), against its plain version on the same model, on flat
    and on rough ground."""
    from wtw_tpu_torch.physics import (EngineParams, flat_heightfield,
                                       make_heightfield)
    from wtw_tpu_torch.physics import kernels as K
    from wtw_tpu_torch.physics.batched import _hf_rows, pack_state_rows
    params = EngineParams()
    per_env, st, tau, fk_in = _mixed_case(dev, robots, n=n)
    fk_b, fk_p = K.fk_plain(per_env, fk_in)
    lin = lambda a, b: torch.linspace(a, b, n, device=dev)[None]
    col = lambda v: torch.tensor(v, device=dev)[:, None].expand(3, n)
    env = torch.cat([lin(0.3, 2.0), lin(0.0, 0.4), lin(-0.5, 2.0),
                     col([0.01, -0.005, 0.002]), col([0.1, -0.2, 0.3])],
                    0).contiguous()
    srows = pack_state_rows(st, tau)
    rough = (0.06 * np.random.RandomState(3).randn(80, 80)).astype(np.float32)
    fields = {"flat": lambda: flat_heightfield(20.0, 0.5, device=dev),
              "rough": lambda: make_heightfield(rough, 0.25, [-10.0, -10.0],
                                                device=dev)}
    lay = _mix_layout(per_env)
    out = {}
    for terrain in terrains:
        hf = fields[terrain]()
        hc, duv = _hf_rows(hf, fk_p[0], fk_p[1])
        args = (per_env, params, srows, fk_b, fk_p, hc.contiguous(),
                duv.contiguous(), env, 1.0 / hf.horizontal_scale)
        got = K.dynamics(*args)
        ref = K.dynamics_plain(*args)
        torch.cuda.synchronize()
        what = f"on {terrain} ground (mixed batch of {robots}, {n} envs)"
        errs = _compare_dyn(K, per_env, got, ref, what)
        call = lambda: K.dynamics(*args)
        check_deterministic(call, f"kernel B {what}")
        active = _touching_per_robot(per_env, args[-1], hc, duv, fk_p)
        if min(active) <= 0:
            raise AssertionError(f"kernel B {what}: a robot with no touching "
                                 f"sphere: {active}")
        bms, by, n_bytes = _dyn_bound(per_env, args, got, active)
        out[terrain] = dict(
            num_envs=n, robots=list(robots), **lay,
            max_abs_err=max(errs.values()), errors=errs, deterministic=True,
            **timings(call, lambda: K.dynamics_plain(*args), plain_iters=5),
            bound_ms=bms, bound_by=by, bytes=n_bytes,
            touching_spheres_per_env_by_robot=dict(zip(robots, active)))
    return out


def _columns(args, cols):
    """Kernel B's arguments (model, params, rows..., inv_s) restricted to
    the env columns `cols`, in that order."""
    model, params, *rows, inv_s = args
    return (model, params, *[r[..., cols].contiguous() for r in rows],
            inv_s)


def _position_bar(base_pos_rows) -> float:
    """The bar of a position output: FK_TOL, or 2 fp32 ulps of the largest
    coordinate (bases within 1 m) where those are larger. Training spreads
    envs up to ~190 m from the origin (the env origins' grid), where one
    ulp is 1.5e-5; the random cases sit within 1 m."""
    far = float(base_pos_rows[:2].abs().max()) + 1.0
    return max(FK_TOL, 2.0 * float(np.spacing(np.float32(far))))


def _training_state_errors(K, args, what, kw=None):
    """Kernel A and kernel B against their plain versions on one training
    or eval call's inputs (`args`, and `kw`: the ceiling): positions under
    `_position_bar`, the rest under FK_TOL and DYN_TOL."""
    model, nb, nj, kw = args[0], args[0].nb, args[0].nj, kw or {}
    fk_in = args[2][:7 + nj].contiguous()
    fb, fp = K.fk(model, fk_in)
    rb, rp = K.fk_plain(model, fk_in)
    got, ref = K.dynamics(*args, **kw), K.dynamics_plain(*args, **kw)
    if got.is_cuda:
        torch.cuda.synchronize()
    pos_bar = _position_bar(fk_in)
    d = (fb - rb).abs()
    pos_rows = torch.cat([d[:nb * 3], d[nb * 7:nb * 7 + nj * 3]])
    err_pos = max(float(pos_rows.max()), float((fp - rp).abs().max()))
    err_rot = max(float(d[nb * 3:nb * 7].max()),
                  float(d[nb * 7 + nj * 3:].max()))
    if not (err_pos <= pos_bar and err_rot <= FK_TOL):
        raise AssertionError(f"kernel A on {what}: positions {err_pos} "
                             f"(bar {pos_bar}), rotations {err_rot}")
    errs = _compare_dyn(K, model, got, ref, f"on {what}", dict(
        DYN_TOL, base_pos=pos_bar, foot_positions=pos_bar))
    return dict(position_bar=pos_bar, kernel_a_position_err=err_pos,
                kernel_a_rotation_err=err_rot,
                kernel_a_max_abs_err=max(err_pos, err_rot),
                max_abs_err=max(errs.values()), errors=errs)


def phase_kernel_b_training_states(dev, go1_call, multi_call):
    """Kernel B on the inputs of its last call in go1_flat's and in
    train_multi's measured iterations (the training phases keep them):
    the mixed case against its plain version at the bars, kernel A
    relaunched on its states giving the training launch's bits, each
    robot's envs given bit for bit what the single-robot kernel gives them
    on that robot's padded model, and the mixed case's device time taken
    apart: without the empty slots (1360 envs of each robot, interleaved),
    with each robot's columns neighbouring (the same envs sorted by
    robot), and each robot's envs alone through the single-robot kernel
    (tiled to 4096 columns), on its own model and on its sphere-padded
    one, beside go1_flat's; with the touching spheres an env of each."""
    from wtw_tpu_torch.models import load_robot
    from wtw_tpu_torch.models.multi import robot_of
    from wtw_tpu_torch.physics import kernels as K
    (m1, *rest1), kw1 = go1_call
    (per_env, *rest), kw = multi_call
    if kw1.get("ceil_h") is not None or kw.get("ceil_h") is not None:
        raise AssertionError("flat-ground training passed a ceiling")
    go1_args, args = (m1, *rest1), (per_env, *rest)
    n, nj = args[2].shape[1], per_env.nj
    # kernel A on the training states gives the training launch's bits
    fb, fp = K.fk(per_env, args[2][:7 + nj].contiguous())
    torch.cuda.synchronize()
    if not (torch.equal(fb, args[3]) and torch.equal(fp, args[4])):
        raise AssertionError("kernel A on train_multi's states differs from "
                             "its launch in training")
    # both kernels against their plain versions on each phase's states
    checks = {}
    for tag, xs in (("multi", args), ("go1_flat", go1_args)):
        checks[tag] = _training_state_errors(K, xs, f"{tag}'s states")
    check_deterministic(lambda: K.dynamics(*args),
                        "kernel B on train_multi's states")
    got = K.dynamics(*args)
    stack, a = per_env.stack, per_env.assignment
    names = [robot_key(robot_of(stack, r))
             for r in range(int(stack.static["mass"].shape[0]))]
    active = _touching_per_robot(per_env, args[-1], *args[5:7], args[4])
    bms, by, n_bytes = _dyn_bound(per_env, args, got, active)
    go1_active = float(_touching(m1.sph_radius[:, None], go1_args[-1],
                                 *go1_args[5:7], go1_args[4]).mean())
    n1 = go1_args[2].shape[1]
    go1_bms, _ = bound_ms(
        4 * (sum(t.numel() for t in go1_args[2:8]) + got.shape[0] * n1),
        dynamics_flops(m1, go1_active) * n1)
    ms = lambda xs: device_ms(lambda: K.dynamics(*xs))
    # the mixed path without empty slots, then with neighbouring columns
    per_run = min(np.bincount(a)) // K.SLOT_GROUP * K.SLOT_GROUP
    keep = np.sort(np.concatenate([np.flatnonzero(a == r)[:per_run]
                                   for r in range(len(names))]))
    dense = torch.as_tensor(keep, device=dev)
    by_robot = torch.as_tensor(keep[np.argsort(a[keep], kind="stable")],
                               device=dev)
    parts = {}
    for key, cols in (("no_empty_slots", dense), ("sorted_by_robot",
                                                  by_robot)):
        sub = stack.take(a[cols.cpu().numpy()])
        parts[key] = dict(num_envs=len(keep),
                          **{k: v for k, v in _mix_layout(sub).items()
                             if k in ("slots", "empty_slots")},
                          device_ms=ms(_columns((sub,) + args[1:], cols)))
    # each robot alone: its envs through the single kernel on the model the
    # mixed launch staged for them give that launch's bits; then tiled to n
    # columns and timed
    alone = {}
    for r, name in enumerate(names):
        idx = np.flatnonzero(a == r)
        padded = robot_of(stack, r)
        mine = torch.as_tensor(idx, device=dev)
        if not torch.equal(K.dynamics(*_columns((padded,) + args[1:], mine)),
                           got[:, mine]):
            raise AssertionError(f"kernel B on train_multi's states: the "
                                 f"mixed launch's {name} envs differ from "
                                 f"the single-robot launch on its model")
        cols = torch.as_tensor(idx[np.arange(n) % len(idx)], device=dev)
        own = load_robot(name, device=dev)
        pa = _columns((padded,) + args[1:], cols)
        oa = (own, pa[1], pa[2], pa[3], pa[4][:, :own.P].contiguous(),
              pa[5][:, :own.P].contiguous(), pa[6][:, :own.P].contiguous(),
              pa[7], pa[8])
        alone[name] = dict(own_spheres=own.P, own_device_ms=ms(oa),
                           padded_device_ms=ms(pa),
                           touching_spheres_per_env=active[r])
    return dict(
        num_envs=n, robots=names, **_mix_layout(per_env),
        kernel_a_same_bits_as_training=True,
        same_bits_as_single_robot_launches=True,
        kernel_a_max_abs_err=checks["multi"]["kernel_a_max_abs_err"],
        max_abs_err=checks["multi"]["max_abs_err"], deterministic=True,
        against_plain=checks,
        **timings(lambda: K.dynamics(*args),
                  lambda: K.dynamics_plain(*args), plain_iters=5),
        bound_ms=bms, bound_by=by, bytes=n_bytes,
        touching_spheres_per_env_by_robot=dict(zip(names, active)),
        go1_flat=dict(num_envs=n1, device_ms=ms(go1_args),
                      bound_ms=go1_bms, touching_spheres_per_env=go1_active),
        **parts, alone=alone)


def _standing_start(models, dev, n):
    """Per-env PD gains, default pose and standing height of each robot's
    flat preset (go1's for go1 and go2's for go2), and the (n,) robot
    index arange % R."""
    from wtw_tpu_torch import config as C
    from wtw_tpu_torch.models.robot import default_joint_angles
    a = torch.arange(n, device=dev) % len(models)
    q0s, kps, kds, hs = [], [], [], []
    for key, m in models.items():
        ctrl = C.PRESETS[f"{key}_flat"]()
        q0 = default_joint_angles(m, dict(ctrl.init_state.default_joint_angles))
        q0s.append(q0)
        kps.append(ctrl.control.stiffness)
        kds.append(ctrl.control.damping)
        hs.append(standing_height(m, q0))
    t = lambda x: torch.tensor(x, device=dev)
    return (a, torch.stack(q0s)[a], t(kps)[a][:, None], t(kds)[a][:, None],
            t(hs)[a], hs)


def _rollout(model, hf, s, q0, kp, kd, substeps):
    from wtw_tpu_torch.physics import EngineParams, physics_step_batched
    n = q0.shape[0]
    dev = q0.device
    ones, zeros = torch.ones(n, device=dev), torch.zeros(n, device=dev)
    info = None
    for _ in range(substeps):
        tau = kp * (q0 - s.joint_q) - kd * s.joint_qd
        s, info = physics_step_batched(model, hf, EngineParams(), s, tau,
                                       ones, zeros)
    return s, info


def _stand(q0, z, dev):
    from wtw_tpu_torch.physics import PhysicsState
    n = q0.shape[0]
    pos = torch.zeros(n, 3, device=dev)
    pos[:, 2] = z
    return PhysicsState(
        base_pos=pos,
        base_quat=torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).expand(n, 4),
        base_lin_vel=torch.zeros(n, 3, device=dev),
        base_ang_vel=torch.zeros(n, 3, device=dev), joint_q=q0.clone(),
        joint_qd=torch.zeros(n, 12, device=dev))


def phase_multi_pure_go1(dev, substeps=100):
    """Every env go1 through the mixed path (a [go1, b1] stack, every env
    assigned go1), 100 substeps from standing under go1's PD gains with
    contacts: bit-identical to the single-robot kernel path on the same
    inputs (the open fault of the JAX package on the TPU, BASELINE.md
    "per-env model diverges at contact events")."""
    from wtw_tpu_torch.models import load_robot
    from wtw_tpu_torch.models.multi import stack_models
    from wtw_tpu_torch.physics import flat_heightfield
    from wtw_tpu_torch.physics import kernels as K
    go1 = load_robot("go1", device=dev)
    per_env = stack_models([go1, load_robot("b1", device=dev)]).take(
        np.zeros(B, np.int32))
    hf = flat_heightfield(20.0, 0.5, device=dev)
    _, q0, kp, kd, h, _ = _standing_start({"go1": go1}, dev, B)
    before = (K.FK.launches, K.DYNAMICS.launches)
    a, ia = _rollout(go1, hf, _stand(q0, h, dev), q0, kp, kd, substeps)
    b, ib = _rollout(per_env, hf, _stand(q0, h, dev), q0, kp, kd, substeps)
    torch.cuda.synchronize()
    launched = (K.FK.launches - before[0], K.DYNAMICS.launches - before[1])
    fields = ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel",
              "joint_q", "joint_qd")
    diff = {f: float((getattr(a, f) - getattr(b, f)).abs().max())
            for f in fields}
    same = all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields) \
        and torch.equal(ia.foot_forces, ib.foot_forces)
    touching = float((ia.total_normal_force > 10.0).float().mean())
    if not (same and touching > 0.99 and launched == (2 * substeps,
                                                      2 * substeps)):
        raise AssertionError(f"multi_pure_go1: bits differ {diff}, share of "
                             f"envs in contact {touching}, launches "
                             f"{launched}")
    return dict(num_envs=B, substeps=substeps, bit_identical=True,
                max_abs_diff=diff, envs_in_contact=touching,
                launches=launched)


def phase_multi_rollout(dev, substeps=100):
    """go1/go2/b1/mini-cheetah interleaved at 4096 envs, 100 substeps from
    standing under each robot's own preset PD gains through both kernels'
    mixed path: finite, and each robot's base height inside (0.4 h, 1.1 h)
    of its own standing height h (as rollout_b1)."""
    from wtw_tpu_torch.models import load_robot
    from wtw_tpu_torch.models.multi import assign_robots, stack_models
    from wtw_tpu_torch.physics import flat_heightfield
    from wtw_tpu_torch.physics import kernels as K
    models = {r: load_robot(r, device=dev) for r in MIX}
    per_env, _ = assign_robots(stack_models(list(models.values())), B)
    a, q0, kp, kd, h, hs = _standing_start(models, dev, B)
    hf = flat_heightfield(20.0, 0.5, device=dev)
    before = (K.FK.launches, K.DYNAMICS.launches)
    s, _ = _rollout(per_env, hf, _stand(q0, h, dev), q0, kp, kd, substeps)
    torch.cuda.synchronize()
    launched = (K.FK.launches - before[0], K.DYNAMICS.launches - before[1])
    z = s.base_pos[:, 2]
    finite = all(bool(torch.isfinite(getattr(s, f)).all()) for f in (
        "base_pos", "base_quat", "base_lin_vel", "base_ang_vel", "joint_q",
        "joint_qd"))
    by_robot = {}
    ok = finite and launched == (substeps, substeps)
    for r, key in enumerate(MIX):
        zr = z[a == r]
        lo, hi = 0.4 * hs[r], 1.1 * hs[r]
        by_robot[key] = dict(standing_height=hs[r], z_bounds=[lo, hi],
                             z_min=float(zr.min()), z_max=float(zr.max()),
                             z_mean_over_h=float(zr.mean()) / hs[r])
        ok = ok and bool((zr > lo).all()) and bool((zr < hi).all())
    if not ok:
        raise AssertionError(f"multi roll-out failed: finite={finite} "
                             f"{by_robot} launches={launched}")
    return dict(num_envs=B, substeps=substeps, by_robot=by_robot,
                launches=launched)


def phase_multi_training(device="cuda", robots=TRAIN_MIX, num_envs=B,
                         iterations=2, warmup=1, keep=None):
    """`train_multi --robots go1,go2,b1` through the port's entry points
    (`train_multi.build` and `MultiRunner.learn`) at full width (actor and
    critic 512-256-128, adaptation 256-128): counts set to 0 after the
    warm-up, just before the measured iterations, and read just after.
    Each iteration is 24 policy steps and the per-robot reward step, 4
    substeps each: 100 launches of each kernel. Every rew_<robot> must be
    finite and non-zero. `keep`: see `_measure`."""
    from wtw_tpu_torch.train_multi import build
    dev = torch.device(device)
    run_dir = tempfile.mkdtemp(prefix="wtw_chip_smoke_multi_")
    try:
        t0 = time.perf_counter()
        env, runner = build(robots, num_envs, (), dev, seed=SEED,
                            run_dir=run_dir, log_freq=1)
        build_s = time.perf_counter() - t0
        T = runner.args.num_steps_per_env
        rec = _measure(runner.learn, dev, iterations, warmup, env.num_envs, T,
                       keep)
        stats = runner.last_stats
        losses = _finite({k: float(stats[k]) for k in (
            "loss", "surrogate_loss", "value_loss", "adaptation_loss",
            "kl_mean")}, "multi training")
        per_robot = dict(zip(robots, runner.last_per_robot.cpu().tolist()))
        if not all(math.isfinite(v) and v != 0.0 for v in per_robot.values()):
            raise AssertionError(f"multi training: a per-robot reward is not "
                                 f"finite and non-zero: {per_robot}")
        with open(os.path.join(run_dir, "metrics.csv")) as f:
            columns = f.readline().strip().split(",")
        return dict(
            robots=list(robots), num_envs=env.num_envs,
            envs_per_robot=[int((env.robot_assignment == r).sum())
                            for r in range(len(robots))],
            num_obs=env.num_obs, spheres_padded_to=env.model.P,
            build_s=build_s, iterations=iterations, **rec, losses=losses,
            rew_by_robot=per_robot, csv_columns=columns,
            expected_launches_per_kernel=(
                iterations * (T + 1) * env.cfg.control.decimation),
            mean_step_reward=float(stats["mean_step_reward"]))
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# the eighth slice: the eval entry points on trained policies
# ---------------------------------------------------------------------------


def _expect_launches(what, counted, n):
    """Each kernel launched exactly n times in the block."""
    off = {k: v for k, v in counted.launches.items() if v != n}
    if off:
        raise AssertionError(f"{what}: kernels launched other than {n} times: "
                             f"{off}")


class Timed:
    """The seconds spent in `module.<name>` inside the block (the card
    synced before each call's clock stops), by wrapping it: an eval entry
    point's set-up (`build`: the checkpoint, the env, the map on the card),
    which is not its rollout. `module` may be a class (a method); `calls`
    counts the calls and `result` keeps the last one's return value."""

    def __init__(self, module, name):
        self.module, self.name, self.seconds = module, name, 0.0
        self.calls, self.result = 0, None

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                self.result = self.real(*a, **kw)
                return self.result
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                self.calls += 1
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def _rollout_rates(counted, build, env_steps, policy_steps):
    """The block's seconds split into set-up (`build_s`) and rollouts
    (`rollout_s`), and the rollouts' env steps/s and ms per policy step."""
    rollout_s = counted.seconds - build.seconds
    return dict(seconds=counted.seconds, build_s=build.seconds,
                rollout_s=rollout_s,
                env_steps_per_s=env_steps / rollout_s,
                ms_per_policy_step=1e3 * rollout_s / policy_steps)


def _last_call_check(counted, what):
    """Kernel A and kernel B against their plain versions on the inputs of
    kernel B's last call in the block, at the block's own env count (an
    eval path launches a grid of a few blocks), and kernel A relaunched on
    its states giving the bits that call was given. Run after the block,
    so these launches are not counted."""
    from wtw_tpu_torch.physics import kernels as K
    args, kw = counted.last
    model = args[0]
    fb, fp = K.fk(model, args[2][:7 + model.nj].contiguous())
    if not (torch.equal(fb, args[3]) and torch.equal(fp, args[4])):
        raise AssertionError(f"kernel A on {what}'s last states differs "
                             f"from its launch there")
    return dict(num_envs=args[2].shape[1],
                with_ceiling=kw.get("ceil_h") is not None,
                kernel_a_same_bits=True,
                **_training_state_errors(K, args, f"{what}'s last states",
                                         kw))


def _quiet(fn, *a, **kw):
    """`fn` with its standard output (an entry point's JSON) kept off this
    script's."""
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


def _finite_values(d, what):
    bad = {k: v for k, v in d.items()
           if isinstance(v, float) and not math.isfinite(v)}
    if bad:
        raise AssertionError(f"{what}: non-finite metrics: {bad}")


def phase_eval_play(checkpoint, device="cuda", runs=((64, None, True),
                                                     (4000, None, False),
                                                     (64, "rand_large",
                                                      False)),
                    steps=250, extra=()):
    """`wtw_tpu_torch.play` (its `main`, as a user calls it) on a go1_mob
    checkpoint of the port, reloaded through play's loader: per run (envs,
    `--sweep`, `--gait-stats`) the env from the file's config, every DR off
    except the lag, the trot at 3 Hz and vx 1.5 (the JAX CLI's defaults).
    Each kernel launches exactly steps x 4 per rollout (two with
    --gait-stats); every metric finite; both kernels against their plain
    versions on the run's last kernel B inputs. `extra`: more CLI flags."""
    from wtw_tpu_torch import play
    out = {}
    for n, sweep, gait in runs:
        argv = ["--checkpoint", checkpoint, "--device", device,
                "--num-envs", str(n), "--steps", str(steps), *extra]
        if sweep:
            argv += ["--sweep", sweep]
        if gait:
            argv += ["--gait-stats"]
        with Counted() as c, Timed(play, "build") as b:
            summary = _quiet(play.main, argv)
            if device != "cpu":
                torch.cuda.synchronize()
        rollouts = 2 if gait else 1
        key = f"{n}_envs" + (f"_{sweep}" if sweep else "")
        if device != "cpu":
            _expect_launches(f"eval_play {key}", c, rollouts * steps * 4)
        _finite_values(summary, f"eval_play {key}")
        out[key] = dict(
            num_envs=n, sweep=sweep, gait_stats=gait, steps=steps,
            launches=c.launches,
            **_rollout_rates(c, b, rollouts * steps * n, rollouts * steps),
            last_call=_last_call_check(c, f"eval_play {key}"),
            summary=summary)
    return dict(runs=out, launches={
        k: sum(r["launches"][k] for r in out.values())
        for k in ("fk", "dynamics")})


def phase_eval_gaits(checkpoint, device="cuda", num_envs=32, steps=300,
                     extra=()):
    """`wtw_tpu_torch.eval_gaits` (its `main`) at its defaults: the four
    gaits at 3 Hz and the trot at 2 Hz, 300 steps each at 32 envs; each
    kernel launches exactly cases x steps x 4; every row finite; both
    kernels against their plain versions on the last kernel B inputs."""
    from wtw_tpu_torch import eval_gaits
    argv = ["--checkpoint", checkpoint, "--device", device, "--num-envs",
            str(num_envs), "--steps", str(steps), *extra]
    with Counted() as c, Timed(eval_gaits, "build") as b:
        result = _quiet(eval_gaits.main, argv)
        if device != "cpu":
            torch.cuda.synchronize()
    rows = result["rows"]
    if device != "cpu":
        _expect_launches("eval_gaits", c, len(rows) * steps * 4)
    for r in rows:
        _finite_values(r, "eval_gaits")
    return dict(num_envs=num_envs, steps=steps, cases=len(rows),
                launches=c.launches,
                **_rollout_rates(c, b, len(rows) * steps * num_envs,
                                 len(rows) * steps),
                last_call=_last_call_check(c, "eval_gaits"),
                gaits_matched=result["gaits_matched"],
                rows=[{k: r[k] for k in ("cmd_gait", "cmd_freq_hz",
                                         "vx_rmse", "stride_hz", "dominant")}
                      for r in rows])


def phase_diag_parkour(checkpoint, device="cuda", num_envs=64, steps=700,
                       terrain="gap", level=0, overrides=()):
    """`wtw_tpu_torch.diag_parkour` (the functions its `main` calls) on a
    parkour checkpoint of the port: the `terrain` course pinned at `level`,
    the run stopping once every env's first episode is over (checked every
    50 steps). Each kernel launches exactly steps run x 4, every kernel B
    call with the ceiling; the attributions sum to the env count; both
    kernels against their plain versions on the last kernel B inputs, the
    ceiling included."""
    from wtw_tpu_torch import diag_parkour as D
    dev = torch.device(device)
    t0 = time.perf_counter()
    env = D.build_env(num_envs, SEED, terrain=terrain, overrides=[
        f"terrain.min_init_map_level={level}",
        f"terrain.max_init_map_level={level}", "only_forwards=true",
        "only_forwards_velocity=0.8", *overrides], device=dev)
    policy = D.load_cat_policy(checkpoint, env)
    if device != "cpu":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    with Counted() as c:
        out, ran = D.diagnose(env, policy, level, steps, SEED)
        if device != "cpu":
            torch.cuda.synchronize()
    if device != "cpu":
        _expect_launches("diag_parkour", c, ran * 4)
        _check_ceiling("diag_parkour", c.record())
    total = out["first_episodes_done"] + out["still_alive"]
    attributed = sum(out["reasons"].values())
    if total != num_envs or attributed != out["first_episodes_done"] or sum(
            out["binding_cstr"].values()) != out["first_episodes_done"]:
        raise AssertionError(f"diag_parkour: attributions do not sum to the "
                             f"{num_envs} envs: {out}")
    return dict(terrain=terrain, level=level, num_envs=num_envs,
                steps=steps, steps_run=ran, **c.record(),
                build_s=build_s, seconds=c.seconds, rollout_s=c.seconds,
                env_steps_per_s=ran * num_envs / c.seconds,
                ms_per_policy_step=1e3 * c.seconds / ran,
                last_call=_last_call_check(c, "diag_parkour"), diag=out)


# ---------------------------------------------------------------------------
# the ninth slice: vision distillation, actuator_train and sweep
# ---------------------------------------------------------------------------


class RenderedFrames:
    """The depth camera's kernel A calls inside the block: wraps
    `envs.depth.sphere_centres` (the renderer's call site of kernel A),
    counting the frames and keeping the last frame's inputs."""

    def __enter__(self):
        from wtw_tpu_torch.envs import depth
        self.depth, self.real = depth, depth.sphere_centres
        self.frames, self.last = 0, None

        def watched(*args):
            self.frames += 1
            self.last = args
            return self.real(*args)
        depth.sphere_centres = watched
        return self

    def __exit__(self, *exc):
        self.depth.sphere_centres = self.real


def _render_check(frames, env, what, device):
    """Kernel A against its plain version on the renderer's last inputs
    (the sphere centres: under FK_TOL, or 2 fp32 ulps of the largest
    coordinate where that is larger, `_position_bar`), and the renderer's
    device ms per frame on them (CUDA events around 5 frames; these
    launches are not counted)."""
    from wtw_tpu_torch.envs import depth
    from wtw_tpu_torch.physics import kernels as K
    model, pos, quat, jq = frames.last
    fk_in = torch.cat([pos, quat, jq], dim=1).T.contiguous()
    got, ref = K.fk(model, fk_in)[1], K.fk_plain(model, fk_in)[1]
    err = float((got - ref).abs().max())
    bar = _position_bar(fk_in[:3])
    if err > bar:
        raise AssertionError(f"{what}: kernel A on the renderer's last inputs "
                             f"is {err} off its plain version (bar {bar})")
    out = dict(frames=frames.frames, num_envs=pos.shape[0],
               kernel_a_max_abs_err=err, position_bar=bar, render_ms=None)
    if device != "cpu":
        render = depth.make_depth_fn(env.hf, depth.DepthCameraCfg(),
                                     model=env.model)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out["render_ms"] = cuda_ms(lambda: render(pos, quat, jq), iters=5,
                                   warmup=1)
        out["render_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    return out


def _setup_s(*timers):
    return types.SimpleNamespace(seconds=sum(t.seconds for t in timers))


def _sets(overrides):
    return [a for x in overrides for a in ("--set", x)]


def _vision_run(argv, device, what, fk_per_step, steps, extra_timers=()):
    """`train_vision.main(argv)` inside the counters: -> (its return value,
    the counters, the build_env timer, the frames, the extra timers)."""
    from wtw_tpu_torch import train_vision as TV
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    import contextlib
    with contextlib.ExitStack() as stack:
        c = stack.enter_context(Counted())
        b = stack.enter_context(Timed(TV, "build_env"))
        frames = stack.enter_context(RenderedFrames())
        timers = [stack.enter_context(Timed(m, n)) for m, n in extra_timers]
        out = _quiet(TV.main, argv + ["--device", device])
        if device != "cpu":
            torch.cuda.synchronize()
    if device != "cpu":
        _expect_fk_dyn(what, c, fk_per_step * steps, 4 * steps)
        _check_ceiling(what, c.record())
    return out, c, b, frames, timers


def _expect_fk_dyn(what, counted, n_fk, n_dyn):
    want = {"fk": n_fk, "dynamics": n_dyn}
    if counted.launches != want:
        raise AssertionError(f"{what}: launches {counted.launches}, expected "
                             f"{want}")


def _vision_record(c, b, frames, env, what, device, env_steps, policy_steps,
                   setup):
    """A vision run's counts, rates, peak memory and checks: both kernels
    on its last kernel B inputs, and kernel A on the renderer's last inputs
    where it rendered."""
    rec = dict(**c.record(),
               **_rollout_rates(c, setup, env_steps, policy_steps),
               max_memory_allocated=(torch.cuda.max_memory_allocated()
                                     if device != "cpu" else None),
               last_call=_last_call_check(c, what))
    if frames.frames:
        rec["renderer"] = _render_check(frames, env, what, device)
    return rec


def phase_vision_generate(checkpoint, demos, device="cuda", num_envs=1024,
                          steps=128, overrides=()):
    """`train_vision generate` (its `main`) with the parkour policy of phase
    11 as the expert: `steps` env steps of demos at `num_envs` into the
    port's demo file `demos`. Kernel B launches 4 a step, every call with
    the ceiling; kernel A 5 a step (4 substeps and the rendered frame)."""
    from wtw_tpu_torch import train_vision as TV
    argv = ["generate", "--checkpoint", checkpoint, "--demos", demos,
            "--num-envs", str(num_envs), "--steps", str(steps)] + _sets(
                overrides)
    out, c, b, frames, (le,) = _vision_run(
        argv, device, "vision_generate", 5, steps,
        extra_timers=[(TV, "load_expert")])
    if frames.frames != steps or out["filled"] != steps:
        raise AssertionError(f"vision_generate: {frames.frames} frames, "
                             f"{out['filled']} steps stored")
    return dict(num_envs=num_envs, steps=steps, buffer_bytes=out["nbytes"],
                **_vision_record(c, b, frames, b.result, "vision_generate",
                                 device, steps * num_envs, steps,
                                 _setup_s(b, le)))


def phase_vision_train(demos, out_dir, device="cuda", num_envs=1024,
                       env_steps=16384, bc_steps=50, actor_delay=8192,
                       overrides=()):
    """`train_vision train` (its `main`) on the demos of vision_generate at
    `DDPGArgs`' defaults (a 256-step ring): `bc_steps` BC batches, then
    env_steps / num_envs collect steps, each followed by an update round
    of 8 substeps; the actor is held for `actor_delay` env steps, so both
    the held and the live rounds run. Losses finite, the student moved off
    its initial weights, launches exact (5 kernel A, 4 kernel B a step)."""
    from wtw_tpu_torch import train_vision as TV
    from wtw_tpu_torch.learn import ddpg_demos as D
    steps = env_steps // num_envs
    argv = ["train", "--demos", demos, "--out", out_dir, "--num-envs",
            str(num_envs), "--env-steps", str(env_steps), "--bc-steps",
            str(bc_steps), "--actor-delay", str(actor_delay)] + _sets(
                overrides)
    out, c, b, frames, (ld, bc, ur, au) = _vision_run(
        argv, device, "vision_train", 5, steps, extra_timers=[
            (D, "load_buffer"), (D.DDPGLearner, "bc_update"),
            (D.DDPGLearner, "update_round"), (D.DDPGLearner, "actor_update")])
    ln = out["learner"]
    losses = _finite({k: float(v) for k, v in ln.last_losses.items()},
                     "vision_train")
    gen = torch.Generator()
    gen.manual_seed(SEED)
    init = D.Student(b.result.num_actions, ln.args, gen).state_dict()
    moved = sorted(k for k, v in ln.student.state_dict().items()
                   if not torch.equal(v.cpu(), init[k]))
    if not moved:
        raise AssertionError("vision_train: the student kept its initial "
                             "weights")
    # rounds once `learning_starts` env steps are in; the actor's after the
    # hold
    rounds = [t for t in range(steps)
              if (t + 1) * num_envs > ln.args.learning_starts]
    want = (bc_steps, len(rounds),
            sum(t >= actor_delay // num_envs for t in rounds))
    if (bc.calls, ur.calls, au.calls) != want:
        raise AssertionError(f"vision_train: {bc.calls} BC batches, "
                             f"{ur.calls} update rounds, {au.calls} actor "
                             f"updates; expected {want}")
    saved = torch.load(out["out"], map_location="cpu", weights_only=True)
    return dict(num_envs=num_envs, env_steps=env_steps, steps=steps,
                bc_batches=bc.calls, update_rounds=ur.calls,
                actor_updates=au.calls, losses=losses,
                moved_tensors=len(moved), saved_tensors=len(saved["student"]),
                ring_bytes=out["ring"].nbytes(),
                demo_bytes=out["demos"].nbytes(),
                bc_ms=1e3 * bc.seconds / max(bc.calls, 1),
                update_round_ms=1e3 * ur.seconds / max(ur.calls, 1),
                **_vision_record(c, b, frames, b.result, "vision_train",
                                 device, steps * num_envs, steps,
                                 _setup_s(b, ld, bc)))


def phase_vision_eval(policy, device="cuda", num_envs=1024, steps=100,
                      student=True, overrides=()):
    """`train_vision eval` (its `main`) on the student of vision_train
    (`--student`, its frame rendered every step: 5 kernel A launches a
    step) or on the expert of phase 11 (`--checkpoint`, no camera: 4).
    Every JSON value finite."""
    from wtw_tpu_torch import train_vision as TV
    what = f"vision_eval_{'student' if student else 'expert'}"
    argv = ["eval", "--student" if student else "--checkpoint", policy,
            "--num-envs", str(num_envs), "--steps", str(steps)] + _sets(
                overrides)
    timers = [] if student else [(TV, "load_expert")]
    out, c, b, frames, extra = _vision_run(
        argv, device, what, 5 if student else 4, steps, extra_timers=timers)
    _finite_values(out, what)
    if frames.frames != (steps if student else 0):
        raise AssertionError(f"{what}: {frames.frames} frames rendered")
    return dict(num_envs=num_envs, steps=steps, result=out,
                **_vision_record(c, b, frames, b.result, what, device,
                                 steps * num_envs, steps, _setup_s(b, *extra)))


def phase_actuator_train(device="cuda", epochs=20):
    """`learn.actuator_train` (its `main`) on a synthetic log from seed 0
    (tests/test_eval_tools.py's law, tau = clip(25 err - 0.6 vel, +-20), 2000
    steps x 12 joints): the exported `.npz` loads through
    `models/actuator_net.py` and predicts the test rows with a MAE below
    the labels' std."""
    import pickle
    from wtw_tpu_torch.learn import actuator_train as AT
    from wtw_tpu_torch.models.actuator_net import (apply_actuator_net,
                                                   load_actuator_net)
    rng = np.random.RandomState(SEED)
    T, nj = 2000, 12
    q_target = rng.normal(size=(T, nj)).astype(np.float32) * 0.3
    q = q_target + rng.normal(size=(T, nj)).astype(np.float32) * 0.1
    qd = rng.normal(size=(T, nj)).astype(np.float32) * 2.0
    x = AT.build_features(q_target, q, qd)
    tau = np.zeros((T, nj), np.float32)
    tau[4:] = np.clip(25.0 * x[..., 0] - 0.6 * x[..., 3], -20, 20)
    d = tempfile.mkdtemp(prefix="wtw_chip_smoke_actuator_")
    try:
        log = os.path.join(d, "log.pkl")
        with open(log, "wb") as f:
            pickle.dump({"joint_pos_target": q_target, "joint_pos": q,
                         "joint_vel": qd, "tau_est": tau}, f)
        npz = os.path.join(d, "net.npz")
        t0 = time.perf_counter()
        out = _quiet(AT.main, ["--log", log, "--out", npz, "--epochs",
                               str(epochs), "--device", device])
        seconds = time.perf_counter() - t0
        params = load_actuator_net(npz, device=device)
        xs = torch.as_tensor(x[:8], device=device)
        pred = apply_actuator_net(params, *xs.unbind(-1))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if not (out["mae"] < out["label_std"]) or not bool(
            torch.isfinite(pred).all()):
        raise AssertionError(f"actuator_train: test MAE {out['mae']} against "
                             f"a label std of {out['label_std']}")
    return dict(epochs=epochs, samples=out["samples"], test_mae=out["mae"],
                label_std=out["label_std"], train_s=seconds,
                loaded_shape=list(pred.shape))


def phase_sweep(device="cuda", num_envs=1024, overrides=()):
    """`wtw_tpu_torch.sweep` (its `main`): a 2-point grid of go1_flat
    (`ppo.learning_rate` 1e-3 and 5e-4), 1 iteration each, every point a
    `python -m wtw_tpu_torch.train` subprocess on `device`; summary.csv
    holds 2 rows. (The training path itself is phase 7's; the kernels'
    launches happen in the subprocesses.)"""
    import csv
    from wtw_tpu_torch import sweep
    d = tempfile.mkdtemp(prefix="wtw_chip_smoke_sweep_")
    try:
        t0 = time.perf_counter()
        cmds, rows = _quiet(sweep.main, [
            "--preset", "go1_flat", "--num-envs", str(num_envs),
            "--iterations", "1", "--device", device, "--sweep-dir", d,
            "-a", "ppo.learning_rate=1e-3,5e-4"] + _sets(overrides))
        seconds = time.perf_counter() - t0
        with open(os.path.join(d, "summary.csv")) as f:
            summary = list(csv.DictReader(f))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if len(summary) != 2 or [r["ppo.learning_rate"] for r in summary] != [
            "1e-3", "5e-4"]:
        raise AssertionError(f"sweep: summary.csv rows {summary}")
    rew = [float(r["mean_step_reward"]) for r in summary]
    if not all(math.isfinite(v) for v in rew):
        raise AssertionError(f"sweep: non-finite rewards {rew}")
    return dict(points=len(cmds), rows=len(summary), seconds=seconds,
                mean_step_reward=rew,
                steps_per_s=[float(r["steps_per_s"]) for r in summary])


# ---------------------------------------------------------------------------
# the tenth slice: bf16 products, env-sharded training, the video recorder
# ---------------------------------------------------------------------------
def phase_bf16_training(device="cuda", num_envs=None, iterations=3,
                        warmup=1, overrides=(), preset="go1_mob", fp32=None):
    """`train --preset go1_mob --set ac.compute_dtype=bfloat16` through the
    port's entry points (`train.build`, `Runner.learn`), as
    `phase_preset_training` runs it, with the checks of the bf16 path:
    parameters and Adam's moments fp32; the rollout's stored history bf16
    (read from the update's argument); every hidden activation bf16 and the
    tower outputs fp32; on the run's first observations and parameters the
    bf16 actor mean within 0.05 of the fp32 one (the JAX package's bar,
    tests/test_mixed_precision.py:53-54); both kernels against their plain
    versions on the inputs of kernel B's last call (`last_call`). `fp32`:
    the fp32 run's record, whose env steps/s and peak memory are reported
    beside this run's."""
    from wtw_tpu_torch.models import actor_critic as ac
    from wtw_tpu_torch.train import build
    dev = torch.device(device)
    run_dir = tempfile.mkdtemp(prefix=f"wtw_chip_smoke_{preset}_bf16_")
    try:
        t0 = time.perf_counter()
        env, runner = build(preset, num_envs,
                            list(overrides) + ["ac.compute_dtype=bfloat16"],
                            dev, seed=SEED, run_dir=run_dir, log_freq=1,
                            save_interval=0)
        build_s = time.perf_counter() - t0
        model = runner.ppo.ac
        obs_h = runner.obs_dict["obs_history"]
        acts = []
        hooks = [m.register_forward_hook(lambda m, i, o: acts.append(o.dtype))
                 for m in model.modules() if isinstance(m, torch.nn.ELU)]
        with torch.no_grad():
            mean16, _ = model.distribution(obs_h)
            value16 = model.evaluate(obs_h, runner.obs_dict["privileged_obs"])
            ref = ac.ActorCritic(env.num_obs, env.num_privileged_obs,
                                 env.num_obs_history, env.num_actions,
                                 dataclasses.replace(
                                     runner.ppo.ac_args,
                                     compute_dtype="float32")).to(dev)
            ref.load_state_dict(model.state_dict())
            mean32, _ = ref.distribution(obs_h)
        for h in hooks:
            h.remove()
        mean_err = float((mean16 - mean32).abs().max())
        if not (set(acts) == {torch.bfloat16} and mean16.dtype == torch.float32
                and value16.dtype == torch.float32):
            raise AssertionError(f"bf16 training: hidden activations {acts}, "
                                 f"mean {mean16.dtype}, value {value16.dtype}")
        if not mean_err <= 0.05:
            raise AssertionError(f"bf16 training: the bf16 actor mean is "
                                 f"{mean_err} off the fp32 one (bar 0.05)")
        stored = []
        real_update = runner.ppo.update

        def update(traj, *a, **kw):
            stored.append(traj.obs_history.dtype)
            return real_update(traj, *a, **kw)
        runner.ppo.update = update
        keep = {}
        try:
            rec = _measure(runner.learn, dev, iterations, warmup,
                           env.num_envs, runner.args.num_steps_per_env, keep)
        finally:
            del runner.ppo.update
        stats = runner.last_stats
        losses = _finite({k: float(stats[k]) for k in (
            "loss", "surrogate_loss", "value_loss", "adaptation_loss",
            "kl_mean")}, f"{preset} bf16 training")
        opt_dtypes = {str(v.dtype) for opt in (runner.ppo.opt,
                                               runner.ppo.adapt_opt)
                      for s in opt.state.values() for v in s.values()
                      if torch.is_tensor(v) and v.dim() > 0}
        param_dtypes = {str(p.dtype) for p in model.parameters()}
        if (param_dtypes != {"torch.float32"}
                or opt_dtypes != {"torch.float32"}
                or set(stored) != {torch.bfloat16}):
            raise AssertionError(f"bf16 training: parameters {param_dtypes}, "
                                 f"Adam moments {opt_dtypes}, stored history "
                                 f"{stored}")
        return dict(
            preset=preset, compute_dtype="bfloat16", num_envs=env.num_envs,
            num_obs_history=env.num_obs_history, build_s=build_s,
            iterations=iterations, **rec, losses=losses,
            expected_launches_per_kernel=(
                iterations * runner.args.num_steps_per_env
                * env.cfg.control.decimation),
            parameter_dtypes=sorted(param_dtypes),
            adam_moment_dtypes=sorted(opt_dtypes),
            stored_history_dtype=str(stored[-1]),
            hidden_activation_dtypes=sorted({str(a) for a in acts}),
            tower_output_dtypes=[str(mean16.dtype), str(value16.dtype)],
            first_obs_mean_max_abs_err_vs_fp32=mean_err,
            fp32_env_steps_per_s=fp32 and fp32["env_steps_per_s"],
            fp32_max_memory_allocated=fp32 and fp32["max_memory_allocated"],
            last_call=_last_call_check(types.SimpleNamespace(
                last=keep["dynamics"]), f"{preset} bf16 training"),
            mean_step_reward=float(stats["mean_step_reward"]))
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


DIST_LEGGED = ("go1_flat", "rma")
DIST_TASKS = DIST_LEGGED + ("parkour", "ppo_plus", "ppornn")


def _overrides(overrides, prefix):
    return [s[len(prefix):] for s in overrides if s.startswith(prefix)]


def _dist_setup(spec, group):
    """(train fn, learner, world, obs) of a dist task at the global width
    `spec["num_envs"]`: the world built whole by the ungrouped env from
    the seed, then, with a group, cut to this rank's shard
    (`parallel.shard_world` / `shard_parkour_world`), the env built with
    the group and the learner through `make_distributed_*_train_fn`
    (its parameters broadcast from rank 0)."""
    from wtw_tpu_torch import config as C
    from wtw_tpu_torch.parallel import mesh
    task, n, dev = spec["task"], spec["num_envs"], torch.device(
        spec["device"])
    ov = list(spec.get("overrides_by_task", {}).get(
        task, spec.get("overrides", ())))
    if task in DIST_LEGGED:
        from wtw_tpu_torch.envs import make_legged_env
        from wtw_tpu_torch.learn import PPOArgs
        from wtw_tpu_torch.learn.ppo_cse import PPO
        from wtw_tpu_torch.learn.ppo_rma import RMA, RMAArgs
        from wtw_tpu_torch.models.actor_critic import ACArgs
        cfg = C.PRESETS["go1_flat"]()
        cfg = dataclasses.replace(cfg, env=dataclasses.replace(
            cfg.env, num_envs=n))
        cfg = C.apply_overrides(cfg, [s for s in ov if not s.startswith(
            ("ppo.", "ac."))])
        args = C.apply_overrides(PPOArgs(
            num_learning_epochs=1, sharding_invariant=(task == "go1_flat"),
            num_steps_per_env=spec["num_steps"],
            num_mini_batches=spec["num_minibatches"]), _overrides(ov, "ppo."))
        cls, net_args = ((PPO, C.apply_overrides(ACArgs(),
                                                 _overrides(ov, "ac.")))
                         if task == "go1_flat" else
                         (RMA, C.apply_overrides(RMAArgs(),
                                                 _overrides(ov, "ac."))))
        whole = make_legged_env(cfg, device=dev, seed=SEED)
        world = whole.init_state(SEED)
        world, obs = whole.get_observations(world)
        if group is None:
            ln = cls(whole, args, net_args, seed=SEED)
            return ln.train_iteration, ln, world, obs
        env = make_legged_env(cfg, device=dev, seed=SEED, group=group)
        world, obs = mesh.shard_world(world, obs, group)
        fn = mesh.make_distributed_train_fn(env, args, net_args, group,
                                            seed=SEED, learner_cls=cls)
        return fn, fn.learner, world, obs
    from wtw_tpu_torch.envs.parkour_env import ParkourCfg, ParkourEnv
    from wtw_tpu_torch.learn.cat_ppo import CatPPO, CatPPOArgs
    from wtw_tpu_torch.learn.cat_ppo_plus import CatPPOPlus, PPOPlusArgs
    from wtw_tpu_torch.learn.cat_ppornn import CatPPORNN, RNNArgs
    from wtw_tpu_torch.models import load_robot
    cls, args_cls = {"parkour": (CatPPO, CatPPOArgs),
                     "ppo_plus": (CatPPOPlus, PPOPlusArgs),
                     "ppornn": (CatPPORNN, RNNArgs)}[task]
    cfg = C.apply_overrides(ParkourCfg(num_envs=n), [
        s for s in ov if not s.startswith("ppo.")])
    kw = dict(num_steps=spec["num_steps"], update_epochs=1,
              num_minibatches=spec["num_minibatches"])
    if task == "parkour":
        kw["sharding_invariant"] = True
    args = C.apply_overrides(args_cls(**kw), _overrides(ov, "ppo."))
    model = load_robot(cfg.robot)
    whole = ParkourEnv(cfg, model, seed=SEED, device=dev)
    world = whole.init_state(SEED)
    obs = whole.get_observations(world)
    if group is None:
        ln = cls(whole, args, seed=SEED)
        return ln.train_iteration, ln, world, ln.observe(obs)
    env = ParkourEnv(cfg, model, seed=SEED, device=dev, group=group)
    world, obs = mesh.shard_parkour_world(world, obs, group)
    fn = mesh.make_distributed_cat_train_fn(env, args, group, seed=SEED,
                                            learner_cls=cls)
    return fn, fn.learner, world, fn.learner.observe(obs)


def _net(ln):
    return getattr(ln, "ac", None) or getattr(ln, "agent", None) or ln.model


def _param_digest(ln) -> str:
    import hashlib
    h = hashlib.sha256()
    for v in _net(ln).state_dict().values():
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


class ReduceTimer:
    """The milliseconds spent in the group's collectives inside the block
    (all-reduces and all-gathers, the card synced before and after each),
    by wrapping `parallel.mesh._reduce` and `_gather`; `calls` counts
    them."""

    def __enter__(self):
        from wtw_tpu_torch.parallel import mesh
        self.mesh = mesh
        self.real = {n: getattr(mesh, n) for n in ("_reduce", "_gather")}
        self.ms, self.calls = 0.0, 0

        def wrap(real):
            def timed(x, *a):
                if x.is_cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real(x, *a)
                if x.is_cuda:
                    torch.cuda.synchronize()
                self.ms += 1e3 * (time.perf_counter() - t0)
                self.calls += 1
                return out
            return timed
        for n, real in self.real.items():
            setattr(mesh, n, wrap(real))
        return self

    def __exit__(self, *exc):
        for n, real in self.real.items():
            setattr(self.mesh, n, real)


def _dist_run(spec, group, out_prefix=None):
    """`spec["iterations"]` train iterations of a dist task on this rank
    (or the whole run): per iteration the digest of the network's
    parameters, the loss, env steps/s and the all-reduce ms; the launches
    and kernel B's calls with a ceiling over the run; both kernels against
    their plain versions on kernel B's last call (on a card). The final
    state goes to `out_prefix`.pt for the parent's comparisons."""
    dev = torch.device(spec["device"])
    fn, ln, world, obs = _dist_setup(spec, group)
    # one set of initial weights for both runs: the CaT nets' orthogonal
    # init runs a QR on the host, whose bits follow its thread count
    if spec.get("init_save"):
        torch.save(_net(ln).state_dict(), spec["init_save"])
    if spec.get("init_load"):
        _net(ln).load_state_dict(torch.load(spec["init_load"]))
    n_local = ln.env.num_envs
    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" else (
        lambda: None)
    digests, losses, rates, reduce_ms, reduce_calls = [], [], [], [], []
    base_pos = []
    steps = spec["num_steps"]
    with Counted() as c:
        for _ in range(spec["iterations"]):
            with ReduceTimer() as rt:
                sync()
                t0 = time.perf_counter()
                world, obs, stats = fn(world, obs)
                sync()
                wall = time.perf_counter() - t0
            rates.append(steps * n_local / wall)
            reduce_ms.append(rt.ms)
            reduce_calls.append(rt.calls)
            digests.append(_param_digest(ln))
            losses.append(float(stats["loss"]))
            base_pos.append(world.env.phys.base_pos.cpu())
    _finite(dict(enumerate(losses)), f"dist {spec['task']}")
    env = ln.env
    state = {"params": {k: v.detach().cpu()
                        for k, v in _net(ln).state_dict().items()}}
    legged = spec["task"] in DIST_LEGGED
    e = world.env if legged else world.env
    state["base_pos"] = e.phys.base_pos.cpu()
    state["base_pos_by_iteration"] = base_pos
    ceiling = None if legged else getattr(env, "hf_ceiling", None)
    if not legged:
        state["running_max"] = world.cat.running_max.cpu()
        state["terrain_level"] = e.terrain_level.cpu()
        for name in ("obs_rms", "value_rms"):
            r = getattr(ln, name)
            state[name] = {f: getattr(r, f).detach().cpu()
                           for f in ("mean", "var", "count")}
    if out_prefix:
        torch.save(state, out_prefix + ".pt")
    rec = dict(task=spec["task"], num_envs=n_local,
               iterations=spec["iterations"], param_digests=digests,
               losses=losses, env_steps_per_s=rates,
               collective_ms_per_iteration=reduce_ms,
               collectives_per_iteration=reduce_calls, **c.record(),
               ceiling=ceiling is not None and not ceiling.is_flat,
               expected_launches_per_kernel=(
                   spec["iterations"] * steps * env.cfg.control.decimation
                   if legged else spec["iterations"] * steps
                   * env.cfg.decimation))
    rec["last_call"] = _last_call_check(c, f"dist {spec['task']}")
    if dev.type == "cuda":
        _check_launches(f"dist {spec['task']} rank", rec)
    return rec, state


def dist_worker(spec_path) -> int:
    """One rank of a dist phase (`--dist-worker`): joins the group over
    gloo, runs each task of the spec and writes its record and state."""
    from wtw_tpu_torch.parallel import mesh
    with open(spec_path) as f:
        spec = json.load(f)
    if spec["device"] != "cpu":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    group = mesh.init_group("gloo", spec["init_method"], spec["world_size"],
                            spec["rank"])
    out = {}
    for task in spec["tasks"]:
        prefix = f"{spec['out']}_{task}_rank{spec['rank']}"
        out[task], _ = _dist_run(dict(spec, task=task), group, prefix)
    with open(f"{spec['out']}_rank{spec['rank']}.json", "w") as f:
        json.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def _spawn_ranks(spec, ranks, d, timeout):
    """Start `ranks` worker processes of this script on `spec` and wait
    for all of them; every rank must exit 0. -> their records."""
    procs = []
    env = dict(os.environ, OMP_NUM_THREADS="1")
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    try:
        for r in range(ranks):
            path = os.path.join(d, f"spec{r}.json")
            with open(path, "w") as f:
                json.dump(dict(spec, rank=r, world_size=ranks), f)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-worker",
                 path], cwd=root, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = {r: (p.returncode, o[1][-3000:])
           for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode != 0}
    if bad:
        raise AssertionError(f"dist ranks failed: {bad}")
    recs = []
    for r in range(ranks):
        with open(f"{spec['out']}_rank{r}.json") as f:
            recs.append(json.load(f))
    return recs


def _close(a, b, what, atol=0.0, rtol=0.0):
    err = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    bar = atol + rtol * float(b.double().abs().max()) if b.numel() else atol
    if not torch.allclose(a.double(), b.double(), atol=atol, rtol=rtol):
        raise AssertionError(f"{what}: {err} off the 1-rank run")
    return err


def phase_dist(task="go1_flat", device="cuda", num_envs=B, ranks=2,
               iterations=3, num_steps=24, num_minibatches=4, overrides=(),
               timeout=900):
    """Env-sharded data-parallel training (`wtw_tpu_torch.parallel`):
    `ranks` ranks of `num_envs / ranks` envs each, as worker processes of
    this script joined over gloo (two ranks share the one card, which NCCL
    refuses; gloo reduces on the host), against one rank of `num_envs` in
    this process, from the same initial world (built whole from the seed,
    then cut by `shard_world`) and the same parameters (the 1-rank run's,
    loaded by every rank, then broadcast from rank 0 by
    `make_distributed_*_train_fn`), with `sharding_invariant` learners and
    1 epoch, for
    `iterations` iterations: the ranks' parameters bitwise equal after
    every iteration; after the last, the parameters within 3e-3 of the
    1-rank run, base_pos within 1e-3 and the loss within rtol 1e-3 (the
    bars of tests/test_parallel.py:209-216); with `task="parkour"` (CaT
    PPO on the parkour course) also CaT's running max within rtol 1e-3,
    both normalizers' moments within rtol 1e-3, the terrain levels equal
    and the ceiling on every kernel B call (tests/test_parallel.py:
    138-166; on a course with a ceiling). On a card, each rank's launches
    are exact and both kernels
    are held against their plain versions on its last call. Two ranks on
    one card give no scaling number."""
    spec = dict(task=task, tasks=[task], device=device, num_envs=num_envs,
                num_steps=num_steps, num_minibatches=num_minibatches,
                iterations=iterations, overrides=list(overrides))
    d = tempfile.mkdtemp(prefix=f"wtw_chip_smoke_dist_{task}_")
    try:
        init = os.path.join(d, "init.pt")
        t0 = time.perf_counter()
        ref, ref_state = _dist_run(dict(spec, init_save=init), None)
        ref_s = time.perf_counter() - t0
        spec.update(init_method="file://" + os.path.join(d, "rendezvous"),
                    out=os.path.join(d, "out"), init_load=init)
        t0 = time.perf_counter()
        recs = [r[task] for r in _spawn_ranks(spec, ranks, d, timeout)]
        ranks_s = time.perf_counter() - t0
        states = [torch.load(f"{spec['out']}_{task}_rank{r}.pt")
                  for r in range(ranks)]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for it in range(iterations):
        if len({r["param_digests"][it] for r in recs}) != 1:
            raise AssertionError(f"dist {task}: the ranks' parameters "
                                 f"differ after iteration {it}")
    for k in ("params",):
        for name, v in states[0][k].items():
            for s in states[1:]:
                if not torch.equal(s[k][name], v):
                    raise AssertionError(f"dist {task}: replicas differ "
                                         f"in {name}")
    by_it = []
    for it in range(iterations):
        d = (torch.cat([s["base_pos_by_iteration"][it] for s in states])
             - ref_state["base_pos_by_iteration"][it]).abs()
        by_it.append({"max": float(d.max()),
                      "share_over_1e-3": float((d > 1e-3).float().mean()),
                      "share_nonzero": float((d > 0).float().mean())})
    errs = {"params": max(_close(states[0]["params"][k], v, f"{task} {k}",
                                 atol=3e-3)
                          for k, v in ref_state["params"].items()),
            "base_pos": _close(torch.cat([s["base_pos"] for s in states]),
                               ref_state["base_pos"], f"{task} base_pos",
                               atol=1e-3)}
    loss = recs[0]["losses"][-1]
    if not math.isclose(loss, ref["losses"][-1], rel_tol=1e-3,
                        abs_tol=1e-4):
        raise AssertionError(f"dist {task}: loss {loss} against the 1-rank "
                             f"run's {ref['losses'][-1]}")
    errs["loss_rel"] = abs(loss - ref["losses"][-1]) / max(
        abs(ref["losses"][-1]), 1e-12)
    if task == "parkour":
        errs["running_max"] = _close(states[0]["running_max"],
                                     ref_state["running_max"],
                                     "parkour running max", rtol=1e-3)
        for name in ("obs_rms", "value_rms"):
            for f in ("mean", "var", "count"):
                errs[f"{name}_{f}"] = _close(
                    states[0][name][f], ref_state[name][f],
                    f"parkour {name}.{f}", rtol=1e-3, atol=1e-4)
        lvl = torch.cat([s["terrain_level"] for s in states])
        if not torch.equal(lvl, ref_state["terrain_level"]):
            raise AssertionError("dist parkour: terrain levels differ")
        # kernel B's launches on a card (a graph's replay calls no
        # wrapper), the plain version's calls on the CPU
        key = ("dynamics_calls_with_ceiling" if device == "cpu"
               else "dynamics_launches_with_ceiling")
        for r in recs + [ref]:
            if r["ceiling"] and (r[key]
                                 != r["expected_launches_per_kernel"]):
                raise AssertionError("dist parkour: kernel B ran without "
                                     "the ceiling")
    bitwise = all(v == 0.0 for v in errs.values())
    return dict(task=task, ranks=ranks, num_envs_per_rank=recs[0]["num_envs"],
                iterations=iterations, one_rank=ref, per_rank=recs,
                one_rank_s=ref_s, ranks_s=ranks_s, max_abs_err=errs,
                base_pos_by_iteration=by_it,
                bitwise_equal_to_one_rank=bitwise,
                launches=recs[0]["launches"],
                replicas_bitwise_equal=True, scaling_number=False)


def phase_dist_learners(device="cuda", num_envs=16, num_steps=4,
                        num_minibatches=2, overrides_by_task=None,
                        timeout=900):
    """ppo_rma (go1_flat), cat_ppo_plus and cat_ppornn (the parkour
    course) one iteration each on 2 ranks, in one spawn: the ranks'
    parameters bitwise equal (these learners have no sharding_invariant
    mode, as in the JAX package). `overrides_by_task`: {task: the
    `section.field=value` overrides of its config and learner}."""
    spec = dict(tasks=["rma", "ppo_plus", "ppornn"], device=device,
                num_envs=num_envs, num_steps=num_steps,
                num_minibatches=num_minibatches, iterations=1,
                overrides_by_task=dict(overrides_by_task or {}))
    d = tempfile.mkdtemp(prefix="wtw_chip_smoke_dist_learners_")
    try:
        spec.update(init_method="file://" + os.path.join(d, "rendezvous"),
                    out=os.path.join(d, "out"))
        recs = _spawn_ranks(spec, 2, d, timeout)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for task in spec["tasks"]:
        if recs[0][task]["param_digests"] != recs[1][task]["param_digests"]:
            raise AssertionError(f"dist {task}: the ranks' parameters differ")
    return {task: dict(losses=recs[0][task]["losses"],
                       launches=recs[0][task]["launches"],
                       replicas_bitwise_equal=True)
            for task in spec["tasks"]}


PROFILED_STEPS = 16


def phase_video_record(checkpoint, device="cuda", num_envs=4000, steps=250):
    """`utils/video.record_rollout` of the go1_mob policy of phase 13 (its
    `.pt`, through play's loader: the env from the file's config at
    `num_envs` envs, every DR off except the lag, the trot at 3 Hz and vx
    1.5), `steps` policy steps (the JAX default) of env 0: each kernel
    launched exactly steps x 4; a finite trajectory of (steps, 3), (steps,
    4) and (steps, 12); a second record from the same seed bitwise equal
    to the first; one device-to-host copy in a record (the profiler's
    `Memcpy DtoH` events over a `PROFILED_STEPS`-step record); both
    kernels against their plain versions on the last call. The card cannot
    render here (no matplotlib)."""
    from wtw_tpu_torch import play
    from wtw_tpu_torch.utils.video import record_rollout
    dev = torch.device(device)
    t0 = time.perf_counter()
    env, policy, cfg, _ = play.build(checkpoint, num_envs, None, SEED,
                                     device, "go1_mob")
    commands = play.command_vector(cfg.commands.num_commands, 1.5, 0.0,
                                   "trot", 3.0, 0.08)
    build_s = time.perf_counter() - t0
    with Counted() as c:
        tr = record_rollout(env, policy, steps, seed=SEED, commands=commands)
    if dev.type == "cuda":
        _expect_launches("video_record", c, steps * 4)
    tr2 = record_rollout(env, policy, steps, seed=SEED, commands=commands)
    # the device-to-host copies of a record, counted by the profiler on a
    # short one (the read-back is one at any length; 250 profiled steps
    # take the profiler ~50 s)
    acts = [torch.profiler.ProfilerActivity.CUDA if dev.type == "cuda"
            else torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        record_rollout(env, policy, PROFILED_STEPS, seed=SEED,
                       commands=commands)
    d2h = sum(e.count for e in prof.key_averages()
              if "dtoh" in e.key.lower().replace(" ", ""))
    shapes = [list(tr.base_pos.shape), list(tr.base_quat.shape),
              list(tr.joint_q.shape)]
    if shapes != [[steps, 3], [steps, 4], [steps, env.num_actions]]:
        raise AssertionError(f"video_record: trajectory shapes {shapes}")
    if not all(np.isfinite(x).all() for x in (tr.base_pos, tr.base_quat,
                                              tr.joint_q)):
        raise AssertionError("video_record: non-finite trajectory")
    same = all(np.array_equal(a, b) for a, b in (
        (tr.base_pos, tr2.base_pos), (tr.base_quat, tr2.base_quat),
        (tr.joint_q, tr2.joint_q)))
    if not same:
        raise AssertionError("video_record: two records from one seed "
                             "differ")
    if dev.type == "cuda" and d2h != 1:
        raise AssertionError(f"video_record: {d2h} device-to-host copies "
                             f"in a record")
    return dict(num_envs=env.num_envs, steps=steps, env_index=0,
                shapes=shapes, launches=c.launches, build_s=build_s,
                record_s=c.seconds, ms_per_policy_step=1e3 * c.seconds
                / steps, device_to_host_copies=d2h,
                device_to_host_copies_steps=PROFILED_STEPS,
                bitwise_repeatable=same,
                base_height_mean=float(tr.base_pos[:, 2].mean()),
                last_call=_last_call_check(c, "video_record"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true",
                    help="only the device, the build and the kernel cases "
                         "(phases 1-5, 8-9, 12 and 14), with no result line: "
                         "to time the kernels of another checkout, copy this "
                         "file into it and run it there")
    ap.add_argument("--dist-worker", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dist_worker:
        return dist_worker(args.dist_worker)
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
    device_name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": device_name, "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    lib = K.build()
    # an older checkout's kernels (run there with --kernels) have no
    # launch-shape query
    shape = getattr(K, "launch_shape", lambda: None)()
    emit({"phase": "build", "library": os.path.basename(lib.path),
          "nvcc_seconds": lib.build_seconds, "ptxas": lib.ptxas,
          "launch_shape": shape, "seconds": time.perf_counter() - t0})

    model = load_robot("go1", device=dev)
    go2 = load_robot("go2", device=dev)
    # the new robots' specs, where the checkout has them (an older one,
    # timed with --kernels, may not)
    robots = {}
    for key in ROBOT_PRESET:
        try:
            robots[key] = load_robot(key, device=dev)
        except FileNotFoundError:
            if not args.kernels:
                raise
    new_kernel_phases = [
        (f"{kind}_{key}", fn, m) for key, m in robots.items()
        for kind, fn in (("kernel_a", phase_kernel_a),
                         ("kernel_b", phase_kernel_b))]
    # an older checkout's kernels (timed with --kernels) may take no robot
    # index; each mixed case on four robots and on train_multi's three
    multi_kernel_phases = [
        (f"{kind}{tag}", fn, robots_) for tag, robots_ in (
            ("", MIX), ("_train", TRAIN_MIX))
        for kind, fn in (("kernel_a_multi", phase_kernel_a_multi),
                         ("kernel_b_multi", phase_kernel_b_multi))
    ] if hasattr(K, "slot_table") else []
    results = {}
    if args.kernels:
        for phase, fn, m in [("kernel_a", phase_kernel_a, model),
                             ("kernel_b", phase_kernel_b, model),
                             ("ragged", phase_ragged, model),
                             ("kernel_a_go2", phase_kernel_a, go2),
                             ("kernel_b_ceiling", phase_kernel_b_ceiling, go2),
                             ("kernel_b_edges", phase_kernel_b_edges, model)
                             ] + new_kernel_phases:
            t0 = time.perf_counter()
            emit({"phase": phase, **fn(m, dev),
                  "seconds": time.perf_counter() - t0})
        for phase, fn, robots_ in multi_kernel_phases:
            t0 = time.perf_counter()
            emit({"phase": phase, **fn(dev, robots=robots_),
                  "seconds": time.perf_counter() - t0})
        print(smi_line, flush=True)
        return 0

    def run(phase, fn, *a, **kw):
        t0 = time.perf_counter()
        results[phase] = fn(*a, **kw)
        emit({"phase": phase, **results[phase],
              "seconds": time.perf_counter() - t0})
        return results[phase]

    # the policies that the eval phases load: go1_mob's and parkour's
    ckpt_dir = tempfile.mkdtemp(prefix="wtw_chip_smoke_policies_")
    ckpt = {k: os.path.join(ckpt_dir, f"{k}.pt") for k in ("go1_mob",
                                                           "parkour")}
    try:
        return _run_all(run, results, model, go2, robots, new_kernel_phases,
                        multi_kernel_phases, dev, ckpt, shape, smi_line,
                        device_name)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _run_all(run, results, model, go2, robots, new_kernel_phases,
             multi_kernel_phases, dev, ckpt, shape, smi_line, device_name):
    """Every phase after the build, the kernels line and the result line
    (`main`'s full run)."""
    from wtw_tpu_torch.physics import kernels as K
    for phase, fn in (("kernel_a", phase_kernel_a), ("kernel_b", phase_kernel_b),
                      ("ragged", phase_ragged), ("rollout", phase_rollout)):
        run(phase, fn, model, dev)
    kept = {"go1_flat": {}, "multi": {}}
    tr = run("training", phase_preset_training, "go1_flat", num_envs=B,
             keep=kept["go1_flat"])
    _check_launches("go1_flat training", tr)

    for phase, fn in (("kernel_a_go2", phase_kernel_a),
                      ("kernel_b_ceiling", phase_kernel_b_ceiling),
                      ("parkour_rollout", phase_parkour_rollout)):
        run(phase, fn, go2, dev)
    pk = run("parkour_training", phase_parkour_training,
             checkpoint_to=ckpt["parkour"])
    _check_launches("parkour training", pk)
    _check_ceiling("parkour training", pk)

    run("kernel_b_edges", phase_kernel_b_edges, model, dev)
    mob = run("mob_training", phase_preset_training, "go1_mob",
              checkpoint_to=ckpt["go1_mob"])
    _check_launches("go1_mob training", mob)

    # the fifth slice: kernels A and B on B1 and the mini-cheetah, Go2
    # Terrain (no ceiling), and the other presets of `train`
    for phase, fn, m in new_kernel_phases:
        run(phase, fn, m, dev)
    for key, m in robots.items():
        run(f"rollout_{key}", phase_robot_rollout, m, dev)
    terrain = run("terrain_training", phase_parkour_training, task="terrain")
    _check_launches("terrain training", terrain)
    if terrain["dynamics_launches_with_ceiling"] or terrain["has_ceiling"]:
        raise AssertionError("terrain training: kernel B was given a "
                             "ceiling")
    full = run("terrain_training_full_rewards", phase_parkour_training,
               iterations=1, warmup=0, task="terrain", reward_mode="full")
    _check_launches("terrain training with the full rewards", full)
    presets = {}
    for preset in ("go2_flat", "b1_flat", "mini_cheetah_flat", "go2_mob",
                   "b1_mob"):
        presets[preset] = run(
            "presets_training", phase_preset_training, preset,
            num_envs=(B if preset.endswith("_flat") else None),
            iterations=1)
        _check_launches(f"{preset} training", presets[preset])

    # the sixth slice: the other learners of the two training CLIs
    plus = run("ppo_plus_training", phase_parkour_training, iterations=2,
               algo="ppo_plus")
    _check_launches("ppo_plus training", plus)
    rnn = run("ppornn_training", phase_parkour_training, iterations=2,
              algo="ppornn")
    _check_launches("ppornn training", rnn)
    for algo, r in (("ppo_plus", plus), ("ppornn", rnn)):
        _check_ceiling(f"{algo} training", r)
    rma = run("rma_training", phase_preset_training, "go1_flat", num_envs=B,
              iterations=2, algo="rma")
    _check_launches("rma training", rma)
    pbt = run("pbt_training", phase_pbt_training)
    _check_launches("pbt training", pbt)

    # the seventh slice: mixed-robot batches, both kernels reading a
    # per-env robot index
    for phase, fn, robots_ in multi_kernel_phases:
        run(phase, fn, dev, robots=robots_)
    for phase in ("kernel_a_multi_train", "kernel_b_multi_train"):
        r = results[phase]
        if min(c["empty_slots"] for c in (
                r.values() if "flat" in r else [r])) <= 0:
            raise AssertionError(f"{phase}: no block with empty slots")
    run("multi_pure_go1", phase_multi_pure_go1, dev)
    run("multi_rollout", phase_multi_rollout, dev)
    multi = run("multi_training", phase_multi_training, keep=kept["multi"])
    _check_launches("multi training", multi)
    kts = run("kernel_b_training_states", phase_kernel_b_training_states,
              dev, kept["go1_flat"]["dynamics"], kept["multi"]["dynamics"])

    # the eighth slice: the eval entry points on the policies trained above
    ep = run("eval_play", phase_eval_play, ckpt["go1_mob"])
    eg = run("eval_gaits", phase_eval_gaits, ckpt["go1_mob"])
    dp = run("diag_parkour", phase_diag_parkour, ckpt["parkour"])

    # the ninth slice: vision distillation on the parkour policy of phase
    # 11 (the chip copy has no checkpoints/), then actuator_train and sweep
    vdir = tempfile.mkdtemp(prefix="wtw_chip_smoke_vision_")
    try:
        demos = os.path.join(vdir, "rb_demos.pt")
        vg = run("vision_generate", phase_vision_generate, ckpt["parkour"],
                 demos)
        vt = run("vision_train", phase_vision_train, demos, vdir)
        ves = run("vision_eval_student", phase_vision_eval,
                  os.path.join(vdir, "vision_student.pt"))
        vee = run("vision_eval_expert", phase_vision_eval, ckpt["parkour"],
                  student=False)
    finally:
        shutil.rmtree(vdir, ignore_errors=True)
    run("actuator_train", phase_actuator_train)
    run("sweep", phase_sweep)
    vision = {"vision_generate": vg, "vision_train": vt,
              "vision_eval_student": ves, "vision_eval_expert": vee}

    # the tenth slice: go1_mob with bf16 products beside phase 13's fp32,
    # env-sharded training on two ranks of the one card, and the video
    # recorder on phase 13's policy
    bf = run("train_go1_mob_bf16", phase_bf16_training, fp32=mob)
    _check_launches("go1_mob bf16 training", bf)
    dist = {"dist_go1_flat": run("dist_go1_flat", phase_dist, "go1_flat"),
            "dist_parkour": run("dist_parkour", phase_dist, "parkour")}
    video = run("video_record", phase_video_record, ckpt["go1_mob"])
    slice_paths = {"go1_mob_bf16": bf, "video_record": video}
    for name, r in dist.items():
        slice_paths[f"{name}_one_rank"] = r["one_rank"]
        for i, rr in enumerate(r["per_rank"]):
            slice_paths[f"{name}_rank{i}"] = rr
    slice_states = {"go1_mob_bf16": bf["last_call"],
                    "video_record": video["last_call"]}
    for name, r in dist.items():
        slice_states[f"{name}_one_rank"] = r["one_rank"]["last_call"]
        for i, rr in enumerate(r["per_rank"]):
            slice_states[f"{name}_rank{i}"] = rr["last_call"]

    # both kernels against their plain versions on each eval run's last
    # kernel B inputs (64, 4000, 32 and 64 envs, and 1024 in the vision
    # runs), and kernel A on the renderer's last inputs
    eval_states = {f"eval_play_{k}": r["last_call"]
                   for k, r in ep["runs"].items()}
    eval_states.update(eval_gaits=eg["last_call"],
                       diag_parkour=dp["last_call"])
    eval_states.update({p: r["last_call"] for p, r in vision.items()})
    eval_states.update(slice_states)
    render_err = {p: r["renderer"]["kernel_a_max_abs_err"]
                  for p, r in vision.items() if "renderer" in r}
    ka, kb, rg = results["kernel_a"], results["kernel_b"], results["ragged"]
    ka2, kc = results["kernel_a_go2"], results["kernel_b_ceiling"]
    ke = results["kernel_b_edges"]
    kam, kbm = results["kernel_a_multi"], results["kernel_b_multi"]
    kamt, kbmt = (results["kernel_a_multi_train"],
                  results["kernel_b_multi_train"])
    robot_a = {k: results[f"kernel_a_{k}"] for k in robots}
    robot_b = {k: results[f"kernel_b_{k}"] for k in robots}
    worst_b = max(list(kb.values()) + [rg["kernel_b"], ke]
                  + [c for r in robot_b.values() for c in r.values()]
                  + list(kbm.values()) + list(kbmt.values()),
                  key=lambda r: r["max_abs_err"])
    paths = {"go1_flat": tr, "parkour": pk, "go1_mob": mob,
             "terrain": terrain, "terrain_full_rewards": full, **presets,
             "ppo_plus": plus, "ppornn": rnn, "rma": rma, "pbt": pbt,
             "multi": multi, "eval_play": ep, "eval_gaits": eg,
             "diag_parkour": dp, **vision, **slice_paths}
    by_path = lambda name: {p: r["launches"][name] for p, r in paths.items()}
    slice_launches = lambda name: sum(r["launches"][name]
                                      for r in slice_paths.values())
    per_robot_a = {}
    for k, r in robot_a.items():
        per_robot_a.update({f"{k}_ms": r["device_ms"],
                            f"{k}_call_ms": r["call_ms"],
                            f"{k}_plain_ms": r["plain_ms"],
                            f"{k}_bound_ms": r["bound_ms"]})
    per_robot_b = {}
    for k, r in robot_b.items():
        for terr, c in r.items():
            per_robot_b.update({f"{k}_{terr}_ms": c["device_ms"],
                                f"{k}_{terr}_call_ms": c["call_ms"],
                                f"{k}_{terr}_plain_ms": c["plain_ms"],
                                f"{k}_{terr}_bound_ms": c["bound_ms"],
                                f"{k}_{terr}_max_abs_err": c["max_abs_err"]})
    multi_b = {}
    for tag, cases in (("multi", kbm), ("multi_train", kbmt)):
        for terr, c in cases.items():
            multi_b.update({f"{tag}_{terr}_ms": c["device_ms"],
                            f"{tag}_{terr}_call_ms": c["call_ms"],
                            f"{tag}_{terr}_plain_ms": c["plain_ms"],
                            f"{tag}_{terr}_bound_ms": c["bound_ms"],
                            f"{tag}_{terr}_max_abs_err": c["max_abs_err"]})
    multi_b.update(
        multi_training_states_ms=kts["device_ms"],
        multi_training_states_plain_ms=kts["plain_ms"],
        multi_training_states_bound_ms=kts["bound_ms"],
        multi_training_states_max_abs_err=kts["max_abs_err"],
        training_states_position_bar=kts["against_plain"]["multi"][
            "position_bar"],
        go1_flat_training_states_ms=kts["go1_flat"]["device_ms"],
        go1_flat_training_states_bound_ms=kts["go1_flat"]["bound_ms"])
    kernels = [
        dict(name=K.FK.name, route="cuda", source=K.FK.source,
             replaces=K.FK.replaces, launches=slice_launches(K.FK.name),
             launches_by_path=by_path(K.FK.name),
             max_abs_err=max([ka["max_abs_err"], ka2["max_abs_err"],
                              rg["kernel_a"]["max_abs_err"],
                              kam["max_abs_err"], kamt["max_abs_err"]]
                             + [r["max_abs_err"] for r in robot_a.values()]
                             + [c["kernel_a_max_abs_err"]
                                for c in eval_states.values()]
                             + list(render_err.values())),
             eval_states_max_abs_err={
                 p: c["kernel_a_max_abs_err"]
                 for p, c in eval_states.items()},
             renderer_max_abs_err=render_err,
             render_ms={p: r["renderer"]["render_ms"]
                        for p, r in vision.items() if "renderer" in r},
             tolerance=ka["tolerance"],
             ms=ka2["ms"], kernel_ms=ka2["ms"], device_ms=ka2["device_ms"],
             call_ms=ka2["call_ms"], plain_ms=ka2["plain_ms"],
             bound_ms=ka2["bound_ms"], bound_by=ka2["bound_by"],
             go1_ms=ka["device_ms"], go1_call_ms=ka["call_ms"],
             go1_plain_ms=ka["plain_ms"],
             go1_bound_ms=ka["bound_ms"], ragged_4000_ms=rg["kernel_a"]["ms"],
             **per_robot_a,
             multi_ms=kam["device_ms"], multi_call_ms=kam["call_ms"],
             multi_plain_ms=kam["plain_ms"], multi_bound_ms=kam["bound_ms"],
             multi_max_abs_err=kam["max_abs_err"],
             multi_train_ms=kamt["device_ms"],
             multi_train_call_ms=kamt["call_ms"],
             multi_train_plain_ms=kamt["plain_ms"],
             multi_train_bound_ms=kamt["bound_ms"],
             multi_train_max_abs_err=kamt["max_abs_err"],
             launch_shape=shape[K.FK.name],
             multi_launch_shape=shape[f"{K.FK.name}_multi"], library_ms=None),
        dict(name=K.DYNAMICS.name, route="cuda", source=K.DYNAMICS.source,
             replaces=K.DYNAMICS.replaces,
             launches=slice_launches(K.DYNAMICS.name),
             launches_by_path=by_path(K.DYNAMICS.name),
             max_abs_err=max([worst_b["max_abs_err"], kc["max_abs_err"],
                              kc["no_ceiling_max_abs_err"]]
                             + [c["max_abs_err"]
                                for c in eval_states.values()]),
             eval_states_max_abs_err={
                 p: c["max_abs_err"] for p, c in eval_states.items()},
             tolerance=DYN_TOL,
             ms=kc["ms"], kernel_ms=kc["ms"], device_ms=kc["device_ms"],
             call_ms=kc["call_ms"], plain_ms=kc["plain_ms"],
             bound_ms=kc["bound_ms"], bound_by=kc["bound_by"],
             ceiling_ms=kc["ms"], ceiling_max_abs_err=kc["max_abs_err"],
             ceiling_bound_ms=kc["bound_ms"],
             touching_ceiling_spheres_per_env=kc[
                 "touching_ceiling_spheres_per_env"],
             go2_no_ceiling_ms=kc["no_ceiling_ms"],
             go2_no_ceiling_call_ms=kc["no_ceiling_call_ms"],
             go2_no_ceiling_plain_ms=kc["no_ceiling_plain_ms"],
             go2_no_ceiling_bound_ms=kc["no_ceiling_bound_ms"],
             flat_ms=kb["flat"]["ms"], flat_call_ms=kb["flat"]["call_ms"],
             flat_plain_ms=kb["flat"]["plain_ms"],
             flat_bound_ms=kb["flat"]["bound_ms"],
             rough_ms=kb["rough"]["ms"], rough_call_ms=kb["rough"]["call_ms"],
             rough_plain_ms=kb["rough"]["plain_ms"],
             rough_bound_ms=kb["rough"]["bound_ms"],
             ragged_4000_ms=rg["kernel_b"]["ms"],
             edges_ms=ke["ms"], edges_call_ms=ke["call_ms"],
             edges_plain_ms=ke["plain_ms"], edges_bound_ms=ke["bound_ms"],
             edges_max_abs_err=ke["max_abs_err"], **per_robot_b, **multi_b,
             launch_shape=shape[K.DYNAMICS.name],
             multi_launch_shape=shape[f"{K.DYNAMICS.name}_multi"],
             library_ms=None),
    ]
    emit({"kernels": kernels})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
