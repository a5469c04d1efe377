"""Where one training iteration's time goes on the GPU.

    python -m wtw_tpu_torch.trace [--task go1_flat|...|b1_mob|parkour|terrain|multi|vision]
                                  [--algo ppo|ppo_plus|ppornn|ppo_cse|rma]
                                  [--num-envs N] [--iterations 2]
                                  [--set K=V ...]

Builds the task at full width (a preset of `train.build`, such as go1_flat,
go1_mob or b1_mob, with the PPO learner or `--algo rma`; or through
`train_parkour.build` Go2 parkour with CaT on the full course, `parkour`,
or Go2Terrain on its Stack-A map, `terrain`, with CaT PPO or `--algo
ppo_plus|ppornn`; or through `train_multi.build` a mixed-robot batch,
`multi`, go1/go2/b1 interleaved (the JAX package's round-5 mix), whose
iteration also takes the per-robot reward step; or the vision student of
`train_vision train`, `vision`, at `DDPGArgs`' defaults on the parkour
course, whose iteration is one collect step (the depth frame, the
student, the env step) and one update round of 8 substeps against a
16-step demo buffer of a zero-action expert; N defaults to 4096 envs,
vision's to 1024, a MoB preset's to its own count), runs one warm-up iteration, then times the rollout and the update of each further
iteration separately (host clock, each ending in
`torch.cuda.synchronize()`), and profiles the last one with
`torch.profiler`: device time by kernel (self time summed over launches),
by group (the two physics kernels, matrix products, PyTorch's gathers
such as the heightfield corner rows, everything else), the
kernel launches of the iteration, the device time of kernel B's
corner-row gathers (the kernels launched inside the `hf_corner_gather`
profiler ranges of `physics/batched.py`; with `vision` also the device
time of the depth march's ground lookups, its `depth_march_ground`
ranges), and the device's busy share of
the iteration's wall time (one stream, so kernel times do not overlap).
A last line gives the host spans of `utils/spans.py` an iteration (calls,
inclusive and self ms, the host syncs charged to each while it was the
innermost), the host syncs and their blocked ms, and the env steps
replayed as a CUDA graph and the world fields copied into the env's state
arena (`env_graph_replays`, `env_state_copy_ins`), averaged over the
timed iterations that ran without the profiler (the profiled one where
there is none). `--set` takes the training CLIs' overrides (e.g. `--set
ac.compute_dtype=bfloat16` with a preset, for a bf16 iteration). Prints
one JSON line per result. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch

from .config import PRESETS
from .envs.depth import MARCH_RANGE
from .physics.batched import GATHER_RANGE
from .utils import spans


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _range_device_us(prof, name: str):
    """(device us, calls) of the kernels launched inside the CPU-side
    profiler ranges called `name`."""
    us, calls = 0.0, 0
    for e in prof.events():
        if e.name == name and e.device_type == torch.autograd.DeviceType.CPU:
            calls += 1
            for attr in ("device_time_total", "cuda_time_total"):
                if hasattr(e, attr):
                    us += float(getattr(e, attr))
                    break
    return us, calls


def _group(name: str) -> str:
    n = name.lower()
    if "wtw_fk" in n:
        return "kernel A (fk)"
    if "wtw_dynamics" in n:
        return "kernel B (dynamics)"
    if ("gemm" in n or "cutlass" in n or "sm90_" in n or "xmma" in n
            or "nvjet" in n):
        return "matrix products"
    if "gather" in n:
        return "gathers"
    return "other kernels"


def _vision(num_envs, seed):
    """-> (env, one iteration) of `--task vision`: the iteration runs one
    collect step and one update round and returns their host seconds, each
    ending in `torch.cuda.synchronize()`."""
    from .learn import ddpg_demos as D
    from .train_vision import build_env
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = build_env(num_envs, seed, device="cuda")
    args = D.DDPGArgs(buffer_steps=256)
    zeros = torch.zeros(num_envs, env.num_actions, device=env.device)
    demos = D.generate_demos(lambda obs: zeros, env, 16, seed,
                             D.DDPGArgs(buffer_steps=64))
    learner = D.DDPGLearner(env.num_obs, env.num_actions, args, seed,
                            env.device)
    col = D.Collector(env, learner, args, seed)

    def iteration():
        t0 = time.perf_counter()
        col.collect()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        learner.update_round(col.rb, demos, True)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1
    return env, iteration


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="go1_flat",
                    choices=sorted(PRESETS) + ["parkour", "terrain", "multi",
                                               "vision"])
    ap.add_argument("--algo", default=None,
                    choices=["ppo", "ppo_plus", "ppornn", "ppo_cse", "rma"],
                    help="the learner: ppo (default), ppo_plus or ppornn on "
                         "parkour and terrain; ppo_cse (default) or rma on "
                         "a preset")
    ap.add_argument("--num-envs", type=int, default=None)
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="an override of the training CLI, e.g. --set "
                         "ac.compute_dtype=bfloat16")
    args = ap.parse_args(argv)
    parkour = args.task in ("parkour", "terrain")
    algo = args.algo or ("ppo" if parkour else "ppo_cse")
    if args.task in ("vision", "multi") and args.set:
        ap.error(f"--task {args.task} takes no --set")
    if args.task == "vision":
        if args.algo:
            ap.error("--task vision takes no --algo (DDPG with demos)")
        algo = "ddpg_demos"
    elif (algo in ("ppo", "ppo_plus", "ppornn")) != parkour or (
            args.task == "multi" and algo != "ppo_cse"):
        ap.error(f"--algo {algo} does not train --task {args.task}")
    per_robot = vision_iteration = None
    if args.task == "vision":
        env, vision_iteration = _vision(args.num_envs or 1024, args.seed)
    elif args.task == "multi":
        from .train_multi import build as build_multi
        env, runner = build_multi(("go1", "go2", "b1"),
                                  args.num_envs or 4096, device="cuda",
                                  seed=args.seed, run_dir=tempfile.mkdtemp())
        learner, per_robot = runner.ppo, runner.per_robot_reward
        world, obs = runner.world, runner.obs_dict
    elif parkour:
        from .train_parkour import build as build_parkour
        runner = build_parkour(args.num_envs or 4096, args.set, device="cuda",
                               seed=args.seed, run_dir=tempfile.mkdtemp(),
                               save_interval=0, task=args.task, algo=algo)
        env, learner = runner.env, runner.learner
        world, obs = runner.world, runner.obs_n
    else:
        from .train import build
        n = args.num_envs or (None if args.task.endswith("_mob") else 4096)
        env, runner = build(args.task, n, args.set, device="cuda",
                            seed=args.seed,
                            run_dir=tempfile.mkdtemp(), save_interval=0,
                            algo=algo)
        learner = runner.learner if algo == "rma" else runner.ppo
        world, obs = runner.world, runner.obs_dict

    def iteration():
        nonlocal world, obs
        if vision_iteration is not None:
            return vision_iteration()
        t0 = time.perf_counter()
        world, obs, traj, _ = learner.rollout(world, obs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        learner.update(traj, obs)
        if per_robot is not None:
            per_robot(world, obs)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    iteration()                                   # warm-up
    split = [iteration() for _ in range(max(args.iterations - 1, 0))]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        split.append(iteration())
        wall = time.perf_counter() - t0
    # device-side events only; user annotations ("Optimizer.step#...")
    # also appear on the device and would count their kernels twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and "#" not in e.key and e.key not in (GATHER_RANGE,
                                                      MARCH_RANGE)]
    by_name = sorted(((_device_us(e), e.count, e.key) for e in kernels),
                     reverse=True)
    groups = {}
    for us, count, key in by_name:
        g = groups.setdefault(_group(key), [0.0, 0])
        g[0] += us
        g[1] += count
    gather_us, gather_calls = _range_device_us(prof, GATHER_RANGE)
    march_us, march_calls = _range_device_us(prof, MARCH_RANGE)
    busy_s = sum(us for us, _, _ in by_name) / 1e6
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"device": name, "task": args.task, "algo": algo,
                      "overrides": args.set, "num_envs": env.num_envs,
                      "rollout_s": [r for r, _ in split],
                      "update_s": [u for _, u in split]}))
    print(json.dumps({"profiled_wall_s": wall, "device_busy_s": busy_s,
                      "device_busy_share": busy_s / wall,
                      "launches_per_iteration": sum(
                          c for _, c, _ in by_name),
                      "groups": {k: {"device_ms": v[0] / 1e3, "launches": v[1]}
                                 for k, v in groups.items()},
                      "corner_row_gathers": {"device_ms": gather_us / 1e3,
                                             "calls": gather_calls},
                      "depth_march_ground": {"device_ms": march_us / 1e3,
                                             "calls": march_calls},
                      "max_memory_allocated":
                          torch.cuda.max_memory_allocated()}))
    print(json.dumps({"top_kernels": [
        {"name": key[:90], "device_ms": us / 1e3, "launches": count}
        for us, count, key in by_name[:15]]}))
    print(json.dumps(_span_table(spans.records()[-len(split):])))


def _span_table(recs):
    """The spans and host syncs an iteration, averaged over the records
    that ran without the profiler (all of them where none did)."""
    recs = [r for r in recs if not r["profiled"]] or recs
    n = max(len(recs), 1)
    table = {}
    for r in recs:
        for name, row in r["spans"].items():
            t = table.setdefault(name, [0, 0, 0, 0, 0])
            for i, k in enumerate(("count", "ns", "self_ns", "syncs",
                                   "sync_ns")):
                t[i] += row[k]
    return {"span_iterations": len(recs),
            "profiled": any(r["profiled"] for r in recs),
            "host_syncs": sum(r["counters"]["host_syncs"] for r in recs) / n,
            "sync_wait_ms": sum(r["counters"]["sync_wait_ns"]
                                for r in recs) / n / 1e6,
            **{k: sum(r["counters"][k] for r in recs) / n
               for k in ("env_graph_replays", "env_state_copy_ins")},
            "spans": {k: {"calls": c / n, "ms": ns / n / 1e6,
                          "self_ms": sf / n / 1e6, "syncs": sy / n,
                          "sync_ms": sn / n / 1e6}
                      for k, (c, ns, sf, sy, sn) in table.items()}}


if __name__ == "__main__":
    main()
