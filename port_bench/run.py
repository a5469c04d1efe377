"""Run one cell of the port's benchmark once and print its result line
(`python3 -m port_bench`, which pins the process first, calls `main`).

Builds the cell's training configuration through the port's own CLI
builder on the CUDA card, loads weights made from the seed, runs three
iterations that the reference later follows (they are the warm-up), then
drives whole training iterations for `--seconds`. With `--trace 0` the
last stdout line holds the cell's end-to-end metrics; with `--trace 1`
its per-layer metrics, read from the window's whole iterations (first
half), from split rollout/update timings (second half) and from a
`torch.profiler` trace of the stretch after the window. After the window
the program is freed and the plain reference checks the start, a few env
steps and the three iterations; the compared numbers and their limits end
stderr and the result line (`checks`).
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import random
import statistics
import sys
import tempfile
import time

import torch

from . import cells, check, record
from . import profile as P
from . import weights as W
from .reference import envstep

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "wtw_tpu")
CACHE = os.path.join(cells.ROOT, ".port_bench_cache")


class NoCard(RuntimeError):
    pass


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (so `wtw_tpu_torch` is not `wtw_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _p90(xs):
    s = sorted(xs)
    k = 0.9 * (len(s) - 1)
    lo = math.floor(k)
    return s[lo] + (s[min(lo + 1, len(s) - 1)] - s[lo]) * (k - lo)


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        control=None, fault=None, t_start=None, follow=False):
    """One run of `cell`; -> the result object. `control` "tf32" runs the
    program's products in TF32 (the control; never in a benchmark run),
    `fault` plants one of `faults.py`'s faults (tests and calibration),
    `follow` records the program's parameters after every optimizer step
    of the check iterations for the reference to follow (calibration).
    `t_start`: when the process started (default: now)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            raise NoCard(f"needs {cell['chips']} CUDA card(s), found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        torch.cuda.reset_peak_memory_stats(dev)
    ad = cells.algo(cell["algo"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    with tempfile.TemporaryDirectory(prefix="port_bench_") as run_dir:
        p = ad.build(cell, dev, seed, run_dir)
        if control == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        if fault:
            from . import faults
            faults.plant(fault, p, cell)
        w0 = W.make(ad.weight_spec(cell), gen, dev)
        p.module.load_state_dict(w0, strict=True)
        w0 = {k: v.cpu() for k, v in w0.items()}

        # the check iterations: recorded for the reference, and the warm-up
        K = cell["check_iterations"]
        T = ad.dims(cell).T
        snap_at = sorted(random.Random(seed).sample(range(K * T),
                                                    cell["env_checks"]))
        start = record.to_host(ad.start(p))
        rec = record.StepRecorder(p.env, ad.keep, ad.resets, snap_at)
        first = record.FirstStep(p.opt, p.module.named_parameters())
        trail = (record.StepTrail(p.opt, p.module.named_parameters())
                 if follow else None)
        draws, losses, lrs = [], [], []
        try:
            for _ in range(K):
                dr = ad.draws(cell, gen, dev)
                draws.append(record.to_host(dr))
                stats = ad.iterate(p, dr)
                losses.append(float(stats["loss"]))
                lrs.append(float(stats["lr"]))
        finally:
            rec.close()
            first.close()
            if trail:
                trail.close()
        prog = {"losses": losses, "grad1": first.grads,
                "params": record.to_host(dict(p.module.named_parameters())),
                "actions": [s["actions"] for s in rec.steps], "lrs": lrs,
                "trail": trail.params if trail else None}
        _sync(dev)
        setup_s = time.perf_counter() - t_start

        # the window; a traced run drives whole iterations for its first half
        # (device.mfu reads them) and rollout and update apart for the rest
        walls, win_losses, split = [], [], []
        t0, epoch0 = time.perf_counter(), time.time()
        while True:
            ti = time.perf_counter()
            dr = ad.draws(cell, gen, dev)
            if trace and ti - t0 >= seconds / 2:
                traj = ad.rollout(p, dr)
                _sync(dev)
                tr = time.perf_counter()
                stats = ad.update(p, traj, dr)
                traj = None
                _sync(dev)
                split.append((tr - ti, time.perf_counter() - tr))
            else:
                stats = ad.iterate(p, dr)
                _sync(dev)
            t1 = time.perf_counter()
            walls.append(t1 - ti)
            win_losses.append(stats["loss"].detach().reshape(()))
            if t1 - t0 >= seconds:
                break
        window_s = t1 - t0
        summary = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            n_prof = cell["trace_iterations"]
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function(P.WINDOW):
                    for _ in range(n_prof):
                        dr = ad.draws(cell, gen, dev)
                        ad.iterate(p, dr)
                    _sync(dev)
            summary = P.summarize(prof.events())
            summary["iterations"] = n_prof
            del prof
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        failed = int((~torch.isfinite(torch.stack(win_losses))).sum())
        n_iter = len(walls)
        del p, stats, win_losses, dr
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    d = ad.dims(cell)
    if trace:
        n_whole = n_iter - len(split)
        rec_t = {"cell": cell, "dims": d, "summary": summary,
                 "rollout_s": [r for r, _ in split],
                 "update_s": [u for _, u in split],
                 "whole_s": sum(walls[:n_whole]),
                 "whole_iterations": n_whole,
                 "flops_per_iteration":
                     cells.flops(cell["algo"]).flops_per_iteration(cell),
                 "device": dev.type}
        metrics = {}
        bench = cells.benchmark()
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        for name in cells.per_layer_metrics(cell["name"], bench):
            v = cells.metric_reader(name)(rec_t)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
    else:
        metrics = {
            "env_steps_per_s": {"value": n_iter * d.T * d.N / window_s,
                                "unit": "env_steps/s"},
            "iteration_s_p90": {"value": _p90(walls), "unit": "s"},
            "peak_mem_bytes": {"value": peak, "unit": "bytes"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        keep = cells.end_to_end_metrics(cell["name"], cells.benchmark())
        metrics = {k: v for k, v in metrics.items() if k in keep}

    numbers, diag = reference_check(cell, seed, dev, start, rec, draws,
                                    prog, w0)
    ok, rows = check.verdict(numbers, cell["limits"])
    out = {"correct": ok, "attempted": n_iter, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": peak}}
    if trace:
        out["device"]["busy_s"] = summary["busy_s"]
        out["device"]["window_s"] = summary["window_s"]
        out["breakdown"] = P.breakdown(summary)
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    out["_notes"] = {"iterations": n_iter, "window_s": window_s,
                     "iteration_s_median": statistics.median(walls),
                     "walls": walls, "window_epoch": epoch0,
                     "setup_s": setup_s, "diag": diag}
    return out


def reference_check(cell, seed, dev, start, rec, draws, prog, w0):
    """The plain reference, once the program is freed: the start and the
    recorded env steps against the frozen env, the check iterations
    against the learner's reference. -> (the numbers of `check.NAMES`,
    what a look at them needs)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ad = cells.algo(cell["algo"])
    fenv = envstep.build_env(cell, dev, seed)
    ref_start = record.to_host(envstep.start(fenv, seed,
                                             cell["cfg"]["builder"]))
    numbers = {"start_gap": check.fields_gap(
        ad.start_fields(start), ad.start_fields(ref_start))[0]}
    gaps, wide = [], {}
    for snap in rec.snapshots:
        ref_out = record.to_host(envstep.step(fenv, snap, dev))
        g = check.field_gaps(ad.step_fields(snap["after"]),
                             ad.step_fields(ref_out))
        worst = max(g, key=g.get)
        gaps.append((g[worst], worst))
        wide[snap["t"]] = {k: v for k, v in sorted(
            g.items(), key=lambda kv: -kv[1])[:3] if v > 0}
    numbers["step_gap"], step_worst = max(gaps)
    del fenv
    follow = {"follow": prog["trail"]} if prog["trail"] else {}
    ref = cells.reference(cell["algo"]).run(cell, w0, start, rec.steps,
                                            draws, dev, **follow)
    numbers.update(check.learner_numbers(prog, ref, w0))
    diag = {"step_worst": step_worst,
            "snapshots": [s["t"] for s in rec.snapshots],
            "step_widest": wide,
            "reset_at": rec.reset_at,
            "trail": check.first_departure(ref.get("trail")),
            "losses": [prog["losses"], ref["losses"]],
            "lrs": [prog["lrs"], ref.get("lrs")],
            "leaf_changes": check.leaf_changes(prog, ref, w0),
            "left_out_leaves": check.left_out_leaves(ref)}
    return numbers, diag


def main(argv=None, t_start=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.makedirs(CACHE, exist_ok=True)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    cell = cells.load_cell(args.workload)
    torch.set_num_threads(len(os.sched_getaffinity(0)))
    try:
        out = run(cell, args.seed, args.seconds, bool(args.trace),
                  t_start=t_start)
    except NoCard as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    notes = out.pop("_notes")
    print(f"window: {notes['iterations']} iterations in "
          f"{notes['window_s']:.3f} s (median {notes['iteration_s_median']:.4f}"
          f" s), setup {notes['setup_s']:.3f} s, from epoch "
          f"{notes['window_epoch']:.3f} s", file=sys.stderr)
    print("iteration walls (s): "
          + " ".join(f"{w:.4f}" for w in notes["walls"]), file=sys.stderr)
    print(f"step_gap's widest field: {notes['diag']['step_worst']} "
          f"(steps {notes['diag']['snapshots']}, first reset at "
          f"{notes['diag']['reset_at']}); leaves left "
          f"out of change_gap: {notes['diag']['left_out_leaves']}",
          file=sys.stderr)
    for n, c in out["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0
