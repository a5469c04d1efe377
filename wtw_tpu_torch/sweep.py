"""Hyperparameter grid sweeps on the PyTorch/CUDA port (the counterpart of
`scripts/sweep.py`, the reference's Hydra multirun + SLURM array
gridsearch, scripts/ppo_gridsearch.slurm:13-27): the grid points run one
after another, each as `python -m wtw_tpu_torch.train` in a subprocess.

    python -m wtw_tpu_torch.sweep --preset go1_mob --num-envs 2048 \\
        --iterations 2000 \\
        -a ppo.learning_rate=1e-3,5e-4 -a rewards.sigma_rew_neg=0.02,0.1

Each grid point gets <sweep-dir>/<tag>/ with its metrics.csv; summary.csv
at the sweep root collects the final row of every run with the point's
values and run dir. `--dry-run` prints the command list without training.
`--device` is passed to every run (default: theirs, cuda).
"""
from __future__ import annotations

import argparse
import csv
import itertools
import os
import subprocess
import sys


def commands(args, axes):
    """-> [(tag, run dir, values, command)] of the grid, in order."""
    sweep_dir = args.sweep_dir or f"runs/sweep_{args.preset}"
    out = []
    for combo in itertools.product(*[vs for _, vs in axes]):
        tag = "_".join(f"{k.split('.')[-1]}{v}" for (k, _), v
                       in zip(axes, combo))
        run_dir = os.path.join(sweep_dir, tag)
        cmd = [sys.executable, "-m", "wtw_tpu_torch.train",
               "--preset", args.preset, "--iterations", str(args.iterations),
               "--seed", str(args.seed), "--run-dir", run_dir]
        if args.num_envs:
            cmd += ["--num-envs", str(args.num_envs)]
        if args.device:
            cmd += ["--device", args.device]
        for s in args.set:
            cmd += ["--set", s]
        for (k, _), v in zip(axes, combo):
            cmd += ["--set", f"{k}={v}"]
        out.append((tag, run_dir, combo, cmd))
    return sweep_dir, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="go1_flat")
    ap.add_argument("--num-envs", type=int, default=None)
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep-dir", default=None)
    ap.add_argument("-a", "--axis", action="append", default=[],
                    metavar="K=V1,V2,...",
                    help="sweep axis: config path = comma-separated values")
    ap.add_argument("--set", action="append", default=[],
                    help="fixed overrides applied to every run")
    ap.add_argument("--device", default=None,
                    help="torch device of every run (default: cuda)")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)

    axes = []
    for a in args.axis:
        k, vs = a.split("=", 1)
        axes.append((k, vs.split(",")))
    if not axes:
        ap.error("need at least one -a axis")

    sweep_dir, grid = commands(args, axes)
    os.makedirs(sweep_dir, exist_ok=True)
    print(f"{len(grid)} grid points over "
          + " x ".join(f"{k}[{len(vs)}]" for k, vs in axes))

    summary_rows = []
    for tag, run_dir, combo, cmd in grid:
        print(">>", " ".join(cmd), flush=True)
        if args.dry_run:
            continue
        subprocess.run(cmd, check=True)
        with open(os.path.join(run_dir, "metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        final = rows[-1]
        final.update({k: v for (k, _), v in zip(axes, combo)})
        final["run_dir"] = run_dir
        summary_rows.append(final)

    if summary_rows:
        keys = list(summary_rows[-1].keys())
        with open(os.path.join(sweep_dir, "summary.csv"), "w",
                  newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys, extrasaction="ignore")
            w.writeheader()
            w.writerows(summary_rows)
        print(f"summary -> {sweep_dir}/summary.csv")
    return [cmd for _, _, _, cmd in grid], summary_rows


if __name__ == "__main__":
    main()
