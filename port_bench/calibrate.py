"""The readings that a cell's limits are set from: the compared numbers of
sound runs over many seeds, of the control (the program's products in
TF32) and of each planted fault, in one process a mode.

    python3 -m port_bench.calibrate --workload <cell> --mode program|tf32|<fault> \
        --seeds 11,12,13 [--seconds 1] [--follow]

Prints one JSON line a seed: {"seed", "mode", "correct", "checks",
"diag"}. `--follow` has the CaT learners' references follow the program's
parameters step by step (`diag.trail`: where they first part, and the
clipped branches that differ there). Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import time

from . import cells, faults
from . import run as R


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", default="program",
                    choices=("program", "tf32") + faults.FAULTS)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--follow", action="store_true")
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = R.run(cell, seed, args.seconds, False, device=args.device,
                    control="tf32" if args.mode == "tf32" else None,
                    fault=args.mode if args.mode in faults.FAULTS else None,
                    t_start=t, follow=args.follow)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "mode": args.mode,
            "correct": out["correct"],
            "checks": {k: v["value"] for k, v in out["checks"].items()},
            "diag": out["_notes"]["diag"],
            "seconds": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
