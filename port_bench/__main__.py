"""Run one cell of the port's benchmark once (see run.py and README.md):

    python3 -m port_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Before torch loads, the process is pinned to one CPU (the second of the
allowed set where there are more; the first is left to the system) and
its thread pools sized to it. On the card's shared host, in turns over
20-s windows of go1_mob.fp32 (4 seeds a mode), free runs read 131-154 k
env steps/s and pinned runs 138.4-139.5 k; full 51-s sets of pinned runs
still spread by 5.6-18.7% (PERF.md §2), so pinning narrows the spread and
does not remove it."""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402


def pin() -> int:
    """Pin this process to one host CPU; -> the CPU."""
    avail = sorted(os.sched_getaffinity(0))
    cpu = avail[1] if len(avail) > 1 else avail[0]
    os.sched_setaffinity(0, [cpu])
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    return cpu


if __name__ == "__main__":
    pin()
    from .run import main
    sys.exit(main(t_start=T0))
