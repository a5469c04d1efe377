"""Network FLOPs of the whole iterations in the first half of the traced
run's window (`counts/flops_<algo>.py`, a lower bound: elementwise work
and physics left out) over the host seconds they took, as a share of the
H100's peak in the products' dtype (`peaks.py`). Those iterations run as
the timed path does, with no sync between rollout and update."""
from port_bench.peaks import FLOPS
from port_bench.readers import device_traced


def read(rec):
    if not device_traced(rec) or rec["whole_iterations"] < 1:
        return None
    peak = FLOPS[rec["cell"]["dtype"]]
    rate = rec["flops_per_iteration"] * rec["whole_iterations"] \
        / rec["whole_s"]
    return 100.0 * rate / peak
