"""Device ms a traced iteration of the kernels launched inside the port's
`hf_corner_gather` profiler ranges (kernel B's heightfield corner rows)."""
from port_bench.readers import device_traced

RANGE = "hf_corner_gather"


def read(rec):
    if not device_traced(rec):
        return None
    us, calls = rec["summary"]["ranges"].get(RANGE, (0.0, 0))
    if not calls or us <= 0:
        return None
    return us / 1e3 / rec["summary"]["iterations"]
