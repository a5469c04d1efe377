"""Device operations launched in one traced iteration (kernels, copies and
sets; user annotations left out)."""
from port_bench.readers import device_traced


def read(rec):
    if not device_traced(rec):
        return None
    s = rec["summary"]
    return sum(c for _, c in s["ops"].values()) / s["iterations"]
