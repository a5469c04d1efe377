"""Share of the traced stretch's wall time in which no operation ran on
the device: 1 - busy / window (busy = the union of the device ops'
intervals)."""
from port_bench.readers import device_traced


def read(rec):
    if not device_traced(rec):
        return None
    s = rec["summary"]
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
