"""Host ms of the rollout (every policy step: the policy's forward and the
env step), ending in a synchronize; median over the iterations of the
second half of the traced run's window (rollout and update apart)."""
import statistics

from port_bench.readers import device_traced


def read(rec):
    if not device_traced(rec) or not rec["rollout_s"]:
        return None
    return 1e3 * statistics.median(rec["rollout_s"])
