"""Host ms of the learner's update (GAE and every minibatch step), ending
in a synchronize; median over the iterations of the second half of the
traced run's window (rollout and update apart)."""
import statistics

from port_bench.readers import device_traced


def read(rec):
    if not device_traced(rec) or not rec["update_s"]:
        return None
    return 1e3 * statistics.median(rec["update_s"])
