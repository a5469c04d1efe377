"""Host syncs in one iteration: the `host_syncs` counter of an
iteration's record (`wtw_tpu_torch.utils.spans`: each `float` of a device
value and each blocking host-to-device copy the program makes), median
over the whole iterations of the first half of the traced run's window."""
import statistics


def read(rec):
    try:
        from wtw_tpu_torch.utils import spans
    except ImportError:             # a program without spans
        return None
    k = rec["cell"]["check_iterations"]
    vals = [r["counters"]["host_syncs"] for r in spans.records()
            if k <= r["index"] < k + rec["whole_iterations"]
            and not r["profiled"]]
    return float(statistics.median(vals)) if vals else None
