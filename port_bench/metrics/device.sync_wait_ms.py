"""Host ms an iteration spends blocked in its host syncs: the
`sync_wait_ns` counter of an iteration's record
(`wtw_tpu_torch.utils.spans`), median over the whole iterations of the
first half of the traced run's window."""
import statistics


def read(rec):
    try:
        from wtw_tpu_torch.utils import spans
    except ImportError:             # a program without spans
        return None
    k = rec["cell"]["check_iterations"]
    vals = [r["counters"]["sync_wait_ns"] for r in spans.records()
            if k <= r["index"] < k + rec["whole_iterations"]
            and not r["profiled"]]
    return statistics.median(vals) / 1e6 if vals else None
