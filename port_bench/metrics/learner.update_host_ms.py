"""Host ms of the learner's update (GAE and every minibatch step) from
inside the program: the port's `learner.update` span in an iteration's
record (`wtw_tpu_torch.utils.spans`), median over the whole iterations of
the first half of the traced run's window, with no sync of the harness
before it (`learner.update_ms` times it from outside, after one)."""
import statistics


def read(rec):
    try:
        from wtw_tpu_torch.utils import spans
    except ImportError:             # a program without spans
        return None
    k = rec["cell"]["check_iterations"]
    vals = [r["spans"]["learner.update"]["ns"] for r in spans.records()
            if k <= r["index"] < k + rec["whole_iterations"]
            and not r["profiled"] and "learner.update" in r["spans"]]
    return statistics.median(vals) / 1e6 if vals else None
