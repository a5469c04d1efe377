"""Host ms of the physics entry in one iteration: the inclusive time of
the port's `physics.step` spans (`physics_step_batched`, 4 an env step) in
an iteration's record (`wtw_tpu_torch.utils.spans`), median over the whole
iterations of the first half of the traced run's window."""
import statistics


def read(rec):
    try:
        from wtw_tpu_torch.utils import spans
    except ImportError:             # a program without spans
        return None
    k = rec["cell"]["check_iterations"]
    vals = [r["spans"]["physics.step"]["ns"] for r in spans.records()
            if k <= r["index"] < k + rec["whole_iterations"]
            and not r["profiled"] and "physics.step" in r["spans"]]
    return statistics.median(vals) / 1e6 if vals else None
