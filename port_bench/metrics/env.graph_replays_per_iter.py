"""Env steps replayed as one CUDA graph in one iteration: the
`env_graph_replays` counter of an iteration's record
(`wtw_tpu_torch.utils.spans`; 24 a rollout where the parkour env step runs
as a graph, 0 where it runs eagerly), median over the whole iterations of
the first half of the traced run's window. None for a program whose
records have no such counter."""
import statistics


def read(rec):
    try:
        from wtw_tpu_torch.utils import spans
    except ImportError:             # a program without spans
        return None
    k = rec["cell"]["check_iterations"]
    vals = [r["counters"]["env_graph_replays"] for r in spans.records()
            if k <= r["index"] < k + rec["whole_iterations"]
            and not r["profiled"] and "env_graph_replays" in r["counters"]]
    return float(statistics.median(vals)) if vals else None
