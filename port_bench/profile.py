"""The traced stretch's device record, from `torch.profiler`'s events: the
device operations (kernels, copies and sets, without the device-side
mirrors of user annotations), the device's busy time as the union of
their intervals, and its idle gaps named by the innermost host op that ran
across each."""
from __future__ import annotations

import bisect

import torch

WINDOW = "port_bench.window"     # the host range around the traced stretch


def _is_device(e) -> bool:
    return e.device_type != torch.autograd.DeviceType.CPU


def device_ops(events):
    """Device-side events that are operations, not annotations."""
    return [e for e in events if _is_device(e)
            and not getattr(e, "is_user_annotation", False)
            and "#" not in e.name and e.name != WINDOW]


def _union(intervals):
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _innermost(spans, at):
    """Name of the latest-starting span (start, end, name), sorted by
    start, that holds the time `at`: the innermost of nested ones."""
    i = bisect.bisect_right(spans, (at, float("inf"), "")) - 1
    for j in range(i, max(i - 5000, -1), -1):
        if spans[j][1] >= at:
            return spans[j][2]
    return None


def summarize(events) -> dict:
    """-> {"window_s", "busy_s", "ops": {name: [us, count]}, "gaps":
    {host op: idle s}, "ranges": {range: [device us, calls]}}."""
    win = [e for e in events if e.name == WINDOW and not _is_device(e)]
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    ops = {}
    spans = []
    for e in device_ops(events):
        s, t = e.time_range.start, e.time_range.end
        o = ops.setdefault(e.name, [0.0, 0])
        o[0] += t - s
        o[1] += 1
        spans.append((max(s, w0), min(t, w1)))
    busy = [(s, t) for s, t in _union(spans) if t > s]
    edges = [w0] + [x for s, t in busy for x in (s, t)] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if not _is_device(e)
                   and e.name != WINDOW), key=lambda x: x[0])
    aten = [h for h in host if h[2].startswith("aten::")]
    named = {}
    for s, t in gaps:
        mid = 0.5 * (s + t)
        name = (_innermost(aten, mid) or _innermost(host, mid)
                or "(python between ops)")
        named[name] = named.get(name, 0.0) + (t - s) / 1e6
    ranges = {}
    for e in events:
        if not _is_device(e) and getattr(e, "is_user_annotation", False) \
                and e.name != WINDOW:
            r = ranges.setdefault(e.name, [0.0, 0])
            r[0] += float(getattr(e, "device_time_total", 0.0))
            r[1] += 1
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(t - s for s, t in busy) / 1e6,
            "ops": ops, "gaps": named, "ranges": ranges}


def breakdown(summary: dict) -> dict:
    """The ten device operations that took most time and the ten host ops
    the device sat idle across the longest, in seconds."""
    top = sorted(summary["ops"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:160], v[0] / 1e6] for k, v in top],
            "idle_gaps": [[k[:160], v] for k, v in gaps]}
