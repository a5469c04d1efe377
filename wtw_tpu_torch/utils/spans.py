"""Host spans and host-sync counters of the training path.

A span names a stretch of host time: `with span("env.step"):`, the
decorator `@spanned("physics.step")`, or `phase("env.reward")`, which
runs from its call to the next phase or to the end of the enclosing span
(the sections of a long function, without re-indenting them). Each
policy iteration keeps one record, opened where `learner.rollout` starts
(`spanned(..., opens_record=True)`), so a split rollout and update land in
the same record as a whole `train_iteration`. A record holds its index
since the process started (`reset` sets it back to 0), whether a profiler
was collecting when it opened, the span table (per name: calls,
inclusive ns, self ns without the child spans, and the host syncs and
their ns charged to the span while it was the innermost) and the
iteration's counters: `host_syncs` and `sync_wait_ns`, the calls of
`host_float`, `tensor` and `as_tensor` (each a host-device
synchronization on a CUDA device) and the host ns they blocked, and the
counts that `count` adds to: `env_graph_replays` (env steps replayed as a
CUDA graph) and `env_state_copy_ins` (world fields an env step copied into
its state arena; `envs/parkour_env.py`). The last `RING` records stay in
memory (`records()`); nothing is written to disk.

Three states:

- off (`enable(False)`): `span` returns one shared no-op and nothing is
  recorded;
- on (the default): host time from `time.perf_counter_ns`, a few us a
  span;
- on while a `torch.profiler` profile collects (the cheap flag
  `torch.autograd.profiler._is_profiler_enabled`): each span also opens a
  `record_function` range of its name, on the profiler's clock beside the
  device ops. A range costs ~10x a bare span, so no range is entered
  without a profiler.

Spans and counters are kept by the thread that trains (module state, no
lock).
"""
from __future__ import annotations

import collections
import functools
import time

import torch
import torch.autograd.profiler as _autograd_profiler

RING = 256                      # records kept

_enabled = True
_records: collections.deque = collections.deque(maxlen=RING)
_record = None                  # the open iteration's record
_index = 0                      # the next record's index
_stack = []                     # open spans, innermost last


def enable(on: bool = True):
    """Turn the recorder on (the default) or off."""
    global _enabled
    _enabled = bool(on)


def reset():
    """Forget every record and open span; the next record has index 0."""
    global _record, _index
    _records.clear()
    _stack.clear()
    _record, _index = None, 0


def records() -> list:
    """The last `RING` iteration records, oldest first."""
    return list(_records)


def _row(name: str) -> dict:
    return _record["spans"].setdefault(
        name, {"count": 0, "ns": 0, "self_ns": 0, "syncs": 0, "sync_ns": 0})


def _open_record():
    global _record, _index
    _record = {"index": _index,
               "profiled": bool(_autograd_profiler._is_profiler_enabled),
               "spans": {}, "counters": {"host_syncs": 0, "sync_wait_ns": 0,
                                         "env_graph_replays": 0,
                                         "env_state_copy_ins": 0}}
    _index += 1
    _records.append(_record)


class _Span:
    __slots__ = ("name", "is_phase", "t0", "inner_ns", "range")

    def __init__(self, name: str, is_phase: bool = False):
        self.name, self.is_phase = name, is_phase

    def __enter__(self):
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.inner_ns = 0
        _stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        # a phase still open inside this span ends with it
        while _stack and _stack[-1] is not self:
            _stack[-1].__exit__(None, None, None)
        ns = time.perf_counter_ns() - self.t0
        if _stack:
            _stack.pop()
        if _stack:
            _stack[-1].inner_ns += ns
        if _record is not None:
            row = _row(self.name)
            row["count"] += 1
            row["ns"] += ns
            row["self_ns"] += ns - self.inner_ns
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class _NoSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A context manager timing `name` (a no-op when the recorder is
    off)."""
    return _Span(name) if _enabled else _NO_SPAN


def spanned(name: str, opens_record: bool = False):
    """Decorator: the call runs inside `span(name)`; with `opens_record`
    each call first opens a new iteration record."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _enabled:
                return fn(*args, **kwargs)
            if opens_record:
                _open_record()
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def phase(name: str):
    """End the phase open in the innermost span, if any, and open `name` in
    its place, until the next `phase` or the end of that span."""
    if not _enabled:
        return
    if _stack and _stack[-1].is_phase:
        _stack[-1].__exit__(None, None, None)
    _Span(name, is_phase=True).__enter__()


def _count_sync(ns: int):
    if _record is None:
        return
    c = _record["counters"]
    c["host_syncs"] += 1
    c["sync_wait_ns"] += ns
    if _stack:
        row = _row(_stack[-1].name)
        row["syncs"] += 1
        row["sync_ns"] += ns


def count(name: str, n: int = 1):
    """Add `n` to the open record's counter `name` (one of `_open_record`'s
    counters)."""
    if _enabled and _record is not None:
        _record["counters"][name] += n


def host_float(t: torch.Tensor) -> float:
    """`float(t)`, counted as a host sync: on a CUDA device the host waits
    for every queued op and copies the value back."""
    if not _enabled:
        return float(t)
    t0 = time.perf_counter_ns()
    v = float(t)
    _count_sync(time.perf_counter_ns() - t0)
    return v


def tensor(data, device, dtype=None) -> torch.Tensor:
    """`torch.tensor(data, dtype=dtype, device=device)`, counted as a host
    sync: on a CUDA device the host data is copied over by a blocking
    copy, which waits for the stream."""
    if not _enabled:
        return torch.tensor(data, dtype=dtype, device=device)
    t0 = time.perf_counter_ns()
    out = torch.tensor(data, dtype=dtype, device=device)
    _count_sync(time.perf_counter_ns() - t0)
    return out


def as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """`torch.as_tensor(x, dtype=dtype, device=device)`; counted as a host
    sync where `x` is host data (not a tensor), which `tensor` copies."""
    if not _enabled or isinstance(x, torch.Tensor):
        return torch.as_tensor(x, dtype=dtype, device=device)
    t0 = time.perf_counter_ns()
    out = torch.as_tensor(x, dtype=dtype, device=device)
    _count_sync(time.perf_counter_ns() - t0)
    return out
