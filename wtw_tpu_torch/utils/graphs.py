"""CUDA-graph replay as a dispatcher op.

`torch.profiler` links a device kernel to the host op that launched it,
and a bare `CUDAGraph.replay()` is no op: its kernels appear in a trace,
by name, but are charged to no host op or range around the replay. Here
the replay runs inside the op `wtw_tpu_torch::graph_replay` (registered
at first use), so the ranges around a replay (`env.step`) hold its
kernels' device time as they hold an eager step's. The op costs a few us
of host time a call.
"""
from __future__ import annotations

from typing import Dict

import torch

_LIBRARY = None
_GRAPHS: Dict[int, torch.cuda.CUDAGraph] = {}   # the graphs being replayed


def _replay_impl(key: int) -> None:
    _GRAPHS[key].replay()


def replay(graph: "torch.cuda.CUDAGraph") -> None:
    """`graph.replay()` inside the op `wtw_tpu_torch::graph_replay`."""
    global _LIBRARY
    if _LIBRARY is None:
        lib = torch.library.Library("wtw_tpu_torch", "DEF")
        lib.define("graph_replay(int key) -> ()")
        lib.impl("graph_replay", _replay_impl, "CompositeExplicitAutograd")
        _LIBRARY = lib
    key = id(graph)
    _GRAPHS[key] = graph
    try:
        torch.ops.wtw_tpu_torch.graph_replay(key)
    finally:
        del _GRAPHS[key]
