"""CUDA graph capture for the device-resident GBDT loops.

The fused tree grower and the whole-run scan engine launch thousands of
small kernels per tree at fixed shapes. ``Captured`` (core/graphs.py)
records one call of such a function in a ``torch.cuda.CUDAGraph`` and
replays it, with the kernels' launch counters counted through the replays
(``count_replays``); ``Replayer`` runs a grower step eagerly once, captures
it on the second call and replays it after.
"""

from __future__ import annotations

from typing import Callable, Dict

from ..core.graphs import (COUNTERS, Captured, count_replays,  # noqa: F401
                           read_counters, set_counters)


class Replayer:
    """``fn(*inputs)`` on the card as the growers run a tree: the first call
    eagerly (it builds and warms every kernel), the second captures ``fn``
    in a CUDA graph (``Captured``) over static copies of its inputs, and
    every later call copies its inputs in and replays; one graph for each
    pattern of inputs that are None. Without ``capture`` (the CPU) every
    call runs eagerly. What a replay returns is the graph's own output:
    use it before the next call."""

    def __init__(self, fn: Callable, capture: bool):
        self.fn, self.capture = fn, capture
        self.calls = 0
        self.graphs: Dict[tuple, tuple] = {}

    def __call__(self, *inputs):
        self.calls += 1
        if not self.capture or self.calls == 1:
            return self.fn(*inputs)
        key = tuple(x is None for x in inputs)
        if key not in self.graphs:
            static = [x.clone() if x is not None else None for x in inputs]
            self.graphs[key] = (static, Captured(lambda: self.fn(*static)))
        else:
            for dst, src in zip(self.graphs[key][0], inputs):
                if dst is not None:
                    dst.copy_(src)
        return self.graphs[key][1].replay()
