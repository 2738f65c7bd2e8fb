"""CUDA graph capture for the device-resident GBDT loops.

The fused tree grower and the whole-run scan engine launch thousands of
small kernels per tree at fixed shapes. ``Captured`` records one call of
such a function in a ``torch.cuda.CUDAGraph`` and replays it; the callers
run the function once eagerly first (which builds and loads the kernels,
opts K1 into its shared memory and makes the first allocations), so the
capture holds launches only.

A kernel's Python launch counter counts in its wrapper, which runs once, at
capture, when nothing launches. Each kernel module that a captured loop
may launch registers its counters here (``count_replays``); ``Captured``
takes back what the capture counted on them and adds it again on every
replay, so each counter counts the launches that ran.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List, Tuple

import torch

#: (module name, counter name) of every registered launch counter
COUNTERS: List[Tuple[str, str]] = []


def count_replays(module: str, *names: str) -> None:
    """Register the launch counters ``names`` of the module ``module`` (its
    ``__name__``) to be counted through graph replays."""
    COUNTERS.extend((module, n) for n in names if (module, n) not in COUNTERS)


def read_counters() -> Dict[Tuple[str, str], int]:
    """The registered counters' values, by (module name, counter name)."""
    return {(m, a): getattr(sys.modules[m], a) for m, a in COUNTERS}


def set_counters(values: Dict[Tuple[str, str], int]) -> None:
    for (m, a), v in values.items():
        setattr(sys.modules[m], a, v)


class Captured:
    """``fn()`` captured once in a CUDA graph (on construction, which runs
    nothing); ``replay()`` runs it. ``out`` is what ``fn`` returned at
    capture: tensors that every replay rewrites in place."""

    def __init__(self, fn: Callable):
        before = read_counters()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn()
        after = read_counters()
        self.launches = {k: after[k] - v for k, v in before.items()
                         if after[k] != v}
        set_counters(before)              # the capture launched nothing
        self.replays = 0

    def replay(self):
        self.graph.replay()
        self.replays += 1
        now = read_counters()
        set_counters({k: now[k] + d for k, d in self.launches.items()})
        return self.out


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
