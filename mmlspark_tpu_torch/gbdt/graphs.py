"""CUDA graph capture for the device-resident GBDT loops.

The fused tree grower and the whole-run scan engine launch thousands of
small kernels per tree at fixed shapes. ``Captured`` (core/graphs.py)
records one call of such a function in a ``torch.cuda.CUDAGraph`` (on the
calling thread's own capture stream, so fits on several threads capture
beside each other's launches) and replays it, with the kernels' launch counters counted through the replays
(``count_replays``); ``Replayer`` runs a grower step eagerly once, captures
it on the second call and replays it after. A row-sharded step on NCCL is
captured with its all-reduces: the eager call has formed the communicator,
and NCCL enqueues the collectives on the capturing stream's work. Gloo's
collectives go through host memory, so a sharded step on gloo stays eager.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..core.graphs import (COUNTERS, Captured, count_replays,  # noqa: F401
                           read_counters, set_counters)


class Replayer:
    """``fn(*inputs)`` on the card as the growers run a tree: the first call
    eagerly (it builds and warms every kernel), the second captures ``fn``
    in a CUDA graph (``Captured``) over static copies of its inputs, and
    every later call copies its inputs in and replays; one graph for each
    pattern of inputs that are None. Without ``capture`` (the CPU) every
    call runs eagerly. What a replay returns is the graph's own output:
    use it before the next call.

    ``agree`` (a sharded step, whose ranks replay their collectives in
    lockstep): called once after each capture with this rank's error (None:
    it captured), it raises on every rank when any rank's capture failed
    (``parallel.mesh.agree``). So no rank waits in a replayed collective
    for a partner that is not there; there is no eager fallback."""

    def __init__(self, fn: Callable, capture: bool,
                 agree: Optional[Callable[[Optional[BaseException]], None]]
                 = None):
        self.fn, self.capture, self.agree = fn, capture, agree
        self.calls = 0
        self.graphs: Dict[tuple, tuple] = {}

    def __call__(self, *inputs):
        self.calls += 1
        if not self.capture or self.calls == 1:
            return self.fn(*inputs)
        key = tuple(x is None for x in inputs)
        if key not in self.graphs:
            static = [x.clone() if x is not None else None for x in inputs]
            err = None
            try:
                graph = Captured(lambda: self.fn(*static))
            except Exception as e:  # noqa: BLE001 — agreed on, then raised
                err = e
            if self.agree is not None:
                self.agree(err)
            if err is not None:
                raise err
            self.graphs[key] = (static, graph)
        else:
            for dst, src in zip(self.graphs[key][0], inputs):
                if dst is not None:
                    dst.copy_(src)
        return self.graphs[key][1].replay()

    def release(self) -> None:
        """Free every graph this step captured (``Captured.release``); the
        next call runs eagerly again."""
        graphs, self.graphs, self.calls = self.graphs, {}, 0
        for _, graph in graphs.values():
            graph.release()

    @property
    def replays(self) -> int:
        """The replays of every graph this step captured."""
        return sum(g.replays for _, g in self.graphs.values())
