"""CUDA graph capture, and launch counters that count through replays.

The device-resident GBDT loops (gbdt/) and the fused executor's K-step mega
dispatch (core/fusion.py) record a fixed sequence of launches once in a
``torch.cuda.CUDAGraph`` and replay it. ``Captured`` records one call of a
function; the callers run the function once eagerly first (which builds and
loads the kernels and makes the first allocations), so the capture holds
launches only.

A kernel's Python launch counter counts in its wrapper, which runs once, at
capture, when nothing launches. Each kernel module that a captured program
may launch registers its counters here (``count_replays``), and its wrapper
counts through ``note_launch(module, name)``: under the lock, and during a
capture on the calling thread into that capture's own tally. ``Captured``
keeps that tally and adds it on every replay, so each counter counts the
launches that ran, and another thread's eager launches during a capture
are counted once, where they ran.
"""

from __future__ import annotations

import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch

#: (module name, counter name) of every registered launch counter
COUNTERS: List[Tuple[str, str]] = []

#: guards every counter update made here (replays, ``note_launch``)
_lock = threading.Lock()
#: held while a graph is captured, and by ``synchronize``: a device-wide
#: synchronize fails while any stream of the device captures, and two
#: threads must not capture at once (``torch.cuda.graph`` synchronizes the
#: device on entry)
CAPTURE_LOCK = threading.RLock()
#: per thread: the tally of the capture running on it (None outside one),
#: and the thread's capture stream (``capture_stream``)
_tls = threading.local()


def capture_stream(device=None) -> "torch.cuda.ExternalStream":
    """This thread's stream to capture graphs on: a stream of its own
    (``csrc/streams.cu``), made once per thread and device. Not
    ``torch.cuda.Stream()``: that hands out PyTorch's pooled streams round
    robin, so a capture could share its stream with another thread's
    launches and events, which invalidates the capture."""
    import ctypes

    from .. import _kernels

    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None or torch.device(device).index is None \
        else torch.device(device)
    streams = getattr(_tls, "streams", None)
    if streams is None:
        streams = _tls.streams = {}
    hit = streams.get(dev.index)
    if hit is None:
        fn = _kernels.lib("streams").mmlspark_stream_create
        fn.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
        fn.restype = ctypes.c_int
        out = ctypes.c_uint64(0)
        with torch.cuda.device(dev):
            _kernels.check(fn(ctypes.byref(out)), "stream create")
        hit = streams[dev.index] = torch.cuda.ExternalStream(out.value,
                                                             device=dev)
    return hit


def count_replays(module: str, *names: str) -> None:
    """Register the launch counters ``names`` of the module ``module`` (its
    ``__name__``) to be counted through graph replays; its wrappers count
    through ``note_launch``."""
    COUNTERS.extend((module, n) for n in names if (module, n) not in COUNTERS)


def read_counters() -> Dict[Tuple[str, str], int]:
    """The registered counters' values, by (module name, counter name)."""
    return {(m, a): getattr(sys.modules[m], a) for m, a in COUNTERS}


def set_counters(values: Dict[Tuple[str, str], int]) -> None:
    for (m, a), v in values.items():
        setattr(sys.modules[m], a, v)


def synchronize(device=None) -> None:
    """``torch.cuda.synchronize(device)``, never while another thread of
    this process captures a graph (it waits for the capture to end)."""
    with CAPTURE_LOCK:
        torch.cuda.synchronize(device)


def note_launch(module: str, name: str, n: int = 1) -> None:
    """Count ``n`` launches on the counter ``name`` of ``module``: on the
    counter itself, or, while the calling thread captures a graph, in that
    capture's tally (the launch runs at each replay, where ``Captured``
    counts it)."""
    tally = getattr(_tls, "tally", None)
    if tally is not None:
        tally[(module, name)] = tally.get((module, name), 0) + n
        return
    mod = sys.modules[module]
    with _lock:
        setattr(mod, name, getattr(mod, name) + n)


class Captured:
    """``fn()`` captured once in a CUDA graph (on construction, which runs
    nothing); ``replay()`` runs it on the current stream. ``out`` is what
    ``fn`` returned at capture: tensors that every replay rewrites in place.

    ``stream`` is the stream to capture on (default: this thread's
    ``capture_stream()``, after the current stream's queued work) and
    ``capture_error_mode`` is ``torch.cuda.graph``'s: with the default
    ``"thread_local"`` other threads keep launching, on their own streams,
    while this one captures. Captures are serialised (``CAPTURE_LOCK``).
    ``release()`` frees the graph and its memory pool."""

    def __init__(self, fn: Callable, stream=None,
                 capture_error_mode: str = "thread_local"):
        if stream is None:
            stream = capture_stream()
            stream.wait_stream(torch.cuda.current_stream())
        self.graph = torch.cuda.CUDAGraph()
        _tls.tally = tally = {}
        try:
            with CAPTURE_LOCK, torch.cuda.graph(
                    self.graph, stream=stream,
                    capture_error_mode=capture_error_mode):
                self.out = fn()
        finally:
            _tls.tally = None
        self.launches = tally
        self.replays = 0

    def replay(self):
        self.graph.replay()
        self.replays += 1
        with _lock:
            now = read_counters()
            set_counters({k: now[k] + d for k, d in self.launches.items()})
        return self.out

    def release(self) -> None:
        """Drop the graph and the tensors it owns (its memory pool returns
        to the allocator once nothing else holds them). The graph is
        destroyed under ``CAPTURE_LOCK``: destroying a graph while another
        thread captures, even in ``thread_local`` mode, fails with "not
        permitted when stream is capturing" and invalidates that capture."""
        graph: Optional[torch.cuda.CUDAGraph] = self.graph
        self.graph, self.out = None, None
        if graph is not None:
            with CAPTURE_LOCK:
                graph.reset()
                del graph
