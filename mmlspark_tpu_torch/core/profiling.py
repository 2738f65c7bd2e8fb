"""Profiling: ``torch.profiler`` around the framework's idioms.

Counterpart of the reference's ``mmlspark_tpu/core/profiling.py``:

  - ``trace(log_dir)``: a context manager that profiles the enclosed block
    (host and, where there is one, CUDA device activity) and writes a
    Chrome/Perfetto trace into ``log_dir``; it yields the profiler, whose
    events ``device_busy`` reads;
  - ``annotate(name)``: a named span in the trace
    (``torch.profiler.record_function``);
  - ``profile_transform(stage, df, log_dir)``: ``stage.transform(df)``
    under a trace with a span per call, and its wall seconds;
  - ``device_memory_stats()``: each CUDA device's live and peak bytes
    (``torch.cuda.memory_stats``);
  - ``device_busy(prof)``: from a trace, the device's busy share of a
    window (the union of its kernel and copy intervals), the device
    operations that took most time, and the longest gaps in which the
    device ran nothing.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

log = logging.getLogger("mmlspark_tpu_torch.profiling")


def _activities(device_only: bool) -> list:
    from torch.profiler import ProfilerActivity

    acts = [] if device_only and torch.cuda.is_available() \
        else [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None,
          device_only: bool = False) -> Iterator[Any]:
    """Profile the enclosed block; yields the ``torch.profiler.profile``.
    With ``log_dir`` the trace is written there as ``trace.json``;
    ``device_only`` records the CUDA device's activity alone (a long run of
    host threads, such as a server's, makes a small trace that way)."""
    from torch.profiler import profile

    with profile(activities=_activities(device_only)) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named span in the trace's timeline."""
    with torch.profiler.record_function(name):
        yield


def profile_transform(stage, df, log_dir: Optional[str] = None,
                      iterations: int = 1) -> Dict[str, Any]:
    """Profile ``stage.transform(df)`` ``iterations`` times: wall seconds
    and a trace (written to ``log_dir`` when given). Returns
    {"elapsed_s", "per_call_s", "log_dir", "device": device_busy(...)}."""
    if iterations < 1:
        raise ValueError(f"iterations must be >= 1, got {iterations}")
    name = type(stage).__name__
    elapsed = 0.0
    with trace(log_dir) as prof:
        for i in range(iterations):
            with annotate(f"{name}.transform[{i}]"):
                t0 = time.perf_counter()
                stage.transform(df)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                elapsed += time.perf_counter() - t0
    return {"elapsed_s": elapsed, "per_call_s": elapsed / iterations,
            "log_dir": log_dir, "device": device_busy(prof)}


def device_memory_stats() -> List[Dict[str, Any]]:
    """Per CUDA device: bytes in use, peak and reserved (empty where there
    is no CUDA device)."""
    out: List[Dict[str, Any]] = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        st = torch.cuda.memory_stats(i)
        out.append({"device": f"cuda:{i}", "platform": "gpu",
                    "name": torch.cuda.get_device_name(i),
                    "stats": {"bytes_in_use": st.get(
                        "allocated_bytes.all.current", 0),
                        "peak_bytes_in_use": st.get(
                            "allocated_bytes.all.peak", 0),
                        "bytes_reserved": st.get(
                            "reserved_bytes.all.current", 0)}})
    return out


def _device_intervals(prof) -> List[tuple]:
    """(start_us, end_us, name) of every device-side event of a trace (the
    profiler's raw events: kernels, copies and sets)."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            out.append((ev.start_ns() / 1e3, ev.end_ns() / 1e3, ev.name()))
    return out


def device_busy(prof, window_us: Optional[tuple] = None, top: int = 15,
                gaps: int = 10) -> Dict[str, Any]:
    """The device's activity in a trace: busy and window milliseconds, the
    busy share (the union of device intervals over the window; the window
    defaults to the first device start to the last device end), the ``top``
    device operations by summed time (with calls) and the ``gaps`` longest
    idle gaps inside the window (start offset and length, ms). With no
    device events, every figure is None (a CPU-only trace)."""
    iv = sorted(_device_intervals(prof))
    if not iv:
        return {"device_events": 0, "busy_ms": None, "window_ms": None,
                "busy_share": None, "top": [], "longest_gaps_ms": []}
    lo, hi = window_us if window_us is not None else (iv[0][0],
                                                       max(e for _, e, _ in iv))
    busy, idle = 0.0, []
    cur_s = cur_e = None
    by_name: Dict[str, List[float]] = {}
    for s, e, name in iv:
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += e - s
        acc[1] += 1
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                idle.append((s - cur_e, cur_e))
            elif s > lo:
                idle.append((s - lo, lo))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if hi > cur_e:
            idle.append((hi - cur_e, cur_e))
    window = hi - lo
    idle.sort(reverse=True)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"device_events": len(iv), "busy_ms": busy / 1e3,
            "window_ms": window / 1e3,
            "busy_share": busy / window if window > 0 else None,
            "top": [{"name": k[:90], "device_ms": v[0] / 1e3, "calls": v[1]}
                    for k, v in ranked[:top]],
            "longest_gaps_ms": [{"at_ms": (at - lo) / 1e3, "ms": g / 1e3}
                                for g, at in idle[:gaps]]}
