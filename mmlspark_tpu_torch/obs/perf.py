"""Performance attribution: roofline ceilings, device memory, SLOs.

Counterpart of the reference's ``mmlspark_tpu/obs/perf.py``:

  - ``device_peaks()`` supplies the roofline ceilings of the current card:
    a spec-sheet table keyed by ``torch.cuda.get_device_name``, overridable
    via ``MMLSPARK_PEAK_FLOPS``/``MMLSPARK_PEAK_GBPS``; unknown devices (CPU
    hosts) get a clearly-labeled nominal ceiling (``peak_source`` says which
    you got).
  - ``fold_device_memory()`` registers a scrape-time collector over
    ``torch.cuda.memory_stats(i)`` per card as
    ``mmlspark_device_memory_bytes{device, stat}``. A scrape never
    initialises CUDA: the collector reports nothing until the process has
    (``torch.cuda.is_initialized()``).
  - ``SLOConfig``/``SLOTracker``: a declarative latency objective (target
    percentile over multi-window burn rates) evaluated at scrape time --
    ``mmlspark_slo_burn_rate{window=}`` is the error-budget signal an
    autoscaler can key on instead of raw queue depth.

Not ported yet (ROADMAP A step 6, beside the Tuner): ``extract_cost``,
``attribute_segments`` and ``segment_families`` read XLA's compiled cost
analysis in the reference; the port has no cost source for its eager torch
programs yet, so it reports none rather than invent one.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .metrics import MetricFamily, MetricsRegistry

__all__ = ["SLOConfig", "SLOTracker", "device_memory_families",
           "device_peaks", "fold_device_memory", "make_slo"]


def _num_or_none(v: Any) -> Optional[float]:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if f == f else None  # NaN -> None


# ---------------------------------------------------------------------------
# Roofline ceilings
# ---------------------------------------------------------------------------

#: spec-sheet peaks keyed by ``torch.cuda.get_device_name`` prefix: NVIDIA's
#: H100 SXM data sheet, dense bf16 tensor-core flop/s and HBM3 bytes/s at
#: the full 700 W power limit
PEAKS = {
    "NVIDIA H100": {"flops": 989e12, "bytes_per_s": 3.35e12},
}

#: clearly-labeled stand-in for devices without a table entry (CPU
#: containers): ~one modern server core. The roofline RATIO on such hosts is
#: indicative, not absolute — the bottleneck label never depends on it.
NOMINAL_PEAKS = {"flops": 1e11, "bytes_per_s": 2e10}


def _device_kind() -> Optional[str]:
    """The first card's name, or None on a host without one."""
    import torch

    if not torch.cuda.is_available():
        return None
    try:
        return torch.cuda.get_device_name(0)
    except (RuntimeError, AssertionError):  # CUDA present, card unusable
        return None


def device_peaks(data_shards: int = 1) -> Dict[str, Any]:
    """Roofline ceilings for the current device: env override >
    chip-spec table > nominal stand-in. ``peak_source`` records which.

    ``data_shards`` > 1 aggregates over a mesh: a segment sharded N ways
    has N chips' worth of flops and bandwidth as its bound (the
    ``peak_source`` gains an ``xN`` suffix so a mesh-scaled bound is never
    mistaken for a single-chip one)."""
    env_f = _num_or_none(os.environ.get("MMLSPARK_PEAK_FLOPS"))
    env_b = _num_or_none(os.environ.get("MMLSPARK_PEAK_GBPS"))
    if env_f and env_b:
        out = {"flops": env_f, "bytes_per_s": env_b * 1e9,
               "peak_source": "env"}
        return _scale_peaks(out, data_shards)
    kind = _device_kind()
    if kind is not None:
        for prefix, peak in PEAKS.items():
            if str(kind).startswith(prefix):
                return _scale_peaks({**peak, "peak_source": "table",
                                     "device_kind": kind}, data_shards)
    return _scale_peaks({**NOMINAL_PEAKS, "peak_source": "nominal",
                         "device_kind": kind}, data_shards)


def _scale_peaks(peaks: Dict[str, Any], data_shards: int) -> Dict[str, Any]:
    n = max(1, int(data_shards or 1))
    if n == 1:
        return peaks
    return {**peaks, "flops": peaks["flops"] * n,
            "bytes_per_s": peaks["bytes_per_s"] * n,
            "peak_source": f"{peaks['peak_source']}x{n}",
            "data_shards": n}


# ---------------------------------------------------------------------------
# Device memory telemetry
# ---------------------------------------------------------------------------


def device_memory_families() -> List[MetricFamily]:
    """``torch.cuda.memory_stats(i)`` per card as one gauge family. Gated
    so that a scrape never initialises CUDA: before the process has
    (``torch.cuda.is_initialized()`` false, or no card at all) there are no
    families."""
    import torch

    if not torch.cuda.is_initialized():
        return []
    fam = MetricFamily(
        "mmlspark_device_memory_bytes", "gauge",
        "torch.cuda.memory_stats() snapshot per card (absent until the "
        "process has initialised CUDA)")
    for i in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(i)
        except RuntimeError:
            continue
        dev = f"cuda:{i}"
        for key, v in sorted(stats.items()):
            f = _num_or_none(v)
            if f is not None:
                fam.add(f, {"device": dev, "stat": str(key)})
    return [fam] if fam.samples else []


def fold_device_memory(registry: MetricsRegistry) -> None:
    """Register the scrape-time device-memory collector."""
    registry.register_collector(device_memory_families)


# ---------------------------------------------------------------------------
# SLO burn-rate tracking
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Declarative latency objective: ``target`` fraction of requests must
    complete within ``objective_ms``, evaluated over each window in
    ``windows_s``. Burn rate = (violating fraction) / (error budget): 1.0
    means the budget burns exactly as fast as it accrues; the standard
    multi-window alert pairs a short window (fast detection) with a long
    one (noise rejection)."""

    name: str = "latency"
    objective_ms: float = 250.0
    target: float = 0.99
    windows_s: Tuple[int, ...] = (60, 300, 3600)

    def __post_init__(self):
        if not 0.0 < self.target <= 1.0:
            raise ValueError(f"target must be in (0, 1], got {self.target}")
        if self.objective_ms <= 0:
            raise ValueError("objective_ms must be positive")
        ws = tuple(int(w) for w in self.windows_s)
        if not ws or any(w <= 0 for w in ws):
            raise ValueError(f"bad windows_s {self.windows_s!r}")
        object.__setattr__(self, "windows_s", ws)


class SLOTracker:
    """Per-second (total, breaches) buckets over the largest window,
    evaluated into burn rates at scrape time.

    ``record(latency_s)`` is the hot-path cost: one lock, one comparison,
    two integer increments. ``families()`` is a registry collector —
    register it with ``registry.register_collector(tracker.families)``.
    """

    def __init__(self, config: Optional[SLOConfig] = None,
                 clock=time.monotonic):
        self.config = config if config is not None else SLOConfig()
        self._clock = clock
        self._lock = threading.Lock()
        # (second, total, breaches) triples, oldest first; bounded by the
        # largest window (+ slack for the partially-filled current second)
        self._buckets: "deque[List[float]]" = deque(
            maxlen=max(self.config.windows_s) + 2)
        self.requests_total = 0
        self.breaches_total = 0

    def record(self, latency_s: float, breach: Optional[bool] = None) -> None:
        """Count one request; ``breach`` overrides the latency comparison
        (shed/timeout responses count against the budget regardless of how
        fast the rejection was)."""
        if breach is None:
            breach = latency_s * 1e3 > self.config.objective_ms
        sec = int(self._clock())
        with self._lock:
            if self._buckets and self._buckets[-1][0] == sec:
                b = self._buckets[-1]
            else:
                b = [sec, 0, 0]
                self._buckets.append(b)
            b[1] += 1
            b[2] += 1 if breach else 0
            self.requests_total += 1
            self.breaches_total += 1 if breach else 0

    def _window_counts(self, now: int) -> Dict[int, Tuple[int, int]]:
        out = {w: (0, 0) for w in self.config.windows_s}
        with self._lock:
            buckets = list(self._buckets)
        for sec, total, bad in buckets:
            age = now - sec
            for w in self.config.windows_s:
                if 0 <= age < w:
                    t, b = out[w]
                    out[w] = (t + total, b + bad)
        return out

    def arrival_buckets(self) -> Dict[str, Any]:
        """Snapshot of the per-second ``(second, total, breaches)`` triples
        plus this tracker's own clock reading — the fleet planner's
        arrival-rate source (serving/fleet/planner.py forecast_rps). The
        clock rides along because the buckets are stamped with THIS clock
        (monotonic by default), which need not agree with wall time."""
        with self._lock:
            buckets = [tuple(b) for b in self._buckets]
        return {"now": self._clock(), "buckets": buckets}

    def burn_rates(self) -> Dict[int, float]:
        """{window_s: burn rate}: violating fraction / error budget; 0.0
        with no traffic in the window (nothing burning)."""
        budget = max(1.0 - self.config.target, 1e-9)
        now = int(self._clock())
        return {w: (round(bad / total / budget, 6) if total else 0.0)
                for w, (total, bad) in self._window_counts(now).items()}

    def summary(self) -> Dict[str, Any]:
        now = int(self._clock())
        counts = self._window_counts(now)
        budget = max(1.0 - self.config.target, 1e-9)
        with self._lock:
            total, breaches = self.requests_total, self.breaches_total
        return {
            "name": self.config.name,
            "objective_ms": self.config.objective_ms,
            "target": self.config.target,
            "requests_total": total,
            "breaches_total": breaches,
            "windows": {str(w): {
                "requests": t, "breaches": b,
                "burn_rate": round(b / t / budget, 4) if t else 0.0}
                for w, (t, b) in counts.items()},
        }

    def families(self) -> List[MetricFamily]:
        s = self.summary()
        labels = {"slo": s["name"]}
        fams = [
            MetricFamily("mmlspark_slo_objective_ms", "gauge",
                         "latency objective").add(s["objective_ms"], labels),
            MetricFamily("mmlspark_slo_target", "gauge",
                         "target within-objective fraction").add(
                             s["target"], labels),
            MetricFamily("mmlspark_slo_requests_total", "counter",
                         "requests evaluated against the SLO").add(
                             s["requests_total"], labels),
            MetricFamily("mmlspark_slo_breaches_total", "counter",
                         "requests over the latency objective").add(
                             s["breaches_total"], labels),
        ]
        burn = MetricFamily(
            "mmlspark_slo_burn_rate", "gauge",
            "error-budget burn rate per window (1.0 = burning exactly at "
            "budget; the HPA signal)")
        win_req = MetricFamily("mmlspark_slo_window_requests", "gauge",
                               "requests inside each burn-rate window")
        for w, rec in s["windows"].items():
            burn.add(rec["burn_rate"], {**labels, "window": f"{w}s"})
            win_req.add(rec["requests"], {**labels, "window": f"{w}s"})
        fams.extend([burn, win_req])
        return fams


def make_slo(slo: Any) -> Optional[SLOTracker]:
    """Coerce a server's ``slo`` knob: None -> default SLOConfig, False ->
    disabled, an SLOConfig/dict -> configured tracker."""
    if slo is False:
        return None
    if slo is None or slo is True:
        return SLOTracker(SLOConfig())
    if isinstance(slo, SLOTracker):
        return slo
    if isinstance(slo, SLOConfig):
        return SLOTracker(slo)
    if isinstance(slo, dict):
        return SLOTracker(SLOConfig(**slo))
    raise ValueError(f"slo must be None/bool/SLOConfig/dict, got {slo!r}")
