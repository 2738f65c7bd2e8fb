"""Performance attribution: program costs, roofline, device memory, SLOs.

Counterpart of the reference's ``mmlspark_tpu/obs/perf.py``:

  - ``cost_tally(args)`` is the port's counterpart of XLA's
    ``cost_analysis()`` / ``memory_analysis()``. A fused program has no
    compiled executable to ask, so the tally watches its first, eager call:
    under a ``TorchDispatchMode`` every aten op adds its flops (the formulas
    of ``torch.utils.flop_counter``) and its input and output bytes
    (``bytes_accessed``, view ops excepted, as XLA counts them); the
    program's arguments and outputs give ``argument_bytes`` and
    ``output_bytes``; on the card, a rise of
    ``torch.cuda.max_memory_allocated`` over the call gives
    ``peak_memory_bytes`` (absent on the CPU, as the reference's is on a
    backend without ``memory_analysis``). The hand-written kernels are
    ctypes calls that dispatch never sees: their launchers add their own
    analytic flops and bytes (``note_kernel_cost``). ``extract_cost``
    reads a record (or the reference's duck-typed executable hooks); every
    missing field degrades to "no record", never to an exception.
  - ``attribute_segments()`` joins those per-(segment, shape-bucket) costs
    with the IngestStats decomposition into a per-segment roofline report
    (bound ms, measured ms, their ratio, the dominant bottleneck:
    ``queue``/``h2d``/``compute``/``dispatch``/``host``), and
    ``segment_families()`` renders it as ``mmlspark_segment_*`` gauges.

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

"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .metrics import MetricFamily, MetricsRegistry

__all__ = ["SLOConfig", "SLOTracker", "attribute_segments", "cost_tally",
           "device_memory_families", "device_peaks", "extract_cost",
           "fold_device_memory", "make_slo", "note_kernel_cost",
           "segment_families"]


def _num_or_none(v: Any) -> Optional[float]:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if f == f else None  # NaN -> None


def extract_cost(compiled: Any) -> Optional[Dict[str, float]]:
    """Harvest a program's cost numbers: ``{flops, bytes_accessed,
    peak_memory_bytes, output_bytes, argument_bytes}`` (whatever subset is
    there), or None when nothing is available.

    Reads a ``cost_record`` dict (what ``cost_tally`` measured for the
    port's programs) or, as the reference does, the duck-typed
    ``cost_analysis()`` / ``memory_analysis()`` hooks of an executable.
    Every access is gated: a hook may be absent, raise, or return None / a
    dict / a list of per-computation dicts — all of which degrade to "no
    data", never to an exception (the caller sits on the CompileCache miss
    path of a live server).
    """
    out: Dict[str, float] = {}
    rec = getattr(compiled, "cost_record", None)
    if isinstance(rec, dict):
        for key in _COST_KEYS:
            v = _num_or_none(rec.get(key))
            if v is not None:
                out[key] = v
        return out or None
    ca = getattr(compiled, "cost_analysis", None)
    if callable(ca):
        try:
            rep = ca()
        except Exception:  # noqa: BLE001 — backend without the hook
            rep = None
        if isinstance(rep, (list, tuple)):
            rep = rep[0] if rep else None
        if isinstance(rep, dict):
            flops = _num_or_none(rep.get("flops"))
            if flops is not None:
                out["flops"] = flops
            nbytes = _num_or_none(rep.get("bytes accessed"))
            if nbytes is not None:
                out["bytes_accessed"] = nbytes
    ma = getattr(compiled, "memory_analysis", None)
    if callable(ma):
        try:
            mem = ma()
        except Exception:  # noqa: BLE001
            mem = None
        if mem is not None:
            parts = {}
            for attr in ("temp_size_in_bytes", "argument_size_in_bytes",
                         "output_size_in_bytes"):
                v = _num_or_none(getattr(mem, attr, None))
                if v is not None:
                    parts[attr] = v
            if parts:
                out["peak_memory_bytes"] = sum(parts.values())
                if "output_size_in_bytes" in parts:
                    out["output_bytes"] = parts["output_size_in_bytes"]
                if "argument_size_in_bytes" in parts:
                    out["argument_bytes"] = parts["argument_size_in_bytes"]
    return out or None



#: the fields of a cost record, as the reference names them
_COST_KEYS = ("flops", "bytes_accessed", "peak_memory_bytes",
              "output_bytes", "argument_bytes")

#: per thread: the tally a program's first call runs under (None outside)
_tls = threading.local()


def note_kernel_cost(flops: float, nbytes: float) -> None:
    """Add a hand-written kernel's analytic flops and bytes to the tally
    active on this thread (no-op outside one): dispatch cannot see inside a
    ctypes launch."""
    tally = getattr(_tls, "tally", None)
    if tally is not None:
        tally["flops"] += float(flops)
        tally["bytes_accessed"] += float(nbytes)


def _tensors(item: Any) -> Iterator[Any]:
    import torch

    if isinstance(item, torch.Tensor):
        yield item
    elif isinstance(item, dict):
        for v in item.values():
            yield from _tensors(v)
    elif isinstance(item, (list, tuple)):
        for v in item:
            yield from _tensors(v)


def _nbytes(item: Any) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(item)))


def _bytes_mode(tally: Dict[str, float]):
    """A TorchDispatchMode adding every aten op's input and output bytes to
    ``tally["bytes_accessed"]``; view and alias ops move nothing and add
    nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Bytes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False) and \
                    func.overloadpacket.__name__ not in _NO_DATA_OPS:
                tally["bytes_accessed"] += (_nbytes(args)
                                            + _nbytes(kwargs or {})
                                            + _nbytes(out))
            return out

    return _Bytes()


#: aten ops that move no data although their schema is not a view
_NO_DATA_OPS = frozenset({"detach", "alias", "lift_fresh", "_unsafe_view",
                          "empty", "empty_like", "empty_strided",
                          "new_empty", "new_empty_strided", "set_",
                          "resize_", "record_stream", "_local_scalar_dense",
                          "sym_size", "sym_stride", "sym_numel"})


@contextlib.contextmanager
def cost_tally(args: Any = None) -> Iterator[Dict[str, float]]:
    """Tally the cost of the code run inside (one call of a program over
    ``args``); the yielded dict holds the record at exit: ``flops``,
    ``bytes_accessed``, ``argument_bytes``, and ``output_bytes`` once the
    caller sets ``record["_out"]`` to the call's outputs, plus
    ``peak_memory_bytes`` on the card when the call raised the allocator's
    peak. Tallies do not nest: an inner one is inert."""
    import torch

    record: Dict[str, Any] = {"flops": 0.0, "bytes_accessed": 0.0}
    if getattr(_tls, "tally", None) is not None:
        yield record
        return
    from ..core.graphs import synchronize

    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    dev = torch.cuda.current_device() if cuda else None
    if cuda:
        synchronize(dev)
        alloc0 = torch.cuda.memory_allocated(dev)
        peak0 = torch.cuda.max_memory_allocated(dev)
    flops = None
    with contextlib.ExitStack() as modes:
        try:   # a tally that cannot start records nothing, never raises
            from torch.utils.flop_counter import FlopCounterMode

            flops = modes.enter_context(FlopCounterMode(display=False))
            modes.enter_context(_bytes_mode(record))
        except Exception:  # noqa: BLE001 — no cost record, as the reference
            modes.close()
            flops = None
            record.pop("flops")
            record.pop("bytes_accessed")
        _tls.tally = record if flops is not None else None
        try:
            yield record
        finally:
            _tls.tally = None
    if flops is not None:
        record["flops"] += float(flops.get_total_flops())
    record["argument_bytes"] = _nbytes(args)
    out = record.pop("_out", None)
    if out is not None:
        record["output_bytes"] = _nbytes(out)
    if cuda:
        synchronize(dev)
        peak1 = torch.cuda.max_memory_allocated(dev)
        if peak1 > peak0:
            record["peak_memory_bytes"] = float(peak1 - alloc0)


@contextlib.contextmanager
def paused_tally() -> Iterator[None]:
    """Suspend the tally active on this thread (a graph capture and replay
    inside a tallied first call add nothing to it)."""
    from torch.utils._python_dispatch import _disable_current_modes

    tally = getattr(_tls, "tally", None)
    if tally is None:
        yield
        return
    _tls.tally = None
    try:
        with _disable_current_modes():
            yield
    finally:
        _tls.tally = tally


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
# Per-segment roofline attribution
# ---------------------------------------------------------------------------

#: IngestStats summary key -> bottleneck label. dispatch gets its own label
#: (the fixed Python submit cost K-step mega-dispatch amortizes — folding it
#: into "host" would hide that win); readback stays the host's share of the
#: batch loop (D2H fetch + finalize wait).
_BOTTLENECK_OF = (("queue_s", "queue"), ("h2d_s", "h2d"),
                  ("compute_s", "compute"), ("dispatch_s", "dispatch"),
                  ("readback_s", "host"))


def _mean_cost(shapes: Dict[str, Dict[str, Any]], key: str
               ) -> Optional[float]:
    vals = [v[key] for v in shapes.values() if _num_or_none(v.get(key))]
    return sum(vals) / len(vals) if vals else None


def attribute_segments(per_segment: Dict[str, Dict[str, Any]],
                       costs: Dict[str, Dict[str, Dict[str, Any]]],
                       peaks: Optional[Dict[str, Any]] = None,
                       sharding: Optional[Dict[str, Dict[str, Any]]] = None,
                       cost_model=None,
                       layout: Optional[Dict[str, str]] = None
                       ) -> Dict[str, Dict[str, Any]]:
    """Join per-segment ingest decompositions with per-(segment, shape)
    program costs (``cost_tally`` records) into the roofline report.

    ``per_segment``: {label: IngestStats.summary()} from the last transform.
    ``costs``: {label: {shape_key: cost record}} from CompileCache.costs().
    Returns {label: {flops_per_batch, bytes_per_batch, peak_memory_bytes,
    bound_ms_per_batch, measured_ms_per_batch, roofline_ratio, bottleneck,
    stage_share, peak_source}} — cost fields absent when the backend
    reported none (the report never fails for lack of them).

    ``sharding`` ({label: SegmentSharding.describe()}, core/fusion.py) marks
    segments executing sharded: their bound aggregates over the mesh
    (per-chip peak × shards), the record carries ``spec``/``shards``, and —
    when ``cost_model`` has calibrated collective probes — the measured
    per-batch collective time is attributed (``collective_ms_per_batch``).
    With ``sharding=None`` the report is byte-identical to the unsharded
    one.

    ``layout`` ({label: "csr"}, the tuned staging-layout knob) marks
    segments running CSR staging: the record carries ``layout``, and —
    when ``cost_model`` has a calibrated nnz term — the bandwidth side of
    the roofline bound uses the fitted nnz bytes (bytes ≈ f(nnz), not
    N·F: the whole point of staging sparse) as
    ``nnz_bytes_per_batch``. With ``layout=None`` the report is
    byte-identical to the dense one."""
    peaks = peaks if peaks is not None else device_peaks()
    sharding = sharding or {}
    layout = layout or {}
    out: Dict[str, Dict[str, Any]] = {}
    for label, s in per_segment.items():
        n = int(s.get("n_batches") or 0)
        if n <= 0:
            continue
        shard = sharding.get(label)
        seg_peaks = peaks
        if shard and int(shard.get("shards", 1) or 1) > 1:
            seg_peaks = _scale_peaks(peaks, int(shard["shards"]))
        rec: Dict[str, Any] = {"n_batches": n, "rows": s.get("rows"),
                               "peak_source": seg_peaks.get("peak_source")}
        if shard:
            rec["spec"] = shard.get("spec")
            rec["shards"] = int(shard.get("shards", 1) or 1)
        lay = layout.get(label)
        if lay:
            rec["layout"] = str(lay)
        # dominant bottleneck from the measured stage decomposition alone
        shares: Dict[str, float] = {}
        for key, bn in _BOTTLENECK_OF:
            v = _num_or_none(s.get(key))
            if v is not None:
                shares[bn] = shares.get(bn, 0.0) + v
        total_stage = sum(shares.values())
        if total_stage > 0:
            rec["bottleneck"] = max(shares, key=shares.get)
            rec["stage_share"] = {k: round(v / total_stage, 4)
                                  for k, v in shares.items()}
        wall = _num_or_none(s.get("wall_s"))
        if wall and wall > 0:
            rec["measured_ms_per_batch"] = round(wall / n * 1e3, 4)
        shapes = costs.get(label) or {}
        flops = _mean_cost(shapes, "flops")
        nbytes = _mean_cost(shapes, "bytes_accessed")
        peak_mem = max((v["peak_memory_bytes"] for v in shapes.values()
                        if _num_or_none(v.get("peak_memory_bytes"))),
                       default=None)
        if flops is not None:
            rec["flops_per_batch"] = round(flops, 1)
        if nbytes is not None:
            rec["bytes_per_batch"] = round(nbytes, 1)
        if peak_mem is not None:
            rec["peak_memory_bytes"] = round(peak_mem, 1)
        # a CSR-staged segment's bandwidth bound comes from the fitted
        # nnz bytes, not the dense-buffer tally: the staged payload IS
        # f(nnz), so pricing it as N·F would overstate the bound
        nnz_bytes = None
        if lay == "csr" and cost_model is not None:
            nnz_fn = getattr(cost_model, "nnz_bytes", None)
            rows = _num_or_none(s.get("rows"))
            if callable(nnz_fn) and rows:
                try:
                    nnz_bytes = _num_or_none(nnz_fn(label, rows / n))
                except Exception:  # noqa: BLE001 — estimate only
                    nnz_bytes = None
            if nnz_bytes is not None:
                rec["nnz_bytes_per_batch"] = round(nnz_bytes, 1)
        # roofline: bound time = max(compute-bound, bandwidth-bound) per
        # batch; ratio = bound / measured (1.0 = running at the bound)
        if (flops or nbytes or nnz_bytes) and wall and wall > 0:
            t_flops = (flops or 0.0) / seg_peaks["flops"]
            band_bytes = nnz_bytes if nnz_bytes is not None else nbytes
            t_mem = (band_bytes or 0.0) / seg_peaks["bytes_per_s"]
            bound_s = max(t_flops, t_mem)
            if bound_s > 0:
                rec["bound_ms_per_batch"] = round(bound_s * 1e3, 6)
                rec["roofline_ratio"] = round(bound_s / (wall / n), 6)
        # measured collective time one sharded batch pays (the fitted
        # α·bytes term over the harvested output payload)
        if shard and cost_model is not None:
            coll_fn = getattr(cost_model, "collective_ms", None)
            out_bytes = _mean_cost(shapes, "output_bytes")
            if callable(coll_fn) and out_bytes:
                ms = coll_fn(str(shard.get("collective", "all_gather")),
                             out_bytes)
                if ms is not None:
                    rec["collective_ms_per_batch"] = round(ms, 6)
        out[label] = rec
    return out


def segment_families(fusion: Dict[str, Any]) -> List[MetricFamily]:
    """Render a fusion_stats() payload (with ``segment_costs`` and
    ``roofline`` sections — core/fusion.py) as the
    ``mmlspark_segment_*`` gauge families."""
    fams: List[MetricFamily] = []
    costs = fusion.get("segment_costs") or {}
    per_metric = (("flops", "mmlspark_segment_cost_flops",
                   "tallied flops of one fused batch"),
                  ("bytes_accessed", "mmlspark_segment_cost_bytes",
                   "tallied bytes accessed by one fused batch"),
                  ("peak_memory_bytes",
                   "mmlspark_segment_cost_peak_memory_bytes",
                   "rise of the allocator's peak over the program's first "
                   "call"),
                  ("compile_s", "mmlspark_segment_compile_seconds",
                   "build seconds for this (segment, shape bucket)"))
    for key, name, help in per_metric:
        fam = MetricFamily(name, "gauge", help)
        for label, shapes in sorted(costs.items()):
            for shape, rec in sorted(shapes.items()):
                v = _num_or_none(rec.get(key))
                if v is not None:
                    fam.add(v, {"segment": label, "shape": shape})
        if fam.samples:
            fams.append(fam)
    roofline = fusion.get("roofline") or {}
    ratio = MetricFamily(
        "mmlspark_segment_roofline_ratio", "gauge",
        "cost-model bound time / measured wall per batch (1.0 = at the "
        "hardware bound)")
    bound = MetricFamily(
        "mmlspark_segment_bound_ms_per_batch", "gauge",
        "roofline bound time for one fused batch")
    measured = MetricFamily(
        "mmlspark_segment_measured_ms_per_batch", "gauge",
        "measured wall per fused batch (TransferRing)")
    bneck = MetricFamily(
        "mmlspark_segment_bottleneck", "gauge",
        "one-hot dominant bottleneck per segment "
        "(queue/h2d/compute/dispatch/host)")
    collective = MetricFamily(
        "mmlspark_segment_collective_ms_per_batch", "gauge",
        "fitted collective (all-reduce/all-gather) time one sharded batch "
        "pays, from measured mesh probes")
    for label, rec in sorted(roofline.items()):
        # sharded segments carry spec labels so a mesh-scaled bound/ratio
        # series never aliases the single-device one; unsharded samples
        # keep exactly the historical label set
        extra = {}
        if rec.get("spec"):
            extra = {"sharded": "1", "spec": str(rec["spec"])}
        if rec.get("layout"):
            # CSR-staged segments carry layout= so an nnz-bound series
            # never aliases the dense-bound one (same no-alias contract
            # as spec=); dense samples keep the historical label set
            extra = {**extra, "layout": str(rec["layout"])}
        for fam, key in ((ratio, "roofline_ratio"),
                         (bound, "bound_ms_per_batch"),
                         (measured, "measured_ms_per_batch")):
            v = _num_or_none(rec.get(key))
            if v is not None:
                fam.add(v, {"segment": label, **extra})
        v = _num_or_none(rec.get("collective_ms_per_batch"))
        if v is not None:
            fam_labels = {"segment": label, **extra}
            collective.add(v, fam_labels)
        dom = rec.get("bottleneck")
        if dom:
            for name in ("queue", "h2d", "compute", "dispatch", "host"):
                bneck.add(1.0 if name == dom else 0.0,
                          {"segment": label, "bottleneck": name, **extra})
    return fams + [f for f in (ratio, bound, measured, bneck, collective)
                   if f.samples]


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
