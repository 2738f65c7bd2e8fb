"""MetricsRegistry: thread-safe counters/gauges/histograms + Prometheus text.

Counterpart of the reference's ``mmlspark_tpu/obs/metrics.py``: the single
registry the port's stats surfaces (``IngestStats``, the server's latency
window, the compile-cache counters, the executor timelines) fold into
(``obs/bridge.py`` holds the adapters), exposed in the Prometheus text
format at ``/_mmlspark/metrics`` on every ServingServer and RoutingFront.

  - ``Counter`` / ``Gauge`` / ``Histogram`` instruments with label sets;
    every mutation is lock-protected, so serving threads record from the
    hot path without coordination. Histograms pin trace-id exemplars to
    the bucket an observation lands in.
  - ``MetricsRegistry.collect()`` also pulls from registered collector
    callbacks at scrape time: the existing stats objects stay the source of
    truth and are read lazily, so ``/_mmlspark/stats`` and
    ``/_mmlspark/metrics`` never disagree.
  - ``exposition()`` renders text format 0.0.4 (HELP/TYPE lines, label
    escaping, ``_bucket``/``_sum``/``_count`` histogram series), or
    OpenMetrics with exemplars. Given the same instruments and samples, the
    text is the reference's byte for byte.
  - ``TrainRecorder`` is the per-iteration series the GBDT boost loops emit
    into the process-wide ``default_registry()``.
"""

from __future__ import annotations

import math
import re
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["COMPILE_BUCKETS", "Counter", "DEFAULT_BUCKETS", "Gauge",
           "Histogram", "MetricFamily", "MetricsRegistry",
           "SERVING_LATENCY_BUCKETS", "Sample", "TrainRecorder",
           "default_registry", "set_default_registry"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default histogram buckets (seconds-oriented, like prometheus_client)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)

#: ms-scale buckets for serving latency histograms (sub-ms floor through
#: the slot timeout) — pass at registration; DEFAULT_BUCKETS is unchanged
SERVING_LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                           0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

#: seconds-scale buckets for program build / warmup timings
COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 60.0, 120.0, 300.0)


class Sample:
    """One exposition line: ``name{labels} value``; ``exemplar`` (set only
    on histogram ``_bucket`` samples that captured one) is rendered in
    OpenMetrics syntax when the writer is asked for it."""

    __slots__ = ("name", "labels", "value", "exemplar")

    def __init__(self, name: str, labels: Dict[str, str], value: float,
                 exemplar: Optional[Dict[str, Any]] = None):
        self.name = name
        self.labels = labels
        self.value = value
        self.exemplar = exemplar


class MetricFamily:
    """HELP/TYPE header + its samples (collector callbacks return these)."""

    __slots__ = ("name", "mtype", "help", "samples")

    def __init__(self, name: str, mtype: str, help: str = "",
                 samples: Optional[List[Sample]] = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        if mtype not in ("counter", "gauge", "histogram", "untyped"):
            raise ValueError(f"invalid metric type {mtype!r}")
        self.name = name
        self.mtype = mtype
        self.help = help
        self.samples = samples if samples is not None else []

    def add(self, value: float, labels: Optional[Dict[str, str]] = None,
            suffix: str = "",
            exemplar: Optional[Dict[str, Any]] = None) -> "MetricFamily":
        self.samples.append(Sample(self.name + suffix, dict(labels or {}),
                                   float(value), exemplar))
        return self


class _Instrument:
    """Shared label-set bookkeeping for Counter/Gauge/Histogram."""

    mtype = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def _label_dict(self, key: Tuple[str, ...]) -> Dict[str, str]:
        return dict(zip(self.labelnames, key))

    def labels(self, **labels: str) -> "_Bound":
        return _Bound(self, self._key(labels))

    def clear(self) -> None:
        with self._lock:
            self._values.clear()


class _Bound:
    """Instrument bound to one label-value tuple (``c.labels(x="y").inc()``)."""

    __slots__ = ("_inst", "_key")

    def __init__(self, inst: _Instrument, key: Tuple[str, ...]):
        self._inst = inst
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._inst._inc(self._key, amount)

    def set(self, value: float) -> None:
        self._inst._set(self._key, value)

    def observe(self, value: float,
                exemplar: Optional[Dict[str, str]] = None) -> None:
        self._inst._observe(self._key, value, exemplar)

    @property
    def value(self) -> float:
        return self._inst._get(self._key)


class Counter(_Instrument):
    """Monotonically-increasing count (requests, bytes, sheds)."""

    mtype = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._inc((), amount)

    @property
    def value(self) -> float:
        return self._get(())

    def _inc(self, key: Tuple[str, ...], amount: float) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def _get(self, key: Tuple[str, ...]) -> float:
        with self._lock:
            return float(self._values.get(key, 0.0))

    def collect(self) -> MetricFamily:
        fam = MetricFamily(self.name, self.mtype, self.help)
        with self._lock:
            for key, v in sorted(self._values.items()):
                fam.add(v, self._label_dict(key))
        return fam


class Gauge(Counter):
    """Point-in-time value (queue depth, loss, utilization)."""

    mtype = "gauge"

    def set(self, value: float) -> None:
        self._set((), value)

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._values[()] = self._values.get((), 0.0) - amount

    def _inc(self, key: Tuple[str, ...], amount: float) -> None:
        with self._lock:  # gauges may go down: no monotonic check
            self._values[key] = self._values.get(key, 0.0) + amount

    def _set(self, key: Tuple[str, ...], value: float) -> None:
        with self._lock:
            self._values[key] = float(value)


class Histogram(_Instrument):
    """Bucketed distribution (step times, latencies): per label set keeps
    per-bucket counts + sum + count, rendered as the cumulative
    ``_bucket{le=...}`` / ``_sum`` / ``_count`` series.

    Bucket boundaries are per-metric at registration (serving latency wants
    ms-scale — SERVING_LATENCY_BUCKETS; compile times want seconds-scale —
    COMPILE_BUCKETS); re-registering the same name with different buckets
    raises (one name, one meaning — MetricsRegistry enforces it).

    ``observe(value, exemplar={"trace_id": ...})`` pins the exemplar to the
    bucket the observation lands in (last-write-wins per bucket, with the
    observed value and a unix timestamp) — the metrics->traces link: a p99
    bucket carries the trace_id of a request that landed there."""

    mtype = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"{self.name}: need at least one bucket")
        self.buckets = tuple(bs)

    def observe(self, value: float,
                exemplar: Optional[Dict[str, str]] = None) -> None:
        self._observe((), value, exemplar)

    def _observe(self, key: Tuple[str, ...], value: float,
                 exemplar: Optional[Dict[str, str]] = None) -> None:
        v = float(value)
        with self._lock:
            state = self._values.get(key)
            if state is None:
                state = {"counts": [0] * len(self.buckets),
                         "sum": 0.0, "count": 0, "exemplars": {}}
                self._values[key] = state
            idx = len(self.buckets)  # +Inf overflow bucket
            for i, b in enumerate(self.buckets):
                if v <= b:
                    state["counts"][i] += 1
                    idx = i
                    break
            state["sum"] += v
            state["count"] += 1
            if exemplar:
                state["exemplars"][idx] = {
                    "labels": {str(k): str(lv) for k, lv in exemplar.items()},
                    "value": v, "ts": time.time()}

    def _get(self, key: Tuple[str, ...]) -> Dict[str, Any]:
        with self._lock:
            state = self._values.get(key)
            if state is None:
                return {"count": 0, "sum": 0.0}
            return {"count": state["count"], "sum": state["sum"]}

    def collect(self) -> MetricFamily:
        fam = MetricFamily(self.name, self.mtype, self.help)
        with self._lock:
            for key, state in sorted(self._values.items()):
                labels = self._label_dict(key)
                exemplars = state.get("exemplars", {})
                cum = 0
                for i, (b, c) in enumerate(zip(self.buckets,
                                               state["counts"])):
                    cum += c
                    fam.add(cum, {**labels, "le": _fmt_float(b)},
                            suffix="_bucket", exemplar=exemplars.get(i))
                fam.add(state["count"], {**labels, "le": "+Inf"},
                        suffix="_bucket",
                        exemplar=exemplars.get(len(self.buckets)))
                fam.add(state["sum"], labels, suffix="_sum")
                fam.add(state["count"], labels, suffix="_count")
        return fam

    def snapshot(self, **labels: str) -> Dict[str, Any]:
        """JSON-friendly view of one label set (default: the unlabeled
        series): cumulative buckets, sum/count, and the captured exemplars
        keyed by their bucket's ``le`` — the always-on exemplar surface in
        ``/_mmlspark/stats``."""
        key = self._key(labels) if labels or self.labelnames else ()
        with self._lock:
            state = self._values.get(key)
            if state is None:
                return {"count": 0, "sum": 0.0, "buckets": {},
                        "exemplars": {}}
            counts = list(state["counts"])
            out = {"count": state["count"], "sum": round(state["sum"], 6),
                   "exemplars": {}}
            for i, ex in state.get("exemplars", {}).items():
                le = _fmt_float(self.buckets[i]) \
                    if i < len(self.buckets) else "+Inf"
                out["exemplars"][le] = dict(ex["labels"],
                                            value=round(ex["value"], 6),
                                            ts=round(ex["ts"], 3))
        cum = 0
        buckets = {}
        for b, c in zip(self.buckets, counts):
            cum += c
            buckets[_fmt_float(b)] = cum
        buckets["+Inf"] = out["count"]
        out["buckets"] = buckets
        return out


def _fmt_float(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _escape_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _render_exemplar(ex: Dict[str, Any]) -> str:
    """OpenMetrics exemplar suffix: `` # {labels} value timestamp``."""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in (ex.get("labels") or {}).items())
    out = f" # {{{inner}}} {_fmt_float(ex['value'])}"
    if ex.get("ts") is not None:
        out += f" {_fmt_float(round(ex['ts'], 3))}"
    return out


def render_family(fam: MetricFamily, exemplars: bool = False) -> str:
    lines = []
    if fam.help:
        lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
    lines.append(f"# TYPE {fam.name} {fam.mtype}")
    for s in fam.samples:
        if s.labels:
            inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                             for k, v in s.labels.items())
            line = f"{s.name}{{{inner}}} {_fmt_float(s.value)}"
        else:
            line = f"{s.name} {_fmt_float(s.value)}"
        if exemplars and s.exemplar:
            line += _render_exemplar(s.exemplar)
        lines.append(line)
    return "\n".join(lines)


class MetricsRegistry:
    """Instrument factory + scrape-time collection.

    ``counter()``/``gauge()``/``histogram()`` are get-or-create: asking for
    an existing name returns the existing instrument (a type or label-set
    mismatch raises — one name, one meaning). ``register_collector`` adds a
    zero-arg callback returning MetricFamily objects, evaluated per scrape —
    the bridge adapters (obs/bridge.py) use this to read the live stats
    objects lazily instead of double-booking counts.
    """

    #: exposition Content-Type (Prometheus text format 0.0.4)
    CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
    #: Content-Type of the exemplar-carrying exposition (OpenMetrics-
    #: flavored: 0.0.4 lines + exemplar suffixes + the ``# EOF`` trailer)
    OPENMETRICS_CONTENT_TYPE = \
        "application/openmetrics-text; version=1.0.0; charset=utf-8"

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}
        self._collectors: List[Callable[[], Iterable[MetricFamily]]] = []

    # -- instrument factories -------------------------------------------
    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> Any:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if type(inst) is not cls or \
                        inst.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(inst).__name__}{inst.labelnames}")
                want = kw.get("buckets")
                if want is not None and \
                        tuple(sorted(float(b) for b in want)) != \
                        inst.buckets:
                    # bucket boundaries are part of the metric's meaning: a
                    # second registrant asking for different ones would
                    # silently get series it cannot interpret
                    raise ValueError(
                        f"metric {name!r} already registered with buckets "
                        f"{inst.buckets}")
                return inst
            inst = cls(name, help, labelnames, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        """``buckets`` default to ``DEFAULT_BUCKETS`` for a new histogram;
        asking for an existing one without ``buckets`` returns it whatever
        its buckets, asking with other ones raises."""
        with self._lock:
            known = name in self._instruments
        if buckets is None and not known:
            buckets = DEFAULT_BUCKETS
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    # -- collectors ------------------------------------------------------
    def register_collector(
            self, fn: Callable[[], Iterable[MetricFamily]]) -> None:
        with self._lock:
            self._collectors.append(fn)

    # -- scrape ----------------------------------------------------------
    def collect(self) -> List[MetricFamily]:
        with self._lock:
            instruments = list(self._instruments.values())
            collectors = list(self._collectors)
        fams = [inst.collect() for inst in instruments]
        for fn in collectors:
            try:
                fams.extend(fn())
            except Exception as e:  # noqa: BLE001 — one bad bridge
                # must not take the whole scrape down
                fams.append(MetricFamily(
                    "mmlspark_collector_errors", "untyped",
                    "a registered collector raised at scrape time").add(
                        1.0, {"error": type(e).__name__}))
        return sorted(fams, key=lambda f: f.name)

    def exposition(self, exemplars: bool = False) -> str:
        """The full scrape payload (text format 0.0.4, trailing newline).
        ``exemplars=True`` appends OpenMetrics exemplar suffixes to the
        histogram bucket samples that captured one, plus the ``# EOF``
        trailer (serve with OPENMETRICS_CONTENT_TYPE) — behind a flag
        because classic 0.0.4 parsers reject exemplar syntax."""
        body = "\n".join(render_family(f, exemplars=exemplars)
                         for f in self.collect()) + "\n"
        if exemplars:
            body += "# EOF\n"
        return body

    def sample_value(self, name: str,
                     labels: Optional[Dict[str, str]] = None
                     ) -> Optional[float]:
        """Scrape-equivalent point read (tests / bridge parity checks)."""
        labels = labels or {}
        for fam in self.collect():
            for s in fam.samples:
                if s.name == name and s.labels == labels:
                    return s.value
        return None


class TrainRecorder:
    """The standard training-instrument bundle (step time, examples/s,
    loss, checkpoint latency, eval metrics), shared by the GBDT boost
    loops and ``models.training.run_train_loop`` so every engine reports
    the same series with only the ``engine`` label differing."""

    #: buckets sized for training steps (ms to minutes)
    STEP_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                    30.0, 60.0, 300.0)

    def __init__(self, engine: str,
                 registry: Optional["MetricsRegistry"] = None):
        reg = registry if registry is not None else default_registry()
        self.engine = str(engine)
        self._steps = reg.counter(
            "mmlspark_train_steps_total",
            "training steps/iterations completed", ("engine",))
        self._step_time = reg.histogram(
            "mmlspark_train_step_seconds", "per-step wall time",
            ("engine",), buckets=self.STEP_BUCKETS)
        self._eps = reg.gauge(
            "mmlspark_train_examples_per_second",
            "training throughput of the last step", ("engine",))
        self._loss = reg.gauge(
            "mmlspark_train_loss", "last reported training loss",
            ("engine",))
        self._ckpt = reg.histogram(
            "mmlspark_train_checkpoint_seconds",
            "checkpoint save latency", ("engine",),
            buckets=self.STEP_BUCKETS)
        self._metric = reg.gauge(
            "mmlspark_train_metric", "last reported eval metric value",
            ("engine", "metric"))
        self._route = reg.counter(
            "mmlspark_train_routes_total",
            "fits by the route they took (native, scan, fused, host)",
            ("engine", "route"))

    def step(self, dur_s: float, examples: Optional[int] = None,
             loss: Optional[float] = None) -> None:
        self._steps.labels(engine=self.engine).inc()
        self._step_time.labels(engine=self.engine).observe(dur_s)
        if examples is not None and dur_s > 0:
            self._eps.labels(engine=self.engine).set(examples / dur_s)
        if loss is not None:
            try:
                self._loss.labels(engine=self.engine).set(float(loss))
            except (TypeError, ValueError):
                pass

    def route(self, name: str) -> None:
        """Record the route a fit took (the GBDT engines: native, scan,
        fused or host)."""
        self._route.labels(engine=self.engine, route=str(name)).inc()

    def checkpoint(self, dur_s: float) -> None:
        self._ckpt.labels(engine=self.engine).observe(dur_s)

    def metric(self, name: str, value: Any) -> None:
        try:
            self._metric.labels(engine=self.engine,
                                metric=str(name)).set(float(value))
        except (TypeError, ValueError):
            pass


_default_lock = threading.Lock()
_default: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """Process-wide registry for surfaces without an owner object
    (training loops, eval stages, the HTTP client)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default


def set_default_registry(reg: Optional[MetricsRegistry]
                         ) -> Optional[MetricsRegistry]:
    """Swap the process default (tests isolate with a fresh registry);
    returns the previous one. ``None`` resets to a lazily-created fresh
    registry."""
    global _default
    with _default_lock:
        prev = _default
        _default = reg
        return prev
