"""Cross-hop request tracing: span context, X-MMLSpark-Trace, exporters.

One serving request crosses three thread/process boundaries (client ->
RoutingFront -> worker ingress -> batch pipeline -> reply), and before this
module nothing tied those hops together. The design mirrors the deadline
layer (core/faults.py ``X-MMLSpark-Deadline``): a tiny header carries the
context across existing HTTP hops, and every stage records spans against it.

  - ``SpanContext``: (trace_id, span_id, parent_id, sampled). The header
    format is ``<trace16hex>-<span16hex>-<01|00>`` (flags = sampled), parsed
    case-insensitively from any mapping like the deadline header.
  - ``Tracer``: owns the HEAD-BASED sampling decision (made once at ingress,
    carried in the header flag so downstream hops never re-roll), a bounded
    ring of finished spans, and the exporters — ``export_jsonl`` (one span
    per line) and ``export_perfetto`` (Chrome trace-event JSON, loadable in
    Perfetto/chrome://tracing). With a ``seed`` the sampling stream is
    deterministic, so chaos runs replay with identical trace sets.
  - ``span()`` wraps ``torch.profiler.record_function`` when the tracer
    asks for it (``annotate=True``), so the same stage boundaries land
    inside ``torch.profiler`` device traces.
  - Batch stages serve MANY requests at once: ``record_batch`` writes one
    span per SAMPLED context in the batch, so every traced request sees the
    drain/dispatch/readback stages it rode through. Head sampling keeps
    this multiplicative cost bounded.
  - ``batch_context``/``current_batch``: a contextvar carrying the current
    batch's (tracer, sampled contexts) into layers that can't thread them
    explicitly (parallel/ingest.timed_stage records H2D spans through it).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import random
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

__all__ = ["Span", "SpanContext", "TRACE_HEADER", "Tracer", "batch_context",
           "current_batch", "parse_trace_header"]

#: header carrying the trace context across hops (deadline-header pattern)
TRACE_HEADER = "X-MMLSpark-Trace"

_FLAG_SAMPLED = "01"
_FLAG_DROPPED = "00"


class SpanContext:
    """Identity of one span within one trace (immutable value object)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "sampled")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled

    def to_header(self) -> str:
        return f"{self.trace_id}-{self.span_id}-" \
               f"{_FLAG_SAMPLED if self.sampled else _FLAG_DROPPED}"

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return f"SpanContext({self.to_header()!r})"


def parse_trace_header(value: Optional[str]) -> Optional[SpanContext]:
    """``trace-span-flags`` -> SpanContext (None on malformed input: a bad
    header must never fail a request, it just starts a fresh trace)."""
    if not value:
        return None
    parts = str(value).strip().split("-")
    if len(parts) != 3:
        return None
    trace_id, span_id, flags = parts
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if not trace_id or not span_id:
        return None
    return SpanContext(trace_id.lower(), span_id.lower(),
                       sampled=flags == _FLAG_SAMPLED)


def context_from_headers(headers: Optional[Mapping[str, str]]
                         ) -> Optional[SpanContext]:
    """Case-insensitive ``X-MMLSpark-Trace`` lookup on any mapping
    (mirrors core.faults.deadline_from_headers)."""
    if not headers:
        return None
    get = getattr(headers, "get", None)
    if get is not None:
        v = get(TRACE_HEADER) or get(TRACE_HEADER.lower())
        if v is not None:
            return parse_trace_header(v)
    low = TRACE_HEADER.lower()
    for k in headers:
        if str(k).lower() == low:
            return parse_trace_header(headers[k])
    return None


class Span:
    """One finished span (epoch-second timestamps, duration in seconds)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "dur_s",
                 "attrs", "service")

    def __init__(self, name: str, ctx: SpanContext, t0: float, dur_s: float,
                 attrs: Optional[Dict[str, Any]] = None, service: str = ""):
        self.name = name
        self.trace_id = ctx.trace_id
        self.span_id = ctx.span_id
        self.parent_id = ctx.parent_id
        self.t0 = t0
        self.dur_s = dur_s
        self.attrs = attrs or {}
        self.service = service

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "t0": self.t0, "dur_s": self.dur_s, "service": self.service,
                "attrs": self.attrs}


class Tracer:
    """Span factory + bounded buffer + exporters for one service.

    ``sample_rate``: head-based sampling probability for traces ORIGINATING
    here (an incoming header's flag always wins — the ingress hop decided).
    ``seed``: deterministic sampling/id stream (chaos replay); None draws
    from the system RNG. ``cap`` bounds the in-memory span ring.
    ``annotate=True`` additionally wraps live ``span()`` blocks in
    ``torch.profiler.record_function``.
    """

    def __init__(self, sample_rate: float = 1.0, cap: int = 8192,
                 seed: Optional[int] = None, service: str = "mmlspark",
                 annotate: bool = False):
        self.sample_rate = float(sample_rate)
        self.service = service
        self.annotate = bool(annotate)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._spans: "deque[Span]" = deque(maxlen=cap)
        # lock-free child-id stream for batch spans: itertools.count is
        # atomic under the GIL, and the fixed-point multiply is a bijection
        # on 64 bits, so every draw is unique within this tracer without
        # touching the seeded RNG (whose lock the ingress path contends
        # on). The random base drawn ONCE at construction keeps ids from
        # different tracers writing into the same trace (front + worker
        # across the hop) from colliding at equal sequence numbers.
        self._seq = itertools.count(1)
        self._seq_base = self._rng.getrandbits(64)
        self.started = 0   # traces originated here
        self.joined = 0    # traces continued from an incoming header
        self.dropped = 0   # unsampled ingress decisions

    # -- context construction -------------------------------------------
    # (id generation inlines under an already-held lock where possible:
    # the serving hot path at sample_rate=1.0 crosses this lock ~10x per
    # request if every draw/push re-acquires, and on a contended host each
    # handoff can cost a scheduler trip — so ingress/record_batch do ONE
    # acquisition each)
    def _id_locked(self, bits: int = 64) -> str:
        return f"{self._rng.getrandbits(bits):0{bits // 4}x}"

    def _sample(self) -> bool:
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < self.sample_rate

    def ingress(self, headers: Optional[Mapping[str, str]] = None
                ) -> SpanContext:
        """Context for a request entering this service: continue the trace
        in the incoming header (its sampled flag is authoritative — the
        head decision), or originate a new one."""
        parent = context_from_headers(headers)
        if parent is not None:
            with self._lock:
                self.joined += 1
                span_id = self._id_locked()
            return SpanContext(parent.trace_id, span_id,
                               parent_id=parent.span_id,
                               sampled=parent.sampled)
        sampled = self._sample()
        with self._lock:
            if sampled:
                self.started += 1
            else:
                self.dropped += 1
            trace_id = self._id_locked(128)
            span_id = self._id_locked()
        return SpanContext(trace_id, span_id, sampled=sampled)

    def child(self, ctx: SpanContext) -> SpanContext:
        """New span context under ``ctx`` (same trace, parent = ctx)."""
        return SpanContext(ctx.trace_id, self._seq_id(),
                           parent_id=ctx.span_id, sampled=ctx.sampled)

    def _seq_id(self) -> str:
        """Unique 64-bit span id without taking the RNG lock: a
        Fibonacci-hashed counter (bijective on 64 bits — no collisions
        within a tracer) XOR a per-tracer random base (collision odds
        across tracers match the old fully-random ids)."""
        n = next(self._seq) * 0x9e3779b97f4a7c15 & (1 << 64) - 1
        return f"{n ^ self._seq_base:016x}"

    # -- recording -------------------------------------------------------
    # deque appends are atomic under the GIL, so the serving hot path
    # records spans LOCK-FREE — the batcher thread's 3 batch-stage records
    # per request no longer trade the tracer lock with the handler
    # thread's ingress/finish (each contended handoff is a potential
    # scheduler trip on a loaded host). Snapshot reads retry around a
    # concurrent append instead (spans()).
    def _push(self, span: Span) -> None:
        self._spans.append(span)

    def record(self, name: str, ctx: Optional[SpanContext], t0: float,
               dur_s: float, **attrs: Any) -> None:
        """Record a finished span with explicit epoch-second timestamps
        (batch stages measure once, then record per context)."""
        if ctx is None or not ctx.sampled:
            return
        self._push(Span(name, ctx, t0, dur_s, attrs or None, self.service))

    def record_batch(self, name: str, ctxs: Sequence[Optional[SpanContext]],
                     t0: float, dur_s: float, **attrs: Any) -> None:
        """One span per SAMPLED context — a batch-level stage (drain, H2D,
        dispatch, readback) seen from every traced request it carried. Each
        span gets its own span_id, parented to the request's ingress span."""
        a = attrs or None
        push = self._spans.append
        for ctx in ctxs:
            if ctx is None or not ctx.sampled:
                continue
            child = SpanContext(ctx.trace_id, self._seq_id(),
                                parent_id=ctx.span_id, sampled=True)
            push(Span(name, child, t0, dur_s, a, self.service))

    @contextlib.contextmanager
    def span(self, name: str, ctx: Optional[SpanContext],
             **attrs: Any) -> Iterator[Optional[SpanContext]]:
        """Live span: measures the enclosed block and records it as a CHILD
        of ``ctx`` (yields the child context, so nested hops can parent to
        it / put it on the wire). Unsampled contexts cost two branch
        checks and no clock reads."""
        if ctx is None or not ctx.sampled:
            yield ctx
            return
        child = self.child(ctx)
        cm = contextlib.nullcontext()
        if self.annotate:
            import torch

            cm = torch.profiler.record_function(name)
        t0 = time.time()
        p0 = time.perf_counter()
        try:
            with cm:
                yield child
        finally:
            self._push(Span(name, child, t0, time.perf_counter() - p0,
                            attrs or None, self.service))

    # -- introspection / export -----------------------------------------
    def spans(self, trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
        # recorders append lock-free; a snapshot that races one retries
        # (appends are sub-microsecond, so a second attempt always lands)
        for _ in range(64):
            try:
                snap = list(self._spans)
                break
            except RuntimeError:  # deque mutated during iteration
                continue
        else:  # pragma: no cover - 64 consecutive races
            snap = []
        out = [s.to_dict() for s in snap]
        if trace_id is not None:
            out = [s for s in out if s["trace_id"] == trace_id]
        return out

    def clear(self) -> None:
        self._spans.clear()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"sample_rate": self.sample_rate, "service": self.service,
                    "buffered": len(self._spans), "started": self.started,
                    "joined": self.joined, "dropped": self.dropped}

    def export_jsonl(self, path: str) -> int:
        """One JSON span per line; returns the number written."""
        spans = self.spans()
        with open(path, "w", encoding="utf-8") as fh:
            for s in spans:
                fh.write(json.dumps(s) + "\n")
        return len(spans)

    def export_perfetto(self, path: str) -> int:
        """Chrome trace-event JSON (complete 'X' events, microsecond
        timestamps) — drag into https://ui.perfetto.dev or
        chrome://tracing. Spans group by service (pid) and trace (tid)."""
        spans = self.spans()
        tids: Dict[str, int] = {}
        events = []
        for s in spans:
            tid = tids.setdefault(s["trace_id"], len(tids) + 1)
            events.append({
                "ph": "X", "name": s["name"], "cat": s["service"] or "span",
                "ts": s["t0"] * 1e6, "dur": max(s["dur_s"], 0.0) * 1e6,
                "pid": 1, "tid": tid,
                "args": {**(s["attrs"] or {}), "trace_id": s["trace_id"],
                         "span_id": s["span_id"],
                         "parent_id": s["parent_id"]}})
        doc = {"traceEvents": events,
               "metadata": {"service": self.service}}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
        return len(events)


# ---------------------------------------------------------------------------
# Current-batch propagation (implicit context for deep layers)
# ---------------------------------------------------------------------------

_BATCH: "contextvars.ContextVar[Optional[Tuple[Tracer, tuple]]]" = \
    contextvars.ContextVar("mmlspark_obs_batch", default=None)


@contextlib.contextmanager
def batch_context(tracer: Optional[Tracer],
                  ctxs: Sequence[Optional[SpanContext]]) -> Iterator[None]:
    """Bind (tracer, sampled contexts of the current batch) for the
    duration of a transform, so layers without an explicit tracer handle
    (TransferRing H2D staging, fused segment execution) can record spans.
    A no-op when the tracer is None or nothing in the batch is sampled."""
    live = tuple(c for c in ctxs if c is not None and c.sampled)
    if tracer is None or not live:
        yield
        return
    tok = _BATCH.set((tracer, live))
    try:
        yield
    finally:
        _BATCH.reset(tok)


def current_batch() -> Optional[Tuple[Tracer, tuple]]:
    """The innermost ``batch_context`` binding, or None."""
    return _BATCH.get()
