"""Observability: metrics registry, Prometheus exposition, tracing, SLOs.

Counterpart of the reference's ``mmlspark_tpu.obs``:

  - ``obs.metrics``  -- MetricsRegistry (thread-safe counters/gauges/
    histograms with label sets) + the Prometheus text-format writer served
    at ``/_mmlspark/metrics`` on every ServingServer and RoutingFront.
  - ``obs.bridge``   -- scrape-time adapters folding the stats surfaces
    (IngestStats, LatencyStats, CompileCache, executor timelines, circuit
    breakers) into the registry, so ``/_mmlspark/stats`` and Prometheus
    report from one source of truth.
  - ``obs.trace``    -- span context propagated across HTTP hops via the
    ``X-MMLSpark-Trace`` header, with JSONL and Perfetto exporters and
    head-based sampling.
  - ``obs.perf``     -- roofline ceilings of the card, device memory
    telemetry, and SLO burn-rate tracking (``SLOConfig``/``SLOTracker``).
    The reference's per-segment XLA cost attribution waits for a cost
    source (ROADMAP A step 6).
"""

from .metrics import (COMPILE_BUCKETS, Counter, DEFAULT_BUCKETS, Gauge,
                      Histogram, MetricFamily, MetricsRegistry,
                      SERVING_LATENCY_BUCKETS, Sample, TrainRecorder,
                      default_registry, set_default_registry)
from .trace import (Span, SpanContext, TRACE_HEADER, Tracer, batch_context,
                    current_batch, parse_trace_header)
from .perf import SLOConfig, SLOTracker
from . import bridge
from . import perf

__all__ = ["COMPILE_BUCKETS", "Counter", "DEFAULT_BUCKETS", "Gauge",
           "Histogram", "MetricFamily", "MetricsRegistry",
           "SERVING_LATENCY_BUCKETS", "SLOConfig", "SLOTracker", "Sample",
           "Span", "SpanContext", "TRACE_HEADER", "Tracer", "TrainRecorder",
           "batch_context", "bridge", "current_batch", "default_registry",
           "parse_trace_header", "perf", "set_default_registry"]
