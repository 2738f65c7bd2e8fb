"""Bridge adapters: fold the existing stats surfaces into a MetricsRegistry.

Counterpart of the reference's ``mmlspark_tpu/obs/bridge.py``. The port's
stats objects -- ``IngestStats`` (parallel/ingest.py), ``LatencyStats`` and
shed counters (serving/server.py), the CompileCache hit/miss counters
(core/device_stage.py via core/fusion.py), the PipelinedExecutor's busy and
overlap seconds (serving/executor.py), the supervision layer, and the
RoutingFront's circuit breakers -- are read by scrape-time COLLECTORS and
rendered as Prometheus families, so the JSON ``/_mmlspark/stats`` payload
and the ``/_mmlspark/metrics`` exposition report from one source of truth.

Every series is prefixed ``mmlspark_``, seconds are
``_seconds``/``_seconds_total``, monotonic counts are ``_total``, and
enum-ish states are one-hot gauges (``state`` label). The serving Tuner's
state is the ``mmlspark_tuner_*`` families (core/tune.py ``Tuner.stats``),
and the fused segments' tallied costs and roofline attribution the
``mmlspark_segment_*`` ones (obs/perf.py ``segment_families``). The fleet,
lifecycle, model-mall and fabric families wait for their planes (ROADMAP A
step 10).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from .metrics import MetricFamily, MetricsRegistry

__all__ = ["fold_front", "fold_server", "fold_tracer"]


def _num(v: Any) -> Optional[float]:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f


# ---------------------------------------------------------------------------
# ServingServer
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# ServingServer
# ---------------------------------------------------------------------------


def _latency_families(summary: Dict[str, Any]) -> Iterable[MetricFamily]:
    served = MetricFamily(
        "mmlspark_latency_window_requests", "gauge",
        "requests in the rolling latency window")
    served.add(summary.get("n", 0))
    yield served
    lat = MetricFamily(
        "mmlspark_request_latency_ms", "gauge",
        "rolling-window request latency decomposition "
        "(component x p50/p95/mean)")
    for component in ("queue", "compute", "overhead", "total"):
        block = summary.get(f"{component}_ms") or {}
        for stat, v in block.items():
            f = _num(v)
            if f is not None:
                lat.add(f, {"component": component, "stat": stat})
    yield lat
    mb = _num(summary.get("mean_batch"))
    if mb is not None:
        fam = MetricFamily("mmlspark_mean_batch_rows", "gauge",
                           "mean drained batch size (rolling window)")
        fam.add(mb)
        yield fam
    shed = (summary.get("shed") or {})
    sheds = MetricFamily(
        "mmlspark_sheds_total", "counter",
        "load-shed responses by HTTP status and reason")
    for status, n in (shed.get("by_status") or {}).items():
        sheds.add(n, {"kind": "status", "value": str(status)})
    for reason, n in (shed.get("by_reason") or {}).items():
        sheds.add(n, {"kind": "reason", "value": str(reason)})
    for tenant, n in (shed.get("by_tenant") or {}).items():
        sheds.add(n, {"kind": "tenant", "value": str(tenant)})
    yield sheds


def _ingest_families(summary: Dict[str, Any]) -> Iterable[MetricFamily]:
    stage = MetricFamily(
        "mmlspark_ingest_stage_seconds_total", "counter",
        "cumulative device-ingest decomposition (TransferRing stages)")
    for name in ("queue_s", "h2d_s", "dispatch_s", "compute_s",
                 "readback_s"):
        f = _num(summary.get(name))
        if f is not None:
            stage.add(f, {"stage": name[:-2]})
    yield stage
    scalars = (("mmlspark_ingest_batches_total", "counter", "n_batches",
                "batches through the transfer ring"),
               ("mmlspark_ingest_rows_total", "counter", "rows",
                "rows through the transfer ring"),
               ("mmlspark_ingest_bytes_total", "counter", "bytes",
                "wire bytes shipped host->device"),
               ("mmlspark_ingest_overlap_ratio", "gauge", "overlap_ratio",
                "ring wall / serial stage time (<1 = overlapped)"),
               ("mmlspark_ingest_h2d_gbps", "gauge", "h2d_gbps",
                "host->device transfer bandwidth"),
               ("mmlspark_transfer_ring_depth", "gauge", "ring_depth",
                "configured in-flight slot depth of the transfer ring"),
               ("mmlspark_ingest_deposits_total", "counter",
                "slot_deposits",
                "batches deposited in place into pre-staged H2D slots"),
               ("mmlspark_ingest_copies_total", "counter",
                "fallback_copies",
                "batches that fell back to the allocating copy path"),
               ("mmlspark_ingest_zero_copy_batches_total", "counter",
                "zero_copy_batches",
                "batches assembled as strided views (no host copy)"),
               ("mmlspark_ingest_copied_batches_total", "counter",
                "copied_batches",
                "batches assembled via a host copy (stack or slot fill)"),
               ("mmlspark_ingest_slot_fill_seconds_total", "counter",
                "slot_fill_s", "time spent filling staging slots"),
               ("mmlspark_ingest_slot_transfer_seconds_total", "counter",
                "slot_transfer_s",
                "H2D transfer time out of staging slots"),
               ("mmlspark_ingest_slot_overlap_ratio", "gauge",
                "slot_overlap_ratio",
                "fraction of slot H2D time overlapped with the next "
                "slot's fill (double-buffered staging)"),
               ("mmlspark_ingest_densified_bytes_total", "counter",
                "densified_bytes",
                "dense bytes materialized densifying sparse columns"),
               ("mmlspark_ingest_densify_ratio", "gauge",
                "densify_ratio",
                "densified bytes per CSR byte the same rows hold "
                "(layout-knob headroom; absent with no sparse data)"),
               ("mmlspark_ingest_csr_batches_total", "counter",
                "csr_batches",
                "batches staged as CSR triples without densifying"),
               ("mmlspark_ingest_csr_bytes_total", "counter",
                "csr_nnz_bytes",
                "CSR triple bytes staged host->device"))
    for mname, mtype, key, help in scalars:
        f = _num(summary.get(key))
        if f is not None:
            yield MetricFamily(mname, mtype, help).add(f)
    occ = MetricFamily(
        "mmlspark_transfer_ring_occupancy", "gauge",
        "observed dispatched-but-undrained steps in the ring "
        "(mean/max per dispatch; max == depth means the ring saturated)")
    for stat, key in (("mean", "ring_occupancy_mean"),
                      ("max", "ring_occupancy_max")):
        f = _num(summary.get(key))
        if f is not None:
            occ.add(f, {"stat": stat})
    if occ.samples:
        yield occ
    # per-bucket pad-waste (the measured term of the auto-tuner's bucket
    # chooser): fraction of each static bucket's rows that were padding
    padding = summary.get("padding") or {}
    ratio = MetricFamily(
        "mmlspark_batch_pad_ratio", "gauge",
        "pad rows / bucket rows per static shape bucket (0 = no waste)")
    padded = MetricFamily(
        "mmlspark_batch_pad_rows_total", "counter",
        "padded (static) rows shipped per shape bucket")
    for bucket, rec in padding.items():
        f = _num(rec.get("pad_ratio"))
        if f is not None:
            ratio.add(f, {"bucket": str(bucket)})
        f = _num(rec.get("padded"))
        if f is not None:
            padded.add(f, {"bucket": str(bucket)})
    if ratio.samples:
        yield ratio
    if padded.samples:
        yield padded


def _fusion_families(stats: Dict[str, Any]) -> Iterable[MetricFamily]:
    cache = stats.get("compile_cache") or {}
    for key, mtype, help in (
            ("hits", "counter", "fused-executable cache hits"),
            ("misses", "counter", "fused-executable cache misses"),
            ("entries", "gauge", "live fused executables"),
            ("compile_s", "counter", "seconds spent compiling fused "
                                     "executables")):
        f = _num(cache.get(key))
        if f is not None:
            yield MetricFamily(f"mmlspark_compile_cache_{key}"
                               + ("_total" if mtype == "counter" else ""),
                               mtype, help).add(f)
    rate = _num(cache.get("hit_rate"))
    if rate is not None:
        yield MetricFamily("mmlspark_compile_cache_hit_rate", "gauge",
                           "hits / (hits + misses)").add(rate)
    ev = _num(cache.get("evictions"))
    if ev is not None:
        yield MetricFamily(
            "mmlspark_segment_cache_evictions_total", "counter",
            "fused executables dropped by the CompileCache's LRU bound"
        ).add(ev)
    cap = _num(cache.get("capacity"))
    if cap is not None:
        yield MetricFamily(
            "mmlspark_segment_cache_capacity", "gauge",
            "configured CompileCache entry cap").add(cap)
    nseg = _num(stats.get("n_fused_segments"))
    if nseg is not None:
        yield MetricFamily("mmlspark_fused_segments", "gauge",
                           "device-fused segments in the active plan"
                           ).add(nseg)
    fallbacks = stats.get("fallbacks")
    if fallbacks is not None:
        yield MetricFamily("mmlspark_fusion_fallbacks", "gauge",
                           "partitions that fell back to the host path "
                           "on the last transform").add(len(fallbacks))
    # cross-segment stitches in force (core/fusion.py plan()): one sample
    # per merged segment, valued at the number of transpiled shims it
    # carries. The stats key — and hence this family — is absent while no
    # stitch is active, keeping the default exposition byte-identical.
    stitched = stats.get("stitched")
    if stitched:
        fam = MetricFamily(
            "mmlspark_segment_stitched", "gauge",
            "transpiled host shims stitched through per fused segment")
        for seg, names in stitched.items():
            fam.add(float(len(names or ())), {"segment": str(seg)})
        yield fam
    # the pipelined stream (core/fusion.py fusion_stats()["pipeline"], fed
    # by parallel/pipeplan.py PipeRunner): the stats key, and so every
    # family below, exists only while a pipe plan is active
    pipe = stats.get("pipeline")
    if pipe:
        f = _num(pipe.get("depth"))
        if f is not None:
            yield MetricFamily(
                "mmlspark_pipe_depth", "gauge",
                "active pipeline-parallel stage count").add(f)
        f = _num(pipe.get("bubble_ratio"))
        if f is not None:
            yield MetricFamily(
                "mmlspark_pipe_bubble_ratio", "gauge",
                "pipeline fill/drain idle fraction, (S-1)/(M+S-1) over "
                "the last stream").add(f)
        busy = MetricFamily(
            "mmlspark_pipe_stage_busy_ratio", "gauge",
            "per-stage busy seconds / stream wall")
        hand = MetricFamily(
            "mmlspark_pipe_handoff_bytes_total", "counter",
            "inter-stage rank-to-rank bytes moved, by receiving stage")
        reqs = MetricFamily(
            "mmlspark_pipe_stage_requeues_total", "counter",
            "micro-batch streams requeued after this stage wedged "
            "(each one re-planned at depth N-1)")
        for st in (pipe.get("stages") or []):
            labels = {"stage": str(st.get("index"))}
            for fam, key in ((busy, "busy_ratio"),
                             (hand, "handoff_bytes"),
                             (reqs, "requeues")):
                f = _num(st.get(key))
                if f is not None:
                    fam.add(f, labels)
        for fam in (busy, hand, reqs):
            if fam.samples:
                yield fam
    # per-(segment, shape-bucket) tallied costs + roofline attribution
    # (obs/perf.py; families absent when no cost was recorded)
    from .perf import segment_families

    for fam in segment_families(stats):
        yield fam


def _executor_families(stats: Dict[str, Any]) -> Iterable[MetricFamily]:
    busy = MetricFamily("mmlspark_executor_busy_seconds_total", "counter",
                        "pipelined-executor stage busy time")
    for stage, v in (stats.get("busy_s") or {}).items():
        f = _num(v)
        if f is not None:
            busy.add(f, {"stage": stage})
    yield busy
    for key, mtype, help in (
            ("epochs", "counter", "batches through the pipelined executor"),
            ("inflight", "gauge", "configured in-flight slot depth"),
            ("inflight_active", "gauge",
             "batches currently in flight (== inflight means saturated)"),
            ("overlap_ratio", "gauge",
             "stage-busy seconds / pipeline-active wall (>1 = overlapped)"),
            ("active_wall_s", "counter",
             "wall seconds with >=1 batch in flight")):
        f = _num(stats.get(key))
        if f is not None:
            name = f"mmlspark_executor_{key}"
            if mtype == "counter" and not name.endswith("_total") \
                    and not name.endswith("_s"):
                name += "_total"
            yield MetricFamily(name, mtype, help).add(f)
    reps = MetricFamily("mmlspark_replica_busy_seconds_total", "counter",
                        "per-replica transform busy time")
    util = MetricFamily("mmlspark_replica_utilization", "gauge",
                        "per-replica busy / pipeline-active wall")
    rows = MetricFamily("mmlspark_replica_rows_total", "counter",
                        "rows computed per replica")
    for r in (stats.get("replicas") or []):
        labels = {"replica": str(r.get("replica"))}
        for fam, key in ((reps, "busy_s"), (util, "utilization"),
                         (rows, "rows")):
            f = _num(r.get(key))
            if f is not None:
                fam.add(f, labels)
    yield reps
    yield util
    yield rows
    sup = stats.get("supervisor")
    if sup:
        for fam in _supervisor_families(sup):
            yield fam
    wd = stats.get("watchdog")
    if wd:
        for fam in _watchdog_families(wd):
            yield fam


def _supervisor_families(sup: Dict[str, Any]) -> Iterable[MetricFamily]:
    """Replica supervision (serving/supervisor.py): one-hot health states,
    decayed health scores, and the eject/readmit lifecycle counters
    (mmlspark_replica_* families)."""
    state = MetricFamily(
        "mmlspark_replica_state", "gauge",
        "one-hot replica health state (healthy/quarantined/probing)")
    score = MetricFamily("mmlspark_replica_health_score", "gauge",
                         "decayed per-replica health score in [0, 1]")
    timeouts = MetricFamily("mmlspark_replica_timeouts_total", "counter",
                            "wedged dispatches (watchdog expiries) "
                            "per replica")
    errors = MetricFamily("mmlspark_replica_errors_total", "counter",
                          "failed dispatches per replica")
    outliers = MetricFamily("mmlspark_replica_outliers_total", "counter",
                            "latency-outlier completions per replica")
    ejections = MetricFamily("mmlspark_replica_ejections_total", "counter",
                             "quarantine transitions per replica")
    readmits = MetricFamily("mmlspark_replica_readmissions_total", "counter",
                            "probe-success re-admissions per replica")
    for r in (sup.get("replicas") or []):
        labels = {"replica": str(r.get("replica"))}
        for name in ("healthy", "quarantined", "probing"):
            state.add(1.0 if r.get("state") == name else 0.0,
                      {**labels, "state": name})
        for fam, key in ((score, "score"), (timeouts, "timeouts"),
                         (errors, "errors"), (outliers, "outliers"),
                         (ejections, "ejections"),
                         (readmits, "readmissions")):
            f = _num(r.get(key))
            if f is not None:
                fam.add(f, labels)
    yield state
    yield score
    yield timeouts
    yield errors
    yield outliers
    yield ejections
    yield readmits


def _watchdog_families(wd: Dict[str, Any]) -> Iterable[MetricFamily]:
    trips = MetricFamily(
        "mmlspark_watchdog_trips_total", "counter",
        "hung-dispatch watchdog expiries by action "
        "(requeue = re-dispatched, extend = budget doubled in place, "
        "abandon = accounted 504)")
    for key in ("requeues", "abandons"):
        f = _num(wd.get(key))
        if f is not None:
            trips.add(f, {"action": key[:-1]})
    total = _num(wd.get("trips"))
    if total is not None:
        rq = _num(wd.get("requeues")) or 0.0
        ab = _num(wd.get("abandons")) or 0.0
        trips.add(max(0.0, total - rq - ab), {"action": "extend"})
    yield trips
    yield MetricFamily(
        "mmlspark_watchdog_armed", "gauge",
        "1 while the watchdog has a budget source (fixed / cost model / "
        "measured EWMA)").add(1.0 if wd.get("armed") else 0.0)
    ew = _num(wd.get("compute_ewma_ms"))
    if ew is not None:
        yield MetricFamily(
            "mmlspark_watchdog_compute_ewma_ms", "gauge",
            "measured dispatch EWMA feeding the wall budget").add(ew)


def _wire_families(server: Any) -> Iterable[MetricFamily]:
    """Per-wire-format ingress counters (the binary frame wire A/B signal:
    requests and body bytes by ``format`` = json | binary)."""
    with server._wire_lock:
        counts = dict(server.wire_counts)
        nbytes = dict(server.wire_bytes)
    reqs = MetricFamily("mmlspark_wire_requests_total", "counter",
                        "public requests by wire format")
    byts = MetricFamily("mmlspark_wire_bytes_total", "counter",
                        "request body bytes by wire format")
    for fmt, n in counts.items():
        reqs.add(n, {"format": fmt})
    for fmt, n in nbytes.items():
        byts.add(n, {"format": fmt})
    yield reqs
    yield byts


def _tenant_families(summary: Dict[str, Any]) -> Iterable[MetricFamily]:
    """Per-tenant admission-class gauges/counters (weighted-fair shedding:
    a light tenant's shed rate staying below a heavy tenant's is readable
    straight off mmlspark_tenant_sheds_total)."""
    weight = MetricFamily("mmlspark_tenant_weight", "gauge",
                          "configured admission weight per tenant")
    inflight = MetricFamily("mmlspark_tenant_inflight", "gauge",
                            "admitted-unanswered requests per tenant")
    admitted = MetricFamily("mmlspark_tenant_admitted_total", "counter",
                            "admissions per tenant")
    shed = MetricFamily("mmlspark_tenant_sheds_total", "counter",
                        "weighted-fair sheds per tenant")
    for tenant, s in summary.items():
        labels = {"tenant": tenant}
        for fam, key in ((weight, "weight"), (inflight, "inflight"),
                         (admitted, "admitted"), (shed, "shed")):
            f = _num(s.get(key))
            if f is not None:
                fam.add(f, labels)
    yield weight
    yield inflight
    yield admitted
    yield shed


def _tuner_families(stats: Dict[str, Any]) -> Iterable[MetricFamily]:
    """Auto-tuner telemetry (core/tune.py Tuner.stats()): lifecycle
    counters, calibration state, the numeric knobs in force, and the
    per-(segment, bucket) predicted-vs-measured error, under the
    reference's names."""
    for key, mtype, help in (
            ("epochs", "counter", "batches the tuner has observed"),
            ("applies", "counter", "knob sets applied"),
            ("rollbacks", "counter",
             "one-step rollbacks after a measured regression")):
        f = _num(stats.get(key))
        if f is not None:
            yield MetricFamily(f"mmlspark_tuner_{key}_total", mtype,
                               help).add(f)
    yield MetricFamily(
        "mmlspark_tuner_calibrated", "gauge",
        "1 once measured data backs the cost model (knobs may move)").add(
            1.0 if stats.get("calibrated") else 0.0)
    yield MetricFamily(
        "mmlspark_tuner_knobs_active", "gauge",
        "1 while a non-default knob set is applied").add(
            1.0 if stats.get("knobs_active") else 0.0)
    knobs = stats.get("knobs") or {}
    knob = MetricFamily("mmlspark_tuner_knob", "gauge",
                        "numeric knob values currently applied")
    for name in ("window_seed_ms", "inflight", "replicas"):
        f = _num(knobs.get(name))
        if f is not None:
            knob.add(f, {"knob": name})
    if knob.samples:
        yield knob
    # compiler-search knobs: the per-(segment, bucket) kernel variant in
    # force (info-style gauge, value 1) and the switch counter. Both are
    # absent until the knob first moves, so the exposition of a server
    # that never tuned variants stays byte-identical to pre-search builds.
    variant = MetricFamily(
        "mmlspark_kernel_variant", "gauge",
        "applied kernel variant per (segment, bucket) — info gauge, "
        "value is always 1")
    for seg, buckets in (knobs.get("kernel_variants") or {}).items():
        for bucket, vid in (buckets or {}).items():
            variant.add(1.0, {"segment": seg, "bucket": str(bucket),
                              "variant": str(vid)})
    if variant.samples:
        yield variant
    f = _num(stats.get("variant_switches"))
    if f is not None and f > 0:
        yield MetricFamily(
            "mmlspark_kernel_variant_switches_total", "counter",
            "tuner applies that changed the kernel-variant knob").add(f)
    conf = MetricFamily("mmlspark_tuner_confidence", "gauge",
                        "cost-model calibration confidence per segment")
    for seg, v in ((stats.get("model") or {}).get("confidence")
                   or {}).items():
        f = _num(v)
        if f is not None:
            conf.add(f, {"segment": seg})
    if conf.samples:
        yield conf
    pred = MetricFamily(
        "mmlspark_tuner_predicted_ms", "gauge",
        "analytical cost-model batch prediction per (segment, bucket)")
    meas = MetricFamily(
        "mmlspark_tuner_measured_ms", "gauge",
        "measured batch EWMA per (segment, bucket)")
    err = MetricFamily(
        "mmlspark_tuner_prediction_error_ratio", "gauge",
        "measured / analytical-predicted batch time (1.0 = exact)")
    for seg, buckets in (stats.get("predicted_vs_measured") or {}).items():
        for bucket, rec in buckets.items():
            labels = {"segment": seg, "bucket": str(bucket)}
            for fam, key in ((pred, "analytic_ms"), (meas, "measured_ms"),
                             (err, "error_ratio")):
                f = _num(rec.get(key))
                if f is not None:
                    fam.add(f, labels)
    for fam in (pred, meas, err):
        if fam.samples:
            yield fam


def _brownout_families(summary: Dict[str, Any]) -> Iterable[MetricFamily]:
    """Brownout controller state (serving/supervisor.py): the applied
    degradation level, whether any step is active, and the transition
    counters — mmlspark_brownout_*."""
    yield MetricFamily(
        "mmlspark_brownout_step", "gauge",
        "applied degradation steps (0 = full service)").add(
            summary.get("step", 0))
    yield MetricFamily(
        "mmlspark_brownout_max_steps", "gauge",
        "declared degradation ladder depth").add(
            summary.get("max_steps", 0))
    yield MetricFamily(
        "mmlspark_brownout_active", "gauge",
        "1 while at least one degradation step is applied").add(
            1.0 if summary.get("active") else 0.0)
    trans = MetricFamily(
        "mmlspark_brownout_transitions_total", "counter",
        "brownout transitions by direction (degrade/restore/rollback)")
    for direction, n in (summary.get("transitions") or {}).items():
        f = _num(n)
        if f is not None:
            trans.add(f, {"direction": str(direction)})
    yield trans


def _hedge_families(summary: Dict[str, Any]) -> Iterable[MetricFamily]:
    """Hedged-request accounting (serving/supervisor.py HedgeTracker):
    volume by outcome, win attribution, and the live quantile delay —
    mmlspark_hedge_*."""
    reqs = MetricFamily(
        "mmlspark_hedge_requests_total", "counter",
        "hedge-eligible public requests by outcome "
        "(hedged / suppressed / both_failed)")
    for key in ("hedged", "suppressed", "both_failed"):
        f = _num(summary.get(key))
        if f is not None:
            reqs.add(f, {"outcome": key})
    yield reqs
    wins = MetricFamily(
        "mmlspark_hedge_wins_total", "counter",
        "first-response winners by role (primary / hedge)")
    for role, key in (("primary", "wins_primary"), ("hedge", "wins_hedge")):
        f = _num(summary.get(key))
        if f is not None:
            wins.add(f, {"role": role})
    yield wins
    f = _num(summary.get("delay_ms"))
    if f is not None:
        yield MetricFamily(
            "mmlspark_hedge_delay_ms", "gauge",
            "current hedge trigger delay (the configured quantile of "
            "observed forward latency)").add(f)
    f = _num(summary.get("hedge_fraction"))
    if f is not None:
        yield MetricFamily(
            "mmlspark_hedge_fraction", "gauge",
            "hedged / eligible requests (the duplicate-work bound)").add(f)


def fold_server(registry: MetricsRegistry, server: Any) -> None:
    """Register collectors reading a ServingServer's live stats surfaces:
    LatencyStats window + shed counters, the admission queue, wire-format
    and tenant admission counters, the async executor, the tuner, and the
    ingest/fusion providers when wired (serve_pipeline).
    Safe to call before start() — everything is read at scrape time."""

    def collect() -> List[MetricFamily]:
        fams: List[MetricFamily] = []
        fams.append(MetricFamily(
            "mmlspark_requests_served_total", "counter",
            "requests answered (all statuses) since process start").add(
                server.requests_served))
        fams.append(MetricFamily(
            "mmlspark_queue_depth", "gauge",
            "requests waiting for a batch slot").add(server._queue.qsize()))
        fams.append(MetricFamily(
            "mmlspark_draining", "gauge",
            "1 while the server refuses new work (graceful stop)").add(
                1.0 if server._draining.is_set() else 0.0))
        fams.extend(_latency_families(server.stats.summary()))
        if getattr(server, "_wire_lock", None) is not None:
            fams.extend(_wire_families(server))
        if getattr(server, "_tenants", None) is not None:
            fams.extend(_tenant_families(server._tenants.summary()))
        if server._executor is not None:
            try:
                fams.extend(_executor_families(server._executor.stats()))
            except Exception:  # noqa: BLE001 — executor mid-shutdown
                pass
        if getattr(server, "_tuner", None) is not None:
            try:
                fams.extend(_tuner_families(server._tuner.stats()))
            except Exception:  # noqa: BLE001 — tuner mid-refit
                pass
        if getattr(server, "_brownout", None) is not None:
            try:
                fams.extend(_brownout_families(server._brownout.summary()))
            except Exception:  # noqa: BLE001 — brownout mid-transition
                pass
        if server.ingest_stats is not None:
            try:
                s = server.ingest_stats()
                if s:
                    fams.extend(_ingest_families(s))
            except Exception:  # noqa: BLE001
                pass
        if server.fusion_stats is not None:
            try:
                s = server.fusion_stats()
                if s:
                    fams.extend(_fusion_families(s))
            except Exception:  # noqa: BLE001
                pass
        return fams

    registry.register_collector(collect)


# ---------------------------------------------------------------------------
# RoutingFront
# ---------------------------------------------------------------------------


def fold_front(registry: MetricsRegistry, front: Any) -> None:
    """Register collectors for a RoutingFront: registered-worker count,
    one-hot circuit-breaker states, and capacity weights."""

    def collect() -> List[MetricFamily]:
        states = front.worker_states
        caps = front.worker_capacities
        fams = [MetricFamily(
            "mmlspark_workers", "gauge",
            "registered workers by routability").add(
                sum(1 for s in states.values() if s != "open"),
                {"routable": "true"}).add(
                sum(1 for s in states.values() if s == "open"),
                {"routable": "false"})]
        st = MetricFamily(
            "mmlspark_worker_circuit_state", "gauge",
            "one-hot circuit-breaker state per worker "
            "(closed/half_open/open)")
        for w, s in states.items():
            for name in ("closed", "half_open", "open"):
                st.add(1.0 if s == name else 0.0,
                       {"worker": w, "state": name})
        fams.append(st)
        cap = MetricFamily("mmlspark_worker_capacity", "gauge",
                           "concurrent-batch capacity weight per worker")
        for w, c in caps.items():
            cap.add(c, {"worker": w})
        fams.append(cap)
        if getattr(front, "_hedge", None) is not None:
            try:
                fams.extend(_hedge_families(front._hedge.summary()))
            except Exception:  # noqa: BLE001 — tracker mid-update
                pass
        return fams

    registry.register_collector(collect)


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------


def fold_tracer(registry: MetricsRegistry, tracer: Any) -> None:
    """Trace-pipeline health: originated/joined/head-dropped traces and the
    buffered span count, so sampling behavior is itself observable."""

    def collect() -> List[MetricFamily]:
        s = tracer.stats()
        fams = [MetricFamily(
            "mmlspark_trace_sample_rate", "gauge",
            "head-based sampling probability at this ingress").add(
                s["sample_rate"])]
        tr = MetricFamily("mmlspark_traces_total", "counter",
                          "ingress trace decisions by kind")
        tr.add(s["started"], {"kind": "started"})
        tr.add(s["joined"], {"kind": "joined"})
        tr.add(s["dropped"], {"kind": "dropped"})
        fams.append(tr)
        fams.append(MetricFamily(
            "mmlspark_trace_buffered_spans", "gauge",
            "finished spans held in the tracer ring").add(s["buffered"]))
        return fams

    registry.register_collector(collect)
