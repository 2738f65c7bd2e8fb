"""RoutingFront — the routing service for multi-worker serving.

Counterpart of the reference's ``mmlspark_tpu/serving/routing.py`` (the
routing service of HTTPSourceV2): every worker POSTs its
``{"address", "capacity"}`` to register, and public traffic is spread across
registered workers. Worker loss is handled by retrying
on another worker (Spark task retry gave the reference this for free; here
it's explicit) — but unlike the pre-fault-layer build, failing workers are NOT
blacklisted forever: each worker runs a circuit breaker (closed -> open on
``max_failures`` consecutive failures), and open workers are health-probed on
a jittered backoff and re-admitted when they answer again.

Deadline contract: requests carrying ``X-MMLSpark-Deadline`` (epoch seconds)
are rejected with 504 once expired — before any forward — and the per-worker
forward timeout is capped at the remaining deadline.

Deployment: one RoutingFront per serving cluster, one ServingServer per GPU
host; the pipeline inside each worker uses that host's cards. Cross-worker
replies ride the internal endpoint (server.reply_to), so a worker group that
shards a batch can answer requests that entered elsewhere. The fleet
capacity aggregate (``/_mmlspark/capacity``) and the federated front fabric
(``fabric=``, ``/_mmlspark/ring``, ``/_mmlspark/drain``) wait for their
planes (ROADMAP A step 10).
"""

from __future__ import annotations

import itertools
import json
import queue as queue_mod
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.error import HTTPError, URLError
from urllib.parse import urlsplit
from urllib.request import Request, urlopen

from ..core import faults
from ..core.faults import RetryPolicy, deadline_from_headers
from ..obs import bridge as obs_bridge
from ..obs.metrics import MetricsRegistry
from ..obs.trace import TRACE_HEADER, Tracer

#: circuit-breaker states (per registered worker)
CLOSED = "closed"          # healthy: receives traffic
OPEN = "open"              # tripped: excluded from routing, health-probed
HALF_OPEN = "half_open"    # probe succeeded: routed again, one failure re-opens


class _WorkerCircuit:
    __slots__ = ("state", "failures", "next_probe", "probe_attempt")

    def __init__(self):
        self.state = CLOSED
        self.failures = 0
        self.next_probe = 0.0
        self.probe_attempt = 0


class RoutingFront:
    """HTTP front: register workers, round-robin public requests, circuit-
    break dead ones and re-admit them when health probes succeed.

    Endpoints:
      POST /_mmlspark/register   {"address": "http://host:port/api"} -> 200
      GET  /_mmlspark/workers    -> {"workers": [...], "states": {...}}
      anything else              -> forwarded to a routable worker (retry
                                    across workers; ``max_failures``
                                    consecutive failures trip the worker's
                                    breaker OPEN — probed, not blacklisted)
    """

    REGISTER_PATH = "/_mmlspark/register"
    WORKERS_PATH = "/_mmlspark/workers"
    #: probed path on the worker host: constant-cost on ServingServer
    #: (healthz — the old /_mmlspark/stats probe payload scaled with the
    #: latency window and executor timeline); any HTTP answer — 404
    #: included — proves liveness elsewhere
    PROBE_PATH = "/_mmlspark/healthz"
    #: the front's own Prometheus exposition + liveness probe
    METRICS_PATH = "/_mmlspark/metrics"
    HEALTH_PATH = "/_mmlspark/healthz"
    #: buffered spans as JSON (worker parity: cross-hop exemplar lookups
    #: resolve from the front too, not just the worker that served them)
    TRACE_PATH = "/_mmlspark/trace"

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 forward_timeout_s: float = 70.0, max_failures: int = 3,
                 token: Optional[str] = None,
                 probe_interval_s: float = 0.5,
                 probe_timeout_s: float = 2.0,
                 probe_policy: Optional[RetryPolicy] = None,
                 obs: bool = True, tracer: Optional[Tracer] = None,
                 trace_sample_rate: float = 1.0,
                 http_mode: str = "thread", slo=None, hedge=None,
                 fabric=None):
        if fabric:
            raise NotImplementedError(
                "the federated front fabric is not ported yet (ROADMAP A "
                "step 10)")
        self.host = host
        self.port = port
        self.forward_timeout_s = forward_timeout_s
        self.max_failures = max_failures
        self.token = token  # when set, /register requires X-MMLSpark-Token
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        # HTTP transport: "thread" = ThreadingHTTPServer + one urlopen
        # socket per forward; "async" = event-loop ingress (serving/aio.py)
        # + pooled keep-alive worker connections — the hop stops paying a
        # TCP connect per forwarded request, and frame bodies pass through
        # as the same opaque bytes (no decode/re-encode on this hop in
        # either mode)
        if http_mode not in ("thread", "async"):
            raise ValueError(f"http_mode must be 'thread' or 'async', "
                             f"got {http_mode!r}")
        self.http_mode = http_mode
        self._aio = None
        self._pool = None  # AsyncConnectionPool (async mode, loop thread)
        # hedged requests ("The Tail at Scale"): after a quantile of the
        # observed forward-latency distribution, re-issue the request to a
        # second worker, first response wins (serving/supervisor.py
        # HedgeTracker). None = off (the default — hedging deliberately
        # double-dispatches, so it is opt-in for idempotent transforms).
        from .supervisor import make_hedge

        self._hedge = make_hedge(hedge)
        # probe backoff: open workers are re-probed on a jittered exponential
        # schedule (deterministic when the policy is seeded)
        self.probe_policy = probe_policy or RetryPolicy(
            max_retries=1 << 30, base_s=probe_interval_s, multiplier=2.0,
            max_backoff_s=max(probe_interval_s * 16, probe_interval_s),
            jitter=0.2, seed=0)
        self._probe_rng = self.probe_policy.make_rng()
        self._workers: List[str] = []
        self._circuits: Dict[str, _WorkerCircuit] = {}
        self._capacity: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._rr = itertools.count()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        # observability: registry (worker circuit states + forward
        # outcomes) and tracer (ingress + per-attempt forward spans; the
        # trace context rides X-MMLSpark-Trace to the worker)
        self.obs_enabled = bool(obs)
        self.registry: Optional[MetricsRegistry] = None
        self.tracer: Optional[Tracer] = None
        self._forwards = None
        # front-side latency SLO (obs/perf.py): burn-rate gauges over the
        # client-observed forward latency, so the autoscaling signal exists
        # at the tier the HPA actually scales behind
        self._slo = None
        if self.obs_enabled:
            self.registry = MetricsRegistry()
            self.tracer = tracer if tracer is not None else Tracer(
                sample_rate=trace_sample_rate, service="routing-front")
            obs_bridge.fold_front(self.registry, self)
            obs_bridge.fold_tracer(self.registry, self.tracer)
            self._forwards = self.registry.counter(
                "mmlspark_front_requests_total",
                "public requests by routing outcome", ("outcome",))
            from ..obs import perf as obs_perf

            self._slo = obs_perf.make_slo(slo)
            if self._slo is not None:
                self.registry.register_collector(self._slo.families)

    def _count(self, outcome: str) -> None:
        if self._forwards is not None:
            self._forwards.labels(outcome=outcome).inc()

    def _slo_record(self, t_p0: float, status: int) -> None:
        """Feed one public-request outcome to the SLO tracker (shed/error
        statuses burn budget regardless of how fast they were written)."""
        if self._slo is not None:
            self._slo.record(time.perf_counter() - t_p0,
                             breach=True if status >= 500 else None)

    # -- worker management ------------------------------------------------
    def register(self, address: str, capacity: int = 1) -> None:
        """``capacity`` is the worker's concurrent-batch hint (its replica
        count under the async executor — ServingServer.capacity): weighted
        round-robin sends a worker with R replicas R slots per cycle."""
        with self._lock:
            if address not in self._workers:
                self._workers.append(address)
            self._circuits[address] = _WorkerCircuit()
            self._capacity[address] = max(1, int(capacity))

    def deregister(self, address: str) -> None:
        with self._lock:
            if address in self._workers:
                self._workers.remove(address)
            self._circuits.pop(address, None)
            self._capacity.pop(address, None)

    @property
    def workers(self) -> List[str]:
        """Routable workers (breaker closed or half-open)."""
        with self._lock:
            return [w for w in self._workers
                    if self._circuits[w].state != OPEN]

    @property
    def worker_states(self) -> Dict[str, str]:
        with self._lock:
            return {w: self._circuits[w].state for w in self._workers}

    @property
    def worker_capacities(self) -> Dict[str, int]:
        with self._lock:
            return {w: self._capacity.get(w, 1) for w in self._workers}

    def _pick_order(self) -> List[str]:
        """Capacity-weighted round-robin: a worker with capacity R (R
        replicas) occupies R slots in the rotation, so traffic matches the
        cluster's real concurrent-batch capacity. The returned order is
        deduplicated — retries still walk DISTINCT workers."""
        with self._lock:
            ws: List[str] = []
            for w in self._workers:
                if self._circuits[w].state != OPEN:
                    ws.extend([w] * self._capacity.get(w, 1))
        if not ws:
            return []
        start = next(self._rr) % len(ws)
        rotated = ws[start:] + ws[:start]
        seen = set()
        order = []
        for w in rotated:
            if w not in seen:
                seen.add(w)
                order.append(w)
        return order

    def _note_failure(self, address: str) -> None:
        with self._lock:
            c = self._circuits.get(address)
            if c is None:
                return
            c.failures += 1
            # a half-open worker re-opens on its first failure; a closed one
            # trips after max_failures consecutive failures
            if c.state == HALF_OPEN or c.failures >= self.max_failures:
                c.state = OPEN
                c.probe_attempt = 0
                c.next_probe = time.monotonic() + self.probe_policy.next_wait(
                    0, self._probe_rng)

    def _note_success(self, address: str) -> None:
        with self._lock:
            c = self._circuits.get(address)
            if c is not None:
                c.failures = 0
                c.state = CLOSED

    # -- health probing (re-admission instead of permanent blacklist) -----
    def _probe(self, address: str) -> bool:
        parts = urlsplit(address)
        url = f"{parts.scheme}://{parts.netloc}{self.PROBE_PATH}"
        try:
            with urlopen(Request(url, method="GET"),
                         timeout=self.probe_timeout_s):
                return True
        except HTTPError:
            return True  # the worker answered: alive, path just unsupported
        except (URLError, OSError):
            return False

    def _probe_loop(self) -> None:
        while not self._stop.wait(min(self.probe_interval_s, 0.1)):
            now = time.monotonic()
            with self._lock:
                due = [w for w in self._workers
                       if self._circuits[w].state == OPEN
                       and now >= self._circuits[w].next_probe]
            for addr in due:
                alive = self._probe(addr)
                with self._lock:
                    c = self._circuits.get(addr)
                    if c is None or c.state != OPEN:
                        continue
                    if alive:
                        c.state = HALF_OPEN
                        c.failures = 0
                    else:
                        c.probe_attempt += 1
                        c.next_probe = time.monotonic() + \
                            self.probe_policy.next_wait(
                                c.probe_attempt, self._probe_rng)

    # -- forwarding helpers (threaded transport) -----------------------------
    def _worker_url(self, addr: str, incoming, path: str) -> str:
        """Resolve the worker-side URL for one forward: "/" routes to the
        worker's registered api path; any other path+query forwards
        verbatim (proxy semantics)."""
        parts = urlsplit(addr)
        wpath = parts.path if path in ("", "/") else incoming.path
        query = f"?{incoming.query}" if incoming.query else ""
        return f"{parts.scheme}://{parts.netloc}{wpath or '/'}{query}"

    def _forward_once(self, addr: str, method: str, url: str, path: str,
                      headers: Dict[str, str], body: bytes,
                      timeout: float, tctx) -> Tuple[str, Any]:
        """One forward attempt over urlopen, with circuit-breaker notes and
        the per-attempt forward span. Returns ``(kind, payload)``:

          - ``"response"`` — payload = (status, body, content_type): the
            worker answered (any status — authoritative, never retried);
          - ``"timeout"``  — payload = error string: the request may have
            REACHED the worker (read timeout — replay only when safe);
          - ``"error"``    — payload = error string: the request never
            arrived (connect refused/reset — safe to replay elsewhere).
        """
        fwd = None
        hdrs = dict(headers)
        if tctx is not None:
            if tctx.sampled:
                fwd = self.tracer.child(tctx)
            hdrs[TRACE_HEADER] = (fwd or tctx).to_header()
        req = Request(url, data=body if body else None, method=method,
                      headers=hdrs)
        t_f0w, t_f0 = time.time(), time.perf_counter()

        def fwd_span(**attrs):
            if fwd is not None:
                self.tracer.record("forward", fwd, t_f0w,
                                   time.perf_counter() - t_f0,
                                   worker=addr, **attrs)

        try:
            faults.fire(faults.WORKER_FORWARD, addr=addr, path=path)
            with urlopen(req, timeout=timeout) as resp:
                self._note_success(addr)
                fwd_span(status=resp.status)
                return ("response", (resp.status, resp.read(),
                                     resp.headers.get("Content-Type",
                                                      "application/json")))
        except HTTPError as e:
            # worker answered (e.g. 500 from the pipeline): authoritative
            self._note_success(addr)
            fwd_span(status=e.code)
            return ("response", (e.code, e.read() or b"",
                                 e.headers.get("Content-Type",
                                               "text/plain")))
        except (URLError, OSError) as e:
            self._note_failure(addr)
            reason = getattr(e, "reason", e)
            fwd_span(error=str(reason))
            timed_out = isinstance(reason, TimeoutError) or \
                "timed out" in str(reason).lower()
            return ("timeout" if timed_out else "error", str(reason))

    def _hedged_forward(self, order: List[str], attempt: Callable,
                        deadline) -> Optional[Tuple[str, Any, str]]:
        """Primary + delayed hedge over the first two routable workers
        (threaded transport): launch ``attempt(order[0])`` in a thread;
        if no outcome lands within the tracker's quantile delay, launch
        ``attempt(order[1])`` and take whichever responds FIRST (the
        loser's reply is discarded when it eventually arrives — bounded
        duplicate work, no cancellation needed). Returns ``(kind, payload,
        addr)`` for the winning response / terminal failure, or None when
        every launched attempt failed with a replay-safe transport error
        (the caller walks the remaining workers)."""
        tracker = self._hedge
        tracker.note_request()
        results: "queue_mod.Queue" = queue_mod.Queue()
        t0 = time.perf_counter()

        def run(addr: str, role: str) -> None:
            try:
                kind, payload = attempt(addr)
            except Exception as e:  # noqa: BLE001 — a lost put would deadlock
                kind, payload = "error", str(e)
            if role == "primary" and kind == "response":
                # quantile source: primary latencies only (hedge wins
                # would bias the reservoir low)
                tracker.observe(time.perf_counter() - t0)
            results.put((role, addr, kind, payload))

        threading.Thread(target=run, args=(order[0], "primary"),
                         daemon=True).start()
        delay = tracker.delay_s()
        launched, hedge_done, did_hedge = 1, False, False
        failures: List[Tuple[str, str, str, Any]] = []
        while len(failures) < launched:
            timeout = None
            if not hedge_done:
                timeout = max(0.0, t0 + delay - time.perf_counter())
            try:
                role, addr, kind, payload = results.get(timeout=timeout)
            except queue_mod.Empty:
                hedge_done = True
                if deadline is not None and deadline.expired():
                    continue  # nobody is waiting: don't spend a duplicate
                try:
                    # chaos seam: a raising FRONT_HEDGE plan suppresses
                    # this hedge; fired() records which requests hedged
                    faults.fire(faults.FRONT_HEDGE, addr=order[1])
                except Exception:  # noqa: BLE001 — injected suppression
                    tracker.note_suppressed()
                    continue
                tracker.note_hedged()
                did_hedge = True
                threading.Thread(target=run, args=(order[1], "hedge"),
                                 daemon=True).start()
                launched += 1
                continue
            if kind == "response":
                tracker.note_win(role)
                return (kind, payload, addr)
            failures.append((role, addr, kind, payload))
            if not hedge_done and kind == "error":
                # the primary failed replay-safe BEFORE the hedge delay:
                # try the second worker immediately — a sequential retry
                # (the primary is gone, so this is not duplicate work and
                # does not count as a hedge)
                hedge_done = True
                threading.Thread(target=run, args=(order[1], "retry"),
                                 daemon=True).start()
                launched += 1
        if did_hedge:
            tracker.note_both_failed()
        # a read timeout is terminal for non-idempotent requests and an
        # expired deadline is terminal outright (the caller applies the
        # rules); prefer reporting those over a replay-safe error
        for role, addr, kind, payload in failures:
            if kind in ("timeout", "deadline"):
                return (kind, payload, addr)
        return None

    # -- HTTP ---------------------------------------------------------------
    def _control(self, path: str, body: bytes, headers
                 ) -> Optional[tuple]:
        """Control-plane endpoints shared by both transports: returns
        (status, content_type, body) or None when the request should be
        forwarded to a worker."""
        if path == RoutingFront.REGISTER_PATH:
            from .server import TOKEN_HEADER
            if self.token is not None and \
                    headers.get(TOKEN_HEADER) != self.token:
                return (403, "application/json",
                        b'{"error": "bad cluster token"}')
            try:
                msg = json.loads(body.decode())
                self.register(msg["address"],
                              capacity=int(msg.get("capacity", 1)))
                return (200, "application/json", b"{}")
            except Exception as e:  # noqa: BLE001
                return (400, "application/json",
                        json.dumps({"error": str(e)}).encode())
        if path == RoutingFront.WORKERS_PATH:
            payload = {"workers": self.workers,
                       "states": self.worker_states,
                       "capacity": self.worker_capacities}
            if self._hedge is not None:
                payload["hedge"] = self._hedge.summary()
            return (200, "application/json", json.dumps(payload).encode())
        if path == RoutingFront.HEALTH_PATH:
            return (200, "application/json", json.dumps(
                {"ok": True, "workers": len(self.workers)}).encode())
        if path == RoutingFront.METRICS_PATH:
            if self.registry is None:
                return (404, "application/json",
                        b'{"error": "observability disabled"}')
            return (200, MetricsRegistry.CONTENT_TYPE,
                    self.registry.exposition().encode("utf-8"))
        if path == RoutingFront.TRACE_PATH:
            # worker parity (ServingServer.TRACE_PATH): a latency-bucket
            # exemplar found in the front's exposition resolves HERE —
            # front ingress/forward spans share the worker's trace_id
            if self.tracer is None:
                return (404, "application/json",
                        b'{"error": "observability disabled"}')
            return (200, "application/json", json.dumps(
                {"stats": self.tracer.stats(),
                 "spans": self.tracer.spans()}).encode("utf-8"))
        return None

    def _make_handler(self):
        front = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _read_body(self) -> bytes:
                length = int(self.headers.get("Content-Length", 0) or 0)
                return self.rfile.read(length) if length else b""

            def _respond(self, status: int, body: bytes,
                         ctype: str = "application/json",
                         extra: Optional[Dict[str, str]] = None):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _handle(self):
                incoming = urlsplit(self.path)
                path = incoming.path.rstrip("/")
                body = self._read_body()
                ctrl = front._control(path, body, self.headers)
                if ctrl is not None:
                    status, ctype, cbody = ctrl
                    self._respond(status, cbody, ctype)
                    return
                # trace ingress: the front originates (or continues) the
                # trace; each forward attempt ships a child context to the
                # worker via X-MMLSpark-Trace, so worker spans link up
                tctx = front.tracer.ingress(self.headers) \
                    if front.tracer is not None else None
                t_w0, t_p0 = time.time(), time.perf_counter()

                def respond(status, body, ctype="application/json",
                            extra=None, outcome=None):
                    self._respond(status, body, ctype, extra)
                    if outcome is not None:
                        front._count(outcome)
                    front._slo_record(t_p0, int(status))
                    if tctx is not None and tctx.sampled:
                        front.tracer.record(
                            "ingress", tctx, t_w0,
                            time.perf_counter() - t_p0, status=int(status))

                # deadline gate: an expired request is dropped HERE, before
                # any forward burns a worker slot
                dl = deadline_from_headers(self.headers)
                if dl is not None and dl.expired():
                    respond(504, b'{"error": "deadline expired"}',
                            outcome="deadline_expired")
                    return
                # forward to a worker, retrying across the ring; a request is
                # only REPLAYED on another worker when the failure shows it
                # never reached the first one (connect refused/reset) or the
                # method is idempotent — a read timeout on a POST may mean the
                # worker is mid-compute, so replaying would double-process it.
                # With hedging ON the first two workers instead race: the
                # hedge launches after the tracker's quantile delay and the
                # first response wins (opt-in: duplicates by design).
                order = front._pick_order()
                if not order:
                    respond(503, b'{"error": "no workers registered"}',
                            extra={"Retry-After": "1"}, outcome="no_workers")
                    return
                idempotent = self.command in ("GET", "HEAD")
                # replace any incoming trace header with the per-attempt
                # context (built in _forward_once): the head decision made
                # at ingress MUST propagate, otherwise the worker would
                # re-roll sampling
                drop = {"host", "content-length"}
                if tctx is not None:
                    drop.add(TRACE_HEADER.lower())
                base_hdrs = {k: v for k, v in self.headers.items()
                             if k.lower() not in drop}

                def attempt(addr):
                    if dl is not None and dl.expired():
                        return ("deadline", None)
                    timeout = front.forward_timeout_s
                    if dl is not None:
                        timeout = max(dl.cap(timeout), 1e-3)
                    return front._forward_once(
                        addr, self.command,
                        front._worker_url(addr, incoming, path), path,
                        base_hdrs, body, timeout, tctx)

                rest = order
                if front._hedge is not None and len(order) >= 2:
                    hedged = front._hedged_forward(order[:2], attempt, dl)
                    if hedged is not None:
                        kind, payload, addr = hedged
                        if kind == "response":
                            status, rbody, ctype = payload
                            respond(status, rbody, ctype,
                                    outcome="forwarded")
                            return
                        if kind == "timeout" and not idempotent:
                            respond(504, json.dumps(
                                {"error": f"worker {addr} timed out; not "
                                          f"replayed (non-idempotent)"}
                            ).encode(), outcome="timeout_unreplayed")
                            return
                        if kind == "deadline":
                            respond(504, b'{"error": "deadline expired"}',
                                    outcome="deadline_expired")
                            return
                    rest = order[2:]
                for addr in rest:
                    kind, payload = attempt(addr)
                    if kind == "response":
                        status, rbody, ctype = payload
                        respond(status, rbody, ctype, outcome="forwarded")
                        return
                    if kind == "deadline":
                        respond(504, b'{"error": "deadline expired"}',
                                outcome="deadline_expired")
                        return
                    if kind == "timeout" and not idempotent:
                        respond(504, json.dumps(
                            {"error": f"worker {addr} timed out; not "
                                      f"replayed (non-idempotent)"}
                        ).encode(), outcome="timeout_unreplayed")
                        return
                respond(502, b'{"error": "all workers failed"}',
                        outcome="all_workers_failed")

            do_POST = _handle
            do_GET = _handle

        return Handler

    async def _aio_handle(self, req):
        """Async-transport handler (serving/aio.py): same control plane,
        circuit-breaker notes, deadline gates, trace spans, and
        idempotent-replay rules as the threaded handler — but forwards ride
        the keep-alive connection pool instead of a fresh urlopen socket,
        and request/response bodies pass through as opaque bytes."""
        import asyncio

        from .aio import HTTPResponse
        from ..obs.trace import TRACE_HEADER

        incoming = urlsplit(req.path)
        path = incoming.path.rstrip("/")
        body = req.body
        ctrl = self._control(path, body, req.headers)
        if ctrl is not None:
            status, ctype, cbody = ctrl
            return HTTPResponse(status, cbody, ctype)
        tctx = self.tracer.ingress(req.headers) \
            if self.tracer is not None else None
        t_w0, t_p0 = time.time(), time.perf_counter()

        def respond(status, rbody, ctype="application/json", extra=None,
                    outcome=None):
            if outcome is not None:
                self._count(outcome)
            self._slo_record(t_p0, int(status))
            if tctx is not None and tctx.sampled:
                self.tracer.record("ingress", tctx, t_w0,
                                   time.perf_counter() - t_p0,
                                   status=int(status))
            return HTTPResponse(status, rbody, ctype, extra)

        dl = deadline_from_headers(req.headers)
        if dl is not None and dl.expired():
            return respond(504, b'{"error": "deadline expired"}',
                           outcome="deadline_expired")
        order = self._pick_order()
        if not order:
            return respond(503, b'{"error": "no workers registered"}',
                           extra={"Retry-After": "1"}, outcome="no_workers")
        idempotent = req.method in ("GET", "HEAD")
        drop = {"host", "content-length", "connection"}
        if tctx is not None:
            # the head sampling decision made at ingress MUST propagate
            # (same rule as the threaded handler)
            drop.add(TRACE_HEADER.lower())
        base_hdrs = {k: v for k, v in req.headers.items()
                     if k.lower() not in drop}

        async def attempt(addr):
            """One pooled forward: same breaker/span/deadline taxonomy as
            the threaded _forward_once, over the keep-alive pool."""
            if dl is not None and dl.expired():
                return ("deadline", None)
            timeout = max(dl.cap(self.forward_timeout_s), 1e-3) \
                if dl is not None else self.forward_timeout_s
            url = self._worker_url(addr, incoming, path)
            fwd = None
            hdrs = dict(base_hdrs)
            if tctx is not None:
                if tctx.sampled:
                    fwd = self.tracer.child(tctx)
                hdrs[TRACE_HEADER] = (fwd or tctx).to_header()
            t_f0w, t_f0 = time.time(), time.perf_counter()

            def fwd_span(**attrs):
                if fwd is not None:
                    self.tracer.record("forward", fwd, t_f0w,
                                       time.perf_counter() - t_f0,
                                       worker=addr, **attrs)

            try:
                faults.fire(faults.WORKER_FORWARD, addr=addr, path=path)
                status, rhdrs, rbody = await self._pool.request(
                    req.method, url, body=body, headers=hdrs,
                    timeout=timeout, deadline=dl)
            except (asyncio.TimeoutError, OSError) as e:
                # transport failure: same taxonomy as the urlopen path —
                # note the breaker, replay only when safe
                self._note_failure(addr)
                fwd_span(error=str(e))
                timed_out = isinstance(e, asyncio.TimeoutError) or \
                    isinstance(e, TimeoutError) or \
                    "timed out" in str(e).lower()
                return ("timeout" if timed_out else "error", str(e))
            # ANY worker answer — 2xx or an error status — is authoritative
            # (the threaded handler's urlopen/HTTPError split, merged)
            self._note_success(addr)
            fwd_span(status=status)
            return ("response",
                    (status, rbody,
                     rhdrs.get("Content-Type", "application/json")))

        rest = order
        if self._hedge is not None and len(order) >= 2:
            hedged = await self._hedged_forward_aio(order[:2], attempt, dl)
            if hedged is not None:
                kind, payload, addr = hedged
                if kind == "response":
                    status, rbody, ctype = payload
                    return respond(status, rbody, ctype,
                                   outcome="forwarded")
                if kind == "timeout" and not idempotent:
                    return respond(504, json.dumps(
                        {"error": f"worker {addr} timed out; not "
                                  f"replayed (non-idempotent)"}
                    ).encode(), outcome="timeout_unreplayed")
                if kind == "deadline":
                    return respond(504, b'{"error": "deadline expired"}',
                                   outcome="deadline_expired")
            rest = order[2:]
        for addr in rest:
            kind, payload = await attempt(addr)
            if kind == "response":
                status, rbody, ctype = payload
                return respond(status, rbody, ctype, outcome="forwarded")
            if kind == "deadline":
                return respond(504, b'{"error": "deadline expired"}',
                               outcome="deadline_expired")
            if kind == "timeout" and not idempotent:
                return respond(504, json.dumps(
                    {"error": f"worker {addr} timed out; not "
                              f"replayed (non-idempotent)"}
                ).encode(), outcome="timeout_unreplayed")
        return respond(502, b'{"error": "all workers failed"}',
                       outcome="all_workers_failed")

    async def _hedged_forward_aio(self, order, attempt,
                                  deadline) -> Optional[Tuple[str, Any, str]]:
        """Async twin of ``_hedged_forward``: primary task + delayed hedge
        task, first response wins, losers are CANCELLED (the pool discards
        a cancelled connection rather than reusing it torn)."""
        import asyncio

        tracker = self._hedge
        tracker.note_request()
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        tasks = {asyncio.ensure_future(attempt(order[0])):
                 ("primary", order[0])}
        delay = tracker.delay_s()
        hedge_done = did_hedge = False
        failures: List[Tuple[str, str, Any]] = []
        result: Optional[Tuple[str, Any, str]] = None
        while tasks:
            timeout = None
            if not hedge_done:
                timeout = max(0.0, t0 + delay - loop.time())
            done, _pending = await asyncio.wait(
                set(tasks), timeout=timeout,
                return_when=asyncio.FIRST_COMPLETED)
            if not done:
                hedge_done = True
                if deadline is not None and deadline.expired():
                    continue
                try:
                    faults.fire(faults.FRONT_HEDGE, addr=order[1])
                except Exception:  # noqa: BLE001 — injected suppression
                    tracker.note_suppressed()
                    continue
                tracker.note_hedged()
                did_hedge = True
                tasks[asyncio.ensure_future(attempt(order[1]))] = \
                    ("hedge", order[1])
                continue
            for t in done:
                role, addr = tasks.pop(t)
                try:
                    kind, payload = await t  # done: resolves immediately
                except asyncio.CancelledError:
                    continue
                if kind == "response":
                    if role == "primary":
                        tracker.observe(loop.time() - t0)
                    tracker.note_win(role)
                    result = (kind, payload, addr)
                else:
                    failures.append((addr, kind, payload))
                    if not hedge_done and kind == "error":
                        # primary failed replay-safe before the delay:
                        # sequential retry on the second worker, not a hedge
                        hedge_done = True
                        tasks[asyncio.ensure_future(attempt(order[1]))] = \
                            ("retry", order[1])
            if result is not None:
                for t in tasks:
                    t.cancel()
                return result
        if did_hedge:
            tracker.note_both_failed()
        for addr, kind, payload in failures:
            if kind in ("timeout", "deadline"):
                return (kind, payload, addr)
        return None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "RoutingFront":
        self._stop.clear()
        if self.http_mode == "async":
            from .aio import AsyncConnectionPool, AsyncHTTPServer

            self._pool = AsyncConnectionPool()
            self._aio = AsyncHTTPServer(self.host, self.port,
                                        self._aio_handle,
                                        name="routing-front-aio")
            self._aio.start()
            self.port = self._aio.port
        else:
            self._httpd = ThreadingHTTPServer((self.host, self.port),
                                              self._make_handler())
            self.port = self._httpd.server_address[1]
            t = threading.Thread(target=self._httpd.serve_forever,
                                 daemon=True, name="routing-front")
            t.start()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, daemon=True, name="routing-front-probe")
        self._probe_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5)
            self._probe_thread = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._aio is not None:
            if self._pool is not None and self._aio.loop is not None \
                    and self._aio.loop.is_running():
                # close pooled worker sockets on their own loop
                try:
                    self._aio.loop.call_soon_threadsafe(self._pool.close)
                except RuntimeError:
                    pass
            self._aio.stop()
            self._aio = None

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def register_worker(front_address: str, worker_address: str,
                    timeout: float = 10.0, token: Optional[str] = None,
                    capacity: int = 1) -> None:
    """Worker-side registration call (ServiceInfo POST parity).

    ``capacity``: concurrent-batch hint for weighted routing — pass the
    worker's ``ServingServer.capacity`` (replica count under async_exec).
    The reference's ``models`` list (multimodel workers) waits for the
    model-mall plane."""
    from .server import _post_json

    parts = urlsplit(front_address)
    url = f"{parts.scheme}://{parts.netloc}{RoutingFront.REGISTER_PATH}"
    _post_json(url, {"address": worker_address, "capacity": int(capacity)},
               timeout=timeout, token=token)
