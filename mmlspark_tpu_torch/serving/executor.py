"""Async pipelined serving: overlapped drain/compute/readback executor.

Counterpart of the reference's ``mmlspark_tpu/serving/executor.py``.

``ServingServer._loop`` is strictly serial — drain -> transform -> fulfill ->
drain — so the device idles during host drain/journal/fulfill and the host
idles during compute. This module rebuilds the hot path as a pipelined
executor (the Orca/continuous-batching shape; cf. TVM's decoupled
schedule/compute split, arXiv:1802.04799):

    ingress queue --[drain/coalesce/journal]--> submit queue
                  --[compute: one worker per replica]--> ready queue
                  --[readback/fulfill thread]--> reply slots

  - The DRAIN stage coalesces batch N+1 while batch N computes. Once the
    coalescing window closes it keeps absorbing arrivals until an in-flight
    slot frees (bounded by ``inflight``), so a saturated server forms
    convoy-merged batches with no idle coalescing sleep — the static
    ``max_wait_ms`` tax the sync loop pays every cycle.
  - The COMPUTE stage runs one worker per replica. Transforms that expose a
    ``submit()`` protocol (fused pipelines — core/fusion.py
    ``transform_submit``) dispatch without blocking and hand a
    pending handle downstream: the batches are queued on the replica's own
    CUDA stream and the handle waits on their events alone. Plain
    transforms compute in place (torch releases the GIL inside its ops, so
    drain/readback still overlap them).
  - The READBACK thread resolves pending outputs, fulfills reply slots,
    feeds the adaptive controller, and commits journal epochs.

Epoch/journal at-least-once semantics, deadline 504 gates, and graceful
drain are shared with the sync loop (both paths call the same
``_prepare_batch`` / ``_apply_output`` server helpers), so replies are
bitwise-identical between the two modes.

``ReplicaSet`` places R copies of the transform round-robin across the
host's cards (``torch.device("cuda", i)`` for every visible card) -- on a
multi-card host each replica computes on its own card; on a one-card host
the replicas share it, each dispatching on a CUDA stream of its own, so one
replica's batch computes while the other's stages and reads back. Every
thread that runs a replica's work enters its device (``runtime.on_device``):
the device choice is per thread.
``AdaptiveBatchController`` replaces the static coalescing window with a
self-tuning one that holds queue wait ~= alpha * compute time (the
static optimum shifts with load).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
import queue as queue_mod
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import torch

from ..core import faults
from ..obs import trace as obs_trace
from ..runtime import on_device

__all__ = ["AdaptiveBatchController", "PipelinedExecutor", "Replica",
           "ReplicaSet"]

_LOG = logging.getLogger("mmlspark_tpu_torch.serving")


# ---------------------------------------------------------------------------
# Adaptive batching controller
# ---------------------------------------------------------------------------


class AdaptiveBatchController:
    """Self-tuning coalescing window: hold queue_ms ~= alpha * compute_ms.

    The static ``max_wait_ms`` has a load-dependent optimum (0 ms
    serializes requests behind full computes under load, while any wait at
    all is pure added latency for a single-stream client). Under the executor's
    slot-aware drain, BACKPRESSURE already merges convoys while every
    in-flight slot is busy — the explicit window only delays dispatch when
    a slot is FREE. So the window's job reduces to: spend at most
    ``alpha * compute`` of extra latency coalescing co-arrivals, minus the
    queue wait the load already imposes:

        window = clamp(alpha * compute_ewma - queue_ewma, min, max)

    gated on co-arrival evidence (batch-rows EWMA > 1): a single-stream
    client never pays a coalescing wait nobody else will join. At
    saturation queue_ewma ~ compute_ewma, so the window collapses to
    ``min_wait_ms`` and batching comes entirely from backpressure; under
    light concurrent load the window opens to merge near-simultaneous
    arrivals within the latency budget.
    """

    def __init__(self, alpha: float = 0.5, min_wait_ms: float = 0.0,
                 max_wait_ms: float = 50.0, init_wait_ms: float = 5.0,
                 ewma: float = 0.25, solo_rows: float = 1.2):
        self.alpha = float(alpha)
        self.min_wait_ms = float(min_wait_ms)
        self.max_wait_ms = float(max_wait_ms)
        self.ewma = float(ewma)
        #: batch-rows EWMA at or below this means "no co-arrivals": the
        #: window stays at min (waiting coalesces nothing)
        self.solo_rows = float(solo_rows)
        self._wait = min(max(float(init_wait_ms), self.min_wait_ms),
                         self.max_wait_ms)
        self._compute_ms: Optional[float] = None
        self._queue_ms: Optional[float] = None
        self._rows: Optional[float] = None
        self._depth: float = 0.0
        self._updates = 0
        self._seeded = False
        self._lock = threading.Lock()

    def window_ms(self) -> float:
        with self._lock:
            return self._wait

    def set_window_clamp(self, max_wait_ms: float) -> float:
        """Re-bound the window's upper clamp live (the brownout
        controller's knob): returns the PREVIOUS clamp so the caller can
        restore it. The current wait is re-clamped immediately."""
        with self._lock:
            prev = self.max_wait_ms
            self.max_wait_ms = max(float(max_wait_ms), self.min_wait_ms)
            self._wait = min(self._wait, self.max_wait_ms)
            return prev

    def seed_compute_ms(self, compute_ms: float) -> None:
        """Model-informed cold start (the Tuner, core/tune.py): seed the
        compute EWMA with the cost model's predicted per-batch compute so the first
        windows are sized from a prediction instead of the ``init_wait_ms``
        guess. A seed never overrides MEASURED state: once observe() has
        run, it only re-anchors the EWMA blend."""
        with self._lock:
            self._seeded = True
            if self._compute_ms is None:
                self._compute_ms = float(compute_ms)
                if self._rows is not None and self._rows > self.solo_rows:
                    w = self.alpha * self._compute_ms - (self._queue_ms or 0.0)
                    self._wait = min(self.max_wait_ms,
                                     max(self.min_wait_ms, w))
            else:
                self._compute_ms = self._ewma(self._compute_ms,
                                              float(compute_ms))

    def _ewma(self, prev: Optional[float], x: float) -> float:
        return x if prev is None else (1 - self.ewma) * prev + self.ewma * x

    def observe(self, compute_s: float, queue_s: float, batch_rows: int,
                queue_depth: int) -> None:
        """Feed one completed batch: compute+readback seconds, mean queue
        wait of its rows, its row count, and the ingress depth left behind."""
        with self._lock:
            self._updates += 1
            self._compute_ms = self._ewma(self._compute_ms, compute_s * 1e3)
            self._queue_ms = self._ewma(self._queue_ms, queue_s * 1e3)
            self._rows = self._ewma(self._rows, float(batch_rows))
            self._depth = self._ewma(self._depth, float(queue_depth))
            if self._rows <= self.solo_rows:
                w = self.min_wait_ms
            else:
                w = self.alpha * self._compute_ms - self._queue_ms
            self._wait = min(self.max_wait_ms, max(self.min_wait_ms, w))

    def state(self) -> Dict[str, Any]:
        """Live controller state for /_mmlspark/stats: the tuned window AND
        the governing knobs (alpha/min/max), so a running server's batching
        configuration is inspectable, not constructor-only."""
        with self._lock:
            rnd = lambda v: None if v is None else round(v, 4)  # noqa: E731
            return {"wait_ms": round(self._wait, 4),
                    "compute_ewma_ms": rnd(self._compute_ms),
                    "queue_ewma_ms": rnd(self._queue_ms),
                    "rows_ewma": rnd(self._rows),
                    "target_queue_ms": rnd(
                        None if self._compute_ms is None
                        else self.alpha * self._compute_ms),
                    "depth_ewma": round(self._depth, 3),
                    "alpha": self.alpha,
                    "min_wait_ms": self.min_wait_ms,
                    "max_wait_ms": self.max_wait_ms,
                    "seeded": self._seeded,
                    "updates": self._updates}


# ---------------------------------------------------------------------------
# Replicas
# ---------------------------------------------------------------------------


class Replica:
    """One placed copy of the serving transform (device + counters). On a
    CUDA device the replica dispatches on a stream of its own (``stream``,
    made on first use)."""

    __slots__ = ("index", "device", "transform", "batches", "rows", "busy_s",
                 "stream")

    def __init__(self, index: int, device: Any, transform: Callable):
        self.index = index
        self.device = device
        self.transform = transform
        self.batches = 0
        self.rows = 0
        self.busy_s = 0.0
        self.stream = None


class ReplicaSet:
    """R replicas of the serving transform placed round-robin across local
    devices (the data-parallel dispatch of Automap, arXiv:2112.02958,
    applied to whole serving batches).

    ``devices`` defaults to every visible card (a single ``None``
    pseudo-device on a host without one, keeping the executor usable for
    host-only transforms; the server resolves its devices itself and
    refuses a host without a card unless asked for the CPU).
    ``transform_factory(index, device)`` builds a per-replica transform --
    per-replica model copies; the default shares ``transform`` across
    replicas: the port's stages key their device state by device (a fused
    plan per (schema, device), the GBDT forest per device,
    ``FunctionModel.device_params`` per device), so replicas on one card
    share that card's tensors and replicas on different cards never touch
    each other's.
    """

    def __init__(self, transform: Optional[Callable] = None, n: int = 1,
                 devices: Optional[List[Any]] = None,
                 transform_factory: Optional[Callable] = None):
        if transform is None and transform_factory is None:
            raise ValueError("need transform or transform_factory")
        if devices is None:
            devices = self._local_devices()
        if not devices:
            devices = [None]
        self.replicas: List[Replica] = []
        #: placements skipped because replica init raised: (index, device,
        #: error string) — surfaced in describe()/stats so a degraded start
        #: is visible, not silent
        self.placement_failures: List[Dict[str, Any]] = []
        for i in range(max(1, int(n))):
            dev = devices[i % len(devices)]
            # a device that raises at replica init (a CUDA fault, OOM on one
            # card) must not fail the whole server start: log, skip it, and
            # serve on the survivors; raise only when nothing survives
            try:
                t = transform_factory(i, dev) \
                    if transform_factory is not None else transform
            except Exception as e:  # noqa: BLE001 — degrade, don't die
                _LOG.warning(
                    "replica %d init failed on device %s — placing the "
                    "remaining replicas without it", i, dev, exc_info=True)
                self.placement_failures.append(
                    {"replica": i, "device": str(dev) if dev is not None
                     else None, "error": str(e)})
                continue
            self.replicas.append(Replica(i, dev, t))
        if not self.replicas:
            raise RuntimeError(
                "every replica placement failed: "
                + "; ".join(f"replica {f['replica']} on {f['device']}: "
                            f"{f['error']}"
                            for f in self.placement_failures))

    def __len__(self) -> int:
        return len(self.replicas)

    @staticmethod
    def _local_devices() -> List[Any]:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]

    @staticmethod
    def device_ctx(device: Any, stream=None):
        """``runtime.on_device`` for a placed device; a no-op for the
        host-only ``None`` pseudo-device."""
        if device is None:
            return contextlib.nullcontext()
        return on_device(device, stream)

    def _replica_ctx(self, replica: Replica):
        dev = replica.device
        if dev is not None and torch.device(dev).type == "cuda" \
                and replica.stream is None:
            replica.stream = torch.cuda.Stream(torch.device(dev))
        return self.device_ctx(dev, replica.stream)

    def run(self, replica: Replica, df):
        """Full transform on the replica's device (dispatch + readback)."""
        with self._replica_ctx(replica):
            return replica.transform(df)

    def submit(self, replica: Replica, df):
        """Non-blocking dispatch when the transform supports the submit
        protocol: returns a zero-arg resolve() or None (no protocol)."""
        sub = getattr(replica.transform, "submit", None)
        if sub is None:
            return None
        with self._replica_ctx(replica):
            return sub(df)

    def describe(self, wall_s: float) -> List[Dict[str, Any]]:
        out = []
        for r in self.replicas:
            out.append({
                "replica": r.index,
                "device": str(r.device) if r.device is not None else None,
                "batches": r.batches, "rows": r.rows,
                "busy_s": round(r.busy_s, 6),
                "utilization": round(r.busy_s / wall_s, 4)
                if wall_s > 0 else None})
        return out


# ---------------------------------------------------------------------------
# Pipelined executor
# ---------------------------------------------------------------------------


_SENTINEL = object()


class PipelinedExecutor:
    """Drain/compute/readback pipeline over a ServingServer's ingress queue.

    Bounded by ``inflight`` (number of batches past drain and not yet
    fulfilled — the explicit in-flight depth knob): the drain thread
    acquires a slot before journaling/staging a batch, the readback thread
    releases it after fulfillment, and while the drain thread waits for a
    slot it keeps absorbing ingress arrivals into the forming batch
    (continuous batching).
    """

    def __init__(self, server, replica_set: ReplicaSet,
                 controller: Optional[AdaptiveBatchController] = None,
                 inflight: int = 2, timeline_cap: int = 512,
                 supervisor=None, watchdog=None):
        self.server = server
        self.replicas = replica_set
        self.controller = controller
        self.inflight = max(1, int(inflight))
        # supervision layer (serving/supervisor.py): per-replica health
        # scores + quarantine/probe/readmit, and the hung-dispatch watchdog
        # budget policy. Both optional — absent, the executor behaves
        # exactly like the unsupervised build.
        self.supervisor = supervisor
        self.watchdog = watchdog
        self._submit_q: "queue_mod.Queue" = queue_mod.Queue()
        self._ready_q: "queue_mod.Queue" = queue_mod.Queue()
        self._slots = threading.Semaphore(self.inflight)
        # pending slot reductions (set_inflight shrink): consumed at release
        # time instead of blocking the caller on a semaphore acquire
        self._shrink = 0
        self._stop = server._stop
        self._lock = threading.Lock()
        self._seq = 0
        self.epochs = 0
        self._timeline: "deque" = deque(maxlen=timeline_cap)
        self._busy = {"drain": 0.0, "readback": 0.0}
        # in-flight dispatch registry for the watchdog scan: replica index
        # -> [prep, gen, t0, budget_s]; an entry doubles as the completion
        # claim token — whoever removes it under the lock owns the outcome
        self._dispatch: Dict[int, list] = {}
        # pipeline-active wall clock: accumulates only while >= 1 batch is in
        # flight, so overlap_ratio is not diluted by idle-server time
        self._active = 0
        self._active_t0 = 0.0
        self._active_wall = 0.0
        self.threads: List[threading.Thread] = []

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "PipelinedExecutor":
        name = self.server.name
        self.threads = [threading.Thread(target=self._drain_loop, daemon=True,
                                         name=f"{name}-drain")]
        for r in self.replicas.replicas:
            self.threads.append(threading.Thread(
                target=self._compute_loop, args=(r,), daemon=True,
                name=f"{name}-compute-{r.index}"))
        self.threads.append(threading.Thread(
            target=self._readback_loop, daemon=True, name=f"{name}-readback"))
        if self.watchdog is not None:
            self.threads.append(threading.Thread(
                target=self._watchdog_loop, daemon=True,
                name=f"{name}-watchdog"))
        for t in self.threads:
            t.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Join the pipeline: the server has already set ``_stop`` (and, on
        graceful drain, waited for in-flight slots to empty). Sentinels
        flush the stage queues so workers exit after finishing queued work."""
        self.server._wake.set()
        for t in self.threads:
            if t.name.endswith("-drain"):
                t.join(timeout=timeout)
        for _ in self.replicas.replicas:
            self._submit_q.put(_SENTINEL)
        for t in self.threads:
            if "-compute-" in t.name:
                t.join(timeout=timeout)
        self._ready_q.put(_SENTINEL)
        for t in self.threads:
            if t.name.endswith("-readback") or t.name.endswith("-watchdog"):
                t.join(timeout=timeout)

    # -- bookkeeping -----------------------------------------------------
    def _mark(self, stage: str, seq: int, t0: float, t1: float,
              replica: Optional[int] = None) -> None:
        with self._lock:
            self._timeline.append({"stage": stage, "seq": seq,
                                   "t0": t0, "t1": t1, "replica": replica})

    def timeline(self) -> List[Dict[str, Any]]:
        """Recent (stage, seq, t0, t1, replica) events — overlap forensics."""
        with self._lock:
            return list(self._timeline)

    def _enter_pipe(self) -> None:
        with self._lock:
            if self._active == 0:
                self._active_t0 = time.perf_counter()
            self._active += 1

    def _exit_pipe(self) -> None:
        with self._lock:
            self._active -= 1
            if self._active == 0:
                self._active_wall += time.perf_counter() - self._active_t0

    # -- stage 1: drain / coalesce / journal -----------------------------
    def _gather(self, first) -> Optional[list]:
        """Continuous batching: coalesce a batch AND acquire an in-flight
        slot, with the two waits merged. While every slot is busy,
        coalescing is free — the batch keeps absorbing arrivals with no
        dispatch to delay (this is where convoys merge under load). Once a
        slot is held, only the adaptive window keeps the batch open, so a
        free device never idles behind a coalescing sleep (the static
        ``max_wait_ms`` tax the sync loop pays every cycle). Returns the
        batch with the slot HELD, or None on stop (slot released)."""
        srv = self.server
        batch = [first]
        window = self.controller.window_ms() \
            if self.controller is not None else srv.max_wait_ms
        deadline = time.perf_counter() + window / 1000.0
        acquired = self._slots.acquire(blocking=False)
        while len(batch) < srv.max_batch_size:
            if self._stop.is_set():
                break
            now = time.perf_counter()
            if acquired:
                remaining = deadline - now
                if remaining <= 0:
                    break
                try:
                    batch.append(srv._queue.get(timeout=remaining))
                except queue_mod.Empty:
                    break
            else:
                while len(batch) < srv.max_batch_size:
                    try:
                        batch.append(srv._queue.get_nowait())
                    except queue_mod.Empty:
                        break
                acquired = self._slots.acquire(timeout=0.002)
        while not acquired:  # batch full (or stopping): still need the slot
            if self._stop.is_set():
                break
            acquired = self._slots.acquire(timeout=0.002)
        if self._stop.is_set() and not acquired:
            for item in batch:  # hard stop: requeue, do not strand
                srv._queue.put(item)
            return None
        return batch

    def _drain_loop(self) -> None:
        srv = self.server
        while not self._stop.is_set():
            first = srv._next_request()
            if first is None:
                continue
            t_c0 = time.perf_counter()
            batch = self._gather(first)
            if batch is None:
                return
            self._enter_pipe()
            t_w0 = time.time()
            t_p0 = time.perf_counter()
            prep = srv._prepare_batch(batch)
            t_p1 = time.perf_counter()
            if prep is None:  # every request expired while queued
                self._release_slot()
                self._exit_pipe()
                continue
            with self._lock:
                self._seq += 1
                prep.seq = self._seq
                self._busy["drain"] += t_p1 - t_p0
            self._mark("drain", prep.seq, t_c0, t_p1)
            srv._trace_batch("drain", prep, t_w0, t_p1 - t_p0)
            self._submit_q.put(prep)

    # -- stage 2: compute (one worker per replica) -----------------------
    def _compute_loop(self, replica: Replica) -> None:
        srv = self.server
        sup = self.supervisor
        while True:
            if sup is not None and not sup.admitted(replica.index):
                # quarantined: no submit-queue pulls until a probe succeeds
                if self._stop.is_set():
                    return
                if sup.probe_due(replica.index):
                    sup.begin_probe(replica.index)
                    sup.note_probe(replica.index,
                                   sup.run_probe(replica))
                else:
                    time.sleep(0.005)
                continue
            prep = self._submit_q.get()
            if prep is _SENTINEL:
                return
            # in-flight deadline gate: a request whose deadline expired while
            # the batch sat staged gets its 504 NOW, pre-dispatch
            prep = srv._regate_inflight(prep)
            if prep is None:
                self._release_slot()
                self._exit_pipe()
                continue
            t_w0 = time.time()
            t0 = time.perf_counter()
            budget = None
            if self.watchdog is not None:
                # a tuned K-step mega-dispatch runs up to K micro-batches in
                # one Python-level call; scale the budget so it isn't read
                # as a hang (serve_pipeline attaches the hint)
                hint = getattr(replica.transform, "mega_k", None)
                try:
                    batches = int(hint() if callable(hint) else hint or 1)
                except Exception:  # noqa: BLE001 — hint must not kill loop
                    batches = 1
                budget = self.watchdog.budget_s(prep.n, batches=batches)
            with self._lock:
                gen = prep.wd_gen
                self._dispatch[replica.index] = [prep, gen, t0, budget]
            pending = out = err = None
            try:
                # chaos seams: a delay plan on WORKER_DISPATCH_HANG wedges
                # this dispatch (the watchdog's prey); a raising plan on
                # WORKER_CRASH simulates the replica dying mid-dispatch
                faults.fire(faults.WORKER_DISPATCH_HANG,
                            replica=replica.index, seq=prep.seq)
                faults.fire(faults.WORKER_CRASH,
                            replica=replica.index, seq=prep.seq)
                # batch_context: traced requests visible to the H2D staging
                # and fused-segment layers under this dispatch
                with obs_trace.batch_context(srv.tracer,
                                             list(prep.ctxs.values())):
                    pending = self.replicas.submit(replica, prep.df)
                    if pending is None:
                        out = self.replicas.run(replica, prep.df)
            except Exception as e:  # noqa: BLE001 — batch fails, not server
                err = e
            t1 = time.perf_counter()
            with self._lock:
                # completion claim: if the watchdog already expired this
                # dispatch (gen bumped, registry entry gone), the result is
                # STALE — the re-dispatched copy owns the slot and replies
                live = prep.wd_gen == gen and \
                    self._dispatch.pop(replica.index, [None, -1])[1] == gen
                replica.busy_s += t1 - t0
                if live:
                    replica.batches += 1
                    replica.rows += prep.n
            if sup is not None:
                if err is not None:
                    sup.note_failure(replica.index)
                else:
                    sup.note_success(replica.index, t1 - t0)
            if not live:
                # late return of a wedged dispatch: discard the result; the
                # supervisor's probe path decides re-admission from here
                self._mark("stale", prep.seq, t0, t1, replica.index)
                continue
            if err is None and self.watchdog is not None:
                self.watchdog.observe(t1 - t0)
            self._mark("compute", prep.seq, t0, t1, replica.index)
            srv._trace_batch("dispatch", prep, t_w0, t1 - t0,
                             replica=replica.index)
            self._ready_q.put((prep, pending, out, err, t1 - t0,
                               replica.device))

    # -- hung-dispatch watchdog ------------------------------------------
    def _watchdog_loop(self) -> None:
        wd = self.watchdog
        while not self._stop.wait(wd.poll_s):
            self._watchdog_scan()

    def _watchdog_scan(self, now: Optional[float] = None) -> None:
        """One watchdog pass over the in-flight dispatch registry. A
        dispatch past its wall budget is WEDGED: claim it (bump the prep's
        generation so the stuck thread's eventual return is discarded),
        quarantine the replica, and either re-dispatch the batch on a
        healthy peer or — when none exists — double the budget in place a
        few times before abandoning with an accounted 504. Exposed with a
        ``now`` override so chaos tests can drive scans deterministically."""
        wd = self.watchdog
        if now is None:
            now = time.perf_counter()
        requeue, extend, abandon = [], [], []
        with self._lock:
            for idx, entry in list(self._dispatch.items()):
                prep, gen, t0, budget = entry
                if budget is None or now - t0 <= budget:
                    continue
                if prep.wd_gen != gen:
                    continue
                peers = len(self.replicas.replicas) - 1 \
                    if self.supervisor is None \
                    else self.supervisor.healthy_peers(idx)
                if peers > 0 and prep.wd_tries < wd.max_redispatch:
                    prep.wd_gen += 1
                    prep.wd_tries += 1
                    del self._dispatch[idx]
                    requeue.append((idx, prep))
                elif prep.wd_expiries + 1 < wd.abandon_after:
                    # no healthy peer: keep waiting with a doubled budget —
                    # a long first-compile must not become a false 504
                    prep.wd_expiries += 1
                    entry[3] = budget * 2.0
                    entry[2] = now
                    extend.append(idx)
                else:
                    prep.wd_gen += 1
                    del self._dispatch[idx]
                    abandon.append((idx, prep))
        for idx, prep in requeue:
            # supervisor/journal work OUTSIDE the executor lock
            if self.supervisor is not None:
                self.supervisor.note_wedged(idx)
            wd.note_trip("requeue")
            _LOG.warning("dispatch on replica %d wedged (seq %d): "
                         "re-dispatching on a healthy replica", idx, prep.seq)
            self._submit_q.put(prep)
        for idx in extend:
            wd.note_trip("extend")
        for idx, prep in abandon:
            if self.supervisor is not None:
                self.supervisor.note_wedged(idx)
            wd.note_trip("abandon")
            _LOG.warning("dispatch on replica %d wedged (seq %d) with no "
                         "healthy peer: abandoning batch with 504s",
                         idx, prep.seq)
            self._abandon(prep)

    def _abandon(self, prep) -> None:
        """Answer every request of a wedged batch 504 with an accounted
        reason, release its slot, and sweep the journal — the batch's epoch
        commits once the abandoned slots are popped (at-least-once: a crash
        before this point replays the batch, which is the contract)."""
        srv = self.server
        for rid in prep.ids:
            srv.stats.record_shed(504, "watchdog_abandoned")
            srv._fulfill(int(rid), 504,
                         b'{"error": "dispatch watchdog expired"}',
                         content_type="application/json")
        self._release_slot()
        self._exit_pipe()
        srv._maybe_commit_epochs()

    # -- stage 3: readback / fulfill -------------------------------------
    def _readback_loop(self) -> None:
        srv = self.server
        while True:
            item = self._ready_q.get()
            if item is _SENTINEL:
                return
            prep, pending, out, err, compute_s, device = item
            t_w0 = time.time()
            t0 = time.perf_counter()
            if err is not None:
                srv._fail_batch(prep.ids, err)
            else:
                try:
                    if pending is not None:
                        # resolve waits on the events its submit recorded,
                        # never on this thread's stream
                        with ReplicaSet.device_ctx(device):
                            out = pending()
                    srv._apply_output(prep.ids, out)
                except Exception as e:  # noqa: BLE001
                    srv._fail_batch(prep.ids, e)
            t1 = time.perf_counter()
            with self._lock:
                self._busy["readback"] += t1 - t0
                self.epochs += 1
            self._mark("readback", prep.seq, t0, t1)
            srv._trace_batch("readback", prep, t_w0, t1 - t0)
            self._release_slot()
            self._exit_pipe()
            if self.controller is not None:
                self.controller.observe(compute_s + (t1 - t0), prep.queue_s,
                                        prep.n, srv._queue.qsize())
            srv._maybe_commit_epochs()
            srv._tuner_tick(prep.queue_s + compute_s + (t1 - t0))

    # -- live knobs ------------------------------------------------------
    def set_inflight(self, n: int) -> None:
        """Re-bound the in-flight depth live (the Tuner's knob,
        core/tune.py). Growth releases permits immediately; shrink takes
        effect as in-flight batches complete (their releases are consumed
        instead of returned), so the hot path never blocks on a resize."""
        n = max(1, int(n))
        grow = 0
        with self._lock:
            delta = n - self.inflight
            if delta == 0:
                return
            self.inflight = n
            if delta > 0:
                cancel = min(self._shrink, delta)
                self._shrink -= cancel
                grow = delta - cancel
            else:
                self._shrink += -delta
        for _ in range(grow):
            self._slots.release()

    def _release_slot(self) -> None:
        with self._lock:
            if self._shrink > 0:
                self._shrink -= 1
                return
        self._slots.release()

    # -- stats surface (/_mmlspark/stats "async" section) ----------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            wall = self._active_wall
            if self._active > 0:
                wall += time.perf_counter() - self._active_t0
            drain_s = self._busy["drain"]
            readback_s = self._busy["readback"]
            epochs = self.epochs
            active = self._active
        compute_s = sum(r.busy_s for r in self.replicas.replicas)
        serial = drain_s + compute_s + readback_s
        supervisor = None
        if self.supervisor is not None:
            supervisor = self.supervisor.summary()
        watchdog = None
        if self.watchdog is not None:
            watchdog = self.watchdog.summary()
        return {
            "mode": "pipelined",
            "inflight": self.inflight,
            # supervision layer (serving/supervisor.py): per-replica health
            # states + watchdog trip counters; None when supervision is off
            "supervisor": supervisor,
            "watchdog": watchdog,
            "placement_failures": self.replicas.placement_failures or None,
            # batches currently past drain and not yet fulfilled: the live
            # slot occupancy (== inflight means the pipeline is saturated
            # — the perf-attribution companion to the ring gauges)
            "inflight_active": active,
            "epochs": epochs,
            "replicas": self.replicas.describe(wall),
            "controller": self.controller.state()
            if self.controller is not None else None,
            "busy_s": {"drain": round(drain_s, 6),
                       "compute": round(compute_s, 6),
                       "readback": round(readback_s, 6)},
            "active_wall_s": round(wall, 6),
            # > 1.0 means stages genuinely overlapped (stage-busy seconds
            # exceed the wall time the pipeline was occupied); 1.0 = serial
            "overlap_ratio": round(serial / wall, 4) if wall > 0 else None,
        }
