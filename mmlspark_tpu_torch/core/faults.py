"""Fault tolerance: retry policy, deadlines, fault injection, and durable
atomic file writes.

Counterpart of the reference's ``mmlspark_tpu/core/faults.py``:

  - ``RetryPolicy``    -- jittered exponential backoff with a total sleep
    budget and deadline awareness (``io/http.send_with_retries``, the
    reply hop, the routing front's forwards and probes).
  - ``Deadline``       -- absolute wall-clock deadline carried end to end in
    the ``X-MMLSpark-Deadline`` header (epoch seconds): expired requests are
    answered 504 before they take a batch slot.
  - ``FaultInjector``  -- deterministic, seedable chaos: named injection
    points (HTTP send, worker forward, journal write/commit, dispatch hang,
    replica crash, front hedge, train step, CSR staging) so a chaos
    scenario replays exactly under a fixed seed.
  - atomic-file helpers (tmp + rename + fsync) shared by the journal
    compactor and GBDT checkpoints.

``install(hook)`` also takes any callable ``hook(point, **ctx)``: the GBDT
boost loop fires ``TRAIN_STEP`` at the top of every iteration, and the
fused executor fires ``SPARSE_STAGE`` before it stages a sparse column as a
CSR triple, taking its accounted densify fallback when the hook raises
``InjectedFault`` (``core/fusion.py`` ``_stage_csr``). The points of the
planes that are not ported (compile-cache tiers, mesh, lifecycle, fabric,
model mall) keep their names so a chaos plan reads the same in both
packages.
"""

from __future__ import annotations

import dataclasses
import errno
import os
import random
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------

#: header carrying the absolute request deadline (unix epoch seconds, float)
DEADLINE_HEADER = "X-MMLSpark-Deadline"


class Deadline:
    """Absolute wall-clock deadline (epoch seconds). Propagates across
    machines via ``X-MMLSpark-Deadline`` — absolute time, not a countdown, so
    queue/transfer delays between hops count against it."""

    __slots__ = ("at",)

    def __init__(self, at: float):
        self.at = float(at)

    @classmethod
    def from_timeout(cls, seconds: float) -> "Deadline":
        return cls(time.time() + seconds)

    @staticmethod
    def from_header(value: Optional[str]) -> Optional["Deadline"]:
        if not value:
            return None
        try:
            return Deadline(float(value))
        except (TypeError, ValueError):
            return None

    def to_header(self) -> str:
        return repr(self.at)

    def remaining(self) -> float:
        return max(0.0, self.at - time.time())

    def expired(self) -> bool:
        return time.time() >= self.at

    def cap(self, wait: float) -> float:
        """Clamp a candidate sleep/timeout to the time left."""
        return min(wait, self.remaining())

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return f"Deadline(at={self.at!r}, remaining={self.remaining():.3f}s)"


def deadline_from_headers(headers: Optional[Mapping[str, str]]
                          ) -> Optional[Deadline]:
    """Case-insensitive ``X-MMLSpark-Deadline`` lookup on any mapping
    (http.client message objects and plain dicts alike)."""
    if not headers:
        return None
    get = getattr(headers, "get", None)
    if get is not None:
        v = get(DEADLINE_HEADER) or get(DEADLINE_HEADER.lower())
        if v is not None:
            return Deadline.from_header(v)
    low = DEADLINE_HEADER.lower()
    for k in headers:
        if str(k).lower() == low:
            return Deadline.from_header(headers[k])
    return None


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff with a retry budget and deadline cap.

    ``jitter`` is the +/- fraction applied to each backoff (0.2 => +/-20%);
    with ``seed`` set the jitter stream is deterministic (chaos replay).
    ``budget_s`` bounds the TOTAL time slept across all retries of one call.
    """

    max_retries: int = 3
    base_s: float = 0.1
    multiplier: float = 2.0
    max_backoff_s: float = 30.0
    jitter: float = 0.2
    budget_s: Optional[float] = None
    seed: Optional[int] = None

    def make_rng(self) -> random.Random:
        return random.Random(self.seed)  # Random(None) seeds from entropy

    def next_wait(self, attempt: int,
                  rng: Optional[random.Random] = None) -> float:
        """Backoff for ``attempt`` (0-based), jittered."""
        base = min(self.base_s * (self.multiplier ** attempt),
                   self.max_backoff_s)
        if self.jitter <= 0:
            return base
        r = rng if rng is not None else self.make_rng()
        return max(0.0, base * (1.0 + self.jitter * r.uniform(-1.0, 1.0)))

    def backoffs(self, deadline: Optional[Deadline] = None):
        """Yield up to ``max_retries`` jittered waits, stopping early when the
        sleep budget or the deadline is exhausted. Each yielded wait is
        already capped at the remaining budget/deadline."""
        rng = self.make_rng()
        spent = 0.0
        for attempt in range(self.max_retries):
            wait = self.next_wait(attempt, rng)
            if self.budget_s is not None:
                left = self.budget_s - spent
                if left <= 0:
                    return
                wait = min(wait, left)
            if deadline is not None:
                left = deadline.remaining()
                if left <= 0:
                    return
                wait = min(wait, left)
            spent += wait
            yield wait

    def run(self, fn: Callable[[], Any], *,
            should_retry: Callable[[BaseException], bool] = lambda e: True,
            deadline: Optional[Deadline] = None,
            sleep_fn: Callable[[float], None] = time.sleep) -> Any:
        """Call ``fn`` with retries; re-raises the last error when the retry
        budget / deadline / attempt count is exhausted."""
        last: Optional[BaseException] = None
        waits = self.backoffs(deadline)
        while True:
            try:
                return fn()
            except BaseException as e:  # noqa: BLE001 - policy decides
                last = e
                if not should_retry(e):
                    raise
            try:
                wait = next(waits)
            except StopIteration:
                raise last
            sleep_fn(wait)


# ---------------------------------------------------------------------------
# FaultInjector
# ---------------------------------------------------------------------------

# Named injection points (the instrumented seams of the framework):
HTTP_SEND = "http.send"            # io/http.send_request, before the socket
WORKER_FORWARD = "worker.forward"  # serving/routing forward-to-worker
INGEST_H2D = "ingest.h2d"          # parallel/ingest TransferRing staging
JOURNAL_WRITE = "journal.write"    # serving/journal entry append
JOURNAL_COMMIT = "journal.commit"  # serving/journal epoch commit
TRAIN_STEP = "train.step"          # gbdt boosting iteration / DNN train step
TUNER_MEASURE = "tuner.measure"    # core/tune Tuner's e2e measurement probe
# serving/executor replica compute loop, just before dispatch: plan with
# delay_s + exc=None to wedge a dispatch (the watchdog's deterministic prey)
WORKER_DISPATCH_HANG = "worker.dispatch_hang"
# serving/executor replica compute loop: a raising plan simulates a replica
# process crash mid-dispatch (feeds the supervisor's error scoring)
WORKER_CRASH = "worker.crash"
# serving/routing hedge launch (threaded + async fronts): a raising plan
# suppresses that hedge; fired() observes exactly which requests hedged
FRONT_HEDGE = "front.hedge"
# serving/fleet persistent compile-cache tier: load fires before an entry
# is read/deserialized (a raising plan = corrupted/unreadable entry ->
# accounted recompile); store fires before the atomic write (a raising
# plan = full/readonly cache volume -> serving continues uncached)
COMPILECACHE_LOAD = "compilecache.load"
COMPILECACHE_STORE = "compilecache.store"
# parallel/shardplan SegmentSharding.device_put, before a host batch is
# staged across the mesh: a raising plan simulates a chip dropping out of
# its shard group mid-stage (the executor degrades that dispatch to the
# host fallback; MeshSupervision quarantines the GROUP and re-plans onto
# the surviving submesh); delay_s wedges the sharded dispatch for the
# mesh-aware watchdog. Fires on the SHARDED path only — unsharded
# bitwise-parity is never perturbed by an armed plan.
MESH_CHIP_WEDGE = "mesh.chip_wedge"
# serving/lifecycle registry swap_live, fired BEFORE any registry or
# executor state mutates: a raising plan is a crash mid-swap and must
# leave the incumbent serving with the candidate un-promoted
LIFECYCLE_SWAP = "lifecycle.swap"
# serving/lifecycle OnlineTrainer, fired before the atomic checkpoint
# write: a raising plan crashes training at checkpoint k; resume() +
# journal replay must reproduce the uninterrupted state bitwise
LIFECYCLE_CHECKPOINT = "lifecycle.checkpoint"
# core/tune Tuner.apply, fired MID-SWAP of a kernel-variant/stitch knob
# change (tuner state updated, fused model not yet pushed): a raising plan
# must leave the incumbent variant serving bitwise-identical replies
TUNER_KERNEL_APPLY = "tuner.kernel_apply"
# serving/fabric L1 front forwarding to an L2 cell (fires only when the
# fabric is enabled, just before the forward): a raising plan is a cell
# dying mid-request — InjectedFault reads as a connection-class "error"
# (replay-safe), so the L1 re-hashes the tenant onto the survivor and the
# reply must be bitwise-identical to a single-front retry
FRONT_L2_CRASH = "front.l2_crash"
# serving/fabric ring membership change, fired BEFORE the epoch mutates:
# a raising plan is a crash mid-rebalance and must leave the journaled
# previous epoch serving (membership, points and epoch all unchanged)
RING_REBALANCE = "ring.rebalance"
# serving/fleet object store put/get, fired before the backend I/O: a
# raising put is a full/unreachable store (tier degrades to accounted
# read-only, serving continues uncached); a raising get is a corrupted /
# unavailable object (accounted recompile)
STORE_PUT = "store.put"
STORE_GET = "store.get"
# core/fusion CSR staging, fired before a sparse column is assembled into
# its (indptr, indices, values) wire triple: a raising plan degrades THAT
# column to the accounted densify fallback (IngestStats.note_densify) —
# output stays bitwise-equal to the dense path, the waste is just counted.
# Fires on the CSR path only — densify-path parity is never perturbed.
SPARSE_STAGE = "sparse.stage"
# parallel/pipeplan PipeRunner, fired per micro-batch before each stage's
# dispatch (ctx: stage=<index>): a raising plan simulates a stage's whole
# sub-mesh dropping out mid-stream — the model quarantines the stage and
# re-plans at depth N-1 over the surviving sub-meshes, re-running the
# in-flight partition (no request dropped); delay_s wedges the stream for
# the watchdog. Fires on the PIPELINED path only — with the pipe_depth
# knob off an armed plan never perturbs the serial bitwise-parity path.
PIPE_STAGE_WEDGE = "pipe.stage_wedge"
# serving/multimodel ModelMall trial/version promotion, fired BEFORE the
# per-model registry swap mutates (the mall's analogue of LIFECYCLE_SWAP,
# with model= in the context): a raising plan is a crash mid-promotion and
# must leave the model's incumbent version serving bitwise
MALL_SWAP = "mall.swap"
# serving/multimodel ModelMall cold-model eviction, fired AFTER the plane
# is parked to the persistent/object-store tier but BEFORE the resident
# copy is dropped: a raising plan is a crash mid-evict — the resident copy
# is lost either way, but the tier copy (written first) survives, so the
# model stays servable through an accounted re-warm on its next request;
# a model is never stranded half-evicted
MALL_EVICT = "mall.evict"

ALL_POINTS = (HTTP_SEND, WORKER_FORWARD, INGEST_H2D, JOURNAL_WRITE,
              JOURNAL_COMMIT, TRAIN_STEP, TUNER_MEASURE,
              WORKER_DISPATCH_HANG, WORKER_CRASH, FRONT_HEDGE,
              COMPILECACHE_LOAD, COMPILECACHE_STORE, MESH_CHIP_WEDGE,
              LIFECYCLE_SWAP, LIFECYCLE_CHECKPOINT, TUNER_KERNEL_APPLY,
              FRONT_L2_CRASH, RING_REBALANCE, STORE_PUT, STORE_GET,
              SPARSE_STAGE, PIPE_STAGE_WEDGE, MALL_SWAP, MALL_EVICT)


class InjectedFault(OSError):
    """Raised by an armed injection point. Subclasses OSError so transport-
    level seams (worker forward, HTTP send) treat it as a connection-class
    failure and exercise their real retry/eviction paths."""


class InjectedDiskFull(InjectedFault):
    """Injected fault carrying ``errno.ENOSPC``: plan with ``exc=
    InjectedDiskFull`` at a write seam (``store.put``, ``journal.write``)
    to drive the disk-full degrade path — the consumer must flip to
    accounted read-only mode, never crash the serving loop."""

    def __init__(self, *args: Any):
        super().__init__(*args)
        self.errno = errno.ENOSPC


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: fire on exact call indices (``at``, 1-based), every
    Nth call (``every``), or with probability ``p`` (seeded — deterministic).
    ``times`` caps total fires (-1 = unlimited). ``delay_s`` sleeps at the
    point; ``exc`` (when not None) then raises."""

    point: str
    at: Tuple[int, ...] = ()
    every: int = 0
    p: float = 0.0
    times: int = -1
    delay_s: float = 0.0
    exc: Optional[type] = InjectedFault
    message: str = ""


class FaultInjector:
    """Deterministic, seedable chaos injector.

    Usage::

        with FaultInjector(seed=7).plan(faults.WORKER_FORWARD, at=(1,)):
            ...   # first worker forward fails with InjectedFault

    Same seed + same plan => the identical fault sequence, so a chaos
    scenario replays exactly. Thread-safe: counters are lock-guarded (the
    instrumented seams run on server/producer threads).
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._specs: Dict[str, FaultSpec] = {}
        self._calls: Dict[str, int] = {}
        self._fires: Dict[str, int] = {}
        self._rngs: Dict[str, random.Random] = {}
        self._log: List[Tuple[str, int, Dict[str, Any]]] = []
        self._lock = threading.Lock()
        self._prev: Optional["FaultInjector"] = None

    def plan(self, point: str, *, at: Tuple[int, ...] = (), every: int = 0,
             p: float = 0.0, times: int = -1, delay_s: float = 0.0,
             exc: Optional[type] = InjectedFault,
             message: str = "") -> "FaultInjector":
        self._specs[point] = FaultSpec(point, tuple(at), every, p, times,
                                       delay_s, exc, message)
        # per-point deterministic stream: stable across runs and independent
        # of arming order
        self._rngs[point] = random.Random(
            self.seed ^ zlib.crc32(point.encode("utf-8")))
        return self

    # -- firing (called from instrumented library code via module fire()) --
    def check(self, point: str, **ctx: Any) -> None:
        spec = self._specs.get(point)
        if spec is None:
            return
        with self._lock:
            n = self._calls.get(point, 0) + 1
            self._calls[point] = n
            should = False
            if spec.times < 0 or self._fires.get(point, 0) < spec.times:
                if spec.at and n in spec.at:
                    should = True
                elif spec.every and n % spec.every == 0:
                    should = True
                elif spec.p > 0 and self._rngs[point].random() < spec.p:
                    should = True
            if should:
                self._fires[point] = self._fires.get(point, 0) + 1
                self._log.append((point, n, dict(ctx)))
        if not should:
            return
        if spec.delay_s > 0:
            time.sleep(spec.delay_s)
        if spec.exc is not None:
            raise spec.exc(spec.message
                           or f"injected fault at {point!r} (call #{n})")

    #: an injector is itself a hook: ``fire`` calls ``_ACTIVE(point, **ctx)``
    __call__ = check

    # -- introspection -----------------------------------------------------
    def fired(self, point: Optional[str] = None
              ) -> List[Tuple[str, int, Dict[str, Any]]]:
        with self._lock:
            return [e for e in self._log if point is None or e[0] == point]

    def calls(self, point: str) -> int:
        with self._lock:
            return self._calls.get(point, 0)

    # -- lifecycle ---------------------------------------------------------
    def install(self) -> "FaultInjector":
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        _ACTIVE = self._prev
        self._prev = None

    def __enter__(self) -> "FaultInjector":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


#: ``hook(point, **ctx)`` -- a FaultInjector or any callable that raises to
#: simulate a fault at ``point``
_ACTIVE: Optional[Callable[..., None]] = None


def active() -> Optional[Callable[..., None]]:
    return _ACTIVE


def install(hook: Optional[Callable[..., None]]) -> Optional[Callable[..., None]]:
    """Install ``hook`` as the active injector (None removes it); returns
    the previous one so callers can restore it."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, hook
    return prev


def fire(point: str, **ctx: Any) -> None:
    """Injection-point hook: no-op unless an injector is installed (one None
    check on the hot path)."""
    hook = _ACTIVE
    if hook is not None:
        hook(point, **ctx)


# ---------------------------------------------------------------------------
# Atomic file helpers (shared by journal compaction and GBDT checkpoints)
# ---------------------------------------------------------------------------


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss. Best
    effort: some filesystems/platforms reject O_RDONLY dir fsync."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_text(path: str, text: str) -> None:
    """Durable atomic file write: tmp in the same directory + flush + fsync +
    rename + directory fsync. A crash at any point leaves either the old
    complete file or the new complete file — never a torn one."""
    d = os.path.dirname(os.path.abspath(path))
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(text)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    fsync_dir(d)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Binary sibling of :func:`atomic_write_text`: tmp in the same
    directory + flush + fsync + rename + directory fsync."""
    d = os.path.dirname(os.path.abspath(path))
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    fsync_dir(d)
