"""Self-healing serving runtime: supervision, watchdogs, hedging, brownout.

Counterpart of the reference's ``mmlspark_tpu/serving/supervisor.py``,
ported whole. "The Tail at Scale" (Dean & Barroso, CACM 2013) catalogs the standard cures
for stragglers and wedged components in a serving fleet: detect outliers,
eject and probe them, hedge slow requests, and degrade gracefully instead of
falling over. Retries, circuit breakers, bounded admission and journaled
epochs *react to errors*; this module adds the layer that *detects and repairs silent failure*: a dispatch
that hangs (device wedge, runaway host stage) burns its deadline without
ever raising, and nothing ejects the replica it wedged on.

Four cooperating pieces, all wired by ``ServingServer`` / ``RoutingFront``:

  - ``ReplicaSupervisor`` — per-replica health accounting for the pipelined
    executor (serving/executor.py): successes, errors, wall-clock latency
    outliers, and wedges feed a decayed health score; a replica that wedges
    (or fails ``max_failures`` consecutive dispatches) is QUARANTINED —
    excluded from the submit queue — and re-admitted only after a PROBE
    succeeds, on a backoff schedule. Mirrors the front's worker circuit
    breaker (serving/routing.py closed/open/half_open), one level down.
  - ``DispatchWatchdog`` — a wall-clock budget per in-flight dispatch,
    derived from a cost model's ``predict_ms`` when one is wired (the
    serving Tuner's ``predict_batch_ms``, core/tune.py) and from a compute
    EWMA otherwise;
    an expired dispatch is marked wedged and its batch re-dispatched on a
    healthy replica (the executor owns the requeue mechanics).
  - ``HedgeTracker`` — hedged-request policy for the RoutingFront: after a
    delay set to a configured quantile of observed forward latency, the
    front re-issues the request to a second worker and the first response
    wins. Duplicate work is bounded by construction: only requests slower
    than the quantile hedge at all.
  - ``BrownoutController`` — declared degradation steps driven by the SLO
    burn rate (obs/perf.py SLOTracker): when the error budget burns past
    ``enter_burn``, apply the next step (shrink the batch window, demote
    optional fused segments to host, tighten admission quotas); restore
    hysteretically when the burn drops below ``exit_burn``. Every
    transition is journaled with one-step rollback.

Everything here is OFF-path when idle: with no faults injected and brownout
disabled, plans, batch windows, and serving replies are bitwise-identical
to the unsupervised build (enforced by the parity tests).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["BrownoutController", "BrownoutStep", "DispatchWatchdog",
           "HedgeConfig", "HedgeTracker", "ReplicaSupervisor", "make_hedge"]

#: replica health states (supervisor mirror of the routing circuit breaker)
HEALTHY = "healthy"          # admitted: pulls batches from the submit queue
QUARANTINED = "quarantined"  # ejected: wedged or error-scored out; waiting
PROBING = "probing"          # probe in flight: one success re-admits

REPLICA_STATES = (HEALTHY, QUARANTINED, PROBING)


class _ReplicaHealth:
    """Mutable per-replica record (guarded by the supervisor's lock)."""

    __slots__ = ("state", "successes", "errors", "timeouts", "outliers",
                 "consecutive", "score", "compute_ewma", "quarantined_at",
                 "probe_attempt", "ejections", "readmissions", "last_reason")

    def __init__(self):
        self.state = HEALTHY
        self.successes = 0
        self.errors = 0
        self.timeouts = 0      # wedged dispatches (watchdog expiries)
        self.outliers = 0      # completions past outlier_k x the EWMA
        self.consecutive = 0   # consecutive failures (resets on success)
        self.score = 1.0       # decayed health score in [0, 1]
        self.compute_ewma: Optional[float] = None
        self.quarantined_at = 0.0
        self.probe_attempt = 0
        self.ejections = 0
        self.readmissions = 0
        self.last_reason: Optional[str] = None


class ReplicaSupervisor:
    """Health scores + eject/probe/readmit state machine over the executor's
    replicas.

    ``probe_fn(replica) -> bool`` (optional) runs a real synthetic dispatch
    during re-admission; the default probe is a LIVENESS probe — for a
    wedged replica the only possible evidence is its stuck thread returning
    at all, so a clean late return after the quarantine cooldown counts as
    probe success. ``quarantine_s`` is the base cooldown; repeated probe
    failures back off exponentially (capped at 16x).
    """

    def __init__(self, replicas: Any, max_failures: int = 3,
                 quarantine_s: float = 1.0, outlier_k: float = 4.0,
                 decay: float = 0.85,
                 probe_fn: Optional[Callable[[Any], bool]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.max_failures = max(1, int(max_failures))
        self.quarantine_s = float(quarantine_s)
        self.outlier_k = float(outlier_k)
        self.decay = float(decay)
        self.probe_fn = probe_fn
        self._clock = clock
        self._lock = threading.Lock()
        # ``replicas``: a replica count, or the iterable of PLACED replica
        # indices (placement skips can leave gaps — a ghost record for a
        # never-placed replica would inflate healthy_peers)
        if isinstance(replicas, int):
            indices = range(max(1, replicas))
        else:
            indices = [int(i) for i in replicas]
        self._replicas: Dict[int, _ReplicaHealth] = {
            int(i): _ReplicaHealth() for i in indices}
        # mesh awareness (parallel/shardplan.py shard_groups): index ->
        # the frozen group of indices that fail TOGETHER (one mesh slice).
        # Empty = every replica is its own group (the pre-mesh behavior).
        self._groups: Dict[int, Tuple[int, ...]] = {}
        # pipeline awareness (parallel/pipeplan.py PipeSupervision): the
        # registered stage device groups, in stage order. Empty until a
        # pipe plan registers — nothing changes for unpipelined serving.
        self._pipe_stages: List[Tuple[int, ...]] = []

    def set_shard_groups(self, groups) -> None:
        """Register the mesh's shard groups (a list of index lists): when a
        member wedges or ejects, its WHOLE group quarantines — partial
        results from a broken mesh slice are lost regardless of which chip
        in the slice failed. Call with () to clear (back to per-replica)."""
        with self._lock:
            self._groups = {}
            for grp in groups or ():
                members = tuple(int(i) for i in grp)
                for i in members:
                    self._groups[i] = members

    def shard_group(self, index: int) -> Tuple[int, ...]:
        with self._lock:
            return self._groups.get(int(index), (int(index),))

    def set_pipe_stages(self, stages) -> None:
        """Register a pipe plan's stage device groups (a list of index
        lists, parallel/pipeplan.py PipeSupervision.register): the same
        fail-together semantics as shard groups — a wedged stage loses
        its whole sub-mesh, so every member quarantines with it. Stage
        groups are kept alongside any shard groups; ``pipe_stage(i)``
        reads them back and ``note_stage_wedged`` quarantines one whole
        stage. Call with () to clear."""
        with self._lock:
            self._pipe_stages = [tuple(int(i) for i in grp)
                                 for grp in stages or ()]
            for members in self._pipe_stages:
                for i in members:
                    # a stage IS a fail-together group: reuse the shard-
                    # group ejection fabric for its members
                    self._groups.setdefault(i, members)

    def pipe_stage(self, stage_index: int) -> Tuple[int, ...]:
        with self._lock:
            stages = getattr(self, "_pipe_stages", [])
            if 0 <= int(stage_index) < len(stages):
                return stages[int(stage_index)]
            return ()

    def note_stage_wedged(self, stage_index: int) -> None:
        """A pipeline stage's whole sub-mesh wedged mid-stream: every
        member device index quarantines NOW (the stage's devices fail
        together — the pipe-stage analogue of ``note_wedged``'s
        shard-group ejection). Unknown stage indices are a no-op."""
        members = self.pipe_stage(stage_index)
        with self._lock:
            for i in members:
                h = self._get(i)
                h.timeouts += 1
                h.consecutive += 1
                self._score(h, 0.0)
                if h.state == HEALTHY:
                    self._eject(h, f"pipe_stage:{int(stage_index)}")

    def _eject_peers(self, index: int, reason: str) -> None:
        """Quarantine the healthy remainder of ``index``'s shard group
        (already under self._lock). Peers carry a ``shard_group:`` reason
        so the stats surface shows WHY a chip that never failed is out."""
        for peer in self._groups.get(int(index), ()):
            if peer == int(index):
                continue
            ph = self._get(peer)
            if ph.state == HEALTHY:
                self._eject(ph, f"shard_group:{reason}")

    def _get(self, index: int) -> _ReplicaHealth:
        return self._replicas.setdefault(int(index), _ReplicaHealth())

    def _score(self, h: _ReplicaHealth, outcome: float) -> None:
        h.score = self.decay * h.score + (1.0 - self.decay) * outcome

    # -- event feed (executor compute loop / watchdog) -------------------
    def note_success(self, index: int, compute_s: float) -> None:
        with self._lock:
            h = self._get(index)
            h.successes += 1
            h.consecutive = 0
            if h.compute_ewma is not None and \
                    compute_s > self.outlier_k * h.compute_ewma:
                # slow-but-completed: a latency outlier dings the score
                # without counting as a failure
                h.outliers += 1
                self._score(h, 0.5)
            else:
                self._score(h, 1.0)
            h.compute_ewma = compute_s if h.compute_ewma is None else \
                0.75 * h.compute_ewma + 0.25 * compute_s

    def note_failure(self, index: int, reason: str = "error") -> None:
        with self._lock:
            h = self._get(index)
            h.errors += 1
            h.consecutive += 1
            self._score(h, 0.0)
            if h.state == HEALTHY and h.consecutive >= self.max_failures:
                self._eject(h, reason)
                self._eject_peers(index, reason)

    def note_wedged(self, index: int) -> None:
        """A watchdog-expired dispatch: immediate quarantine — a wedged
        replica must stop receiving traffic NOW, not after max_failures."""
        with self._lock:
            h = self._get(index)
            h.timeouts += 1
            h.consecutive += 1
            self._score(h, 0.0)
            if h.state == HEALTHY:
                self._eject(h, "wedged")
            # a wedged chip invalidates its whole mesh slice even when the
            # record was already quarantined (late watchdog expiry)
            self._eject_peers(index, "wedged")

    def _eject(self, h: _ReplicaHealth, reason: str) -> None:
        h.state = QUARANTINED
        h.quarantined_at = self._clock()
        h.probe_attempt = 0
        h.ejections += 1
        h.last_reason = reason

    # -- admission / probing (executor compute loop) ---------------------
    def admitted(self, index: int) -> bool:
        with self._lock:
            return self._get(index).state == HEALTHY

    def probe_due(self, index: int) -> bool:
        """True once the quarantine cooldown (with probe backoff) elapsed."""
        with self._lock:
            h = self._get(index)
            if h.state != QUARANTINED:
                return False
            backoff = self.quarantine_s * min(16, 2 ** h.probe_attempt)
            return self._clock() - h.quarantined_at >= backoff

    def begin_probe(self, index: int) -> None:
        with self._lock:
            h = self._get(index)
            if h.state == QUARANTINED:
                h.state = PROBING

    def run_probe(self, replica: Any) -> bool:
        """Execute the configured probe (liveness default: True — the
        replica's thread being free to probe IS the liveness evidence)."""
        if self.probe_fn is None:
            return True
        try:
            return bool(self.probe_fn(replica))
        except Exception:  # noqa: BLE001 — a raising probe is a failed probe
            return False

    def note_probe(self, index: int, ok: bool) -> None:
        with self._lock:
            h = self._get(index)
            if ok:
                h.state = HEALTHY
                h.consecutive = 0
                h.readmissions += 1
                # re-admitted on probation: mid score, one wedge re-ejects
                h.score = max(h.score, 0.5)
            else:
                h.state = QUARANTINED
                h.quarantined_at = self._clock()
                h.probe_attempt += 1

    def healthy_peers(self, excluding: int) -> int:
        with self._lock:
            return sum(1 for i, h in self._replicas.items()
                       if i != excluding and h.state == HEALTHY)

    # -- stats surface ---------------------------------------------------
    def describe(self) -> List[Dict[str, Any]]:
        with self._lock:
            out = []
            for i in sorted(self._replicas):
                h = self._replicas[i]
                out.append({
                    "replica": i, "state": h.state,
                    "score": round(h.score, 4),
                    "successes": h.successes, "errors": h.errors,
                    "timeouts": h.timeouts, "outliers": h.outliers,
                    "consecutive_failures": h.consecutive,
                    "ejections": h.ejections,
                    "readmissions": h.readmissions,
                    "last_reason": h.last_reason,
                    "compute_ewma_ms": None if h.compute_ewma is None
                    else round(h.compute_ewma * 1e3, 3)})
            return out

    def summary(self) -> Dict[str, Any]:
        rows = self.describe()
        return {"replicas": rows,
                "healthy": sum(1 for r in rows if r["state"] == HEALTHY),
                "quarantined": sum(1 for r in rows
                                   if r["state"] != HEALTHY),
                "ejections": sum(r["ejections"] for r in rows),
                "readmissions": sum(r["readmissions"] for r in rows)}


# ---------------------------------------------------------------------------
# Hung-dispatch watchdog (budget policy; the executor owns the scan thread)
# ---------------------------------------------------------------------------


class DispatchWatchdog:
    """Wall-clock budget policy for in-flight dispatches.

    Budget per batch = ``k`` x the best estimate of its compute time:
    the cost model's ``predict_ms`` when calibrated (``predict_ms_fn``,
    wired from the serving tuner), else a measured compute EWMA — floored
    at ``min_budget_s`` so scheduling jitter never trips it. ``fixed_s``
    overrides everything (the chaos tests' deterministic knob). UNARMED
    (budget None) until either estimate exists: a fresh server's first
    compile can take arbitrarily long and must not read as a wedge.

    On expiry the executor re-dispatches the batch on a healthy replica
    (``max_redispatch`` bounds duplicates). With no healthy peer the budget
    doubles in place up to ``abandon_after`` expiries, then the batch is
    abandoned with an accounted 504 — a single-replica wedge degrades to a
    fast, attributed failure instead of a silent slot-timeout.
    """

    def __init__(self, k: float = 8.0, min_budget_s: float = 1.0,
                 fixed_s: Optional[float] = None,
                 predict_ms_fn: Optional[Callable[[int],
                                                  Optional[float]]] = None,
                 max_redispatch: int = 1, abandon_after: int = 3,
                 poll_s: float = 0.01):
        self.k = float(k)
        self.min_budget_s = float(min_budget_s)
        self.fixed_s = None if fixed_s is None else float(fixed_s)
        self.predict_ms_fn = predict_ms_fn
        self.max_redispatch = max(0, int(max_redispatch))
        self.abandon_after = max(1, int(abandon_after))
        self.poll_s = float(poll_s)
        self._lock = threading.Lock()
        self._ewma: Optional[float] = None
        self.trips = 0
        self.requeues = 0
        self.abandons = 0

    def observe(self, compute_s: float) -> None:
        """Feed one healthy dispatch's wall seconds (EWMA fallback source)."""
        with self._lock:
            self._ewma = compute_s if self._ewma is None else \
                0.75 * self._ewma + 0.25 * compute_s

    def budget_s(self, rows: int, batches: int = 1) -> Optional[float]:
        """Wall budget for a batch of ``rows``, or None while unarmed.

        ``batches`` covers K-step mega-dispatch (core/fusion.py): one
        Python-level dispatch may execute up to K queued micro-batches, so
        the measured-EWMA fallback — calibrated on single dispatches —
        scales by K. The cost-model prediction path already prices the
        actual row count and needs no scaling."""
        batches = max(1, int(batches or 1))
        if self.fixed_s is not None:
            return self.fixed_s
        pred_ms = None
        if self.predict_ms_fn is not None:
            try:
                pred_ms = self.predict_ms_fn(int(rows))
            except Exception:  # noqa: BLE001 — model failure != unarmed crash
                pred_ms = None
        with self._lock:
            ewma = self._ewma
        est = pred_ms / 1e3 if pred_ms is not None else \
            (ewma * batches if ewma is not None else None)
        if est is None:
            return None
        return max(self.min_budget_s, self.k * est)

    def note_trip(self, kind: str) -> None:
        with self._lock:
            self.trips += 1
            if kind == "requeue":
                self.requeues += 1
            elif kind == "abandon":
                self.abandons += 1

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            ewma = self._ewma
            trips, requeues, abandons = \
                self.trips, self.requeues, self.abandons
        return {"k": self.k, "min_budget_s": self.min_budget_s,
                "fixed_s": self.fixed_s,
                "armed": self.fixed_s is not None or ewma is not None
                or self.predict_ms_fn is not None,
                "compute_ewma_ms": None if ewma is None
                else round(ewma * 1e3, 3),
                "trips": trips, "requeues": requeues, "abandons": abandons}


# ---------------------------------------------------------------------------
# Hedged requests (RoutingFront policy + accounting)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HedgeConfig:
    """Hedging policy: after ``quantile`` of the observed forward-latency
    distribution (clamped to [min_delay_ms, max_delay_ms]), re-issue the
    request to ONE other worker; first response wins. Until ``min_samples``
    latencies are observed the delay is ``init_delay_ms``. Only requests
    slower than the quantile hedge at all, so duplicate work is bounded at
    ~(1 - quantile) of traffic by construction.

    Hedging deliberately double-dispatches: enable it only for idempotent
    serving transforms (pure inference — the normal case). Each worker
    journals and commits its own epoch exactly once either way; the losing
    reply is discarded at the front.
    """

    quantile: float = 0.95
    init_delay_ms: float = 50.0
    min_delay_ms: float = 1.0
    max_delay_ms: float = 5000.0
    min_samples: int = 20
    window: int = 512

    def __post_init__(self):
        if not 0.5 <= self.quantile < 1.0:
            raise ValueError(f"hedge quantile must be in [0.5, 1), "
                             f"got {self.quantile}")
        if self.min_delay_ms < 0 or self.max_delay_ms < self.min_delay_ms:
            raise ValueError("bad hedge delay clamp")


class HedgeTracker:
    """Latency reservoir + hedge accounting for the RoutingFront."""

    def __init__(self, config: Optional[HedgeConfig] = None):
        self.config = config if config is not None else HedgeConfig()
        self._lock = threading.Lock()
        self._lat: "deque[float]" = deque(maxlen=self.config.window)
        self.requests = 0
        self.hedged = 0
        self.suppressed = 0       # hedge launch blocked (injected fault)
        self.wins_primary = 0
        self.wins_hedge = 0
        self.wins_retry = 0       # non-hedged retry walk won the race
        self.both_failed = 0

    def observe(self, latency_s: float) -> None:
        with self._lock:
            self._lat.append(float(latency_s))

    def delay_s(self) -> float:
        """Current hedge trigger delay in seconds."""
        cfg = self.config
        with self._lock:
            lat = sorted(self._lat)
        if len(lat) < cfg.min_samples:
            ms = cfg.init_delay_ms
        else:
            idx = min(len(lat) - 1, int(cfg.quantile * len(lat)))
            ms = lat[idx] * 1e3
        return min(cfg.max_delay_ms, max(cfg.min_delay_ms, ms)) / 1e3

    def note_request(self) -> None:
        with self._lock:
            self.requests += 1

    def note_hedged(self) -> None:
        with self._lock:
            self.hedged += 1

    def note_suppressed(self) -> None:
        with self._lock:
            self.suppressed += 1

    def note_win(self, role: str) -> None:
        with self._lock:
            if role == "hedge":
                self.wins_hedge += 1
            elif role == "retry":
                self.wins_retry += 1
            else:
                self.wins_primary += 1

    def note_both_failed(self) -> None:
        with self._lock:
            self.both_failed += 1

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            n = len(self._lat)
            out = {"quantile": self.config.quantile,
                   "delay_ms": None, "samples": n,
                   "requests": self.requests, "hedged": self.hedged,
                   "suppressed": self.suppressed,
                   "wins_primary": self.wins_primary,
                   "wins_hedge": self.wins_hedge,
                   "wins_retry": self.wins_retry,
                   "both_failed": self.both_failed,
                   "hedge_fraction": round(
                       self.hedged / self.requests, 4)
                   if self.requests else 0.0}
        out["delay_ms"] = round(self.delay_s() * 1e3, 3)
        return out


def make_hedge(hedge: Any) -> Optional[HedgeTracker]:
    """Coerce the front's ``hedge`` knob: None/False -> off, True -> default
    config, HedgeConfig/dict -> configured, HedgeTracker -> as-is."""
    if hedge is None or hedge is False:
        return None
    if hedge is True:
        return HedgeTracker()
    if isinstance(hedge, HedgeTracker):
        return hedge
    if isinstance(hedge, HedgeConfig):
        return HedgeTracker(hedge)
    if isinstance(hedge, dict):
        return HedgeTracker(HedgeConfig(**hedge))
    raise ValueError(f"hedge must be None/bool/HedgeConfig/dict, "
                     f"got {hedge!r}")


# ---------------------------------------------------------------------------
# Brownout: staged graceful degradation on SLO burn
# ---------------------------------------------------------------------------


class BrownoutStep:
    """One declared degradation: ``apply()`` engages it, ``revert()``
    restores the pre-step state (closures capture whatever knob state they
    need). Steps are applied in declaration order and reverted in reverse —
    a stack of reversible knob changes."""

    __slots__ = ("name", "_apply", "_revert")

    def __init__(self, name: str, apply: Callable[[], None],
                 revert: Callable[[], None]):
        self.name = str(name)
        self._apply = apply
        self._revert = revert

    def apply(self) -> None:
        self._apply()

    def revert(self) -> None:
        self._revert()


class BrownoutController:
    """Hysteretic staged degradation driven by SLO burn rate.

    ``check()`` is the per-batch tick (rate-limited to ``check_interval_s``
    internally, so it is a cheap no-op on the hot path): read the burn rate
    for ``window_s`` from the SLO tracker; above ``enter_burn`` and after
    ``hold_s`` since the last transition, apply the next step; below
    ``exit_burn`` for ``2 * hold_s`` (hysteresis — restoring is slower than
    degrading), revert the most recent step. Transitions are journaled like
    tuner decisions (bounded list, ``rollback()`` reverts exactly the most
    recent step)."""

    def __init__(self, slo: Any, steps: List[BrownoutStep],
                 enter_burn: float = 2.0, exit_burn: float = 0.5,
                 window_s: int = 60, hold_s: float = 5.0,
                 check_interval_s: float = 0.25, journal_cap: int = 256,
                 clock: Callable[[], float] = time.monotonic):
        if slo is None:
            raise ValueError("brownout requires an SLO tracker (slo= knob)")
        if exit_burn >= enter_burn:
            raise ValueError("exit_burn must be below enter_burn "
                             "(hysteresis band)")
        self.slo = slo
        self.steps = list(steps)
        self.enter_burn = float(enter_burn)
        self.exit_burn = float(exit_burn)
        self.window_s = int(window_s)
        self.hold_s = float(hold_s)
        self.check_interval_s = float(check_interval_s)
        self._journal_cap = int(journal_cap)
        self._clock = clock
        self._lock = threading.Lock()
        self._step = 0          # applied step count (0 = full service)
        self._last_check = 0.0
        self._last_change = 0.0
        self._below_since: Optional[float] = None
        self.transitions = {"degrade": 0, "restore": 0, "rollback": 0}
        self.journal: List[Dict[str, Any]] = []

    @property
    def step(self) -> int:
        with self._lock:
            return self._step

    def _log(self, action: str, step_name: str, burn: float) -> None:
        entry = {"action": action, "step": step_name,
                 "level": self._step, "burn": round(burn, 4),
                 "t": round(self._clock(), 3)}
        self.journal.append(entry)
        if len(self.journal) > self._journal_cap:
            del self.journal[: self._journal_cap // 4]

    def _burn(self) -> float:
        try:
            rates = self.slo.burn_rates()
        except Exception:  # noqa: BLE001 — a broken tracker must not degrade
            return 0.0
        return float(rates.get(self.window_s, 0.0))

    def check(self) -> Optional[str]:
        """One controller tick. Returns the transition taken ("degrade" /
        "restore") or None. Rate-limited; safe to call per batch."""
        now = self._clock()
        with self._lock:
            if now - self._last_check < self.check_interval_s:
                return None
            self._last_check = now
        burn = self._burn()
        action: Optional[str] = None
        step: Optional[BrownoutStep] = None
        with self._lock:
            if burn > self.enter_burn:
                self._below_since = None
                if self._step < len(self.steps) and \
                        now - self._last_change >= self.hold_s:
                    step = self.steps[self._step]
                    self._step += 1
                    self._last_change = now
                    self.transitions["degrade"] += 1
                    self._log("degrade", step.name, burn)
                    action = "degrade"
            elif burn < self.exit_burn and self._step > 0:
                # hysteresis: the burn must stay below exit_burn for
                # 2 * hold_s before a step restores (degrading is fast,
                # restoring is deliberate)
                if self._below_since is None:
                    self._below_since = now
                elif now - self._below_since >= 2 * self.hold_s:
                    step = self.steps[self._step - 1]
                    self._step -= 1
                    self._last_change = now
                    self._below_since = now
                    self.transitions["restore"] += 1
                    self._log("restore", step.name, burn)
                    action = "restore"
            else:
                self._below_since = None
        if action is None or step is None:
            return None
        # knob closures run OUTSIDE the controller lock: a step may take
        # server/controller locks of its own (lock-order hygiene, C002)
        self._run_step(action, step)
        return action

    @staticmethod
    def _run_step(action: str, step: BrownoutStep) -> None:
        try:
            if action == "degrade":
                step.apply()
            else:
                step.revert()
        except Exception:  # noqa: BLE001 — a failing knob must not kill serving
            pass

    def rollback(self) -> bool:
        """Revert exactly the most recent applied step (the tuner-style
        one-step rollback). Returns False at full service."""
        with self._lock:
            if self._step == 0:
                return False
            step = self.steps[self._step - 1]
            self._step -= 1
            self._last_change = self._clock()
            self.transitions["rollback"] += 1
            self._log("rollback", step.name, 0.0)
        self._run_step("restore", step)
        return True

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {"step": self._step,
                    "max_steps": len(self.steps),
                    "active": self._step > 0,
                    "steps": [s.name for s in self.steps],
                    "enter_burn": self.enter_burn,
                    "exit_burn": self.exit_burn,
                    "window_s": self.window_s,
                    "transitions": dict(self.transitions),
                    "journal": list(self.journal[-16:])}


def make_brownout(spec: Any, slo: Any,
                  steps: List[BrownoutStep]) -> Optional[BrownoutController]:
    """Coerce a server's ``brownout`` knob: None/False -> off, True ->
    default thresholds, dict -> configured (keys = BrownoutController
    kwargs), BrownoutController -> as-is."""
    if spec is None or spec is False:
        return None
    if isinstance(spec, BrownoutController):
        return spec
    if spec is True:
        return BrownoutController(slo, steps)
    if isinstance(spec, dict):
        return BrownoutController(slo, steps, **spec)
    raise ValueError(f"brownout must be None/bool/dict/BrownoutController, "
                     f"got {spec!r}")
