"""Per-tenant admission classes: weighted-fair load shedding.

Counterpart of the reference's ``mmlspark_tpu/serving/tenants.py``.
Bounded admission alone sheds with a GLOBAL 503 once the ingress queue hits
``max_queue`` — one heavy tenant saturating the queue starves every light
tenant behind the same front. This module maps the ``X-MMLSpark-Tenant``
header to admission classes with configured weights, so overload sheds
PROPORTIONALLY:

  - while the global queue is below ``max_queue``, every tenant is admitted
    (work-conserving — unused share is never wasted);
  - once the queue is full, a tenant is admitted only while its in-flight
    share (admitted and not yet answered) is below its weighted quota
    ``max_queue * weight / sum(active weights)`` — the heavy tenant that
    filled the queue sheds first, a light tenant within its share still
    gets in (total admission stays bounded by ~2x ``max_queue``: the global
    cap plus the sum of quotas).

Requests without the header share the ``default`` class. The admission
object is transport-agnostic: ``ServingServer`` consults it at ingress in
both the threaded and async HTTP modes.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Mapping, Optional

__all__ = ["TENANT_HEADER", "MODEL_HEADER", "TenantAdmission",
           "tenants_from_spec", "header_lookup"]

#: request header naming the admission class (absent -> "default")
TENANT_HEADER = "X-MMLSpark-Tenant"
DEFAULT_TENANT = "default"
#: request header naming the target model in a multi-model worker (the
#: model-mall plane, ROADMAP A step 10; absent -> the default model)
MODEL_HEADER = "X-MMLSpark-Model"


def header_lookup(headers: Optional[Mapping[str, str]],
                  name: str) -> Optional[str]:
    """Case-insensitive single-header lookup (the ``tenant_of`` /
    ``deadline_from_headers`` convention, factored out): exact and
    lowercase keys first, then a linear scan; empty values read as
    absent."""
    if not headers:
        return None
    get = getattr(headers, "get", None)
    v = None
    if get is not None:
        v = get(name) or get(name.lower())
    if v is None:
        low = name.lower()
        for k in headers:
            if str(k).lower() == low:
                v = headers[k]
                break
    v = str(v).strip() if v is not None else ""
    return v or None


class TenantAdmission:
    """Weighted-fair admission over named tenant classes.

    ``weights``: tenant -> relative weight (unknown tenants get
    ``default_weight``). State tracked per tenant: in-flight count
    (admitted, not yet answered — released by the server when the reply
    slot resolves), admitted/shed totals for the stats surface.
    """

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0):
        self.weights = {str(k): float(v) for k, v in (weights or {}).items()}
        if any(w <= 0 for w in self.weights.values()):
            raise ValueError("tenant weights must be positive")
        self.default_weight = float(default_weight)
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {}
        self._admitted: Dict[str, int] = {}
        self._shed: Dict[str, int] = {}
        # brownout pressure: every quota is scaled by this factor while a
        # degradation step has tightened admission (1.0 = full quotas)
        self._pressure = 1.0

    def set_pressure(self, factor: float) -> float:
        """Scale every tenant quota by ``factor`` (the brownout
        controller's tighten-admission knob); returns the previous factor
        so the step can restore it."""
        if factor <= 0:
            raise ValueError("pressure factor must be positive")
        with self._lock:
            prev = self._pressure
            self._pressure = float(factor)
            return prev

    @staticmethod
    def tenant_of(headers: Optional[Mapping[str, str]]) -> str:
        """Case-insensitive ``X-MMLSpark-Tenant`` lookup (same convention as
        ``deadline_from_headers``); absent or empty -> ``default``."""
        return header_lookup(headers, TENANT_HEADER) or DEFAULT_TENANT

    def weight(self, tenant: str) -> float:
        return self.weights.get(tenant, self.default_weight)

    def quota(self, tenant: str, max_queue: int) -> int:
        """This tenant's fair share of a FULL queue: ``max_queue`` split by
        weight over the currently-active tenants (inflight > 0, plus the
        asking tenant). At least 1 — a configured tenant is never starved
        outright."""
        with self._lock:
            return self._quota_locked(tenant, max_queue)

    def _quota_locked(self, tenant: str, max_queue: int) -> int:
        active = {t for t, n in self._inflight.items() if n > 0}
        active.add(tenant)
        total_w = sum(self.weight(t) for t in active)
        if total_w <= 0:
            return max(1, int(max_queue * self._pressure))
        return max(1, int(max_queue * self._pressure
                          * self.weight(tenant) / total_w))

    def try_admit(self, tenant: str, queue_depth: int,
                  max_queue: int) -> bool:
        """One admission decision; on True the tenant's in-flight count is
        taken (pair with ``release`` when the request resolves)."""
        with self._lock:
            if max_queue <= 0 or queue_depth < max_queue:
                ok = True  # global queue not full: work-conserving admit
            else:
                ok = self._inflight.get(tenant, 0) < \
                    self._quota_locked(tenant, max_queue)
            if ok:
                self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
                self._admitted[tenant] = self._admitted.get(tenant, 0) + 1
            else:
                self._shed[tenant] = self._shed.get(tenant, 0) + 1
            return ok

    def release(self, tenant: str) -> None:
        with self._lock:
            n = self._inflight.get(tenant, 0) - 1
            if n > 0:
                self._inflight[tenant] = n
            else:
                self._inflight.pop(tenant, None)

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            tenants = sorted(set(self._admitted) | set(self._shed)
                             | set(self._inflight) | set(self.weights))
            return {t: {"weight": self.weight(t),
                        "inflight": self._inflight.get(t, 0),
                        "admitted": self._admitted.get(t, 0),
                        "shed": self._shed.get(t, 0)}
                    for t in tenants}


def tenants_from_spec(spec: Optional[str]) -> Optional[TenantAdmission]:
    """Parse the deploy-surface encoding (helm env plumbing):
    ``"teamA=3,teamB=1"`` -> TenantAdmission with those weights; ``"1"`` /
    ``"true"`` -> enabled with uniform weights; empty/None/"0"/"false" ->
    None (tenancy off, legacy global shed)."""
    if spec is None:
        return None
    spec = spec.strip()
    if not spec or spec.lower() in ("0", "false", "off", "no"):
        return None
    if spec.lower() in ("1", "true", "on", "yes"):
        return TenantAdmission()
    weights: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, w = part.partition("=")
        if not sep:
            raise ValueError(f"bad tenant spec entry {part!r} "
                             f"(want name=weight)")
        weights[name.strip()] = float(w)
    return TenantAdmission(weights)
