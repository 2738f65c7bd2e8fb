"""HTTP client half: typed request/response records and the retrying send.

Counterpart of ``HTTPRequestData``, ``HTTPResponseData``, ``send_request``,
``parse_retry_after`` and ``send_with_retries`` in the reference's
``mmlspark_tpu/io/http.py``. The serving stack's reply hop
(``serving/server.py`` ``reply_to``) rides ``send_with_retries``:
retryable statuses back off with jitter (or a seeded
``core.faults.RetryPolicy``), 429/503 honor Retry-After, and every wait is
capped at the request deadline. ``HTTPTransformer``, the simple
transformer's parsers and the shared per-process singletons wait for ROADMAP
A step 10.
"""

from __future__ import annotations

import dataclasses
import random
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, Optional

from ..core import faults
from ..core.schema import Binding

# ---------------------------------------------------------------------------
# Schema (HTTPSchema parity)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HTTPRequestData:
    url: str
    method: str = "GET"
    headers: Optional[Dict[str, str]] = None
    entity: Optional[bytes] = None

    def to_row(self) -> Dict[str, Any]:
        return Binding.to_row(self)

    @staticmethod
    def from_row(row: Dict[str, Any]) -> "HTTPRequestData":
        return Binding.from_row(HTTPRequestData, row)


@dataclasses.dataclass
class HTTPResponseData:
    statusCode: int
    statusLine: str = ""
    entity: Optional[bytes] = None
    headers: Optional[Dict[str, str]] = None

    def to_row(self) -> Dict[str, Any]:
        return Binding.to_row(self)

    @staticmethod
    def from_row(row: Dict[str, Any]) -> "HTTPResponseData":
        return Binding.from_row(HTTPResponseData, row)


# ---------------------------------------------------------------------------
# Client with retries
# ---------------------------------------------------------------------------


RETRYABLE_CODES = {403, 408, 429, 500, 502, 503, 504}

#: +/- jitter fraction applied to the legacy fixed backoff list (decorrelates
#: synchronized retry storms from many partitions hitting one rate-limited
#: host; a seeded RetryPolicy gives a deterministic stream instead)
_LEGACY_JITTER = 0.2


def send_request(req: HTTPRequestData, timeout: float = 60.0,
                 deadline: Optional[faults.Deadline] = None
                 ) -> HTTPResponseData:
    if deadline is not None:
        timeout = max(deadline.cap(timeout), 1e-3)
    r = urllib.request.Request(req.url, data=req.entity,
                               headers=req.headers or {},
                               method=req.method or "GET")
    try:
        faults.fire(faults.HTTP_SEND, url=req.url, method=req.method)
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            return HTTPResponseData(
                statusCode=resp.status,
                statusLine=getattr(resp, "reason", "") or "",
                entity=resp.read(),
                headers=dict(resp.headers.items()))
    except urllib.error.HTTPError as e:
        return HTTPResponseData(statusCode=e.code, statusLine=str(e.reason),
                                entity=e.read() if e.fp else None,
                                headers=dict(e.headers.items()) if e.headers else {})
    except Exception as e:  # connection errors -> 0 status (retryable)
        return HTTPResponseData(statusCode=0, statusLine=str(e))


def parse_retry_after(value: Optional[str],
                      now: Optional[float] = None) -> Optional[float]:
    """Seconds to wait from a Retry-After header: numeric seconds OR an
    HTTP-date (RFC 9110 both forms). None when unparseable."""
    if not value:
        return None
    try:
        return max(0.0, float(value))
    except (TypeError, ValueError):
        pass
    from email.utils import parsedate_to_datetime

    try:
        dt = parsedate_to_datetime(value)
    except (TypeError, ValueError):
        return None
    if dt is None:
        return None
    if dt.tzinfo is None:
        from datetime import timezone

        dt = dt.replace(tzinfo=timezone.utc)
    return max(0.0, dt.timestamp() - (time.time() if now is None else now))


def send_with_retries(req: HTTPRequestData, retry_backoffs_ms=(100, 500, 1000),
                      timeout: float = 60.0,
                      sleep_fn: Callable[[float], None] = time.sleep,
                      policy: Optional[faults.RetryPolicy] = None,
                      deadline: Optional[faults.Deadline] = None,
                      send: Optional[Callable] = None
                      ) -> HTTPResponseData:
    """Status-aware retry: retryable codes back off with jitter; 429/503
    honor Retry-After (numeric seconds or HTTP-date), and every honored wait
    is capped at the request deadline.

    ``policy``: a core.faults.RetryPolicy replacing the legacy fixed backoff
    list (seedable jitter, sleep budget). ``deadline``: when set, no sleep or
    socket timeout extends past it; once expired the last response returns
    as-is instead of retrying into a lost cause. ``send``: per-attempt
    transport override (``(req, timeout[, deadline]) -> HTTPResponseData``)
    so callers can inject an offline transport while keeping the full retry
    behavior.
    """
    rng = policy.make_rng() if policy is not None else random.Random()
    n_attempts = policy.max_retries if policy is not None \
        else len(retry_backoffs_ms)
    budget_left = policy.budget_s if policy is not None else None

    def _send():
        # the deadline arg is only threaded through when set: injected test
        # handlers replace send_request with (req, timeout) signatures
        if send is not None:
            return send(req, timeout) if deadline is None \
                else send(req, timeout, deadline)
        if deadline is None:
            return send_request(req, timeout)
        return send_request(req, timeout, deadline)

    resp = _send()
    for attempt in range(n_attempts):
        if resp.statusCode == 200 or resp.statusCode not in RETRYABLE_CODES | {0}:
            return resp
        if policy is not None:
            wait = policy.next_wait(attempt, rng)
        else:
            base = retry_backoffs_ms[attempt] / 1000.0
            wait = max(0.0, base * (1.0 + _LEGACY_JITTER * rng.uniform(-1, 1)))
        if resp.statusCode in (429, 503) and resp.headers:
            ra = parse_retry_after(
                resp.headers.get("Retry-After")
                or resp.headers.get("retry-after"))
            if ra is not None:
                wait = ra  # server-directed wait: exact, not jittered
        if budget_left is not None:
            if budget_left <= 0:
                return resp
            wait = min(wait, budget_left)
            budget_left -= wait
        if deadline is not None:
            remaining = deadline.remaining()
            if remaining <= 0:
                return resp
            wait = min(wait, remaining)  # cap the honored wait at the deadline
        sleep_fn(wait)
        resp = _send()
    return resp
