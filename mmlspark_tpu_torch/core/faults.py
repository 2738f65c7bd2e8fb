"""Fault-injection seams of the boosting loop and the fused executor.

Counterpart of the ``fire`` / ``TRAIN_STEP`` / ``SPARSE_STAGE`` /
``InjectedFault`` part of the reference's ``mmlspark_tpu/core/faults.py``:
named injection points that are no-ops unless an injector is installed.
The GBDT boost loop fires ``TRAIN_STEP`` at the top of every iteration;
the fused executor fires ``SPARSE_STAGE`` before it stages a sparse column
as a CSR triple, and takes its accounted densify fallback when the hook
raises ``InjectedFault`` (``core/fusion.py`` ``_stage_csr``). The
reference's retry policies, deadlines and the seeded ``FaultInjector``
wait for the serving slice.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

TRAIN_STEP = "train.step"          # gbdt boosting iteration
SPARSE_STAGE = "sparse.stage"      # fused executor: CSR staging of a column


class InjectedFault(OSError):
    """The exception an injector raises to simulate a fault at a point."""


#: ``hook(point, **ctx)`` — raises to simulate a fault at ``point``
_ACTIVE: Optional[Callable[..., None]] = None


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
