"""Fault-injection seams of the boosting loop and the fused executor, and
durable atomic file writes.

Counterpart of the ``fire`` / ``TRAIN_STEP`` / ``SPARSE_STAGE`` /
``InjectedFault`` / ``atomic_write_text`` part of the reference's
``mmlspark_tpu/core/faults.py``:
named injection points that are no-ops unless an injector is installed.
The GBDT boost loop fires ``TRAIN_STEP`` at the top of every iteration;
the fused executor fires ``SPARSE_STAGE`` before it stages a sparse column
as a CSR triple, and takes its accounted densify fallback when the hook
raises ``InjectedFault`` (``core/fusion.py`` ``_stage_csr``). GBDT
checkpoints are written with ``atomic_write_text``, so a crash mid-write
leaves the previous complete file. The
reference's retry policies, deadlines and the seeded ``FaultInjector``
wait for the serving slice.
"""

from __future__ import annotations

import os
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


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss (best
    effort: some filesystems refuse a directory fsync)."""
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
    """Durable atomic file write: a temporary file in the same directory,
    flushed and fsynced, renamed over ``path``, then the directory fsynced.
    A crash at any point leaves the old complete file or the new one,
    never a torn one."""
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
