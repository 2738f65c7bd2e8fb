"""Device selection for the port's entry points.

Every entry point (``gbdt.booster.train``, the GBDT stages, ``DeviceEnsemble``)
runs on ``cuda`` unless the caller asks for the CPU, either per call
(``train(..., device="cpu")``) or for a block of code
(``with use_device("cpu"): ...``). Without a CUDA device and without such a
request the entry points raise: nothing quietly runs on the CPU.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict, Iterator, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

_local = threading.local()

#: guards ``_working`` and ``_sync_held``
_work_lock = threading.Lock()
#: thread id -> depth of its ``working`` blocks: the threads running the
#: port's device work now
_working: Dict[int, int] = {}
#: (thread id, the mode it replaced) while a ``sync_debug_mode`` block
#: holds ``torch.cuda.set_sync_debug_mode``, which is the whole process's
_sync_held: Optional[tuple] = None


def _requested() -> Optional[torch.device]:
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_device(device: DeviceLike) -> Iterator[torch.device]:
    """Run the enclosed entry-point calls on ``device`` (e.g. ``"cpu"``)."""
    dev = resolve_device(device)
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(dev)
    try:
        yield dev
    finally:
        stack.pop()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` if given, else the one ``use_device`` asked for, else
    ``cuda``. Raises when the result is a CUDA device and none is present."""
    if device is None:
        dev = _requested() or torch.device("cuda")
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mmlspark_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' or wrap the call in "
            "use_device('cpu') to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def requested_device() -> Optional[torch.device]:
    """The device the innermost ``use_device`` on this thread asked for, or
    None."""
    return _requested()


@contextlib.contextmanager
def working() -> Iterator[None]:
    """Mark this thread as running device work for the block (a fit, a
    worker thread's life). A ``sync_debug_mode`` block another thread holds
    gives its mode back first: the mode is the process's, and this thread's
    host reads must not raise in it."""
    global _sync_held
    me = threading.get_ident()
    with _work_lock:
        _working[me] = _working.get(me, 0) + 1
        if _sync_held is not None and _sync_held[0] != me:
            torch.cuda.set_sync_debug_mode(_sync_held[1])
            _sync_held = None
    try:
        yield
    finally:
        with _work_lock:
            _working[me] -= 1
            if not _working[me]:
                del _working[me]


def device_work(fn: Callable) -> Callable:
    """``fn`` run inside ``working()`` (the fit entry points)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with working():
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def sync_debug_mode(mode: Optional[str]) -> Iterator[bool]:
    """``torch.cuda.set_sync_debug_mode(mode)`` for the block, where that
    proves something: a card, a ``mode``, and no other thread working
    (``working``). The mode is the process's, so another thread's host
    read would raise in it; one that starts working during the block takes
    the mode back (the block then proves nothing more). Yields whether the
    mode was set."""
    global _sync_held
    me = threading.get_ident()
    with _work_lock:
        held = (mode is not None and torch.cuda.is_available()
                and _sync_held is None
                and all(t == me for t in _working))
        if held:
            _sync_held = (me, torch.cuda.get_sync_debug_mode())
            torch.cuda.set_sync_debug_mode(mode)
    try:
        yield held
    finally:
        if held:
            with _work_lock:
                if _sync_held is not None and _sync_held[0] == me:
                    torch.cuda.set_sync_debug_mode(_sync_held[1])
                    _sync_held = None


@contextlib.contextmanager
def on_device(device: DeviceLike, stream: Optional["torch.cuda.Stream"] = None
              ) -> Iterator[torch.device]:
    """Run this thread's work on ``device``: the entry points resolve it
    (``use_device``), CUDA allocations land on it (``torch.cuda.device``),
    and with a ``stream`` the thread's CUDA work is queued there. The
    choice is per thread: a thread a server or executor starts enters its
    device with this, since it does not inherit its creator's. The thread
    counts as ``working`` for the block."""
    with working(), use_device(device) as dev:
        if dev.type != "cuda":
            yield dev
            return
        with torch.cuda.device(dev):
            if stream is None:
                yield dev
                return
            with torch.cuda.stream(stream):
                yield dev


def default_device() -> torch.device:
    """``cuda``, unless the caller asked for ``cpu`` via ``use_device``."""
    return resolve_device(None)
