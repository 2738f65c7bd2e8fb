"""Device selection for the port's entry points.

Every entry point (``gbdt.booster.train``, the GBDT stages, ``DeviceEnsemble``)
runs on ``cuda`` unless the caller asks for the CPU, either per call
(``train(..., device="cpu")``) or for a block of code
(``with use_device("cpu"): ...``). Without a CUDA device and without such a
request the entry points raise: nothing quietly runs on the CPU.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

_local = threading.local()


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
def on_device(device: DeviceLike, stream: Optional["torch.cuda.Stream"] = None
              ) -> Iterator[torch.device]:
    """Run this thread's work on ``device``: the entry points resolve it
    (``use_device``), CUDA allocations land on it (``torch.cuda.device``),
    and with a ``stream`` the thread's CUDA work is queued there. The
    choice is per thread: a thread a server or executor starts enters its
    device with this, since it does not inherit its creator's."""
    with use_device(device) as dev:
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
