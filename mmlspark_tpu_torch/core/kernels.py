"""Kernel-variant registry for the fused executor.

Copy of the reference's ``mmlspark_tpu/core/kernels.py`` (pure Python): the
same variant ids, params and tolerances, ``activate`` / ``active`` /
``active_param``. In the reference the executor activates a variant around
a segment's trace; the port runs its fused program eagerly, so the
executor activates the variant around every call of the program instead
(``core/fusion.py``), and the call sites read it at the same points.

Variants are :class:`KernelVariant` records picked per (segment, bucket)
through ``FusedPipelineModel.set_tuning(kernel_variants=...)``.

Two invariants matter:

* **Tolerance declaration.**  ``tolerance is None`` means the variant is
  exact-compute: it must produce bitwise-identical results to the default.
  A float tolerance marks a reduction-order-sensitive variant (e.g. the
  histogram chunk size changes f32 accumulation splits).
* **Cold-start identity.**  With no variant active every kernel resolves
  its built-in default; ``active()`` returns ``None`` and no behaviour
  changes.  Variant ids never contain ``:`` or ``;`` so the
  ``variant=<id>;`` CompileCache shape prefix stays unambiguous.
"""

from __future__ import annotations

import contextlib
import re
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, Mapping, Optional, Tuple

__all__ = [
    "KernelVariant",
    "register",
    "get",
    "all_variant_ids",
    "activate",
    "active",
    "active_param",
    "DEFAULT_VARIANT",
]

#: Sentinel id for "use the kernel's built-in default" (never registered).
DEFAULT_VARIANT = "default"

_ID_RE = re.compile(r"^[a-z0-9][a-z0-9._-]*$")


@dataclass(frozen=True)
class KernelVariant:
    """One point in a kernel's variant space.

    ``kernel`` names the call-site family ("hist", "select", "forest");
    ``params`` are the knob values the call site consumes at trace time;
    ``tolerance`` is the declared numeric tolerance versus the default
    variant (``None`` = exact-compute, enforced bitwise).
    """

    id: str
    kernel: str
    params: Mapping[str, object] = field(default_factory=dict)
    tolerance: Optional[float] = None

    def __post_init__(self) -> None:
        if not _ID_RE.match(self.id) or ":" in self.id or ";" in self.id:
            raise ValueError(f"invalid kernel variant id: {self.id!r}")


_REGISTRY: Dict[str, KernelVariant] = {}
_LOCK = threading.Lock()


def register(variant: KernelVariant) -> KernelVariant:
    """Register (or idempotently re-register) a variant."""
    with _LOCK:
        prev = _REGISTRY.get(variant.id)
        if prev is not None and prev != variant:
            raise ValueError(f"conflicting redefinition of variant {variant.id!r}")
        _REGISTRY[variant.id] = variant
    return variant


def get(variant_id: str) -> Optional[KernelVariant]:
    """Look up a variant by id; ``None`` for unknown ids / the default."""
    if not variant_id or variant_id == DEFAULT_VARIANT:
        return None
    return _REGISTRY.get(variant_id)


def all_variant_ids() -> Tuple[str, ...]:
    with _LOCK:
        return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Activation.  The executor enters ``activate(vid)`` around every call of a
# segment's fused program; kernel call sites consult ``active()`` /
# ``active_param()`` when they run.
# ---------------------------------------------------------------------------

_tls = threading.local()


def _stack(create: bool = False):
    stack = getattr(_tls, "stack", None)
    if stack is None and create:
        stack = _tls.stack = []
    return stack


@contextlib.contextmanager
def activate(variant_id: Optional[str]) -> Iterator[Optional[KernelVariant]]:
    """Make ``variant_id`` the active variant for its kernel family within
    the ``with`` body (thread-local; nestable, innermost wins per family)."""
    var = get(variant_id) if variant_id else None
    if var is None:
        yield None
        return
    stack = _stack(create=True)
    stack.append(var)
    try:
        yield var
    finally:
        stack.pop()


def active(kernel: str) -> Optional[KernelVariant]:
    """The innermost active variant for ``kernel``, or ``None``."""
    stack = _stack()
    if not stack:
        return None
    for var in reversed(stack):
        if var.kernel == kernel:
            return var
    return None


def active_param(kernel: str, name: str, default):
    """Convenience: the active variant's ``params[name]``, else ``default``."""
    var = active(kernel)
    if var is None:
        return default
    return var.params.get(name, default)


# ---------------------------------------------------------------------------
# Built-in variant space: the reference's, id for id.  The port reads only
# the ``forest`` family; the ``hist`` and ``select`` ids are kept so the
# registry (and a tuned knob naming them) is the reference's.
# ---------------------------------------------------------------------------

# Histogram chunk size changes how rows are split across grid cells and how
# the bf16 hi/lo (or 3-pass f32) partial sums accumulate -> reduction-order
# sensitive, gated behind an allclose tolerance.
_HIST_TOL = 2e-3
for _c in (256, 1024):
    register(KernelVariant(id=f"hist.c{_c}", kernel="hist",
                           params={"chunk": _c}, tolerance=_HIST_TOL))

# Row-select writes each surviving row exactly once via pass-through one-hot
# products; chunking only re-tiles the scan, so variants are exact-compute.
for _c in (512, 2048):
    register(KernelVariant(id=f"select.c{_c}", kernel="select",
                           params={"chunk": _c}, tolerance=None))

# Forest traversal: the path-matrix GEMM and the per-depth gather traversal
# land on the same leaf values (one-hot reach x leaf value, zeros added
# exactly), so switching loop order is exact-compute.
register(KernelVariant(id="forest.gather", kernel="forest",
                       params={"impl": "gather"}, tolerance=None))
register(KernelVariant(id="forest.gemm", kernel="forest",
                       params={"impl": "gemm"}, tolerance=None))

# Sparse/CSR variants:
#   hist.csr — in the reference, the sparse engine's flat-ragged-bin
#   histogram as a one-hot contraction over nnz chunks; chunk order changes
#   the f32 summation order, so it shares the histogram tolerance.
#   forest.csr — the gather traversal over the CSR-gathered used-feature
#   matrix; every output cell of the gather receives at most one stored
#   value, so the variant is exact-compute. (The port's gather, K3, runs
#   for every CSR-staged batch whatever variant is active.)
register(KernelVariant(id="hist.csr", kernel="hist",
                       params={"layout": "csr"}, tolerance=_HIST_TOL))
register(KernelVariant(id="forest.csr", kernel="forest",
                       params={"impl": "gather", "csr_gather": "pallas"},
                       tolerance=None))
