"""Device-stage contract: how a pipeline stage joins a fused device program.

Counterpart of the reference's ``mmlspark_tpu/core/device_stage.py``. A stage
offers itself to the fused executor (``core/fusion.py``) through

    stage.device_fn(schema) -> Optional[DeviceFn]

A ``DeviceFn`` describes the stage as a program over batched torch tensors
plus the host-side shims the executor needs at segment edges:

  - ``fn(params, env)``      the body: reads batched [B, ...] tensors out of
                             ``env`` (a dict keyed by column name), returns
                             the dict of columns it writes. Raise
                             ``FusionUnsupported`` when the incoming shapes
                             or dtypes rule fusion out: the executor falls
                             back to the host path for the partition.
  - ``prepare(cols, ctx)``   host per-row prep of SEGMENT-EXTERNAL inputs,
                             reusing the unfused code path.
  - ``finalize(outs, ctx)``  host post-processing of the stage's device
                             outputs after readback (f64 objective math) —
                             again the exact unfused code.

The bitwise contract: everything placed in ``fn`` must be exact between the
unfused path and the fused one — here literally the same torch ops (the
GBDT forest traversal) on a batch of other rows. Anything else belongs in
``prepare``/``finalize``.

The reference traces ``fn`` into one XLA program with ``jax.jit``. The port
has no trace: the fused program is an eager composition of the stages'
torch ops, launched batch after batch on the device. ``CompileCache`` keeps
the reference's keying — segment key, shape signature, and the
``variant=<id>;``, ``layout=csr;``, ``mega{k};`` and ``stitch=`` shape
prefixes — its bounded LRU and its hit/miss counters, so the executor and
``fusion_stats()`` read the same; an entry is the built program for one
signature. Where the reference harvests XLA's cost analysis at compile
time, ``costs()`` records what the cost tally (obs/perf.py ``cost_tally``)
measured on the program's first call: flops, bytes accessed, argument and
output bytes and, on the card, the peak memory it added, beside
``compile_s`` and the first call's milliseconds. The reference's persistent
second tier (``attach_persistent``, ``preload``) belongs with the fleet
plane (ROADMAP A step 10).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple


class FusionUnsupported(Exception):
    """A stage cannot join (or continue) a fused segment for the observed
    schema/shapes/dtypes. Raised at plan time or when the program runs; the
    executor falls back to the unfused host path for the partition."""


@dataclasses.dataclass
class DeviceFn:
    """One stage's slice of a fused device program (see module docstring).

    ``key`` must be hashable and identify the computation (stage class,
    column names, model identity...): it keys the shared compile cache
    together with the batch shape signature.

    ``device_outputs``: the env keys the executor reads back for this stage
    (defaults to ``out_cols``); internal keys (prefixed ``__``) let a stage
    compute raw device values that only ``finalize`` consumes — e.g. the
    GBDT forest scores, finalized into probability/prediction columns in
    f64 on host. A stage with internal outputs is ``terminal``: nothing
    downstream can consume its finalized columns on device.

    ``null_policy``: "propagate" = rows with a null input produce null
    outputs; "fallback" = nulls in this stage's external inputs force the
    partition onto the host path (stages whose host code gives nulls a
    value).
    """

    key: Tuple
    in_cols: Tuple[str, ...]
    out_cols: Tuple[str, ...]
    fn: Callable[[Any, Dict[str, Any]], Dict[str, Any]]
    params: Any = None
    prepare: Optional[Callable] = None
    finalize: Optional[Callable] = None
    device_outputs: Optional[Tuple[str, ...]] = None
    accepts: Optional[Callable] = None   # ({col: probe_row}) -> bool
    null_policy: str = "propagate"
    reject_sparse: bool = True
    drop_invalid: bool = False
    # fn can consume input produced by an upstream device stage in the same
    # segment (False when `prepare` does host work fn cannot replicate —
    # the planner then starts a new segment at this stage)
    internal_ok: bool = True
    terminal: bool = False
    # heavy = worth a device round-trip on its own (NN forward, forest
    # kernel); a segment of only light stages executes on the host path
    heavy: bool = False
    # feature-dim sharding declaration for the fusion planner
    # (parallel/shardplan.py): {input col: dim (batch = 0) that may shard
    # over the mesh's tensor axis}. Batch-dim data parallelism needs none
    # (fn is row independent by contract); a feature candidate is derived
    # for a segment only when every stage declares its external inputs.
    shard_dims: Optional[Dict[str, int]] = None
    # stitchable: this TERMINAL stage's host finalize has a device
    # counterpart (device_finalize below), so the planner may keep the
    # segment OPEN across it when the stitch knob names it. The stage's own
    # finalized columns stay host-only; a later reader of those splits.
    stitchable: bool = False
    # device_finalize: device replacement for the numeric part of
    # `finalize` — (params, env) -> extra device outputs (named by
    # `device_finalize_outputs`) run in the SAME fused program when the
    # stitch knob enables it; `finalize_stitched(outs, ctx)` is the host
    # shim that builds the final columns from those readbacks.
    # `finalize_tolerance` DECLARES the allowed numeric deviation vs the
    # host `finalize` path (the f64 reductions run in f32 on device).
    device_finalize: Optional[Callable] = None
    device_finalize_outputs: Tuple[str, ...] = ()
    finalize_stitched: Optional[Callable] = None
    finalize_tolerance: Optional[float] = None
    # sparse_cols: input columns this stage can consume as a CSR triple
    # instead of a densified [B, F] matrix. For a capable column ``c`` the
    # executor stages four env keys — ``{c}:indptr`` (i32 [B+1]),
    # ``{c}:indices`` (i32 [nnz_pad]), ``{c}:values`` (f32 [nnz_pad]) and
    # ``{c}:width`` (i32 scalar, kept on the host) — and calls ``sparse_fn``
    # in place of ``fn``. The CSR path is opt-in per segment (the ``layout``
    # knob); with the knob off, sparse rows take the host fallback.
    sparse_cols: Tuple[str, ...] = ()
    # sparse_fn(params, env): the CSR body — must produce outputs
    # bitwise-equal to ``fn`` over the densified equivalent of the triple.
    sparse_fn: Optional[Callable] = None

    def __post_init__(self):
        self.in_cols = tuple(self.in_cols)
        self.out_cols = tuple(self.out_cols)
        self.sparse_cols = tuple(self.sparse_cols)
        if self.device_outputs is None:
            self.device_outputs = self.out_cols
        else:
            self.device_outputs = tuple(self.device_outputs)
        self.device_finalize_outputs = tuple(self.device_finalize_outputs)


def _sync_outputs(out: Any) -> None:
    """Wait for the device work behind ``out`` (a tensor or a tuple of
    them) when any of it is on a CUDA device."""
    import torch

    from .graphs import synchronize

    items = out if isinstance(out, (tuple, list)) else (out,)
    for t in items:
        if isinstance(t, (tuple, list)):   # a K-step program's outputs
            _sync_outputs(t)
            return
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            synchronize(t.device)
            return


class _FirstCall:
    """A cached program whose first call runs under the cost tally and is
    timed to the end of its device work; later calls go straight through.
    ``program`` is the built program (eviction releases it, where it holds
    a CUDA graph)."""

    __slots__ = ("program", "_record", "_pending", "_lock")

    def __init__(self, program: Callable, record: Callable):
        self.program = program
        self._record = record
        self._pending = True
        self._lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        if not self._pending:
            return self.program(*args, **kwargs)
        with self._lock:
            first, self._pending = self._pending, False
        if not first:
            return self.program(*args, **kwargs)
        from ..obs.perf import cost_tally

        t0 = time.perf_counter()
        with cost_tally(args) as rec:
            out = self.program(*args, **kwargs)
            rec["_out"] = out
        _sync_outputs(out)
        rec["first_call_ms"] = round((time.perf_counter() - t0) * 1e3, 6)
        self._record(rec)
        return out


def _release(program: Any) -> None:
    """Free what an evicted program holds on the card (its CUDA graphs)."""
    fn = getattr(getattr(program, "program", program), "release", None)
    if callable(fn):
        fn()


class CompileCache:
    """Shared fused-program cache with hit/miss/build-time counters and
    per-(segment, shape-bucket) cost records.

    Key: (segment key, shape signature [, variant/layout/stitch/mega
    tails]). Value: the built program for that signature. ``get`` builds on
    a miss (``compile_time_s`` sums the builders' seconds) and wraps the
    program so that its first call runs under the cost tally
    (obs/perf.py) and is timed to the end of its device work: the tally's
    record, with ``compile_s`` and ``first_call_ms``, is the cost record
    ``costs()`` reports under the caller's ``(label, shape)`` pair.

    Counter updates happen under the cache lock, so a concurrent ``stats()``
    never sees a torn hits/misses/compile_time_s triple.

    The cache is a bounded LRU: a hit refreshes the entry, an insert past
    ``capacity`` evicts the least-recently-used one together with its cost
    record, and releases the program's CUDA graphs and their memory pools
    (a mega program's, core/fusion.py); ``evictions`` counts drops.
    """

    def __init__(self, capacity: int = 256):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._capacity = int(capacity)
        self._entries: Dict[Tuple, Any] = {}
        self._lock = threading.Lock()
        self._costs: Dict[Tuple[str, str], Dict[str, Any]] = {}
        # entry key -> its cost-record key, so eviction can drop the record
        self._cost_key: Dict[Tuple, Tuple[str, str]] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.compile_time_s = 0.0

    def _evict_lru_locked(self) -> Any:
        """Drop the least-recently-used entry (dict order = LRU order: hits
        re-insert at the end) and its cost record; returns the program, for
        the caller to release once the lock is dropped. Lock held."""
        key = next(iter(self._entries))
        fn = self._entries.pop(key)
        ck = self._cost_key.pop(key, None)
        if ck is not None:
            self._costs.pop(ck, None)
        self.evictions += 1
        return fn

    def _wrap(self, built: Callable,
              cost_key: Optional[Tuple[str, str]]) -> Callable:
        """``built``, with its first call tallied into the cost record
        ``cost_key``."""
        if cost_key is None:
            return built

        def record(rec: Dict[str, Any]) -> None:
            with self._lock:
                cur = self._costs.get(cost_key)
                if cur is not None:
                    cur.update({k: (round(v, 6) if isinstance(v, float)
                                    else v) for k, v in rec.items()})

        return _FirstCall(built, record)

    def get(self, key: Tuple, builder: Callable[[], Any],
            label: Optional[str] = None,
            shape: Optional[str] = None) -> Any:
        with self._lock:
            if key in self._entries:
                self.hits += 1
                fn = self._entries.pop(key)   # LRU refresh
                self._entries[key] = fn
                return fn
        t0 = time.perf_counter()
        built = builder()
        dt = time.perf_counter() - t0
        cost_key = (str(label), str(shape)) if label is not None else None
        fn = self._wrap(built, cost_key)
        evicted = []
        with self._lock:
            if key in self._entries:   # another thread built it meanwhile
                out = self._entries[key]
            else:
                self.misses += 1
                self.compile_time_s += dt
                while len(self._entries) >= self._capacity:
                    evicted.append(self._evict_lru_locked())
                self._entries[key] = out = fn
                if cost_key is not None:
                    self._costs[cost_key] = {"compile_s": round(dt, 6)}
                    self._cost_key[key] = cost_key
        for old in evicted:
            _release(old)
        return out

    def costs(self) -> Dict[str, Dict[str, Dict[str, Any]]]:
        """{segment label: {shape bucket: cost record}} — ``compile_s`` and,
        once the program has run, the tally's flops / bytes_accessed /
        argument_bytes / output_bytes [/ peak_memory_bytes] and
        ``first_call_ms`` per cached program."""
        with self._lock:
            out: Dict[str, Dict[str, Dict[str, Any]]] = {}
            for (label, shape), rec in self._costs.items():
                out.setdefault(label, {})[shape] = dict(rec)
            return out

    def segment_cost(self, label: str) -> Optional[Dict[str, float]]:
        """Mean per-batch cost across this segment's cached shape buckets
        (span attrs + quick attribution), or None when nothing recorded."""
        with self._lock:
            recs = [r for (lab, _), r in self._costs.items() if lab == label]
        if not recs:
            return None
        out: Dict[str, float] = {"shape_buckets": float(len(recs))}
        for k in ("flops", "bytes_accessed", "peak_memory_bytes"):
            vals = [r[k] for r in recs if isinstance(r.get(k), (int, float))]
            if vals:
                out[k] = sum(vals) / len(vals)
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "capacity": self._capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": round(self.hits / total, 4) if total else None,
                "compile_time_s": round(self.compile_time_s, 6),
            }


_GLOBAL_CACHE = CompileCache()


def compile_cache() -> CompileCache:
    """The process-wide fused-program cache (shared across pipelines, so
    built programs survive re-planning)."""
    return _GLOBAL_CACHE
