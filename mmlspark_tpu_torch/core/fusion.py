"""Device-resident pipeline fusion: adjacent stages -> one device program.

Counterpart of the reference's ``mmlspark_tpu/core/fusion.py``.
``PipelineModel.transform`` executes stage by stage through host numpy:
every boundary between two device-capable stages pays a readback, a host
re-batching pass and a fresh upload. This module removes those boundaries:

  - ``plan(stages, schema)`` partitions a fitted stage list into maximal
    runs of device-capable stages (``stage.device_fn(schema)`` — see
    core/device_stage.py) plus host stages. A host-only stage splits a
    segment; a ``terminal`` device stage (one whose outputs finalize on
    host, e.g. GBDT's f64 objective transforms) ends one.
  - ``Segment`` composes its stages' device fns into ONE program per batch:
    batches stack once, ride the TransferRing (parallel/ingest.py — pinned
    staging, a copy stream, one step per batch, one readback), and every
    built program is cached in the shared CompileCache keyed by (segment,
    bucketed batch shape, dtype).
  - ``FusedPipelineModel`` is the runner ``PipelineModel.fuse()`` returns.
    Fused output is BITWISE-IDENTICAL to the unfused chain: device fns run
    the same torch ops as the unfused stages; anything host-flavoured runs
    in the stages' prepare/finalize hooks using the unfused code paths, and
    any partition the contract cannot hold for (ragged rows, sparse rows
    with the layout knob off, mixed sparse and dense rows, nulls into a
    ``fallback`` stage, sparse widths over 2^22) falls back to the host
    path per partition, listed in ``fusion_stats()["fallbacks"]``.

With a segment's ``layout`` knob at ``"csr"``, sparse feature rows are
staged as CSR triples (``_stage_csr``, ``_batches``) and the consuming
stage runs its ``sparse_fn`` — for GBDT, the K3 gather of the forest's used
columns (gbdt/gather_kernel.py) — instead of densifying them.

The fused program is an eager composition of torch ops (the reference traces
it with ``jax.jit``); a stage's failure that is not ``FusionUnsupported`` —
a kernel that does not build or launch, a CUDA error — propagates out of
``transform``: only the reference's documented reasons become a host
fallback.

``transform_submit`` / ``SegmentExecutor.submit_run`` are the serving
executor's non-blocking split: the trailing segment dispatches on the
calling thread's stream and a ``resolve()`` waits on that call's CUDA
events alone, so replicas sharing a card do not serialise on each other
(serving/executor.py). Not ported yet: the K-step mega dispatch
(``set_tuning(mega_k=K)`` with K > 1 raises; a CUDA graph beside the Tuner,
ROADMAP A step 6), the cost model and Tuner (A step 6), sharding and pipe
plans (A step 9), persistent caches and the SlotPool deposit path;
``profiling.annotate`` becomes ``torch.profiler.record_function``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import kernels as _kernels
from .dataframe import DataFrame
from .device_stage import CompileCache, DeviceFn, FusionUnsupported, compile_cache
from .pipeline import PipelineModel, Transformer
from .schema import Schema


class _HostFallback(Exception):
    """Internal: this partition must run the unfused path."""


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------


class HostStage:
    """Plan node: a stage executed through its normal transform()."""

    __slots__ = ("stage",)

    def __init__(self, stage: Transformer):
        self.stage = stage

    @property
    def label(self) -> str:
        return type(self.stage).__name__

    def describe(self) -> Dict[str, Any]:
        return {"kind": "host", "stages": [self.label]}


class Segment:
    """Plan node: a maximal run of device-capable stages fused into one
    program per (batch shape, dtype) signature."""

    def __init__(self):
        self.stages: List[Transformer] = []
        self.dfns: List[DeviceFn] = []
        # stage names the plan kept a segment OPEN across: their terminal
        # host finalize runs on the device (DeviceFn.device_finalize), so
        # the boundary they would force disappears; empty unless the stitch
        # knob names them
        self.stitched: List[str] = []
        # out_cols of stitched stages: they materialize only on HOST at
        # finalize time, so no later in-segment stage may consume them
        self.host_cols: set = set()

    # -- construction ----------------------------------------------------
    def add(self, stage: Transformer, dfn: DeviceFn) -> None:
        self.stages.append(stage)
        self.dfns.append(dfn)

    def mark_stitched(self, stage: Transformer, dfn: DeviceFn) -> None:
        """Record that the segment continues PAST this terminal stage: its
        f64 host-finalize reductions run as a device shim
        (``device_finalize``), so downstream device stages keep consuming
        the segment's device-resident columns. The stage's finalized output
        columns stay host-only (``host_cols``) — a later stage reading them
        still splits."""
        self.stitched.append(type(stage).__name__)
        self.host_cols |= set(dfn.out_cols)

    def can_accept(self, dfn: DeviceFn) -> bool:
        if not self.dfns:
            return True
        # a stitched terminal stage's columns exist only on host: a reader
        # cannot join the device program
        if set(dfn.in_cols) & self.host_cols:
            return False
        written = self.written_cols - self.host_cols
        internal_in = set(dfn.in_cols) & written
        if internal_in and not dfn.internal_ok:
            return False
        # a prepare hook may only own external inputs no earlier stage reads
        if dfn.prepare is not None:
            earlier_ext = {c for d in self.dfns for c in d.in_cols
                           if c not in written and c not in self.host_cols}
            if set(dfn.in_cols) & earlier_ext:
                return False
        return True

    # -- derived layout --------------------------------------------------
    @property
    def written_cols(self) -> set:
        return {c for d in self.dfns for c in d.out_cols}

    @property
    def external_in_cols(self) -> List[str]:
        ext: List[str] = []
        written: set = set()
        for d in self.dfns:
            for c in d.in_cols:
                if c not in written and c not in ext:
                    ext.append(c)
            written |= set(d.out_cols)
        return ext

    @property
    def key(self) -> Tuple:
        return tuple(d.key for d in self.dfns)

    @property
    def label(self) -> str:
        return "+".join(type(s).__name__ for s in self.stages)

    @property
    def heavy(self) -> bool:
        return any(d.heavy for d in self.dfns)

    def readback_plan(self, transpiled: Tuple[int, ...] = ()
                      ) -> List[Tuple[str, int]]:
        """(env key, writer dfn index) pairs the executor reads back: each
        column at its FINAL value plus every internal ``__`` key — plus,
        for dfn indices in ``transpiled``, the extra outputs their
        ``device_finalize`` computes on device."""
        final_writer: Dict[str, int] = {}
        for i, d in enumerate(self.dfns):
            for c in d.out_cols:
                final_writer[c] = i
        out: List[Tuple[str, int]] = []
        for i, d in enumerate(self.dfns):
            for k in d.device_outputs:
                if k.startswith("__") or final_writer.get(k) == i:
                    out.append((k, i))
            if i in transpiled:
                out.extend((k, i) for k in d.device_finalize_outputs)
        return out

    def batch_size(self) -> int:
        for s in self.stages:
            if s.has_param("batchSize") and s.get("batchSize"):
                return int(s.get("batchSize"))
        return 256

    def ring_depth(self) -> int:
        for s in self.stages:
            if s.has_param("ringDepth") and s.get("ringDepth"):
                return int(s.get("ringDepth"))
        return 2

    def describe(self) -> Dict[str, Any]:
        out = {"kind": "fused",
               "stages": [type(s).__name__ for s in self.stages],
               "in_cols": self.external_in_cols,
               "out_cols": sorted(self.written_cols),
               "batch_size": self.batch_size()}
        if self.stitched:  # key absent on unstitched plans
            out["stitched"] = list(self.stitched)
        return out


def plan(stages: Sequence[Transformer], schema: Schema,
         fuse_overrides: Optional[Dict[str, bool]] = None,
         stitch_overrides: Optional[Dict[str, bool]] = None) -> List[Any]:
    """Partition a fitted stage chain into HostStage / Segment plan nodes.

    Walks the chain threading the schema through ``transform_schema``; each
    stage offers a DeviceFn via ``device_fn(schema)`` (None or
    ``FusionUnsupported`` = host-only). Segments that carry no heavy stage
    are demoted to host stages — a device round-trip for column plumbing
    alone is a loss — unless ``fuse_overrides`` ({segment label: bool})
    says otherwise.

    ``stitch_overrides`` ({terminal stage class name: bool}) is the stitch
    knob: a ``terminal`` stage normally CLOSES its segment. When the stage
    declares the device shim (``stitchable`` + ``device_finalize`` /
    ``finalize_stitched``) and its override is True, the segment stays OPEN
    across it: downstream device stages keep consuming the segment's
    device-resident columns, while the stage's own finalized columns stay
    host-only. (The reference also lets its cost model decide both; that
    model is not ported yet.)
    """
    nodes: List[Any] = []
    cur: Optional[Segment] = None

    def stitch_across(stage: Transformer, dfn: DeviceFn) -> bool:
        if not (dfn.stitchable and dfn.device_finalize is not None
                and dfn.finalize_stitched is not None):
            return False
        return bool((stitch_overrides or {}).get(type(stage).__name__))

    def keep_fused(seg: Segment) -> bool:
        if fuse_overrides is not None and seg.label in fuse_overrides:
            return bool(fuse_overrides[seg.label])
        return seg.heavy

    def close():
        nonlocal cur
        if cur is not None:
            if keep_fused(cur):
                nodes.append(cur)
            else:
                nodes.extend(HostStage(s) for s in cur.stages)
            cur = None

    for stage in stages:
        try:
            dfn = stage.device_fn(schema)
        except FusionUnsupported:
            dfn = None
        if dfn is None:
            close()
            nodes.append(HostStage(stage))
        else:
            if cur is not None and not cur.can_accept(dfn):
                close()
            if cur is None:
                cur = Segment()
            cur.add(stage, dfn)
            if dfn.terminal:
                if stitch_across(stage, dfn):
                    cur.mark_stitched(stage, dfn)
                else:
                    close()
        try:
            schema = stage.transform_schema(schema.copy())
        except Exception:  # noqa: BLE001 — schema-opaque stage: keep going
            pass
    close()
    return nodes


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------


def _stack_col(col: np.ndarray, allow_sparse: bool, stats=None) -> np.ndarray:
    """Valid-subset column -> dense [n, ...] array, preserving the wire
    dtype (uint8 stays uint8); f64/i64 narrow exactly like the unfused
    ``stack_rows(float32)`` does. A densified sparse column books its waste
    into ``stats`` (``IngestStats.note_densify``): the dense bytes
    materialized vs the CSR bytes the same rows hold."""
    from ..parallel.batching import densify_sparse, is_sparse_row, sparse_width
    from ..parallel.ingest import rows_to_batch

    if col.dtype != object:
        arr = np.asarray(col)
    else:
        probe = next((v for v in col if v is not None), None)
        if probe is None:
            arr = np.zeros((len(col), 0), dtype=np.float32)
        elif is_sparse_row(probe):
            if not allow_sparse:
                raise _HostFallback("sparse rows")
            width = sparse_width(col)
            if width > (1 << 22):
                raise _HostFallback(f"sparse width {width} too large")
            arr = densify_sparse(col, width, dtype=np.float32)
            if stats is not None:
                nnz = sum(len(np.atleast_1d(v["values"]))
                          for v in col if v is not None)
                # CSR bytes: f32 values + i32 indices per nnz, i32 indptr
                stats.note_densify(arr.nbytes, nnz * 8 + (len(col) + 1) * 4)
        else:
            rows = [np.asarray(v) for v in col]
            shapes = {r.shape for r in rows}
            if len(shapes) > 1:
                raise _HostFallback(f"ragged rows {sorted(shapes)}")
            if len({r.dtype for r in rows}) == 1:
                arr = rows_to_batch(rows, stats=stats)
            else:
                arr = np.stack(rows)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    elif arr.dtype == object:
        raise _HostFallback("non-array object rows")
    return np.ascontiguousarray(arr)


def _probe_info(col: np.ndarray) -> Dict[str, Any]:
    """Classify one column for the runtime dtype gates. Scans EVERY
    non-null row for sparseness — a partition whose first row is dense but
    a later row sparse (or vice versa) must read as ``mixed`` and take the
    clean host fallback."""
    from ..parallel.batching import is_sparse_row

    if col.dtype != object:
        return {"dtype": col.dtype, "ndim": col.ndim - 1, "sparse": False,
                "mixed": False}
    probe = None
    n_sparse = n_rows = 0
    for v in col:
        if v is None:
            continue
        if probe is None:
            probe = v
        n_rows += 1
        if is_sparse_row(v):
            n_sparse += 1
    if probe is None:
        return {"dtype": None, "ndim": None, "sparse": False, "mixed": False}
    if n_sparse:
        return {"dtype": np.dtype(np.float32), "ndim": 1, "sparse": True,
                "mixed": n_sparse != n_rows}
    arr = np.asarray(probe)
    return {"dtype": arr.dtype, "ndim": arr.ndim, "sparse": False,
            "mixed": False}


def _csr_from_rows(col: np.ndarray, width: int
                   ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Sparse object column -> (indptr i32 [n+1], indices i32 [nnz],
    values f32 [nnz]). Semantics match ``densify_sparse`` exactly so the
    CSR path stays bitwise-equal to the densify path: indices >= width
    drop, duplicate indices keep the LAST value (numpy fancy assignment),
    explicit zeros stay (they densify to the 0.0 fill), and per-row indices
    sort ascending (the gather kernel's search order). None = ineligible
    (a negative index; the caller densifies instead)."""
    indptr = np.zeros(len(col) + 1, dtype=np.int32)
    idx_parts: List[np.ndarray] = []
    val_parts: List[np.ndarray] = []
    for i, v in enumerate(col):
        if v is None:
            indptr[i + 1] = indptr[i]
            continue
        idx = np.atleast_1d(np.asarray(v["indices"], dtype=np.int64))
        vals = np.atleast_1d(np.asarray(v["values"], dtype=np.float32))
        if idx.size and int(idx.min()) < 0:
            return None
        keep = idx < width
        idx, vals = idx[keep], vals[keep]
        order = np.argsort(idx, kind="stable")
        idx, vals = idx[order], vals[order]
        if idx.size > 1:
            last = np.ones(idx.size, dtype=bool)
            last[:-1] = idx[1:] != idx[:-1]
            idx, vals = idx[last], vals[last]
        idx_parts.append(idx.astype(np.int32))
        val_parts.append(vals)
        indptr[i + 1] = indptr[i] + idx.size
    indices = np.concatenate(idx_parts) if idx_parts \
        else np.zeros(0, dtype=np.int32)
    values = np.concatenate(val_parts) if val_parts \
        else np.zeros(0, dtype=np.float32)
    return indptr, indices, values


def _default_finalize(outs: Dict[str, np.ndarray], ctx: Dict) -> Dict[str, np.ndarray]:
    """Readback arrays -> partition columns: 1-D stays a numeric column,
    [n, ...] becomes an object column of per-row views."""
    cols: Dict[str, np.ndarray] = {}
    for name, arr in outs.items():
        if arr.ndim <= 1:
            cols[name] = arr
        else:
            obj = np.empty(len(arr), dtype=object)
            for i in range(len(arr)):
                obj[i] = arr[i]
            cols[name] = obj
    return cols


def _dtype_name(dt) -> str:
    """numpy-style dtype name of a tensor or array dtype ("float32")."""
    return str(dt).replace("torch.", "")


class _PendingBatch:
    """One submitted batch's readback: the host arrays (pinned tensors on
    CUDA, still being written until ``done`` completes) and what must stay
    alive until then (the step's outputs)."""

    __slots__ = ("outs", "done", "keep")

    def __init__(self, outs: Tuple[Any, ...], done=None, keep=None):
        self.outs = outs
        self.done = done
        self.keep = keep

    def wait(self) -> Tuple[Any, ...]:
        """Block until this batch's copies have landed (its event alone)."""
        if self.done is not None:
            self.done.synchronize()
            self.done = self.keep = None
        return self.outs


class SegmentExecutor:
    """Runs one Segment over a DataFrame, partition by partition and batch
    by batch through the TransferRing, on one device, with cached fused
    programs."""

    def __init__(self, segment: Segment, cache: Optional[CompileCache] = None,
                 buckets: Optional[Tuple[int, ...]] = None,
                 kernel_variants=None, stitch=None,
                 layout: Optional[str] = None,
                 device: Optional[torch.device] = None):
        from ..parallel.ingest import ReadbackSlots
        from ..runtime import resolve_device

        self.segment = segment
        self.cache = cache if cache is not None else compile_cache()
        self.device = resolve_device(device)
        self.fallbacks: List[str] = []
        # bucket SET for short batches (None = power-of-two buckets)
        self.buckets = tuple(sorted(buckets)) if buckets else None
        # kernel_variants maps this segment's shape bucket (or "*") to a
        # core/kernels.py variant id activated around every program call;
        # stitch ({stage class name: bool}) enables each stage's device
        # `device_finalize` in place of the host `finalize` numeric path
        kv: Dict[Any, str] = {}
        for k, v in (kernel_variants or {}).items():
            if not v:
                continue
            try:
                kv[int(k)] = str(v)
            except (TypeError, ValueError):
                kv["*"] = str(v)
        self.kernel_variants = kv
        self.stitch = {str(k): bool(v) for k, v in (stitch or {}).items()}
        # sparse layout knob: "csr" stages capable sparse columns as
        # (indptr, indices, values) triples instead of densifying them
        self.layout = str(layout) if layout else None
        # the ring's host buffers for the readback, reused across partitions
        # and transforms
        self._slots = ReadbackSlots(pin=self.device.type == "cuda")
        # device finalizers: every stage the PLAN stitched the segment
        # across, plus any stage the stitch knob names directly
        self._transpiled: Tuple[int, ...] = tuple(
            i for i, (s, d) in enumerate(zip(segment.stages, segment.dfns))
            if d.device_finalize is not None
            and d.finalize_stitched is not None
            and (type(s).__name__ in segment.stitched
                 or self.stitch.get(type(s).__name__)))
        names = tuple(dict.fromkeys(
            type(segment.stages[i]).__name__ for i in self._transpiled))
        self._stitch_pre = f"stitch={','.join(names)};" if names else ""
        # the stitched program differs under the SAME seg.key: key apart
        self._stitch_tail: Tuple = \
            (("stitch", self._transpiled),) if self._transpiled else ()

    # -- host path -------------------------------------------------------
    def _host_partition(self, part: Dict[str, np.ndarray], schema: Schema
                        ) -> List[Dict[str, np.ndarray]]:
        sub = DataFrame([dict(part)], schema.copy())
        for s in self.segment.stages:
            sub = s.transform(sub)
        return sub.partitions

    # -- fused path ------------------------------------------------------
    def run(self, df: DataFrame, stats) -> DataFrame:
        params = tuple(d.params for d in self.segment.dfns)
        out_parts: List[Dict[str, np.ndarray]] = []
        for part in df.partitions:
            try:
                out_parts.append(self._run_partition(dict(part), params, stats))
            except _HostFallback as e:
                self.fallbacks.append(f"{self.segment.label}: {e}")
                out_parts.extend(self._host_partition(part, df.schema))
        return self._overlay(df, out_parts)

    def _overlay(self, df: DataFrame, out_parts: List[Dict[str, np.ndarray]]
                 ) -> DataFrame:
        """Overlay the chained stage schema onto the produced partitions,
        inferring any column a stage's transform_schema didn't declare."""
        chained = df.schema.copy()
        for s in self.segment.stages:
            try:
                chained = s.transform_schema(chained)
            except Exception:  # noqa: BLE001 — schema-opaque stage
                pass
        inferred = DataFrame(out_parts)
        types = {name: chained.types.get(name, inferred.schema.types[name])
                 for name in inferred.schema.names}
        meta = {k: v for k, v in chained.metadata.items() if k in types}
        return DataFrame(out_parts, Schema(types, meta))

    def _prep_partition(self, part: Dict[str, np.ndarray],
                        stats=None) -> Dict[str, Any]:
        """Host-side prep for one partition — validity masks, per-stage
        prepare hooks, dtype/sparse/null gates, dense stacking and CSR
        staging — everything up to device dispatch. Raises _HostFallback
        when the fused contract cannot hold; returns the execution state."""
        seg = self.segment
        ext = seg.external_in_cols
        for c in ext:
            if c not in part:
                raise _HostFallback(f"missing column {c!r}")
        n = len(part[ext[0]]) if ext else 0

        # nulls into a NaN-filling stage cannot propagate-as-null: host path
        for dfn in seg.dfns:
            if dfn.null_policy != "fallback":
                continue
            for c in dfn.in_cols:
                if c in ext and part[c].dtype == object and \
                        any(v is None for v in part[c]):
                    raise _HostFallback(f"nulls in {c!r}")

        valid = np.ones(n, dtype=bool)
        for c in ext:
            col = part[c]
            if col.dtype == object:
                valid &= np.array([v is not None for v in col], dtype=bool)
        sub = {c: part[c][valid] for c in ext}
        ctx: Dict[str, Any] = {}

        # host prep (segment-external inputs only): the unfused per-row code
        written: set = set()
        for dfn in seg.dfns:
            if dfn.prepare is not None:
                mine = {c: sub[c] for c in dfn.in_cols
                        if c in sub and c not in written}
                if mine:
                    sub.update(dfn.prepare(mine, ctx))
            written |= set(dfn.out_cols)
        # prep can null rows (decode failures): shrink validity like dropNa
        n_valid = int(valid.sum())
        if n_valid:
            keep = np.ones(n_valid, dtype=bool)
            for c in ext:
                col = sub[c]
                if col.dtype == object:
                    keep &= np.array([v is not None for v in col], dtype=bool)
            if not keep.all():
                sub = {c: v[keep] for c, v in sub.items()}
                for k, v in list(ctx.items()):
                    if isinstance(v, np.ndarray) and len(v) == n_valid:
                        ctx[k] = v[keep]
                idx = np.flatnonzero(valid)
                valid = np.zeros(n, dtype=bool)
                valid[idx[keep]] = True
                n_valid = int(valid.sum())

        # runtime dtype gates: a mixed sparse/dense column satisfies no
        # stacking contract — clean host fallback
        probes = {c: _probe_info(sub[c]) for c in ext}
        mixed = sorted(c for c, p in probes.items() if p.get("mixed"))
        if mixed:
            raise _HostFallback(f"mixed sparse/dense rows in {mixed}")
        csr_cols = self._csr_capable(probes)
        for dfn, stage in zip(seg.dfns, seg.stages):
            mine = {c: probes[c] for c in dfn.in_cols if c in probes}
            if mine and dfn.reject_sparse and any(
                    p["sparse"] for c2, p in mine.items()
                    if c2 not in csr_cols):
                raise _HostFallback("sparse rows")
            if mine and dfn.accepts is not None and not dfn.accepts(mine):
                raise _HostFallback(f"{type(stage).__name__} dtype gate")

        readback = seg.readback_plan(self._transpiled)
        state: Dict[str, Any] = {
            "part": part, "sub": sub, "ctx": ctx, "valid": valid, "n": n,
            "n_valid": n_valid, "ext": ext, "staged_cols": list(ext),
            "readback": readback, "keys": [k for k, _ in readback]}
        if n_valid > 0:
            allow_sparse = all(not d.reject_sparse for d in seg.dfns)
            dense: Dict[str, np.ndarray] = {}
            csr: Dict[str, Tuple] = {}
            for c in ext:
                if c in csr_cols:
                    triple = self._stage_csr(sub[c])
                    if triple is not None:
                        csr[c] = triple
                        continue
                    # ineligible / injected sparse.stage fault: accounted
                    # densify fallback — bitwise-equal to the dense path
                    dense[c] = _stack_col(sub[c], True, stats=stats)
                    continue
                dense[c] = _stack_col(sub[c], allow_sparse, stats=stats)
            state["dense"] = dense
            if csr:
                state["csr"] = csr
                staged: List[str] = []
                for c in ext:
                    if c in csr:
                        staged += [f"{c}:indptr", f"{c}:indices",
                                   f"{c}:values", f"{c}:width"]
                    else:
                        staged.append(c)
                state["staged_cols"] = staged
        return state

    def _csr_capable(self, probes: Dict[str, Dict[str, Any]]) -> set:
        """External columns eligible for CSR staging: the layout knob says
        "csr" for this segment, the column's rows are (uniformly) sparse,
        and EVERY consuming stage declares the capability
        (``DeviceFn.sparse_cols`` + ``sparse_fn``)."""
        if self.layout != "csr":
            return set()
        out = set()
        for c, p in probes.items():
            if not p["sparse"] or p.get("mixed"):
                continue
            consumers = [d for d in self.segment.dfns if c in d.in_cols]
            if consumers and all(c in d.sparse_cols
                                 and d.sparse_fn is not None
                                 for d in consumers):
                out.add(c)
        return out

    def _stage_csr(self, col: np.ndarray) -> Optional[Tuple]:
        """One sparse column -> (indptr, indices, values, width), or None
        to take the accounted densify fallback (zero-width column, an i32
        composite-key overflow, a negative index, or an injected
        ``sparse.stage`` fault)."""
        from ..parallel.batching import sparse_width

        from . import faults

        width = sparse_width(col)
        # the gather's composite keys row*width + index must fit i32 (the
        # reference's kernel builds them in i32; the gate is kept as it is)
        if width <= 0 or self.segment.batch_size() * width >= (1 << 31):
            return None
        try:
            faults.fire(faults.SPARSE_STAGE)
        except faults.InjectedFault:
            return None
        triple = _csr_from_rows(col, width)
        if triple is None:
            return None
        indptr, indices, values = triple
        return indptr, indices, values, width

    def _batches(self, state: Dict[str, Any], stats=None):
        """Padded/bucketed Batch stream over the partition's staged
        arrays. Each CSR-staged batch books its triple's bytes against the
        dense bytes the densify path would ship (``IngestStats.note_csr``,
        once per batch; the reference books once per partition)."""
        from ..parallel.batching import Batch, next_bucket, pad_batch

        batch_size = self.segment.batch_size()
        dense = state["dense"]
        csr = state.get("csr") or {}
        n_valid = state["n_valid"]
        for start in range(0, n_valid, batch_size):
            stop = min(start + batch_size, n_valid)
            m = stop - start
            target = batch_size if m == batch_size \
                else min(next_bucket(m, buckets=self.buckets), batch_size)
            arrays = {c: pad_batch(dense[c][start:stop], target)
                      for c in dense}
            for c, (indptr, indices, values, width) in csr.items():
                # CSR window slice: rebase the indptr to this window and pad
                # row-wise by REPEATING the last offset (pad rows are empty),
                # nnz-wise to a power-of-two bucket with zeros. Padded nnz
                # entries lie past indptr[target]: they belong to no row.
                base = int(indptr[start])
                nnz_b = int(indptr[stop]) - base
                ip = (indptr[start:stop + 1] - base).astype(np.int32)
                if m < target:
                    ip = np.pad(ip, (0, target - m), mode="edge")
                nnz_pad = next_bucket(max(1, nnz_b))
                idx = np.pad(np.asarray(indices[base:base + nnz_b],
                                        dtype=np.int32),
                             (0, nnz_pad - nnz_b))
                val = np.pad(np.asarray(values[base:base + nnz_b],
                                        dtype=np.float32),
                             (0, nnz_pad - nnz_b))
                arrays[f"{c}:indptr"] = ip
                arrays[f"{c}:indices"] = idx
                arrays[f"{c}:values"] = val
                arrays[f"{c}:width"] = np.asarray(width, dtype=np.int32)
                if stats is not None:
                    stats.note_csr(nnz_b * 8 + (m + 1) * 4, m * width * 4)
            mask = np.zeros(target, dtype=bool)
            mask[:m] = True
            yield Batch(arrays, mask, m)

    def _put(self, batch) -> Tuple[Dict[str, torch.Tensor], int]:
        from ..parallel.ingest import stage_array

        return ({c: stage_array(a, self.device)
                 for c, a in batch.arrays.items()}, batch.num_valid)

    @staticmethod
    def _sig_of(x, ext) -> Tuple:
        """Shape signature of one staged input dict (CompileCache key)."""
        return tuple((c, tuple(x[c].shape), _dtype_name(x[c].dtype))
                     for c in ext)

    @staticmethod
    def _shape_key_of(sig) -> str:
        return ";".join(f"{c}={'x'.join(str(d) for d in shp)}:{dt}"
                        for c, shp, dt in sig)

    def _variant_for(self, sig) -> Optional[str]:
        """Kernel-variant id active for one shape signature: the tuned
        per-bucket entry (bucket = leading dim of the first staged input),
        falling back to the ``"*"`` wildcard; None = built-in default."""
        kv = self.kernel_variants
        if not kv:
            return None
        vid = None
        if sig and sig[0][1]:
            vid = kv.get(int(sig[0][1][0]))
        if vid is None:
            vid = kv.get("*")
        return vid

    def _make_step(self, params, state: Dict[str, Any]):
        """Dispatch closure: staged batch -> (device outputs, num_valid).
        Non-blocking (the ops are queued on the compute stream); programs
        come from the shared CompileCache keyed by (segment, shape
        signature)."""
        seg, keys = self.segment, state["keys"]
        staged_cols = state.get("staged_cols") or state["ext"]
        csr_cols = frozenset(state.get("csr") or ())
        key_tail = self._stitch_tail
        shape_pre = self._stitch_pre
        if csr_cols:
            # a CSR-staged program runs sparse_fn bodies over the triple:
            # key it apart, and prefix the shape key
            key_tail = key_tail + (("layout", "csr"),)
            shape_pre = "layout=csr;" + shape_pre

        def step(staged):
            x, m = staged
            sig = self._sig_of(x, staged_cols)
            # a kernel variant is a DIFFERENT program for the same
            # (segment, signature): key it apart, and decorate the shape
            # key (variant=<id>;)
            vid = self._variant_for(sig)
            tail = key_tail + ((("variant", vid),) if vid else ())
            pre = (f"variant={vid};" if vid else "") + shape_pre
            program = self.cache.get(
                (seg.key, sig) + tail,
                lambda: self._build(keys, variant=vid, csr_cols=csr_cols),
                label=seg.label, shape=pre + self._shape_key_of(sig))
            with torch.profiler.record_function(f"fused:{seg.label}"):
                return program(params, x), m

        return step

    @staticmethod
    def _fetch(handle) -> Tuple[torch.Tensor, ...]:
        ys, m = handle
        return tuple(y[:m] for y in ys)

    def _run_partition(self, part: Dict[str, np.ndarray], params,
                       stats) -> Dict[str, np.ndarray]:
        from ..parallel.ingest import TransferRing

        state = self._prep_partition(part, stats)
        collected: Dict[str, List[np.ndarray]] = {k: []
                                                  for k in state["keys"]}
        if state["n_valid"] > 0:
            ring = TransferRing(self._batches(state, stats), put=self._put,
                                step=self._make_step(params, state),
                                fetch=self._fetch,
                                depth=self.segment.ring_depth(), stats=stats,
                                device=self.device, slots=self._slots)
            try:
                for out in ring:
                    for k, y in zip(state["keys"], out):
                        collected[k].append(y)
            except FusionUnsupported as e:
                raise _HostFallback(str(e))
        return self._emit_partition(state, collected)

    def _readback_async(self, handle) -> "_PendingBatch":
        """Queue one dispatched batch's readback behind its step, on the
        calling thread's current stream: each output (cropped to the valid
        rows) copies into a pinned host buffer of its own, and a CUDA event
        marks the end. The buffers belong to this batch alone, so a later
        batch cannot overwrite them before ``resolve`` copies out."""
        ys = self._fetch(handle)
        if self.device.type != "cuda":
            return _PendingBatch(tuple(y.numpy().copy() for y in ys))
        hosts = tuple(torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
                      for y in ys)
        for h, y in zip(hosts, ys):
            h.copy_(y, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return _PendingBatch(hosts, done, keep=(handle, ys))

    def submit_run(self, df: DataFrame, stats):
        """Non-blocking segment execution: prep, stage and DISPATCH every
        partition's batches now, on the calling thread's current stream,
        each batch's readback queued behind it (``_readback_async``); the
        returned zero-arg ``resolve()`` waits on those batches' events (not
        on a stream, so another replica's work on the card is never waited
        for), copies the outputs out and finalizes. ``resolve()`` output is
        bitwise-identical to ``run()``: the same programs over the same
        batches.

        Host-fallback partitions (ragged/sparse/null/dtype violations)
        execute synchronously at submit time -- never a wrong answer."""
        from ..obs.trace import current_batch
        from ..parallel.ingest import timed_stage

        seg = self.segment
        obs = current_batch()  # serving batch's trace binding (or None)
        wall0 = time.perf_counter()
        t_wall = time.time()
        params = tuple(d.params for d in seg.dfns)
        pendings: List[Tuple[str, Any, Any]] = []
        for part in df.partitions:
            try:
                state = self._prep_partition(dict(part), stats)
                handles = []
                if state["n_valid"] > 0:
                    step = self._make_step(params, state)
                    for batch in self._batches(state, stats):
                        staged, timing = timed_stage(self._put, batch)
                        td = time.perf_counter()
                        pending = self._readback_async(step(staged))
                        timing.dispatch_s = time.perf_counter() - td
                        handles.append((pending, timing))
                pendings.append(("device", state, handles))
            except (_HostFallback, FusionUnsupported) as e:
                self.fallbacks.append(f"{seg.label}: {e}")
                pendings.append(
                    ("host", self._host_partition(part, df.schema), None))

        def resolve() -> DataFrame:
            out_parts: List[Dict[str, np.ndarray]] = []
            for kind, payload, handles in pendings:
                if kind == "host":
                    out_parts.extend(payload)
                    continue
                state = payload
                collected: Dict[str, List[np.ndarray]] = {
                    k: [] for k in state["keys"]}
                for pending, timing in handles:
                    t0 = time.perf_counter()
                    out = pending.wait()
                    timing.compute_s = time.perf_counter() - t0
                    timing.resolve_h2d()
                    t1 = time.perf_counter()
                    out = tuple(o.numpy().copy() if isinstance(o, torch.Tensor)
                                else o for o in out)
                    timing.readback_s = time.perf_counter() - t1
                    stats.record(timing)
                    for k, y in zip(state["keys"], out):
                        collected[k].append(y)
                out_parts.append(self._emit_partition(state, collected))
            stats.add_wall(time.perf_counter() - wall0)
            if obs is not None:
                tracer, ctxs = obs
                tracer.record_batch(f"segment:{seg.label}", ctxs, t_wall,
                                    time.perf_counter() - wall0)
            return self._overlay(df, out_parts)

        return resolve

    def _emit_partition(self, state: Dict[str, Any],
                        collected: Dict[str, List[np.ndarray]]
                        ) -> Dict[str, np.ndarray]:
        """Readback arrays -> finalized partition columns (per writer
        stage, scattered over the validity mask)."""
        seg = self.segment
        part, ctx = state["part"], state["ctx"]
        valid, n, n_valid = state["valid"], state["n"], state["n_valid"]
        readback = state["readback"]
        full = {k: (np.concatenate(v, axis=0) if v
                    else np.zeros((0,), dtype=np.float32))
                for k, v in collected.items()}

        by_writer: Dict[int, Dict[str, np.ndarray]] = {}
        for k, i in readback:
            by_writer.setdefault(i, {})[k] = full[k]
        out_part = dict(part)
        transpiled = set(self._transpiled)
        for i, dfn in enumerate(seg.dfns):
            outs = by_writer.get(i)
            if outs is None:
                continue
            if n_valid == 0:
                cols = {c: np.empty(0, dtype=object) for c in dfn.out_cols}
            elif i in transpiled:
                # the numeric reductions already ran on device
                # (device_finalize); this host shim only shapes the
                # readbacks into columns
                cols = dfn.finalize_stitched(outs, ctx)
            elif dfn.finalize is not None:
                cols = dfn.finalize(outs, ctx)
            else:
                cols = _default_finalize(outs, ctx)
            for c in dfn.out_cols:
                if c not in cols:
                    continue
                col = cols[c]
                if n_valid == n:
                    out_part[c] = col
                else:
                    scat = np.empty(n, dtype=object)
                    scat[np.flatnonzero(valid)] = col
                    out_part[c] = scat
        if any(d.drop_invalid for d in seg.dfns) and n_valid < n:
            out_part = {k: v[valid] for k, v in out_part.items()}
        return out_part

    def _build(self, keys: List[str], variant: Optional[str] = None,
               csr_cols: frozenset = frozenset()):
        """The fused program for one shape signature: every stage's body in
        order over one env of staged tensors, with the kernel ``variant``
        active around each call (core/kernels.py). A stage whose input
        column was CSR-staged (``csr_cols``) runs its ``sparse_fn`` over the
        triple's env keys instead of ``fn`` — the only point where the two
        bodies diverge."""
        seg = self.segment
        transpiled = set(self._transpiled)

        def fused(params_tuple, cols):
            with _kernels.activate(variant):
                env = dict(cols)
                for i, (dfn, p) in enumerate(zip(seg.dfns, params_tuple)):
                    if dfn.sparse_fn is not None and \
                            csr_cols & set(dfn.in_cols):
                        env.update(dfn.sparse_fn(p, env))
                    else:
                        env.update(dfn.fn(p, env))
                    if i in transpiled:
                        env.update(dfn.device_finalize(p, env))
                return tuple(env[k] for k in keys)

        return fused


# ---------------------------------------------------------------------------
# FusedPipelineModel
# ---------------------------------------------------------------------------


class FusedPipelineModel(PipelineModel):
    """PipelineModel whose transform executes the fused plan.

    Fusion is an EXECUTION STRATEGY, not a persisted artifact; the class is
    kept out of the stage registry (``_abstract``). Plans are cached per
    (schema, device): a stage's DeviceFn closes over its model's tensors on
    the device the plan was made for.
    """

    _abstract = True

    def __init__(self, stages=None, cache: Optional[CompileCache] = None,
                 **kwargs):
        super().__init__(stages, **kwargs)
        self._cache = cache if cache is not None else compile_cache()
        self._plans: Dict[Tuple, List[Any]] = {}
        self._seg_stats: Dict[str, Any] = {}
        self._last_fallbacks: List[str] = []
        self._last_plan: Optional[List[Any]] = None
        # tuning knobs (all default OFF: an untuned model plans, buckets
        # and dispatches as the plain defaults say)
        self._bucket_overrides: Dict[str, Tuple[int, ...]] = {}
        self._fuse_overrides: Dict[str, bool] = {}
        self._variant_overrides: Dict[str, Dict[Any, str]] = {}
        self._stitch_overrides: Dict[str, bool] = {}
        self._layout_overrides: Dict[str, str] = {}

    def fuse(self) -> "FusedPipelineModel":
        return self

    def set_tuning(self, buckets: Optional[Dict[str, Tuple[int, ...]]] = None,
                   fuse: Optional[Dict[str, bool]] = None,
                   kernel_variants: Optional[Dict[str, Dict[Any, str]]] = None,
                   stitch: Optional[Dict[str, bool]] = None,
                   layout: Optional[Dict[str, str]] = None,
                   mega_k: Optional[Dict[str, int]] = None) -> None:
        """Apply knobs: per-segment-label bucket sets, fuse-vs-demote
        overrides, per-segment kernel-variant maps ({label: {bucket|"*":
        variant id}}), per-stage-name stitch flags, and per-segment layouts
        ({label: "csr"}). Passing None leaves a knob unchanged; passing {}
        clears it. Cached plans are invalidated (built programs survive in
        the CompileCache).

        ``mega_k`` ({label: K}) is the reference's K-step mega dispatch;
        K = 1 is the plain per-batch dispatch every segment runs. A K-step
        program means capturing a CUDA graph, which belongs with the Tuner
        (ROADMAP A step 6): any K > 1 raises ``NotImplementedError``."""
        if mega_k is not None and any(int(k) > 1 for k in mega_k.values()):
            raise NotImplementedError(
                "K-step mega dispatch (mega_k > 1) is not ported yet: it "
                "waits for CUDA-graph capture beside the Tuner (ROADMAP A "
                "step 6)")
        if kernel_variants is not None:
            self._variant_overrides = {
                str(k): dict(v) for k, v in kernel_variants.items() if v}
        if stitch is not None:
            self._stitch_overrides = {str(k): bool(v)
                                      for k, v in stitch.items()}
        if buckets is not None:
            self._bucket_overrides = {
                str(k): tuple(sorted(int(b) for b in v))
                for k, v in buckets.items()}
        if fuse is not None:
            self._fuse_overrides = {str(k): bool(v)
                                    for k, v in fuse.items()}
        if layout is not None:
            self._layout_overrides = {str(k): str(v)
                                      for k, v in layout.items() if v}
        self._plans.clear()

    @property
    def compile_cache(self) -> CompileCache:
        """The program cache this model's segments build into."""
        return self._cache

    def _plan_for(self, schema: Schema, device: torch.device) -> List[Any]:
        key = (tuple(schema.types.items()), str(device))
        if key not in self._plans:
            self._plans[key] = plan(
                self._stages, schema.copy(),
                fuse_overrides=self._fuse_overrides or None,
                stitch_overrides=self._stitch_overrides or None)
        return self._plans[key]

    def _make_executor(self, node: Segment,
                       device: torch.device) -> SegmentExecutor:
        return SegmentExecutor(
            node, self._cache,
            buckets=self._bucket_overrides.get(node.label),
            kernel_variants=self._variant_overrides.get(node.label),
            stitch=self._stitch_overrides or None,
            layout=self._layout_overrides.get(node.label),
            device=device)

    def transform(self, df: DataFrame, fused: bool = True) -> DataFrame:
        if not fused:
            return PipelineModel.transform(self, df)
        from ..parallel.ingest import IngestStats
        from ..runtime import default_device

        device = default_device()
        nodes = self._plan_for(df.schema, device)
        self._last_plan = nodes
        self._seg_stats = {}
        self._last_fallbacks = []
        for node in nodes:
            if isinstance(node, Segment):
                stats = IngestStats()
                self._seg_stats[node.label] = stats
                ex = self._make_executor(node, device)
                df = ex.run(df, stats)
                self._last_fallbacks.extend(ex.fallbacks)
            else:
                df = node.stage.transform(df)
        return df

    def transform_submit(self, df: DataFrame):
        """Non-blocking transform: run host stages and all but a TRAILING
        fused segment now; the trailing segment's batches are staged and
        dispatched on the calling thread's stream, and the returned
        zero-arg ``resolve()`` waits on their events, reads back and
        finalizes. ``transform_submit(df)()`` is bitwise-identical to
        ``transform(df)`` -- the serving executor uses this split to
        fulfill replies from its readback thread while the next batch
        dispatches."""
        from ..parallel.ingest import IngestStats
        from ..runtime import default_device

        device = default_device()
        nodes = self._plan_for(df.schema, device)
        self._last_plan = nodes
        self._seg_stats = {}
        self._last_fallbacks = []
        tail = nodes[-1] if nodes and isinstance(nodes[-1], Segment) else None
        body = nodes[:-1] if tail is not None else nodes
        for node in body:
            if isinstance(node, Segment):
                stats = IngestStats()
                self._seg_stats[node.label] = stats
                ex = self._make_executor(node, device)
                df = ex.run(df, stats)
                self._last_fallbacks.extend(ex.fallbacks)
            else:
                df = node.stage.transform(df)
        if tail is None:
            out = df
            return lambda: out
        stats = IngestStats()
        self._seg_stats[tail.label] = stats
        ex = self._make_executor(tail, device)
        resolve = ex.submit_run(df, stats)

        def done() -> DataFrame:
            out = resolve()
            self._last_fallbacks.extend(ex.fallbacks)
            return out

        return done

    # -- stats surface ---------------------------------------------------
    @property
    def last_ingest_stats(self):
        """Aggregated ingest decomposition across fused segments of the most
        recent transform (None before the first / when nothing fused)."""
        from ..parallel.ingest import IngestStats

        if not self._seg_stats:
            return None
        agg = IngestStats()
        for st in list(self._seg_stats.values()):
            agg.merge(st)
        return agg

    def fusion_stats(self) -> Dict[str, Any]:
        """Segment layout + per-segment ingest + compile-cache counters +
        per-program cost records (build seconds, first-call ms)."""
        nodes = self._last_plan or []
        out = {
            "segments": [n.describe() for n in nodes],
            "n_fused_segments": sum(isinstance(n, Segment) for n in nodes),
            "per_segment": {label: s.summary()
                            for label, s in self._seg_stats.items()},
            "fallbacks": list(self._last_fallbacks),
            "compile_cache": self._cache.stats(),
            "segment_costs": self._cache.costs(),
        }
        if (self._bucket_overrides or self._fuse_overrides
                or self._variant_overrides or self._stitch_overrides
                or self._layout_overrides):
            out["tuning"] = {
                "buckets": {k: list(v)
                            for k, v in self._bucket_overrides.items()},
                "fuse": dict(self._fuse_overrides)}
            if self._variant_overrides:
                out["tuning"]["kernel_variants"] = {
                    label: {str(b): v for b, v in kv.items()}
                    for label, kv in self._variant_overrides.items()}
            if self._stitch_overrides:
                out["tuning"]["stitch"] = dict(self._stitch_overrides)
            if self._layout_overrides:
                out["tuning"]["layout"] = dict(self._layout_overrides)
        stitched: Dict[str, List[str]] = {}
        for n in nodes:
            if not isinstance(n, Segment):
                continue
            names = list(n.stitched)
            names += [type(s).__name__
                      for s, d in zip(n.stages, n.dfns)
                      if d.device_finalize is not None
                      and d.finalize_stitched is not None
                      and self._stitch_overrides.get(type(s).__name__)]
            if names:
                stitched[n.label] = list(dict.fromkeys(names))
        if stitched:  # key absent when nothing stitched
            out["stitched"] = stitched
        return out
