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
(serving/executor.py).

The K-step mega dispatch (``set_tuning(mega_k={label: K})``, the Tuner's
knob) sends K queued micro-batches of one signature through one call: the
reference traces K copies of the per-batch body into one XLA executable;
here the K-step program (``_MegaProgram``) is one ``torch.cuda.CUDAGraph``
of K runs of the same eager per-batch program over K static input sets,
captured once per (cache key, K, stream) and replayed after — one replay
for K batches, its launches counted through the replay (core/graphs.py).
On the CPU a K-step program is K sequential eager calls. A capture or
replay that fails raises; nothing runs K eager calls in its place on a
card.

The cost model (core/costmodel.py) feeds the planner's fuse-vs-demote and
stitch decisions and learns from the executor's host-path timings and
sparse densities; the slot pool (parallel/ingest.py ``SlotPool``) lets a
column of uniform dense rows deposit straight into a reusable (pinned, on
CUDA) staging slot, filled ahead on a thread.

Over a mesh (``FusedPipelineModel.set_mesh``), the ``sharding`` knob
({label: "data" | "feature"}) runs a segment sharded
(parallel/shardplan.py) and ``pipe_depth`` streams a chainable run of
segments over pipe-axis sub-meshes (parallel/pipeplan.py). The port's mesh
is one process a rank: every rank calls ``set_mesh``, ``set_tuning`` and
``transform`` on the same frame and returns the whole of it. A sharded
K-step program captures only the rank's own compute; its collectives run
outside the graph. Not ported: the persistent cache tier (ROADMAP A step
10). ``profiling.annotate`` becomes ``torch.profiler.record_function``.
"""

from __future__ import annotations

import threading
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
         cost_model=None,
         fuse_overrides: Optional[Dict[str, bool]] = None,
         stitch_overrides: Optional[Dict[str, bool]] = None) -> List[Any]:
    """Partition a fitted stage chain into HostStage / Segment plan nodes.

    Walks the chain threading the schema through ``transform_schema``; each
    stage offers a DeviceFn via ``device_fn(schema)`` (None or
    ``FusionUnsupported`` = host-only). Segments that carry no heavy stage
    are demoted to host stages — a device round-trip for column plumbing
    alone is a loss.

    ``cost_model`` (core/costmodel.py SegmentCostModel) upgrades that
    demotion heuristic to a PREDICTED fuse-vs-host comparison:
    ``fuse_decision(label)`` returning True keeps a light segment fused,
    False demotes it, None (uncalibrated) falls back to the heuristic — so
    plans from an uncalibrated model are identical to the default.
    ``fuse_overrides`` ({label: bool}, the Tuner's applied knob) wins over
    both.

    ``stitch_overrides`` ({terminal stage class name: bool}) is the stitch
    knob: a ``terminal`` stage normally CLOSES its segment. When the stage
    declares the device shim (``stitchable`` + ``device_finalize`` /
    ``finalize_stitched``) and its override is True — or, with no
    override, ``cost_model.stitch_decision(segment label, stage name)``
    prices the merge as worth it (None while uncalibrated) — the segment
    stays OPEN across it: downstream device stages keep consuming the
    segment's device-resident columns, while the stage's own finalized
    columns stay host-only.
    """
    nodes: List[Any] = []
    cur: Optional[Segment] = None

    def stitch_across(seg: Segment, stage: Transformer,
                      dfn: DeviceFn) -> bool:
        if not (dfn.stitchable and dfn.device_finalize is not None
                and dfn.finalize_stitched is not None):
            return False
        name = type(stage).__name__
        if stitch_overrides is not None and name in stitch_overrides:
            return bool(stitch_overrides[name])
        if cost_model is not None:
            try:
                decision = cost_model.stitch_decision(seg.label, name)
            except Exception:  # noqa: BLE001 — a model bug must not kill plan
                decision = None
            return bool(decision)
        return False

    def keep_fused(seg: Segment) -> bool:
        if fuse_overrides is not None and seg.label in fuse_overrides:
            return bool(fuse_overrides[seg.label])
        if seg.heavy:
            return True
        if cost_model is not None:
            try:
                decision = cost_model.fuse_decision(seg.label)
            except Exception:  # noqa: BLE001 — a model bug must not kill plan
                decision = None
            if decision is not None:
                return decision
        return False

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
                if stitch_across(cur, stage, dfn):
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
                 cost_model=None, slot_pool=None, mega_k: int = 1,
                 kernel_variants=None, stitch=None,
                 layout: Optional[str] = None,
                 device: Optional[torch.device] = None, sharding=None):
        from ..parallel.ingest import ReadbackSlots
        from ..runtime import resolve_device

        self.segment = segment
        self.cache = cache if cache is not None else compile_cache()
        self.device = resolve_device(device)
        self.fallbacks: List[str] = []
        # bucket SET for short batches (None = power-of-two buckets)
        self.buckets = tuple(sorted(buckets)) if buckets else None
        # cost model fed by host-fallback timings and sparse densities
        self.cost_model = cost_model
        # pre-allocated staging slots (parallel/ingest.py SlotPool); None =
        # the allocating path
        self.slot_pool = slot_pool
        # K-step mega-dispatch factor for the submit path (the Tuner's
        # knob, costmodel.choose_mega_k); 1 = per-batch dispatch
        self.mega_k = max(1, int(mega_k or 1))
        # mesh sharding (parallel/shardplan.py SegmentSharding, or a pipe
        # stage's pipeplan.PipeStageSharding); None = the single-device path
        self.sharding = sharding
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

    def _cost_attrs(self) -> Dict[str, Any]:
        """Tallied cost attrs for this segment's trace spans (mean per-batch
        flops/bytes across cached shape buckets; empty when none was
        recorded) — a traced p99 spike carries its cost context."""
        cost = self.cache.segment_cost(self.segment.label)
        if not cost:
            return {}
        out: Dict[str, Any] = {}
        for k in ("flops", "bytes_accessed", "peak_memory_bytes"):
            if k in cost:
                out[k] = round(cost[k], 1)
        return out

    # -- host path -------------------------------------------------------
    def _host_partition(self, part: Dict[str, np.ndarray], schema: Schema
                        ) -> List[Dict[str, np.ndarray]]:
        sub = DataFrame([dict(part)], schema.copy())
        n = len(next(iter(part.values()))) if part else 0
        for s in self.segment.stages:
            t0 = time.perf_counter()
            sub = s.transform(sub)
            if self.cost_model is not None and n > 0:
                # the measured HOST side of the fuse-vs-host comparison
                self.cost_model.observe_host(
                    type(s).__name__, time.perf_counter() - t0, n)
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
        # density term (costmodel.observe_nnz): fed for EVERY sparse
        # external column — including ones about to take the reject_sparse
        # host fallback — so choose_layout can calibrate while the layout
        # knob is still off. Observation only; outputs are untouched.
        if self.cost_model is not None and n_valid > 0:
            from ..parallel.batching import sparse_width

            for c in ext:
                if probes[c]["sparse"]:
                    nnz = sum(len(np.atleast_1d(v["values"]))
                              for v in sub[c] if v is not None)
                    self.cost_model.observe_nnz(
                        seg.label, n_valid, nnz, sparse_width(sub[c]))
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
            deposit: Dict[str, List[np.ndarray]] = {}
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
                rows = self._deposit_rows(sub[c]) \
                    if self.slot_pool is not None else None
                if rows is not None:
                    # slot-eligible: the stack is deferred to _batches,
                    # which fills a pre-allocated SlotPool buffer directly
                    # (the one host copy)
                    deposit[c] = rows
                else:
                    dense[c] = _stack_col(sub[c], allow_sparse, stats=stats)
            state["dense"] = dense
            state["deposit"] = deposit
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
        (``DeviceFn.sparse_cols`` + ``sparse_fn``). Off under sharding, as
        in the reference: a sharded segment keeps the densify path
        (shardplan's ``csr_row`` spec is priced on the host only)."""
        if self.layout != "csr" or self.sharding is not None:
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

    @staticmethod
    def _deposit_rows(col: np.ndarray) -> Optional[List[np.ndarray]]:
        """Rows eligible for slot deposit: an object column of uniform,
        dense ndarray rows whose dtype ships as-is (no f64->f32 / i64->i32
        narrowing and no sparse densify — those transforms need their own
        allocation), so filling the staging slot IS the single host copy.
        Every fallback decision is made HERE, before any generator runs on
        a fill thread. None = take ``_stack_col`` (the copying path)."""
        if col.dtype != object or len(col) == 0:
            return None
        rows = list(col)
        first = rows[0]
        if not isinstance(first, np.ndarray):
            return None
        shape, dt = first.shape, first.dtype
        if dt == object or dt in (np.dtype(np.float64), np.dtype(np.int64)):
            return None
        for r in rows[1:]:
            if not isinstance(r, np.ndarray) or r.shape != shape \
                    or r.dtype != dt:
                return None
        return rows

    def _batches(self, state: Dict[str, Any], stats=None):
        """Padded/bucketed Batch stream over the partition's staged
        arrays. Each CSR-staged batch books its triple's bytes against the
        dense bytes the densify path would ship (``IngestStats.note_csr``,
        once per batch; the reference books once per partition).

        Deposit-eligible columns (``state["deposit"]``) fill a
        pre-allocated SlotPool buffer in place — stack + pad collapse into
        one copy into the reusable staging slot; slot contention (acquire
        timeout) falls back to the allocating path with an accounted copy
        (``IngestStats.note_copy``)."""
        from ..parallel.batching import Batch, next_bucket, pad_batch
        from ..parallel.ingest import rows_to_batch

        batch_size = self.segment.batch_size()
        dense = state["dense"]
        deposit = state.get("deposit") or {}
        csr = state.get("csr") or {}
        n_valid = state["n_valid"]
        # sharded: every padded batch splits evenly over the shards, so the
        # target rounds up to a shard multiple (the pad rows are masked out
        # at readback like a bucket's)
        shards = self.sharding.shards if self.sharding is not None else 1
        for start in range(0, n_valid, batch_size):
            stop = min(start + batch_size, n_valid)
            m = stop - start
            target = batch_size if m == batch_size \
                else min(next_bucket(m, buckets=self.buckets), batch_size)
            if shards > 1:
                target = -(-target // shards) * shards
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
            lease = None
            if deposit:
                spec = {c: ((target,) + rows[0].shape, rows[0].dtype)
                        for c, rows in deposit.items()}
                lease = self.slot_pool.acquire(spec, stats=stats) \
                    if self.slot_pool is not None else None
                if lease is not None:
                    lease.fill_begin()
                    for c, rows in deposit.items():
                        buf = lease.arrays[c]
                        rows_to_batch(rows[start:stop], out=buf,
                                      stats=stats)
                        if m < target:
                            buf[m:] = 0  # pad parity with pad_batch zeros
                        arrays[c] = buf
                    lease.fill_end()
                    if stats is not None:
                        stats.note_deposit()
                else:
                    for c, rows in deposit.items():
                        arrays[c] = pad_batch(
                            rows_to_batch(rows[start:stop], stats=stats),
                            target)
                    if stats is not None:
                        stats.note_copy()
            mask = np.zeros(target, dtype=bool)
            mask[:m] = True
            yield Batch(arrays, mask, m, staging=lease)

    def _put(self, batch) -> Tuple[Any, ...]:
        """Stage one batch on the device: a slot-deposited column copies
        from its (pinned, on CUDA) slot tensor directly; every other array
        goes through ``stage_array``. Sharded, each column lands as this
        rank's block (``sharding.device_put``), and the batch's whole
        shapes ride along: ``(staged, num_valid, shapes)``. A staging
        failure there (a card dropping out mid-stage, the
        ``mesh.chip_wedge`` seam) comes back in place of the staged dict,
        and the step turns it into the partition's host fallback on every
        rank."""
        from ..parallel.ingest import stage_array

        sh = self.sharding
        if sh is not None and sh.splits:
            full = {c: tuple(np.shape(a)) for c, a in batch.arrays.items()}
            return (sh.device_put(batch.arrays, self.device),
                    batch.num_valid, full)

        lease = getattr(batch, "staging", None)
        out: Dict[str, torch.Tensor] = {}
        for c, a in batch.arrays.items():
            if lease is not None and c in lease.tensors \
                    and a is lease.arrays[c]:
                t = lease.tensors[c]
                out[c] = t.to(self.device, non_blocking=True) \
                    if self.device.type == "cuda" else t
            else:
                out[c] = stage_array(a, self.device)
        return out, batch.num_valid

    @staticmethod
    def _sig_of(x, ext) -> Tuple:
        """Shape signature of one staged input dict (CompileCache key)."""
        return tuple((c, tuple(x[c].shape), _dtype_name(x[c].dtype))
                     for c in ext)

    @staticmethod
    def _group_sig(x, ext) -> Tuple:
        """``_sig_of`` plus the VALUES of 0-d host inputs (a CSR batch's
        ``:width``): a captured K-step graph bakes those values in, so two
        batches of one shape and another width never share a mega group or
        a graph."""
        host = tuple((c, x[c].item()) for c in ext
                     if x[c].dim() == 0 and x[c].device.type == "cpu")
        sig = SegmentExecutor._sig_of(x, ext)
        return sig + ((("host", host),) if host else ())

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

    def _keying(self, state: Dict[str, Any]) -> Tuple:
        """(staged columns, CSR-staged columns, cache-key tail, shape-key
        prefix) of one partition's programs: a sharded program is keyed
        after its spec (``spec=...;``), a CSR-staged one runs sparse_fn
        bodies over the triple, so it is keyed apart and its shape key
        prefixed (``layout=csr;``), after any stitch."""
        staged_cols = state.get("staged_cols") or state["ext"]
        csr_cols = frozenset(state.get("csr") or ())
        sh = self.sharding
        # a sharded program (a rank's block, collectives around it) is keyed
        # apart from the single-device one, and its shape key prefixed so
        # the cost model's bucket parser skips its records
        key_tail = ((sh.cache_key(),) if sh is not None else ()) + \
            self._stitch_tail
        shape_pre = (sh.shape_prefix() if sh is not None else "") + \
            self._stitch_pre
        if csr_cols:
            key_tail = key_tail + (("layout", "csr"),)
            shape_pre = "layout=csr;" + shape_pre
        return staged_cols, csr_cols, key_tail, shape_pre

    def _make_step(self, params, state: Dict[str, Any]):
        """Dispatch closure: staged batch -> (device outputs, num_valid).
        Non-blocking (the ops are queued on the compute stream); programs
        come from the shared CompileCache keyed by (segment, shape
        signature)."""
        seg, keys = self.segment, state["keys"]
        staged_cols, csr_cols, key_tail, shape_pre = self._keying(state)

        sh = self.sharding

        def program_of(x):
            sig = self._sig_of(x, staged_cols)
            # a kernel variant is a DIFFERENT program for the same
            # (segment, signature): key it apart, and decorate the shape
            # key (variant=<id>;)
            vid = self._variant_for(sig)
            tail = key_tail + ((("variant", vid),) if vid else ())
            pre = (f"variant={vid};" if vid else "") + shape_pre
            return self.cache.get(
                (seg.key, sig) + tail,
                lambda: self._build(keys, variant=vid, csr_cols=csr_cols),
                label=seg.label, shape=pre + self._shape_key_of(sig))

        def run(p, x):
            # sharded, the program is found (or built) inside the sharded
            # call, so a build failure on one rank is agreed like a run
            # failure
            return program_of(x)(p, x)

        def step(staged):
            x, m = staged[0], staged[1]
            if sh is None:
                program = program_of(x)
                with torch.profiler.record_function(f"fused:{seg.label}"):
                    return program(params, x), m
            full = staged[2] if len(staged) > 2 else \
                {c: tuple(v.shape) for c, v in x.items()}
            with torch.profiler.record_function(f"fused:{seg.label}"):
                return sh.run(run, params, x, full), m

        return step

    def _make_mega_step(self, params, state: Dict[str, Any], k: int):
        """K-step dispatch closure: a list of K same-signature staged
        batches (``((x, m), timing)`` items) -> tuple of K output tuples,
        through ONE call of the cached K-step program (``_MegaProgram``:
        one graph replay on the card). Keyed apart from the K=1 program by
        (``"mega"``, K), the 0-d host inputs' values and the kernel
        variant; the shape key is prefixed ``mega{k};`` so the cost model's
        bucket parser skips mega records (their flops are K batches')."""
        seg, keys = self.segment, state["keys"]
        staged_cols, csr_cols, key_tail, shape_pre = self._keying(state)

        sh = self.sharding

        def program_of(cols_seq):
            x = cols_seq[0]
            sig = self._sig_of(x, staged_cols)
            gsig = self._group_sig(x, staged_cols)
            vid = self._variant_for(sig)
            tail = key_tail + ((("variant", vid),) if vid else ())
            pre = (f"variant={vid};" if vid else "") + shape_pre
            return self.cache.get(
                (seg.key, gsig, ("mega", k)) + tail,
                lambda: self._build_mega(keys, k, variant=vid,
                                         csr_cols=csr_cols),
                label=seg.label,
                shape=f"{pre}mega{k};{self._shape_key_of(sig)}")

        def run(p, cols_seq):
            # sharded, found (or built) inside the sharded call, so a build
            # failure on one rank is agreed like a run failure
            return program_of(cols_seq)(p, cols_seq)

        def mega(group):
            from ..parallel.shardplan import StageFailed

            cols_seq = tuple(x if isinstance(x, StageFailed)
                             else {c: x[c] for c in staged_cols}
                             for x in (staged[0] for staged, _t in group))
            if sh is None:
                program = program_of(cols_seq)
                with torch.profiler.record_function(
                        f"fused:{seg.label}:mega{k}"):
                    return program(params, cols_seq)
            with torch.profiler.record_function(f"fused:{seg.label}:mega{k}"):
                # the K batches' compute in one call (one captured graph on
                # the card), then each batch's collectives, outside it
                return sh.run_many(run, params, cols_seq, group[0][0][2])

        return mega

    @staticmethod
    def _fetch(handle) -> Tuple[torch.Tensor, ...]:
        ys, m = handle
        return tuple(y[:m] for y in ys)

    def _fill_ahead(self, state: Dict[str, Any], stats):
        """Batch source for one partition: the plain generator, wrapped in
        a background fill thread when slot deposit is active — slot N+1
        fills while slot N transfers (the SlotPool's two buffers per bucket
        pace the lookahead). Returns (iterator, closer)."""
        src = self._batches(state, stats)
        if not state.get("deposit"):
            return src, None
        from ..parallel.batching import DevicePrefetcher

        filler = DevicePrefetcher(src, depth=1)
        return iter(filler), filler

    def _run_partition(self, part: Dict[str, np.ndarray], params,
                       stats) -> Dict[str, np.ndarray]:
        from ..parallel.ingest import TransferRing

        state = self._prep_partition(part, stats)
        collected: Dict[str, List[np.ndarray]] = {k: []
                                                  for k in state["keys"]}
        if state["n_valid"] > 0:
            src, filler = self._fill_ahead(state, stats)
            ring = TransferRing(src, put=self._put,
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
            finally:
                if filler is not None:
                    filler.close()
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
        mega_k = self.mega_k
        pendings: List[Tuple[str, Any, Any]] = []
        for part in df.partitions:
            try:
                state = self._prep_partition(dict(part), stats)
                handles = []
                if state["n_valid"] > 0:
                    step = self._make_step(params, state)
                    src, filler = self._fill_ahead(state, stats)
                    try:
                        if mega_k <= 1:
                            for batch in src:
                                staged, timing = timed_stage(self._put,
                                                             batch)
                                td = time.perf_counter()
                                pending = self._readback_async(step(staged))
                                timing.dispatch_s = \
                                    time.perf_counter() - td
                                handles.append((pending, timing))
                        else:
                            staged_it = (timed_stage(self._put, batch)
                                         for batch in src)
                            self._dispatch_mega(staged_it, params, state,
                                                step, mega_k, handles)
                    finally:
                        if filler is not None:
                            filler.close()
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
                                    time.perf_counter() - wall0,
                                    **self._cost_attrs())
            return self._overlay(df, out_parts)

        return resolve

    def _dispatch_mega(self, staged_it, params, state: Dict[str, Any],
                       step, k: int, handles) -> None:
        """Dispatch staged batches in SLIDING K-step groups: pull from the
        (lazily staging) iterator, and the moment K consecutive batches of
        one signature (``_group_sig``: shapes, dtypes and 0-d host values)
        are staged, run them through the K-step program (one call for K
        micro-batches) and DROP the staged-input references — at most K
        staged inputs are alive at once. Runs shorter than K (signature
        change or end of stream) dispatch singly through the ordinary step
        — the SAME per-batch program as K=1, so outputs are identical
        either way. The measured mega dispatch time is split evenly across
        the K timings, with ``timing.mega_k`` tagging the share so the cost
        model can de-amortize it."""
        ext = state.get("staged_cols") or state["ext"]
        mega = self._make_mega_step(params, state, k)

        def flush(group):
            if len(group) == k:
                td = time.perf_counter()
                outs = mega(group)
                pend = [self._readback_async((ys, staged[1]))
                        for (staged, _t), ys in zip(group, outs)]
                share = (time.perf_counter() - td) / k
                for (staged, timing), p in zip(group, pend):
                    timing.dispatch_s = share
                    timing.mega_k = k
                    handles.append((p, timing))
            else:
                for staged, timing in group:
                    td = time.perf_counter()
                    pending = self._readback_async(step(staged))
                    timing.dispatch_s = time.perf_counter() - td
                    handles.append((pending, timing))

        group: List[Any] = []
        sig0 = None
        for item in staged_it:
            # sharded: group by the whole batch's shapes, which every rank
            # shares (a rank's staging failure must not regroup its batches)
            sig = ("whole", tuple(sorted(item[0][2].items()))) \
                if len(item[0]) > 2 else self._group_sig(item[0][0], ext)
            if group and sig != sig0:
                flush(group)
                group = []
            if not group:
                sig0 = sig
            group.append(item)
            if len(group) == k:
                flush(group)
                group = []
        if group:
            flush(group)

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

    def _build_mega(self, keys: List[str], k: int,
                    variant: Optional[str] = None,
                    csr_cols: frozenset = frozenset()) -> "_MegaProgram":
        """The K-step program: K runs of ``_build``'s per-batch body in one
        call — a captured CUDA graph on the card, K eager calls elsewhere.
        Each run's ops are exactly the per-batch program's, so per-batch
        outputs match the K=1 path."""
        return _MegaProgram(self._build(keys, variant=variant,
                                        csr_cols=csr_cols), k, self.device)


class _MegaProgram:
    """K runs of a per-batch fused program in one call.

    On the CPU, ``__call__(params, cols_seq)`` runs the body on each of the
    K input dicts in turn. On the card it replays a ``torch.cuda.CUDAGraph``
    of the K runs over K static input sets, one graph per CUDA stream (a
    graph is not reentrant, and each serving replica computes on a stream
    of its own). The first call on a stream runs the K batches eagerly
    (which builds and loads the kernels and makes any lazy device copies),
    then captures the K runs over static copies of the inputs
    (``capture_error_mode="thread_local"``: other replicas keep launching)
    and replays. Every call copies the staged inputs into the graph's static
    inputs on the caller's stream, replays, and clones the static outputs
    on the same stream before returning: no host sync, and the clones are
    the caller's before any later replay rewrites the graph's outputs. A
    0-d host input (a CSR width) is baked into the graph: the cache key
    carries its value. A capture or replay that fails raises.
    ``release()`` (a cache eviction, from any thread) waits for the calls in
    flight, then frees every graph and its memory pool. A call that starts
    after it finds the program dead: it captures a graph of its own, replays
    it once and frees it."""

    def __init__(self, body, k: int, device: torch.device):
        self.body = body
        self.k = int(k)
        self.cuda = device.type == "cuda"
        self._graphs: Dict[int, Tuple[List[Dict[str, Any]], Any]] = {}
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._busy = 0        # calls between their lookup and their clones
        self.dead = False

    def __call__(self, params, cols_seq):
        if len(cols_seq) != self.k:
            raise ValueError(f"a {self.k}-step program got {len(cols_seq)} "
                             f"batches")
        if not self.cuda:
            return tuple(self.body(params, cols) for cols in cols_seq)
        from ..obs.perf import paused_tally

        stream = torch.cuda.current_stream()
        with self._lock:
            entry = self._graphs.get(stream.cuda_stream)
            dead = self.dead
            self._busy += 1
        try:
            if entry is None:
                # first call on this stream: the K batches eagerly (their
                # outputs are not used), then the capture
                for cols in cols_seq:
                    self.body(params, cols)
                with paused_tally():
                    entry = self._capture(params, cols_seq)
                if not dead:
                    with self._lock:
                        self._graphs[stream.cuda_stream] = entry
            static, cap = entry
            with paused_tally():
                for dst, src in zip(static, cols_seq):
                    for c, t in dst.items():
                        if t.device.type == "cuda":
                            t.copy_(src[c])
                outs = cap.replay()
                out = tuple(tuple(y.clone() for y in ys) for ys in outs)
            if dead:
                from .graphs import synchronize

                synchronize()   # the clones have read the pool
                cap.release()
            return out
        finally:
            with self._lock:
                self._busy -= 1
                if not self._busy:
                    self._idle.notify_all()

    def _capture(self, params, cols_seq):
        from .graphs import Captured

        from .graphs import capture_stream

        static = [{c: (t.clone() if t.device.type == "cuda" else t)
                   for c, t in cols.items()} for cols in cols_seq]
        # a stream no other thread is handed (not torch.cuda.Stream()'s pool)
        side = capture_stream()
        side.wait_stream(torch.cuda.current_stream())
        cap = Captured(lambda: tuple(self.body(params, cols)
                                     for cols in static),
                       stream=side, capture_error_mode="thread_local")
        return static, cap

    @property
    def graphs(self) -> int:
        """Graphs captured so far (one per stream that called)."""
        with self._lock:
            return len(self._graphs)

    def release(self) -> None:
        with self._lock:
            self.dead = True
            while self._busy:
                self._idle.wait()
            entries, self._graphs = list(self._graphs.values()), {}
        if entries:
            from .graphs import synchronize

            synchronize()   # no replay may still read a pool
        for _static, cap in entries:
            cap.release()


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
                 cost_model=None, slot_staging: bool = True, **kwargs):
        super().__init__(stages, **kwargs)
        self._cache = cache if cache is not None else compile_cache()
        self._plans: Dict[Tuple, List[Any]] = {}
        self._seg_stats: Dict[str, Any] = {}
        self._last_fallbacks: List[str] = []
        self._last_plan: Optional[List[Any]] = None
        # tuning knobs (core/tune.py's Tuner drives them; all default OFF:
        # an untuned model plans, buckets and dispatches as the plain
        # defaults say): a cost model feeding plan()'s fuse-vs-host and
        # stitch comparisons, per-segment bucket sets, fuse overrides,
        # K-step mega-dispatch factors, kernel variants, stitch flags and
        # staging layouts
        self._cost_model = cost_model
        self._bucket_overrides: Dict[str, Tuple[int, ...]] = {}
        self._fuse_overrides: Dict[str, bool] = {}
        self._mega_k_overrides: Dict[str, int] = {}
        self._variant_overrides: Dict[str, Dict[Any, str]] = {}
        self._stitch_overrides: Dict[str, bool] = {}
        self._layout_overrides: Dict[str, str] = {}
        # the mesh segments may shard over (set_mesh / MeshSupervision) and
        # the per-segment spec overrides (the Tuner's sharding knob); both
        # off by default: no mesh or no override = the single-device path
        self._shard_mesh = None
        self._sharding_overrides: Dict[str, str] = {}
        self._seg_sharding: Dict[str, Any] = {}
        # pipeline depth (parallel/pipeplan.py, the Tuner's pipe_depth
        # knob): > 1 places a chainable segment run on pipe-axis sub-meshes
        # and streams micro-batches through them; None = serial
        self._pipe_depth: Optional[int] = None
        self._pipe_stats: Optional[Dict[str, Any]] = None
        self._pipe_replans = 0
        self._pipe_requeues: Dict[int, int] = {}
        self._pipe_wedge_handler = None
        self._pipe_supervision = None
        # pre-allocated staging (parallel/ingest.py SlotPool), one pool per
        # device type (pinned on CUDA), shared across segments and
        # executors; ``slot_staging=False`` pins the allocating path
        self.slot_staging = bool(slot_staging)
        self._slot_pools: Dict[str, Any] = {}

    def fuse(self) -> "FusedPipelineModel":
        return self

    def set_tuning(self, buckets: Optional[Dict[str, Tuple[int, ...]]] = None,
                   fuse: Optional[Dict[str, bool]] = None,
                   cost_model=None,
                   mega_k: Optional[Dict[str, int]] = None,
                   sharding: Optional[Dict[str, str]] = None,
                   kernel_variants: Optional[Dict[str, Dict[Any, str]]] = None,
                   stitch: Optional[Dict[str, bool]] = None,
                   layout: Optional[Dict[str, str]] = None,
                   pipe_depth: Optional[int] = None) -> None:
        """Apply tuned knobs (``Tuner.apply``): per-segment-label bucket
        sets, fuse-vs-demote overrides, per-segment K-step mega-dispatch
        factors ({label: K}; K = 1 is the plain per-batch dispatch),
        per-segment kernel-variant maps ({label: {bucket|"*": variant
        id}}), per-stage-name stitch flags, per-segment layouts ({label:
        "csr"}), the mesh knobs and/or the cost model itself. Passing None
        leaves a knob unchanged; passing {} clears it. Cached plans are
        invalidated (built programs survive in the CompileCache).

        ``sharding`` ({label: "data" | "feature"}) shards a segment over the
        ``set_mesh`` mesh; ``pipe_depth`` above 1 streams a chainable
        segment run over pipe-axis sub-meshes, 1 or below clears it. Every
        rank of the mesh sets the same knobs."""
        if pipe_depth is not None:
            self._pipe_depth = int(pipe_depth) \
                if int(pipe_depth) > 1 else None
        if sharding is not None:
            self._sharding_overrides = {str(k): str(v)
                                        for k, v in sharding.items() if v}
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
        if mega_k is not None:
            self._mega_k_overrides = {str(k): max(1, int(v))
                                      for k, v in mega_k.items()}
        if layout is not None:
            self._layout_overrides = {str(k): str(v)
                                      for k, v in layout.items() if v}
        if cost_model is not None:
            self._cost_model = cost_model
        self._plans.clear()

    def set_mesh(self, mesh) -> None:
        """Attach (or, with None, detach) the mesh segments may shard and
        pipeline over. The mesh alone changes nothing: a segment shards
        only when a ``sharding`` override names a spec for its label, and
        a run pipelines only with ``pipe_depth`` above 1 (the Tuner's
        journaled decisions). MeshSupervision calls this with the
        surviving sub-mesh after a shard-group quarantine. Every rank of
        the mesh calls it."""
        self._shard_mesh = mesh
        self._seg_sharding.clear()
        self._plans.clear()

    @property
    def shard_mesh(self):
        """The mesh segments may shard over (None: single-device)."""
        return self._shard_mesh

    @property
    def cost_model(self):
        return self._cost_model

    @property
    def mega_k_max(self) -> int:
        """Largest active K-step dispatch factor (1 when untuned). Serving's
        DispatchWatchdog scales its budget by this so a K-batch mega
        dispatch is not mistaken for a hang."""
        return max(self._mega_k_overrides.values(), default=1)

    def _get_slot_pool(self, device: torch.device):
        """The model's SlotPool for ``device``'s type (pinned slots on
        CUDA), or None with ``slot_staging`` off."""
        if not self.slot_staging:
            return None
        pool = self._slot_pools.get(device.type)
        if pool is None:
            from ..parallel.ingest import SlotPool

            pool = self._slot_pools.setdefault(
                device.type, SlotPool(pin=device.type == "cuda"))
        return pool

    @property
    def compile_cache(self) -> CompileCache:
        """The program cache this model's segments build into."""
        return self._cache

    def _plan_for(self, schema: Schema, device: torch.device) -> List[Any]:
        key = (tuple(schema.types.items()), str(device))
        if key not in self._plans:
            self._plans[key] = plan(
                self._stages, schema.copy(), cost_model=self._cost_model,
                fuse_overrides=self._fuse_overrides or None,
                stitch_overrides=self._stitch_overrides or None)
        return self._plans[key]

    def _sharding_for(self, node: Segment):
        """The segment's tuned spec resolved into a SegmentSharding (None =
        unsharded: no mesh, no override, a one-shard axis, a mesh this rank
        is not in, or a resolution failure: a wrong sharding must never
        fail a transform). The mesh's ranks agree on it
        (``mesh.any_failed``): a failure on one rank leaves every rank
        unsharded, never a partner waiting in the sharded step's
        collectives."""
        name = self._sharding_overrides.get(node.label)
        mesh = self._shard_mesh
        if mesh is None or not name or not getattr(mesh, "is_member", True):
            self._seg_sharding.pop(node.label, None)
            return None
        from ..parallel.mesh import any_failed
        from ..parallel.shardplan import sharding_for

        sh, failed = None, 0
        try:
            sh = sharding_for(node, mesh, name)
        except Exception:  # noqa: BLE001 — degrade to single-device
            failed = 1
        if any_failed(failed, mesh):
            sh = None
        if sh is None:
            self._seg_sharding.pop(node.label, None)
        else:
            self._seg_sharding[node.label] = sh.describe()
        return sh

    def _make_executor(self, node: Segment, device: torch.device,
                       pipe: bool = False,
                       sharding=None) -> SegmentExecutor:
        """The segment's executor under the tuned knobs, sharded as
        ``_sharding_for`` resolves it. ``pipe``: one segment of a pipelined
        run, placed by ``sharding`` (a stage's placement, or None: the
        plain chain a partition falls back to), with no K-step dispatch
        (the stream is the amortisation) and no CSR layout
        (``_pipe_plan_for`` excludes it)."""
        label = node.label
        return SegmentExecutor(
            node, self._cache,
            buckets=self._bucket_overrides.get(label),
            cost_model=self._cost_model,
            slot_pool=self._get_slot_pool(device),
            mega_k=1 if pipe else self._mega_k_overrides.get(label, 1),
            kernel_variants=self._variant_overrides.get(label),
            stitch=self._stitch_overrides or None,
            layout=None if pipe else self._layout_overrides.get(label),
            device=device,
            sharding=sharding if pipe else self._sharding_for(node))

    def _host_node(self, node: HostStage, df: DataFrame) -> DataFrame:
        """Run one host plan node, feeding its wall time to the cost model
        (the measured host side of fuse-vs-demote) when tuning is on."""
        if self._cost_model is None:
            return node.stage.transform(df)
        n = sum(len(next(iter(p.values()))) if p else 0
                for p in df.partitions)
        t0 = time.perf_counter()
        out = node.stage.transform(df)
        if n > 0:
            self._cost_model.observe_host(
                node.label, time.perf_counter() - t0, n)
        return out

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
        self._pipe_stats = None
        pplan = self._pipe_plan_for(nodes)
        if pplan is not None:
            from ..parallel.pipeplan import StageWedged

            try:
                return self._transform_pipelined(df, pplan, device)
            except StageWedged as e:
                # a stage's ranks failed mid-stream (alike on every rank):
                # quarantine it, re-plan at depth N-1 on the survivors and
                # re-run the frame, bitwise the same (depth falls each
                # time, so the recursion ends)
                self._pipe_replan_after_wedge(pplan, e.stage)
                return self.transform(df, fused=True)
        for node in nodes:
            df = self._serial_node(node, df, device)
        return df

    def _serial_node(self, node, df: DataFrame,
                     device: torch.device) -> DataFrame:
        from ..parallel.ingest import IngestStats

        if not isinstance(node, Segment):
            return self._host_node(node, df)
        stats = IngestStats()
        self._seg_stats[node.label] = stats
        ex = self._make_executor(node, device)
        df = ex.run(df, stats)
        self._last_fallbacks.extend(ex.fallbacks)
        return df

    def _pipe_plan_for(self, nodes: List[Any]):
        """The pipe_depth knob resolved into a PipePlan (None = serial: the
        knob off, no mesh, no chainable run, an active CSR layout override
        (its triples are staged per partition on the host, which a handoff
        never holds), this rank outside the mesh (it runs the frame
        serially, bitwise the pipelined answer), or a resolution failure:
        a wrong pipeline must never fail a transform).

        The mesh's ranks agree twice (``mesh.share_objects``), so that a
        failure on one rank is the serial path on all of them: on the host
        half (``pipe_run``), where the first rank's stage costs cut the run
        on every rank, and on the placement (its sub-mesh groups, the
        supervision hook)."""
        depth = self._pipe_depth
        mesh = self._shard_mesh
        if not depth or depth <= 1 or mesh is None \
                or self._layout_overrides \
                or not getattr(mesh, "is_member", True):
            return None
        from ..parallel.mesh import share_objects
        from ..parallel.pipeplan import pipe_run, place_pipe_run

        try:
            prep = pipe_run(nodes, mesh, depth, model=self._cost_model)
        except Exception:  # noqa: BLE001 — degrade to serial
            prep = None
        votes = share_objects(
            (prep is None, None if prep is None else prep.costs), mesh)
        if any(serial for serial, _ in votes):
            return None
        pplan, failed = None, False
        try:
            pplan = place_pipe_run(prep._replace(costs=votes[0][1]), mesh)
            if pplan is not None and pplan.my_stage() is not None \
                    and self._pipe_supervision is not None:
                self._pipe_supervision.register(pplan)
        except Exception:  # noqa: BLE001 — degrade to serial
            failed = True
        if any(share_objects(failed, mesh)):
            return None
        if pplan is None or pplan.my_stage() is None:
            return None
        return pplan

    def _transform_pipelined(self, df: DataFrame, pplan,
                             device: torch.device) -> DataFrame:
        """The plan with its chainable run pipelined: nodes before and
        after the run go through the serial loop; the run's segments stream
        micro-batches across their stages (parallel/pipeplan.py
        PipeRunner). The plan's indices refer to the pipeline view
        (``split_segments``), so that view is what runs. StageWedged
        escapes to ``transform``, which re-plans and re-runs."""
        from ..parallel.ingest import IngestStats
        from ..parallel.pipeplan import PipeRunner, stage_sharding_for

        nodes = pplan.nodes
        for node in nodes[:pplan.first]:
            df = self._serial_node(node, df, device)
        execs, serial, stats = [], [], []
        for offset, node in enumerate(nodes[pplan.first:pplan.last]):
            stage = pplan.stages[pplan.stage_of[pplan.first + offset]]
            sh = stage_sharding_for(
                node, stage, pplan.depth,
                spec_name=self._sharding_overrides.get(node.label))
            if sh.inner is not None and stage.mesh.is_member:
                self._seg_sharding[node.label] = sh.inner.describe()
            seg_stats = IngestStats()
            self._seg_stats[node.label] = seg_stats
            stats.append(seg_stats)
            execs.append(self._make_executor(node, device, pipe=True,
                                             sharding=sh))
            serial.append(self._make_executor(node, device, pipe=True))
        runner = PipeRunner(pplan, execs, stats, cost_model=self._cost_model,
                            serial=serial)
        df = runner.run(df)
        for ex in execs + serial:
            self._last_fallbacks.extend(ex.fallbacks)
        self._pipe_stats = runner.stats_dict(
            requeues=self._pipe_requeues, replans=self._pipe_replans)
        for node in nodes[pplan.last:]:
            df = self._serial_node(node, df, device)
        return df

    def _pipe_replan_after_wedge(self, pplan, stage_index: int) -> None:
        """Quarantine a wedged stage and re-arm at depth N-1: through the
        registered supervision hook (PipeSupervision: supervisor quarantine
        and mesh degrade) when one is attached, else the local degrade.
        N-1 == 1 clears the knob (serial on the survivors)."""
        self._pipe_replans += 1
        self._pipe_requeues[int(stage_index)] = \
            self._pipe_requeues.get(int(stage_index), 0) + 1
        handler = self._pipe_wedge_handler
        if handler is not None:
            try:
                handler(pplan, int(stage_index))
                return
            except Exception:  # noqa: BLE001 — fall back to local replan
                pass
        from ..parallel.pipeplan import degrade_after_wedge

        mesh, depth = degrade_after_wedge(self._shard_mesh, pplan,
                                          stage_index)
        self.set_mesh(mesh)
        self.set_tuning(pipe_depth=depth if depth > 1 else 1)

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
        # the submit split stays serial: its contract is one trailing
        # dispatched segment, not a stream
        self._pipe_stats = None
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
                df = self._host_node(node, df)
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
        per-program cost records (the tally's flops/bytes, build seconds,
        first-call ms) and the roofline attribution built from them
        (obs/perf.py ``attribute_segments``): measured-vs-bound per segment
        with a dominant bottleneck label. The attribution is empty (never
        failing) when no cost was recorded."""
        nodes = self._last_plan or []
        per_segment = {label: s.summary()
                       for label, s in list(self._seg_stats.items())}
        costs = self._cache.costs()
        try:
            from ..obs.perf import attribute_segments

            roofline = attribute_segments(
                per_segment, costs,
                sharding=self._seg_sharding or None,
                cost_model=self._cost_model,
                layout=self._layout_overrides or None)
        except Exception:  # noqa: BLE001 — attribution must not break stats
            roofline = {}
        out = {
            "segments": [n.describe() for n in nodes],
            "n_fused_segments": sum(isinstance(n, Segment) for n in nodes),
            "per_segment": per_segment,
            "fallbacks": list(self._last_fallbacks),
            "compile_cache": self._cache.stats(),
            "segment_costs": costs,
            "roofline": roofline,
        }
        if (self._bucket_overrides or self._fuse_overrides
                or self._mega_k_overrides or self._sharding_overrides
                or self._variant_overrides or self._stitch_overrides
                or self._layout_overrides):
            out["tuning"] = {
                "buckets": {k: list(v)
                            for k, v in self._bucket_overrides.items()},
                "fuse": dict(self._fuse_overrides),
                "mega_k": dict(self._mega_k_overrides),
                "sharding": dict(self._sharding_overrides)}
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
        if self._seg_sharding:
            from ..parallel.shardplan import mesh_topology

            out["sharding"] = {
                "mesh": mesh_topology(self._shard_mesh),
                "segments": {k: dict(v)
                             for k, v in self._seg_sharding.items()}}
        pools = {k: p.stats() for k, p in self._slot_pools.items()}
        if pools:
            out["slot_pool"] = pools.get("cuda") or pools.get("cpu") \
                or next(iter(pools.values()))
        if self._pipe_stats:  # key absent when no pipe plan ran
            out["pipeline"] = dict(self._pipe_stats)
        return out
