"""Host -> device ingest: staging, the transfer ring, and its accounting.

Counterpart of ``PreprocessSpec``, ``BatchTiming``, ``IngestStats``,
``rows_to_batch``, ``timed_stage``, ``TransferRing`` and
``_h2d_aliases_host`` in the reference's ``mmlspark_tpu/parallel/ingest.py``,
on CUDA streams and events:

- ``PreprocessSpec`` describes a model input's cast/scale/offset/transpose;
  ``apply_device`` runs it on a batch tensor ahead of the forward, so the
  wire carries the raw dtype.

- ``stage_array`` puts one host batch array on the device. Where the device
  keeps its own copy (CUDA), the array goes through a pinned host buffer
  and a non-blocking host-to-device copy; where the "device" tensor would
  alias the host memory (the CPU), the array is used as it is.
- ``TransferRing`` runs ``put`` (staging) for each batch on a copy stream of
  its own, makes the compute stream wait for the copy with a CUDA event,
  dispatches ``step`` on the compute stream, and starts the batch's
  readback on a readback stream that waits only for that batch's done
  event, into reused host buffers (``ReadbackSlots``, pinned on CUDA). It
  keeps at most ``depth`` steps in flight and drains them in order. The
  host prepares batch i+1 and stages it while the card still runs batch i,
  and batch i's copy to the host runs beside batch i+1's forward instead
  of queueing behind it.

- ``SlotPool`` hands out reusable staging slots (``SlotLease``): paired
  buffers per (column, batch shape, dtype) bucket, pinned host tensors on
  CUDA and plain arrays on the CPU, under a per-slot and a total byte cap
  with least-recently-used eviction of free buckets. The fused executor
  deposits a batch's rows straight into a slot (``rows_to_batch(...,
  out=)``), which is the batch's one host copy; ``timed_stage`` copies the
  slot to the card and returns it to the pool once that copy is done.

The reference's ring stages on a background thread (``DevicePrefetcher``)
because ``jax.device_put`` blocks; here the copy is asynchronous on its own
stream, so the ring needs no thread. The deposit path alone fills its slots
ahead on a ``DevicePrefetcher`` thread (core/fusion.py ``_fill_ahead``).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# PreprocessSpec: host preprocessing moved onto the device
# ---------------------------------------------------------------------------


_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "float16": torch.float16, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class PreprocessSpec:
    """Device-side preprocessing of a model's input batch.

    Describes what the host used to do to each row before batching —
    ``astype(dtype) * scale + offset`` and an optional per-row axes
    transpose (NHWC -> NCHW for ONNX imports) — so the wire carries the raw
    decoded dtype (uint8 pixels: 4x fewer host-to-device bytes) and the work
    runs on the device, ahead of the forward. Hashable, so program caches
    can key on it.

    ``transpose`` is the PER-ROW axes permutation (e.g. ``(2, 0, 1)`` for
    HWC -> CHW); the batched op shifts it past the leading batch dim.
    ``dtype``: compute dtype after the cast.
    """

    scale: float = 1.0
    offset: float = 0.0
    transpose: Optional[Tuple[int, ...]] = None
    dtype: str = "float32"

    def __post_init__(self):
        if self.transpose is not None:
            object.__setattr__(self, "transpose",
                               tuple(int(a) for a in self.transpose))

    def cache_key(self) -> Tuple:
        """Pure-literal tuple form for program-cache keys."""
        return ("PreprocessSpec", float(self.scale), float(self.offset),
                self.transpose, self.dtype)

    def _batch_axes(self, ndim: int) -> Tuple[int, ...]:
        perm = self.transpose
        if perm is None or len(perm) != ndim - 1:
            raise ValueError(
                f"transpose {perm} does not match per-row rank {ndim - 1}")
        return (0,) + tuple(a + 1 for a in perm)

    def apply_device(self, x: torch.Tensor) -> torch.Tensor:
        """Batched [B, ...] op on a tensor, on its device. The scale and
        offset are rounded to ``dtype`` first, as the reference's
        ``dt(self.scale)`` is."""
        dt = _TORCH_DTYPES[self.dtype]
        y = x.to(dt)
        if self.scale != 1.0:
            y = y * torch.tensor(self.scale, dtype=dt)
        if self.offset != 0.0:
            y = y + torch.tensor(self.offset, dtype=dt)
        if self.transpose is not None:
            y = y.permute(self._batch_axes(y.dim()))
        return y

    def apply_host(self, x: np.ndarray) -> np.ndarray:
        """Numpy version of ``apply_device`` on a [B, ...] batch (a uint8 ->
        f32 cast and an f32 multiply are exact, so the two agree
        bitwise)."""
        dt = np.dtype(self.dtype).type
        y = x.astype(dt)
        if self.scale != 1.0:
            y = y * dt(self.scale)
        if self.offset != 0.0:
            y = y + dt(self.offset)
        if self.transpose is not None:
            y = np.transpose(y, self._batch_axes(y.ndim))
        return y

    def apply_host_row(self, img: np.ndarray) -> np.ndarray:
        """``apply_host`` on one row (ImageFeaturizer's ``hostPreprocess``
        path)."""
        return self.apply_host(img[None])[0]


# ---------------------------------------------------------------------------
# IngestStats: per-batch ingest decomposition
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatchTiming:
    """Decomposition of one batch through the ring (seconds).

    ``queue_s``  — wait for the next host batch (the host stacking, padding
                   and CSR slicing of the batch source).
    ``h2d_s``    — host->device transfer: on CUDA the copy stream's own time
                   for the batch (CUDA events around it, read at drain);
                   where staging aliases the host (CPU), the host time of
                   ``put``.
    ``dispatch_s`` — host cost of enqueueing the step.
    ``compute_s``  — residual wait for the step's outputs at drain time
                   (0 when compute fully hid behind later batches' ingest).
    ``readback_s`` — device->host fetch of the outputs alone: on CUDA the
                   readback stream's own time for the batch (``fetch``'s
                   device work and the copy into the pinned slot, CUDA
                   events read at drain) plus the host's copy out of the
                   slot; elsewhere the host time of both.
    ``bytes_in`` — bytes staged for this batch.
    ``rows``     — valid rows in the batch.
    ``padded_rows`` — the static bucket size the batch was padded to (0 =
                   unpadded/unknown).
    ``mega_k``   — dispatch-amortization group size this batch rode (1 =
                   plain per-batch dispatch). When > 1, ``dispatch_s`` is
                   the per-batch SHARE of one K-step mega dispatch;
                   ``dispatch_s * mega_k`` recovers the per-call fixed cost
                   the cost model's ``choose_mega_k`` needs.
    """

    queue_s: float = 0.0
    h2d_s: float = 0.0
    dispatch_s: float = 0.0
    compute_s: float = 0.0
    readback_s: float = 0.0
    bytes_in: int = 0
    rows: int = 0
    padded_rows: int = 0
    mega_k: int = 1
    # (start, end) CUDA events around the copy, read once the step is done
    h2d_events: Any = dataclasses.field(default=None, repr=False,
                                        compare=False)

    def resolve_h2d(self) -> None:
        """Read the copy time from its events (they have completed once the
        step that waited on them has)."""
        if self.h2d_events is not None:
            start, end = self.h2d_events
            self.h2d_s = start.elapsed_time(end) / 1e3
            self.h2d_events = None


class IngestStats:
    """Accumulates ``BatchTiming`` rows plus ring wall time; ``summary()``
    renders the decomposition ``fusion_stats()`` reports per segment.
    Partitions of one transform accumulate into one object."""

    def __init__(self):
        self.records: List[BatchTiming] = []
        self.wall_s: float = 0.0
        # ring slot occupancy (dispatched-but-undrained steps)
        self.ring_depth: int = 0
        self._occ_sum: int = 0
        self._occ_n: int = 0
        self._occ_max: int = 0
        # pad waste per bucket: {padded size: [batches, real rows]}
        self._pad: Dict[int, List[int]] = {}
        # deposit accounting: batches staged in place into SlotPool slots vs
        # batches that took the accounted copying fallback
        # (mmlspark_ingest_deposits_total / _copies_total)
        self.deposits: int = 0
        self.copies: int = 0
        # rows_to_batch outcome split: spanning zero-copy views vs copies
        self.zero_copy_batches: int = 0
        self.copied_batches: int = 0
        # per-slot double-buffer decomposition: fill / transfer seconds and
        # the measured fill<->transfer overlap between paired buffers
        self.slot_fill_s: float = 0.0
        self.slot_transfer_s: float = 0.0
        self.slot_overlap_s: float = 0.0
        self.slot_transfers: int = 0
        # sparse-layout accounting: bytes a densify materialized vs the CSR
        # bytes the same rows hold, and the CSR-through counterpart (bytes
        # staged as triples vs the dense-equivalent bytes avoided). All zero
        # — and absent from summary() — until sparse data is seen.
        self.densified_bytes: int = 0
        self.densify_nnz_bytes: int = 0
        self.densifies: int = 0
        self.csr_nnz_bytes: int = 0
        self.csr_dense_bytes: int = 0
        self.csr_batches: int = 0

    def record(self, t: BatchTiming) -> None:
        self.records.append(t)
        if t.padded_rows > 0:
            self.note_padding(t.padded_rows, t.rows)

    def note_padding(self, bucket: int, rows: int) -> None:
        """Count one batch padded to ``bucket`` static rows with ``rows``
        real ones."""
        acc = self._pad.setdefault(int(bucket), [0, 0])
        acc[0] += 1
        acc[1] += int(rows)

    def add_wall(self, seconds: float) -> None:
        self.wall_s += seconds

    def note_ring(self, depth: int) -> None:
        self.ring_depth = max(self.ring_depth, int(depth))

    def note_occupancy(self, in_flight: int) -> None:
        n = int(in_flight)
        self._occ_sum += n
        self._occ_n += 1
        self._occ_max = max(self._occ_max, n)

    def note_deposit(self) -> None:
        """One batch staged in place into a pre-allocated slot."""
        self.deposits += 1

    def note_copy(self) -> None:
        """One batch that took the accounted copying fallback (deposit
        ineligible or slot contention) — the
        ``mmlspark_ingest_copies_total`` counter."""
        self.copies += 1

    def note_slot(self, fill_s: float, transfer_s: float,
                  overlap_s: float) -> None:
        """One slot cycle: host fill seconds, copy-to-device seconds, and
        the measured overlap between this transfer and the paired buffer's
        concurrent fill (double-buffering effectiveness, per slot)."""
        self.slot_fill_s += float(fill_s)
        self.slot_transfer_s += float(transfer_s)
        self.slot_overlap_s += float(overlap_s)
        self.slot_transfers += 1

    def note_batch_copy(self, zero_copy: bool) -> None:
        """rows_to_batch outcome: spanning zero-copy view vs stacked copy."""
        if zero_copy:
            self.zero_copy_batches += 1
        else:
            self.copied_batches += 1

    def note_densify(self, densified_bytes: int, nnz_bytes: int) -> None:
        """One sparse column densified: the dense bytes it materialized vs
        the CSR bytes the same rows hold."""
        self.densified_bytes += int(densified_bytes)
        self.densify_nnz_bytes += int(nnz_bytes)
        self.densifies += 1

    def note_csr(self, nnz_bytes: int, dense_bytes: int) -> None:
        """One sparse column staged as a CSR triple: the triple's bytes vs
        the dense-equivalent bytes the densify path would have shipped."""
        self.csr_nnz_bytes += int(nnz_bytes)
        self.csr_dense_bytes += int(dense_bytes)
        self.csr_batches += 1

    def merge(self, other: "IngestStats") -> None:
        """Fold another stats object in (segment aggregation)."""
        self.records.extend(other.records)
        self.wall_s += other.wall_s
        self.ring_depth = max(self.ring_depth, other.ring_depth)
        self._occ_sum += other._occ_sum
        self._occ_n += other._occ_n
        self._occ_max = max(self._occ_max, other._occ_max)
        for bucket, (batches, rows) in other._pad.items():
            acc = self._pad.setdefault(bucket, [0, 0])
            acc[0] += batches
            acc[1] += rows
        self.deposits += other.deposits
        self.copies += other.copies
        self.zero_copy_batches += other.zero_copy_batches
        self.copied_batches += other.copied_batches
        self.slot_fill_s += other.slot_fill_s
        self.slot_transfer_s += other.slot_transfer_s
        self.slot_overlap_s += other.slot_overlap_s
        self.slot_transfers += other.slot_transfers
        self.densified_bytes += other.densified_bytes
        self.densify_nnz_bytes += other.densify_nnz_bytes
        self.densifies += other.densifies
        self.csr_nnz_bytes += other.csr_nnz_bytes
        self.csr_dense_bytes += other.csr_dense_bytes
        self.csr_batches += other.csr_batches

    def _pad_summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        padding: Dict[str, Any] = {}
        tot_real = tot_padded = 0
        for bucket in sorted(self._pad):
            batches, real = self._pad[bucket]
            padded = batches * bucket
            tot_real += real
            tot_padded += padded
            padding[str(bucket)] = {
                "batches": batches, "rows": real, "padded": padded,
                "pad_ratio": round(1 - real / padded, 4) if padded
                else None}
        out["padding"] = padding
        if tot_padded:
            out["pad_ratio"] = round(1 - tot_real / tot_padded, 4)
        return out

    def _staging_summary(self) -> Dict[str, Any]:
        """Deposit / zero-copy / slot-overlap / sparse-layout sections
        (only populated keys)."""
        out: Dict[str, Any] = {}
        if self.deposits or self.copies:
            out["slot_deposits"] = self.deposits
            out["fallback_copies"] = self.copies
        if self.zero_copy_batches or self.copied_batches:
            out["zero_copy_batches"] = self.zero_copy_batches
            out["copied_batches"] = self.copied_batches
        if self.slot_transfers:
            out["slot_fill_s"] = round(self.slot_fill_s, 6)
            out["slot_transfer_s"] = round(self.slot_transfer_s, 6)
            out["slot_overlap_s"] = round(self.slot_overlap_s, 6)
            # fraction of transfer time hidden behind the paired buffer's
            # fill (1.0 = every transfer fully overlapped a fill)
            out["slot_overlap_ratio"] = round(
                self.slot_overlap_s / self.slot_transfer_s, 4) \
                if self.slot_transfer_s > 0 else None
        if self.densifies:
            out["densifies"] = self.densifies
            out["densified_bytes"] = self.densified_bytes
            out["densify_nnz_bytes"] = self.densify_nnz_bytes
            out["densify_ratio"] = round(
                self.densified_bytes / self.densify_nnz_bytes, 4) \
                if self.densify_nnz_bytes > 0 else None
        if self.csr_batches:
            out["csr_batches"] = self.csr_batches
            out["csr_nnz_bytes"] = self.csr_nnz_bytes
            out["csr_dense_bytes"] = self.csr_dense_bytes
        return out

    def summary(self) -> Dict[str, Any]:
        if not self.records:
            out = {"n_batches": 0}
            if self._pad:
                out.update(self._pad_summary())
            out.update(self._staging_summary())
            return out
        cols = {f: float(sum(getattr(r, f) for r in self.records))
                for f in ("queue_s", "h2d_s", "dispatch_s", "compute_s",
                          "readback_s")}
        total_bytes = int(sum(r.bytes_in for r in self.records))
        rows = int(sum(r.rows for r in self.records))
        serial = sum(cols.values())
        n = len(self.records)
        out: Dict[str, Any] = {
            "n_batches": n,
            "rows": rows,
            "bytes": total_bytes,
            "wall_s": round(self.wall_s, 6),
            # < 1.0: the ring hid ingest behind compute (and vice versa)
            "overlap_ratio": round(self.wall_s / serial, 4) if serial > 0
            else None,
            "h2d_gbps": round(total_bytes / cols["h2d_s"] / 1e9, 4)
            if cols["h2d_s"] > 0 else None,
        }
        if self.ring_depth > 0:
            out["ring_depth"] = self.ring_depth
            if self._occ_n > 0:
                out["ring_occupancy_mean"] = round(
                    self._occ_sum / self._occ_n, 4)
                out["ring_occupancy_max"] = self._occ_max
        if self._pad:
            out.update(self._pad_summary())
        out.update(self._staging_summary())
        for f, v in cols.items():
            out[f] = round(v, 6)
            out[f"{f[:-2]}_ms_per_batch"] = round(v / n * 1e3, 4)
        return out


# ---------------------------------------------------------------------------
# Host batch assembly and staging
# ---------------------------------------------------------------------------


def _root_exporter(a: np.ndarray):
    """The object that OWNS an array view's memory: walk the ``.base``
    chain to the final ndarray, and through a memoryview to its exporter
    (``decode_frame`` views are frombuffer-over-memoryview-slice; the slice
    keeps the WHOLE exporter alive, which is what makes a spanning strided
    view over sibling slices memory-safe)."""
    b = a
    while isinstance(b, np.ndarray) and b.base is not None:
        b = b.base
    if isinstance(b, memoryview):
        try:
            return b.obj
        except Exception:  # noqa: BLE001 — released/exotic memoryview
            return b
    return b


def _spanning_view(arrs: List[np.ndarray], shape: Tuple[int, ...],
                   ) -> Optional[np.ndarray]:
    """Zero-copy [B, ...] view when the rows sit at a CONSTANT pointer
    stride inside one live buffer; None otherwise.

    Two layouts qualify: adjacent rows (stride == row nbytes — a whole
    batch shipped in one frame column, or journal replay of a concatenated
    region) and rows spanning multiple PIPELINED FRAMES of one connection
    buffer (stride > row nbytes: equal-size frames back-to-back put each
    frame's payload at payload+header intervals). The second layout is
    only taken when every row resolves to the SAME root exporter object —
    rows from unrelated buffers must never be bridged by pointer
    arithmetic, no matter how adjacent they happen to land."""
    nb = arrs[0].nbytes
    if len(arrs) < 2 or not nb \
            or not all(a.flags["C_CONTIGUOUS"] for a in arrs):
        return None
    try:
        ptrs = [a.__array_interface__["data"][0] for a in arrs]
    except (KeyError, TypeError):
        return None
    stride = ptrs[1] - ptrs[0]
    if stride < nb or any(p != ptrs[0] + i * stride
                          for i, p in enumerate(ptrs)):
        return None
    if stride > nb:
        root = _root_exporter(arrs[0])
        if any(_root_exporter(a) is not root for a in arrs[1:]):
            return None
    # one spanning view over the shared buffer; arrs[0] rides along as
    # .base so the underlying memory stays alive
    return np.lib.stride_tricks.as_strided(
        arrs[0], shape=(len(arrs),) + shape,
        strides=(stride,) + arrs[0].strides)


def rows_to_batch(rows, out: Optional[np.ndarray] = None,
                  stats: Optional["IngestStats"] = None) -> np.ndarray:
    """Per-row arrays -> one contiguous [B, ...] batch for H2D staging.

    The binary-wire ingest path: ``decode_frame`` hands each request's
    payload back as a zero-copy VIEW over its body bytes, and this is the
    single host copy that remains — the batch stack that doubles as the
    staging buffer (uint8 on the wire, cast/scale on the device via
    PreprocessSpec).

    Fast path: when the rows sit at one constant stride over ONE live
    buffer (a client shipped a whole batch in one frame column, journal
    replay of a concatenated region, or pipelined equal-size frames of one
    connection), the batch is a strided view — zero copies end-to-end.
    Otherwise ``np.stack``. Rows must agree on shape and dtype (ragged
    batches stay on the per-row host path).

    ``out``: slot-fill mode — a pre-allocated [cap, ...] staging slot
    (SlotPool buffer) receiving the rows in place; returns ``out[:B]``.
    ``stats``: optional IngestStats receiving the zero-copy vs copied
    batch counters."""
    arrs = [np.asarray(r) for r in rows]
    if not arrs:
        raise ValueError("rows_to_batch needs at least one row")
    shape, dt = arrs[0].shape, arrs[0].dtype
    for a in arrs[1:]:
        if a.shape != shape or a.dtype != dt:
            raise ValueError(
                f"ragged batch: {a.shape}/{a.dtype} vs {shape}/{dt}")
    if out is not None:
        # slot-fill: rows land in the caller's slot — stack + pad collapse
        # into this ONE copy (the H2D staging buffer is the destination)
        if out.dtype != dt or tuple(out.shape[1:]) != shape \
                or len(out) < len(arrs):
            raise ValueError(
                f"slot [{len(out)}]{out.shape[1:]}/{out.dtype} cannot "
                f"receive batch [{len(arrs)}]{shape}/{dt}")
        view = _spanning_view(arrs, shape) if len(arrs) > 1 else None
        if view is not None:
            out[:len(arrs)] = view  # one bulk memcpy
        else:
            for i, a in enumerate(arrs):
                out[i] = a
        if stats is not None:
            stats.note_batch_copy(zero_copy=False)
        return out[:len(arrs)]
    if len(arrs) == 1:
        if arrs[0].flags["C_CONTIGUOUS"]:
            if stats is not None:
                stats.note_batch_copy(zero_copy=True)
            return arrs[0][None]
        if stats is not None:
            stats.note_batch_copy(zero_copy=False)
        return np.ascontiguousarray(arrs[0])[None]
    view = _spanning_view(arrs, shape)
    if view is not None:
        if stats is not None:
            stats.note_batch_copy(zero_copy=True)
        return view
    if stats is not None:
        stats.note_batch_copy(zero_copy=False)
    return np.stack(arrs)




# ---------------------------------------------------------------------------
# SlotPool: pre-allocated, double-buffered H2D staging slots
# ---------------------------------------------------------------------------


class _SlotBucket:
    """Paired pre-allocated buffers for one (column, batch shape, dtype)
    bucket. Two buffers = double buffering: one fills while the sibling
    transfers. Each buffer is a host tensor (pinned when ``pin``, so the
    copy to the card reads it directly) and ``bufs`` holds the numpy views
    the fill writes through. ``fills`` holds this bucket's recent completed
    fill intervals — a transfer's overlap is measured against its OWN
    bucket's sibling fills only. ``tick`` is the pool's LRU clock value at
    last use."""

    __slots__ = ("tensors", "bufs", "free", "fills", "tick")

    def __init__(self, shape: Tuple[int, ...], dtype, n: int, pin: bool):
        dt = torch.from_numpy(np.empty(0, dtype=dtype)).dtype
        self.tensors = [torch.zeros(shape, dtype=dt, pin_memory=pin)
                        for _ in range(n)]
        self.bufs = [t.numpy() for t in self.tensors]
        self.free = list(range(n))
        self.fills: deque = deque(maxlen=8)
        self.tick = 0

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self.bufs)


class SlotLease:
    """One acquired staging slot: a pre-allocated ``[cap, ...]`` buffer per
    deposit column of one batch. Lifecycle: ``fill_begin``/``fill_end``
    around the host fill, then ``transfer_begin``/``transfer_end`` driven
    by ``timed_stage`` around the H2D transfer — ``transfer_end`` records
    the fill/transfer/overlap decomposition into IngestStats and returns
    the buffers to the pool. ``release()`` is the idempotent abandon path
    (a faulted transfer frees the buffers without recording a cycle; the
    slot content is simply overwritten on reuse, never read). A weakref
    finalizer backstops release: a lease dropped on any abort path (queue
    drain, injected fault, watchdog kill) still returns its buffers to the
    shared, never-replenished pool instead of shrinking it forever."""

    __slots__ = ("arrays", "tensors", "_pool", "_held", "_stats", "_fill",
                 "_tx0", "_done", "_finalizer", "__weakref__")

    def __init__(self, pool: "SlotPool", held: List[Tuple[Tuple, int]],
                 arrays: Dict[str, np.ndarray],
                 tensors: Dict[str, torch.Tensor], stats):
        self.arrays = arrays
        #: the host tensors behind ``arrays`` (pinned on CUDA): the fused
        #: executor copies these to the card without another staging copy
        self.tensors = tensors
        self._pool = pool
        self._held = held
        self._stats = stats
        self._fill = (0.0, 0.0)
        self._tx0: Optional[float] = None
        self._done = False
        self._finalizer = weakref.finalize(self, pool._release, held)

    def fill_begin(self) -> None:
        self._fill = (time.perf_counter(), 0.0)

    def fill_end(self) -> None:
        self._fill = (self._fill[0], time.perf_counter())
        self._pool._note_fill(self._held, self._fill)

    def transfer_begin(self) -> None:
        self._tx0 = time.perf_counter()

    def transfer_end(self) -> None:
        tx1 = time.perf_counter()
        tx0 = self._tx0 if self._tx0 is not None else tx1
        if self._stats is not None:
            fill_s = max(0.0, self._fill[1] - self._fill[0])
            self._stats.note_slot(fill_s, tx1 - tx0,
                                  self._pool._overlap(self._held, tx0, tx1))
        self.release()

    def release(self) -> None:
        if self._done:
            return
        self._done = True
        # the finalizer IS the release (calling it runs pool._release once
        # and detaches, so a later GC never double-frees)
        self._finalizer()


class SlotPool:
    """Pre-allocated, shape-bucket-keyed staging slots with PAIRED buffers
    per bucket: pinned host tensors when ``pin`` (a CUDA device), plain
    ones otherwise.

    ``acquire(spec)`` hands out a ``SlotLease`` over one buffer per
    requested column, keyed by (column, full batch shape, dtype) — the
    shape-bucket key, so every padded bucket size reuses its own slot
    instead of allocating per batch. Each bucket holds
    ``buffers_per_bucket`` (default 2) buffers: while buffer A is in H2D
    transfer, buffer B fills — the per-slot overlap is MEASURED (lease
    transfer intervals intersected with concurrent fill intervals) and
    reported through ``IngestStats.note_slot``.

    ``acquire`` is all-or-nothing under one condition variable (no partial
    holds, no lock-order deadlocks) and returns None instead of blocking
    past ``acquire_timeout_s`` — callers fall back to the accounted
    copying path (``IngestStats.note_copy``), so slot contention degrades
    to today's behavior instead of stalling the ring.

    Buffer ALLOCATION happens outside the lock (pinning a 256MB slot must
    not stall every concurrent acquire/release), and total pool memory is
    bounded by ``max_total_bytes``: inserting a new bucket first evicts
    least-recently-used fully-free buckets, and when no room can be made
    the acquire returns None (copy-path fallback) instead of growing
    without limit across the distinct shapes a long-lived server sees."""

    def __init__(self, buffers_per_bucket: int = 2,
                 max_slot_bytes: int = 1 << 28,
                 max_total_bytes: int = 1 << 31,
                 acquire_timeout_s: float = 2.0, pin: bool = False):
        self.pin = bool(pin)
        self._nbuf = max(1, int(buffers_per_bucket))
        self._max_bytes = int(max_slot_bytes)
        self._max_total = int(max_total_bytes)
        self._timeout = float(acquire_timeout_s)
        self._cv = threading.Condition()
        self._buckets: Dict[Tuple, _SlotBucket] = {}
        self._tick = 0          # LRU clock (monotonic acquire counter)
        self._evictions = 0

    def _missing_buckets(self, keys: Dict[str, Tuple],
                         spec: Dict[str, Tuple[Tuple[int, ...], Any]]
                         ) -> Optional[List[Tuple]]:
        """Under self._cv: keys not yet backed by a bucket, as (key, shape,
        dtype, nbytes) build specs. None when any slot exceeds the per-slot
        byte cap (caller falls back to the copying path)."""
        missing = []
        for col, key in keys.items():
            if key in self._buckets:
                continue
            shape, dtype = spec[col]
            nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
            if nbytes <= 0 or nbytes > self._max_bytes:
                return None
            missing.append((key, tuple(int(d) for d in shape), dtype,
                            nbytes))
        return missing

    def _make_room(self, need: int, protect: frozenset) -> bool:
        """Under self._cv: evict LRU fully-free buckets until ``need`` more
        bytes fit under ``max_total_bytes``. False when in-use buckets pin
        the pool above the cap (leased buffers are never evicted — a stale
        release into a re-created bucket is guarded, but yanking live
        buffers is not recoverable). ``protect``: keys the CURRENT acquire
        needs — evicting a sibling bucket of the same spec would ping-pong
        build/evict forever."""
        total = sum(b.nbytes for b in self._buckets.values())
        while total + need > self._max_total:
            victim_key, victim = None, None
            for key, b in self._buckets.items():
                if key not in protect and len(b.free) == len(b.bufs) and \
                        (victim is None or b.tick < victim.tick):
                    victim_key, victim = key, b
            if victim is None:
                return False
            del self._buckets[victim_key]
            total -= victim.nbytes
            self._evictions += 1
        return True

    def acquire(self, spec: Dict[str, Tuple[Tuple[int, ...], Any]],
                stats=None,
                timeout: Optional[float] = None) -> Optional[SlotLease]:
        """``spec``: {column: (full batch shape INCLUDING the leading
        padded cap, dtype)}. Returns a SlotLease, or None on timeout /
        uncacheable shape / a full pool (caller copies and accounts it)."""
        if not spec:
            return None
        deadline = time.perf_counter() + (
            self._timeout if timeout is None else float(timeout))
        keys = {}
        for col in sorted(spec):
            shape, dtype = spec[col]
            keys[col] = (col, tuple(int(d) for d in shape),
                         np.dtype(dtype).str)
        while True:
            with self._cv:
                missing = self._missing_buckets(keys, spec)
                if missing is None:
                    return None
                if not missing:
                    lease = self._try_grab(keys, stats)
                    if lease is not None:
                        return lease
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0 or not self._cv.wait(remaining):
                        return None
                    continue
            # allocate OUTSIDE the lock: pinning a 256MB slot must not
            # stall concurrent acquire/release on the shared pool
            built = [(key, _SlotBucket(shape, dtype, self._nbuf, self.pin))
                     for key, shape, dtype, _ in missing]
            protect = frozenset(keys.values())
            with self._cv:
                for key, bucket in built:
                    if key in self._buckets:
                        continue  # racing thread built it first; drop ours
                    if not self._make_room(bucket.nbytes, protect):
                        return None
                    self._buckets[key] = bucket
                self._cv.notify_all()
            # loop: grab under the lock now that the buckets exist

    def _try_grab(self, keys: Dict[str, Tuple],
                  stats) -> Optional[SlotLease]:
        """Under self._cv: all-or-nothing lease over one free buffer per
        key. None when any bucket has no free buffer (or two columns
        collapse onto one bucket)."""
        buckets = {col: self._buckets[key] for col, key in keys.items()}
        if not all(b.free for b in buckets.values()) or \
                len({id(b) for b in buckets.values()}) != len(buckets):
            return None
        self._tick += 1
        held = []
        arrays = {}
        tensors = {}
        for col, key in keys.items():
            bucket = buckets[col]
            bucket.tick = self._tick
            idx = bucket.free.pop()
            held.append((key, idx))
            arrays[col] = bucket.bufs[idx]
            tensors[col] = bucket.tensors[idx]
        return SlotLease(self, held, arrays, tensors, stats)

    def _release(self, held: List[Tuple[Tuple, int]]) -> None:
        with self._cv:
            for key, idx in held:
                bucket = self._buckets.get(key)
                if bucket is not None and idx not in bucket.free:
                    bucket.free.append(idx)
            self._cv.notify_all()

    def _note_fill(self, held: List[Tuple[Tuple, int]],
                   interval: Tuple[float, float]) -> None:
        """Record a completed fill on the lease's OWN buckets only: overlap
        must measure this bucket-pair's double buffering, not unrelated
        leases elsewhere in the shared pool."""
        with self._cv:
            for key, _idx in held:
                bucket = self._buckets.get(key)
                if bucket is not None:
                    bucket.fills.append(interval)

    def _overlap(self, held: List[Tuple[Tuple, int]],
                 tx0: float, tx1: float) -> float:
        """Seconds of [tx0, tx1] overlapped by sibling fills in the lease's
        own buckets (a lease's own fill ends before its transfer begins, so
        it contributes zero by construction). Multi-column leases record
        one identical interval per bucket — deduped so it counts once."""
        with self._cv:
            fills = {f for key, _idx in held
                     for f in getattr(self._buckets.get(key), "fills", ())}
        return sum(max(0.0, min(tx1, f1) - max(tx0, f0))
                   for f0, f1 in fills)

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            buckets = len(self._buckets)
            buffers = sum(len(b.bufs) for b in self._buckets.values())
            nbytes = sum(b.nbytes for b in self._buckets.values())
            evictions = self._evictions
        return {"buckets": buckets, "buffers": buffers, "bytes": nbytes,
                "max_total_bytes": self._max_total,
                "evictions": evictions, "pinned": self.pin}


#: per device type: does staging a host tensor there alias its memory?
_H2D_ALIASES: Dict[str, bool] = {}


def _h2d_aliases_host(device) -> bool:
    """Does ``Tensor.to(device)`` of a host tensor return a tensor that
    SHARES the host memory? Probed once per device type: stage a small host
    tensor the way ``stage_array`` would, wait for the copy, write the host
    side, and read the staged value. A CUDA device keeps its own copy
    (False): the host buffer is free once the copy event has completed. On
    the CPU the staged tensor is the host tensor itself (True), so staging
    there needs no pinned buffer and no copy at all."""
    dev = torch.device(device)
    if dev.type not in _H2D_ALIASES:
        probe = np.zeros(16, dtype=np.float32)
        staged = torch.from_numpy(probe).to(dev, non_blocking=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        probe[0] = 1.0
        _H2D_ALIASES[dev.type] = bool(staged[0].item() == 1.0)
    return _H2D_ALIASES[dev.type]


def stage_array(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host batch array -> a tensor on ``device``, on the current
    stream. A 0-d array (a scalar such as a CSR width) stays a host tensor:
    kernels take it as an argument, and reading it back from the device
    would stall the stream. Otherwise, where staging aliases the host, the
    array is used in place; else it is copied into a pinned buffer and from
    there to the device without blocking (the caching host allocator keeps
    the pinned block until the copy has completed)."""
    if arr.ndim == 0:
        return torch.as_tensor(arr)
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if _h2d_aliases_host(device):
        return host
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    return pinned.to(device, non_blocking=True)


def _tree_tensors(item: Any) -> Iterator[torch.Tensor]:
    if isinstance(item, torch.Tensor):
        yield item
    elif isinstance(item, dict):
        for v in item.values():
            yield from _tree_tensors(v)
    elif isinstance(item, (list, tuple)):
        for v in item:
            yield from _tree_tensors(v)


def _tree_nbytes(item: Any) -> int:
    """Total nbytes of the arrays inside a batch structure."""
    if hasattr(item, "arrays"):  # parallel.batching.Batch
        return _tree_nbytes(item.arrays)
    if hasattr(item, "nbytes"):
        return int(item.nbytes)
    if isinstance(item, dict):
        return sum(_tree_nbytes(v) for v in item.values())
    if isinstance(item, (list, tuple)):
        return sum(_tree_nbytes(v) for v in item)
    return 0


#: per CUDA device: the side stream slot-staged batches copy on, so that a
#: slot can return to its pool after its own copy, not the stream's work
_SLOT_STREAMS: Dict[int, "torch.cuda.Stream"] = {}
_SLOT_STREAMS_LOCK = threading.Lock()


def _slot_stream() -> "torch.cuda.Stream":
    dev = torch.cuda.current_device()
    with _SLOT_STREAMS_LOCK:
        if dev not in _SLOT_STREAMS:
            _SLOT_STREAMS[dev] = torch.cuda.Stream(dev)
        return _SLOT_STREAMS[dev]


def _clone_tree(item: Any) -> Any:
    """``item`` with every tensor in it cloned (structure preserved)."""
    if isinstance(item, torch.Tensor):
        return item.clone()
    if isinstance(item, dict):
        return {k: _clone_tree(v) for k, v in item.items()}
    if isinstance(item, tuple):
        return tuple(_clone_tree(v) for v in item)
    if isinstance(item, list):
        return [_clone_tree(v) for v in item]
    return item


def timed_stage(put: Callable, item: Any,
                stream: Optional["torch.cuda.Stream"] = None
                ) -> Tuple[Any, BatchTiming]:
    """Stage one host batch with ingest accounting; returns (staged,
    timing). With a copy ``stream`` (CUDA), ``put`` runs on it between two
    timing events, the current (compute) stream waits for the second one,
    and every staged CUDA tensor is marked as used by the compute stream so
    the allocator does not hand its memory to the copy stream early; the
    copy time is read at drain. Without one, ``put`` runs in place and its
    host time is the staging time.

    A slot-staged batch (``item.staging``, a SlotLease) returns its slot to
    the pool once the staged tensors no longer need it: on CUDA after its
    copy has landed (on the ring's copy stream, else on a side stream of
    its own, waited for here, as the reference blocks until the batch is
    device-resident); where staging aliases the host (the CPU), after the
    staged tensors are cloned out of the slot, which the next fill
    overwrites. The ``INGEST_H2D`` fault seam fires before ``put``; a
    failure abandons the slot (it is reused, its content never read)."""
    from ..core import faults

    mask = getattr(item, "mask", None)
    timing = BatchTiming(bytes_in=_tree_nbytes(item),
                         rows=int(getattr(item, "num_valid", 0) or 0),
                         padded_rows=len(mask) if mask is not None else 0)
    slot = getattr(item, "staging", None)
    if slot is not None and stream is None and slot._pool.pin:
        stream = _slot_stream()
    if slot is not None:
        slot.transfer_begin()
    try:
        faults.fire(faults.INGEST_H2D, rows=timing.rows,
                    nbytes=timing.bytes_in)
        if stream is None:
            t0 = time.perf_counter()
            staged = put(item)
            if slot is not None:
                staged = _clone_tree(staged)
            timing.h2d_s = time.perf_counter() - t0
        else:
            compute = torch.cuda.current_stream(stream.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(stream):
                start.record(stream)
                staged = put(item)
                end.record(stream)
            compute.wait_event(end)
            for t in _tree_tensors(staged):
                if t.device.type == "cuda":
                    t.record_stream(compute)
            timing.h2d_events = (start, end)
            if slot is not None:
                end.synchronize()   # the slot is free once its copy landed
    except BaseException:
        if slot is not None:
            slot.release()
        raise
    if slot is not None:
        slot.transfer_end()
    return staged, timing


# ---------------------------------------------------------------------------
# TransferRing
# ---------------------------------------------------------------------------


class ReadbackSlots:
    """Host buffers the ring's readback lands in: one per (ring slot, output
    index), grown when an output outgrows it and otherwise reused from batch
    to batch and from ring to ring. Pinned for a CUDA device, where the
    copy into them runs asynchronously on the readback stream. The ring
    copies each output out of its slot before it yields it, so no array it
    yields aliases a buffer that a later batch overwrites."""

    def __init__(self, pin: bool):
        self.pin = pin
        self._bufs: Dict[Tuple[int, int], torch.Tensor] = {}

    def view(self, slot: int, index: int, like: torch.Tensor) -> torch.Tensor:
        """A host tensor of ``like``'s shape and dtype over the buffer of
        (``slot``, ``index``)."""
        nbytes = like.numel() * like.element_size()
        buf = self._bufs.get((slot, index))
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=self.pin)
            self._bufs[(slot, index)] = buf
        return buf[:nbytes].view(like.dtype).view(like.shape)


@dataclasses.dataclass
class _Readback:
    """One batch's readback in flight: the slot views its outputs land in,
    what must outlive the copy (the step's handle and ``fetch``'s tensors),
    and the (start, end) events on the readback stream (None off CUDA)."""

    views: Tuple[torch.Tensor, ...]
    keep: Any
    events: Any = None
    host_s: float = 0.0


class TransferRing:
    """``depth``-slot host -> device -> compute -> host pipeline over an
    iterator of batches, draining results IN ORDER.

      - ``put(item)``    host batch -> staged device input (``timed_stage``:
                         on the ring's copy stream when the device is CUDA).
      - ``step(staged)`` enqueue the computation on the compute stream;
                         returns a handle. Must not block.
      - ``fetch(handle)`` handle -> a tuple of tensors to read back (a crop,
                         a cast); on CUDA it runs on the ring's readback
                         stream, after the step's done event. Must not block.

    The ring copies ``fetch``'s tensors into ``slots`` (pinned host buffers
    on CUDA, one per ring slot and output, reused) as soon as the step is
    enqueued, and yields one tuple of numpy arrays per batch, copied out of
    the slots. ``depth`` bounds dispatched-but-undrained steps. A step's
    failure (an exception out of ``step`` or ``fetch``) propagates to the
    caller.
    """

    def __init__(self, it: Iterator, put: Callable, step: Callable,
                 fetch: Callable, depth: int = 2,
                 stats: Optional[IngestStats] = None,
                 device: Optional[torch.device] = None,
                 slots: Optional[ReadbackSlots] = None):
        if depth <= 0:
            raise ValueError("depth must be positive")
        self.depth = depth
        self.stats = stats if stats is not None else IngestStats()
        self.stats.note_ring(depth)
        self._it = iter(it)
        self._put, self._step, self._fetch = put, step, fetch
        dev = torch.device(device) if device is not None else None
        self._cuda = dev is not None and dev.type == "cuda"
        self._stream = torch.cuda.Stream(dev) if self._cuda else None
        self._readback = torch.cuda.Stream(dev) if self._cuda else None
        self.slots = slots if slots is not None else ReadbackSlots(self._cuda)

    def __iter__(self):
        inflight: "deque" = deque()
        wall0 = time.perf_counter()
        try:
            for n in itertools.count():
                tq = time.perf_counter()
                try:
                    item = next(self._it)
                except StopIteration:
                    break
                queue_s = time.perf_counter() - tq
                staged, timing = timed_stage(self._put, item, self._stream)
                timing.queue_s = queue_s
                td = time.perf_counter()
                handle = self._step(staged)
                done = None
                if self._cuda:
                    done = torch.cuda.Event()
                    done.record()
                timing.dispatch_s = time.perf_counter() - td
                pending = self._start_readback(handle, done, n % self.depth)
                inflight.append((pending, timing, done))
                self.stats.note_occupancy(len(inflight))
                if len(inflight) >= self.depth:
                    yield self._drain(inflight)
            while inflight:
                yield self._drain(inflight)
        finally:
            self.stats.add_wall(time.perf_counter() - wall0)

    def _start_readback(self, handle, done, slot: int) -> _Readback:
        """Queue ``fetch`` and the copies into ``slot``'s host buffers: on
        CUDA on the readback stream, behind ``done`` and nothing else. The
        handle and ``fetch``'s tensors are held until the copy's end event
        has completed, so the allocator cannot hand their memory to another
        stream while the copy still reads it."""
        if not self._cuda:
            t0 = time.perf_counter()
            ys = tuple(self._fetch(handle))
            views = tuple(self.slots.view(slot, i, y) for i, y in enumerate(ys))
            for v, y in zip(views, ys):
                v.copy_(y)
            return _Readback(views, None, host_s=time.perf_counter() - t0)
        rs = self._readback
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(rs):
            rs.wait_event(done)
            start.record(rs)
            ys = tuple(self._fetch(handle))
            views = tuple(self.slots.view(slot, i, y) for i, y in enumerate(ys))
            for v, y in zip(views, ys):
                v.copy_(y, non_blocking=True)
            end.record(rs)
        return _Readback(views, (handle, ys), (start, end))

    def _drain(self, inflight: "deque"):
        pending, timing, done = inflight.popleft()
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        t1 = time.perf_counter()
        timing.compute_s = t1 - t0
        timing.resolve_h2d()
        device_s = 0.0
        if pending.events is not None:
            start, end = pending.events
            end.synchronize()
            device_s = start.elapsed_time(end) / 1e3
        t2 = time.perf_counter()
        out = tuple(v.numpy().copy() for v in pending.views)
        timing.readback_s = (device_s + pending.host_s
                             + time.perf_counter() - t2)
        self.stats.record(timing)
        return out
