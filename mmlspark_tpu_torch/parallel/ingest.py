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

The reference's ring stages on a background thread (``DevicePrefetcher``)
because ``jax.device_put`` blocks; here the copy is asynchronous on its own
stream, so the ring needs no thread. ``SlotPool`` (reusable staging slots)
and the deposit path wait for a later slice.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
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
    """

    queue_s: float = 0.0
    h2d_s: float = 0.0
    dispatch_s: float = 0.0
    compute_s: float = 0.0
    readback_s: float = 0.0
    bytes_in: int = 0
    rows: int = 0
    padded_rows: int = 0
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
        # rows_to_batch outcome split: spanning zero-copy views vs copies
        self.zero_copy_batches: int = 0
        self.copied_batches: int = 0
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
        self.zero_copy_batches += other.zero_copy_batches
        self.copied_batches += other.copied_batches
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
        """Zero-copy and sparse-layout sections (only populated keys)."""
        out: Dict[str, Any] = {}
        if self.zero_copy_batches or self.copied_batches:
            out["zero_copy_batches"] = self.zero_copy_batches
            out["copied_batches"] = self.copied_batches
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


def _spanning_view(arrs: List[np.ndarray], shape: Tuple[int, ...]
                   ) -> Optional[np.ndarray]:
    """Zero-copy [B, ...] view when the rows sit at a CONSTANT pointer
    stride inside one buffer (rows sliced out of one stacked array); None
    otherwise. Only adjacent rows (stride == row nbytes) qualify, so rows of
    unrelated buffers are never bridged by pointer arithmetic."""
    nb = arrs[0].nbytes
    if len(arrs) < 2 or not nb \
            or not all(a.flags["C_CONTIGUOUS"] for a in arrs):
        return None
    ptrs = [a.__array_interface__["data"][0] for a in arrs]
    if any(p != ptrs[0] + i * nb for i, p in enumerate(ptrs)):
        return None
    return np.lib.stride_tricks.as_strided(
        arrs[0], shape=(len(arrs),) + shape, strides=(nb,) + arrs[0].strides)


def rows_to_batch(rows, stats: Optional[IngestStats] = None) -> np.ndarray:
    """Per-row arrays -> one contiguous [B, ...] batch for staging: a
    strided view when the rows are adjacent slices of one buffer (no copy),
    else ``np.stack``. Rows must agree on shape and dtype. ``stats``
    receives the zero-copy vs copied counters."""
    arrs = [np.asarray(r) for r in rows]
    if not arrs:
        raise ValueError("rows_to_batch needs at least one row")
    shape, dt = arrs[0].shape, arrs[0].dtype
    for a in arrs[1:]:
        if a.shape != shape or a.dtype != dt:
            raise ValueError(
                f"ragged batch: {a.shape}/{a.dtype} vs {shape}/{dt}")
    view = _spanning_view(arrs, shape)
    if view is not None:
        if stats is not None:
            stats.note_batch_copy(zero_copy=True)
        return view
    if stats is not None:
        stats.note_batch_copy(zero_copy=False)
    return np.stack(arrs)


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


def timed_stage(put: Callable, item: Any,
                stream: Optional["torch.cuda.Stream"] = None
                ) -> Tuple[Any, BatchTiming]:
    """Stage one host batch with ingest accounting; returns (staged,
    timing). With a copy ``stream`` (CUDA), ``put`` runs on it between two
    timing events, the current (compute) stream waits for the second one,
    and every staged CUDA tensor is marked as used by the compute stream so
    the allocator does not hand its memory to the copy stream early; the
    copy time is read at drain. Without one, ``put`` runs in place and its
    host time is the staging time."""
    mask = getattr(item, "mask", None)
    timing = BatchTiming(bytes_in=_tree_nbytes(item),
                         rows=int(getattr(item, "num_valid", 0) or 0),
                         padded_rows=len(mask) if mask is not None else 0)
    if stream is None:
        t0 = time.perf_counter()
        staged = put(item)
        timing.h2d_s = time.perf_counter() - t0
        return staged, timing
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
