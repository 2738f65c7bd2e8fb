"""Row stacking, static-shape batching helpers and background batchers.

Copy of the reference's ``mmlspark_tpu/parallel/batching.py`` less its mesh
helper (``pad_to_multiple_of_shards``, ROADMAP A step 9):

  - ``DevicePrefetcher``: a fill thread over a batch iterator (the fused
    executor's slot-deposit lookahead, core/fusion.py ``_fill_ahead``);
    ``close()`` hands the staging leases of queued batches back to the
    SlotPool (parallel/ingest.py).
  - ``DynamicBufferedBatcher`` / ``TimeIntervalBatcher``: background
    buffered batchers over any iterator (drain-everything and time-window
    flushing).
  - ``next_bucket``, ``pad_batch``, ``Batch``, ``is_sparse_row``,
    ``sparse_width``, ``densify_sparse``, ``stack_rows``, ``Minibatcher``,
    ``_crop`` and ``concat_outputs``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np


def _release_staging(item) -> None:
    """Return a dropped batch's SlotPool lease (``Batch.staging``) to the
    pool. Queued batches can carry leased staging buffers; dropping one on
    close()/abort without releasing would permanently shrink the shared,
    never-replenished pool. Idempotent (SlotLease.release guards), no-op
    for lease-less items."""
    lease = getattr(item, "staging", None)
    if lease is not None:
        try:
            lease.release()
        except Exception:  # noqa: BLE001 - cleanup must not mask the abort
            pass


class DevicePrefetcher:
    """Background-thread device prefetch: pull items from an iterator, ship
    them to the device (``put``), and hand over device-resident results
    through a bounded queue — the producer's decode/stack/H2D cost overlaps
    the consumer's compute.

    Reference analogue: the background-thread DynamicBufferedBatcher
    (stages/Batchers.scala:12-160) that keeps Spark partitions fed while the
    consumer works. ``depth`` bounds in-flight batches (double buffering by
    default) so memory stays bounded.

    Iterate it like the original iterator; producer exceptions re-raise at
    the consumer.
    """

    _DONE = object()

    def __init__(self, it: Iterator, put: Optional[Callable] = None,
                 depth: int = 2):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: List[BaseException] = []
        self._stop = threading.Event()

        def offer(item) -> bool:
            """Bounded put that gives up when the consumer closed — an
            abandoned iteration must not strand this thread (and its
            device-resident buffers) on a full queue forever."""
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in it:
                    if self._stop.is_set():
                        _release_staging(item)
                        return
                    staged = put(item) if put is not None else item
                    if not offer(staged):
                        _release_staging(staged)
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised at consumer
                self._err.append(e)
            finally:
                offer(self._DONE)

        self._thread = threading.Thread(target=produce, daemon=True,
                                        name="device-prefetch")
        self._thread.start()

    def close(self) -> None:
        """Release the producer thread and any queued buffers (idempotent).
        Dropped items hand their staging leases back to the SlotPool — an
        early abort must not strand pre-allocated slot buffers."""
        self._stop.set()
        try:
            while True:
                _release_staging(self._q.get_nowait())
        except Exception:
            pass

    def _get(self):
        """Blocking get that an external close() can always interrupt: poll
        with a timeout and re-check _stop, so a consumer is never stranded
        on an empty queue whose producer already gave up (the DONE injection
        can lose the race with close()'s drain)."""
        import queue

        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return self._DONE

    def __iter__(self):
        try:
            while True:
                item = self._get()
                if item is self._DONE:
                    if self._err:
                        raise self._err[0]
                    return
                yield item
        finally:
            self.close()


class DynamicBufferedBatcher:
    """Background-thread buffered batcher over any iterator: a producer
    thread fills a bounded buffer (backpressure — it blocks at
    ``max_buffer`` items); each ``next()`` drains EVERYTHING currently
    buffered into one list, so batch size adapts to the consumer's speed
    (slow consumer -> bigger batches, fast consumer -> batches of 1).

    Reference parity: DynamicBufferedBatcher (stages/Batchers.scala:12-60)
    — the iterator primitive under DynamicMiniBatchTransformer. Producer
    exceptions re-raise at the consumer; ``close()`` releases the thread.
    """

    _DONE = object()

    def __init__(self, it: Iterator, max_buffer: int = 1000):
        import queue
        import threading

        if max_buffer <= 0:
            raise ValueError("max_buffer must be positive")
        self._q: "queue.Queue" = queue.Queue(maxsize=max_buffer)
        self._err: List[BaseException] = []
        self._stop = threading.Event()

        def offer(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in it:
                    if self._stop.is_set() or not offer(item):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised at consumer
                self._err.append(e)
            finally:
                offer(self._DONE)

        self._thread = threading.Thread(target=produce, daemon=True,
                                        name="dynamic-batcher")
        self._thread.start()

    def close(self) -> None:
        import queue

        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except Exception:
            pass
        # wake any consumer blocked in a no-timeout get(): the producer's
        # offer(_DONE) gives up once _stop is set, so DONE must be fed from
        # here (the drain above guarantees space; a racing put is fine to
        # drop — the consumer only needs one)
        try:
            self._q.put_nowait(self._DONE)
        except queue.Full:
            pass

    def _get(self):
        """Blocking get interruptible by an external close(): poll with a
        timeout and re-check _stop (close()'s drain can race a blocked
        producer put and lose the injected DONE on a re-filled queue)."""
        import queue

        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return self._DONE

    def __iter__(self):
        import queue

        try:
            done = False
            while not done:
                batch = [self._get()]  # block for at least one item
                try:
                    while True:
                        batch.append(self._q.get_nowait())
                except queue.Empty:
                    pass
                # scan the WHOLE batch for the sentinel: a producer blocked in
                # put() when close() drained can land items AFTER the injected
                # DONE, so it is not necessarily last — anything behind it is
                # abandoned by close() semantics, and the opaque sentinel must
                # never leak to the consumer as data
                for i, item in enumerate(batch):
                    if item is self._DONE:
                        batch = batch[:i]
                        done = True
                        break
                if batch:
                    yield batch
            if self._err:
                raise self._err[0]
        finally:
            self.close()


class TimeIntervalBatcher:
    """Time-windowed batcher over any iterator: a producer thread buffers
    items; batches flush every ``interval_s`` seconds (whatever arrived in
    the window, >= 1 item) or at ``max_batch_size``, whichever first.

    Reference parity: TimeIntervalMiniBatchTransformer's iterator
    (stages/Batchers.scala:98-160). Windows with no items yield nothing
    (the reference blocks for the first element too).
    """

    _DONE = object()

    def __init__(self, it: Iterator, interval_s: float = 1.0,
                 max_batch_size: int = int(1e9), max_buffer: int = 1000):
        self._interval = float(interval_s)
        self._max_batch = int(max_batch_size)
        self._inner = DynamicBufferedBatcher(it, max_buffer)

    def close(self) -> None:
        self._inner.close()

    def __iter__(self):
        import queue
        import time as _time

        q, done_tok = self._inner._q, self._inner._DONE
        try:
            done = False
            while not done:
                # _get: interruptible by close() (returns DONE once stopped)
                batch = [self._inner._get()]  # block for the first element
                if batch[0] is done_tok:
                    break
                deadline = _time.monotonic() + self._interval
                while len(batch) < self._max_batch:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        item = q.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if item is done_tok:
                        done = True
                        break
                    batch.append(item)
                if batch:
                    yield batch
            if self._inner._err:
                raise self._inner._err[0]
        finally:
            self.close()


def next_bucket(n: int, buckets: Optional[Sequence[int]] = None,
                multiple: int = 8) -> int:
    """Smallest allowed static size >= n. Default: next power of two >=
    max(n, multiple). ``buckets`` (an ascending bucket set, the fused
    executor's ``buckets`` knob) overrides the power-of-two policy."""
    if n <= 0:
        return multiple
    if buckets:
        for b in buckets:
            if b >= n:
                return b
        return buckets[-1]
    return max(multiple, 1 << (n - 1).bit_length())


def pad_batch(arr: np.ndarray, target: int, pad_value: float = 0.0) -> np.ndarray:
    """Pad leading dim of ``arr`` up to ``target`` rows with ``pad_value``."""
    n = arr.shape[0]
    if n == target:
        return arr
    if n > target:
        raise ValueError(f"batch of {n} rows exceeds target {target}")
    pad_width = [(0, target - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=pad_value)


@dataclasses.dataclass
class Batch:
    """One padded, static-shape batch: host arrays + validity mask.

    ``staging``: the SlotPool lease (parallel/ingest.py SlotLease) when the
    arrays live in a pre-allocated staging slot — ``timed_stage`` returns
    the buffers to the pool once the batch's copy to the device is done.
    None for plainly-allocated batches."""

    arrays: Dict[str, np.ndarray]
    mask: np.ndarray          # [B] bool, True = real row
    num_valid: int
    staging: Any = None


def is_sparse_row(v) -> bool:
    """True for the framework's sparse-row struct ``{"indices", "values"
    [, "size"]}`` (shared by TextFeaturizer and the VW featurizer)."""
    return isinstance(v, dict) and "indices" in v and "values" in v


def sparse_width(col) -> int:
    """The dense width of a sparse-row column: the declared ``size`` when the
    producer carries one (widths then do NOT depend on which rows a partition
    happens to hold), else max index + 1."""
    width = 0
    for v in col:
        if v is None:
            continue
        s = int(v.get("size", 0))
        if not s:
            idx = np.asarray(v["indices"])
            s = int(idx.max()) + 1 if idx.size else 0
        width = max(width, s)
    return width


def densify_sparse(col, width: int, dtype=np.float64) -> np.ndarray:
    """Sparse-row column -> dense [N, width]. Indices >= width are dropped."""
    out = np.zeros((len(col), width), dtype=dtype)
    for i, v in enumerate(col):
        if v is None:
            continue
        idx = np.asarray(v["indices"], dtype=np.int64)
        keep = idx < width
        out[i, idx[keep]] = np.asarray(v["values"], dtype=dtype)[keep]
    return out


def stack_rows(col: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Stack a column of per-row arrays/scalars into one dense [N, ...] array.

    Sparse rows densify here (via ``sparse_width``/``densify_sparse``).
    Ragged dense rows are an error — resize/pad upstream.
    """
    if col.dtype != object:
        return np.ascontiguousarray(col, dtype=dtype)
    probe = next((v for v in col if v is not None), None)
    if is_sparse_row(probe):
        width = sparse_width(col)
        if width > (1 << 22):
            raise ValueError(
                f"sparse column width {width} is too large to densify — "
                f"use a smaller feature space")
        return densify_sparse(col, width, dtype=dtype)
    rows = [np.asarray(v, dtype=dtype) for v in col]
    shapes = {r.shape for r in rows}
    if len(shapes) > 1:
        raise ValueError(f"Ragged rows (shapes {shapes}); resize/pad before batching")
    return np.stack(rows)


class Minibatcher:
    """FixedMiniBatchTransformer-equivalent over column dicts.

    With ``bucket=True`` the final short batch is padded (with
    ``pad_value``) to a bucket size so batch shapes repeat across
    partitions; per-row outputs are later cropped by ``num_valid``.
    ``preserve_int``: integer columns keep their dtype instead of casting to
    ``dtype`` (token ids must reach the embedding as ints).
    """

    def __init__(self, batch_size: int = 32, bucket: bool = True,
                 dtype=np.float32, pad_value: float = 0.0,
                 preserve_int: bool = False):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.batch_size = batch_size
        self.bucket = bucket
        self.dtype = dtype
        self.pad_value = pad_value
        self.preserve_int = preserve_int

    def _col_dtype(self, col):
        if not self.preserve_int:
            return self.dtype
        if getattr(col, "dtype", None) is not None and col.dtype != object:
            return None if np.issubdtype(col.dtype, np.integer) else self.dtype
        probe = next((v for v in col if v is not None), None)
        if probe is not None and np.issubdtype(np.asarray(probe).dtype,
                                               np.integer):
            return None
        return self.dtype

    def batches(self, part: Dict[str, np.ndarray], cols: Sequence[str]
                ) -> Iterator[Batch]:
        n = len(next(iter(part.values()))) if part else 0
        dense = {c: stack_rows(part[c], self._col_dtype(part[c]))
                 for c in cols}
        for start in range(0, n, self.batch_size):
            stop = min(start + self.batch_size, n)
            m = stop - start
            target = self.batch_size if (m == self.batch_size or not self.bucket) \
                else next_bucket(m)
            target = min(target, self.batch_size) if m < self.batch_size else target
            arrays = {c: pad_batch(dense[c][start:stop], target, self.pad_value)
                      for c in cols}
            mask = np.zeros(target, dtype=bool)
            mask[:m] = True
            yield Batch(arrays, mask, m)


def _crop(res: Any, n: int) -> Any:
    """The first ``n`` rows of every array or tensor in ``res`` (dicts and
    sequences of them): a padded batch's outputs without the padding."""
    if isinstance(res, dict):
        return {k: _crop(v, n) for k, v in res.items()}
    if isinstance(res, (list, tuple)):
        return type(res)(_crop(v, n) for v in res)
    return res[:n] if hasattr(res, "shape") else np.asarray(res)[:n]


def concat_outputs(outs: List[Any]) -> Any:
    """FlattenBatch parity: merge per-batch outputs back into full-length
    columns."""
    if not outs:
        return outs
    first = outs[0]
    if isinstance(first, dict):
        return {k: concat_outputs([o[k] for o in outs]) for k in first}
    if isinstance(first, (list, tuple)) and not isinstance(first, np.ndarray):
        return type(first)(concat_outputs([o[i] for o in outs])
                           for i in range(len(first)))
    return np.concatenate([np.asarray(o) for o in outs], axis=0)
