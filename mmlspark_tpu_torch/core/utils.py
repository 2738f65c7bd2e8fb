"""Core utilities: timing, retries, async buffering, resource management.

Parity targets:
  - StopWatch                — core/utils/StopWatch.scala (VW phase timing)
  - retry_with_timeout/retry — downloader/ModelDownloader FaultToleranceUtils.retryWithTimeout
                               (ModelDownloader.scala:37-47) and LightGBM networkInit
                               exponential backoff (TrainUtils.scala:365-381)
  - buffered_await           — core/utils/AsyncUtils.bufferedAwait
  - using                    — core/env/StreamUtilities.using
  - cast_utilities           — core/utils/CastUtilities

The port's copy of ``mmlspark_tpu/core/utils.py`` (host code).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import logging
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence, TypeVar

import numpy as np

T = TypeVar("T")

log = logging.getLogger("mmlspark_tpu_torch")


class StopWatch:
    """Cumulative nanosecond timer (reference core/utils/StopWatch.scala)."""

    def __init__(self):
        self.elapsed_ns = 0
        self._start: Optional[int] = None

    def start(self) -> None:
        self._start = time.perf_counter_ns()

    def stop(self) -> None:
        if self._start is not None:
            self.elapsed_ns += time.perf_counter_ns() - self._start
            self._start = None

    @contextlib.contextmanager
    def measure(self) -> Iterator[None]:
        self.start()
        try:
            yield
        finally:
            self.stop()

    @property
    def elapsed_s(self) -> float:
        return self.elapsed_ns / 1e9


def retry(fn: Callable[[], T], max_retries: int = 3, initial_delay_s: float = 0.1,
          backoff: float = 2.0, exceptions=(Exception,),
          on_retry: Optional[Callable[[int, Exception], None]] = None) -> T:
    """Exponential-backoff retry (LightGBM networkInit parity, TrainUtils.scala:365-381)."""
    delay = initial_delay_s
    for attempt in range(max_retries):
        try:
            return fn()
        except exceptions as e:  # noqa: PERF203
            if attempt == max_retries - 1:
                raise
            if on_retry:
                on_retry(attempt, e)
            log.warning("retry %d/%d after %s: %s", attempt + 1, max_retries, type(e).__name__, e)
            time.sleep(delay)
            delay *= backoff
    raise RuntimeError("unreachable")


def retry_with_timeout(fn: Callable[[], T], timeout_s: float, max_retries: int = 3) -> T:
    """Run ``fn`` with a per-attempt timeout (ModelDownloader.scala:37-47 parity)."""
    last_err: Optional[Exception] = None
    for _ in range(max_retries):
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        fut = pool.submit(fn)
        try:
            return fut.result(timeout=timeout_s)
        except Exception as e:  # includes TimeoutError
            last_err = e
        finally:
            # Don't join a potentially-hung worker: a blocking shutdown would defeat
            # the timeout. The daemon thread is abandoned on timeout.
            pool.shutdown(wait=False, cancel_futures=True)
    raise last_err  # type: ignore[misc]


def buffered_await(futures: Iterable[concurrent.futures.Future], buffer_size: int
                   ) -> Iterator[Any]:
    """Yield future results in order while keeping at most ``buffer_size`` outstanding
    (reference core/utils/AsyncUtils.bufferedAwait — bounded pipelined concurrency)."""
    window: List[concurrent.futures.Future] = []
    it = iter(futures)
    try:
        for _ in range(buffer_size):
            window.append(next(it))
    except StopIteration:
        pass
    while window:
        head = window.pop(0)
        yield head.result()
        try:
            window.append(next(it))
        except StopIteration:
            continue


@contextlib.contextmanager
def using(*resources):
    """Resource-safe block (core/env/StreamUtilities.using parity)."""
    try:
        yield resources if len(resources) > 1 else resources[0]
    finally:
        for r in resources:
            close = getattr(r, "close", None)
            if close:
                with contextlib.suppress(Exception):
                    close()


def cast_column(col: np.ndarray, dtype: str) -> np.ndarray:
    """Numeric column coercion (core/utils/CastUtilities parity)."""
    if col.dtype == object:
        return np.array([np.asarray(v, dtype=dtype) if isinstance(v, np.ndarray)
                         else dtype_scalar(v, dtype) for v in col], dtype=object)
    return col.astype(dtype)


def dtype_scalar(v: Any, dtype: str) -> Any:
    return np.dtype(dtype).type(v)


class SharedVariable:
    """Per-process lazily-initialized singleton (io/http/SharedVariable.scala:1-65 parity).

    In the reference this provides one HTTP client / native handle per JVM shared across
    partitions; here, one per host process shared across partition map calls.
    """

    _instances: dict = {}
    _UNSET = object()

    def __init__(self, factory: Callable[[], T], key: Optional[str] = None):
        self._factory = factory
        self._key = key  # None => cache on this instance (keys from id() would be reused)
        self._value: Any = SharedVariable._UNSET

    def get(self) -> T:
        if self._key is None:
            if self._value is SharedVariable._UNSET:
                self._value = self._factory()
            return self._value
        if self._key not in SharedVariable._instances:
            SharedVariable._instances[self._key] = self._factory()
        return SharedVariable._instances[self._key]

    @classmethod
    def clear_all(cls) -> None:
        cls._instances.clear()
