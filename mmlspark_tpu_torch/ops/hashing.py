"""MurmurHash3 (x86 32-bit) — VW-compatible feature hashing (the port of
``mmlspark_tpu/ops/hashing.py``, pure numpy, so the port keeps its own copy).

The reference exposes VW's murmur through VowpalWabbitMurmur.hash for its
featurizers (vw/VowpalWabbitFeaturizer.scala:62-180, VowpalWabbitMurmurWithPrefix).
``hash_strings`` hashes a batch through the native library's
``mml_murmur3_batch`` (``native_loader.murmur3_batch``) and keeps this
numpy path where the library cannot be built. Host code: nothing here runs
on the card.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)


def _rotl32(x: np.uint32, r: int) -> np.uint32:
    x = np.uint32(x)
    return np.uint32((int(x) << r | int(x) >> (32 - r)) & 0xFFFFFFFF)


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3_x86_32 over bytes; matches VW/Scala reference output."""
    with np.errstate(over="ignore"):
        h = np.uint32(seed & 0xFFFFFFFF)
        n = len(data)
        n_blocks = n // 4
        blocks = np.frombuffer(data[: n_blocks * 4], dtype="<u4")
        for k in blocks:
            k = np.uint32(k) * _C1
            k = _rotl32(k, 15) * _C2
            h = np.uint32(h ^ k)
            h = _rotl32(h, 13)
            h = np.uint32(h * np.uint32(5) + np.uint32(0xE6546B64))
        # tail
        tail = data[n_blocks * 4:]
        k = np.uint32(0)
        if len(tail) >= 3:
            k = np.uint32(k ^ np.uint32(tail[2] << 16))
        if len(tail) >= 2:
            k = np.uint32(k ^ np.uint32(tail[1] << 8))
        if len(tail) >= 1:
            k = np.uint32(k ^ np.uint32(tail[0]))
            k = np.uint32(k * _C1)
            k = _rotl32(k, 15)
            k = np.uint32(k * _C2)
            h = np.uint32(h ^ k)
        # finalization
        h = np.uint32(h ^ np.uint32(n))
        h = np.uint32(h ^ (h >> np.uint32(16)))
        h = np.uint32(h * np.uint32(0x85EBCA6B))
        h = np.uint32(h ^ (h >> np.uint32(13)))
        h = np.uint32(h * np.uint32(0xC2B2AE35))
        h = np.uint32(h ^ (h >> np.uint32(16)))
        return int(h)


def hash_string(s: str, seed: int = 0) -> int:
    return murmur3_32(s.encode("utf-8"), seed)


class MurmurWithPrefix:
    """Prefix-seeded hashing: precompute the hash state of a fixed prefix so
    per-feature hashing only processes the suffix
    (reference vw/VowpalWabbitMurmurWithPrefix.scala)."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self.prefix_bytes = prefix.encode("utf-8")

    def hash(self, suffix: str, seed: int = 0) -> int:
        # correctness first: hash(prefix + suffix); the prefix-state optimization
        # lives in the C++ path
        return murmur3_32(self.prefix_bytes + suffix.encode("utf-8"), seed)


def hash_strings(values: Iterable[str], seed: int = 0) -> np.ndarray:
    """Batch hashing: C++ fast path when built, python fallback."""
    vals = list(values)
    from .. import native_loader

    native = native_loader.murmur3_batch(vals, seed)
    if native is not None:
        native_loader.count("murmur3_batch", "native")
        return native
    native_loader.count("murmur3_batch", "numpy")
    return np.fromiter((hash_string(v, seed) for v in vals), dtype=np.int64)
