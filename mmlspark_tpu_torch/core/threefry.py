"""The reference's random draws: Threefry-2x32 keys, splits and uniforms.

The JAX package draws its in-scan GOSS sample from
``jax.random.uniform(key, (n,))`` over the keys
``jax.random.split(jax.random.PRNGKey(seed), iters)``. A card that runs the
port has no JAX, so this module keeps its own copy of those three functions,
bit for bit the JAX 0.9 arithmetic with ``jax_threefry_partitionable`` on
(its default) and 64-bit types off (the reference's setting):

  - ``prng_key(seed)``: ``threefry_seed`` of an int32 seed, the key
    ``(seed >> 32, seed & 0xFFFFFFFF)``, so ``(0, seed mod 2^32)``;
  - ``split(key, num)``: ``_threefry_split_foldlike``, the hash of the
    64-bit counters ``0 .. num - 1`` (``iota_2x32_shape``: high word 0, low
    word the counter), the two output words one new key each;
  - ``uniform(key, n)``: ``_threefry_random_bits_partitionable`` for 32-bit
    draws (the hash of counters ``0 .. n - 1``, ``bits1 ^ bits2``), then
    ``_uniform``'s mantissa trick: ``(bits >> 9) | 0x3F800000`` read as an
    f32 in [1, 2), minus 1.

The counters run over the draw's shape, so a draw of another length is
another sequence: draw over exactly the reference's ``n``.

Plain functions on tensors, on the device of their inputs. The u32
arithmetic runs in int64 masked with ``& 0xFFFFFFFF`` (``torch.uint32``
has too few operations and an int32 right shift is arithmetic); nothing is
read on the host, so a CUDA graph can hold a draw.
"""

from __future__ import annotations

import torch

from ..runtime import DeviceLike, resolve_device

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry_2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                  x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x1, x2)``
    under the key ``(k1, k2)``: int64 tensors holding u32 values, the keys
    broadcasting against the counters. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


def prng_key(seed: int, device: DeviceLike = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: an int64 [2] tensor of u32 words."""
    lo = int(seed) & _MASK
    return torch.tensor([0, lo], dtype=torch.int64,
                        device=resolve_device(device))


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split(key, num)``: an int64 [num, 2] tensor of keys."""
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry_2x32(key[0], key[1], torch.zeros_like(counts), counts)
    return torch.stack([b1, b2], dim=1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` 32-bit draws of ``key`` (an int64 [2] tensor), as int64."""
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry_2x32(key[0], key[1], torch.zeros_like(counts), counts)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))``: [n] f32 in [0, 1)."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats, min=0.0)
