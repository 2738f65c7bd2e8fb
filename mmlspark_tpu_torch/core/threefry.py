"""The reference's random draws: Threefry-2x32 keys, splits, uniforms and normals.

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
    f32 in [1, 2), minus 1;
  - ``normal(key, n)``: ``_normal_real``, a uniform on
    [nextafter(-1, 0), 1) (the draw above times ``1 - lo``, which rounds
    to 2, plus ``lo``, at least ``lo``) through ``sqrt(2) * erf_inv``.
    ``erf_inv`` is XLA's f32 polynomial (``chlo.erf_inv``) over its own
    ``log1p`` (a Cephes rational below ``sqrt(2) - 1``, else the log of
    ``1 + x`` by its mantissa and exponent), step for step as the CPU
    backend compiles them, its multiply-adds fused: each fused step is an
    f64 product and sum rounded once to f32. ``torch.erfinv`` and
    ``torch.log1p`` are other approximations, and the CPU's vectorised
    ``torch.sqrt`` is not always correctly rounded, so this module takes
    neither; every op here is an IEEE operation, so the card's draw is
    the CPU's bit for bit.

The counters run over the draw's shape, so a draw of another length is
another sequence: draw over exactly the reference's ``n``.

Plain functions on tensors, on the device of their inputs. The u32
arithmetic runs in int64 masked with ``& 0xFFFFFFFF`` (``torch.uint32``
has too few operations and an int32 right shift is arithmetic); nothing is
read on the host, so a CUDA graph can hold a draw.
"""

from __future__ import annotations

import numpy as np
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


def _f32(v: float) -> float:
    """The f32 value of an f32 constant, as LLVM spells it (an f64)."""
    return float(np.float32(v))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32 (``b`` and ``c`` f32 tensors or
    f32 constants): the product is exact in f64, the sum rounds in f64 and
    then to f32 (a double rounding that differs from a fused multiply-add
    only where the f64 sum lands on an f32 tie)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def _sqrt(w: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root of ``w >= 0``: the f64 root
    rounded to f32, then moved to the neighbour whose interval holds
    ``w`` (the midpoints of f32 neighbours square exactly in f64)."""
    w64 = w.double()
    r = torch.sqrt(w64).float()
    lo = torch.nextafter(r, torch.zeros_like(r))
    hi = torch.nextafter(r, torch.full_like(r, float("inf")))
    m_lo = (lo.double() + r.double()) * 0.5
    m_hi = (r.double() + hi.double()) * 0.5
    r = torch.where(w64 < m_lo * m_lo, lo, r)
    return torch.where(w64 > m_hi * m_hi, hi, r)


# XLA's f32 log1p, its constants as f32 values: the Cephes rational below
# sqrt(2) - 1 (numerator, denominator after its leading 1), and the log of
# 1 + x from its mantissa m in [sqrt(1/2), sqrt(2)) and exponent e:
# three quadratics in r = m - 1 joined by r^3, plus e * ln 2 in two parts
_LOG1P_SMALL = 0.4142135679721832
_LOG1P_NUM = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
              29.91191864013672, 60.949668884277344, 57.11296463012695,
              20.039552688598633)
_LOG1P_DEN = (15.062909126281738, 83.04756927490234, 221.7624053955078,
              309.0987243652344, 216.42788696289062, 60.11865997314453)
_LOG_POLY = ((0.07037683576345444, -0.11514610052108765, 0.11676998436450958),
             (-0.12420140951871872, 0.14249323308467865, -0.16668057441711426),
             (0.2000071406364441, -0.24999994039535522, 0.3333333134651184))
_LN2_LO = -0.00021219444170128554
_LN2_HI = 0.693359375
_SQRT_HALF = 0.7071067690849304
_F32_MIN = 1.1754943508222875e-38


def _log1p(t: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log1p`` as the CPU backend compiles it, bit for bit."""
    y = t + 1.0
    bits = torch.where(y > _F32_MIN, y, _F32_MIN).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    below = m < _SQRT_HALF
    e = ((bits >> 23) - 127).float() + 1.0 - below.float()
    r = (m - 1.0) + torch.where(below, m, 0.0)
    r2 = r * r
    r3 = r2 * r
    a, b, c = (_fma(_fma(r, k[0], k[1]), r, k[2]) for k in _LOG_POLY)
    c = _fma(_fma(a, r3, b), r3, c)
    s = _fma(c, r3, e * _LN2_LO)
    big = _fma(e, _LN2_HI, (r - r2 * 0.5) + s)
    big = torch.where(y > 0, big, float("nan"))
    big = torch.where(y == 0, float("-inf"), big)
    big = torch.where(y == float("inf"), y, big)
    one = t * 0.0 + 1.0
    den = _fma(one, t, _LOG1P_DEN[0])
    for k in _LOG1P_DEN[1:]:
        den = _fma(den, t, k)
    num = t * 0.0 + _LOG1P_NUM[0]
    for k in _LOG1P_NUM[1:]:
        num = _fma(num, t, k)
    t2 = t * t
    small = t + _fma(t2, -0.5, (t * t2) * (num / den))
    return torch.where(t.abs() < _LOG1P_SMALL, small, big)


# XLA's f32 erf_inv (Giles' polynomials, f32 values): w < 5 and w >= 5
_ERFINV_LT5 = (2.810226362726098e-08, 3.432739390518691e-07,
               -3.523387704262859e-06, -4.391506536194356e-06,
               0.00021858086984138936, -0.001253725029528141,
               -0.004177681636065245, 0.24664072692394257, 1.5014094114303589)
_ERFINV_GE5 = (-0.0002002142573473975, 0.0001009505576803349,
               0.0013493432197719812, -0.003673428436741233,
               0.005739507731050253, -0.007622461300343275,
               0.00943887047469616, 1.0016740560531616, 2.832976818084717)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` of f32 ``x`` as the CPU backend computes it."""
    lg = _log1p(x * -x)
    lt5 = lg > -5.0
    z = torch.where(lt5, -2.5 - lg, _sqrt(-lg) - 3.0)
    coef = [torch.where(lt5, a, b).to(torch.float32)
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = _fma(coef[0], z, coef[1])
    for k in coef[2:]:
        p = _fma(z, p, k)
    return x * torch.where(x.abs() == 1.0, float("inf"), p)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` for ``n = prod(shape)``, flat: [n]
    f32 (reshape it; the counters run over the shape flattened)."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # (1 - lo) rounds to 2 in f32, so the scaling is exact
    u = torch.clamp(floats * 2.0 + _NORMAL_LO, min=_NORMAL_LO)
    return erf_inv(u) * _SQRT2
