"""K5, K6 and K7: the flash-attention kernels (``csrc/flash_attn.cu``, the
forward, and ``csrc/flash_attn_bwd.cu``, the backward) and their plain
versions.

Replaces the TPU route ``mmlspark_tpu/models/attention.py:_flash_dispatch``,
which calls the library kernel
``jax.experimental.pallas.ops.tpu.flash_attention`` (Pallas, reaching
``pl.pallas_call`` inside JAX). The function is bf16 attention over
``[B, T, H, D]`` tensors, non-causal or full-square causal, with
``sm_scale = 1/sqrt(D)``; the output is bf16 ``[B, Tq, H, D]``.

``flash_attention_plain`` is the reference's XLA path (``dense_attention``
with the flash route off, ``attention.py:106-121``), rounding step for
rounding step: ``k`` scaled in its own dtype, scores in f32 (f64 for f64
inputs), masked rows giving zeros, probabilities normalised in f32 and
rounded to the value dtype before the second product. It is the plain
version of K5 and the port's attention everywhere the gate
(``attention.flash_route``) keeps the kernel off; it runs over chunks of the
batch so that its ``[b, H, Tq, Tk]`` score tensor stays near 1 GiB.

Bound on the H100: operations (4 * B * H * Tq * Tk * D flops, halved under
causal masking, against 8 bytes per element of q, k, v and o). The kernel
is a Hopper design: TMA loads of K/V tiles into a ring of shared-memory
stages by a producer warp, ``wgmma`` for both products in two or three
consumer warpgroups of 64 query rows (at head dims 384 and 512 a CTA
writes half the output columns). It takes every head dim the gate admits:
above 512 one instantiation takes D at run time, streaming Q and K through
the ring in 64-column chunks and cutting the output into ``SLICE``-column
slices, one a CTA (``col_slices``). See the source for the design.

``flash_attention`` is the wrapper: a CUDA tensor launches the kernel
(there is no fallback: a build or launch failure propagates), a CPU tensor
takes the plain version, anything else raises. ``launches`` counts kernel
launches, through CUDA graph replays too (core/graphs.py: the fused
executor's mega dispatch replays captured launches), and each launch adds
its flops and bytes to an active cost tally (obs/perf.py), which cannot see
inside it. K5 launched with an ``lse`` buffer also writes each row's
log-sum-exp, which the backward reads.

The backward replaces the two Pallas kernels of the library's
``flash_attention`` VJP (``_flash_attention_bwd_dkv``, K6, and
``_flash_attention_bwd_dq``, K7), which the reference runs when it trains
through its flash route. ``flash_attention_bwd_plain`` is the library's
formula (``mha_reference_bwd``) with the kernels' rounding steps: P from
the f32 scores and the forward's ``lse``, P and dS rounded to bf16 before
their products, f32 sums, dQ/dK/dV rounded to bf16 once.
``FlashAttention`` is the autograd Function: K5 with ``lse`` forward, the
row sums ``di = rowsum(dO * O)`` (a torch reduction, as the library's
``jnp.sum``) and K6 then K7 backward; on CPU tensors (the tests) the plain
pair. K6 and K7 are K5's Hopper design (a TMA producer warp, two ``wgmma``
consumer warpgroups taking turns, a ring of shared-memory stages): K6 a CTA
per key tile (128 keys, 64 at D = 256, where its two warpgroups split the
products instead of the columns) streaming query tiles (64 rows, 32 at
D = 128) of Q, dO, lse and di; K7 a CTA per 128 queries streaming K/V
tiles (128, 64 or 32 keys at D = 64, 128, 256). Up to D = 256 no CTA
recomputes another's products; from 384 up each CTA owns a ``SLICE`` of
the output columns, streams the operands of the products reduced over D
(K6: S^T and dP^T; K7: S and dP) in 64-column chunks and recomputes P and
dS in each slice. No output element has two writers (``bwd_launch_grid``,
``bwd_smem_bytes`` and ``bwd_tiles`` mirror the source's grids, shared
memory and tile schedules). ``bwd_dkv_launches`` and ``bwd_dq_launches``
count K6's and K7's launches as ``launches`` counts K5's. While grad is
enabled and an input requires grad, only ``FlashAttention`` may launch K5:
a bare ``flash_attention_cuda`` call raises rather than return an output
that autograd cannot differentiate.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .. import _kernels
from ..core import graphs
from ..obs import perf as _perf

#: kernel launches since the counter was last set to 0 (K5, K6, K7)
launches = 0
bwd_dkv_launches = 0
bwd_dq_launches = 0
graphs.count_replays(__name__, "launches", "bwd_dkv_launches",
                     "bwd_dq_launches")

#: the largest head dims with tuned instantiations (K5; K6 and K7): above
#: them each kernel takes D at run time in column slices of ``SLICE``
FWD_TUNED_MAX = 512
BWD_TUNED_MAX = 256
#: output columns a CTA of the sliced layouts owns
SLICE = 128
#: query and key lengths must be multiples of 64 (the Hopper kernel's
#: query tiles are 192 or 128 rows and its key tiles 128 or 64; a partial
#: last tile is masked)
TILE = 64
#: score elements per chunk of the plain version (2^28 f32 = 1 GiB)
_PLAIN_CHUNK_ELEMENTS = 1 << 28
#: the most blocks a 1-D CUDA grid takes
MAX_GRID_BLOCKS = (1 << 31) - 1


def head_dim_ok(d: int) -> bool:
    """The head dims the kernels take: the gate's, 64 or a multiple of 128
    (the reference's ``_flash_dispatch``)."""
    return d == 64 or (d > 0 and d % 128 == 0)


def col_slices(d: int, which: str = "fwd") -> int:
    """CTAs that share a row tile, each writing its own output columns: K5
    (``which="fwd"``) writes half of them at D = 384 and 512 and a
    ``SLICE`` above (``Sm90Cfg``, ``SlicedCfg``); K6 and K7 (``"dkv"``,
    ``"dq"``) a ``SLICE`` from 384 up (``DkvSlicedCfg``, ``DqSlicedCfg``)."""
    if which == "fwd":
        return d // SLICE if d > FWD_TUNED_MAX else 2 if d > 256 else 1
    return d // SLICE if d > BWD_TUNED_MAX else 1


def launch_grid(b: int, tq: int, h: int, d: int) -> Tuple[int, int, int]:
    """K5's 1-D grid for a [B, Tq, H, D] query: (query blocks, head x
    column-slice slots, total blocks). A CTA takes 192 query rows at D=64
    and 128 above (3 or 2 consumer warpgroups) and ``col_slices`` of the
    output columns (``Sm90Cfg`` and ``SlicedCfg`` in the source)."""
    m_blocks = -(-tq // (192 if d == 64 else 128))
    hc = h * col_slices(d)
    return m_blocks, hc, m_blocks * hc * b


def grid_decode(block, m_blocks: int, hc: int):
    """Block index -> (batch, head x column-split slot, query block), query
    blocks fastest, as the kernel decodes ``blockIdx.x`` (works on ints and
    on numpy arrays)."""
    return block // (m_blocks * hc), (block // m_blocks) % hc, block % m_blocks


#: the most shared memory a block takes on the H100 (bytes)
SMEM_MAX = 232_448


def bwd_tile_rows(d: int, which: str) -> int:
    """Rows of the tile one CTA owns: K6's keys (``which="dkv"``: 128, two
    warpgroups of 64, or 64 at D = 256, where both warpgroups work on the
    same keys) or K7's queries (``"dq"``: 128) (``DkvCfg``/``DqCfg``, and
    from D = 384 up ``DkvSlicedCfg``/``DqSlicedCfg``)."""
    if which == "dkv":
        return 64 if d == 256 else 128
    return 128


def bwd_stream_rows(d: int, which: str) -> int:
    """Rows of a tile a CTA streams through its ring: K6's query tiles (64;
    32 at D = 128 and from 384 up, for registers) or K7's key tiles (128 at
    D = 64, 64 at 128, 32 at 256, 64 from 384 up)."""
    if which == "dkv":
        return 32 if d == 128 or d > BWD_TUNED_MAX else 64
    return {64: 128, 128: 64, 256: 32}.get(d, 64)


def bwd_smem_bytes(d: int, which: str, parts: bool = False):
    """Dynamic shared memory of one K6 or K7 CTA, as the source sizes it:
    the tiles loaded once (K6: K and V of its keys; K7: Q and dO of its 128
    queries), K6's P hand-over at D = 256 (f32, 64 x 64), the ring's stages
    (K6: a Q and a dO tile and their lse and di; K7: a K and a V tile)
    and 1 KB of alignment slack. From D = 384 up (the sliced layouts)
    nothing is loaded once: a ring of D-chunk stages (a 64-column box of
    every operand of the products reduced over D: K6 K, V of 128 keys and
    Q, dO of 32 queries; K7 Q, dO of 128 queries and K, V of 64 keys) and
    one of two slice stages (K6 Q and dO of a query tile's ``SLICE``
    columns, its lse and di; K7 K of a key tile's). With ``parts`` also the
    stage count (of the D-chunk ring where sliced)."""
    if d > BWD_TUNED_MAX:
        if which == "dkv":
            chunk = 2 * 128 * 128 + 2 * 32 * 128
            stages, sl = 4, 2 * 32 * SLICE * 2 + 2 * 32 * 4
        else:
            chunk = 2 * 128 * 128 + 2 * 64 * 128
            stages, sl = 3, 64 * SLICE * 2
        total = stages * chunk + 2 * sl + 1024
        return (total, stages) if parts else total
    if which == "dkv":
        once = 2 * bwd_tile_rows(d, which) * d * 2
        once += 64 * 64 * 4 if d == 256 else 0
        bq = bwd_stream_rows(d, which)
        stage = 2 * bq * d * 2 + 2 * bq * 4
    else:
        once = 4 * 64 * d * 2
        stage = 2 * bwd_stream_rows(d, which) * d * 2
    stages = min(3, (SMEM_MAX - 1024 - 256 - once) // stage)
    total = once + stages * stage + 1024
    return (total, stages) if parts else total


def bwd_launch_grid(b: int, tq: int, tk: int, h: int, d: int,
                    which: str) -> Tuple[int, int, int]:
    """K6's (``which="dkv"``) or K7's (``"dq"``) 1-D grid: (key or query
    tiles of ``bwd_tile_rows`` rows, head x column-slice slots, total
    blocks); up to D = 256 no CTA splits the output columns, from 384 up
    each owns a ``SLICE``. ``grid_decode`` reads a block index of either."""
    tiles = -(-(tk if which == "dkv" else tq) // bwd_tile_rows(d, which))
    hc = h * col_slices(d, which)
    return tiles, hc, tiles * hc * b


def bwd_tiles(tq: int, tk: int, d: int, which: str, causal: bool):
    """The tiles one (batch, head) of K6 or K7 computes, in launch order,
    as the source walks them: rows of (CTA, q_lo, q_hi, k_lo, k_hi, masked)
    for each 64-row group of a CTA (a warpgroup's, or at K6's D = 256 the
    pair's) and each tile it computes; ``masked`` where the source masks
    elementwise (causal crossings, keys past Tk). Tiles a warpgroup waits
    for and releases without computing are not listed. An int64 numpy
    array (the CPU tests check its coverage)."""
    rows = []
    if which == "dkv":
        bk, bq = bwd_tile_rows(d, which), bwd_stream_rows(d, which)
        for kt in range(-(-tk // bk)):
            k0 = kt * bk
            qi0 = k0 // bq if causal else 0
            for kf in range(k0, k0 + bk, 64):
                for qi in range(qi0, tq // bq):
                    qs = qi * bq
                    masked = (causal and qs < kf + 63) or kf + 64 > tk
                    rows.append((kt, qs, qs + bq, kf, kf + 64, masked))
    else:
        bm, bn = bwd_tile_rows(d, which), bwd_stream_rows(d, which)
        m_tiles = -(-tq // bm)
        for raw in range(m_tiles):
            mt = m_tiles - 1 - raw if causal else raw
            q0 = mt * bm
            n_tiles = -(-tk // bn)
            if causal:
                n_tiles = min(n_tiles, -(-(q0 + bm) // bn))
            for rf in range(q0, q0 + bm, 64):
                n_comp = min(n_tiles, (rf + 63) // bn + 1) if causal \
                    else n_tiles
                for j in range(n_comp):
                    n0 = j * bn
                    masked = n0 + bn > tk or (causal and n0 + bn - 1 > rf)
                    rows.append((raw, rf, rf + 64, n0, n0 + bn, masked))
    return np.asarray(rows, dtype=np.int64).reshape(-1, 6)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, q_offset: int = 0,
                          k_offset: int = 0, return_lse: bool = False):
    """Reference attention, q: [B, Tq, H, D], k/v: [B, Tk, H, D] ->
    [B, Tq, H, D] in v's dtype. ``*_offset`` are global positions of the
    first query and key for causal masking of shards; a query that sees no
    key gets zeros. With ``return_lse`` also each row's log-sum-exp
    ln sum_j exp(q.k_j / sqrt(D)), f32 [B, H, Tq] (-inf for a row that sees
    no key), from scores taken as K5 and the backward take them: q.k in
    f32, scaled in f32 (the output's scores scale k in bf16 first, which
    differs where 1/sqrt(D) is not a power of 2)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    # v.dtype.type(scale) * k: the scale and the product round to k's dtype
    ks = k * torch.tensor(1.0 / math.sqrt(d), dtype=v.dtype)
    mask = None
    if causal:
        qpos = torch.arange(tq, device=q.device) + q_offset
        kpos = torch.arange(tk, device=q.device) + k_offset
        mask = kpos[None, :] > qpos[:, None]
    step = max(1, _PLAIN_CHUNK_ELEMENTS // max(1, h * tq * tk))
    out, lses = [], []
    for lo in range(0, b, step):
        qc, kc, vc = q[lo:lo + step], ks[lo:lo + step], v[lo:lo + step]
        s = torch.einsum("bqhd,bkhd->bhqk", qc.to(acc), kc.to(acc))
        if mask is not None:
            s = s.masked_fill(mask, -math.inf)
        m = s.amax(dim=-1, keepdim=True)
        safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(torch.where(torch.isfinite(s), s - safe_m,
                                  torch.full_like(s, -math.inf)))
        denom = p.sum(dim=-1, keepdim=True)
        p = p / torch.where(denom == 0.0, torch.ones_like(denom), denom)
        if return_lse:
            s = torch.einsum("bqhd,bkhd->bhqk", qc.to(acc),
                             k[lo:lo + step].to(acc)) * (1.0 / math.sqrt(d))
            if mask is not None:
                s = s.masked_fill(mask, -math.inf)
            lses.append(torch.logsumexp(s, dim=-1))
            del s
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(acc),
                         vc.to(acc))
        out.append(o.to(v.dtype))
    o = torch.cat(out, dim=0) if len(out) > 1 else out[0]
    if return_lse:
        return o, torch.cat(lses, dim=0) if len(lses) > 1 else lses[0]
    return o


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = False):
    """The backward of attention from the forward's output ``o`` and row
    log-sum-exp ``lse`` ([B, H, Tq]): (dq, dk, dv) in q's, k's and v's
    dtypes. The library's formula with K6's and K7's rounding steps: the
    scores q.k in f32 scaled by 1/sqrt(D) in f32, P = exp(s - lse) (0 where
    causal masking hides the key), dV = bf16(P)^T dO, dP = dO V^T,
    dS = (dP - di) P / sqrt(D) with di = rowsum(O dO) in f32, dK =
    bf16(dS)^T Q, dQ = bf16(dS) K, every sum f32 (f64 for f64 inputs); over
    chunks of the batch as the forward."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / math.sqrt(d)
    mask = None
    if causal:
        mask = torch.ones(tq, tk, dtype=torch.bool, device=q.device).triu(1)
    di = (o.to(acc) * do.to(acc)).sum(-1).transpose(1, 2)   # [B, H, Tq]
    step = max(1, _PLAIN_CHUNK_ELEMENTS // max(1, h * tq * tk))
    grads = []
    for lo in range(0, b, step):
        sl = slice(lo, lo + step)
        qc, kc, vc, dc = (x[sl].to(acc) for x in (q, k, v, do))
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kc) * scale
        p = torch.exp(s - lse[sl].to(acc)[..., None])
        del s
        if mask is not None:
            p = p.masked_fill(mask, 0.0)
        dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).to(acc), dc)
        dp = torch.einsum("bqhd,bkhd->bhqk", dc, vc)
        ds = ((dp - di[sl].to(acc)[..., None]) * p * scale).to(q.dtype).to(acc)
        del dp, p
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, kc)
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, qc)
        grads.append((dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)))
    if len(grads) == 1:
        return grads[0]
    return tuple(torch.cat(g, dim=0) for g in zip(*grads))


def _layout_ok(x: torch.Tensor) -> bool:
    """The kernels read a contiguous last dim and 16-byte aligned rows (K5's
    TMA tensor maps take positive strides of 16 bytes)."""
    return x.stride(3) == 1 and all(s % 8 == 0 and s > 0
                                    for s in x.stride()[:3]) \
        and x.data_ptr() % 16 == 0


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, *more: Tuple[str, torch.Tensor]) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)) + more:
        if x.dtype != torch.bfloat16 or x.dim() != 4:
            raise TypeError(f"{name} must be bf16 [B, T, H, D], got {x.dtype} "
                            f"{tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not _layout_ok(x):
            raise ValueError(f"{name} needs a contiguous last dim and 16-byte "
                             f"aligned rows, got strides {x.stride()}")
    b, tq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    tk = k.shape[1]
    if not head_dim_ok(d):
        raise ValueError(f"head dim {d} is neither 64 nor a multiple of 128")
    if tq % TILE or tk % TILE or tk == 0:
        raise ValueError(f"Tq={tq} and Tk={tk} must be positive multiples "
                         f"of {TILE}")
    if causal and tq != tk:
        raise ValueError(f"causal masking needs Tq == Tk, got {tq}, {tk}")
    blocks = launch_grid(b, tq, h, d)[2]
    if blocks > MAX_GRID_BLOCKS:
        raise ValueError(f"B={b}, Tq={tq}, H={h} needs {blocks} CTAs, more "
                         f"than a grid takes ({MAX_GRID_BLOCKS})")


def _fn():
    fn = _kernels.lib("flash_attn").mmlspark_flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    fn = _kernels.lib("flash_attn_bwd").mmlspark_flash_attn_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def attention_cost(b: int, tq: int, tk: int, h: int, d: int,
                   causal: bool) -> tuple:
    """(flops, bytes) of one attention: 4 * B * H * Tq * Tk * D flops for
    the two products, halved under causal masking, and each bf16 element of
    q, k, v and o moved once (``chip_smoke.py``'s K5 operations bound)."""
    flops = 4.0 * b * h * tq * tk * d / (2 if causal else 1)
    return flops, float(2 * b * h * d * (2 * tq + 2 * tk))


def bwd_cost(b: int, tq: int, tk: int, h: int, d: int, causal: bool,
             which: str) -> tuple:
    """(flops, bytes) of K6 (``which="dkv"``: 8 * B * H * Tq * Tk * D flops
    for its four products) or K7 (``"dq"``: 6 * ..., three), halved under
    causal masking; bytes: q, k, v and dO (bf16), lse and di (f32) read
    once, dK and dV or dQ (bf16) written once."""
    n_prod = 4 if which == "dkv" else 3
    flops = 2.0 * n_prod * b * h * tq * tk * d / (2 if causal else 1)
    reads = 2 * b * h * d * (2 * tq + 2 * tk) + 8 * b * h * tq
    writes = 2 * b * h * d * (2 * tk if which == "dkv" else tq)
    return flops, float(reads + writes)


def _requires_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False, lse: bool = False):
    """Launch K5 on PyTorch's current stream; returns bf16 [B, Tq, H, D],
    with ``lse`` also the rows' log-sum-exp, f32 [B, H, Tq]. Raises while
    grad is enabled and an input requires grad: the output would carry no
    gradient (``FlashAttention`` is the differentiable route)."""
    if _requires_grad(q, k, v):
        raise RuntimeError(
            "flash_attention_cuda would detach q/k/v from autograd: use "
            "FlashAttention.apply (or attention.dense_attention) while grad "
            "is enabled")
    _check_inputs(q, k, v, causal)
    b, tq, h, d = q.shape
    o = torch.empty((b, tq, h, d), dtype=torch.bfloat16, device=q.device)
    row_lse = (torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
               if lse else None)
    strides = (ctypes.c_int64 * 12)(*[s for x in (q, k, v, o)
                                      for s in x.stride()[:3]])
    code = _fn()(_kernels.ptr(q), _kernels.ptr(k), _kernels.ptr(v),
                 _kernels.ptr(o),
                 None if row_lse is None else _kernels.ptr(row_lse),
                 b, h, tq, k.shape[1], d, int(bool(causal)),
                 ctypes.cast(strides, ctypes.c_void_p), 1.0 / math.sqrt(d),
                 _kernels.stream_ptr(q.device))
    graphs.note_launch(__name__, "launches")
    _kernels.check(code, "flash_attn kernel launch")
    _perf.note_kernel_cost(*attention_cost(b, tq, k.shape[1], h, d, causal))
    return (o, row_lse) if lse else o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """bf16 attention [B, T, H, D] -> [B, Tq, H, D]: the kernel for CUDA
    tensors (there is no fallback), the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    raise ValueError(f"no flash attention for device {q.device}")


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             causal: bool = False):
    """Launch K6 (dK, dV) then K7 (dQ) on PyTorch's current stream; returns
    bf16 (dq, dk, dv), contiguous [B, T, H, D]. ``di = rowsum(O dO)`` is a
    torch reduction, as the library's ``jnp.sum``."""
    _check_inputs(q, k, v, causal, ("o", o), ("do", do))
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if tuple(do.shape) != tuple(o.shape) or tuple(o.shape) != tuple(q.shape):
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, tq) \
            or lse.device != q.device:
        raise ValueError(f"lse must be f32 [B, H, Tq] = {(b, h, tq)} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")
    for which in ("dkv", "dq"):
        blocks = bwd_launch_grid(b, tq, tk, h, d, which)[2]
        if blocks > MAX_GRID_BLOCKS:
            raise ValueError(f"B={b}, T={max(tq, tk)}, H={h} needs {blocks} "
                             f"CTAs, more than a grid takes")
    lse = lse.contiguous()
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dq = torch.empty((b, tq, h, d), dtype=torch.bfloat16, device=q.device)
    dk = torch.empty((b, tk, h, d), dtype=torch.bfloat16, device=q.device)
    dv = torch.empty_like(dk)
    for which in ("dkv", "dq"):
        launch_bwd(which, q, k, v, do, lse, di, dq, dk, dv, causal)
    return dq, dk, dv


def launch_bwd(which: str, q, k, v, do, lse, di, dq, dk, dv,
               causal: bool) -> None:
    """One launch of K6 (``which="dkv"``, writes dk and dv) or K7
    (``"dq"``, writes dq) on checked inputs (``flash_attention_bwd_cuda``
    checks them and computes ``di``), counted and costed."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    strides = (ctypes.c_int64 * 21)(*[s for x in (q, k, v, do, dq, dk, dv)
                                      for s in x.stride()[:3]])
    code = _bwd_fn()(*[_kernels.ptr(x) for x in (q, k, v, do, lse, di, dq,
                                                 dk, dv)],
                     b, h, tq, tk, d, int(bool(causal)),
                     ctypes.cast(strides, ctypes.c_void_p), 1.0 / math.sqrt(d),
                     0 if which == "dkv" else 1, _kernels.stream_ptr(q.device))
    counter = f"bwd_{which}_launches"
    graphs.note_launch(__name__, counter)
    _kernels.check(code, f"flash_attn_bwd kernel launch ({counter})")
    _perf.note_kernel_cost(*bwd_cost(b, tq, tk, h, d, causal, which))


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False):
    """(dq, dk, dv): K6 and K7 for CUDA tensors (there is no fallback), the
    plain backward for CPU tensors."""
    if q.device.type == "cuda":
        if not _layout_ok(do):
            do = do.contiguous()
        return flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    raise ValueError(f"no flash attention backward for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """Differentiable bf16 attention [B, T, H, D] through the kernels: the
    forward is K5 with the rows' log-sum-exp, saving q, k, v, o and lse;
    the backward is K6 then K7. On CPU tensors (tests only) the plain
    forward and backward. ``FlashAttention.apply(q, k, v, causal)``. Once
    differentiable, as the library's VJP ("Higher-order AD not
    supported")."""

    @staticmethod
    def forward(ctx, q, k, v, causal=False):
        if q.device.type == "cuda":
            o, lse = flash_attention_cuda(q, k, v, causal, lse=True)
        elif q.device.type == "cpu":
            o, lse = flash_attention_plain(q, k, v, causal, return_lse=True)
        else:
            raise ValueError(f"no flash attention for device {q.device}")
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None
