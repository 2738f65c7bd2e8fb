"""K5: the flash-attention kernel (``csrc/flash_attn.cu``) and its plain version.

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
writes half the output columns). See the source for the design.

``flash_attention`` is the wrapper: a CUDA tensor launches the kernel
(there is no fallback: a build or launch failure propagates), a CPU tensor
takes the plain version, anything else raises. ``launches`` counts kernel
launches, through CUDA graph replays too (core/graphs.py: the fused
executor's mega dispatch replays captured launches), and each launch adds
its flops and bytes to an active cost tally (obs/perf.py), which cannot see
inside it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from .. import _kernels
from ..core import graphs
from ..obs import perf as _perf

#: kernel launches since the counter was last set to 0
launches = 0
graphs.count_replays(__name__, "launches")

#: head dims the kernel is built for
HEAD_DIMS = (64, 128, 256, 384, 512)
#: query and key lengths must be multiples of 64 (the Hopper kernel's
#: query tiles are 192 or 128 rows and its key tiles 128 or 64; a partial
#: last tile is masked)
TILE = 64
#: score elements per chunk of the plain version (2^28 f32 = 1 GiB)
_PLAIN_CHUNK_ELEMENTS = 1 << 28
#: the most blocks a 1-D CUDA grid takes
MAX_GRID_BLOCKS = (1 << 31) - 1


def launch_grid(b: int, tq: int, h: int, d: int) -> Tuple[int, int, int]:
    """K5's 1-D grid for a [B, Tq, H, D] query: (query blocks, head x
    column-split slots, total blocks). A CTA takes 192 query rows at D=64
    and 128 above (3 or 2 consumer warpgroups), and half the output columns
    at D=384 and 512 (``Sm90Cfg`` in the source)."""
    m_blocks = -(-tq // (192 if d == 64 else 128))
    hc = h * (2 if d > 256 else 1)
    return m_blocks, hc, m_blocks * hc * b


def grid_decode(block, m_blocks: int, hc: int):
    """Block index -> (batch, head x column-split slot, query block), query
    blocks fastest, as the kernel decodes ``blockIdx.x`` (works on ints and
    on numpy arrays)."""
    return block // (m_blocks * hc), (block // m_blocks) % hc, block % m_blocks


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, q_offset: int = 0,
                          k_offset: int = 0) -> torch.Tensor:
    """Reference attention, q: [B, Tq, H, D], k/v: [B, Tk, H, D] ->
    [B, Tq, H, D] in v's dtype. ``*_offset`` are global positions of the
    first query and key for causal masking of shards; a query that sees no
    key gets zeros."""
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
    out = []
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
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(acc),
                         vc.to(acc))
        out.append(o.to(v.dtype))
    return torch.cat(out, dim=0) if len(out) > 1 else out[0]


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16 or x.dim() != 4:
            raise TypeError(f"{name} must be bf16 [B, T, H, D], got {x.dtype} "
                            f"{tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        # the kernel's TMA tensor maps take positive strides of 16 bytes
        if x.stride(3) != 1 or any(s % 8 or s <= 0 for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last dim and 16-byte "
                             f"aligned rows, got strides {x.stride()}")
    b, tq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    tk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def attention_cost(b: int, tq: int, tk: int, h: int, d: int,
                   causal: bool) -> tuple:
    """(flops, bytes) of one attention: 4 * B * H * Tq * Tk * D flops for
    the two products, halved under causal masking, and each bf16 element of
    q, k, v and o moved once (``chip_smoke.py``'s K5 operations bound)."""
    flops = 4.0 * b * h * tq * tk * d / (2 if causal else 1)
    return flops, float(2 * b * h * d * (2 * tq + 2 * tk))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False) -> torch.Tensor:
    """Launch K5 on PyTorch's current stream; returns bf16 [B, Tq, H, D]."""
    _check_inputs(q, k, v, causal)
    b, tq, h, d = q.shape
    o = torch.empty((b, tq, h, d), dtype=torch.bfloat16, device=q.device)
    strides = (ctypes.c_int64 * 12)(*[s for x in (q, k, v, o)
                                      for s in x.stride()[:3]])
    code = _fn()(_kernels.ptr(q), _kernels.ptr(k), _kernels.ptr(v),
                 _kernels.ptr(o), b, h, tq, k.shape[1], d, int(bool(causal)),
                 ctypes.cast(strides, ctypes.c_void_p), 1.0 / math.sqrt(d),
                 _kernels.stream_ptr(q.device))
    graphs.note_launch(__name__, "launches")
    _kernels.check(code, "flash_attn kernel launch")
    _perf.note_kernel_cost(*attention_cost(b, tq, k.shape[1], h, d, causal))
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """bf16 attention [B, T, H, D] -> [B, Tq, H, D]: the kernel for CUDA
    tensors (there is no fallback), the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    raise ValueError(f"no flash attention for device {q.device}")
