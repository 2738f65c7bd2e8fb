"""K2: the tier row-select kernel (``csrc/select.cu``) and its plain version.

Replaces the TPU kernel ``mmlspark_tpu/gbdt/pallas_select.py:_select_kernel``
(``select_rows``): a stable compaction of the masked rows of feature-major
bins, grad and hess into ``cap``-wide buffers, zero past the count,
bit-exact. The TPU kernel reformulates it as one-hot MXU contractions; on
Hopper it is two launches: per-block counts of the mask, then per block a
ballot compaction of its selected row indices into shared memory, copies
by the whole block from that list into the [F, cap] outputs, and the
block's share of the zero tail (see the source). The outputs are allocated
empty: the kernel writes every element once.

Bound on the H100: bytes — the mask and the selected rows' bins, grad and
hess read once, the [F + 2, cap] outputs written once: ~61 us at N = 2M,
F = 28, 30% of the rows selected and cap = 1M, against 3.35 TB/s.

``select_rows`` is the wrapper: a CPU tensor takes ``select_rows_plain``, a
CUDA tensor launches the kernel (there is no fallback), anything else
raises. ``launches`` counts kernel launches (one per wrapper call; the
call runs the ``LAUNCHES_PER_CALL`` CUDA launches of one compaction).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _kernels
from ..core import graphs

#: kernel launches since the counter was last set to 0 (graph replays too)
launches = 0
graphs.count_replays(__name__, "launches")

#: CUDA launches in one compaction: the count kernel and the scatter kernel
LAUNCHES_PER_CALL = 2
#: rows per chunk of the scatter kernel, and the most row blocks it takes
#: (each block sums the counts of the blocks before it)
CHUNK_ROWS = 2048
MAX_BLOCKS = 1024

#: mask width from which the grower compacts through the kernel — the
#: reference's ``use_select`` gate (pallas_select.py), kept until a
#: measurement on the card re-derives it
MIN_ROWS = 500_000


def use_select(n_rows: int) -> bool:
    """Dispatch gate for the grower: compact through K2 when the mask is at
    least ``MIN_ROWS`` rows wide."""
    return n_rows >= MIN_ROWS


def select_rows_plain(bins_fm: torch.Tensor, grad: torch.Tensor,
                      hess: torch.Tensor, mask: torch.Tensor,
                      cap: int) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``nonzero`` + ``index_select`` into zeroed ``cap``-wide buffers."""
    f = bins_fm.shape[0]
    dev = bins_fm.device
    idx = torch.nonzero(mask).flatten()[:cap]
    k = idx.numel()
    bins_c = torch.zeros(f, cap, dtype=torch.int32, device=dev)
    grad_c = torch.zeros(cap, dtype=torch.float32, device=dev)
    hess_c = torch.zeros(cap, dtype=torch.float32, device=dev)
    bins_c[:, :k] = bins_fm.index_select(1, idx).to(torch.int32)
    grad_c[:k] = grad.index_select(0, idx)
    hess_c[:k] = hess.index_select(0, idx)
    return bins_c, grad_c, hess_c


def _check_inputs(bins_fm, grad, hess, mask) -> None:
    if bins_fm.dim() != 2 or bins_fm.dtype != torch.int32:
        raise TypeError(f"bins must be int32 [F, N], got {bins_fm.dtype} "
                        f"{tuple(bins_fm.shape)}")
    n = bins_fm.shape[1]
    if n >= 1 << 31:
        raise ValueError("select kernel takes fewer than 2^31 rows")
    for name, t, dt in (("grad", grad, torch.float32),
                        ("hess", hess, torch.float32),
                        ("mask", mask, torch.bool)):
        if t.dtype != dt or tuple(t.shape) != (n,):
            raise TypeError(f"{name} must be {dt} [{n}], got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != bins_fm.device:
            raise ValueError(f"{name} is on {t.device}, bins on "
                             f"{bins_fm.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not bins_fm.is_contiguous():
        raise ValueError("bins must be contiguous")


def row_blocks(n: int) -> Tuple[int, int]:
    """(rows per block, blocks) of the kernel's grid for ``n`` rows: whole
    chunks of ``CHUNK_ROWS``, at most ``MAX_BLOCKS`` blocks, at least one
    (it writes the zero outputs of an empty mask too)."""
    chunks = max(1, -(-n // CHUNK_ROWS))
    per = -(-chunks // MAX_BLOCKS)
    return per * CHUNK_ROWS, -(-chunks // per)


def _fn():
    fn = _kernels.lib("select").mmlspark_select
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def select_rows_cuda(bins_fm: torch.Tensor, grad: torch.Tensor,
                     hess: torch.Tensor, mask: torch.Tensor,
                     cap: int) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch K2 on PyTorch's current stream."""
    _check_inputs(bins_fm, grad, hess, mask)
    f, n = bins_fm.shape
    dev = bins_fm.device
    rows_per_block, n_blocks = row_blocks(n)
    counts = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    bins_c = torch.empty(f, cap, dtype=torch.int32, device=dev)
    grad_c = torch.empty(cap, dtype=torch.float32, device=dev)
    hess_c = torch.empty(cap, dtype=torch.float32, device=dev)
    p = _kernels.ptr
    code = _fn()(
        p(bins_fm), p(grad), p(hess), p(mask), p(counts), p(bins_c),
        p(grad_c), p(hess_c), n, f, cap, rows_per_block, n_blocks,
        _kernels.stream_ptr(dev))
    graphs.note_launch(__name__, "launches")
    _kernels.check(code, "select kernel launch")
    return bins_c, grad_c, hess_c


def select_rows(bins_fm: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                mask: torch.Tensor, cap: int) -> Tuple[torch.Tensor,
                                                       torch.Tensor,
                                                       torch.Tensor]:
    """Compact the masked rows to the front of ``cap``-wide buffers (rows
    past the count are zero; the caller guarantees ``mask.sum() <= cap``).
    Returns (bins_c [F, cap] int32, grad_c [cap] f32, hess_c [cap] f32)."""
    if bins_fm.device.type == "cuda":
        return select_rows_cuda(bins_fm, grad, hess, mask, cap)
    if bins_fm.device.type == "cpu":
        return select_rows_plain(bins_fm, grad, hess, mask, cap)
    raise ValueError(f"no row select for device {bins_fm.device}")
