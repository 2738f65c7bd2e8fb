"""K1: the GBDT histogram kernel (``csrc/hist.cu``) and its plain version.

Replaces the TPU kernel ``mmlspark_tpu/gbdt/pallas_hist.py:_hist_kernel``
(``compute_histogram_mxu``). The TPU kernel defaults to a bf16 hi/lo split
of grad/hess so one bf16 MXU pass carries the f32 values; that is a trick
for the MXU and has nothing to do on Hopper, so K1 computes the f32
histogram the reference computes under ``MMLSPARK_TPU_HIST_EXACT=1``.
Both K1 and its plain version accumulate in f64 and round each cell to f32
once: the result does not depend on the order rows are added in, so the
card and the CPU build the same histograms, and a small child derived by
subtraction from a parent over millions of rows keeps its own sums (f32
accumulation loses them at that scale).

Bound on the H100: bytes. The kernel must read the selected rows' bins
(4*F bytes each), grad and hess (8 bytes each) and the mask (1 byte per
row), and write 12*F*B bytes: ~38 us at 1M selected of N = 2M rows, F = 28
against 3.35 TB/s. The Hopper design keeps each block's whole feature
group in up to 227 KB of shared memory (f64 grad/hess, u32 counts), warps
take (feature, 128-row) units with 16-byte loads, lanes that share a bin
add once where a unit's bins repeat (``__match_any_sync``), and each block
writes an f64 partial that a second launch sums in block order into the
f32 output: ``LAUNCHES_PER_CALL`` launches, no memset, no global atomics.
The f64 shared-memory adds (compare-and-swap loops on this card) and their
bank conflicts bound it, not HBM. The grid is sized here, in
``launch_geometry``; see the source for the rest.

``histogram`` is the wrapper: a CPU tensor takes ``histogram_plain``, a CUDA
tensor launches the kernel (there is no fallback), anything else raises.
``launches`` counts kernel launches (one per wrapper call; the call runs
the ``LAUNCHES_PER_CALL`` CUDA launches of one histogram).

``histogram_count`` is the device-count entry, for the device-resident
grower: rows [0, count) of a compacted buffer with ``count`` a 0-dim int32
tensor on the device, read by the kernel, and no mask. Its grid is sized
for the buffer (``count_tiers``: K1's geometry for each tier width, widest
first); each block groups rows as a launch sized for the narrowest tier
that holds the count would, and blocks past the count return at once.
``count_launches`` counts its launches. Both counters count launches made
by replaying a captured CUDA graph too (``core/graphs.py``).

Every entry takes ``f64=True`` for the same sums before their one rounding,
as f64 ``[F, num_bins, 3]``: a sharded fit adds the shards' f64 histograms
across processes and rounds the total once, so it builds the histogram a
single process builds over all the rows (up to a double-rounding tie). The
kernel's reduction launch then writes f64 (24 bytes a cell, not 12); the
block partials and the order they are summed in are the same.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import _kernels
from ..core import graphs

#: kernel launches since the counter was last set to 0 (the mask entry)
launches = 0
#: launches of the device-count entry since the counter was last set to 0
count_launches = 0
graphs.count_replays(__name__, "launches", "count_launches")
#: the most tier widths one device-count launch chooses among
MAX_TIERS = 8

#: CUDA launches in one call on the shared-memory path: the block partials
#: and their reduction (the global path adds a memset)
LAUNCHES_PER_CALL = 2
#: threads of a block, and rows of a warp's unit (4 a lane)
THREADS = 1024
UNIT_ROWS = 128
#: dynamic shared memory a block may opt into on the H100 (227 KB), and
#: what one SM holds for its blocks (228 KB, 1 KB reserved a block)
SMEM_BLOCK_MAX = 232_448
SMEM_SM = 233_472
#: bytes of one (feature, bin) cell: f64 grad, f64 hess, u32 count
CELL_BYTES = 20
#: the aggregating warps' staging of their lanes' (grad, hess), 8 B a lane
AGG_BYTES = THREADS * 8
#: SMs of the H100 SXM, and units a warp takes at least before the rows are
#: split over another block
SMS = 132
UNITS_PER_WARP = 4


@dataclasses.dataclass(frozen=True)
class Geometry:
    """K1's launch: ``row_blocks`` x ``groups`` blocks of ``THREADS``, each
    ``rows_per_block`` rows (a multiple of 4) and ``feat_per_block``
    features with ``smem_bytes`` of dynamic shared memory; ``scratch`` f64
    values of block partials. ``feat_per_block == 0``: the global path
    (one feature's histogram does not fit a block), ``row_blocks`` blocks
    of 256 threads adding into ``scratch`` = F * B * 3 doubles."""

    feat_per_block: int
    groups: int
    row_blocks: int
    rows_per_block: int
    smem_bytes: int
    scratch: int


def launch_geometry(n: int, f: int, b: int) -> Geometry:
    """Size K1's grid for ``n`` rows, ``f`` features and ``b`` bins: as many
    features a block as fit its shared memory (balanced over the groups),
    and the rows split over enough blocks to fill the card (``SMS`` times
    the blocks an SM holds, over the groups) while every warp keeps
    ``UNITS_PER_WARP`` units of work."""
    cells = f * b * 3
    fit = (SMEM_BLOCK_MAX - AGG_BYTES) // (b * CELL_BYTES)
    if fit < 1:
        blocks = max(1, min(-(-n // 256), SMS * 8))
        rows = (-(-max(n, 1) // blocks) + 3) // 4 * 4
        return Geometry(0, 1, -(-max(n, 1) // rows), rows, 0, cells)
    groups = -(-f // min(fit, f))
    fpb = -(-f // groups)
    smem = (fpb * b * CELL_BYTES + 15) // 16 * 16 + AGG_BYTES
    per_sm = max(1, min(2048 // THREADS, SMEM_SM // (smem + 1024)))
    units = -(-max(n, 1) // UNIT_ROWS) * fpb
    want = -(-units // (THREADS // 32 * UNITS_PER_WARP))
    row_blocks = max(1, min(-(-SMS * per_sm // groups), want))
    rows = (-(-max(n, 1) // row_blocks) + 3) // 4 * 4
    row_blocks = -(-max(n, 1) // rows)
    return Geometry(fpb, groups, row_blocks, rows, smem, row_blocks * cells)


def histogram_plain(bins_fm: torch.Tensor, grad: torch.Tensor,
                    hess: torch.Tensor, row_mask: torch.Tensor,
                    num_bins: int, f64: bool = False) -> torch.Tensor:
    """[F, N] int bins + [N] grad/hess/mask -> [F, num_bins, 3] f32 sums of
    (grad * m, hess * m, m). The counterpart of the reference's
    ``histogram.compute_histogram_xla``: one ``index_add_`` per feature,
    accumulated in f64 and rounded to f32 once, so every cell is the f32
    rounding of its exact sum whatever order the rows are added in
    (``f64``: the sums before that rounding)."""
    f, n = bins_fm.shape
    dev = bins_fm.device
    m = row_mask.to(torch.float32)
    vals = torch.stack([grad * m, hess * m, m], dim=1).reshape(-1).double()
    chan = torch.arange(3, device=dev)
    hist = torch.zeros(f, num_bins * 3, dtype=torch.float64, device=dev)
    for fi in range(f):
        idx = (bins_fm[fi].to(torch.int64)[:, None] * 3 + chan).reshape(-1)
        hist[fi].index_add_(0, idx, vals)
    hist = hist.view(f, num_bins, 3)
    return hist if f64 else hist.float()


def _check_inputs(bins_fm, grad, hess, row_mask=None) -> None:
    if bins_fm.dim() != 2 or bins_fm.dtype != torch.int32:
        raise TypeError(f"bins must be int32 [F, N], got {bins_fm.dtype} "
                        f"{tuple(bins_fm.shape)}")
    n = bins_fm.shape[1]
    checks = [("grad", grad, torch.float32), ("hess", hess, torch.float32)]
    if row_mask is not None:
        checks.append(("mask", row_mask, torch.bool))
    for name, t, dt in checks:
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


def _fn():
    fn = _kernels.lib("hist").mmlspark_hist
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _out_dtype(f64: bool) -> torch.dtype:
    return torch.float64 if f64 else torch.float32


def histogram_cuda(bins_fm: torch.Tensor, grad: torch.Tensor,
                   hess: torch.Tensor, row_mask: torch.Tensor,
                   num_bins: int, f64: bool = False) -> torch.Tensor:
    """Launch K1 on PyTorch's current stream; returns [F, num_bins, 3]
    (f64 sums with ``f64``)."""
    _check_inputs(bins_fm, grad, hess, row_mask)
    f, n = bins_fm.shape
    dev = bins_fm.device
    out = torch.empty(f, num_bins, 3, dtype=_out_dtype(f64), device=dev)
    if n == 0:
        return out.zero_()
    geo = launch_geometry(n, f, num_bins)
    scratch = torch.empty(geo.scratch, dtype=torch.float64, device=dev)
    p = _kernels.ptr
    code = _fn()(p(bins_fm), p(grad), p(hess), p(row_mask), p(out),
                 p(scratch), n, f, num_bins, geo.feat_per_block,
                 geo.row_blocks, geo.rows_per_block, geo.smem_bytes,
                 int(f64), _kernels.stream_ptr(dev))
    graphs.note_launch(__name__, "launches")
    _kernels.check(code, "hist kernel launch")
    return out


class CountTiers(ctypes.Structure):
    """The device-count entry's geometry table (``CountTiers`` in the
    source): widths widest first, K1's grid for each."""

    _fields_ = [("n", ctypes.c_int32),
                ("row_blocks", ctypes.c_int32 * MAX_TIERS),
                ("width", ctypes.c_int64 * MAX_TIERS),
                ("rows_per_block", ctypes.c_int64 * MAX_TIERS)]


def count_tiers(n: int, f: int, b: int, caps=()) -> list:
    """(width, Geometry) for the buffer width ``n`` and each narrower tier
    width of ``caps``, widest first: the grouping a count's launch takes is
    that of the narrowest width that holds it."""
    widths = [n] + sorted({int(c) for c in caps if 0 < c < n}, reverse=True)
    if len(widths) > MAX_TIERS:
        raise ValueError(f"at most {MAX_TIERS} tier widths, got {widths}")
    return [(w, launch_geometry(w, f, b)) for w in widths]


def histogram_count_plain(bins_fm: torch.Tensor, grad: torch.Tensor,
                          hess: torch.Tensor, count: torch.Tensor,
                          num_bins: int, f64: bool = False) -> torch.Tensor:
    """The device-count entry's plain version: the rows before ``count``
    (a 0-dim or [1] integer tensor) as the row mask of ``histogram_plain``."""
    n = bins_fm.shape[1]
    valid = torch.arange(n, device=bins_fm.device) < count.reshape(())
    return histogram_plain(bins_fm, grad, hess, valid, num_bins, f64)


def _count_fn():
    fn = _kernels.lib("hist").mmlspark_hist_count
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, CountTiers, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def histogram_count_cuda(bins_fm: torch.Tensor, grad: torch.Tensor,
                         hess: torch.Tensor, count: torch.Tensor,
                         num_bins: int, caps=(), f64: bool = False
                         ) -> torch.Tensor:
    """Launch K1's device-count entry on PyTorch's current stream: the rows
    before the int32 ``count`` (on the device, never read here) of the
    compacted [F, n] buffer; ``caps``: the tier widths the rows are grouped
    by. Returns [F, num_bins, 3] (f64 sums with ``f64``)."""
    f, n = bins_fm.shape
    dev = bins_fm.device
    _check_inputs(bins_fm, grad, hess)
    if count.dtype != torch.int32 or count.numel() != 1 \
            or count.device != dev:
        raise TypeError(f"count must be one int32 on {dev}, got "
                        f"{count.dtype} {tuple(count.shape)} on "
                        f"{count.device}")
    out = torch.empty(f, num_bins, 3, dtype=_out_dtype(f64), device=dev)
    if n == 0:
        return out.zero_()
    tiers = count_tiers(n, f, num_bins, caps)
    geo = tiers[0][1]
    table = CountTiers()
    table.n = len(tiers)
    for i, (w, g) in enumerate(tiers):
        table.width[i], table.row_blocks[i] = w, g.row_blocks
        table.rows_per_block[i] = g.rows_per_block
    scratch = torch.empty(max(g.scratch for _, g in tiers),
                          dtype=torch.float64, device=dev)
    p = _kernels.ptr
    code = _count_fn()(p(bins_fm), p(grad), p(hess), p(count), p(out),
                       p(scratch), n, f, num_bins, geo.feat_per_block,
                       max(g.row_blocks for _, g in tiers), geo.smem_bytes,
                       table, int(f64), _kernels.stream_ptr(dev))
    graphs.note_launch(__name__, "count_launches")
    _kernels.check(code, "hist kernel (device count) launch")
    return out


def histogram_count(bins_fm: torch.Tensor, grad: torch.Tensor,
                    hess: torch.Tensor, count: torch.Tensor, num_bins: int,
                    caps=(), f64: bool = False) -> torch.Tensor:
    """[F, n] compacted bins -> [F, num_bins, 3] sums of the rows before the
    device-held ``count``: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if bins_fm.device.type == "cuda":
        return histogram_count_cuda(bins_fm, grad, hess, count, num_bins,
                                    caps, f64=f64)
    if bins_fm.device.type == "cpu":
        return histogram_count_plain(bins_fm, grad, hess, count, num_bins,
                                     f64=f64)
    raise ValueError(f"no histogram for device {bins_fm.device}")


def histogram(bins_fm: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              row_mask: torch.Tensor, num_bins: int, f64: bool = False
              ) -> torch.Tensor:
    """[F, N] bins -> [F, num_bins, 3] masked (grad, hess, count) sums: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if bins_fm.device.type == "cuda":
        return histogram_cuda(bins_fm, grad, hess, row_mask, num_bins,
                              f64=f64)
    if bins_fm.device.type == "cpu":
        return histogram_plain(bins_fm, grad, hess, row_mask, num_bins,
                               f64=f64)
    raise ValueError(f"no histogram for device {bins_fm.device}")
