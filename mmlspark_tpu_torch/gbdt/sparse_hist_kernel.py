"""K4: the flat sparse-histogram kernel (``csrc/sparse_hist.cu``) and its plain
version.

Replaces the TPU kernel ``mmlspark_tpu/gbdt/pallas_sparse.py:_sparse_hist_kernel``
(``sparse_histogram_mxu``, dispatched by ``flat_hist_dispatch``): the
sparse GBDT engine's nonzero-entry histogram, ``[3, nnz]`` masked (grad,
hess, count) stats in bin-sorted entry order -> ``[3, total_bins]`` sums
over the flat ragged bin space. The reference runs that kernel only under
its ``hist.csr`` variant and below 128k bins (a VMEM guard), and otherwise
takes differences of one f32 prefix sum over all entries, because the TPU
has no scatter. The port computes every flat histogram with K4.

The stream's valid length is ``bin_end[-1]``: the stats may be wider (a
static width, their row stride), as the scan's stream compacted to the
selected rows' entries is, whose length is known only on the device. K4
reads it there, and neither K4 nor its plain version reads or writes an
entry at or past it.

Both K4 and its plain version accumulate in f64 and round each cell to f32
once, so the card and the CPU build the same histogram (up to a
double-rounding tie) whatever order the entries are added in. That is also
more accurate than the reference's prefix differences: at 50M entries the
f32 prefix of the hessians passes 10^7, where one ulp is 1.

Bound on the H100: bytes. The function must read 12*nnz bytes of stats and
4*TB of bin offsets and write 12*TB: ~0.18 ms at 49.7M entries and 1.31M
bins against 3.35 TB/s (for a compacted stream: its valid entries). The
kernel is a merge-path segmented reduction: the path of the TB bin-end
markers merged with the valid entries is cut into as many equal shares as
the grid has persistent blocks (``shares`` of the width), so skewed bins and
runs of empty bins cost the same; each block sums its bins in f64 in a
fixed order and writes those it holds whole straight to the f32 output,
and a second launch adds up the bins that cross shares, in share order.
The result is bitwise the same from run to run. ``merge_path_search``,
``shares``, ``tile_end`` and ``partitioned_histogram`` are the kernel's
arithmetic in Python, for the tests; see the source for the rest.

``sparse_histogram`` is the wrapper: a CPU tensor takes
``sparse_histogram_plain``, a CUDA tensor launches the kernel (there is no
fallback), anything else raises. ``launches`` counts kernel launches (one
per wrapper call; the call runs the ``LAUNCHES_PER_CALL`` CUDA launches of
one histogram). Every entry takes ``f64=True`` for the sums before their one
rounding, as f64 ``[3, TB]`` (both of the kernel's writes of the output
then store f64): a sharded fit adds the shards' sums across processes and
rounds once.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..core import graphs

#: kernel launches since the counter was last set to 0 (graph replays too)
launches = 0
graphs.count_replays(__name__, "launches")

#: CUDA launches in one call: the shares and the carries across them
LAUNCHES_PER_CALL = 2
#: threads of a block, path items a thread takes in a tile, items a tile,
#: and the bin ends staged for a tile (it takes one fewer markers at most)
THREADS = 256
ITEMS_PER_THREAD = 23
TILE = THREADS * ITEMS_PER_THREAD
END_WINDOW = TILE // 8 + 2
#: SMs of the H100 SXM and persistent blocks on each
SMS = 132
BLOCKS_PER_SM = 3


def shares(nnz: int, tb: int) -> Tuple[int, int]:
    """(blocks, path items a block) of K4's grid for ``nnz`` entries and
    ``tb`` bins: at most ``SMS * BLOCKS_PER_SM`` blocks and at least one
    tile a block, the ``nnz + tb`` items of the path split evenly. The grid
    is sized for the stats' width; the kernel splits the path of the valid
    length over it (``share_of``), the same shares for a full stream."""
    total = nnz + tb
    blocks = max(1, min(SMS * BLOCKS_PER_SM, -(-total // TILE)))
    share = max(1, -(-total // blocks))
    return -(-total // share) if total else 1, share


def share_of(blocks: int, nnz: int, tb: int) -> int:
    """Path items a block of a ``blocks``-block grid takes for ``nnz`` valid
    entries: the kernel's own division, on the device."""
    return max(1, -(-(nnz + tb) // blocks))


def merge_path_search(bin_end, nnz: int, diag: int, ti: int = 0,
                      tj: int = 0, cap: Optional[int] = None) -> int:
    """Bin-end markers among the first ``diag`` items of the merge path that
    starts at (marker ``ti``, entry ``tj``), or ``cap`` if that many or
    more: marker b comes before entry j when ``bin_end[b] <= j``. The
    kernel's binary search, over a sequence of ints."""
    tb = len(bin_end)
    lo, hi = max(0, diag - (nnz - tj)), min(diag, tb - ti)
    if cap is not None:
        hi = min(hi, cap)
    while lo < hi:
        mid = (lo + hi) >> 1
        if bin_end[ti + mid] <= tj + diag - mid - 1:
            lo = mid + 1
        else:
            hi = mid
    return lo


def tile_end(bin_end, nnz: int, ti: int, tj: int, items: int
             ) -> Tuple[int, int]:
    """Where a tile that starts at (``ti``, ``tj``) with ``items`` path items
    left in its share ends: after ``TILE`` items, or right after its
    ``END_WINDOW - 1``-th marker (the last staged) if the path gets there
    first."""
    d = min(TILE, items)
    markers = END_WINDOW - 1
    x = merge_path_search(bin_end, nnz, d, ti, tj, cap=markers)
    if x >= markers and markers < min(d, len(bin_end) - ti):
        return ti + markers, bin_end[ti + markers - 1]
    return ti + x, tj + d - x


def partitioned_histogram(data, bin_end) -> Tuple[np.ndarray, list]:
    """K4's reduction, share by share, tile by tile and thread by thread
    (numpy, f64 runs, each bin rounded to f32 once) -> ([3, TB] f32, the
    share carries [(head bin or -1, tail bin)]). Sums take the same
    operands as the kernel; the scan across a tile's threads adds them in
    thread order, where the kernel adds them in a shuffle tree."""
    data = np.asarray(data, dtype=np.float32)
    bin_end = [int(v) for v in np.asarray(bin_end)]
    width, tb = data.shape[1], len(bin_end)
    nnz = min(width, max(bin_end[-1], 0)) if tb else width
    out = np.full((3, tb), np.nan, dtype=np.float32)
    n_shares, _ = shares(width, tb)
    share = share_of(n_shares, nnz, tb)
    heads, tails = [], []
    for p in range(n_shares):
        d0, d1 = min(p * share, nnz + tb), min((p + 1) * share, nnz + tb)
        i0 = merge_path_search(bin_end, nnz, d0)
        ti, tj = i0, d0 - i0
        carry = np.zeros(3)
        head = None
        dt = d0
        while dt < d1:
            nti, ntj = tile_end(bin_end, nnz, ti, tj, d1 - dt)
            n_items = nti - ti + ntj - tj
            for t in range(THREADS):
                a = min(n_items, t * ITEMS_PER_THREAD)
                b = min(n_items, a + ITEMS_PER_THREAD)
                x = merge_path_search(bin_end, nnz, a, ti, tj)
                i, j = ti + x, tj + a - x
                run, cut = np.zeros(3), False
                for _ in range(a, b):
                    if i < tb and (j >= nnz or bin_end[i] <= j):
                        if not cut:          # the thread's first bin
                            v = carry + run
                            if i == i0:
                                head = (i, v)
                            else:
                                out[:, i] = v.astype(np.float32)
                            cut = True
                        else:
                            out[:, i] = run.astype(np.float32)
                        run = np.zeros(3)
                        i += 1
                    else:
                        run = run + data[:, j].astype(np.float64)
                        j += 1
                carry = run if cut else carry + run
            ti, tj, dt = nti, ntj, dt + n_items
        heads.append(head)
        tails.append((ti, carry))
    for p, head in enumerate(heads):          # the carry launch
        if head is None:
            continue
        q = p
        while q > 0 and tails[q - 1][0] == head[0]:
            q -= 1
        v = np.zeros(3)
        for r in range(q, p):
            v = v + tails[r][1]
        out[:, head[0]] = (v + head[1]).astype(np.float32)
    carries = [(h[0] if h else -1, t[0]) for h, t in zip(heads, tails)]
    return out, carries


def bin_ids(bin_end: torch.Tensor) -> torch.Tensor:
    """[TB] exclusive end offsets -> [bin_end[-1]] int64 flat bin id of every
    bin-sorted entry."""
    tb = bin_end.shape[0]
    if tb == 0:
        return torch.zeros(0, dtype=torch.int64, device=bin_end.device)
    ends = bin_end.to(torch.int64)
    lengths = torch.diff(ends, prepend=ends.new_zeros(1))
    return torch.repeat_interleave(
        torch.arange(tb, device=bin_end.device), lengths)


def sparse_histogram_plain(data: torch.Tensor, bin_end: torch.Tensor,
                           f64: bool = False) -> torch.Tensor:
    """[3, width] f32 stats + [TB] bin end offsets -> [3, TB] f32 sums: one
    ``index_add_`` over the flat bin ids of the first ``bin_end[-1]``
    entries, accumulated in f64 and rounded to f32 once (``f64``: the sums
    before that rounding)."""
    ids = bin_ids(bin_end)
    out = torch.zeros(3, bin_end.shape[0], dtype=torch.float64,
                      device=data.device)
    out.index_add_(1, ids, data[:, :ids.shape[0]].double())
    return out if f64 else out.float()


def _check_inputs(data: torch.Tensor, bin_end: torch.Tensor) -> None:
    if data.dim() != 2 or data.shape[0] != 3 or data.dtype != torch.float32:
        raise TypeError(f"stats must be f32 [3, nnz], got {data.dtype} "
                        f"{tuple(data.shape)}")
    if bin_end.dim() != 1 or bin_end.dtype != torch.int32:
        raise TypeError(f"bin_end must be int32 [TB], got {bin_end.dtype} "
                        f"{tuple(bin_end.shape)}")
    if bin_end.device != data.device:
        raise ValueError(f"bin_end is on {bin_end.device}, stats on "
                         f"{data.device}")
    if not (data.is_contiguous() and bin_end.is_contiguous()):
        raise ValueError("stats and bin_end must be contiguous")
    if data.shape[1] + bin_end.shape[0] >= 1 << 31:
        raise ValueError("the kernel takes fewer than 2^31 entries and bins")
    # the kernel's 16-byte copies start from the aligned base
    if (data.numel() and data.data_ptr() % 16) or \
            (bin_end.numel() and bin_end.data_ptr() % 16):
        raise ValueError("stats and bin_end must be 16-byte aligned")


def _fn():
    fn = _kernels.lib("sparse_hist").mmlspark_sparse_hist
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def sparse_histogram_cuda(data: torch.Tensor, bin_end: torch.Tensor,
                          f64: bool = False) -> torch.Tensor:
    """Launch K4 on PyTorch's current stream; returns [3, TB] f32 (f64
    with ``f64``). The
    entries must be bin-sorted, their valid length ``bin_end[-1]`` at most
    the stats' width (read on the device: no host read)."""
    _check_inputs(data, bin_end)
    width, tb = data.shape[1], bin_end.shape[0]
    dev = data.device
    out = torch.empty(3, tb, dtype=torch.float64 if f64 else torch.float32,
                      device=dev)
    if tb:
        blocks, _ = shares(width, tb)
        keys = torch.empty(2 * blocks, dtype=torch.int32, device=dev)
        vals = torch.empty(6 * blocks, dtype=torch.float64, device=dev)
        p = _kernels.ptr
        code = _fn()(p(data), p(bin_end), p(out), p(keys), p(vals), width,
                     tb, blocks, int(f64), _kernels.stream_ptr(dev))
        graphs.note_launch(__name__, "launches")
        _kernels.check(code, "sparse_hist kernel launch")
    return out


def sparse_histogram(data: torch.Tensor, bin_end: torch.Tensor,
                     f64: bool = False) -> torch.Tensor:
    """[3, width] bin-sorted masked (grad, hess, count), ``bin_end[-1]`` of
    them valid -> [3, TB] per-bin sums: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if data.device.type == "cuda":
        return sparse_histogram_cuda(data, bin_end, f64=f64)
    if data.device.type == "cpu":
        return sparse_histogram_plain(data, bin_end, f64=f64)
    raise ValueError(f"no sparse histogram for device {data.device}")
