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

Both K4 and its plain version accumulate in f64 and round each cell to f32
once, so the card and the CPU build the same histogram (up to a
double-rounding tie) whatever order the entries are added in. That is also
more accurate than the reference's prefix differences: at 50M entries the
f32 prefix of the hessians passes 10^7, where one ulp is 1.

Bound on the H100: bytes. The function must read 12*nnz bytes of stats and
4*TB of bin offsets and write 12*TB: ~0.19 ms at 49.7M entries and 1.31M
bins against 3.35 TB/s. The kernel tiles the entry stream (never the bins,
which are heavily skewed in text data), reduces each segment run in f64
registers and a warp shuffle scan, and adds runs with f64 atomics; see the
source.

``sparse_histogram`` is the wrapper: a CPU tensor takes
``sparse_histogram_plain``, a CUDA tensor launches the kernel (there is no
fallback), anything else raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels

#: kernel launches since the counter was last set to 0
launches = 0


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


def sparse_histogram_plain(data: torch.Tensor,
                           bin_end: torch.Tensor) -> torch.Tensor:
    """[3, nnz] f32 stats + [TB] bin end offsets -> [3, TB] f32 sums: one
    ``index_add_`` over the entries' flat bin ids, accumulated in f64 and
    rounded to f32 once."""
    ids = bin_ids(bin_end)
    out = torch.zeros(3, bin_end.shape[0], dtype=torch.float64,
                      device=data.device)
    out.index_add_(1, ids, data[:, :ids.shape[0]].double())
    return out.float()


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


def _fn():
    fn = _kernels.lib("sparse_hist").mmlspark_sparse_hist
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def sparse_histogram_cuda(data: torch.Tensor,
                          bin_end: torch.Tensor) -> torch.Tensor:
    """Launch K4 on PyTorch's current stream; returns [3, TB] f32. The
    entries must be bin-sorted with ``bin_end[-1] == nnz``."""
    global launches
    _check_inputs(data, bin_end)
    nnz, tb = data.shape[1], bin_end.shape[0]
    acc = torch.zeros(3, tb, dtype=torch.float64, device=data.device)
    if nnz and tb:
        code = _fn()(_kernels.ptr(data), _kernels.ptr(bin_end),
                     _kernels.ptr(acc), nnz, tb,
                     _kernels.stream_ptr(data.device))
        launches += 1
        _kernels.check(code, "sparse_hist kernel launch")
    return acc.float()


def sparse_histogram(data: torch.Tensor, bin_end: torch.Tensor) -> torch.Tensor:
    """[3, nnz] bin-sorted masked (grad, hess, count) -> [3, TB] per-bin sums:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if data.device.type == "cuda":
        return sparse_histogram_cuda(data, bin_end)
    if data.device.type == "cpu":
        return sparse_histogram_plain(data, bin_end)
    raise ValueError(f"no sparse histogram for device {data.device}")
