"""K3: the CSR gather kernel (``csrc/csr_gather.cu``), its plain version, and
the used-feature remap of a forest.

Replaces the TPU kernel ``mmlspark_tpu/gbdt/pallas_sparse.py:_gather_kernel``
(``csr_gather_pallas``, dispatched by ``csr_gather``): a CSR-staged batch of
sparse rows -> the dense ``[N, U]`` f32 matrix of the ``U`` feature columns
the forest reads. The fused executor (``core/fusion.py``) stages sparse
feature rows as CSR triples when a segment's layout knob says ``"csr"``, and
the GBDT stage's ``sparse_fn`` gathers with ``csr_gather`` and traverses a
forest remapped onto the gathered columns, so a 2^18-wide hashed feature
space is scored without densifying it.

Semantics, bit for bit those of the reference's ``csr_gather_xla``
(``pallas_sparse.py:130``): used ids clamp to ``width - 1``; entries at
positions ``>= indptr[N]`` (nnz padding) belong to no row; an absent cell is
``+0.0``; a stored value is copied as its bits (an explicit ``0.0``, a
``-0.0`` and a NaN stay what they are). Row indices are sorted, distinct and
below ``width``.

On CUDA tensors ``csr_gather`` always launches K3, whatever kernel variant
is active: the gather is exact, so routing cannot change the result, and the
reference's ``_GATHER_MAX_CELLS`` guard sizes TPU VMEM, which this card does
not have. On CPU tensors it runs ``csr_gather_plain``, one global
``searchsorted`` over ``row * width + index`` keys as in the reference's XLA
formulation; anything else raises. ``launches`` counts kernel launches,
through CUDA graph replays too (core/graphs.py: the fused executor's mega
dispatch replays captured launches), and each launch adds its bytes bound
to an active cost tally (obs/perf.py), which cannot see inside it.

Bound on the H100: the launch's latency at the executor's 256-row batch
(~0.16 MB of bytes), bytes over a whole partition; see the source. The
kernel stages the used ids and each warp's rows of entries in shared memory
and finds each used id in a row's indices there by a branchless binary
search, up to four at a time a lane; ``launch_geometry`` sizes its grid
(one row a warp for a small batch, more for a large one). The wrapper's
own cost is most of a call at the executor's batch, so ``csr_gather_cuda``
checks its inputs with one expression and passes raw pointers and the raw
stream, packed into one argument, to a ``ctypes`` function bound on first
use.
"""

from __future__ import annotations

import copy
import ctypes
import struct

import numpy as np
import torch

from .. import _kernels
from ..core import graphs
from ..obs import perf as _perf

#: kernel launches since the counter was last set to 0
launches = 0
graphs.count_replays(__name__, "launches")

#: the kernel's shape, as in csrc/csr_gather.cu: warps a block, entries a
#: warp's shared-memory window holds, and used ids a block stages
WARPS_PER_BLOCK = 4
STAGE_ENTRIES = 512
USED_CHUNK = 512
#: H100 SXM streaming multiprocessors; a batch of at most ``SMS *
#: ROWS_PER_SM`` rows takes one row a warp, a larger one more rows a warp,
#: up to ``ROWS_PER_WARP_CAP``
SMS = 132
ROWS_PER_SM = 16
ROWS_PER_WARP_CAP = 4


# ---------------------------------------------------------------------------
# used-feature set + ensemble remap (host, once per forest)
# ---------------------------------------------------------------------------


def used_features(ens) -> np.ndarray:
    """Sorted unique feature ids the forest's internal nodes read (i64).
    Never empty: an all-leaf forest reads no feature, but keep one column so
    the compacted matrix has a valid shape."""
    feats = np.asarray(ens.feature)
    pos = np.unique(feats[feats >= 0]).astype(np.int64)
    if len(pos) == 0:
        pos = np.zeros(1, dtype=np.int64)
    return pos


def remap_ensemble(ens, used: np.ndarray):
    """A shallow copy of a ``DeviceEnsemble`` whose host feature ids are
    POSITIONS in ``used``, ready to traverse the ``[N, U]`` matrix
    ``csr_gather`` produces; its device tensors are built from the remapped
    host arrays on first use. Leaf markers (-1) stay; GEMM pad slots
    (ivalid == 0, feature 0) map to an in-range position, where their sign
    is zeroed exactly as on the dense path."""
    used = np.asarray(used, dtype=np.int64)
    remapped = copy.copy(ens)
    feats = np.asarray(ens.feature)
    pos = np.searchsorted(used, np.maximum(feats.astype(np.int64), 0))
    pos = np.minimum(pos, len(used) - 1)
    remapped.feature = np.where(feats >= 0, pos, feats).astype(feats.dtype)
    if ens._gemm is not None:
        feat_g, *rest = ens._gemm
        gpos = np.minimum(np.searchsorted(used, feat_g.astype(np.int64)),
                          len(used) - 1)
        remapped._gemm = (gpos.astype(feat_g.dtype), *rest)
    remapped._dev = {}
    return remapped


# ---------------------------------------------------------------------------
# CSR gather
# ---------------------------------------------------------------------------


def _width(width) -> int:
    if isinstance(width, torch.Tensor) and width.device.type != "cpu":
        raise TypeError("width must be a host value (reading it back from "
                        "the device would stall the stream)")
    w = int(width)
    if w <= 0:
        raise ValueError(f"width must be positive, got {w}")
    return w


def csr_gather_plain(indptr: torch.Tensor, indices: torch.Tensor,
                     values: torch.Tensor, width, used: torch.Tensor
                     ) -> torch.Tensor:
    """[N+1] offsets, [nnz] indices and f32 values, [U] used ids ->
    [N, U] f32: one ``searchsorted`` of every (row, used column) query over
    the ascending composite keys ``row * width + index``."""
    w = _width(width)
    n, u, nnz = indptr.shape[0] - 1, used.shape[0], indices.shape[0]
    dev = indices.device
    if n <= 0 or nnz == 0:
        return torch.zeros((max(n, 0), u), dtype=torch.float32, device=dev)
    used_q = torch.clamp(used.to(torch.int64), max=w - 1)
    # row of every entry position; positions past indptr[N] land on row N,
    # past every query
    row_of = torch.searchsorted(indptr.to(torch.int64),
                                torch.arange(nnz, device=dev), right=True) - 1
    key = row_of * w + indices.to(torch.int64)
    q = (torch.arange(n, device=dev)[:, None] * w + used_q[None, :]).reshape(-1)
    pos = torch.searchsorted(key, q)
    pos_c = torch.clamp(pos, max=nnz - 1)
    ok = (pos < nnz) & (key[pos_c] == q)
    x = torch.where(ok, values[pos_c], values.new_zeros(()))
    return x.reshape(n, u)


def launch_geometry(n_rows: int, n_used: int) -> tuple:
    """(rows a warp, grid x, grid y) of K3's launch for ``n_rows`` rows and
    ``n_used`` used ids; the C entry point takes the first and derives the
    same grid. A small batch is bound by latency: one row a warp, so each
    warp's chain of round trips is short and the blocks spread over the
    card. A large one is bound by bytes: several rows a warp, so each round
    trip moves several rows' entries."""
    rpw = min(ROWS_PER_WARP_CAP, max(1, -(-n_rows // (SMS * ROWS_PER_SM))))
    return (rpw, -(-n_rows // (WARPS_PER_BLOCK * rpw)),
            -(-n_used // USED_CHUNK))


def _check_inputs(indptr, indices, values, used) -> None:
    for name, t, dt in (("indptr", indptr, torch.int32),
                        ("indices", indices, torch.int32),
                        ("values", values, torch.float32),
                        ("used", used, torch.int32)):
        if t.dim() != 1 or t.dtype != dt:
            raise TypeError(f"{name} must be 1-D {dt}, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != indptr.device:
            raise ValueError(f"{name} is on {t.device}, indptr on "
                             f"{indptr.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if values.shape[0] != indices.shape[0]:
        raise ValueError(f"{values.shape[0]} values for {indices.shape[0]} "
                         f"indices")
    if indptr.shape[0] < 1 or used.shape[0] < 1:
        raise ValueError("indptr and used must not be empty")
    if indptr.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {indptr.device}")


_I32, _F32 = torch.int32, torch.float32
#: the launch's arguments as the C entry point reads them (``GatherArgs``):
#: pointers to indptr, indices, values, used and out, the stream, nnz, then
#: rows, used ids, width, rows a warp and two pads. One packed block,
#: because ctypes converts every argument of every call, and a dozen cost
#: the host more than the kernel takes on the card
_ARGS = struct.Struct("<6Qq6i")
#: (C entry point, raw current-stream getter), bound on the first launch
_bound = None


def _bind():
    global _bound
    fn = _kernels.lib("csr_gather").mmlspark_csr_gather
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    _bound = (fn, torch._C._cuda_getCurrentRawStream)
    return _bound


def gather_cost(n_rows: int, nnz: int, n_used: int) -> tuple:
    """(flops, bytes) of one gather: no arithmetic, and the bytes it must
    move — offsets, the batch's entries (index + value), the used ids and
    the [N, U] f32 output (``chip_smoke.py``'s ``gather_bound``)."""
    return 0.0, float(4 * (n_rows + 1) + 8 * nnz + 4 * n_used
                      + 4 * n_rows * n_used)


def csr_gather_cuda(indptr: torch.Tensor, indices: torch.Tensor,
                    values: torch.Tensor, width, used: torch.Tensor
                    ) -> torch.Tensor:
    """Launch K3 on PyTorch's current stream; returns [N, U] f32."""
    dev = indptr.device
    # the conditions of _check_inputs in one expression; it names the fault
    if not (dev.type == "cuda" and indptr.dtype is _I32
            and indices.dtype is _I32 and values.dtype is _F32
            and used.dtype is _I32 and indptr.dim() == 1
            and indices.dim() == 1 and values.dim() == 1 and used.dim() == 1
            and indices.device == dev and values.device == dev
            and used.device == dev and indptr.is_contiguous()
            and indices.is_contiguous() and values.is_contiguous()
            and used.is_contiguous() and values.numel() == indices.numel()
            and indptr.numel() >= 1 and used.numel() >= 1):
        _check_inputs(indptr, indices, values, used)
    w = width if type(width) is int and width > 0 else _width(width)
    n, u = indptr.numel() - 1, used.numel()
    out = torch.empty((n, u), dtype=_F32, device=dev)
    if n:
        fn, stream = _bound or _bind()
        code = fn(_ARGS.pack(indptr.data_ptr(), indices.data_ptr(),
                             values.data_ptr(), used.data_ptr(),
                             out.data_ptr(), stream(dev.index),
                             indices.numel(), n, u, w,
                             launch_geometry(n, u)[0], 0, 0))
        graphs.note_launch(__name__, "launches")
        _kernels.check(code, "csr_gather kernel launch")
        _perf.note_kernel_cost(*gather_cost(n, indices.numel(), u))
    return out


def csr_gather(indptr: torch.Tensor, indices: torch.Tensor,
               values: torch.Tensor, width, used: torch.Tensor
               ) -> torch.Tensor:
    """CSR triple + host ``width`` + [U] used ids -> [N, U] f32 matrix of
    the used columns: the kernel for CUDA tensors (there is no fallback),
    the plain version for CPU tensors."""
    if indptr.device.type == "cuda":
        return csr_gather_cuda(indptr, indices, values, width, used)
    if indptr.device.type == "cpu":
        return csr_gather_plain(indptr, indices, values, width, used)
    raise ValueError(f"no CSR gather for device {indptr.device}")
