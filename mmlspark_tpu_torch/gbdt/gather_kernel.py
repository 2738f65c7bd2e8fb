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
formulation; anything else raises. ``launches`` counts kernel launches.

Bound on the H100: bytes, ~0.4 MB per 256-row batch of text rows, so a launch
is bound by its latency; see the source.
"""

from __future__ import annotations

import copy
import ctypes

import numpy as np
import torch

from .. import _kernels

#: kernel launches since the counter was last set to 0
launches = 0


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


def _fn():
    fn = _kernels.lib("csr_gather").mmlspark_csr_gather
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def csr_gather_cuda(indptr: torch.Tensor, indices: torch.Tensor,
                    values: torch.Tensor, width, used: torch.Tensor
                    ) -> torch.Tensor:
    """Launch K3 on PyTorch's current stream; returns [N, U] f32."""
    global launches
    _check_inputs(indptr, indices, values, used)
    w = _width(width)
    n, u = indptr.shape[0] - 1, used.shape[0]
    out = torch.empty((n, u), dtype=torch.float32, device=indptr.device)
    if n:
        code = _fn()(_kernels.ptr(indptr), _kernels.ptr(indices),
                     _kernels.ptr(values), _kernels.ptr(used),
                     _kernels.ptr(out), n, u, indices.shape[0], w,
                     _kernels.stream_ptr(indptr.device))
        launches += 1
        _kernels.check(code, "csr_gather kernel launch")
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
