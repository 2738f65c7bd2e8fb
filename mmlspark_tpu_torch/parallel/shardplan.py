"""Sharding planner: cost-model-planned partition specs for fused segments.

Counterpart of the reference's ``mmlspark_tpu/parallel/shardplan.py``.
Partition specs are derived from the stage graph and chosen by the cost
model, never hand-annotated:

  - ``candidates(segment, mesh)`` derives the partitionings a segment
    admits, exactly as the reference does: ``data`` (every external input
    shards its batch dim over the ``data`` axis, legal for the
    row-independent fused programs), ``csr_row`` (derived and priced for a
    segment with a CSR-capable stage; the executor never stages CSR under
    sharding, as the reference's does not) and ``feature`` (over the
    ``tensor`` axis, only where every DeviceFn declares ``shard_dims``).
  - ``sharding_for(segment, mesh, name)`` resolves a candidate into a
    ``SegmentSharding``: what each rank stages and the collectives the
    executor runs around the segment's program.
  - ``measure_collectives(mesh)`` times all-reduce and all-gather probes on
    the mesh's groups and feeds the cost model's collective term, which
    ``choose_sharding`` prices (a journaled Tuner knob, core/tune.py).
  - ``shard_groups`` / ``submesh_excluding`` / ``MeshSupervision`` make the
    supervisor mesh-aware: a wedged rank quarantines its shard group, and
    the fused model re-plans onto the surviving sub-mesh.

The reference is one controller that compiles a GSPMD program over local
devices. The port's mesh is one process a rank (parallel/mesh.py), so a
sharded segment is SPMD: every rank runs ``transform`` on the same frame.
Under ``data`` each rank stages its block of every padded batch, runs the
segment's program on its own card, and all-gathers the outputs over the
axis, so every rank returns the whole frame. Under ``feature`` each rank
stages its block of the feature dim and all-gathers full rows over
``tensor`` before the program, which then runs replicated: the explicit
form of the gather of full rows the reference's compiler inserts for the
forest. Before a gather the ranks agree on failure (``mesh.any_failed``),
so a staging failure on one rank (the ``mesh.chip_wedge`` chaos seam)
sends every rank to the host fallback instead of leaving a partner
waiting. A candidate of one shard is the unsharded path, bit for bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import faults
from .mesh import (DATA_AXIS, TENSOR_AXIS, MeshSpec, any_failed, axis_group,
                   gather_blocks, mesh_topology, sub_mesh)

__all__ = ["ShardCandidate", "SegmentSharding", "MeshSupervision",
           "candidates", "candidate_for", "sharding_for", "tuner_candidates",
           "measure_collectives", "shard_groups", "group_of",
           "submesh_excluding", "donation_supported", "mesh_topology",
           "split_csr_rows", "ragged_allgather_bytes"]

#: candidate partitioning names (the values of the ``sharding`` tuner knob)
SPEC_DATA = "data"
SPEC_FEATURE = "feature"
SPEC_CSR_ROW = "csr_row"

# consensus flags (``mesh.any_failed``): the largest over the ranks wins
_OK, _DEMOTE, _ERROR = 0, 1, 2


# ---------------------------------------------------------------------------
# Candidate derivation (host-side)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardCandidate:
    """One partitioning a segment admits over a mesh.

    ``in_dims`` maps each external input column to the dim sharded over
    ``axis`` (None = replicated input); ``out_dim`` is the dim outputs come
    back split on (None = replicated outputs). ``collective`` names the
    collective the cost model prices (``all_gather`` for the data
    readback, ``all_reduce`` for the feature candidate, as the reference
    names it)."""

    name: str
    axis: str
    shards: int
    in_dims: Tuple[Tuple[str, Optional[int]], ...]
    out_dim: Optional[int]
    collective: str

    def describe(self) -> Dict[str, Any]:
        return {"name": self.name, "axis": self.axis, "shards": self.shards,
                "in_dims": dict(self.in_dims), "out_dim": self.out_dim,
                "collective": self.collective}


def candidates(segment, mesh) -> List[ShardCandidate]:
    """Candidate partitionings for one fused Segment over ``mesh``: ``data``
    whenever the data axis has more than one shard, ``csr_row`` beside it
    for a segment with a CSR-capable stage, and ``feature`` over the tensor
    axis only where every DeviceFn declares a dim for each of its external
    inputs (``DeviceFn.shard_dims``)."""
    out: List[ShardCandidate] = []
    ext = list(segment.external_in_cols)
    shape = dict(getattr(mesh, "shape", {}) or {})
    n_data = int(shape.get(DATA_AXIS, 1))
    if n_data > 1 and ext:
        out.append(ShardCandidate(
            name=SPEC_DATA, axis=DATA_AXIS, shards=n_data,
            in_dims=tuple((c, 0) for c in ext), out_dim=0,
            collective="all_gather"))
    if n_data > 1 and ext and any(
            getattr(dfn, "sparse_fn", None) is not None
            and getattr(dfn, "sparse_cols", ()) for dfn in segment.dfns):
        # row-split CSR over the data axis: priced from the nnz term; the
        # executor keeps the densify path under sharding (as the reference)
        out.append(ShardCandidate(
            name=SPEC_CSR_ROW, axis=DATA_AXIS, shards=n_data,
            in_dims=tuple((c, 0) for c in ext), out_dim=0,
            collective="all_gather"))
    n_tensor = int(shape.get(TENSOR_AXIS, 1))
    if n_tensor > 1 and ext:
        dims: Dict[str, int] = {}
        ok = True
        written: set = set()
        for dfn in segment.dfns:
            decl = getattr(dfn, "shard_dims", None) or {}
            for c in dfn.in_cols:
                if c in written:
                    continue  # internal input: the sharding propagates
                if c not in decl:
                    ok = False
                    break
                dims[c] = int(decl[c])
            if not ok:
                break
            written |= set(dfn.out_cols)
        if ok and set(dims) >= set(ext):
            out.append(ShardCandidate(
                name=SPEC_FEATURE, axis=TENSOR_AXIS, shards=n_tensor,
                in_dims=tuple((c, dims[c]) for c in ext), out_dim=None,
                collective="all_reduce"))
    return out


def candidate_for(segment, mesh, name: str) -> Optional[ShardCandidate]:
    for cand in candidates(segment, mesh):
        if cand.name == str(name):
            return cand
    return None


def tuner_candidates(segment, mesh, model=None, batch: Optional[int] = None
                     ) -> List[Dict[str, Any]]:
    """Candidate descriptions in the shape ``SegmentCostModel.
    choose_sharding`` prices: ``{name, shards, op, collective_bytes}``.
    ``collective_bytes`` is the tallied output bytes of the segment's
    programs (0 when none was recorded: the collective then prices as
    free); the ``csr_row`` candidate's comes from the fitted nnz term."""
    out: List[Dict[str, Any]] = []
    label = getattr(segment, "label", str(segment))
    for cand in candidates(segment, mesh):
        nbytes = 0.0
        if model is not None:
            fn = getattr(model, "segment_bytes", None)
            if callable(fn):
                try:
                    nbytes = float(fn(label, "output_bytes") or 0.0)
                except Exception:  # noqa: BLE001 — estimate only
                    nbytes = 0.0
        if cand.name == SPEC_CSR_ROW and model is not None and batch:
            fn = getattr(model, "nnz_bytes", None)
            if callable(fn):
                try:
                    nb = fn(label, int(batch))
                    if nb is not None:
                        nbytes = float(nb)
                except Exception:  # noqa: BLE001 — estimate only
                    pass
        out.append({"name": cand.name, "shards": cand.shards,
                    "op": cand.collective, "collective_bytes": nbytes})
    return out


def split_csr_rows(indptr, indices, values, shards: int
                   ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Row-split one CSR column into ``shards`` contiguous row ranges, each
    with a rebased indptr (``ip[0] == 0``) and exactly its rows' (indices,
    values): the host side of the ``csr_row`` spec. Concatenating the
    shards' predictions in order is the unsplit prediction."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices)
    values = np.asarray(values)
    n = len(indptr) - 1
    shards = max(1, int(shards))
    bounds = [round(i * n / shards) for i in range(shards + 1)]
    out: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for lo, hi in zip(bounds, bounds[1:]):
        base = int(indptr[lo])
        end = int(indptr[hi])
        ip = (indptr[lo:hi + 1] - base).astype(np.int32)
        out.append((ip, np.asarray(indices[base:end], dtype=np.int32),
                    np.asarray(values[base:end], dtype=np.float32)))
    return out


def ragged_allgather_bytes(nnz_per_shard: Sequence[int],
                           rows_per_shard: Optional[Sequence[int]] = None
                           ) -> float:
    """All-gather payload of a ragged row-split CSR batch: every shard's
    (indices, values) pads to the largest nnz before the gather, plus the
    rebased indptr slices."""
    nnz = [int(x) for x in nnz_per_shard]
    if not nnz:
        return 0.0
    pad = max(max(nnz), 1)
    bytes_iv = len(nnz) * pad * 8.0  # i32 indices + f32 values per slot
    rows = sum(int(r) for r in (rows_per_shard or []))
    return bytes_iv + (rows + len(nnz)) * 4.0


# ---------------------------------------------------------------------------
# Runtime sharding handle (executor-facing)
# ---------------------------------------------------------------------------


def donation_supported(mesh) -> bool:
    """Input donation has no PyTorch counterpart: a staged batch's memory is
    freed with its last reference. Always False (``describe()`` keeps the
    reference's ``donate`` key)."""
    return False


class StageFailed:
    """What a sharded ``device_put`` returns in place of a staged batch when
    staging failed on this rank: the step then reports the failure to the
    other ranks (``mesh.any_failed``) instead of raising alone."""

    __slots__ = ("reason",)

    def __init__(self, reason: str):
        self.reason = reason


class SegmentSharding:
    """Resolved sharding of one SegmentExecutor: one (segment, candidate,
    mesh). ``device_put`` stages this rank's block of a host batch and is
    the chip-wedge chaos seam (``mesh.chip_wedge`` fires per staged batch
    on the sharded path only, so an injection never touches the unsharded
    path); ``run`` calls the segment's program between the candidate's
    collectives."""

    #: a rank stages only its block of each batch
    splits = True

    def __init__(self, segment, mesh, candidate: ShardCandidate):
        self.segment = segment
        self.mesh = mesh
        self.candidate = candidate

    @property
    def spec_name(self) -> str:
        return self.candidate.name

    @property
    def shards(self) -> int:
        return int(self.candidate.shards)

    @property
    def axis(self) -> str:
        return self.candidate.axis

    def cache_key(self) -> Tuple:
        """Program-cache key component: a sharded program is kept apart from
        the single-device one for the same batch shape."""
        return ("spec", self.candidate.name, self.candidate.axis,
                self.shards)

    def shape_prefix(self) -> str:
        """Cost-record shape-key prefix, unparseable by ``bucket_of_shape``:
        a rank's share of the flops must not fold into the single-device
        table."""
        return f"spec={self.candidate.name}{self.shards};"

    def _blocks(self, size: int) -> Tuple[int, List[int]]:
        """(this rank's block index, every block's length) of a dim of
        ``size`` split over the candidate's axis (``np.array_split``)."""
        n = self.shards
        sizes = [len(b) for b in np.array_split(np.arange(size), n)]
        return self.mesh.coord(self.axis), sizes

    def local(self, col: str, arr):
        """This rank's block of one input column (an array or a tensor)."""
        dim = dict(self.candidate.in_dims).get(col)
        if dim is None or np.ndim(arr) <= dim:
            return arr
        me, sizes = self._blocks(int(arr.shape[dim]))
        start = sum(sizes[:me])
        idx = [slice(None)] * np.ndim(arr)
        idx[dim] = slice(start, start + sizes[me])
        return arr[tuple(idx)]

    def put_params(self, params):
        """Params stay whole on every rank's card: a replicated copy."""
        return params

    def device_put(self, arrays: Dict[str, np.ndarray], device) -> Any:
        """Stage this rank's block of one host batch on ``device``. Fires
        ``mesh.chip_wedge`` first: an armed raise simulates a rank's card
        dropping out mid-stage; the failure comes back as ``StageFailed``
        for the step to report to every rank."""
        from .ingest import stage_array

        try:
            faults.fire(faults.MESH_CHIP_WEDGE)
            return {c: stage_array(np.ascontiguousarray(self.local(c, v)),
                                   device)
                    for c, v in arrays.items()}
        except Exception as e:  # noqa: BLE001 — any stage fault demotes
            return StageFailed(str(e))

    def reshard(self, tensors: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """This rank's block of inputs that arrived whole on its card (a
        pipe stage's handoff)."""
        return {c: self.local(c, t).contiguous() for c, t in tensors.items()}

    def _agree(self, flag: int, reason: str, error=None) -> None:
        """Every rank's verdict on one batch: nothing raised anywhere, or
        the same decision everywhere (``FusionUnsupported``: the
        partition's host fallback; a rank's own error re-raised there and a
        ``RuntimeError`` on its partners)."""
        from ..core.device_stage import FusionUnsupported

        worst = any_failed(flag, self.mesh)
        if worst == _OK:
            return
        if error is not None and flag == _ERROR:
            raise error
        if worst == _DEMOTE:
            raise FusionUnsupported(
                f"mesh stage failure: {reason or 'on a peer rank'}")
        raise RuntimeError(f"{self.segment.label}: a peer rank's program "
                           f"failed on a sharded batch")

    @staticmethod
    def _call(program, params, x):
        from ..core.device_stage import FusionUnsupported

        try:
            return program(params, x), _OK, "", None
        except FusionUnsupported as e:
            return None, _DEMOTE, str(e), e
        except Exception as e:  # noqa: BLE001 — reported to every rank
            return None, _ERROR, str(e), e

    def _gather_in(self, x: Dict[str, torch.Tensor], sizes_of
                   ) -> Dict[str, torch.Tensor]:
        out = dict(x)
        for c, dim in self.candidate.in_dims:
            if dim is None or c not in out or out[c].dim() <= dim:
                continue
            out[c] = gather_blocks(out[c], self.mesh, self.axis, dim,
                                   sizes_of[c])
        return out

    def _gather_out(self, ys: Tuple[torch.Tensor, ...]
                    ) -> Tuple[torch.Tensor, ...]:
        dim = self.candidate.out_dim
        if dim is None:
            return tuple(ys)
        return tuple(gather_blocks(y, self.mesh, self.axis, dim,
                                   [int(y.shape[dim])] * self.shards)
                     for y in ys)

    def run(self, program, params, x, full_shapes: Dict[str, Tuple]):
        """The program over one staged batch (this rank's block), between
        the candidate's collectives: ``data`` runs the block and gathers
        the outputs over the axis; ``feature`` gathers the inputs' full
        rows, then runs replicated. ``full_shapes``: each input's shape
        before staging (its blocks' lengths). ``program`` is called inside
        the agreement: a failure to find or build it on one rank is every
        rank's failure."""
        return self.run_many(lambda p, xs: (program(p, xs[0]),), params,
                             [x], full_shapes)[0]

    def run_many(self, program, params, xs: Sequence[Any],
                 full_shapes: Dict[str, Tuple]):
        """``run`` over K batches: ``program(params, cols_seq)`` computes
        the K batches on this rank (one captured graph on the card: the
        collectives stay outside it), then each batch's outputs go through
        the candidate's collectives in order."""
        if self.candidate.out_dim is None:
            failed = next((x for x in xs if isinstance(x, StageFailed)), None)
            self._agree(_DEMOTE if failed else _OK,
                        failed.reason if failed else "")
            sizes = {c: self._blocks(int(full_shapes[c][dim]))[1]
                     for c, dim in self.candidate.in_dims
                     if dim is not None and c in full_shapes
                     and len(full_shapes[c]) > dim}
            outs, flag, reason, err = self._call(
                program, params, tuple(self._gather_in(x, sizes)
                                       for x in xs))
            self._agree(flag, reason, err)
            return outs
        failed = next((x for x in xs if isinstance(x, StageFailed)), None)
        if failed is not None:
            outs, flag, reason, err = None, _DEMOTE, failed.reason, None
        else:
            outs, flag, reason, err = self._call(program, params, tuple(xs))
        self._agree(flag, reason, err)
        return tuple(self._gather_out(ys) for ys in outs)

    def describe(self) -> Dict[str, Any]:
        return {"spec": self.candidate.name, "axis": self.candidate.axis,
                "shards": self.shards,
                "collective": self.candidate.collective,
                "donate": donation_supported(self.mesh)}


def sharding_for(segment, mesh, name: Optional[str]
                 ) -> Optional[SegmentSharding]:
    """Resolve a tuned sharding knob value into a SegmentSharding, or None
    when it must stay unsharded: no mesh, a mesh this rank is not in, an
    unknown candidate, or a one-shard axis (the unsharded path, bit for
    bit)."""
    if mesh is None or not name:
        return None
    if not getattr(mesh, "is_member", True):
        return None
    cand = candidate_for(segment, mesh, name)
    if cand is None or cand.shards <= 1:
        return None
    return SegmentSharding(segment, mesh, cand)


# ---------------------------------------------------------------------------
# Collective probes (the α·bytes calibration source)
# ---------------------------------------------------------------------------


def measure_collectives(mesh, sizes: Sequence[int] = (1 << 14, 1 << 18),
                        repeats: int = 3, model=None,
                        axis: Optional[str] = None) -> List[Dict[str, Any]]:
    """Time all-reduce and all-gather collectives over one axis of the mesh
    (default: ``data`` when it has more than one shard, else the largest)
    at each payload size in bytes, and feed the cost model's
    ``observe_collective``. One untimed call per (op, size) first. Every
    rank of the mesh calls it; returns this rank's probe records."""
    import torch.distributed as dist

    shape = dict(getattr(mesh, "shape", {}) or {})
    if axis is None:
        axis = DATA_AXIS if int(shape.get(DATA_AXIS, 1)) > 1 else \
            max(shape, key=lambda a: shape[a])
    n = int(shape.get(axis, 1))
    g = axis_group(mesh, axis)
    if n <= 1 or g is None:
        return []
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    records: List[Dict[str, Any]] = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for op in ("all_reduce", "all_gather"):
        for size in sizes:
            elems = max(n, (int(size) // 4 // n) * n)
            x = torch.zeros(elems, dtype=torch.float32, device=dev)
            part = x[:elems // n].contiguous()
            outs = [torch.empty_like(part) for _ in range(n)]

            def once():
                if op == "all_reduce":
                    dist.all_reduce(x, group=g.handle)
                else:
                    dist.all_gather(outs, part, group=g.handle)

            once()
            sync()
            t0 = time.perf_counter()
            for _ in range(max(1, int(repeats))):
                once()
            sync()
            seconds = (time.perf_counter() - t0) / max(1, int(repeats))
            rec = {"op": op, "axis": axis, "shards": n,
                   "bytes": elems * 4, "seconds": seconds}
            records.append(rec)
            if model is not None:
                feed = getattr(model, "observe_collective", None)
                if callable(feed):
                    feed(op, elems * 4, seconds)
    return records


# ---------------------------------------------------------------------------
# Mesh-aware supervision: shard groups + sub-mesh re-planning
# ---------------------------------------------------------------------------


def shard_groups(mesh) -> List[List[int]]:
    """Indices into the mesh (its ranks in mesh order) that fail together:
    all sharing one data-axis coordinate (the model-parallel slice a rank
    computes with). For a pure data mesh each group is one rank."""
    arr = np.arange(int(np.prod(np.shape(mesh.devices)))).reshape(
        np.shape(mesh.devices))
    axes = list(mesh.axis_names)
    if DATA_AXIS in axes:
        arr = np.moveaxis(arr, axes.index(DATA_AXIS), 0)
    n = arr.shape[0]
    return [[int(i) for i in row] for row in arr.reshape(n, -1)]


def group_of(mesh, device_index: int) -> List[int]:
    """The shard group (mesh indices) containing ``device_index``."""
    idx = int(device_index)
    for grp in shard_groups(mesh):
        if idx in grp:
            return grp
    raise ValueError(f"device index {device_index} not in mesh")


def submesh_excluding(mesh, exclude_ranks: Sequence[int]):
    """A data mesh over the surviving ranks of ``mesh`` (global ranks), or
    None when none survives. A rank it leaves out holds the description
    and no group, and runs unsharded."""
    dead = {int(r) for r in exclude_ranks}
    survivors = [r for r in mesh.ranks if r not in dead]
    if not survivors:
        return None
    return sub_mesh(mesh, survivors, MeshSpec(data=len(survivors)))


class MeshSupervision:
    """Glue from replica supervision to mesh repair: owns the mesh a
    FusedPipelineModel shards over, registers the shard groups with a
    ReplicaSupervisor (one supervised index per rank of the mesh), and on
    a wedge quarantines the group and re-plans the model onto the surviving
    sub-mesh (data parallelism over the survivors). Every rank runs the
    same calls (SPMD).

    ``on_wedge(index)`` is idempotent per group and returns the new mesh
    (None when no rank survives: the model then runs unsharded)."""

    def __init__(self, fused, mesh, supervisor=None):
        self.fused = fused
        self.mesh0 = mesh
        self.mesh = mesh
        self.supervisor = supervisor
        self._failed: List[int] = []
        self.replans = 0
        if supervisor is not None:
            setter = getattr(supervisor, "set_shard_groups", None)
            if callable(setter):
                setter(shard_groups(mesh))
        if fused is not None and hasattr(fused, "set_mesh"):
            fused.set_mesh(mesh)

    def failed_devices(self) -> List[int]:
        return list(self._failed)

    def on_wedge(self, device_index: int):
        """A rank wedged: quarantine its whole shard group and re-plan the
        fused model over the surviving sub-mesh."""
        group = group_of(self.mesh0, device_index)
        ranks = self.mesh0.ranks
        fresh = [ranks[i] for i in group if ranks[i] not in self._failed]
        if not fresh:
            return self.mesh  # whole group already quarantined: no-op
        self._failed.extend(fresh)
        if self.supervisor is not None:
            wedge = getattr(self.supervisor, "note_wedged", None)
            if callable(wedge):
                wedge(int(device_index))
        sub = submesh_excluding(self.mesh0, self._failed)
        self.mesh = sub
        self.replans += 1
        if self.fused is not None and hasattr(self.fused, "set_mesh"):
            self.fused.set_mesh(sub)
        return sub

    def describe(self) -> Dict[str, Any]:
        return {"topology": mesh_topology(self.mesh),
                "original": mesh_topology(self.mesh0),
                "failed_devices": len(self._failed),
                "replans": self.replans}
