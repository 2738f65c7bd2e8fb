"""The process mesh on ``torch.distributed``: discovery, construction, the
collectives the data-parallel learners call.

Counterpart of the reference's ``mmlspark_tpu/parallel/mesh.py``, which
replaces the original system's driver-socket rendezvous and its LightGBM /
VW rings with one SPMD mesh. The reference is a single controller that
drives a mesh of local devices. The port takes PyTorch's idiom: one
process per data shard, all running the same program.

  - rendezvous = ``dist.init_process_group`` (``initialize_distributed``:
    the same ``MMLSPARK_COORDINATOR`` / ``MMLSPARK_NUM_PROCESSES`` /
    ``MMLSPARK_PROCESS_ID`` environment as the reference's);
  - worker count = the ``data`` axis, the world size;
  - each process's ``Mesh`` carries its rank, its device (``cuda:<local
    rank>`` unless the caller names one), its backend (NCCL on CUDA, gloo on
    the CPU) and its process group.

Every rank calls an entry point with the same full inputs, as the
reference's controller does, and keeps its own row block
(``row_block``); the learners sum their histograms and states with
``all_reduce_sum`` and gather rows with ``all_gather``. A collective is
never replaced by anything else: a failed initialisation or collective
raises. Gloo on CUDA tensors runs only when the caller names it
(``make_mesh(backend="gloo")``); its all-reduce and all-gather then go
through host memory, as NCCL's go through the mesh's card for a host
tensor (the host-kept scores a metric or log gathers).

All six axes of the reference's mesh are there. A rank's coordinates
follow the reference's device order, row-major over ``AXES`` (data
slowest), as ``jax.make_mesh`` lays devices out, so rank r holds what the
reference's device r holds. ``make_mesh`` gives each rank a process group
for every axis and for the batch group (data x fsdp, the reference's
``num_data_shards``), made by every rank in the same order. The DNN layers
call the differentiable collectives below on them (``all_gather_axis`` and
``reduce_scatter_axis``, each the other's backward; ``all_reduce_axis``;
``ring_shift``, whose backward is the reverse shift): ``torch.distributed``
carries no gradient of its own.

The GBDT and VW fits shard rows over the data axis alone, as the
reference's do: a rank takes the block of its data coordinate
(``row_block``) and sums and gathers over its data-axis group
(``all_reduce_sum``, ``all_gather``); the ranks that share a data
coordinate (the replicas along fsdp, tensor, seq, expert and pipe) hold
the same block and compute the same trees. ``fsdp`` replicates here too,
though the DNN's batch group is data x fsdp.

The fusion planners (``parallel/shardplan.py``, ``parallel/pipeplan.py``)
take sub-meshes of a mesh: ``sub_mesh(mesh, members, spec)`` lays a subset
of its ranks out as a mesh of its own (a pipe stage's ranks with the other
axes kept, the survivors of a wedged shard group), with a group on every
axis made by its members alone. A rank outside a sub-mesh holds its
description and no group. The members of a group agree that each of them
can form it before any blocks in the backend's rendezvous
(``_member_group``): a failure on one member raises on all of them, and a
member that never arrives ends the others' wait within
``FORM_TIMEOUT_S``.
``send_tensors`` / ``recv_tensors`` move a dict of tensors from one rank to
another (the pipe handoff: NCCL card to card, gloo through host memory);
``mesh_topology`` names a mesh's shape and card.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

log = logging.getLogger("mmlspark_tpu_torch")

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"
AXES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS, SEQ_AXIS, EXPERT_AXIS, PIPE_AXIS)

BATCH = "batch"        # the (data, fsdp) group: a batch's row blocks
WORLD = "world"        # every rank of the mesh

#: seconds the members of a sub-mesh group wait for one another to agree
#: that every one can form it, and then for the group's rendezvous
FORM_TIMEOUT_S = 60.0
#: the default timeout of a sub-mesh group's collectives
GROUP_TIMEOUT_S = 1800.0


def _dist():
    import torch.distributed as dist

    return dist


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join the process group. Arguments default from the environment
    (``MMLSPARK_COORDINATOR``, ``MMLSPARK_NUM_PROCESSES``,
    ``MMLSPARK_PROCESS_ID``), so every process of a launch runs the same
    code. The coordinator is an ``init_method`` (``tcp://host:port``,
    ``file:///path``; a bare ``host:port`` means tcp). ``backend``: NCCL
    when CUDA is available, else gloo.

    A single process is a no-op that does not latch: a later call with
    more processes still initialises. A group the caller started is kept.
    Returns True iff this call started the group."""
    dist = _dist()
    if dist.is_initialized():
        return False
    coordinator_address = coordinator_address or \
        os.environ.get("MMLSPARK_COORDINATOR")
    if num_processes is None and "MMLSPARK_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["MMLSPARK_NUM_PROCESSES"])
    if process_id is None and "MMLSPARK_PROCESS_ID" in os.environ:
        process_id = int(os.environ["MMLSPARK_PROCESS_ID"])
    if num_processes in (None, 1):
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError(
            f"{num_processes} processes need a coordinator address and this "
            f"process's id (MMLSPARK_COORDINATOR, MMLSPARK_PROCESS_ID)")
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=int(num_processes),
                            rank=int(process_id))
    log.info("torch.distributed initialized: process %s of %s via %s (%s)",
             process_id, num_processes, coordinator_address, backend)
    return True


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def process_shard(df, process_id: Optional[int] = None,
                  num_processes: Optional[int] = None):
    """Per-process input sharding: this process's partitions of a
    DataFrame, round robin by partition index; the frame itself for one
    process."""
    if process_id is None or num_processes is None:
        initialize_distributed()
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    if n <= 1:
        return df
    from ..core.dataframe import DataFrame

    mine = [p for i, p in enumerate(df.partitions) if i % n == pid]
    if not mine:
        return df.limit(0)
    return DataFrame(mine, schema=df.schema)


@dataclasses.dataclass
class MeshSpec:
    """Declarative mesh shape; -1 on one axis absorbs the remaining
    processes."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1
    pipe: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = dataclasses.asdict(self)
        fixed = 1
        wild = None
        for k, v in sizes.items():
            if v == -1:
                if wild is not None:
                    raise ValueError("Only one mesh axis may be -1")
                wild = k
            else:
                fixed *= v
        if wild is not None:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[wild] = n_devices // fixed
        else:
            total = int(np.prod(list(sizes.values())))
            if total != n_devices:
                raise ValueError(f"Mesh {sizes} needs {total} devices, have {n_devices}")
        return sizes


@dataclasses.dataclass
class CollectiveStats:
    """What this process's collectives did since the last ``reset``: calls,
    bytes each process contributed, and the host wall time of the calls
    (on NCCL that is the enqueue, not the transfer)."""

    calls: int = 0
    bytes: int = 0
    ms: float = 0.0

    def reset(self) -> None:
        self.calls, self.bytes, self.ms = 0, 0, 0.0


#: this process's collectives (a reading aid for the smoke test and logs)
stats = CollectiveStats()


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The ranks along one axis (or the batch group) that hold this rank's
    other coordinates, in coordinate order, and their process group
    (None: the default group)."""

    ranks: Tuple[int, ...]
    handle: Any = None

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass(eq=False)
class Mesh:
    """One process's view of the mesh: ``shape`` maps every axis to its
    size (the reference's ``mesh.shape``), ``rank`` is this process's global
    rank (its index on the data axis when that is the only axis), ``device``
    where its tensors live, ``backend`` and ``group`` the process group of
    the whole mesh (None: the default group, or no group for one process).
    ``groups`` maps an axis, ``BATCH`` and ``WORLD`` to the ``AxisGroup``
    this rank is in; an axis of size 1 has none (its collectives are the
    identity), except in a mesh of one process, where every key names the
    one-rank group so that the backend's code path runs."""

    shape: Dict[str, int]
    rank: int = 0
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    backend: str = "gloo"
    group: Any = None
    groups: Dict[str, AxisGroup] = dataclasses.field(default_factory=dict)
    # the global ranks of this mesh in its order (() = every rank of the
    # process group, 0..n-1); a sub-mesh's are a subset (``sub_mesh``)
    members: Tuple[int, ...] = ()
    # the group of the whole process group (None: the default group): the
    # one rank-to-rank transfers go through, sub-mesh or not
    root: Any = None
    _subs: Dict[Any, "Mesh"] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def size(self) -> int:
        return int(self.shape.get(DATA_AXIS, 1))

    @property
    def ranks(self) -> Tuple[int, ...]:
        """The global ranks of this mesh, in mesh order."""
        return self.members or tuple(range(self.axis_size(WORLD)))

    @property
    def index(self) -> Optional[int]:
        """This process's place in ``ranks`` (None: not a member)."""
        r = self.ranks
        return r.index(self.rank) if self.rank in r else None

    @property
    def is_member(self) -> bool:
        return self.rank in self.ranks

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXES

    @property
    def devices(self) -> np.ndarray:
        """The mesh's global ranks laid out over ``AXES`` (the reference's
        ``mesh.devices``: a rank stands for its device)."""
        return np.asarray(self.ranks).reshape(
            [int(self.shape.get(a, 1)) for a in AXES])

    def axis_size(self, axis: str) -> int:
        if axis == BATCH:
            return num_data_shards(self)
        if axis == WORLD:
            return int(np.prod([self.shape.get(a, 1) for a in AXES]))
        return int(self.shape.get(axis, 1))

    def coord(self, axis: str) -> int:
        """This rank's index on ``axis`` (``BATCH``: its row block, data
        major)."""
        if self.index is None:
            raise ValueError(f"rank {self.rank} is not in this mesh")
        c = coords_of(self.index, self.shape)
        if axis == BATCH:
            return c[DATA_AXIS] * int(self.shape.get(FSDP_AXIS, 1)) \
                + c[FSDP_AXIS]
        if axis == WORLD:
            return self.index
        return c[axis]


def coords_of(rank: int, shape: Dict[str, int]) -> Dict[str, int]:
    """The coordinates of ``rank``: row-major over ``AXES``, data slowest
    (``jax.make_mesh``'s device order)."""
    sizes = [int(shape.get(a, 1)) for a in AXES]
    idx = np.unravel_index(int(rank), sizes) if rank < int(np.prod(sizes)) \
        else None
    if idx is None:
        raise ValueError(f"rank {rank} is outside a mesh of {shape}")
    return {a: int(i) for a, i in zip(AXES, idx)}


def _group_keys():
    return [(a, (a,)) for a in AXES] + [(BATCH, (DATA_AXIS, FSDP_AXIS)),
                                        (WORLD, AXES)]


def _make_groups(sizes: Dict[str, int], rank: int, world: int, base,
                 backend: str, members: Optional[Sequence[int]] = None
                 ) -> Dict[str, AxisGroup]:
    """This rank's ``AxisGroup`` for every axis, the batch group and the
    world of the mesh over ``members``. Without ``members`` (the whole
    process group) every rank calls ``dist.new_group`` for every group,
    members or not, in the same order (the collective contract of
    ``new_group``); a group of the whole process group is ``base`` itself.
    With ``members`` (a sub-mesh) a rank makes only the groups it is in
    (``_member_group``), so a rank outside the sub-mesh takes no part."""
    local = members is not None
    dist = _dist()
    dims = [int(sizes.get(a, 1)) for a in AXES]
    members = list(range(world)) if members is None else list(members)
    ids = np.asarray(members).reshape(dims)
    everyone = members == list(range(world))
    out: Dict[str, AxisGroup] = {}
    for key, axes in _group_keys():
        moving = [AXES.index(a) for a in axes]
        size = int(np.prod([dims[i] for i in moving]))
        if size == 1 and world > 1:
            continue
        if size == len(members) and everyone:
            out[key] = AxisGroup(tuple(int(r) for r in ids.reshape(-1)),
                                 base)
            continue
        fixed = [i for i in range(len(AXES)) if i not in moving]
        blocks = np.transpose(ids, fixed + moving).reshape(-1, size)
        for block in blocks:
            ranks = tuple(int(r) for r in block)
            if local:
                if rank in ranks:
                    out[key] = AxisGroup(ranks, _member_group(
                        ranks, rank, backend))
                continue
            handle = dist.new_group(list(ranks), backend=backend)
            if rank in ranks:
                out[key] = AxisGroup(ranks, handle)
    return out


_MEMBER_GROUPS: Dict[Tuple[int, ...], int] = {}


def _member_group(ranks: Tuple[int, ...], rank: int, backend: str):
    """A process group of ``ranks`` made by its members alone: a gloo or
    NCCL group over the default store under a prefix named by the ranks
    and how many groups of those ranks this process has made (the same on
    every member, which make them in one order). ``dist.new_group`` cannot
    serve: without every rank of the process group it names a group after
    how many groups the calling process holds, which differs from member
    to member once sub-meshes leave some ranks out.

    Before any member blocks in the backend's rendezvous, the members
    agree that every one of them could prepare the group
    (``_agree_on_store``): a failure on one raises the same error on all,
    so every member falls back alike, and a member that never arrives
    ends the others' wait within ``FORM_TIMEOUT_S``. The gloo rendezvous
    after the agreement is bounded by the same time."""
    dist = _dist()
    n = _MEMBER_GROUPS.get(ranks, 0)
    _MEMBER_GROUPS[ranks] = n + 1
    name = f"mmlspark_sub/{'_'.join(map(str, ranks))}/{n}"
    base = dist.distributed_c10d._get_default_store()
    me = ranks.index(rank)
    make, err = None, None
    try:
        make = _group_maker(dist.PrefixStore(name, base), me, len(ranks),
                            backend)
    except Exception as e:  # noqa: BLE001 — every member is told below
        err = f"{type(e).__name__}: {e}"
    _agree_on_store(base, f"{name}/ready", ranks, me, err,
                    f"the sub-mesh group of ranks {list(ranks)} did not form")
    return make()


def _group_maker(store, me: int, size: int, backend: str):
    """What a member prepares of its group before the agreement (the
    options, gloo's device), and the call that then makes the group."""
    import datetime

    dist = _dist()
    form = datetime.timedelta(seconds=FORM_TIMEOUT_S)
    ops = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    if backend == "nccl":
        # NCCL's communicator forms at the group's first collective
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = ops
        return lambda: dist.ProcessGroupNCCL(store, me, size, opts)
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = form
    opts._devices = [dist.ProcessGroupGloo.create_default_device()]

    def make():
        pg = dist.ProcessGroupGloo(store, me, size, opts)
        pg._set_default_timeout(ops)
        return pg

    return make


def _agree_on_store(store, key: str, ranks: Tuple[int, ...], me: int,
                    err: Optional[str], what: str) -> None:
    """Post this member's outcome (``err`` None: it went well) under
    ``key`` and read every member's within ``FORM_TIMEOUT_S``; raise the
    same ``RuntimeError`` (``what`` and the failures) on every member that
    arrived when one failed, and on each when one never arrived. Through
    the store, not a communicator, which the failure may have left out of
    step."""
    import datetime

    store.set(f"{key}/{me}", "ok" if err is None else err)
    keys = [f"{key}/{i}" for i in range(len(ranks))]
    try:
        store.wait(keys, datetime.timedelta(seconds=FORM_TIMEOUT_S))
    except Exception as e:  # noqa: BLE001 — the store's timeout
        raise RuntimeError(f"{what}: a member did not arrive within "
                           f"{FORM_TIMEOUT_S} s") from e
    said = [store.get(k).decode() for k in keys]
    failed = {ranks[i]: v for i, v in enumerate(said) if v != "ok"}
    if failed:
        raise RuntimeError(f"{what}: {failed}")


_AGREEMENTS: Dict[Tuple[str, Tuple[int, ...]], int] = {}


def agree(mesh, what: str, err: Optional[BaseException] = None) -> None:
    """Every rank of ``mesh`` reports whether a step it took alone (``err``
    None: it went well) succeeded, through the process group's store, and
    every rank raises the same ``RuntimeError`` if one failed or did not
    arrive within ``FORM_TIMEOUT_S``. The ranks call it in one order (a
    count a step name and ranks keys each round). ``err`` itself is raised
    without a process group."""
    dist = _dist()
    if not dist.is_initialized():
        if err is not None:
            raise err
        return
    ranks = mesh.ranks
    n = _AGREEMENTS.get((what, ranks), 0)
    _AGREEMENTS[(what, ranks)] = n + 1
    try:
        _agree_on_store(
            dist.distributed_c10d._get_default_store(),
            f"mmlspark_agree/{what}/{'_'.join(map(str, ranks))}/{n}", ranks,
            mesh.index, None if err is None else f"{type(err).__name__}: "
            f"{err}", f"{what} failed on a rank of {list(ranks)}")
    except RuntimeError as e:
        raise e from err


def _local_rank(rank: int) -> int:
    env = os.environ.get("LOCAL_RANK")
    if env is not None:
        return int(env)
    return rank % max(torch.cuda.device_count(), 1)


def make_mesh(spec: Optional[MeshSpec] = None,
              device: Optional[Any] = None,
              backend: Optional[str] = None) -> Mesh:
    """This process's ``Mesh`` over the process group (started from the
    environment by ``initialize_distributed`` when there is none), with
    its group on every axis (``_make_groups``: every process of the group
    must call it, in the same order as the others).

    ``device``: default ``cuda:<local rank>`` (``LOCAL_RANK``, else the rank
    modulo the visible cards), or the CPU where ``runtime.use_device``
    asked for it. ``backend``: NCCL for a CUDA device, gloo for the CPU;
    ``"gloo"`` with a CUDA device must be asked for by name (several ranks
    on one card)."""
    from ..runtime import requested_device, resolve_device

    spec = spec or MeshSpec()
    dist = _dist()
    if device is not None:
        dev = resolve_device(device)
    else:
        dev = resolve_device(requested_device())
    want = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if want == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend runs on CUDA devices only")
    initialize_distributed(backend=want)
    world = process_count()
    sizes = spec.resolve(world)
    rank = process_index()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank(rank))
    group = None
    if world > 1:
        have = str(dist.get_backend()).lower()
        if have != want:
            group = dist.new_group(backend=want)
    groups = _make_groups(sizes, rank, world, group, want) \
        if dist.is_initialized() else {}
    return Mesh(shape=sizes, rank=rank, device=dev, backend=want,
                group=group, groups=groups, root=group)


def mesh_shards(mesh) -> int:
    """Data shards of ``mesh`` for the GBDT and VW fits: 1 for None, else
    the data axis of a port ``Mesh`` (the other axes replicate). Raises
    ``TypeError`` for anything else (a shard count, the reference's
    mesh)."""
    if mesh is None:
        return 1
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a mmlspark_tpu_torch.parallel.Mesh "
                        f"(make_mesh), got {type(mesh).__name__}")
    return mesh.size


def num_data_shards(mesh) -> int:
    return int(mesh.shape.get(DATA_AXIS, 1) * mesh.shape.get(FSDP_AXIS, 1))


def data_index(mesh) -> int:
    """This rank's block of the GBDT and VW fits: its data coordinate (0
    without a mesh)."""
    if mesh is None or mesh_shards(mesh) == 1:
        return 0
    return mesh.coord(DATA_AXIS)


def row_block(n: int, mesh) -> slice:
    """This rank's contiguous block of ``n`` rows (``n`` a multiple of the
    shard count): the rows the reference's shard of the same data index
    holds."""
    s = mesh_shards(mesh)
    if n % s:
        raise ValueError(f"{n} rows do not split into {s} equal blocks")
    r = data_index(mesh)
    return slice(r * (n // s), (r + 1) * (n // s))


def _data_group(mesh) -> Optional[AxisGroup]:
    """The group the GBDT and VW collectives run over: ``mesh``'s data
    axis (one of a single process too, so its backend runs); None (the
    identity) without a mesh, a process group or a data axis above 1."""
    mesh_shards(mesh)
    return axis_group(mesh, DATA_AXIS)


def collectives_capturable(mesh) -> bool:
    """Whether the data-axis collectives of ``mesh`` can be captured in a
    CUDA graph: NCCL's run on the card's streams; gloo's go through host
    memory (a host read); none at all (the identity) can."""
    return _data_group(mesh) is None or mesh.backend == "nccl"


def _staged(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where ``mesh``'s backend can run a collective on it: gloo on a
    CUDA tensor through host memory, NCCL on a host tensor through
    ``mesh.device``; ``t`` itself otherwise."""
    if mesh.backend == "gloo" and t.device.type == "cuda":
        return t.cpu()
    if mesh.backend == "nccl" and t.device.type != "cuda":
        return t.to(mesh.device)
    return t


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` over the data axis, in place, any dtype; returns ``t``.
    Every rank of the data group must call it, in the same order. The
    identity without a mesh, a process group or a data group."""
    g = _data_group(mesh)
    if g is None:
        return t
    dist = _dist()
    t0 = time.perf_counter()
    work = _staged(mesh, t)
    dist.all_reduce(work, op=dist.ReduceOp.SUM, group=g.handle)
    if work is not t:
        t.copy_(work)
    stats.calls += 1
    stats.bytes += t.numel() * t.element_size()
    stats.ms += (time.perf_counter() - t0) * 1e3
    return t


def all_gather(t: torch.Tensor, mesh,
               sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every data shard's ``t`` concatenated along dim 0 in data order (the
    rows of the whole data set for row blocks). ``sizes``: each shard's
    dim 0, when they differ (each rank knows them); equal by default. The
    identity without a mesh, a process group or a data group. The gather
    runs where the backend can (``_staged``) and returns a tensor on
    ``t``'s device."""
    g = _data_group(mesh)
    if g is None:
        return t
    s = g.size
    dist = _dist()
    t0 = time.perf_counter()
    me = data_index(mesh)
    sizes = [int(t.shape[0])] * s if sizes is None else [int(v) for v in sizes]
    if int(t.shape[0]) != sizes[me]:
        raise ValueError(f"data shard {me} holds {t.shape[0]} rows, sizes "
                         f"say {sizes[me]}")
    width = max(sizes)
    src = _staged(mesh, t.contiguous())
    if int(src.shape[0]) < width:
        pad = src.new_zeros((width - int(src.shape[0]), *src.shape[1:]))
        src = torch.cat([src, pad])
    parts = [torch.empty_like(src) for _ in range(s)]
    dist.all_gather(parts, src, group=g.handle)
    out = torch.cat([p[:n] for p, n in zip(parts, sizes)])
    stats.calls += 1
    stats.bytes += src.numel() * src.element_size()
    stats.ms += (time.perf_counter() - t0) * 1e3
    return out.to(t.device)


def fetch_global(x, mesh=None, sizes: Optional[Sequence[int]] = None):
    """Host numpy of a tensor (or a tuple/list of them) whose rows are split
    over the mesh's data axis: the blocks gathered in data order; a plain
    host copy for one shard. Collective for more than one: every rank of
    the data group calls it in lockstep."""
    if isinstance(x, (tuple, list)):
        return type(x)(fetch_global(a, mesh, sizes) for a in x)
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    return all_gather(x, mesh, sizes).cpu().numpy()


class MeshContext:
    """Process-wide default mesh, built lazily (a single-axis data mesh
    over the process group). Stages consult ``current`` (the mesh set
    explicitly), never the lazy one."""

    _default: Optional[Mesh] = None
    _explicit = False

    @classmethod
    def get(cls) -> Mesh:
        if cls._default is None:
            cls._default = make_mesh()  # lazy: does not count as explicit
        return cls._default

    @classmethod
    def current(cls) -> Optional[Mesh]:
        """The mesh ``set`` installed, or None (a lazily built one does not
        count, so 'no mesh configured' stays one shard)."""
        return cls._default if cls._explicit else None

    @classmethod
    def set(cls, mesh: Optional[Mesh]) -> None:
        cls._default = mesh
        cls._explicit = True

    @classmethod
    def reset(cls) -> None:
        cls._default = None
        cls._explicit = False


def explicit_mesh(num_workers: int) -> Optional[Mesh]:
    """The stages' worker topology: the mesh ``MeshContext.set`` installed
    when its data axis is larger than 1; None (one shard) otherwise, and
    always for ``numWorkers == 1``."""
    if num_workers == 1:
        return None
    mesh = MeshContext.current()
    if mesh is not None and mesh_shards(mesh) > 1:
        return mesh
    return None


# ---------------------------------------------------------------------------
# collectives on one axis, differentiable
# ---------------------------------------------------------------------------


def axis_group(mesh, axis: str) -> Optional[AxisGroup]:
    """``mesh``'s group on ``axis`` (an axis, ``BATCH`` or ``WORLD``), or
    None where the collective is the identity (no process group, or an
    axis of size 1 in a mesh of several processes)."""
    if mesh is None or not _dist().is_initialized():
        return None
    return mesh.groups.get(axis)


def _note(t: torch.Tensor, t0: float) -> None:
    stats.calls += 1
    stats.bytes += t.numel() * t.element_size()
    stats.ms += (time.perf_counter() - t0) * 1e3


_LOW = (torch.bfloat16, torch.float16)


def _gather_raw(t: torch.Tensor, mesh, g: AxisGroup, dim: int
                ) -> torch.Tensor:
    """Every rank's ``t`` of the group concatenated along ``dim``, in
    coordinate order. bf16 travels as float16 bits (gloo takes no bf16,
    and a gather moves bits only)."""
    t0 = time.perf_counter()
    src = _staged(mesh, t.contiguous())
    if src.dtype == torch.bfloat16:
        src = src.view(torch.float16)
    parts = [torch.empty_like(src) for _ in range(g.size)]
    _dist().all_gather(parts, src, group=g.handle)
    out = torch.cat(parts, dim=dim)
    if t.dtype == torch.bfloat16:
        out = out.view(t.dtype)
    _note(src, t0)
    return out.to(t.device)


def _sum_raw(t: torch.Tensor, mesh, g: AxisGroup) -> torch.Tensor:
    """The group's sum of ``t`` (a new tensor); 16-bit floats are summed
    in f32 and rounded once."""
    t0 = time.perf_counter()
    work = _staged(mesh, t.detach())
    work = work.to(torch.float32) if work.dtype in _LOW else work.clone()
    dist = _dist()
    dist.all_reduce(work, op=dist.ReduceOp.SUM, group=g.handle)
    _note(work, t0)
    return work.to(device=t.device, dtype=t.dtype)


def _scatter_raw(t: torch.Tensor, mesh, g: AxisGroup, dim: int
                 ) -> torch.Tensor:
    """The group's sum of ``t``, this rank's chunk of it along ``dim``
    (``reduce_scatter_tensor`` on NCCL; an all-reduce and its chunk on
    gloo, which has no reduce-scatter of its own)."""
    n = g.size
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {n} chunks")
    c = t.shape[dim] // n
    me = g.ranks.index(mesh.rank)
    if mesh.backend != "nccl":
        return _sum_raw(t, mesh, g).narrow(dim, me * c, c).contiguous()
    t0 = time.perf_counter()
    src = _staged(mesh, t.detach())
    wide = src.to(torch.float32) if src.dtype in _LOW else src
    wide = wide.movedim(dim, 0).contiguous()
    out = wide.new_empty((c,) + tuple(wide.shape[1:]))
    _dist().reduce_scatter_tensor(out, wide, group=g.handle)
    _note(wide, t0)
    return out.movedim(0, dim).to(device=t.device, dtype=t.dtype) \
        .contiguous()


def _shift_raw(t: torch.Tensor, mesh, g: AxisGroup, offset: int
               ) -> torch.Tensor:
    """``t`` of the rank ``offset`` places before this one on the group's
    ring (this rank's goes ``offset`` places on): one send and one receive
    a rank."""
    n = g.size
    if n == 1:
        return t.clone()
    dist = _dist()
    me = g.ranks.index(mesh.rank)
    t0 = time.perf_counter()
    src = _staged(mesh, t.contiguous())
    if src.dtype == torch.bfloat16:
        src = src.view(torch.float16)
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, g.ranks[(me + offset) % n], g.handle),
           dist.P2POp(dist.irecv, buf, g.ranks[(me - offset) % n], g.handle)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if t.dtype == torch.bfloat16:
        buf = buf.view(t.dtype)
    _note(src, t0)
    return buf.to(t.device)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, g, dim):
        ctx.mesh, ctx.g, ctx.dim = mesh, g, dim
        return _gather_raw(x, mesh, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_raw(grad, ctx.mesh, ctx.g, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, g, dim):
        ctx.mesh, ctx.g, ctx.dim = mesh, g, dim
        return _scatter_raw(x, mesh, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return _gather_raw(grad, ctx.mesh, ctx.g, ctx.dim), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, g):
        ctx.mesh, ctx.g = mesh, g
        return _sum_raw(x, mesh, g)

    @staticmethod
    def backward(ctx, grad):
        return _sum_raw(grad, ctx.mesh, ctx.g), None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, g, offset):
        ctx.mesh, ctx.g, ctx.offset = mesh, g, offset
        return _shift_raw(x, mesh, g, offset)

    @staticmethod
    def backward(ctx, grad):
        return _shift_raw(grad, ctx.mesh, ctx.g, -ctx.offset), None, None, \
            None


def all_gather_axis(x: torch.Tensor, mesh, axis: str, dim: int = 0
                    ) -> torch.Tensor:
    """The blocks of ``x`` along ``axis`` concatenated on ``dim``, in
    coordinate order; the backward is the reduce-scatter of the gradient.
    The identity where ``axis_group`` is None. Every rank of the group
    calls it, in the same order."""
    g = axis_group(mesh, axis)
    if g is None:
        return x
    return _AllGather.apply(x, mesh, g, dim % x.dim())


def reduce_scatter_axis(x: torch.Tensor, mesh, axis: str, dim: int = 0
                        ) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, this rank's chunk of it along
    ``dim``; the backward is the all-gather of the gradient."""
    g = axis_group(mesh, axis)
    if g is None:
        return x
    return _ReduceScatter.apply(x, mesh, g, dim % x.dim())


def all_reduce_axis(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (a new tensor); the backward sums the
    gradient over the same group: every rank's loss is a term of one sum
    (``training`` divides each rank's by its replicas)."""
    g = axis_group(mesh, axis)
    if g is None:
        return x
    return _AllReduce.apply(x, mesh, g)


def ring_shift(x: torch.Tensor, mesh, axis: str, offset: int = 1
               ) -> torch.Tensor:
    """``x`` of the rank ``offset`` places before this one on ``axis``'s
    ring (the reference's ``ppermute`` with ``(i, i + offset)`` pairs); the
    backward shifts the gradient back the other way."""
    g = axis_group(mesh, axis)
    if g is None:
        return x
    return _Shift.apply(x, mesh, g, int(offset))


def barrier(mesh) -> None:
    """Every rank of ``mesh`` has reached this call: a one-element sum over
    the world, read back on the host, so the caller waits for every rank
    (NCCL's collective alone returns before it runs, and a rank would read
    a file its partner is still writing); nothing without a process
    group."""
    g = axis_group(mesh, WORLD)
    if g is not None:
        _sum_raw(torch.zeros(1, device=mesh.device), mesh, g).item()


def gather_blocks(t: torch.Tensor, mesh, axis: str, dim: int,
                  sizes: Sequence[int]) -> torch.Tensor:
    """The blocks of ``t`` along ``axis`` concatenated on ``dim``, in
    coordinate order, where block i has ``sizes[i]`` entries on ``dim``
    (``np.array_split``'s blocks: they may differ by one). Each block is
    padded to the largest, gathered and cropped. The identity where the
    axis has no group. Every rank of the group calls it, in one order."""
    g = axis_group(mesh, axis)
    if g is None or g.size == 1:
        return t
    width = max(int(v) for v in sizes)
    src = t
    if int(t.shape[dim]) < width:
        pad = list(t.shape)
        pad[dim] = width - int(t.shape[dim])
        src = torch.cat([t, t.new_zeros(pad)], dim=dim)
    full = _gather_raw(src, mesh, g, dim)
    parts = [full.narrow(dim, i * width, int(n)) for i, n in enumerate(sizes)]
    return torch.cat(parts, dim=dim) if len(parts) > 1 else parts[0]


def any_failed(flag: int, mesh) -> int:
    """The largest of every rank's ``flag`` over ``mesh``'s ranks (0: all
    went well): the agreement a sharded segment reaches before a
    collective, so that a failure on one rank becomes the same decision on
    every rank instead of a partner left waiting. ``flag`` itself without
    a group."""
    g = axis_group(mesh, WORLD)
    if g is None or g.size == 1:
        return int(flag)
    dist = _dist()
    t0 = time.perf_counter()
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g.handle)
    _note(t, t0)
    return int(t.item())


def share_objects(obj: Any, mesh) -> List[Any]:
    """Every rank's ``obj`` (any picklable value), in mesh order, on every
    rank of ``mesh``: how the ranks of an SPMD program agree on a decision
    one of them makes (the Tuner's knob sets and verdicts, a pipe plan's
    stage costs) or learn that one of them failed. ``[obj]`` without a
    group, and on a rank outside the mesh: such a rank runs without the
    mesh's collectives, so nothing of it needs agreeing. Two all-gathers
    (the lengths, then the padded pickles) through the mesh's wire: the
    card on NCCL, host memory on gloo."""
    g = axis_group(mesh, WORLD)
    if g is None or g.size == 1:
        return [obj]
    dist = _dist()
    n = g.size
    t0 = time.perf_counter()
    wire = _wire(mesh)
    blob = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
    size = torch.tensor([blob.numel()], dtype=torch.int64, device=wire)
    sizes = [torch.empty_like(size) for _ in range(n)]
    dist.all_gather(sizes, size, group=g.handle)
    lengths = [int(s.item()) for s in sizes]
    buf = torch.zeros(max(lengths), dtype=torch.uint8, device=wire)
    buf[:blob.numel()] = blob.to(wire)
    bufs = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(bufs, buf, group=g.handle)
    _note(buf, t0)
    return [pickle.loads(b[:k].cpu().numpy().tobytes())
            for b, k in zip(bufs, lengths)]


# ---------------------------------------------------------------------------
# sub-meshes and rank-to-rank transfers (the fusion planners)
# ---------------------------------------------------------------------------


def sub_mesh(mesh: Mesh, members: Sequence[int],
             spec: Optional[MeshSpec] = None) -> Mesh:
    """The mesh of ``members`` (global ranks of ``mesh``, ascending) laid
    out by ``spec`` (default: one data axis over them). Its members call it
    in the same order (each of its groups is a ``dist.new_group`` among
    the group's members alone); a rank outside ``members`` gets the
    description with no group and takes no part. The result is kept on
    ``mesh``, so a second call with the same arguments makes no group."""
    members = tuple(int(r) for r in members)
    if list(members) != sorted(set(members)):
        raise ValueError(f"sub-mesh members {members} must ascend")
    if not set(members) <= set(mesh.ranks):
        raise ValueError(f"{members} are not all ranks of {mesh.ranks}")
    spec = spec or MeshSpec(data=len(members))
    sizes = spec.resolve(len(members))
    key = (members, tuple(sizes[a] for a in AXES))
    got = mesh._subs.get(key)
    if got is not None:
        return got
    dist = _dist()
    groups: Dict[str, AxisGroup] = {}
    if dist.is_initialized():
        if mesh.rank in members:
            groups = _make_groups(sizes, mesh.rank, process_count(),
                                  mesh.group, mesh.backend, members)
    else:
        # one process: its one-rank mesh is the only sub-mesh there is
        groups = dict(mesh.groups)
    whole = groups.get(WORLD)
    sub = Mesh(shape=sizes, rank=mesh.rank, device=mesh.device,
               backend=mesh.backend,
               group=whole.handle if whole is not None else mesh.group,
               groups=groups if mesh.rank in members else {},
               members=members, root=mesh.root)
    mesh._subs[key] = sub
    return sub


def mesh_topology(mesh) -> str:
    """Canonical topology string (axis sizes and the card's name): what a
    cache keyed by mesh shape folds into its fingerprint."""
    if mesh is None:
        return "none"
    axes = ",".join(f"{a}={int(mesh.shape.get(a, 1))}" for a in AXES)
    dev = torch.device(getattr(mesh, "device", "cpu"))
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return f"{axes};kind={kind}"


_ALIGN = 16   # bytes: each tensor of a transfer starts on this boundary


def _wire(mesh) -> torch.device:
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def send_tensors(tensors: Dict[str, torch.Tensor], dst: int, mesh,
                 meta: Any = None) -> int:
    """Send a dict of tensors (any dtypes and shapes, ``meta`` a picklable
    value beside them) to global rank ``dst``, which calls
    ``recv_tensors``. Three messages: the header's length, the header, one
    payload of every tensor's bytes; on NCCL from card to card, on gloo
    through host memory. Returns the payload's bytes."""
    dist = _dist()
    t0 = time.perf_counter()
    wire = _wire(mesh)
    head = [(k, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in tensors.items()]
    blob = pickle.dumps({"tensors": head, "meta": meta})
    hdr = torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(wire)
    dist.send(torch.tensor([hdr.numel()], dtype=torch.int64, device=wire),
              int(dst), group=mesh.root)
    dist.send(hdr, int(dst), group=mesh.root)
    chunks = []
    for t in tensors.values():
        b = t.detach().contiguous().reshape(-1).view(torch.uint8).to(wire)
        chunks.append(b)
        pad = -b.numel() % _ALIGN
        if pad:
            chunks.append(torch.zeros(pad, dtype=torch.uint8, device=wire))
    nbytes = sum(int(c.numel()) for c in chunks)
    if nbytes:
        payload = torch.cat(chunks) if len(chunks) > 1 else chunks[0]
        dist.send(payload, int(dst), group=mesh.root)
    stats.calls += 1
    stats.bytes += nbytes
    stats.ms += (time.perf_counter() - t0) * 1e3
    return nbytes


def recv_tensors(src: int, mesh) -> Tuple[Dict[str, torch.Tensor], Any]:
    """(tensors, meta) sent by global rank ``src`` with ``send_tensors``;
    the tensors on ``mesh.device``."""
    dist = _dist()
    t0 = time.perf_counter()
    wire = _wire(mesh)
    n = torch.empty(1, dtype=torch.int64, device=wire)
    dist.recv(n, int(src), group=mesh.root)
    hdr = torch.empty(int(n.item()), dtype=torch.uint8, device=wire)
    dist.recv(hdr, int(src), group=mesh.root)
    info = pickle.loads(hdr.cpu().numpy().tobytes())
    spans = []
    off = 0
    for name, shape, dt in info["tensors"]:
        dtype = getattr(torch, dt)
        k = int(np.prod(shape, dtype=np.int64)) * \
            torch.empty(0, dtype=dtype).element_size()
        spans.append((name, shape, dtype, off, k))
        off += k + (-k % _ALIGN)
    payload = torch.empty(off, dtype=torch.uint8, device=wire)
    if off:
        dist.recv(payload, int(src), group=mesh.root)
    out = {}
    for name, shape, dtype, start, k in spans:
        t = payload[start:start + k].view(dtype).reshape(shape)
        out[name] = t.to(mesh.device)
    stats.calls += 1
    stats.bytes += off
    stats.ms += (time.perf_counter() - t0) * 1e3
    return out, info["meta"]


# ---------------------------------------------------------------------------
# placements: which block of a tensor a rank holds
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """The reference's ``NamedSharding``: ``spec`` is its ``PartitionSpec``
    as a tuple, an axis name (or a tuple of them, split row-major) or None
    for each leading dim of a tensor; ``()`` replicates. ``mesh`` is the
    mesh it was made for (anything with the reference's ``shape``)."""

    spec: Tuple[Any, ...]
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    def axes(self) -> Tuple[str, ...]:
        out: List[str] = []
        for s in self.spec:
            if s is not None:
                out.extend(s if isinstance(s, tuple) else (s,))
        return tuple(out)

    def dim_of(self, axis: str) -> Optional[int]:
        """The dim ``axis`` splits, or None."""
        for i, s in enumerate(self.spec):
            if s == axis or (isinstance(s, tuple) and axis in s):
                return i
        return None

    def _split(self, entry, mesh) -> Tuple[int, int]:
        axes = entry if isinstance(entry, tuple) else (entry,)
        n, idx = 1, 0
        for a in axes:
            k = int(mesh.shape.get(a, 1))
            c = mesh.coord(a) if k > 1 else 0
            n, idx = n * k, idx * k + c
        return n, idx

    def local_slices(self, shape: Sequence[int], mesh=None) -> Tuple[slice, ...]:
        """This rank's block of a tensor of ``shape``."""
        mesh = mesh if mesh is not None else self.mesh
        out = []
        for i, size in enumerate(shape):
            entry = self.spec[i] if i < len(self.spec) else None
            if entry is None:
                out.append(slice(None))
                continue
            n, idx = self._split(entry, mesh)
            if size % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                                 f"into {n} blocks")
            c = size // n
            out.append(slice(idx * c, (idx + 1) * c))
        return tuple(out)

    def local(self, t, mesh=None):
        """This rank's block of ``t`` (a tensor or an array), contiguous."""
        blk = t[self.local_slices(t.shape, mesh)]
        if isinstance(blk, torch.Tensor):
            return blk.contiguous()
        return np.ascontiguousarray(blk)


def _map_tree(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def shard_tree(tree, shardings, mesh=None):
    """Each leaf's block on this rank (detached copies): the port's
    ``jax.device_put(tree, shardings)``."""
    def one(leaf, spec):
        with torch.no_grad():
            return spec.local(leaf, mesh).clone() \
                if isinstance(leaf, torch.Tensor) else spec.local(leaf, mesh)

    return _map_tree(one, tree, shardings)


def gather_tree(tree, shardings, mesh):
    """The whole leaves of a tree of blocks (``shard_tree``'s inverse): each
    split dim gathered over its axis. Collective: every rank calls it."""
    def one(leaf, spec):
        out = leaf.detach()
        for i, entry in enumerate(spec.spec):
            if entry is None:
                continue
            if isinstance(entry, tuple):
                raise ValueError("gather_tree takes one axis a dim")
            g = axis_group(mesh, entry)
            if g is not None and g.size > 1:
                out = _gather_raw(out, mesh, g, i)
        return out

    return _map_tree(one, tree, shardings)


__all__: List[str] = [
    "AXES", "AxisGroup", "BATCH", "CollectiveStats", "DATA_AXIS",
    "EXPERT_AXIS", "FSDP_AXIS", "Mesh", "MeshContext", "MeshSpec",
    "PIPE_AXIS", "SEQ_AXIS", "ShardSpec", "TENSOR_AXIS", "WORLD",
    "all_gather", "all_gather_axis", "all_reduce_axis", "all_reduce_sum",
    "agree", "any_failed", "axis_group", "barrier", "collectives_capturable",
    "coords_of", "data_index", "gather_blocks",
    "gather_tree", "mesh_topology", "recv_tensors", "reduce_scatter_axis",
    "ring_shift", "send_tensors", "shard_tree", "share_objects", "sub_mesh",
    "explicit_mesh", "fetch_global", "initialize_distributed", "make_mesh",
    "mesh_shards", "num_data_shards", "process_count", "process_index",
    "process_shard", "row_block", "stats"]
