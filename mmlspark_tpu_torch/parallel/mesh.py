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

Only the ``data`` axis is ported. A mesh whose ``fsdp``, ``tensor``,
``seq``, ``expert`` or ``pipe`` axis is larger than 1 is the DNN half of
ROADMAP A9 and raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence

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

_DNN_TODO = ("a mesh with an fsdp, tensor, seq, expert or pipe axis larger "
             "than 1 is the DNN half of multi-GPU work (ROADMAP A9): only the "
             "data axis is ported")


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


@dataclasses.dataclass(eq=False)
class Mesh:
    """One process's view of the mesh: ``shape`` maps every axis to its
    size (the reference's ``mesh.shape``), ``rank`` is this process's index
    on the data axis, ``device`` where its tensors live, ``backend`` and
    ``group`` the process group its collectives run on (None: the default
    group, or no group for one process)."""

    shape: Dict[str, int]
    rank: int = 0
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    backend: str = "gloo"
    group: Any = None

    @property
    def size(self) -> int:
        return int(self.shape.get(DATA_AXIS, 1))


def _check_axes(sizes: Dict[str, int]) -> None:
    if any(int(sizes.get(a, 1)) > 1 for a in AXES[1:]):
        raise NotImplementedError(_DNN_TODO)


def _local_rank(rank: int) -> int:
    env = os.environ.get("LOCAL_RANK")
    if env is not None:
        return int(env)
    return rank % max(torch.cuda.device_count(), 1)


def make_mesh(spec: Optional[MeshSpec] = None,
              device: Optional[Any] = None,
              backend: Optional[str] = None) -> Mesh:
    """This process's ``Mesh`` over the process group (started from the
    environment by ``initialize_distributed`` when there is none).

    ``device``: default ``cuda:<local rank>`` (``LOCAL_RANK``, else the rank
    modulo the visible cards), or the CPU where ``runtime.use_device``
    asked for it. ``backend``: NCCL for a CUDA device, gloo for the CPU;
    ``"gloo"`` with a CUDA device must be asked for by name (several ranks
    on one card). Raises ``NotImplementedError`` for any axis but ``data``
    larger than 1."""
    from ..runtime import requested_device, resolve_device

    spec = spec or MeshSpec()
    _check_axes(dataclasses.asdict(spec))
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
    return Mesh(shape=sizes, rank=rank, device=dev, backend=want,
                group=group)


def mesh_shards(mesh) -> int:
    """Data shards of ``mesh``: 1 for None, else the data axis of a port
    ``Mesh``. Raises ``TypeError`` for anything else (a shard count, the
    reference's mesh) and ``NotImplementedError`` for an axis other than
    ``data`` larger than 1."""
    if mesh is None:
        return 1
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a mmlspark_tpu_torch.parallel.Mesh "
                        f"(make_mesh), got {type(mesh).__name__}")
    _check_axes(mesh.shape)
    return mesh.size


def num_data_shards(mesh) -> int:
    return int(mesh.shape.get(DATA_AXIS, 1) * mesh.shape.get(FSDP_AXIS, 1))


def row_block(n: int, mesh) -> slice:
    """This rank's contiguous block of ``n`` rows (``n`` a multiple of the
    shard count): the rows the reference's shard of the same index holds."""
    s = mesh_shards(mesh)
    if n % s:
        raise ValueError(f"{n} rows do not split into {s} equal blocks")
    r = mesh.rank if mesh is not None else 0
    return slice(r * (n // s), (r + 1) * (n // s))


def _active(mesh) -> bool:
    """Do collectives run for ``mesh``: a port ``Mesh`` in a process group
    (one of a single process too, so its backend runs)."""
    mesh_shards(mesh)
    return mesh is not None and _dist().is_initialized()


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
    Every process must call it, in the same order. The identity without a
    mesh or a process group."""
    if not _active(mesh):
        return t
    dist = _dist()
    t0 = time.perf_counter()
    work = _staged(mesh, t)
    dist.all_reduce(work, op=dist.ReduceOp.SUM, group=mesh.group)
    if work is not t:
        t.copy_(work)
    stats.calls += 1
    stats.bytes += t.numel() * t.element_size()
    stats.ms += (time.perf_counter() - t0) * 1e3
    return t


def all_gather(t: torch.Tensor, mesh,
               sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in rank order (the rows
    of the whole data set for row blocks). ``sizes``: each rank's dim 0,
    when they differ (each rank knows them); equal by default. The
    identity without a mesh or a process group. The gather runs where the
    backend can (``_staged``) and returns a tensor on ``t``'s device."""
    if not _active(mesh):
        return t
    s = mesh_shards(mesh)
    dist = _dist()
    t0 = time.perf_counter()
    sizes = [int(t.shape[0])] * s if sizes is None else [int(v) for v in sizes]
    if int(t.shape[0]) != sizes[mesh.rank]:
        raise ValueError(f"rank {mesh.rank} holds {t.shape[0]} rows, sizes "
                         f"say {sizes[mesh.rank]}")
    width = max(sizes)
    src = _staged(mesh, t.contiguous())
    if int(src.shape[0]) < width:
        pad = src.new_zeros((width - int(src.shape[0]), *src.shape[1:]))
        src = torch.cat([src, pad])
    parts = [torch.empty_like(src) for _ in range(s)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat([p[:n] for p, n in zip(parts, sizes)])
    stats.calls += 1
    stats.bytes += src.numel() * src.element_size()
    stats.ms += (time.perf_counter() - t0) * 1e3
    return out.to(t.device)


def fetch_global(x, mesh=None, sizes: Optional[Sequence[int]] = None):
    """Host numpy of a tensor (or a tuple/list of them) whose rows are split
    over the mesh: the blocks gathered in rank order; a plain host copy for
    one shard. Collective for more than one: every process calls it in
    lockstep."""
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


__all__: List[str] = [
    "AXES", "CollectiveStats", "DATA_AXIS", "EXPERT_AXIS", "FSDP_AXIS",
    "Mesh", "MeshContext", "MeshSpec", "PIPE_AXIS", "SEQ_AXIS",
    "TENSOR_AXIS", "all_gather", "all_reduce_sum",
    "explicit_mesh", "fetch_global", "initialize_distributed", "make_mesh",
    "mesh_shards", "num_data_shards", "process_count", "process_index",
    "process_shard", "row_block", "stats"]
