"""Pipeline-parallel mesh execution: fused segments resident on disjoint
``pipe``-axis sub-meshes, micro-batches streamed rank to rank.

Counterpart of the reference's ``mmlspark_tpu/parallel/pipeplan.py``:

  - ``build_pipe_plan(nodes, mesh, depth)`` re-cuts the fused plan at its
    clean device-to-device boundaries (``split_segments``), finds the
    longest run of consecutive segments whose device outputs the next can
    consume directly (``chainable``), groups it into at most
    ``min(depth, pipe)`` contiguous stages balanced by
    ``SegmentCostModel.predict_ms`` (equal-count while uncalibrated), and
    gives each stage a sub-mesh split along the pipe axis with the other
    axes kept, so a ``data`` or ``feature`` spec still composes inside a
    stage (``PipeStageSharding.inner``).
  - ``PipeStageSharding`` runs a stage replicated over its ranks: the same
    program on the same micro-batch on each, so the bits match the serial
    chain.
  - ``PipeRunner`` streams stage 0's padded micro-batches through the
    stages. The reference's single controller reshards device arrays from
    one sub-mesh to the next; the port's mesh is one process a rank, so
    each rank runs its own stage's segments and hands every segment output
    so far to its partner in the next stage (``mesh.send_tensors``: NCCL
    card to card, gloo through host memory), then takes the next
    micro-batch. A rank keeps at most ``depth + 1`` micro-batches of
    readbacks in flight. The measured handoffs feed the cost model's
    ``pipe_handoff`` collective fit. At the end of a partition the last
    stage holds every segment's readbacks and sends them to the other
    ranks of its chain, so every rank emits and returns the same frame.
  - A stage that fails mid-stream (the ``pipe.stage_wedge`` chaos seam,
    which every rank fires in the same order, or a dispatch or handoff
    failure on one rank, which travels down the chain with the
    micro-batches and back with the results) raises :class:`StageWedged`
    on every rank; the model quarantines the stage's ranks
    (``PipeSupervision`` -> ``ReplicaSupervisor.note_stage_wedged``),
    re-plans at depth N-1 on the survivors (``degrade_after_wedge``) and
    re-runs the frame. A rank left out of the new mesh runs the frame
    serially: the answer is bitwise the same.

A partition the streaming contract cannot hold (no valid rows, a dtype
gate of a downstream segment) runs the plain serial executor chain on
every rank: slower, never wrong.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import faults
from .mesh import (PIPE_AXIS, MeshSpec, any_failed, recv_tensors,
                   send_tensors, sub_mesh)

__all__ = [
    "PIPE_HANDOFF_OP", "StageWedged", "chainable", "chainable_runs",
    "split_segments", "pipe_submeshes", "balance_stages",
    "build_pipe_plan", "pipe_run", "place_pipe_run", "PipeRun", "PipeStage",
    "PipePlan", "PipeStageSharding", "stage_sharding_for", "PipeRunner",
    "degrade_after_wedge", "PipeSupervision",
]

#: collective-fit key of the measured inter-stage handoff
#: (costmodel.observe_collective / collective_ms)
PIPE_HANDOFF_OP = "pipe_handoff"


class StageWedged(RuntimeError):
    """A pipeline stage's ranks failed mid-stream: a placement failure. The
    model quarantines the stage and re-plans at depth N-1 before re-running
    (a contract violation of one partition runs the serial chain
    instead)."""

    def __init__(self, stage: int, reason: str = ""):
        super().__init__(reason or f"pipeline stage {stage} wedged")
        self.stage = int(stage)


# ---------------------------------------------------------------------------
# plan derivation
# ---------------------------------------------------------------------------


def chainable(prev, nxt) -> bool:
    """Whether ``nxt``'s fused program can consume ``prev``'s device outputs
    directly: every external input of ``nxt`` is a device readback of
    ``prev`` (not one of its host-only columns), the final writer of each
    has no host ``finalize`` (so the device value is the column value), and
    no stage of ``nxt`` has a host ``prepare``."""
    try:
        readback = {k for k, _ in prev.readback_plan(())}
    except Exception:  # noqa: BLE001 — unplannable segment: not chainable
        return False
    avail = readback - set(prev.host_cols)
    ext = list(nxt.external_in_cols)
    if not ext or not set(ext) <= avail:
        return False
    final_writer: Dict[str, Any] = {}
    for dfn in prev.dfns:
        for c in dfn.out_cols:
            final_writer[c] = dfn
    for c in ext:
        writer = final_writer.get(c)
        if writer is None or writer.finalize is not None:
            return False
    return all(dfn.prepare is None for dfn in nxt.dfns)


def chainable_runs(nodes: Sequence[Any]
                   ) -> List[List[Tuple[int, Any]]]:
    """Maximal runs of at least 2 consecutive plan nodes that are all fused
    Segments, each adjacent pair chainable, as (node index, segment)
    lists: the candidate pipelines of a plan (``build_pipe_plan`` and the
    Tuner's depth proposal)."""
    runs: List[List[Tuple[int, Any]]] = []
    cur: List[Tuple[int, Any]] = []
    for j, node in enumerate(nodes):
        if hasattr(node, "dfns"):
            if cur and cur[-1][0] == j - 1 and chainable(cur[-1][1], node):
                cur.append((j, node))
                continue
            if len(cur) >= 2:
                runs.append(cur)
            cur = [(j, node)]
        else:
            if len(cur) >= 2:
                runs.append(cur)
            cur = []
    if len(cur) >= 2:
        runs.append(cur)
    return runs


def split_segments(nodes: Sequence[Any]) -> List[Any]:
    """The pipeline view of a fused plan: every fused Segment re-cut at each
    clean device-to-device boundary (the next DeviceFn has no host
    ``prepare`` and the handoff columns are finalize-free readbacks) into
    maximal chainable sub-segments. A single-device plan fuses a chain into
    one segment; a pipeline wants the opposite cut, so each stage can live
    on its own sub-mesh. Each sub-segment runs the same DeviceFns in the
    same order, so serial semantics are unchanged. Host stages,
    single-stage segments and stitched segments pass through."""
    out: List[Any] = []
    for node in nodes:
        dfns = getattr(node, "dfns", None)
        if (not dfns or len(dfns) < 2
                or getattr(node, "host_cols", None)):
            out.append(node)
            continue
        out.extend(_split_one(node))
    return out


def _split_one(seg) -> List[Any]:
    """Cut one fused segment at every DeviceFn that can head its own
    program, then merge back any adjacent pair ``chainable`` rejects."""
    groups: List[List[int]] = [[0]]
    for i in range(1, len(seg.dfns)):
        if seg.dfns[i].prepare is None:
            groups.append([i])
        else:
            groups[-1].append(i)
    if len(groups) == 1:
        return [seg]

    def build(idxs: List[int]):
        sub = type(seg)()
        for i in idxs:
            sub.add(seg.stages[i], seg.dfns[i])
        return sub

    merged = [build(groups[0])]
    gidx = [list(groups[0])]
    for g in groups[1:]:
        sub = build(g)
        if chainable(merged[-1], sub):
            merged.append(sub)
            gidx.append(list(g))
        else:
            gidx[-1].extend(g)
            merged[-1] = build(gidx[-1])
    if len(merged) == 1:
        return [seg]
    return merged


def pipe_submeshes(mesh, depth: int) -> Optional[List[Any]]:
    """``depth`` disjoint sub-meshes of ``mesh`` along the pipe axis, every
    other axis kept: stage i owns pipe coordinate group i. None when the
    pipe axis cannot cover ``depth`` stages."""
    depth = int(depth)
    shape = dict(getattr(mesh, "shape", {}) or {})
    p = int(shape.get(PIPE_AXIS, 1))
    axes = list(getattr(mesh, "axis_names", ()) or ())
    if depth < 2 or p < depth or PIPE_AXIS not in axes:
        return None
    arr = np.asarray(mesh.devices)
    pipe_idx = axes.index(PIPE_AXIS)
    sizes = {a: int(shape.get(a, 1))
             for a in ("data", "fsdp", "tensor", "seq", "expert")}
    out = []
    for group in np.array_split(np.arange(p), depth):
        sub = np.take(arr, group, axis=pipe_idx)
        # the pipe axis is the fastest: the block's ranks ascend in order
        out.append(sub_mesh(mesh, [int(r) for r in sub.flat],
                            MeshSpec(pipe=len(group), **sizes)))
    return out


def balance_stages(costs: Sequence[Optional[float]], depth: int
                   ) -> List[int]:
    """Contiguous stage sizes for a segment run: with every ``predict_ms``
    known, the split minimising the largest stage sum (the pipeline's
    clock); with any unknown, the equal-count split."""
    n = len(costs)
    depth = max(1, min(int(depth), n))
    if any(c is None for c in costs):
        return [len(g) for g in np.array_split(np.arange(n), depth)]
    import itertools
    best: Optional[Tuple[int, ...]] = None
    best_max = float("inf")
    for cuts in itertools.combinations(range(1, n), depth - 1):
        bounds = (0,) + cuts + (n,)
        clock = max(sum(float(c) for c in costs[a:b])
                    for a, b in zip(bounds, bounds[1:]))
        if clock < best_max - 1e-12:
            best, best_max = bounds, clock
    if best is None:  # unreachable: depth <= n guarantees one composition
        raise RuntimeError("balance_stages found no contiguous split")
    return [b - a for a, b in zip(best, best[1:])]


@dataclasses.dataclass
class PipeStage:
    """One pipeline stage: a contiguous group of fused segments resident on
    one pipe-axis sub-mesh."""

    index: int
    seg_nodes: Tuple[int, ...]  # plan-node indices of the member segments
    labels: Tuple[str, ...]
    mesh: Any
    predicted_ms: Optional[float] = None

    def device_ids(self) -> List[int]:
        """The stage's ranks (a rank stands for its card)."""
        return [int(r) for r in self.mesh.ranks]

    def describe(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"index": int(self.index),
                               "segments": list(self.labels),
                               "devices": self.device_ids()}
        if self.predicted_ms is not None:
            out["predicted_ms"] = round(float(self.predicted_ms), 4)
        return out


class PipePlan:
    """Placement of one run of chainable fused segments onto pipe-axis
    stages. ``nodes`` is the pipeline view of the plan
    (``split_segments``); ``first``/``last`` bound the run inside it
    (half-open); ``stage_of`` maps each member node index to its stage;
    ``mesh`` is the mesh the stages were cut from (its process group
    carries the handoffs)."""

    def __init__(self, stages: Sequence[PipeStage], first: int, last: int,
                 nodes: Optional[Sequence[Any]] = None, mesh=None):
        self.stages = list(stages)
        self.first = int(first)
        self.last = int(last)
        self.nodes = list(nodes) if nodes is not None else None
        self.mesh = mesh
        self.depth = len(self.stages)
        self.stage_of: Dict[int, int] = {
            n: st.index for st in self.stages for n in st.seg_nodes}

    def my_stage(self) -> Optional[int]:
        """The stage this rank belongs to (None: outside the plan's mesh)."""
        for st in self.stages:
            if getattr(st.mesh, "is_member", True):
                return st.index
        return None

    def describe(self) -> Dict[str, Any]:
        return {"depth": self.depth,
                "stages": [st.describe() for st in self.stages]}


class PipeRun(NamedTuple):
    """The host half of a pipe plan (``pipe_run``): the pipeline view, its
    run of chainable segments as ``(view index, segment)`` pairs, the stage
    count and each run segment's ``predict_ms`` (None: uncalibrated)."""

    nodes: List[Any]
    run: List[Tuple[int, Any]]
    depth: int
    costs: List[Optional[float]]


def pipe_run(nodes: Sequence[Any], mesh, depth: int, model=None,
             batch: Optional[int] = None) -> Optional[PipeRun]:
    """What ``build_pipe_plan`` decides on the host, with no collective:
    the pipeline view (``split_segments``), its longest (first on a tie)
    run of at least two chainable segments, ``min(depth, pipe, run
    length)`` stages and the run's ``predict_ms`` costs. None = stay
    serial: no pipe axis to split, no eligible run, or depth below 2 after
    clamping."""
    if mesh is None:
        return None
    shape = dict(getattr(mesh, "shape", {}) or {})
    p = int(shape.get(PIPE_AXIS, 1))
    if p < 2 or int(depth) < 2:
        return None
    nodes = split_segments(nodes)
    runs = chainable_runs(nodes)
    if not runs:
        return None
    run = max(runs, key=len)
    depth_eff = min(int(depth), p, len(run))
    if depth_eff < 2:
        return None
    b = int(batch) if batch else run[0][1].batch_size()
    costs: List[Optional[float]] = []
    for _, seg in run:
        ms = None
        if model is not None:
            try:
                if model.calibrated(seg.label):
                    ms = model.predict_ms(seg.label, batch=b)
            except Exception:  # noqa: BLE001 — balance falls back to count
                ms = None
        costs.append(ms)
    return PipeRun(nodes, run, depth_eff, costs)


def place_pipe_run(prep: PipeRun, mesh) -> Optional["PipePlan"]:
    """The PipePlan of a ``pipe_run``: its stages balanced by
    ``prep.costs``, each on its pipe-axis sub-mesh (made by the stage's
    members: collective among them). None when the pipe axis cannot cover
    the stages."""
    submeshes = pipe_submeshes(mesh, prep.depth)
    if submeshes is None:
        return None
    run, costs = prep.run, prep.costs
    sizes = balance_stages(costs, prep.depth)
    stages: List[PipeStage] = []
    k = 0
    for si, size in enumerate(sizes):
        chunk = run[k:k + size]
        chunk_costs = costs[k:k + size]
        k += size
        pred = sum(chunk_costs) \
            if all(c is not None for c in chunk_costs) else None
        stages.append(PipeStage(
            index=si, seg_nodes=tuple(j for j, _ in chunk),
            labels=tuple(seg.label for _, seg in chunk),
            mesh=submeshes[si], predicted_ms=pred))
    return PipePlan(stages, first=run[0][0], last=run[-1][0] + 1,
                    nodes=prep.nodes, mesh=mesh)


def build_pipe_plan(nodes: Sequence[Any], mesh, depth: int,
                    model=None, batch: Optional[int] = None
                    ) -> Optional["PipePlan"]:
    """A PipePlan from a fused plan: the pipeline view
    (``split_segments``), its longest (first on a tie) run of at least two
    chainable segments, grouped into ``min(depth, pipe, run length)``
    stages balanced by ``predict_ms``, each with its sub-mesh. The plan's
    ``nodes`` is that view: the executor runs it, not the original plan.
    None = stay serial: no pipe axis to split, no eligible run, or depth
    below 2 after clamping. ``pipe_run`` then ``place_pipe_run``: an SPMD
    caller agrees on the first's costs between the two
    (``FusedPipelineModel._pipe_plan_for``)."""
    prep = pipe_run(nodes, mesh, depth, model=model, batch=batch)
    return None if prep is None else place_pipe_run(prep, mesh)


# ---------------------------------------------------------------------------
# stage placement handle
# ---------------------------------------------------------------------------


class PipeStageSharding:
    """Executor-facing placement of one segment of a pipeline stage, with
    the interface of ``shardplan.SegmentSharding``. By default the stage
    runs replicated over its sub-mesh (each of its ranks computes the whole
    micro-batch on its card: the serial program, so pipelined replies are
    bitwise the serial chain's). A tuned ``inner`` SegmentSharding,
    resolved against the sub-mesh, composes on top and carries the sharded
    (allclose) contract."""

    def __init__(self, segment, submesh, stage_index: int, depth: int,
                 inner=None):
        self.segment = segment
        self.mesh = submesh
        self.stage_index = int(stage_index)
        self.depth = int(depth)
        self.inner = inner
        self.device_ids = tuple(int(r) for r in submesh.ranks)

    @property
    def shards(self) -> int:
        return self.inner.shards if self.inner is not None else 1

    @property
    def splits(self) -> bool:
        """Whether a rank stages only a block of each batch."""
        return self.inner is not None

    def cache_key(self) -> Tuple:
        """Program-cache key tail: a stage's program is keyed apart from the
        single-device one, from other stages and from a re-planned
        placement of the same stage (the ranks pin the sub-mesh)."""
        tail = ("pipe", self.stage_index, self.depth, self.device_ids)
        if self.inner is not None:
            return self.inner.cache_key() + tail
        return tail

    def shape_prefix(self) -> str:
        """``pipe=s<i>of<d>;`` before the shape key, so the cost model's
        bucket parser skips stage records."""
        pre = self.inner.shape_prefix() if self.inner is not None else ""
        return f"pipe=s{self.stage_index}of{self.depth};" + pre

    def put_params(self, params):
        if self.inner is not None:
            return self.inner.put_params(params)
        return params

    def device_put(self, arrays: Dict[str, Any], device):
        """Stage one host batch (stage 0 of the stream)."""
        if self.inner is not None:
            return self.inner.device_put(arrays, device)
        from .ingest import stage_array

        return {c: stage_array(v, device) for c, v in arrays.items()}

    def reshard(self, tensors: Dict[str, Any]) -> Dict[str, Any]:
        """A handoff that arrived whole on this rank's card, as this stage
        stages it: whole (replicated), or this rank's block (inner)."""
        if self.inner is not None:
            return self.inner.reshard(tensors)
        return tensors

    def run(self, program, params, x, full_shapes):
        if self.inner is not None:
            return self.inner.run(program, params, x, full_shapes)
        return program(params, x)

    def run_many(self, program, params, xs, full_shapes):
        if self.inner is not None:
            return self.inner.run_many(program, params, xs, full_shapes)
        return program(params, tuple(xs))

    def describe(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"stage": self.stage_index,
                               "depth": self.depth,
                               "devices": list(self.device_ids)}
        if self.inner is not None:
            out["spec"] = self.inner.describe()
        return out


def stage_sharding_for(segment, stage: PipeStage, depth: int,
                       spec_name: Optional[str] = None
                       ) -> PipeStageSharding:
    """The segment's stage placement, composing its tuned partition spec
    (resolved against the stage's sub-mesh) when one is named and
    resolvable; otherwise the replicated (bitwise) placement. The stage's
    ranks agree (``mesh.any_failed``): a resolution that failed on one of
    them leaves every one of them replicated."""
    inner = None
    if spec_name:
        from .shardplan import sharding_for

        failed = 0
        try:
            inner = sharding_for(segment, stage.mesh, spec_name)
        except Exception:  # noqa: BLE001 — degrade to replicated stage
            failed = 1
        if any_failed(failed, stage.mesh):
            inner = None
    return PipeStageSharding(segment, stage.mesh, stage.index, depth,
                             inner=inner)


# ---------------------------------------------------------------------------
# streaming runner
# ---------------------------------------------------------------------------


def _chain_sender(pplan: PipePlan, stage: int, index: int) -> int:
    """The global rank of stage ``stage - 1`` that feeds the rank at
    ``index`` of stage ``stage``."""
    prev = pplan.stages[stage - 1].mesh.ranks
    return int(prev[index % len(prev)])


def _chain_receivers(pplan: PipePlan, stage: int, index: int) -> List[int]:
    """The global ranks of stage ``stage + 1`` the rank at ``index`` of
    stage ``stage`` feeds."""
    here = len(pplan.stages[stage].mesh.ranks)
    nxt = pplan.stages[stage + 1].mesh.ranks
    return [int(r) for j, r in enumerate(nxt) if j % here == index]


class PipeRunner:
    """Streams micro-batches through the pipelined segment chain, one
    stage a rank (SPMD: every rank of the plan's mesh runs it on the same
    frame).

    Every rank preps each partition as the serial path does (the same
    micro-batch boundaries and padding; the emit needs the partition's
    validity and host context). Stage 0's ranks stage the batches; every
    later stage takes its inputs from the previous stage's handoff. A
    handoff carries every segment output so far, padded, keyed
    ``"<segment>/<key>"``, with the micro-batch's valid rows and the
    stream's status. The last stage keeps the readbacks (at most
    ``window`` micro-batches in flight on the card) and, at the end of the
    partition, sends them with the status to every other rank of its
    chain. ``serial`` are plain executors of the same segments: the chain a
    partition falls back to on every rank."""

    def __init__(self, pplan: PipePlan, executors: Sequence[Any],
                 stats: Sequence[Any], cost_model=None,
                 window: Optional[int] = None,
                 serial: Optional[Sequence[Any]] = None):
        self.pplan = pplan
        self.mesh = pplan.mesh
        self.execs = list(executors)
        self.serial = list(serial) if serial is not None else self.execs
        self.stats = list(stats)
        self.cost_model = cost_model
        self.window = max(1, int(window)) if window else pplan.depth + 1
        node_order = sorted(pplan.stage_of)
        #: chain position (0..n_segments-1) -> stage index
        self.seg_stage = [pplan.stage_of[j] for j in node_order]
        self.stage = pplan.my_stage()
        if self.stage is None:
            raise ValueError("this rank is in no stage of the pipe plan")
        self.index = pplan.stages[self.stage].mesh.index
        self.micro_batches = 0
        self.partitions = 0
        self.serial_parts = 0
        self.busy_s = [0.0] * pplan.depth
        self.handoff_bytes = [0.0] * pplan.depth
        self.handoff_s = [0.0] * pplan.depth
        self.wall_s = 0.0

    # -- public entry ------------------------------------------------------

    def run(self, df):
        from ..core.device_stage import FusionUnsupported
        from ..core.fusion import _HostFallback

        t0 = time.perf_counter()
        params = [ex.sharding.put_params(tuple(d.params
                                               for d in ex.segment.dfns))
                  for ex in self.execs]
        parts_per_seg: List[List[Dict[str, np.ndarray]]] = \
            [[] for _ in self.execs]
        for part in df.partitions:
            self.partitions += 1
            try:
                outs = self._run_partition(dict(part), params)
                for lst, p in zip(parts_per_seg, outs):
                    lst.append(p)
            except StageWedged:
                raise
            except (_HostFallback, FusionUnsupported):
                # decided alike on every rank: the serial chain, bitwise
                # the unpipelined answer, its waste counted
                self._serial_partition(part, df.schema, parts_per_seg)
        out = df
        for ex, parts in zip(self.execs, parts_per_seg):
            out = ex._overlay(out, parts)
        self.wall_s += time.perf_counter() - t0
        return out

    # -- per-partition streaming ------------------------------------------

    def _serial_partition(self, part, schema, parts_per_seg) -> None:
        from ..core.dataframe import DataFrame

        self.serial_parts += 1
        sub = DataFrame([dict(part)], schema.copy())
        for j, ex in enumerate(self.serial):
            sub = ex.run(sub, self.stats[j])
            parts_per_seg[j].extend(sub.partitions)

    def _fire_seams(self) -> None:
        """The ``pipe.stage_wedge`` seam of one micro-batch, in the
        reference's order (stage 0's dispatch, then each stage boundary),
        on every rank alike: an armed injection wedges the same stage at
        the same micro-batch on every rank, before its handoffs."""
        stages = [self.seg_stage[0]] + [
            sj for sj, sp in zip(self.seg_stage[1:], self.seg_stage)
            if sj != sp]
        for s in stages:
            try:
                faults.fire(faults.PIPE_STAGE_WEDGE, stage=int(s))
            except Exception as e:  # noqa: BLE001 — any armed exc wedges
                raise StageWedged(int(s), str(e))

    def _run_partition(self, part: Dict[str, np.ndarray], params
                       ) -> List[Dict[str, np.ndarray]]:
        from ..core.fusion import _HostFallback

        ex0 = self.execs[0]
        state0 = ex0._prep_partition(part, self.stats[0])
        if state0["n_valid"] <= 0:
            raise _HostFallback("no valid rows to stream")
        states = [state0]
        for ex in self.execs[1:]:
            seg = ex.segment
            readback = seg.readback_plan(ex._transpiled)
            # the inputs arrive from the previous stage: no host part, no
            # validity scan, no prepare; _emit_chain fills part/valid/n
            states.append({
                "part": None, "sub": {}, "ctx": {}, "valid": None,
                "n": None, "n_valid": None,
                "ext": list(seg.external_in_cols),
                "staged_cols": list(seg.external_in_cols),
                "readback": readback,
                "keys": [k for k, _ in readback]})
        mine = [j for j, s in enumerate(self.seg_stage) if s == self.stage]
        steps = {j: self.execs[j]._make_step(params[j], states[j])
                 for j in mine}
        last = self.pplan.depth - 1
        n_micro = -(-state0["n_valid"] // ex0.segment.batch_size())
        collected: List[Dict[str, List[np.ndarray]]] = \
            [{k: [] for k in st["keys"]} for st in states]
        status: Optional[Tuple] = None
        inflight: deque = deque()
        src, filler = (ex0._fill_ahead(state0, self.stats[0])
                       if self.stage == 0 else (None, None))
        try:
            for k in range(n_micro):
                self._fire_seams()
                self.micro_batches += 1
                outs, m, status = self._micro_batch(
                    k, src, steps, states, mine, status)
                if self.stage < last:
                    self._hand_on(outs, m, status)
                elif status is None:
                    inflight.append((m, outs))
                    while len(inflight) > self.window:
                        self._collect(inflight.popleft(), collected)
            while inflight:
                self._collect(inflight.popleft(), collected)
        finally:
            if filler is not None:
                filler.close()
        collected, status = self._share_results(collected, states, status)
        if status is not None:
            if status[0] == "fallback":
                raise _HostFallback(status[1])
            raise StageWedged(int(status[1]), status[2])
        return self._emit_chain(states, collected)

    def _micro_batch(self, k, src, steps, states, mine, status):
        """This rank's part of micro-batch ``k``: stage 0 stages it from the
        host, a later stage receives it; then this stage's segments run.
        Returns (every segment output so far by (segment, key), valid rows,
        the stream's status). A failure here becomes the status, which
        travels on with the micro-batches (the protocol goes on, so no
        partner is left waiting)."""
        from ..core.device_stage import FusionUnsupported
        from ..core.fusion import _HostFallback
        from .ingest import BatchTiming, timed_stage

        outs: Dict[Tuple[int, str], torch.Tensor] = {}
        env: Dict[str, torch.Tensor] = {}
        staged = None
        if self.stage == 0:
            batch = next(src)
            m = int(batch.num_valid)
            if status is None:
                try:
                    staged, timing0 = timed_stage(self.execs[0]._put, batch)
                except Exception as e:  # noqa: BLE001 — the stage failed
                    status = ("wedged", 0, f"stage 0 staging failed: {e}")
        else:
            sender = _chain_sender(self.pplan, self.stage, self.index)
            t1 = time.perf_counter()
            got, meta = recv_tensors(sender, self.mesh)
            dt = time.perf_counter() - t1
            m = int(meta["m"])
            if status is None and meta["status"] is not None:
                status = tuple(meta["status"])
            nbytes = float(sum(t.numel() * t.element_size()
                               for t in got.values()))
            self.handoff_s[self.stage] += dt
            self.handoff_bytes[self.stage] += nbytes
            if self.cost_model is not None and nbytes > 0:
                obs = getattr(self.cost_model, "observe_collective", None)
                if callable(obs):
                    try:
                        obs(PIPE_HANDOFF_OP, nbytes, dt)
                    except Exception:  # noqa: BLE001 — observation only
                        pass
            for name in sorted(got, key=lambda s: int(s.split("/", 1)[0])):
                j, key = name.split("/", 1)
                outs[(int(j), key)] = got[name]
                env[key] = got[name]
        if status is not None:
            return outs, m, status
        for j in mine:
            sj = self.seg_stage[j]
            ex = self.execs[j]
            t2 = time.perf_counter()
            try:
                if j == 0:
                    handle = steps[0](staged)
                    timing = timing0
                else:
                    xs = {c: env[c] for c in states[j]["ext"]}
                    full = {c: tuple(v.shape) for c, v in xs.items()}
                    if k == 0:
                        self._check_gates(j, xs)
                    timing = BatchTiming(rows=m)
                    if xs:
                        timing.padded_rows = int(
                            next(iter(xs.values())).shape[0])
                    handle = steps[j]((ex.sharding.reshard(xs), m, full))
            except (_HostFallback, FusionUnsupported) as e:
                return outs, m, ("fallback", str(e))
            except Exception as e:  # noqa: BLE001 — the stage's dispatch died
                return outs, m, ("wedged", sj,
                                 f"stage {sj} dispatch failed: {e}")
            now = time.perf_counter()
            timing.dispatch_s = now - t2
            self.busy_s[sj] += now - t2
            self.stats[j].record(timing)
            for key, y in zip(states[j]["keys"], handle[0]):
                outs[(j, key)] = y
                env[key] = y
        return outs, m, None

    def _hand_on(self, outs, m: int, status) -> None:
        """Send micro-batch outputs (and the status) to the next stage."""
        tensors = {} if status is not None else \
            {f"{j}/{key}": y for (j, key), y in outs.items()}
        for dst in _chain_receivers(self.pplan, self.stage, self.index):
            t1 = time.perf_counter()
            nbytes = send_tensors(tensors, dst, self.mesh,
                                  meta={"m": m, "status": status})
            self.handoff_s[self.stage + 1] += time.perf_counter() - t1
            self.handoff_bytes[self.stage + 1] += float(nbytes)

    def _collect(self, item, collected) -> None:
        """Read one micro-batch's outputs back (the last stage)."""
        m, outs = item
        t0 = time.perf_counter()
        for (j, key), y in outs.items():
            collected[j][key].append(y[:m].cpu().numpy())
        self.busy_s[self.stage] += time.perf_counter() - t0

    def _share_results(self, collected, states, status):
        """The last stage's readbacks and status to every rank of its chain
        (a rank of an earlier stage gets them from the last-stage rank its
        own place maps to)."""
        last = self.pplan.depth - 1
        last_ranks = self.pplan.stages[last].mesh.ranks
        if self.stage == last:
            tensors = {} if status is not None else {
                f"{j}/{key}": torch.from_numpy(np.concatenate(parts, axis=0))
                for j, cols in enumerate(collected)
                for key, parts in cols.items() if parts}
            for s in range(last):
                for i, r in enumerate(self.pplan.stages[s].mesh.ranks):
                    if i % len(last_ranks) == self.index:
                        send_tensors(tensors, int(r), self.mesh,
                                     meta={"status": status})
            return collected, status
        src = last_ranks[self.index % len(last_ranks)]
        got, meta = recv_tensors(int(src), self.mesh)
        status = tuple(meta["status"]) if meta["status"] is not None \
            else None
        out = [{k: [] for k in st["keys"]} for st in states]
        for name, t in got.items():
            j, key = name.split("/", 1)
            out[int(j)][key].append(t.cpu().numpy())
        return out, status

    def _check_gates(self, j: int, xs: Dict[str, Any]) -> None:
        """First-micro-batch check of a downstream segment: the ``accepts``
        dtype gates its serial prep would evaluate on host rows, on the
        handoff's row view. A failing gate runs the partition on the serial
        chain (every rank: the status carries it)."""
        from ..core.fusion import _HostFallback

        ex = self.execs[j]
        probes = {c: {"dtype": np.dtype(str(v.dtype).replace("torch.", "")),
                      "ndim": max(0, int(v.dim()) - 1),
                      "sparse": False, "mixed": False}
                  for c, v in xs.items()}
        for dfn, stage in zip(ex.segment.dfns, ex.segment.stages):
            mine = {c: probes[c] for c in dfn.in_cols if c in probes}
            if mine and dfn.accepts is not None and not dfn.accepts(mine):
                raise _HostFallback(
                    f"{type(stage).__name__} dtype gate (pipelined)")

    def _emit_chain(self, states, collected) -> List[Dict[str, np.ndarray]]:
        """Finalize the chain as the serial path would: each segment's emit
        over its predecessor's emitted partition, validity collapsing after
        any ``drop_invalid`` segment."""
        outs: List[Dict[str, np.ndarray]] = []
        cur_part = states[0]["part"]
        cur_n = states[0]["n"]
        cur_valid = states[0]["valid"]
        n_valid = states[0]["n_valid"]
        for j, ex in enumerate(self.execs):
            st = states[j]
            if j > 0:
                st["part"] = cur_part
                st["n"] = cur_n
                st["valid"] = cur_valid
                st["n_valid"] = n_valid
            out_part = ex._emit_partition(st, collected[j])
            outs.append(out_part)
            if any(d.drop_invalid for d in ex.segment.dfns) \
                    and n_valid < cur_n:
                cur_n = n_valid
                cur_valid = np.ones(n_valid, dtype=bool)
            cur_part = out_part
        return outs

    # -- stats surface -----------------------------------------------------

    def stats_dict(self, requeues: Optional[Dict[int, int]] = None,
                   replans: int = 0) -> Dict[str, Any]:
        """The ``fusion_stats()["pipeline"]`` section (absent when no pipe
        plan ran): this rank's host-side measurements of the stream (its
        own stage's busy time, the handoffs it sent and received)."""
        wall = max(self.wall_s, 1e-9)
        mb = self.micro_batches
        s = self.pplan.depth
        bubble = (s - 1) / (mb + s - 1) if mb > 0 else 0.0
        stages = []
        for st in self.pplan.stages:
            i = st.index
            d = st.describe()
            d["busy_ms"] = round(self.busy_s[i] * 1e3, 3)
            d["busy_ratio"] = round(min(1.0, self.busy_s[i] / wall), 4)
            d["handoff_bytes"] = int(self.handoff_bytes[i])
            d["handoff_ms"] = round(self.handoff_s[i] * 1e3, 3)
            d["requeues"] = int((requeues or {}).get(i, 0))
            stages.append(d)
        return {"depth": s, "window": self.window, "micro_batches": mb,
                "partitions": self.partitions,
                "serial_fallback_partitions": self.serial_parts,
                "bubble_ratio": round(bubble, 4),
                "handoff_bytes": int(sum(self.handoff_bytes)),
                "handoff_ms": round(sum(self.handoff_s) * 1e3, 3),
                "wall_ms": round(wall * 1e3, 3),
                "replans": int(replans),
                "stage": self.stage,
                "stages": stages}


# ---------------------------------------------------------------------------
# failure handling / supervision
# ---------------------------------------------------------------------------


def degrade_after_wedge(mesh, pplan: PipePlan, stage_index: int
                        ) -> Tuple[Any, int]:
    """(surviving mesh, new depth) after ``stage_index`` wedged: the stage's
    ranks dropped, a ``pipe = depth - 1`` mesh over the survivors when they
    divide evenly, else a data mesh at depth 1 (serial on the survivors).
    (None, 1) when nothing survives. A rank of the wedged stage gets the
    new mesh's description and runs the frame serially."""
    dead = set(pplan.stages[int(stage_index)].mesh.ranks)
    survivors = [r for r in mesh.ranks if r not in dead]
    if not survivors:
        return None, 1
    new_depth = int(pplan.depth) - 1
    if new_depth >= 2 and len(survivors) % new_depth == 0:
        return sub_mesh(mesh, survivors,
                        MeshSpec(data=len(survivors) // new_depth,
                                 pipe=new_depth)), new_depth
    return sub_mesh(mesh, survivors, MeshSpec(data=len(survivors))), 1


class PipeSupervision:
    """Extends shard-group quarantine (shardplan.MeshSupervision) to pipe
    stages: registers each stage's rank group with the supervisor, and on a
    wedged stage quarantines its ranks
    (``ReplicaSupervisor.note_stage_wedged``), degrades the mesh and
    re-arms the model at depth N-1; the model then re-runs the frame on the
    survivors, bitwise the same, no request dropped."""

    def __init__(self, fused, mesh, supervisor=None):
        self.fused = fused
        self.mesh0 = mesh
        self.mesh = mesh
        self.supervisor = supervisor
        self.replans = 0
        self.depth: Optional[int] = None
        self._registered = False
        if fused is not None:
            fused._pipe_wedge_handler = self.on_stage_wedge
            fused._pipe_supervision = self
            if hasattr(fused, "set_mesh"):
                fused.set_mesh(mesh)

    def register(self, pplan: PipePlan) -> None:
        """Hand the plan's stage groups (indices into the original mesh) to
        the supervisor, as ``set_shard_groups`` does for shard groups."""
        self.depth = pplan.depth
        if self.supervisor is None:
            return
        setter = getattr(self.supervisor, "set_pipe_stages", None)
        if not callable(setter):
            return
        ranks = list(self.mesh0.ranks)
        setter([[ranks.index(r) for r in st.mesh.ranks]
                for st in pplan.stages])
        self._registered = True

    def on_stage_wedge(self, pplan: PipePlan, stage_index: int):
        """The model's wedge callback: quarantine, degrade, re-arm."""
        if not self._registered:
            self.register(pplan)
        if self.supervisor is not None:
            noter = getattr(self.supervisor, "note_stage_wedged", None)
            if callable(noter):
                noter(int(stage_index))
        new_mesh, new_depth = degrade_after_wedge(self.mesh, pplan,
                                                  stage_index)
        self.mesh = new_mesh
        self.depth = new_depth
        self.replans += 1
        if self.fused is not None:
            if hasattr(self.fused, "set_mesh"):
                self.fused.set_mesh(new_mesh)
            if hasattr(self.fused, "set_tuning"):
                self.fused.set_tuning(pipe_depth=new_depth)
        return new_mesh

    def describe(self) -> Dict[str, Any]:
        from .shardplan import mesh_topology
        return {"topology": mesh_topology(self.mesh),
                "original": mesh_topology(self.mesh0),
                "depth": self.depth, "replans": self.replans}
