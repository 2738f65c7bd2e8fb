"""Tuner: the bounded measure -> refit -> apply loop over the cost model.

Counterpart of the reference's ``mmlspark_tpu/core/tune.py``, the same
decisions on the same measurements. TVM's auto-tuning insight
(arXiv:1802.04799) applied to this framework's knobs: don't hand-tune
constants, MEASURE candidate settings, refit the cost model
(core/costmodel.py), and keep what the measurements like. The knobs a
``Tuner`` owns:

  - shape-bucket sets per fused segment (``parallel/batching.py`` pads to
    powers of two by default);
  - fuse-vs-demote per light segment (``core/fusion.py plan()``);
  - the K-step mega dispatch per segment (a captured CUDA graph of K
    micro-batches on the card, core/fusion.py);
  - kernel variants, cross-segment stitches and the sparse staging layout;
  - the adaptive batch controller's cold-start window (predicted compute ms
    seeds the EWMA — ``AdaptiveBatchController.seed_compute_ms``);
  - the serving executor's ``inflight`` depth and a replica-count
    suggestion, derived from predicted compute-vs-transfer overlap;
  - the mesh knobs, over a fused model with a ``shard_mesh``: a partition
    spec per segment (``sharding``, parallel/shardplan.py) and the
    pipeline depth of its longest chainable run (``pipe_depth``,
    parallel/pipeplan.py).

Every decision is journaled, every ``apply`` keeps the previous knob set,
and a measured regression past ``tolerance`` rolls back ONE step. An
UNCALIBRATED model proposes the empty knob set, so cold-start behaviour is
bitwise-identical to the static defaults. State (model + knobs + journal)
serializes via ``to_dict``, in the reference's format.

Two drive modes:

  - explicit: ``tuner.tune(measure)`` where ``measure() -> float`` is a
    higher-is-better end-to-end metric (rows/s, requests/s);
  - serving: ``every=N`` makes ``on_epoch()`` (called by both serving
    loops after each batch) refit + apply every N batches and watch the
    measured per-batch e2e EWMA for regressions, rolling back one step
    when the tuned knobs made it worse.

Over a fused model whose ``shard_mesh`` spans several ranks the Tuner is
SPMD like the model (one process a rank, parallel/mesh.py): every rank
calls the same methods in one order, and the mesh's first rank decides.
Each rank folds its own measurements, so ``propose`` ends by taking the
first rank's knob set, ``tune`` judges every step by its measurement,
``on_epoch`` takes its regression verdict, and a push that failed on any
rank rolls back on all (``parallel.mesh.share_objects``). A knob that
moves a collective (a spec, a bucket, K, a pipe depth) is then the same on
every rank of the mesh; a rank outside it runs without the mesh's
collectives and keeps its own.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import faults
from .costmodel import SegmentCostModel

__all__ = ["KnobSet", "Tuner"]


@dataclasses.dataclass
class KnobSet:
    """One coherent setting of every tuned knob. The default-constructed
    KnobSet IS the static-heuristic configuration (nothing overridden)."""

    #: per-segment-label shape-bucket sets (None entries impossible; absent
    #: label = keep the power-of-two default)
    buckets: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    #: per-segment-label fuse-vs-demote overrides for LIGHT segments
    fuse: Dict[str, bool] = dataclasses.field(default_factory=dict)
    #: predicted compute ms seeding the adaptive controller's EWMA
    window_seed_ms: Optional[float] = None
    #: executor in-flight slot depth
    inflight: Optional[int] = None
    #: ReplicaSet sizing suggestion (surfaced, not hot-applied: replica
    #: placement happens at server start)
    replicas: Optional[int] = None
    #: per-segment-label K-step mega-dispatch factors (absent label = K=1,
    #: the bitwise-identical single-step path)
    mega_k: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: per-segment-label partition-spec names over the fused model's mesh
    #: (parallel/shardplan.py; absent label = the single-device path)
    sharding: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: per-segment-label {bucket: kernel variant id} maps (core/kernels.py;
    #: absent label/bucket = the built-in default kernel)
    kernel_variants: Dict[str, Dict[str, str]] = dataclasses.field(
        default_factory=dict)
    #: per-stage-class-name cross-segment stitch flags (core/fusion.py
    #: plan(); absent name = never merge across that boundary)
    stitch: Dict[str, bool] = dataclasses.field(default_factory=dict)
    #: per-segment-label sparse staging layouts ("csr" stages capable
    #: sparse columns as wire triples, docs/sparse.md; absent label = the
    #: densify path, byte-for-byte the untuned behaviour)
    layout: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: pipeline depth for the fused plan's chainable segment run
    #: (parallel/pipeplan.py; None/<=1 = the serial path, byte-for-byte
    #: the untuned behaviour)
    pipe_depth: Optional[int] = None

    def is_default(self) -> bool:
        return not (self.buckets or self.fuse or self.mega_k or
                    self.sharding or self.kernel_variants or self.stitch or
                    self.layout or
                    self.window_seed_ms is not None or
                    self.inflight is not None or
                    self.replicas is not None or
                    self.pipe_depth is not None)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.buckets:
            out["buckets"] = {k: list(v) for k, v in self.buckets.items()}
        if self.fuse:
            out["fuse"] = dict(self.fuse)
        if self.mega_k:
            out["mega_k"] = {k: int(v) for k, v in self.mega_k.items()}
        if self.sharding:
            out["sharding"] = {k: str(v)
                               for k, v in self.sharding.items()}
        if self.kernel_variants:
            out["kernel_variants"] = {
                label: {str(b): str(v) for b, v in kv.items()}
                for label, kv in self.kernel_variants.items()}
        if self.stitch:
            out["stitch"] = {k: bool(v) for k, v in self.stitch.items()}
        if self.layout:
            out["layout"] = {k: str(v) for k, v in self.layout.items()}
        for k in ("window_seed_ms", "inflight", "replicas", "pipe_depth"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KnobSet":
        return cls(
            buckets={k: tuple(int(x) for x in v)
                     for k, v in (d.get("buckets") or {}).items()},
            fuse={k: bool(v) for k, v in (d.get("fuse") or {}).items()},
            mega_k={k: int(v)
                    for k, v in (d.get("mega_k") or {}).items()},
            sharding={k: str(v)
                      for k, v in (d.get("sharding") or {}).items()},
            kernel_variants={
                label: {str(b): str(v) for b, v in (kv or {}).items()}
                for label, kv in (d.get("kernel_variants") or {}).items()},
            stitch={k: bool(v)
                    for k, v in (d.get("stitch") or {}).items()},
            layout={k: str(v)
                    for k, v in (d.get("layout") or {}).items()},
            window_seed_ms=d.get("window_seed_ms"),
            inflight=d.get("inflight"), replicas=d.get("replicas"),
            pipe_depth=d.get("pipe_depth"))


class Tuner:
    """Cost-model-driven knob tuner over a FusedPipelineModel (and,
    optionally, the serving executor/controller it runs under).

    ``fused``: the FusedPipelineModel whose CompileCache costs and
    per-segment IngestStats feed the model and whose ``set_tuning()``
    receives bucket/fuse knobs. ``controller``/``executor`` (wired by
    ``ServingServer.start()`` when the server owns a tuner): receive the
    window seed / inflight knobs. All optional — a Tuner over just a fused
    model tunes buckets and fuse decisions alone.
    """

    def __init__(self, fused=None, model: Optional[SegmentCostModel] = None,
                 controller=None, executor=None,
                 every: int = 0, tolerance: float = 0.05,
                 max_inflight: int = 8, journal_cap: int = 256):
        self.model = model if model is not None else SegmentCostModel()
        self.fused = fused
        self.controller = controller
        self.executor = executor
        #: serving mode: refit+apply every N batches (0 = explicit only)
        self.every = int(every)
        #: fractional e2e regression that triggers a one-step rollback
        self.tolerance = float(tolerance)
        self.max_inflight = int(max_inflight)
        self._journal_cap = int(journal_cap)
        self._lock = threading.Lock()
        self.knobs = KnobSet()
        self._prev: Optional[KnobSet] = None
        self.journal: List[Dict[str, Any]] = []
        self.applies = 0
        self.rollbacks = 0
        self.epochs = 0
        #: applies that changed the kernel_variants knob (the
        #: mmlspark_kernel_variant_switches_total counter)
        self.variant_switches = 0
        # incremental IngestStats folding: label -> (stats object id, fold
        # high-water mark) so re-reading a live stats object never double
        # counts records
        self._folded: Dict[str, Tuple[int, int]] = {}
        # serving-mode regression watch: per-batch e2e ms EWMAs before and
        # after the latest apply; the first post-apply batches are skipped
        # (they carry any fresh bucket's ONE-TIME program build — a graph
        # capture on the card — which must not read as a steady state)
        self._e2e_before: Optional[float] = None
        self._e2e_after: Optional[float] = None
        self._e2e_after_n = 0
        self._e2e_skip = 0
        # a rolled-back knob set is vetoed for a few boundaries so a noisy
        # host doesn't flip-flop apply/rollback on the same proposal
        self._vetoed: Optional[Dict[str, Any]] = None
        self._veto_until = 0

    # -- agreement over a mesh ------------------------------------------
    def _share(self, obj: Any) -> List[Any]:
        """Every rank's ``obj`` over the fused model's mesh, in mesh order
        (``[obj]`` without one, or outside it): what its first rank
        decides, or whether any rank failed. Every rank of the mesh calls
        it at the same point."""
        mesh = getattr(self.fused, "shard_mesh", None)
        if mesh is None:
            return [obj]
        from ..parallel.mesh import share_objects

        return share_objects(obj, mesh)

    # -- journal ---------------------------------------------------------
    def _log(self, action: str, **fields: Any) -> None:
        entry = {"action": action, "epoch": self.epochs, **fields}
        with self._lock:
            self.journal.append(entry)
            if len(self.journal) > self._journal_cap:
                del self.journal[: self._journal_cap // 4]

    # -- refit -----------------------------------------------------------
    def fold_measured(self) -> None:
        """Fold the fused model's CURRENT per-segment IngestStats into the
        cost model (incremental, double-count safe). Called per batch in
        serving mode — the stats objects are replaced every transform, so
        waiting for the every-N refit would drop most of the records."""
        segs = getattr(self.fused, "_seg_stats", None) or {}
        for label, st in list(segs.items()):
            prev_id, mark = self._folded.get(label, (None, 0))
            if prev_id != id(st):
                mark = 0
            try:
                mark = self.model.observe_stats(label, st, start=mark)
            except Exception:  # noqa: BLE001
                continue
            self._folded[label] = (id(st), mark)

    def refit(self) -> None:
        """Fold the fused model's latest CompileCache costs and per-segment
        IngestStats into the cost model (incremental, double-count safe)."""
        fused = self.fused
        if fused is None:
            return
        cache = getattr(fused, "_cache", None)
        if cache is not None:
            try:
                self.model.ingest_costs(cache.costs())
            except Exception:  # noqa: BLE001 — refit must never kill serving
                pass
        self.fold_measured()

    # -- propose ---------------------------------------------------------
    def _segment_batch_caps(self) -> Dict[str, int]:
        """{segment label: configured batch size} over the fused plan."""
        out: Dict[str, int] = {}
        plan = getattr(self.fused, "_last_plan", None) or []
        for node in plan:
            bs = getattr(node, "batch_size", None)
            if callable(bs):
                out[node.label] = int(bs())
        return out

    def propose(self) -> KnobSet:
        """Derive a KnobSet from the current model. Uncalibrated segments
        contribute nothing, so a cold model proposes the default set. Over
        a mesh of several ranks, its first rank's set."""
        knobs = KnobSet()
        caps = self._segment_batch_caps()
        trailing_ms: Optional[float] = None
        parts: Optional[Dict[str, float]] = None
        for label, cap in caps.items():
            if not self.model.calibrated(label):
                continue
            chosen = self.model.choose_buckets(label, cap)
            if chosen is not None:
                knobs.buckets[label] = chosen
            decision = self.model.fuse_decision(label)
            if decision is not None:
                knobs.fuse[label] = decision
            k = self._mega_k_for(label)
            if k is not None and k > 1:
                knobs.mega_k[label] = k
            spec = self._sharding_for(label, cap)
            if spec is not None:
                knobs.sharding[label] = spec
            variants = self._variants_for(label)
            if variants:
                knobs.kernel_variants[label] = variants
            lay = self._layout_for(label)
            if lay:
                knobs.layout[label] = lay
            pred = self.model.predict(label, batch=cap)
            if pred is not None:
                trailing_ms = pred["ms"]
                parts = pred.get("parts")
        stitch = self._stitch_proposals()
        if stitch:
            knobs.stitch = stitch
        depth = self._pipe_depth_for(caps)
        if depth is not None and depth > 1:
            knobs.pipe_depth = int(depth)
        if trailing_ms is not None:
            compute = (parts or {}).get("compute_ms")
            knobs.window_seed_ms = round(
                compute if compute is not None else trailing_ms, 4)
            transfer = sum((parts or {}).get(k, 0.0)
                           for k in ("h2d_ms", "readback_ms"))
            host = (parts or {}).get("dispatch_ms", 0.0)
            if compute and compute > 0:
                # slots needed so transfer+host hide behind compute
                knobs.inflight = max(1, min(
                    self.max_inflight,
                    1 + round((transfer + host) / compute)))
                knobs.replicas = self._replica_suggestion(compute, transfer)
        return self._share(knobs)[0]

    def _mega_k_for(self, label: str) -> Optional[int]:
        """Cost-model K for a segment, capped by observed queue depth (a K
        deeper than the queue ever gets only adds latency: the mega program
        would wait on batches that are not coming)."""
        chooser = getattr(self.model, "choose_mega_k", None)
        if not callable(chooser):
            return None
        try:
            k = chooser(label)
        except Exception:  # noqa: BLE001 — proposal must never raise out
            return None
        if k is None or k <= 1:
            return k
        depth = 0
        stats = getattr(self.fused, "_seg_stats", None) or {}
        st = stats.get(label)
        if st is not None:
            depth = int(getattr(st, "_occ_max", 0) or 0)
        if depth <= 0 and self.executor is not None:
            depth = int(getattr(self.executor, "inflight", 0) or 0)
        if depth > 0:
            k = min(k, depth)
        return max(1, k)

    def _sharding_for(self, label: str, cap: int) -> Optional[str]:
        """Cost-model partition-spec choice for one segment: the candidates
        the plan's stage graph admits over the fused model's mesh
        (parallel/shardplan.py), each priced as flops/shards + the
        calibrated collective term; None (= stay unsharded, the default
        that keeps cold start bitwise identical) without a mesh or a
        winner."""
        mesh = getattr(self.fused, "shard_mesh", None)
        chooser = getattr(self.model, "choose_sharding", None)
        if mesh is None or not callable(chooser):
            return None
        seg = None
        for node in getattr(self.fused, "_last_plan", None) or []:
            if getattr(node, "label", None) == label and \
                    hasattr(node, "dfns"):
                seg = node
                break
        if seg is None:
            return None
        try:
            from ..parallel.shardplan import tuner_candidates

            cands = tuner_candidates(seg, mesh, model=self.model,
                                     batch=cap)
            if not cands:
                return None
            return chooser(label, cap, cands)
        except Exception:  # noqa: BLE001 — proposal must never raise out
            return None

    def _variants_for(self, label: str) -> Dict[str, str]:
        """Measured per-bucket kernel-variant winners for one segment
        (``costmodel.choose_variant`` over the buckets that hold trial
        data). {} proposes nothing — the built-in default kernels — which
        is also what a model without variant support yields."""
        chooser = getattr(self.model, "choose_variant", None)
        buckets = getattr(self.model, "variant_buckets", None)
        if not callable(chooser) or not callable(buckets):
            return {}
        out: Dict[str, str] = {}
        try:
            for b in buckets(label):
                vid = chooser(label, b)
                if vid:
                    out[str(b)] = str(vid)
        except Exception:  # noqa: BLE001 — proposal must never raise out
            return {}
        return out

    def _layout_for(self, label: str) -> Optional[str]:
        """Cost-model staging-layout choice for one segment ("csr" stages
        sparse columns as wire triples, docs/sparse.md). None — the
        densify default — from a model without nnz support, an
        uncalibrated nnz term, or bytes that do not favour CSR."""
        chooser = getattr(self.model, "choose_layout", None)
        if not callable(chooser):
            return None
        try:
            return chooser(label)
        except Exception:  # noqa: BLE001 — proposal must never raise out
            return None

    def _pipe_depth_for(self, caps: Dict[str, int]) -> Optional[int]:
        """Cost-model pipeline depth for the fused plan's longest chainable
        segment run (parallel/pipeplan.py ``chainable_runs`` over the
        pipeline view + ``costmodel.choose_pipe_depth``). None (= serial,
        the default) without a mesh whose pipe axis is above 1, a run of
        at least two segments, or a calibrated run (the chooser's gate)."""
        mesh = getattr(self.fused, "shard_mesh", None)
        chooser = getattr(self.model, "choose_pipe_depth", None)
        if mesh is None or not callable(chooser):
            return None
        try:
            from ..parallel.mesh import PIPE_AXIS
            from ..parallel.pipeplan import chainable_runs, split_segments

            p = int(dict(getattr(mesh, "shape", {}) or {})
                    .get(PIPE_AXIS, 1))
            if p < 2:
                return None
            # propose over the pipeline view: the re-cut build_pipe_plan
            # runs
            runs = chainable_runs(split_segments(
                getattr(self.fused, "_last_plan", None) or []))
            if not runs:
                return None
            run = max(runs, key=len)
            labels = [seg.label for _, seg in run]
            batch = min(int(caps.get(lab, 256)) for lab in labels)
            return chooser(labels, batch, p)
        except Exception:  # noqa: BLE001 — proposal must never raise out
            return None

    def _stitch_proposals(self) -> Dict[str, bool]:
        """Stitch flags for the plan's adjacent (Segment, Segment)
        boundaries split by a TERMINAL tail stage that carries a transpiled
        finalize shim (``stitchable`` + ``device_finalize`` +
        ``finalize_stitched``) and whose measured readback + H2D round-trip
        the cost model prices as worth removing (``stitch_decision``,
        calibration-gated — a cold model proposes nothing). Keys are the
        tail stage's class name — the same key ``plan()``'s
        ``stitch_overrides`` consumes."""
        decider = getattr(self.model, "stitch_decision", None)
        if not callable(decider):
            return {}
        out: Dict[str, bool] = {}
        nodes = getattr(self.fused, "_last_plan", None) or []
        for up, down in zip(nodes, nodes[1:]):
            if not (hasattr(up, "dfns") and hasattr(down, "dfns")):
                continue
            if not up.dfns or not down.dfns:
                continue
            tail = up.dfns[-1]
            if not (getattr(tail, "stitchable", False)
                    and getattr(tail, "device_finalize", None) is not None
                    and getattr(tail, "finalize_stitched", None)
                    is not None):
                continue
            try:
                decision = decider(up.label, down.label)
            except Exception:  # noqa: BLE001 — proposal must never raise
                continue
            if decision:
                out[type(up.stages[-1]).__name__] = True
        return out

    def predict_batch_ms(self, rows: int) -> Optional[float]:
        """Predicted wall ms for one serving batch of ``rows`` — the sum of
        the calibrated segments' batch predictions. None while uncalibrated
        (the serving watchdog stays on its measured-EWMA fallback). This is
        the cost-model side of the hung-dispatch budget
        (serving/supervisor.py DispatchWatchdog)."""
        total: Optional[float] = None
        for label in self._segment_batch_caps():
            if not self.model.calibrated(label):
                continue
            try:
                pred = self.model.predict(label, batch=int(rows))
            except Exception:  # noqa: BLE001 — prediction must never raise out
                continue
            if pred is not None and pred.get("ms") is not None:
                total = (total or 0.0) + float(pred["ms"])
        return total

    def predict_row_ms(self, bucket: int = 32) -> Optional[float]:
        """Per-ROW service estimate at ``bucket`` — the multimodel
        planner's packing key for THIS pipeline (the ``predict_ms`` mall
        hook). None while uncalibrated, so the mall falls back to its own
        measured EWMA (the probe-slot graduation path)."""
        if bucket <= 0:
            return None
        ms = self.predict_batch_ms(int(bucket))
        return None if ms is None else ms / int(bucket)

    def _replica_suggestion(self, compute_ms: float,
                            transfer_ms: float) -> Optional[int]:
        """Compute-bound segments scale across the local cards;
        transfer-bound ones gain nothing from more replicas on one link.
        None on a host without a card."""
        import torch

        if not torch.cuda.is_available():
            return None
        n_dev = torch.cuda.device_count()
        return n_dev if compute_ms >= transfer_ms else 1

    # -- apply / rollback ------------------------------------------------
    @staticmethod
    def _push(fused, knobs: KnobSet) -> None:
        """set_tuning with the full knob surface, degrading for older
        fused models (newest kwargs dropped first). ``pipe_depth`` ships
        as 1 when unset — set_tuning's <= 1 CLEARS the knob, so rolling
        back to a default set restores the serial path bitwise."""
        try:
            fused.set_tuning(buckets=knobs.buckets, fuse=knobs.fuse,
                             mega_k=knobs.mega_k, sharding=knobs.sharding,
                             kernel_variants=knobs.kernel_variants,
                             stitch=knobs.stitch, layout=knobs.layout,
                             pipe_depth=knobs.pipe_depth or 1)
        except TypeError:
            try:  # older fused models without the pipeline-depth knob
                fused.set_tuning(buckets=knobs.buckets, fuse=knobs.fuse,
                                 mega_k=knobs.mega_k,
                                 sharding=knobs.sharding,
                                 kernel_variants=knobs.kernel_variants,
                                 stitch=knobs.stitch, layout=knobs.layout)
            except TypeError:
                try:  # ... without the staging-layout knob either
                    fused.set_tuning(buckets=knobs.buckets,
                                     fuse=knobs.fuse,
                                     mega_k=knobs.mega_k,
                                     sharding=knobs.sharding,
                                     kernel_variants=knobs.kernel_variants,
                                     stitch=knobs.stitch)
                except TypeError:
                    Tuner._push_legacy(fused, knobs)

    @staticmethod
    def _push_legacy(fused, knobs: KnobSet) -> None:
        try:  # older fused models without the compiler-search knobs
            fused.set_tuning(buckets=knobs.buckets, fuse=knobs.fuse,
                             mega_k=knobs.mega_k,
                             sharding=knobs.sharding)
        except TypeError:
            try:  # ... without the sharding knob
                fused.set_tuning(buckets=knobs.buckets,
                                 fuse=knobs.fuse, mega_k=knobs.mega_k)
            except TypeError:  # ... or without the K knob either
                fused.set_tuning(buckets=knobs.buckets,
                                 fuse=knobs.fuse)

    def apply(self, knobs: KnobSet, reason: str = "apply") -> None:
        """Push a KnobSet into the wired layers, remembering the previous
        set for one-step rollback. A kernel-variant/stitch/layout swap
        that fails
        MID-SWAP (the ``tuner.kernel_apply`` chaos seam, or any push
        failure) restores the incumbent knob set — replies stay bitwise
        those of the incumbent variant."""
        with self._lock:
            prev = self.knobs
            self._prev = prev
            self.knobs = knobs
            self.applies += 1
            # serving watch: ignore the next batches' e2e (fresh-bucket
            # compile spike) before judging the new knobs
            self._e2e_skip = 2
        variant_change = knobs.kernel_variants != prev.kernel_variants
        swap_change = (variant_change or knobs.stitch != prev.stitch
                       or knobs.layout != prev.layout
                       or knobs.pipe_depth != prev.pipe_depth)
        fused = self.fused
        error: Optional[str] = None
        try:
            if swap_change:
                # chaos seam: a raise here lands MID-SWAP — tuner state
                # already points at the new knobs, the fused model still
                # runs the incumbent — the exact window the rollback
                # handler below must make safe
                faults.fire(faults.TUNER_KERNEL_APPLY)
            if fused is not None and hasattr(fused, "set_tuning"):
                self._push(fused, knobs)
        except Exception as e:  # noqa: BLE001 — a failed swap never serves
            error = str(e)
        # over a mesh, a push that failed on any rank rolls back on every
        # rank: the ranks must not run different knob sets
        error = next((e for e in self._share(error) if e is not None), None)
        if error is not None:
            with self._lock:
                self.knobs = prev
                self._prev = None  # the failed swap is not a step to redo
                self.rollbacks += 1
            if fused is not None and hasattr(fused, "set_tuning"):
                try:
                    self._push(fused, prev)  # re-pin the incumbent
                except Exception:  # noqa: BLE001
                    pass
            self._log("kernel_apply_rollback", error=error,
                      knobs=prev.to_dict())
            return
        if variant_change:
            with self._lock:
                self.variant_switches += 1
        if self.controller is not None and knobs.window_seed_ms is not None:
            seed = getattr(self.controller, "seed_compute_ms", None)
            if callable(seed):
                seed(knobs.window_seed_ms)
        if self.executor is not None and knobs.inflight is not None:
            set_inflight = getattr(self.executor, "set_inflight", None)
            if callable(set_inflight):
                set_inflight(knobs.inflight)
        self._log(reason, knobs=knobs.to_dict())

    def warm_start(self, knobs: Dict[str, Any]) -> bool:
        """Apply a SHIPPED knob snapshot (fleet/objstore.py knob shipping)
        at serve start: the fresh pod begins on the fleet's tuned
        buckets/mega-K/sharding/variants with no relearning window.
        Journaled as ``warm_start`` with one-step rollback to the defaults
        this pod would otherwise have started on. False (and untouched
        state) on an empty, default, or malformed snapshot."""
        try:
            ks = KnobSet.from_dict(dict(knobs or {}))
        except Exception:  # noqa: BLE001 — a bad snapshot just relearns
            return False
        if ks.is_default():
            return False
        self.apply(ks, reason="warm_start")
        return True

    def rollback(self, reason: str = "regression") -> bool:
        """Re-apply the PREVIOUS knob set (one step). Returns False when
        there is nothing to roll back to."""
        with self._lock:
            prev = self._prev
            if prev is None:
                return False
            self._prev = None
        self.apply(prev, reason=f"rollback:{reason}")
        with self._lock:
            self.rollbacks += 1
            self._prev = None  # a rollback is terminal for that step
        return True

    # -- explicit tuning loop --------------------------------------------
    def _measure(self, measure: Callable[[], float]) -> float:
        # chaos seam: an injected delay here slows THIS measurement (the
        # deterministic way to fake a regression in tests); an injected
        # exception surfaces to the caller like any measurement failure
        t0 = time.perf_counter()
        faults.fire(faults.TUNER_MEASURE)
        penalty = time.perf_counter() - t0
        value = float(measure())
        if penalty > 0:
            # an injected stall IS a slower system: scale the
            # higher-is-better metric down by the stalled fraction
            value = value / (1.0 + penalty)
        # over a mesh, its first rank's measurement judges every step
        return self._share(value)[0]

    def tune(self, measure: Callable[[], float], steps: int = 1,
             warmup: int = 1) -> Dict[str, Any]:
        """Bounded measure -> refit -> apply loop. ``measure() -> float``
        is higher-is-better end-to-end goodness (qps, images/s); it should
        exercise the fused pipeline so refit() sees fresh stats. A step
        whose measurement regresses past ``tolerance`` rolls back and the
        loop stops (one-step rollback contract). ``warmup`` discarded
        measure() calls follow each apply so a fresh bucket's ONE-TIME
        build doesn't read as a steady-state regression (build cost is
        already charged in the model's bucket scoring, amortized over
        ``compile_horizon``). Returns the decision summary (journaled)."""
        baseline = self._measure(measure)
        self._log("baseline", value=round(baseline, 6))
        history = [{"step": 0, "value": round(baseline, 6),
                    "knobs": self.knobs.to_dict(), "accepted": True}]
        for step in range(1, max(1, int(steps)) + 1):
            self.refit()
            knobs = self.propose()
            self.apply(knobs)
            for _ in range(max(0, int(warmup))):
                measure()  # discarded: compiles fresh-bucket executables
            value = self._measure(measure)
            accepted = value >= baseline * (1.0 - self.tolerance)
            entry = {"step": step, "value": round(value, 6),
                     "knobs": knobs.to_dict(), "accepted": accepted}
            history.append(entry)
            if not accepted:
                self.rollback("tune_step_regressed")
                self._log("tune_step", **entry)
                break
            self._log("tune_step", **entry)
            baseline = max(baseline, value)
        return {"baseline": history[0]["value"], "steps": history,
                "final_knobs": self.knobs.to_dict(),
                "rollbacks": self.rollbacks}

    # -- serving integration ---------------------------------------------
    def on_batch(self, e2e_s: float) -> None:
        """Feed one served batch's end-to-end seconds (queue+compute+
        readback) — the regression signal for serving-mode tuning. Batches
        right after an apply are skipped: they carry any fresh bucket's
        one-time compile, not steady state."""
        ms = float(e2e_s) * 1e3
        with self._lock:
            if self._e2e_skip > 0:
                self._e2e_skip -= 1
                return
            if self._e2e_after is None:
                self._e2e_after = ms
            else:
                self._e2e_after = 0.75 * self._e2e_after + 0.25 * ms
            self._e2e_after_n += 1

    def on_epoch(self, e2e_s: Optional[float] = None) -> None:
        """Per-batch tick from the serving loops. Every ``self.every``
        batches: check the post-apply e2e EWMA against the pre-apply one
        (rollback on regression), then refit and apply a fresh proposal."""
        if e2e_s is not None:
            self.on_batch(e2e_s)
        self.fold_measured()
        with self._lock:
            self.epochs += 1
            if self.every <= 0 or self.epochs % self.every != 0:
                return
            before, after = self._e2e_before, self._e2e_after
            enough = self._e2e_after_n >= max(2, self.every // 2)
        regressed = (before is not None and after is not None and enough
                     and self._prev is not None
                     and after > before * (1.0 + self.tolerance))
        # over a mesh, its first rank's verdict holds on every rank
        if self._share(regressed)[0]:
            bad = self.knobs.to_dict()
            self.rollback("serving_e2e_regressed")
            with self._lock:
                self._vetoed = bad
                self._veto_until = self.epochs + 4 * max(1, self.every)
                self._e2e_before = after
                self._e2e_after = None
                self._e2e_after_n = 0
            return
        self.refit()
        knobs = self.propose()
        kd = knobs.to_dict()
        with self._lock:
            vetoed = (self._vetoed is not None and kd == self._vetoed
                      and self.epochs < self._veto_until)
        if kd == self.knobs.to_dict():
            self._log("steady", knobs=kd)
        elif vetoed:
            # the measured watch rejected exactly this set recently: hold
            # the current knobs until the veto window passes
            self._log("vetoed", knobs=kd)
        else:
            self.apply(knobs)
        with self._lock:
            self._e2e_before = after if after is not None else before
            self._e2e_after = None
            self._e2e_after_n = 0

    # -- stats / serialization -------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """The ``tuner`` section of /_mmlspark/stats (and the source of the
        mmlspark_tuner_* metric families, obs/bridge.py)."""
        with self._lock:
            journal = list(self.journal[-16:])
            knob_ref = self.knobs
            applies, rollbacks, epochs = \
                self.applies, self.rollbacks, self.epochs
            switches = self.variant_switches
            e2e = {"before_ms": self._e2e_before,
                   "after_ms": self._e2e_after}
        knobs = knob_ref.to_dict()
        out = {
            "every": self.every, "tolerance": self.tolerance,
            "epochs": epochs, "applies": applies, "rollbacks": rollbacks,
            "calibrated": self.model.calibrated(),
            "knobs": knobs, "default_knobs": KnobSet().to_dict(),
            "knobs_active": not KnobSet.from_dict(knobs).is_default(),
            "predicted_vs_measured": self.model.prediction_error(),
            "model": self.model.stats(),
            "e2e_ewma": e2e,
            "journal": journal,
        }
        if switches:  # key absent until a variant ever switched: parity
            out["variant_switches"] = switches
        return out

    def to_dict(self) -> Dict[str, Any]:
        # snapshot the model OUTSIDE our lock: it takes its own (single
        # consistent lock order — model never calls back into the tuner)
        model = self.model.to_dict()
        with self._lock:
            knob_ref = self.knobs
            out = {"version": 1, "every": self.every,
                   "tolerance": self.tolerance,
                   "applies": self.applies, "rollbacks": self.rollbacks,
                   "epochs": self.epochs,
                   "journal": list(self.journal),
                   "model": model}
            if self.variant_switches:
                out["variant_switches"] = self.variant_switches
        out["knobs"] = knob_ref.to_dict()
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any], fused=None, controller=None,
                  executor=None) -> "Tuner":
        t = cls(fused=fused, controller=controller, executor=executor,
                model=SegmentCostModel.from_dict(d.get("model") or {}),
                every=int(d.get("every", 0)),
                tolerance=float(d.get("tolerance", 0.05)))
        t.knobs = KnobSet.from_dict(d.get("knobs") or {})
        t.applies = int(d.get("applies", 0))
        t.rollbacks = int(d.get("rollbacks", 0))
        t.epochs = int(d.get("epochs", 0))
        t.variant_switches = int(d.get("variant_switches", 0))
        t.journal = list(d.get("journal") or [])
        return t
