"""Per-segment cost model: analytical roofline first, measured refinement on top.

Counterpart of the reference's ``mmlspark_tpu/core/costmodel.py``, the same
host arithmetic line for line, so that both packages give the same numbers
on the same observations and a model serialised by one (``to_dict``) loads
in the other (``from_dict``). In the shape of "A Learned Performance Model
for TPUs" (arXiv:2008.01040): start from an ANALYTICAL prediction (roofline
over the fused programs' harvested flops/bytes — obs/perf.py's cost tally —
and ``device_peaks()``, plus build-time amortization for buckets that would
need a fresh program), then REFINE online from what the executor measured
(per-stage EWMAs keyed by ``(segment, bucket)``).

The public surface the Tuner (core/tune.py) consumes:

  - ``observe_batch(segment, timing)`` / ``observe_stats(segment, stats)``
    fold measured ``BatchTiming`` rows in (bucket = the padded batch size).
  - ``ingest_costs(cache.costs())`` folds the CompileCache's cost records
    (flops / bytes_accessed / compile_s ...).
  - ``observe_host(stage, seconds, rows)`` learns the HOST path's per-row
    cost per stage class — the other side of the fuse-vs-demote comparison.
  - ``predict_ms(segment, shape=None, batch=None)`` -> predicted wall ms
    for one batch, or None when the model knows nothing; ``predict()``
    returns the full record (per-stage parts, source, confidence).
  - ``confidence(segment)`` / ``calibrated(segment)``: the gate every knob
    decision sits behind — an UNCALIBRATED model changes nothing.
  - ``choose_buckets``, ``fuse_decision``, ``choose_mega_k``,
    ``choose_variant``, ``stitch_decision`` and ``choose_layout``: the
    knob decisions, each None (keep the default) until calibrated.
  - ``observe_collective`` / ``collective_ms`` / ``choose_sharding`` and
    ``predict_pipelined_ms`` / ``choose_pipe_depth``: the mesh terms, fed
    by ``shardplan.measure_collectives`` and the pipe runner's measured
    handoffs; the Tuner asks for them when the fused model has a mesh.

Everything is host-side Python, thread-safe under one lock, and
serializable (``to_dict``/``from_dict``).
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["SegmentCostModel", "bucket_of_shape"]

#: measured-stage keys folded per (segment, bucket); queue_s is tracked but
#: excluded from the predicted batch wall (it is producer wait the ring
#: overlaps, not work the batch itself costs)
_STAGES = ("queue_s", "h2d_s", "dispatch_s", "compute_s", "readback_s")
_WALL_STAGES = ("h2d_s", "dispatch_s", "compute_s", "readback_s")


def bucket_of_shape(shape_key: str) -> Optional[int]:
    """Leading (batch) dim of a CompileCache shape key
    (``"col=64x32x32x3:uint8;..."`` -> 64); None when unparseable.

    The first token must be a structurally valid SHAPE entry —
    ``<col>=<d1>x...x<dn>:<dtype>`` with every dim an integer — so ANY
    decorated prefix (``mega{k};``, ``spec=...;``, ``variant=<id>;``,
    ``stitch=...;`` or future ones) is rejected generically rather than by
    per-prefix special cases. Decorated keys carry executor state, not a
    batch shape; parsing one here would leak a bogus bucket into the
    analytic cost tables."""
    try:
        first = shape_key.split(";", 1)[0]
        name, eq, value = first.partition("=")
        if not eq or not name or "{" in name or "}" in name:
            return None
        dims, colon, dtype = value.rpartition(":")
        if not colon or not dtype or not dims:
            return None
        parts = dims.split("x")
        if not all(p.isdigit() for p in parts):
            return None
        return int(parts[0])
    except (IndexError, ValueError):
        return None


def _min_max_contiguous(costs: Sequence[float], k: int) -> float:
    """Minimum achievable max-stage-sum over contiguous splits of ``costs``
    into ``k`` groups — the pipeline clock of the best-balanced contiguous
    stage assignment (chains are short, so enumerate cut placements)."""
    vals = [float(c) for c in costs]
    n = len(vals)
    k = max(1, min(int(k), n))
    if k == 1:
        return sum(vals)
    import itertools
    best = float("inf")
    for cuts in itertools.combinations(range(1, n), k - 1):
        bounds = (0,) + cuts + (n,)
        clock = max(sum(vals[a:b]) for a, b in zip(bounds, bounds[1:]))
        best = min(best, clock)
    return best


class _BucketRecord:
    """Measured EWMAs + counters for one (segment, bucket).

    ``dispatch_call_s`` tracks the DE-AMORTIZED per-Python-call dispatch
    cost: when a timing rode a K-step mega dispatch (``timing.mega_k`` >
    1), its ``dispatch_s`` is the per-batch share (mega time / K), so the
    call cost is ``dispatch_s * mega_k``. ``choose_mega_k`` reads this —
    reading the amortized EWMA would make an active K>1 look like cheap
    dispatch, propose K=1, and oscillate every tuning cycle. The amortized
    ``dispatch_s`` EWMA stays as-is: it IS the per-batch wall
    contribution the roofline/prediction side wants."""

    __slots__ = ("n", "rows", "ewma", "dispatch_call_s") + _STAGES

    def __init__(self):
        self.n = 0
        self.rows = 0
        self.dispatch_call_s = None
        for k in _STAGES:
            setattr(self, k, None)

    def fold(self, timing, alpha: float) -> None:
        self.n += 1
        self.rows += int(getattr(timing, "rows", 0) or 0)
        for k in _STAGES:
            v = float(getattr(timing, k, 0.0) or 0.0) * 1e3  # -> ms
            prev = getattr(self, k)
            setattr(self, k, v if prev is None
                    else (1 - alpha) * prev + alpha * v)
        k_amort = max(1, int(getattr(timing, "mega_k", 1) or 1))
        call = float(getattr(timing, "dispatch_s", 0.0) or 0.0) * \
            k_amort * 1e3
        self.dispatch_call_s = call if self.dispatch_call_s is None \
            else (1 - alpha) * self.dispatch_call_s + alpha * call

    def wall_ms(self) -> Optional[float]:
        vals = [getattr(self, k) for k in _WALL_STAGES]
        if all(v is None for v in vals):
            return None
        return sum(v for v in vals if v is not None)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"n": self.n, "rows": self.rows}
        for k in _STAGES:
            v = getattr(self, k)
            if v is not None:
                out[k[:-2] + "_ms"] = round(v, 6)
        if self.dispatch_call_s is not None:
            out["dispatch_call_ms"] = round(self.dispatch_call_s, 6)
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "_BucketRecord":
        rec = cls()
        rec.n = int(d.get("n", 0))
        rec.rows = int(d.get("rows", 0))
        for k in _STAGES:
            v = d.get(k[:-2] + "_ms")
            if v is not None:
                setattr(rec, k, float(v))
        v = d.get("dispatch_call_ms")
        if v is not None:
            rec.dispatch_call_s = float(v)
        return rec


class SegmentCostModel:
    """Analytical-then-learned per-(segment, bucket) batch cost model."""

    def __init__(self, peaks: Optional[Dict[str, Any]] = None,
                 ewma: float = 0.3, min_obs: int = 4,
                 compile_horizon: int = 200):
        # peaks resolve lazily (device_peaks() reads the card's name, which
        # initialises CUDA); pass explicitly to pin them
        self._peaks = peaks
        self.ewma = float(ewma)
        #: batches measured at a bucket before its EWMA is trusted
        self.min_obs = int(min_obs)
        #: batches a fresh compile is amortized over in bucket-set scoring
        self.compile_horizon = int(compile_horizon)
        self._lock = threading.Lock()
        # (segment, bucket) -> measured record
        self._measured: Dict[Tuple[str, int], _BucketRecord] = {}
        # (segment, bucket) -> {flops, bytes_accessed, compile_s} (harvest)
        self._analytic: Dict[Tuple[str, int], Dict[str, float]] = {}
        # segment -> {real batch rows -> batches observed} (pad-waste term)
        self._size_hist: Dict[str, Dict[int, int]] = {}
        # host stage class -> (ewma ms-per-row, n) — the demote side
        self._host: Dict[str, List[float]] = {}
        # collective op ("all_reduce"/"all_gather") -> [(bytes, ms), ...]
        # measured probe points (bounded), the α·bytes sharding term
        self._collective: Dict[str, List[Tuple[float, float]]] = {}
        # (segment, bucket, variant id) -> [ewma wall ms, n] — measured
        # kernel-variant trials ("default" tracks the incumbent baseline)
        self._variant: Dict[Tuple[str, int, str], List[float]] = {}
        # segment -> [ewma nnz-per-row, ewma width, n] — sparse density
        # observations (docs/sparse.md): staging bytes scale with nnz, not
        # rows x width, so the layout decision needs its own term
        self._nnz: Dict[str, List[float]] = {}

    # -- feeding ---------------------------------------------------------
    def peaks(self) -> Dict[str, Any]:
        if self._peaks is None:
            from ..obs.perf import device_peaks

            self._peaks = device_peaks()
        return self._peaks

    def observe_batch(self, segment: str, timing) -> None:
        """Fold one measured ``BatchTiming`` (parallel/ingest.py). Bucket =
        the padded batch size when recorded, else the valid row count."""
        bucket = int(getattr(timing, "padded_rows", 0) or 0) or \
            int(getattr(timing, "rows", 0) or 0)
        if bucket <= 0:
            return
        rows = int(getattr(timing, "rows", 0) or 0)
        with self._lock:
            key = (str(segment), bucket)
            rec = self._measured.get(key)
            if rec is None:
                rec = self._measured[key] = _BucketRecord()
            rec.fold(timing, self.ewma)
            if rows > 0:
                hist = self._size_hist.setdefault(str(segment), {})
                hist[rows] = hist.get(rows, 0) + 1

    def observe_stats(self, segment: str, stats, start: int = 0) -> int:
        """Fold ``stats.records[start:]`` of an IngestStats; returns the new
        high-water index (incremental folding without double counting)."""
        records = list(getattr(stats, "records", ()))[start:]
        for t in records:
            self.observe_batch(segment, t)
        return start + len(records)

    def ingest_costs(self, costs: Dict[str, Dict[str, Dict[str, Any]]]
                     ) -> None:
        """Fold a ``CompileCache.costs()`` payload: {segment: {shape key:
        {flops, bytes_accessed, compile_s, ...}}} keyed down to buckets."""
        with self._lock:
            for label, shapes in (costs or {}).items():
                for shape, rec in shapes.items():
                    bucket = bucket_of_shape(shape)
                    if bucket is None or bucket <= 0:
                        continue
                    dst = self._analytic.setdefault(
                        (str(label), bucket), {})
                    for k in ("flops", "bytes_accessed", "compile_s",
                              "output_bytes", "argument_bytes"):
                        v = rec.get(k)
                        if isinstance(v, (int, float)):
                            dst[k] = float(v)

    def observe_host(self, stage: str, seconds: float, rows: int) -> None:
        """Fold one host-path stage execution (ms per row EWMA)."""
        if rows <= 0 or seconds < 0:
            return
        per_row = seconds * 1e3 / rows
        with self._lock:
            cur = self._host.get(str(stage))
            if cur is None:
                self._host[str(stage)] = [per_row, 1]
            else:
                cur[0] = (1 - self.ewma) * cur[0] + self.ewma * per_row
                cur[1] += 1

    def observe_collective(self, op: str, nbytes: float, seconds: float
                           ) -> None:
        """Fold one measured collective probe (parallel/shardplan.py
        ``measure_collectives``): op is ``"all_reduce"``/``"all_gather"``,
        ``nbytes`` the payload size, ``seconds`` the measured wall time."""
        if nbytes <= 0 or seconds < 0:
            return
        with self._lock:
            pts = self._collective.setdefault(str(op), [])
            pts.append((float(nbytes), float(seconds) * 1e3))
            if len(pts) > 64:  # bound: keep the freshest calibration
                del pts[:-64]

    def _collective_fit(self, op: str) -> Optional[Tuple[float, float]]:
        """(latency_ms, ms_per_byte) least-squares fit over the probe
        points for one op; None when no points exist."""
        pts = self._collective.get(str(op))
        if not pts:
            return None
        if len(pts) == 1 or len({b for b, _ in pts}) == 1:
            b0, ms0 = pts[-1]
            return 0.0, ms0 / b0  # proportional through the origin
        n = float(len(pts))
        sx = sum(b for b, _ in pts)
        sy = sum(m for _, m in pts)
        sxx = sum(b * b for b, _ in pts)
        sxy = sum(b * m for b, m in pts)
        denom = n * sxx - sx * sx
        slope = (n * sxy - sx * sy) / denom
        alpha = (sy - slope * sx) / n
        return max(0.0, alpha), max(0.0, slope)

    def collective_ms(self, op: str, nbytes: float) -> Optional[float]:
        """Predicted wall ms of one ``op`` collective moving ``nbytes``
        (fitted latency + α·bytes); None until a probe has been folded."""
        with self._lock:
            fit = self._collective_fit(op)
        if fit is None or nbytes < 0:
            return None
        alpha, per_byte = fit
        return alpha + per_byte * float(nbytes)

    def collective_calibrated(self, op: Optional[str] = None) -> bool:
        """True once measured probes back the op's collective term (any op
        when None) — the second gate in front of ``choose_sharding``."""
        with self._lock:
            ops = [str(op)] if op else list(self._collective)
            return any(len(self._collective.get(o) or ()) >= 2
                       for o in ops)

    def segment_bytes(self, segment: str, key: str = "output_bytes"
                      ) -> Optional[float]:
        """Mean harvested byte count over the segment's analytic records
        (``output_bytes``/``argument_bytes``/``bytes_accessed``) — the
        collective payload estimate ``choose_sharding`` candidates carry."""
        with self._lock:
            vals = [rec[key] for (s, _), rec in self._analytic.items()
                    if s == str(segment) and isinstance(
                        rec.get(key), (int, float))]
        return sum(vals) / len(vals) if vals else None

    # -- prediction ------------------------------------------------------
    def _analytic_ms(self, key: Tuple[str, int]) -> Optional[float]:
        rec = self._analytic.get(key)
        if not rec:
            return None
        peaks = self.peaks()
        t_f = rec.get("flops", 0.0) / float(peaks["flops"])
        t_b = rec.get("bytes_accessed", 0.0) / float(peaks["bytes_per_s"])
        bound = max(t_f, t_b)
        return bound * 1e3 if bound > 0 else None

    def _buckets_of(self, segment: str) -> List[int]:
        return sorted({b for (s, b) in self._measured if s == segment} |
                      {b for (s, b) in self._analytic if s == segment})

    def _ms_at_bucket(self, segment: str, bucket: int
                      ) -> Tuple[Optional[float], str, float]:
        """(predicted ms, source, confidence) at one exact bucket.

        Measured EWMA when trusted; else analytical roofline, scaled by the
        segment's measured/bound ratio when any bucket of the segment has
        both (the "learned correction" on top of the analytical form)."""
        key = (segment, bucket)
        rec = self._measured.get(key)
        if rec is not None and rec.n >= self.min_obs:
            wall = rec.wall_ms()
            if wall is not None:
                return wall, "measured", rec.n / (rec.n + float(self.min_obs))
        bound = self._analytic_ms(key)
        if bound is None:
            return None, "none", 0.0
        # correction factor: mean measured/bound over calibrated buckets
        ratios = []
        for (s, b), m in self._measured.items():
            if s != segment or m.n < self.min_obs:
                continue
            other = self._analytic_ms((segment, b))
            wall = m.wall_ms()
            if other and wall and other > 0:
                ratios.append(wall / other)
        if ratios:
            return (bound * sum(ratios) / len(ratios), "analytic+corrected",
                    0.3)
        return bound, "analytic", 0.1

    def _interp_ms(self, segment: str, bucket: int
                   ) -> Tuple[Optional[float], str, float]:
        """Prediction at an ARBITRARY bucket: exact record when present,
        else linear interpolation/extrapolation over the known buckets
        (batch cost is affine in rows to first order: fixed dispatch +
        per-row compute)."""
        exact = self._ms_at_bucket(segment, bucket)
        if exact[0] is not None:
            return exact
        pts = []
        for b in self._buckets_of(segment):
            ms, _, conf = self._ms_at_bucket(segment, b)
            if ms is not None:
                pts.append((b, ms, conf))
        if not pts:
            return None, "none", 0.0
        if len(pts) == 1:
            b0, ms0, conf = pts[0]
            # proportional with a fixed-cost floor: half the known point
            return ms0 * max(0.5, bucket / b0), "scaled", conf * 0.5
        pts.sort()
        lo = max((p for p in pts if p[0] <= bucket), default=pts[0])
        hi = min((p for p in pts if p[0] >= bucket), default=pts[-1])
        if lo[0] == hi[0]:
            lo, hi = pts[0], pts[-1]
        slope = (hi[1] - lo[1]) / float(hi[0] - lo[0])
        ms = lo[1] + slope * (bucket - lo[0])
        conf = min(lo[2], hi[2]) * 0.8
        return max(ms, 1e-6), "interpolated", conf

    def predict(self, segment: str, batch: Optional[int] = None,
                shape: Optional[str] = None) -> Optional[Dict[str, Any]]:
        """Full prediction record for one batch of ``batch`` rows (or the
        bucket parsed from a CompileCache ``shape`` key): ``{ms, bucket,
        source, confidence, parts}`` or None when the model knows nothing
        about the segment."""
        if batch is None and shape is not None:
            batch = bucket_of_shape(shape)
        if batch is None or batch <= 0:
            return None
        with self._lock:
            ms, source, conf = self._interp_ms(str(segment), int(batch))
            if ms is None:
                return None
            out: Dict[str, Any] = {"ms": round(ms, 6), "bucket": int(batch),
                                   "source": source,
                                   "confidence": round(conf, 4)}
            rec = self._measured.get((str(segment), int(batch)))
            if rec is not None and rec.n > 0:
                out["parts"] = {k[:-2] + "_ms": round(getattr(rec, k), 6)
                                for k in _STAGES
                                if getattr(rec, k) is not None}
                out["observed_batches"] = rec.n
            return out

    def predict_ms(self, segment: str, shape: Optional[str] = None,
                   batch: Optional[int] = None) -> Optional[float]:
        rec = self.predict(segment, batch=batch, shape=shape)
        return None if rec is None else rec["ms"]

    def per_row_ms(self, segment: str, batch: int = 32) -> Optional[float]:
        """Predicted per-ROW service at bucket ``batch`` — the packing key
        of the multimodel planner (``predict_ms x forecast_rps``,
        serving/fleet/planner.py pack_models). None while uncalibrated:
        the planner gives the model a measured-probe slot instead."""
        if batch <= 0:
            return None
        ms = self.predict_ms(segment, batch=int(batch))
        return None if ms is None else ms / int(batch)

    def confidence(self, segment: str) -> float:
        """Calibration confidence for a segment: the best single-bucket
        confidence (0.0 = unknown, >= 0.5 once min_obs batches measured)."""
        with self._lock:
            best = 0.0
            for b in self._buckets_of(str(segment)):
                _, _, conf = self._ms_at_bucket(str(segment), b)
                best = max(best, conf)
            return round(best, 4)

    def calibrated(self, segment: Optional[str] = None) -> bool:
        """True once MEASURED data (not just analytical bounds) backs the
        segment — the gate in front of every knob change."""
        with self._lock:
            keys = [k for k in self._measured
                    if segment is None or k[0] == str(segment)]
            return any(self._measured[k].n >= self.min_obs for k in keys)

    # -- knob decisions --------------------------------------------------
    def choose_buckets(self, segment: str, max_bucket: int,
                       max_buckets: int = 6,
                       candidates: Optional[Sequence[int]] = None
                       ) -> Optional[Tuple[int, ...]]:
        """Bucket set minimizing predicted batch cost + compile
        amortization over the segment's OBSERVED batch-size histogram.

        Candidates default to the observed real sizes, their next multiples
        of 8, and the power-of-two defaults (all capped at ``max_bucket``).
        Every observed size must map to the smallest chosen bucket >= it;
        each chosen bucket that has never compiled charges its predicted
        compile time amortized over ``compile_horizon`` batches. Returns
        None until the segment is calibrated — the caller then keeps the
        power-of-two default, so an uncalibrated model changes nothing."""
        seg = str(segment)
        if not self.calibrated(seg):
            return None
        with self._lock:
            hist = dict(self._size_hist.get(seg) or {})
        hist = {n: c for n, c in hist.items() if 0 < n <= max_bucket}
        if not hist:
            return None
        if candidates is None:
            cand = set()
            for n in hist:
                cand.add(n)
                cand.add(min(max_bucket, (n + 7) // 8 * 8))
            b = 8
            while b < max_bucket:
                cand.add(b)
                b <<= 1
            cand.add(max_bucket)
            candidates = sorted(c for c in cand if c >= 1)
        else:
            candidates = sorted({int(c) for c in candidates
                                 if 0 < int(c) <= max_bucket})
        if not candidates or candidates[-1] < max(hist):
            return None
        with self._lock:
            compiled = {b for (s, b) in self._analytic if s == seg} | \
                {b for (s, b) in self._measured if s == seg}
            ms_at = {}
            for c in candidates:
                ms, _, _ = self._interp_ms(seg, c)
                if ms is None:
                    return None
                ms_at[c] = ms
            compile_ms = [rec.get("compile_s", 0.0) * 1e3
                          for (s, _), rec in self._analytic.items()
                          if s == seg and rec.get("compile_s")]
        amort = (sum(compile_ms) / len(compile_ms) / self.compile_horizon
                 if compile_ms else 0.0)

        def score(chosen: Tuple[int, ...]) -> float:
            total = 0.0
            for n, count in hist.items():
                b = next((c for c in chosen if c >= n), chosen[-1])
                total += count * ms_at[b]
            total += sum(amort for b in chosen if b not in compiled)
            return total

        # exact search over small candidate sets, greedy refinement above
        best: Optional[Tuple[int, ...]] = None
        best_score = float("inf")
        top = candidates[-1]
        rest = candidates[:-1]
        if len(rest) <= 12:
            for mask in range(1 << len(rest)):
                chosen = tuple(c for i, c in enumerate(rest)
                               if mask >> i & 1) + (top,)
                if len(chosen) > max_buckets:
                    continue
                s = score(chosen)
                if s < best_score - 1e-12:
                    best, best_score = chosen, s
        else:
            chosen = (top,)
            best, best_score = chosen, score(chosen)
            improved = True
            while improved and len(best) < max_buckets:
                improved = False
                for c in rest:
                    if c in best:
                        continue
                    trial = tuple(sorted(best + (c,)))
                    s = score(trial)
                    if s < best_score - 1e-12:
                        best, best_score = trial, s
                        improved = True
        return best

    def fuse_decision(self, label: str) -> Optional[bool]:
        """Predicted fuse-vs-host comparison for a segment label
        (``"StageA+StageB"``): True when the predicted DEVICE per-row cost
        undercuts the summed measured HOST per-row cost of its stages,
        False when it doesn't, None when either side lacks trustworthy data
        (the planner keeps the light-segment heuristic)."""
        seg = str(label)
        if not self.calibrated(seg):
            return None
        with self._lock:
            host_total = 0.0
            for stage in seg.split("+"):
                rec = self._host.get(stage)
                if rec is None or rec[1] < self.min_obs:
                    return None
                host_total += rec[0]
            # device ms/row at the modal measured bucket
            best_key, best_n = None, 0
            for (s, b), rec in self._measured.items():
                if s == seg and rec.n > best_n and rec.rows > 0:
                    best_key, best_n = (s, b), rec.n
            if best_key is None or best_n < self.min_obs:
                return None
            rec = self._measured[best_key]
            wall = rec.wall_ms()
            if wall is None:
                return None
            device_per_row = wall * rec.n / rec.rows
        return device_per_row < host_total

    def choose_mega_k(self, segment: str, max_k: int = 8,
                      amortize_to: float = 0.15) -> Optional[int]:
        """Dispatch-amortization factor for a segment: the K micro-batches a
        single Python-level mega-dispatch should cover so the measured fixed
        dispatch cost falls to ``amortize_to`` of the per-batch device work
        (H2D + compute + readback EWMAs at the modal measured bucket).
        Returns None when uncalibrated or the modal bucket lacks a dispatch
        measurement; 1 when dispatch is already cheap enough. Reads the
        DE-AMORTIZED per-call dispatch EWMA (``dispatch_call_s``), so the
        chosen K stays stable while a K>1 mega dispatch is active instead
        of oscillating back to 1 on its own amortized timings."""
        seg = str(segment)
        if not self.calibrated(seg):
            return None
        with self._lock:
            best_rec, best_n = None, 0
            for (s, _b), rec in self._measured.items():
                if s == seg and rec.n > best_n:
                    best_rec, best_n = rec, rec.n
            if best_rec is None or best_n < self.min_obs:
                return None
            disp = best_rec.dispatch_call_s
            if disp is None:
                disp = best_rec.dispatch_s
            if disp is None or disp <= 0.0:
                return None
            work = sum(v for v in (best_rec.h2d_s, best_rec.compute_s,
                                   best_rec.readback_s) if v is not None)
        if work <= 0.0:
            return None
        if disp <= amortize_to * work:
            return 1
        k = int(math.ceil(disp / (amortize_to * work)))
        return max(1, min(int(max_k), k))

    def predict_sharded_ms(self, segment: str, batch: int, shards: int,
                           collective_bytes: float = 0.0,
                           op: str = "all_gather") -> Optional[float]:
        """Predicted wall ms for one ``batch``-row dispatch sharded
        ``shards`` ways: the single-device prediction at the PER-SHARD
        batch (ceil(batch/shards) — compute and memory traffic divide
        across chips) plus the measured collective term for moving
        ``collective_bytes`` through ``op``. None when the segment
        prediction is unknown, or when a nonzero collective payload has no
        calibrated term (an unpriced collective must not look free)."""
        shards = max(1, int(shards))
        per_shard = (int(batch) + shards - 1) // shards
        base = self.predict_ms(segment, batch=per_shard)
        if base is None:
            return None
        coll = 0.0
        if collective_bytes > 0:
            fitted = self.collective_ms(op, collective_bytes)
            if fitted is None:
                return None
            coll = fitted
        return base + coll

    def choose_sharding(self, segment: str, batch: int,
                        candidates: Sequence[Dict[str, Any]],
                        margin: float = 0.95) -> Optional[str]:
        """Pick the candidate partitioning (``{name, shards, op,
        collective_bytes}`` descriptions from ``shardplan.
        tuner_candidates``) whose predicted sharded wall undercuts the
        unsharded prediction by at least ``1 - margin``; None keeps the
        segment unsharded. Gated on BOTH ``calibrated(segment)`` and
        ``collective_calibrated()``: an uncalibrated model must change
        nothing, so cold-start stays bitwise-identical to the single-device
        path."""
        seg = str(segment)
        if not self.calibrated(seg) or not self.collective_calibrated():
            return None
        base = self.predict_ms(seg, batch=int(batch))
        if base is None:
            return None
        best_name: Optional[str] = None
        best_ms = base * float(margin)
        for cand in candidates or ():
            shards = int(cand.get("shards", 1) or 1)
            if shards <= 1:
                continue
            ms = self.predict_sharded_ms(
                seg, int(batch), shards,
                collective_bytes=float(cand.get("collective_bytes", 0.0)
                                       or 0.0),
                op=str(cand.get("op", "all_gather")))
            if ms is not None and ms < best_ms:
                best_ms = ms
                best_name = str(cand.get("name"))
        return best_name

    def predict_pipelined_ms(self, stage_labels: Sequence[str], batch: int,
                             microbatches: int = 8,
                             handoff_bytes: float = 0.0,
                             op: str = "pipe_handoff") -> Optional[float]:
        """Predicted wall ms for streaming ``microbatches`` micro-batches
        of ``batch`` rows through pipeline stages whose segment labels are
        ``stage_labels``: the pipeline clock is its slowest stage, paid
        ``M + S - 1`` ticks (the GPipe fill/drain bubble), plus the fitted
        inter-stage transfer term for the ``M * (S - 1)`` device-to-device
        handoffs. Gated exactly like :meth:`choose_sharding`: None unless
        EVERY stage is calibrated and a nonzero handoff payload has a
        fitted transfer cost — an unpriced pipeline must not look free, so
        cold start stays bitwise-identical to the unpipelined path."""
        labels = [str(s) for s in stage_labels]
        if not labels:
            return None
        per: list = []
        for lab in labels:
            if not self.calibrated(lab):
                return None
            ms = self.predict_ms(lab, batch=int(batch))
            if ms is None:
                return None
            per.append(ms)
        n_stages = len(per)
        hand = 0.0
        if handoff_bytes > 0 and n_stages > 1:
            fitted = self.collective_ms(op, handoff_bytes)
            if fitted is None:
                return None
            hand = fitted
        m = max(1, int(microbatches))
        return (m + n_stages - 1) * max(per) + m * (n_stages - 1) * hand

    def choose_pipe_depth(self, chain_labels: Sequence[str], batch: int,
                          max_depth: int, microbatches: int = 8,
                          handoff_bytes: float = 0.0,
                          op: str = "pipe_handoff",
                          margin: float = 0.95) -> Optional[int]:
        """Pipeline depth for a chainable segment run: the best contiguous
        grouping of ``chain_labels`` into 2..``max_depth`` stages (each
        stage's cost is the sum of its members, the clock their max) whose
        predicted pipelined wall undercuts the serial wall by at least
        ``1 - margin``. None keeps the chain serial. Gated on every label
        being ``calibrated`` and — for a nonzero handoff payload — on a
        fitted ``op`` transfer term, mirroring :meth:`choose_sharding` so
        an uncalibrated model changes nothing."""
        labels = [str(s) for s in chain_labels]
        if len(labels) < 2 or int(max_depth) < 2:
            return None
        per: list = []
        for lab in labels:
            if not self.calibrated(lab):
                return None
            ms = self.predict_ms(lab, batch=int(batch))
            if ms is None:
                return None
            per.append(ms)
        hand = 0.0
        if handoff_bytes > 0:
            if not self.collective_calibrated(op):
                return None
            fitted = self.collective_ms(op, handoff_bytes)
            if fitted is None:
                return None
            hand = fitted
        m = max(1, int(microbatches))
        serial = m * sum(per)
        best_depth: Optional[int] = None
        best_ms = serial * float(margin)
        for depth in range(2, min(int(max_depth), len(per)) + 1):
            clock = _min_max_contiguous(per, depth)
            total = (m + depth - 1) * clock + m * (depth - 1) * hand
            if total < best_ms:
                best_ms = total
                best_depth = depth
        return best_depth

    def _modal_record(self, segment: str) -> Optional[_BucketRecord]:
        """Most-observed measured record of a segment when it clears
        ``min_obs``; caller holds the lock."""
        best, best_n = None, 0
        for (s, _b), rec in self._measured.items():
            if s == segment and rec.n > best_n:
                best, best_n = rec, rec.n
        return best if best is not None and best_n >= self.min_obs else None

    def stitch_decision(self, upstream: str, downstream: str,
                        margin: float = 0.95) -> Optional[bool]:
        """Should the planner stitch ``downstream`` into ``upstream``'s
        segment across a transpiled host shim? True when the measured
        round-trip the merge removes — upstream readback + downstream H2D +
        downstream dispatch EWMAs at the modal buckets — is worth at least
        ``1 - margin`` of the combined measured wall (``predict_ms`` backs
        the walls). None until BOTH sides are calibrated: an uncalibrated
        model must change nothing, so cold-start plans stay
        bitwise-identical."""
        up, down = str(upstream), str(downstream)
        if not self.calibrated(up) or not self.calibrated(down):
            return None
        with self._lock:
            up_rec = self._modal_record(up)
            down_rec = self._modal_record(down)
            if up_rec is None or down_rec is None:
                return None
            saved = sum(v for v in (up_rec.readback_s, down_rec.h2d_s,
                                    down_rec.dispatch_s) if v is not None)
            walls = [r.wall_ms() for r in (up_rec, down_rec)]
        if saved <= 0.0 or any(w is None for w in walls):
            return None
        return saved > (1.0 - float(margin)) * sum(walls)

    def observe_variant(self, segment: str, bucket: int, variant: str,
                        seconds: float) -> None:
        """Fold one measured kernel-variant trial at (segment, bucket);
        variant ``"default"`` tracks the incumbent baseline the candidates
        must beat."""
        if seconds < 0 or bucket <= 0:
            return
        ms = float(seconds) * 1e3
        with self._lock:
            key = (str(segment), int(bucket), str(variant))
            cur = self._variant.get(key)
            if cur is None:
                self._variant[key] = [ms, 1]
            else:
                cur[0] = (1 - self.ewma) * cur[0] + self.ewma * ms
                cur[1] += 1

    def variant_buckets(self, segment: str) -> List[int]:
        """Buckets of a segment that have any kernel-variant trial data."""
        with self._lock:
            return sorted({b for (s, b, _v) in self._variant
                           if s == str(segment)})

    def choose_variant(self, segment: str, bucket: int,
                       margin: float = 0.95) -> Optional[str]:
        """Winning kernel variant at one (segment, bucket): the candidate
        whose trial EWMA undercuts the measured ``"default"`` baseline by
        at least ``1 - margin``, both sides backed by ``min_obs`` trials.
        None keeps the built-in default — so with no trials folded (cold
        start) nothing changes."""
        seg, b = str(segment), int(bucket)
        with self._lock:
            base = self._variant.get((seg, b, "default"))
            if base is None or base[1] < self.min_obs:
                return None
            best_id: Optional[str] = None
            best_ms = base[0] * float(margin)
            for (s, bb, vid), rec in sorted(self._variant.items()):
                if s != seg or bb != b or vid == "default":
                    continue
                if rec[1] >= self.min_obs and rec[0] < best_ms:
                    best_id, best_ms = vid, rec[0]
        return best_id

    def observe_nnz(self, segment: str, rows: int, nnz: int,
                    width: int) -> None:
        """Fold one sparse-column staging observation (rows of the
        partition, total nonzeros, declared feature width) — fed by the
        executor's CSR/densify staging and by bench harnesses. The EWMA
        tracks nnz PER ROW so the prediction scales to any batch size."""
        if rows <= 0 or nnz < 0 or width <= 0:
            return
        per_row = float(nnz) / float(rows)
        with self._lock:
            cur = self._nnz.get(str(segment))
            if cur is None:
                self._nnz[str(segment)] = [per_row, float(width), 1]
            else:
                cur[0] = (1 - self.ewma) * cur[0] + self.ewma * per_row
                cur[1] = (1 - self.ewma) * cur[1] + self.ewma * float(width)
                cur[2] += 1

    def nnz_bytes(self, segment: str, batch: int) -> Optional[float]:
        """Predicted CSR wire bytes for one ``batch``-row staging of the
        segment's sparse column: values (f32) + indices (i32) per nonzero
        plus the i32 indptr — bytes ≈ f(nnz), not N x F. None until an
        ``observe_nnz`` has been folded (the roofline's nnz-aware bound
        and the layout decision both gate on it)."""
        if batch <= 0:
            return None
        with self._lock:
            rec = self._nnz.get(str(segment))
        if rec is None:
            return None
        return batch * rec[0] * 8.0 + (batch + 1) * 4.0

    def dense_bytes(self, segment: str, batch: int) -> Optional[float]:
        """Densified staging bytes for the same batch (rows x observed
        width x f32) — the side the CSR prediction must undercut."""
        if batch <= 0:
            return None
        with self._lock:
            rec = self._nnz.get(str(segment))
        if rec is None:
            return None
        return batch * rec[1] * 4.0

    def choose_layout(self, segment: str,
                      margin: float = 0.5) -> Optional[str]:
        """Should the executor stage this segment's sparse columns as CSR
        wire triples? ``"csr"`` when the predicted per-row wire bytes
        (8·nnz/row + indptr) undercut the densified row (width x f32) by
        at least ``margin`` — sparse enough that the transfer and gather
        win is robust to the density EWMA drifting. None (keep densify)
        otherwise, and ALWAYS None until the segment is calibrated AND the
        density term has ``min_obs`` observations: an uncalibrated model
        changes nothing, so cold start stays bitwise-identical."""
        seg = str(segment)
        if not self.calibrated(seg):
            return None
        with self._lock:
            rec = self._nnz.get(seg)
        if rec is None or rec[2] < self.min_obs or rec[1] <= 0:
            return None
        csr_row = rec[0] * 8.0 + 4.0
        dense_row = rec[1] * 4.0
        if csr_row < dense_row * float(margin):
            return "csr"
        return None

    # -- introspection / serialization -----------------------------------
    def host_ms_per_row(self, stage: str) -> Optional[float]:
        with self._lock:
            rec = self._host.get(str(stage))
            return None if rec is None else round(rec[0], 6)

    def segments(self) -> List[str]:
        with self._lock:
            return sorted({s for (s, _) in self._measured} |
                          {s for (s, _) in self._analytic})

    def prediction_error(self) -> Dict[str, Dict[str, Any]]:
        """Analytical-vs-measured error per (segment, bucket) that has
        both: the perf_report "predicted vs measured" table, and the
        honesty check on the analytical form itself."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for (seg, b), rec in sorted(self._measured.items()):
                if rec.n < self.min_obs:
                    continue
                wall = rec.wall_ms()
                bound = self._analytic_ms((seg, b))
                if wall is None:
                    continue
                row: Dict[str, Any] = {"measured_ms": round(wall, 4),
                                       "batches": rec.n}
                if bound is not None and bound > 0:
                    row["analytic_ms"] = round(bound, 6)
                    row["error_ratio"] = round(wall / bound, 4)
                out.setdefault(seg, {})[str(b)] = row
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            measured = {f"{s}:{b}": rec.to_dict()
                        for (s, b), rec in sorted(self._measured.items())}
            host = {k: {"ms_per_row": round(v[0], 6), "n": v[1]}
                    for k, v in sorted(self._host.items())}
            n_analytic = len(self._analytic)
            variants = {f"{s}:{b}:{v}": {"ms": round(rec[0], 6), "n": rec[1]}
                        for (s, b, v), rec in sorted(self._variant.items())}
            nnz = {s: {"nnz_per_row": round(rec[0], 4),
                       "width": round(rec[1], 2), "n": int(rec[2])}
                   for s, rec in sorted(self._nnz.items())}
        segs = self.segments()
        out = {"segments": segs,
               "calibrated": {s: self.calibrated(s) for s in segs},
               "confidence": {s: self.confidence(s) for s in segs},
               "measured": measured, "host_stages": host,
               "analytic_records": n_analytic,
               "peak_source": self.peaks().get("peak_source")}
        if variants:  # key absent when unused: stats payload parity
            out["variant_trials"] = variants
        if nnz:  # key absent when no sparse data seen: payload parity
            out["nnz"] = nnz
        return out

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "version": 1,
                "ewma": self.ewma, "min_obs": self.min_obs,
                "compile_horizon": self.compile_horizon,
                "measured": {f"{s}\x00{b}": rec.to_dict()
                             for (s, b), rec in self._measured.items()},
                "analytic": {f"{s}\x00{b}": dict(rec)
                             for (s, b), rec in self._analytic.items()},
                "size_hist": {s: {str(n): c for n, c in h.items()}
                              for s, h in self._size_hist.items()},
                "host": {k: list(v) for k, v in self._host.items()},
                "collectives": {op: [list(p) for p in pts]
                                for op, pts in self._collective.items()},
            }
            if self._variant:  # key absent when unused: payload parity
                out["variants"] = {f"{s}\x00{b}\x00{v}": list(rec)
                                   for (s, b, v), rec in
                                   self._variant.items()}
            if self._nnz:  # key absent when no sparse data seen
                out["nnz"] = {s: list(rec)
                              for s, rec in self._nnz.items()}
            return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any],
                  peaks: Optional[Dict[str, Any]] = None
                  ) -> "SegmentCostModel":
        m = cls(peaks=peaks, ewma=float(d.get("ewma", 0.3)),
                min_obs=int(d.get("min_obs", 4)),
                compile_horizon=int(d.get("compile_horizon", 200)))

        def split(key: str) -> Tuple[str, int]:
            seg, b = key.rsplit("\x00", 1)
            return seg, int(b)

        for key, rec in (d.get("measured") or {}).items():
            m._measured[split(key)] = _BucketRecord.from_dict(rec)
        for key, rec in (d.get("analytic") or {}).items():
            m._analytic[split(key)] = {k: float(v) for k, v in rec.items()}
        for seg, hist in (d.get("size_hist") or {}).items():
            m._size_hist[seg] = {int(n): int(c) for n, c in hist.items()}
        for k, v in (d.get("host") or {}).items():
            m._host[k] = [float(v[0]), int(v[1])]
        for op, pts in (d.get("collectives") or {}).items():
            m._collective[op] = [(float(p[0]), float(p[1])) for p in pts]
        for key, rec in (d.get("variants") or {}).items():
            seg, b, vid = key.rsplit("\x00", 2)
            m._variant[(seg, int(b), vid)] = [float(rec[0]), int(rec[1])]
        for seg, rec in (d.get("nnz") or {}).items():
            m._nnz[seg] = [float(rec[0]), float(rec[1]), int(rec[2])]
        return m
