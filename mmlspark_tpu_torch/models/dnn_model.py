"""DNNModel — DNN inference as a pipeline stage (the port of
``mmlspark_tpu/models/dnn_model.py``, CNTKModel parity).

The reference's path: parameters resident on the device once per
transform, rows minibatched into static-shape batches (power-of-two bucket
padding for the last one), one compiled forward per batch fetching every
requested node, outputs cropped to the real rows and coerced to per-row
float32 arrays; null input rows give null output rows. Here the forward is
an eager PyTorch forward under ``torch.inference_mode()``, batches ride the
port's ``TransferRing`` (pinned staging on a copy stream, ``ringDepth``
batches in flight), and the parameters go to the device through
``FunctionModel.device_params``.

A multi-input model (an imported ONNX graph with several graph inputs,
``GraphModule``) takes a ``feedDict`` naming a column for each input: every
fed column is batched and staged to the device, and the forward gets them
as a dict. Such a model stays unfused (``device_fn`` returns None), and a
``preprocess`` spec beside a multi-input feed raises, as in the reference.

``useMesh`` shards evaluation over a mesh's data axis (one process a
rank, ``parallel.mesh``): on by itself under a ``MeshContext`` whose data
axis is above 1, ``True`` builds a default mesh if none is set, ``False``
keeps one device. Every rank transforms the same frame: a batch that the
data axis divides is split into row blocks, each rank runs its own, and
the outputs are gathered over the data group (the reference's
``fetch_global``); a batch it does not divide runs whole on every rank, the
reference's route for it. Mesh eval stays unfused (``device_fn`` is None).
``donateInputs`` is accepted and does nothing but warn: the staged batch is
freed once its forward has run, so there is no buffer to donate.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, HasBatchSize, HasInputCol, HasOutputCol, Param
from ..core.pipeline import Model
from ..core.schema import ColType, Schema
from ..parallel.batching import Minibatcher, _crop, concat_outputs
from ..parallel.ingest import (IngestStats, PreprocessSpec, ReadbackSlots,
                               TransferRing, stage_array)
from .module import FunctionModel


class DNNModel(Model, HasInputCol, HasOutputCol, HasBatchSize):
    """Evaluate a FunctionModel over an input column of arrays.

    Mirrors CNTKModel's public surface: set_model, inputCol/outputCol,
    set_feed_dict (the primary input) / set_fetch_dict (several outputs, all
    fetched in ONE forward), set_output_node / set_output_node_index,
    set_mini_batch_size. Runs on CUDA unless the caller wraps it in
    ``runtime.use_device("cpu")``.
    """

    model = ComplexParam("model", "The FunctionModel to evaluate")
    outputNode = Param("outputNode", "Named layer to fetch (None = final output)",
                       None, ptype=str)
    feedDict = Param("feedDict",
                     "Map of model argument names (ARGUMENT_i or graph input "
                     "names; keys) to input column names (values) — the "
                     "multi-input form of inputCol", None, ptype=dict)
    fetchDict = Param("fetchDict",
                      "Map of output column names (keys) to fetch nodes "
                      "(OUTPUT_i or layer paths; values), all fetched in ONE "
                      "forward pass", None, ptype=dict)
    batchSize = Param("batchSize", "Rows per evaluation minibatch", 64,
                      lambda v: v > 0, int)
    preprocess = ComplexParam(
        "preprocess",
        "PreprocessSpec run on the device ahead of the forward (cast/scale/"
        "offset/layout-transpose), so input batches travel in their wire "
        "dtype. Single-input models only.")
    ringDepth = Param("ringDepth",
                      "In-flight batches in the transfer ring: the next "
                      "batches' H2D + compute overlap the previous fetch",
                      2, lambda v: v > 0, int)
    donateInputs = Param("donateInputs",
                         "Accepted for the reference's surface; no effect "
                         "here but a warning (the staged batch is freed "
                         "after its forward)",
                         None, ptype=bool)
    useMesh = Param("useMesh",
                    "Shard eval batches over the mesh's data axis; None "
                    "(default) = auto: on whenever a mesh whose data axis "
                    "is above 1 has been set via MeshContext.set. True also "
                    "builds a default mesh if none is set; False forces "
                    "one device.", None, ptype=bool)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._last_ingest_stats: Optional[IngestStats] = None

    @property
    def last_ingest_stats(self) -> Optional[IngestStats]:
        """Ingest decomposition of the most recent transform() (queue/h2d/
        compute/readback per batch, bytes, overlap ratio)."""
        return self._last_ingest_stats

    # -- fluent setters mirroring the reference API -----------------------
    def set_model(self, model: FunctionModel) -> "DNNModel":
        return self.set("model", model)

    def get_model(self) -> FunctionModel:
        return self.get_or_throw("model")

    def set_output_node(self, node: str) -> "DNNModel":
        return self.set("outputNode", node)

    def set_output_node_index(self, i: int) -> "DNNModel":
        return self.set("outputNode", f"OUTPUT_{i}")

    def set_mini_batch_size(self, n: int) -> "DNNModel":
        return self.set("batchSize", n)

    def set_preprocess(self, spec: Optional[PreprocessSpec]) -> "DNNModel":
        return self.set("preprocess", spec)

    def set_ring_depth(self, n: int) -> "DNNModel":
        return self.set("ringDepth", n)

    def set_feed_dict(self, *args) -> "DNNModel":
        """set_feed_dict({arg: col, ...}) or set_feed_dict(arg, col)."""
        d = {args[0]: args[1]} if len(args) == 2 else dict(args[0])
        return self.set("feedDict", d)

    def set_fetch_dict(self, *args) -> "DNNModel":
        """set_fetch_dict({col: node, ...}) or set_fetch_dict(col, node)."""
        d = {args[0]: args[1]} if len(args) == 2 else dict(args[0])
        return self.set("fetchDict", d)

    # -- I/O maps ----------------------------------------------------------
    def _io_maps(self, model: FunctionModel):
        """(input name -> column, out column -> tap) from either the dict
        params or the single-column params."""
        feed = self.get("feedDict")
        if feed:
            in_map = {model.resolve_input(k): v for k, v in feed.items()}
        else:
            in_map = {model.resolve_input("ARGUMENT_0"):
                      self.get_or_throw("inputCol")}
        fetch = self.get("fetchDict")
        if fetch:
            out_map = {c: model.resolve_output(n) for c, n in fetch.items()}
        else:
            out_map = {self.get_or_throw("outputCol"):
                       model.resolve_output(self.get("outputNode"))}
        return in_map, out_map

    def _plan(self, model: FunctionModel):
        """(input name -> column, output columns, taps, multi_in).
        ``multi_in`` unless the map is exactly {primary input: column}: a
        single entry naming a secondary input goes through the dict feed
        too, so that GraphModule refuses the incomplete feed instead of
        binding the column to the primary input."""
        in_map, out_map = self._io_maps(model)
        multi_in = list(in_map) != model.argument_names()[:1]
        out_cols = tuple(out_map)
        return in_map, out_cols, tuple(out_map[c] for c in out_cols), multi_in

    def device_fn(self, schema: Schema):
        """Fusion contract: the input column (through the optional
        PreprocessSpec) and ONE forward fetching every tap — the same torch
        ops the unfused path runs, so fused == unfused bitwise at the same
        batch size. Mesh eval and multi-input models keep the unfused
        path."""
        from ..core.device_stage import DeviceFn

        model = self.get("model")
        if model is None or self.get("useMesh") is True:
            return None
        if self._mesh() is not None:
            return None
        in_map, out_cols, taps, multi_in = self._plan(model)
        if multi_in:
            return None   # multi-input feedDict eval stays unfused
        in_col = list(in_map.values())[0]
        spec: Optional[PreprocessSpec] = self.get("preprocess")
        key = ("DNNModel", model.cache_token(), in_col, out_cols, taps,
               None if spec is None else spec.cache_key())

        def fn(params: FunctionModel, env):
            # the program cache is keyed by architecture, not weights: the
            # weights come in as ``params`` (this stage's model) each call
            x = env[in_col]
            if spec is not None:
                x = spec.apply_device(x)
            acts = params.apply_taps(x, list(taps),
                                     params=params.device_params(x.device))
            # f32 on device == the unfused float32 readback
            return {c: acts[t].to(torch.float32)
                    for c, t in zip(out_cols, taps)}

        def accepts(probes):
            p = probes.get(in_col)
            if p is None or p["dtype"] is None:
                return True
            return p["sparse"] or p["dtype"].kind in "fuib"

        return DeviceFn(key=key, in_cols=(in_col,), out_cols=out_cols, fn=fn,
                        params=model, accepts=accepts, reject_sparse=False,
                        heavy=True,
                        # flat [N, F] inputs may shard their feature dim
                        # over the tensor axis (parallel/shardplan.py)
                        shard_dims={in_col: 1})

    def transform_schema(self, schema: Schema) -> Schema:
        if self.get("model") is None:
            # schema-only validation before the model is set: the column
            # params (node-name resolution needs a live model)
            feed = self.get("feedDict")
            in_cols = list(feed.values()) if feed \
                else [self.get_or_throw("inputCol")]
            fetch = self.get("fetchDict")
            out_cols = list(fetch) if fetch else [self.get_or_throw("outputCol")]
        else:
            in_map, out_map = self._io_maps(self.get_model())
            in_cols, out_cols = list(in_map.values()), list(out_map)
        for col in in_cols:
            schema.require(col)
        out = schema.copy()
        for col in out_cols:
            out.types[col] = ColType.VECTOR
        return out

    def _mesh(self, build: bool = False):
        """The mesh eval shards over, or None: ``MeshContext``'s (built
        when ``useMesh`` is True and ``build``), when its data axis is
        above 1."""
        from ..parallel.mesh import DATA_AXIS, MeshContext

        use = self.get("useMesh")
        if use is False:
            return None
        mesh = MeshContext.get() if (use and build) else MeshContext.current()
        if mesh is not None and mesh.shape.get(DATA_AXIS, 1) > 1:
            return mesh
        return None

    def transform(self, df: DataFrame) -> DataFrame:
        from ..parallel.mesh import DATA_AXIS, all_gather_axis
        from ..runtime import default_device

        device = default_device()
        mesh = self._mesh(build=True)
        if self.get("donateInputs"):
            warnings.warn("DNNModel: donateInputs has no effect in the "
                          "PyTorch port (the staged batch is freed after its "
                          "forward)", stacklevel=2)
        model = self.get_model()
        in_map, out_cols, taps, multi_in = self._plan(model)
        in_cols = list(in_map.values())
        spec: Optional[PreprocessSpec] = self.get("preprocess")
        if spec is not None and multi_in:
            raise ValueError(
                "preprocess spec applies to single-input models only "
                "(feedDict consumers preprocess per column upstream)")
        batcher = Minibatcher(self.get("batchSize"), bucket=True,
                              dtype=np.float32, preserve_int=True)
        stats = IngestStats()
        self._last_ingest_stats = stats
        params = model.device_params(device)   # resident once per transform
        slots = ReadbackSlots(pin=device.type == "cuda")   # for every ring

        def put(batch) -> Tuple[Any, int]:
            # every fed column staged to the device: a dict for the
            # multi-input graph, the one tensor otherwise
            if multi_in:
                return ({name: stage_array(batch.arrays[col], device)
                         for name, col in in_map.items()}, batch.num_valid)
            return (stage_array(batch.arrays[in_cols[0]], device),
                    batch.num_valid)

        def forward(x):
            if spec is not None:
                x = spec.apply_device(x)
            acts = model.apply_taps(x, list(taps), params=params)
            return tuple(acts[t] for t in taps)

        def step(staged):
            x, num_valid = staged
            rows = next(iter(x.values())) if multi_in else x
            n = int(rows.shape[0])
            shards = 1 if mesh is None else mesh.shape[DATA_AXIS]
            if shards == 1 or n % shards:
                # one device, or a batch the data axis does not divide:
                # every rank runs it whole
                return forward(x), num_valid
            blk = slice(mesh.coord(DATA_AXIS) * (n // shards),
                        (mesh.coord(DATA_AXIS) + 1) * (n // shards))
            mine = {k: v[blk] for k, v in x.items()} if multi_in else x[blk]
            with torch.inference_mode():
                ys = tuple(all_gather_axis(y, mesh, DATA_AXIS, dim=0)
                           for y in forward(mine))
            return ys, num_valid

        def fetch(handle) -> Tuple[torch.Tensor, ...]:
            # crop the bucket padding before the readback; the cast runs on
            # the ring's readback stream
            ys, num_valid = handle
            return tuple(y.to(torch.float32) for y in _crop(ys, num_valid))

        def eval_partition(part):
            n = len(part[in_cols[0]])
            cols: Dict[str, np.ndarray] = {c: np.empty(n, dtype=object)
                                           for c in out_cols}
            # null inputs produce null outputs (CNTKModel emits null rows
            # for undecodable inputs rather than failing the partition); a
            # row is valid only if every fed column is non-null
            valid_idx = np.array(
                [i for i in range(n)
                 if all(part[c][i] is not None for c in in_cols)],
                dtype=np.int64)
            if len(valid_idx):
                sub = {c: part[c][valid_idx] for c in in_cols}
                ring = TransferRing(batcher.batches(sub, in_cols),
                                    put=put, step=step, fetch=fetch,
                                    depth=self.get("ringDepth"), stats=stats,
                                    device=device, slots=slots)
                outs = list(ring)
                for ci, c in enumerate(out_cols):
                    full = concat_outputs([o[ci] for o in outs])
                    for j, i in enumerate(valid_idx):
                        cols[c][i] = full[j]
            out = dict(part)
            out.update(cols)
            return out

        return df.map_partitions(eval_partition)
