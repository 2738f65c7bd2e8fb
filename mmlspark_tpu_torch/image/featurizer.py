"""ImageFeaturizer — headless-CNN transfer learning and featurization (the
port of ``mmlspark_tpu/image/featurizer.py``).

Reference: image/ImageFeaturizer.scala:133-178 — pick an output node by
cutting ``cutOutputLayers`` layers off the head (the model's
``layer_names``, head-first), resize inputs to the model's size, and
delegate to the DNN stage. Resize runs on the host per image (decode,
resize and the channel fix are host code); ``DNNModel`` runs the batched
forward on the card, fetching the tapped activation directly.

Wire format: batches ship to the device as **uint8** (the decoded pixel
dtype) by default; the float cast, the ``scaleFactor`` multiply and any
NCHW layout transpose run on the device ahead of the forward
(``PreprocessSpec``, parallel/ingest.py): 4x fewer host-to-device bytes
than a host-side ``astype(float32) * scale``, with the same numbers (a
uint8 -> f32 cast and an f32 multiply are exact). ``hostPreprocess=True``
does them on the host and ships float32.

The NCHW branch (``data_format == "NCHW"``) serves imported ONNX backbones
(ROADMAP A7d). Under a ``MeshContext`` whose data axis is above 1 the
featurizer stays out of fusion (``device_fn`` is None), as the reference's
does: its wrapped ``DNNModel`` shards the forward over the mesh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.device_stage import DeviceFn, FusionUnsupported
from ..core.params import ComplexParam, HasInputCol, HasOutputCol, Param
from ..core.pipeline import Transformer
from ..core.schema import ColType, ImageSchema, Schema
from ..models.dnn_model import DNNModel
from ..models.module import FunctionModel
from ..ops import image as ops
from ..parallel.ingest import PreprocessSpec


class ImageFeaturizer(Transformer, HasInputCol, HasOutputCol):
    """Featurize images (or encoded-image bytes) through a headless CNN.

    Batches ride the host->device link in their decoded dtype (uint8 by
    default — the uint8-wire default); ``scaleFactor`` scaling and NCHW
    layout transposes run on the device ahead of the forward
    (PreprocessSpec).
    """

    model = ComplexParam("model", "The FunctionModel backbone")
    cutOutputLayers = Param("cutOutputLayers",
                            "How many layers to cut off the head (1 = pooled features)",
                            1, lambda v: v >= 0, int)
    dropNa = Param("dropNa", "Drop rows whose image failed to decode", True, ptype=bool)
    batchSize = Param("batchSize", "Eval minibatch size", 64, lambda v: v > 0, int)
    scaleFactor = Param("scaleFactor", "Multiply pixel values (1/255 to normalize)",
                        1.0, ptype=float)
    hostPreprocess = Param(
        "hostPreprocess",
        "Do the float cast / scale / layout transpose on the HOST per image "
        "(the legacy float32 wire format, 4x the H2D bytes). Default False: "
        "pixels stay uint8 on the wire and preprocessing fuses into the "
        "device's forward.", False, ptype=bool)
    ringDepth = Param("ringDepth",
                      "In-flight batches in the DNN transfer ring", 2,
                      lambda v: v > 0, int)

    def __init__(self, **kwargs):
        kwargs.setdefault("inputCol", "image")
        kwargs.setdefault("outputCol", "features")
        super().__init__(**kwargs)
        self._dnn_cache = None  # (key, DNNModel), reused across calls

    def set_model(self, model: FunctionModel) -> "ImageFeaturizer":
        return self.set("model", model)

    def set_cut_output_layers(self, n: int) -> "ImageFeaturizer":
        return self.set("cutOutputLayers", n)

    def _output_node(self, model: FunctionModel) -> Optional[str]:
        cut = self.get("cutOutputLayers")
        if cut == 0:
            return None  # full head output
        if cut >= len(model.layer_names):
            raise ValueError(
                f"cutOutputLayers={cut} but model has {len(model.layer_names)} cut points")
        return model.layer_names[cut]

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")
        model: FunctionModel = self.get_or_throw("model")
        fmt = getattr(model, "data_format", "NHWC")
        if fmt == "NCHW":  # imported ONNX backbones
            c, h, w = model.input_shape
        else:
            h, w, c = model.input_shape
        scale = self.get("scaleFactor")
        host_pre = self.get("hostPreprocess")
        # device-side preprocess: float cast + scale on device, plus the
        # HWC -> CHW layout move for ONNX backbones; the wire keeps the
        # decoded dtype (uint8 images: 4x fewer H2D bytes)
        spec = PreprocessSpec(scale=scale,
                              transpose=(2, 0, 1) if fmt == "NCHW" else None)

        # 1. normalize input rows to fixed-shape HWC arrays (auto-resize,
        #    reference ImageFeaturizer.scala:141-165); dtype is preserved
        #    (wire dtype) unless hostPreprocess is set
        def prep(part):
            col = part[in_col]
            out = np.empty(len(col), dtype=object)
            for i, row in enumerate(col):
                img = None
                if row is None:
                    pass
                elif isinstance(row, (bytes, bytearray)):
                    img = ops.decode_image(bytes(row))
                elif ImageSchema.is_image(row):
                    img = ImageSchema.to_array(row)
                else:
                    img = np.asarray(row)
                    if img.ndim == 1:  # unrolled CHW vector
                        img = np.moveaxis(img.reshape(c, h, w), 0, -1)
                if img is None:
                    out[i] = None
                    continue
                img = ops.resize(img, h, w)
                if img.ndim == 2:
                    img = img[:, :, None]
                if img.shape[2] != c:
                    img = (np.repeat(img[:, :, :1], c, axis=2) if img.shape[2] < c
                           else img[:, :, :c])
                out[i] = spec.apply_host_row(img) if host_pre \
                    else np.ascontiguousarray(img)
            return out

        prepped = df.with_column("__dnn_input__", prep)
        if self.get("dropNa"):
            prepped = prepped.dropna(subset=["__dnn_input__"])

        node = self._output_node(model)
        key = (id(model), node, out_col, self.get("batchSize"),
               None if host_pre else spec, self.get("ringDepth"))
        if self._dnn_cache is None or self._dnn_cache[0] != key:
            dnn = DNNModel(inputCol="__dnn_input__", outputCol=out_col,
                           batchSize=self.get("batchSize"),
                           ringDepth=self.get("ringDepth"))
            dnn.set_model(model)
            if not host_pre:
                dnn.set_preprocess(spec)
            if node is not None:
                dnn.set_output_node(node)
            self._dnn_cache = (key, dnn)
        dnn = self._dnn_cache[1]
        return dnn.transform(prepped).drop("__dnn_input__")

    @property
    def last_ingest_stats(self):
        """Ingest decomposition of the most recent transform (delegates to
        the wrapped DNNModel) — None before the first transform."""
        return self._dnn_cache[1].last_ingest_stats if self._dnn_cache else None

    def device_fn(self, schema: Schema):
        """Fusion contract: decode/resize/channel-fix run per-row in
        `prepare` (the unfused host prep); the device body is the channel
        fix mirror + PreprocessSpec + ONE forward to the tapped activation.
        Upstream in-segment image stages feed it device-resident batches —
        trace-time shape gates fall back when (H, W) does not match the
        backbone."""
        model: Optional[FunctionModel] = self.get("model")
        if model is None:
            return None
        from ..parallel.mesh import DATA_AXIS, MeshContext

        mesh = MeshContext.current()
        if mesh is not None and mesh.shape.get(DATA_AXIS, 1) > 1:
            return None  # mesh-sharded eval keeps the unfused path
        fmt = getattr(model, "data_format", "NHWC")
        if fmt == "NCHW":
            c, h, w = model.input_shape
        else:
            h, w, c = model.input_shape
        spec = PreprocessSpec(scale=self.get("scaleFactor"),
                              transpose=(2, 0, 1) if fmt == "NCHW" else None)
        node = self._output_node(model)
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")
        # cache_token (not id): the shared CompileCache key must survive a
        # process restart for the fleet's persistent tier to hit
        key = ("ImageFeaturizer", in_col, out_col, model.cache_token(),
               node, spec.cache_key(), h, w, c)

        def prepare(cols, ctx):
            # the unfused per-row prep (decode -> resize -> channel fix);
            # the spec runs on DEVICE in both hostPreprocess modes — its ops
            # are exact, so the wire stays the decoded dtype
            col = cols[in_col]
            out = np.empty(len(col), dtype=object)
            for i, row in enumerate(col):
                img = None
                if row is None:
                    pass
                elif isinstance(row, (bytes, bytearray)):
                    img = ops.decode_image(bytes(row))
                elif ImageSchema.is_image(row):
                    img = ImageSchema.to_array(row)
                else:
                    img = np.asarray(row)
                    if img.ndim == 1:
                        img = np.moveaxis(img.reshape(c, h, w), 0, -1)
                if img is None:
                    out[i] = None
                    continue
                img = ops.resize(img, h, w)
                if img.ndim == 2:
                    img = img[:, :, None]
                if img.shape[2] != c:
                    img = (np.repeat(img[:, :, :1], c, axis=2)
                           if img.shape[2] < c else img[:, :, :c])
                out[i] = np.ascontiguousarray(img)
            return {in_col: out}

        def accepts(probes):
            p = probes.get(in_col)
            if p is None or p["dtype"] is None:
                return True
            return p["dtype"].kind in "fuib" and p["ndim"] in (2, 3)

        def fn(params: FunctionModel, env):
            # the program cache is keyed by architecture, not weights: the
            # weights come in as ``params`` (this stage's model) each call
            x = env[in_col]
            if x.dim() == 3:
                x = x[:, :, :, None]
            if x.dim() != 4:
                raise FusionUnsupported("image batch must be [B,H,W,C]")
            if (x.shape[1], x.shape[2]) != (h, w):
                raise FusionUnsupported(
                    f"input {x.shape[1]}x{x.shape[2]} != backbone {h}x{w}; "
                    f"resize upstream (host prep only runs at segment heads)")
            x = ops.fix_channels_batch(x, c)
            y = spec.apply_device(x)
            act = params.apply_taps(y, [node],
                                    params=params.device_params(y.device))[node]
            # f32 on device == the unfused float32 readback
            return {out_col: act.to(torch.float32)}

        return DeviceFn(
            key=key, in_cols=(in_col,), out_cols=(out_col,), fn=fn,
            params=model, prepare=prepare, accepts=accepts,
            reject_sparse=False, drop_invalid=bool(self.get("dropNa")),
            heavy=True)

    def transform_schema(self, schema: Schema) -> Schema:
        schema.require(self.get_or_throw("inputCol"))
        out = schema.copy()
        out.types[self.get_or_throw("outputCol")] = ColType.VECTOR
        return out
