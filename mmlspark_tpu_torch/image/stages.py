"""Image pipeline stages (the port of ``mmlspark_tpu/image/stages.py``):
ImageTransformer, ResizeImageTransformer, UnrollImage, UnrollBinaryImage and
ImageSetAugmenter.

All stages read and write ImageSchema struct columns (core/schema.py) —
per-row dicts of {origin, height, width, nChannels, mode, data} with an HWC
numpy array payload. ImageTransformer and ResizeImageTransformer also fuse
(``device_fn``), with the reference's split: the longest device-exact op
suffix runs batched on the device (``ops.image``'s mirrors, bit for bit
the host ops); resize and the blurs (f64 host arithmetic) run per row in
the segment's ``prepare`` with the unfused code; and the host chain's
dtype changes (threshold's f64, the blurs' f32) are replayed in
``finalize`` (``_host_forced_dtype``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..core.dataframe import DataFrame
from ..core.device_stage import DeviceFn, FusionUnsupported
from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Transformer
from ..core.schema import ColType, ImageSchema, Schema
from ..ops import image as ops


def _f32_exact(v) -> bool:
    """True when ``float(v)`` round-trips through float32 unchanged — the
    precondition for host-f64 scalar arithmetic (numpy promotes python
    floats to f64) to agree bitwise with the device's f32 compute."""
    try:
        return float(np.float32(v)) == float(v)
    except (TypeError, ValueError, OverflowError):
        return False


def _op_device_exact(op) -> bool:
    """Image ops with a bitwise-exact batched device mirror (ops/image.py).

    resize/blur/gaussianKernel compute through f64 interpolation on host and
    therefore run in the fused segment's host `prepare` instead. threshold
    is exact only when its scalars are f32-representable: the host compares
    in f64 (python-float promotion) and a non-representable threshold could
    split values differently than the device's f32 compare.
    """
    kind = op.get("op")
    if kind in ("crop", "flip"):
        return True
    if kind == "threshold":
        return _f32_exact(op.get("threshold")) and _f32_exact(op.get("maxVal", 255.0))
    if kind == "colorFormat":
        return op.get("format") in ("gray", "grayscale", "bgr2rgb", "rgb2bgr")
    return False


def _split_device_ops(op_list):
    """Split an op chain into (host prefix, device-exact suffix)."""
    k = len(op_list)
    while k > 0 and _op_device_exact(op_list[k - 1]):
        k -= 1
    return list(op_list[:k]), list(op_list[k:])


def _host_forced_dtype(op_list):
    """Replay the host chain's dtype transitions: the dtype the LAST
    dtype-forcing op leaves behind (None = input dtype passes through).
    threshold promotes to f64 (numpy python-float scalar promotion); the
    blurs cast to f32. The fused finalize widens the device f32 readback
    back to this dtype — exact under the _op_device_exact gates."""
    forced = None
    for op in op_list:
        kind = op.get("op")
        if kind == "threshold":
            forced = np.float64
        elif kind in ("blur", "gaussianKernel"):
            forced = np.float32
    return forced


def _apply_device_op(x, op):
    """Batched [B,H,W,C] mirror of ImageTransformer._apply_op for the
    device-exact subset."""
    kind = op["op"]
    if kind == "crop":
        return ops.crop_batch(x, op["x"], op["y"], op["height"], op["width"])
    if kind == "flip":
        return ops.flip_batch(x, op.get("flipCode", 1))
    if kind == "threshold":
        return ops.threshold_batch(x, op["threshold"], op.get("maxVal", 255.0),
                                   op.get("type", "binary"))
    if kind == "colorFormat":
        return ops.color_format_batch(x, op["format"])
    raise FusionUnsupported(f"image op {kind!r} has no device mirror")


def _image_rows_to_arrays(col, apply_host_ops=None):
    """Struct/array rows -> (array rows, origins): the unfused per-row host
    path (ImageSchema.to_array + optional host ops), shared by the fusion
    `prepare` hooks below."""
    out = np.empty(len(col), dtype=object)
    origins = np.empty(len(col), dtype=object)
    for i, row in enumerate(col):
        if row is None:
            out[i] = None
            origins[i] = ""
            continue
        img = ImageSchema.to_array(row) if ImageSchema.is_image(row) \
            else np.asarray(row)
        origins[i] = row.get("origin", "") if isinstance(row, dict) else ""
        if apply_host_ops is not None:
            img = apply_host_ops(img)
        out[i] = np.asarray(img)
    return out, origins


def _image_struct_finalize(in_col, out_col, cast_dtype=None):
    """finalize hook: readback batch -> image-struct column, carrying the
    input rows' origins forward exactly like the host path does.
    ``cast_dtype`` widens the device f32 readback to the host chain's
    forced dtype (_host_forced_dtype) — an exact widening under the
    _op_device_exact gates."""

    def finalize(outs, ctx):
        arr = np.asarray(outs[out_col])
        if cast_dtype is not None and arr.dtype != cast_dtype:
            arr = arr.astype(cast_dtype)
        origins = ctx.get(f"origins:{in_col}")
        if origins is None:
            origins = ctx.get(f"origins:{out_col}")
        col = np.empty(len(arr), dtype=object)
        for i in range(len(arr)):
            origin = origins[i] if origins is not None else ""
            col[i] = ImageSchema.make(np.asarray(arr[i]), origin or "")
        ctx[f"origins:{out_col}"] = origins if origins is not None \
            else np.array([""] * len(arr), dtype=object)
        return {out_col: col}

    return finalize


def _image_accepts(probes):
    """Runtime dtype gate for image batches: uint8/float32 rows of rank
    2/3 (f64 images would narrow lossily on the wire — host path)."""
    for p in probes.values():
        if p["dtype"] is None:
            continue
        if p["dtype"] not in (np.dtype(np.uint8), np.dtype(np.float32)):
            return False
        if p["ndim"] not in (2, 3):
            return False
    return True


class ImageTransformer(Transformer, HasInputCol, HasOutputCol):
    """Composable image-op pipeline on an image column.

    Reference: opencv/ImageTransformer.scala:26-150 — an ordered list of OpenCV
    stages (ResizeImage/CropImage/ColorFormat/Flip/Blur/Threshold/GaussianKernel)
    applied per image. Here each op is a dict {"op": name, ...params} executed by
    the numpy kernels in ops/image.py.
    """

    stages = Param("stages", "Ordered list of image ops", None, ptype=list)

    def __init__(self, **kwargs):
        kwargs.setdefault("inputCol", "image")
        kwargs.setdefault("outputCol", "image")
        kwargs.setdefault("stages", [])
        super().__init__(**kwargs)

    # -- fluent op builders (mirroring the reference's .resize(...) etc.) --
    def _add(self, **op) -> "ImageTransformer":
        st = list(self.get("stages"))
        st.append(op)
        return self.set("stages", st)

    def resize(self, height: int, width: int) -> "ImageTransformer":
        return self._add(op="resize", height=height, width=width)

    def crop(self, x: int, y: int, height: int, width: int) -> "ImageTransformer":
        return self._add(op="crop", x=x, y=y, height=height, width=width)

    def color_format(self, format: str) -> "ImageTransformer":
        return self._add(op="colorFormat", format=format)

    def flip(self, flip_code: int = 1) -> "ImageTransformer":
        return self._add(op="flip", flipCode=flip_code)

    def blur(self, height: int, width: int) -> "ImageTransformer":
        return self._add(op="blur", height=height, width=width)

    def threshold(self, threshold: float, max_val: float = 255.0,
                  threshold_type: str = "binary") -> "ImageTransformer":
        return self._add(op="threshold", threshold=threshold, maxVal=max_val,
                         type=threshold_type)

    def gaussian_kernel(self, applied_width: int, sigma: float) -> "ImageTransformer":
        return self._add(op="gaussianKernel", appliedWidth=applied_width, sigma=sigma)

    # -- execution ---------------------------------------------------------
    @staticmethod
    def _apply_op(img: np.ndarray, op: Dict[str, Any]) -> np.ndarray:
        kind = op["op"]
        if kind == "resize":
            return ops.resize(img, op["height"], op["width"])
        if kind == "crop":
            return ops.crop(img, op["x"], op["y"], op["height"], op["width"])
        if kind == "colorFormat":
            return ops.color_format(img, op["format"])
        if kind == "flip":
            return ops.flip(img, op.get("flipCode", 1))
        if kind == "blur":
            return ops.box_blur(img, op["height"], op["width"])
        if kind == "threshold":
            return ops.threshold(img, op["threshold"], op.get("maxVal", 255.0),
                                 op.get("type", "binary"))
        if kind == "gaussianKernel":
            return ops.gaussian_blur(img, op["sigma"], op.get("appliedWidth"))
        raise ValueError(f"Unknown image op {kind!r}")

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")
        stage_list = self.get("stages")

        def fn(part):
            col = part[in_col]
            out = np.empty(len(col), dtype=object)
            for i, row in enumerate(col):
                if row is None:
                    out[i] = None
                    continue
                img = ImageSchema.to_array(row) if ImageSchema.is_image(row) else np.asarray(row)
                origin = row.get("origin", "") if isinstance(row, dict) else ""
                for op in stage_list:
                    img = self._apply_op(img, op)
                out[i] = ImageSchema.make(np.asarray(img), origin)
            return out

        return df.with_column(out_col, fn)

    def transform_schema(self, schema: Schema) -> Schema:
        schema.require(self.get_or_throw("inputCol"))
        out = schema.copy()
        out.types[self.get_or_throw("outputCol")] = ColType.STRUCT
        return out

    def device_fn(self, schema: Schema):
        """Fusion contract: the longest device-exact op suffix runs batched
        on device; any prefix (resize/blur — f64 host arithmetic) runs
        per-row in `prepare` through the SAME _apply_op code the unfused
        path uses, so fused == unfused bitwise either way."""
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")
        op_list = list(self.get("stages") or [])
        host_ops, dev_ops = _split_device_ops(op_list)
        key = ("ImageTransformer", in_col, out_col,
               tuple(tuple(sorted(op.items())) for op in op_list))

        def prepare(cols, ctx):
            def host_chain(img):
                for op in host_ops:
                    img = self._apply_op(img, op)
                return img

            rows, origins = _image_rows_to_arrays(
                cols[in_col], host_chain if host_ops else None)
            ctx[f"origins:{in_col}"] = origins
            if out_col != in_col:
                ctx[f"origins:{out_col}"] = origins
            return {in_col: rows}

        def fn(params, env):
            x = env[in_col]
            if x.ndim not in (3, 4):
                raise FusionUnsupported("image batch must be [B,H,W(,C)]")
            for op in dev_ops:
                x = _apply_device_op(x, op)
            return {out_col: x}

        return DeviceFn(
            key=key, in_cols=(in_col,), out_cols=(out_col,), fn=fn,
            prepare=prepare,
            finalize=_image_struct_finalize(in_col, out_col,
                                            _host_forced_dtype(op_list)),
            accepts=_image_accepts,
            # a host-op prefix cannot be replayed on device-resident input:
            # the planner starts a new segment here in that case
            internal_ok=not host_ops)


class ResizeImageTransformer(Transformer, HasInputCol, HasOutputCol):
    """Resize an image column (reference image/ResizeImageTransformer.scala — AWT resize)."""

    height = Param("height", "Target height", None, lambda v: v > 0, int)
    width = Param("width", "Target width", None, lambda v: v > 0, int)
    nChannels = Param("nChannels", "Force channel count (1 or 3)", None, ptype=int)

    def __init__(self, **kwargs):
        kwargs.setdefault("inputCol", "image")
        kwargs.setdefault("outputCol", "image")
        super().__init__(**kwargs)

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")
        h, w = self.get_or_throw("height"), self.get_or_throw("width")
        nch = self.get("nChannels")

        def fn(part):
            col = part[in_col]
            out = np.empty(len(col), dtype=object)
            for i, row in enumerate(col):
                if row is None:
                    out[i] = None
                    continue
                img = ImageSchema.to_array(row) if ImageSchema.is_image(row) else np.asarray(row)
                img = ops.resize(img, h, w)
                if nch == 1 and (img.ndim == 3 and img.shape[2] != 1):
                    img = ops.color_format(img, "gray")
                elif nch == 3 and (img.ndim == 2 or img.shape[2] == 1):
                    img = np.repeat(img.reshape(h, w, 1), 3, axis=2)
                origin = row.get("origin", "") if isinstance(row, dict) else ""
                out[i] = ImageSchema.make(np.asarray(img), origin)
            return out

        return df.with_column(out_col, fn)

    def device_fn(self, schema: Schema):
        """Fusion contract: the resize + channel fix run per-row in
        `prepare` (the unfused host code — bilinear resize is f64 host
        arithmetic with no exact device mirror); the device body is the
        identity, which still lets this stage head a fused segment so the
        resized batch uploads ONCE for everything downstream."""
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")
        h, w = self.get_or_throw("height"), self.get_or_throw("width")
        nch = self.get("nChannels")
        key = ("ResizeImageTransformer", in_col, out_col, h, w, nch)

        def host_resize(img):
            img = ops.resize(img, h, w)
            if nch == 1 and (img.ndim == 3 and img.shape[2] != 1):
                img = ops.color_format(img, "gray")
            elif nch == 3 and (img.ndim == 2 or img.shape[2] == 1):
                img = np.repeat(img.reshape(h, w, 1), 3, axis=2)
            return img

        def prepare(cols, ctx):
            rows, origins = _image_rows_to_arrays(cols[in_col], host_resize)
            ctx[f"origins:{in_col}"] = origins
            if out_col != in_col:
                ctx[f"origins:{out_col}"] = origins
            return {in_col: rows}

        def fn(params, env):
            return {out_col: env[in_col]}

        return DeviceFn(
            key=key, in_cols=(in_col,), out_cols=(out_col,), fn=fn,
            prepare=prepare, finalize=_image_struct_finalize(in_col, out_col),
            accepts=_image_accepts, internal_ok=False)


class UnrollImage(Transformer, HasInputCol, HasOutputCol):
    """Image struct column -> flat CHW float vector column
    (reference image/UnrollImage.scala:28-53)."""

    def __init__(self, **kwargs):
        kwargs.setdefault("inputCol", "image")
        kwargs.setdefault("outputCol", "unrolled")
        super().__init__(**kwargs)

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")

        def fn(part):
            col = part[in_col]
            out = np.empty(len(col), dtype=object)
            for i, row in enumerate(col):
                if row is None:
                    out[i] = None
                    continue
                img = ImageSchema.to_array(row) if ImageSchema.is_image(row) else np.asarray(row)
                out[i] = ops.unroll_chw(img)
            return out

        return df.with_column(out_col, fn)

    def transform_schema(self, schema: Schema) -> Schema:
        schema.require(self.get_or_throw("inputCol"))
        out = schema.copy()
        out.types[self.get_or_throw("outputCol")] = ColType.VECTOR
        return out


class UnrollBinaryImage(Transformer, HasInputCol, HasOutputCol):
    """Binary (encoded bytes) column -> decode -> optional resize -> flat CHW vector
    (reference image/UnrollImage.scala UnrollBinaryImage)."""

    height = Param("height", "Resize height (optional)", None, ptype=int)
    width = Param("width", "Resize width (optional)", None, ptype=int)

    def __init__(self, **kwargs):
        kwargs.setdefault("inputCol", "value")
        kwargs.setdefault("outputCol", "unrolled")
        super().__init__(**kwargs)

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")
        h, w = self.get("height"), self.get("width")

        def fn(part):
            col = part[in_col]
            out = np.empty(len(col), dtype=object)
            for i, raw in enumerate(col):
                if raw is None:
                    out[i] = None
                    continue
                img = ops.decode_image(bytes(raw)) if isinstance(raw, (bytes, bytearray)) \
                    else np.asarray(raw)
                if img is None:
                    out[i] = None
                    continue
                if h is not None and w is not None:
                    img = ops.resize(img, h, w)
                out[i] = ops.unroll_chw(img)
            return out

        return df.with_column(out_col, fn)


class ImageSetAugmenter(Transformer, HasInputCol, HasOutputCol):
    """Dataset augmentation by flips (reference image/ImageSetAugmenter.scala):
    emits the original rows plus one extra copy per enabled flip."""

    flipLeftRight = Param("flipLeftRight", "Add horizontally-flipped copies", True, ptype=bool)
    flipUpDown = Param("flipUpDown", "Add vertically-flipped copies", False, ptype=bool)

    def __init__(self, **kwargs):
        kwargs.setdefault("inputCol", "image")
        kwargs.setdefault("outputCol", "image")
        super().__init__(**kwargs)

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")
        dfs = [df.with_column(out_col, lambda p: p[in_col])]

        def flipper(code):
            def fn(part):
                col = part[in_col]
                out = np.empty(len(col), dtype=object)
                for i, row in enumerate(col):
                    if row is None:
                        out[i] = None
                        continue
                    img = (ImageSchema.to_array(row)
                           if ImageSchema.is_image(row) else np.asarray(row))
                    origin = row.get("origin", "") if isinstance(row, dict) else ""
                    out[i] = ImageSchema.make(ops.flip(img, code), origin)
                return out
            return fn

        if self.get("flipLeftRight"):
            dfs.append(df.with_column(out_col, flipper(1)))
        if self.get("flipUpDown"):
            dfs.append(df.with_column(out_col, flipper(0)))
        result = dfs[0]
        for d in dfs[1:]:
            result = result.union(d.select(*result.columns))
        return result
