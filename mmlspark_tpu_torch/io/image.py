"""Image reading and decoding into ImageSchema struct columns (the port of
``mmlspark_tpu/io/image.py``).

Reference: io/image/ImageUtils.scala:1-159 (decode BufferedImage into
ImageSchema rows) and the image datasource
(org/apache/spark/ml/source/image/PatchedImageFileFormat.scala).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.dataframe import DataFrame
from ..core.schema import ImageSchema
from ..ops.image import decode_image
from .binary import read_binary_files


def read_images(path: str, recursive: bool = True, sample_ratio: float = 1.0,
                drop_invalid: bool = True, num_partitions: int = 1,
                seed: int = 0) -> DataFrame:
    """Directory -> DataFrame[{path, image: ImageSchema struct}]."""
    raw = read_binary_files(path, recursive, sample_ratio, inspect_zip=True,
                            seed=seed, num_partitions=num_partitions)
    df = to_image_column(raw, bytes_col="bytes", path_col="path",
                         output_col="image")
    df = df.drop("bytes")
    if drop_invalid:
        df = df.dropna(subset=["image"])
    return df


def to_image_column(df: DataFrame, bytes_col: str = "bytes",
                    path_col: Optional[str] = None,
                    output_col: str = "image") -> DataFrame:
    """Decode an encoded-bytes column into ImageSchema structs
    (undecodable rows become None)."""

    def fn(p):
        col = p[bytes_col]
        origins = p[path_col] if path_col and path_col in p else None
        out = np.empty(len(col), dtype=object)
        for i, blob in enumerate(col):
            if blob is None:
                out[i] = None
                continue
            arr = decode_image(bytes(blob))
            if arr is None:
                out[i] = None
            else:
                out[i] = ImageSchema.make(
                    arr, str(origins[i]) if origins is not None else "")
        return out

    return df.with_column(output_col, fn)
