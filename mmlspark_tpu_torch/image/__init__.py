"""Image pipeline stages (the port of ``mmlspark_tpu.image``): transform,
resize, unroll, augment, featurize.

Parity targets: opencv/ImageTransformer.scala, image/ResizeImageTransformer.scala,
image/UnrollImage.scala, image/ImageSetAugmenter.scala, image/ImageFeaturizer.scala.
"""

from .featurizer import ImageFeaturizer
from .stages import (
    ImageSetAugmenter,
    ImageTransformer,
    ResizeImageTransformer,
    UnrollBinaryImage,
    UnrollImage,
)

__all__ = [
    "ImageFeaturizer", "ImageSetAugmenter", "ImageTransformer",
    "ResizeImageTransformer", "UnrollBinaryImage", "UnrollImage",
]
