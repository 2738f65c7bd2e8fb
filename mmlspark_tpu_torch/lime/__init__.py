"""Model interpretability: LIME for tabular data and images (reference lime/).

TabularLIME/TabularLIMEModel (lime/LIME.scala:164-220), ImageLIME (superpixel
masking + sampled probes + per-row lasso, LIME.scala:43-158), SLIC superpixels
(lime/Superpixel.scala:143+), SuperpixelTransformer.

The port of ``mmlspark_tpu.lime``: the same draws and superpixels on the
host, a partition's probes scored in one ``transform`` and its lassos
fitted in one batched call on the card (``ops.lasso.fit_lasso_batch``).
"""

from .superpixel import Superpixel, SuperpixelTransformer, slic
from .lime import ImageLIME, TabularLIME, TabularLIMEModel

__all__ = ["ImageLIME", "Superpixel", "SuperpixelTransformer", "TabularLIME",
           "TabularLIMEModel", "slic"]
