"""Neural-network models on PyTorch (the port of ``mmlspark_tpu.models``):
the named-layer module system, the transformer encoder with K5 (the
hand-written flash-attention kernel, ``csrc/flash_attn.cu``) on its
attention, the ``DNNModel`` pipeline stage, and the weights carry-over from
the JAX reference."""

from .attention import (
    Embed,
    LayerNorm,
    MultiHeadAttention,
    dense_attention,
    flash_route,
    transformer_block,
    transformer_encoder,
)
from .convert import load_jax_params
from .dnn_model import DNNModel
from .module import (
    Dense,
    Fn,
    FunctionModel,
    Module,
    Residual,
    Sequential,
    matmul_dtype,
    matmul_precision,
)

__all__ = ["DNNModel", "Dense", "Embed", "Fn", "FunctionModel", "LayerNorm",
           "Module", "MultiHeadAttention", "Residual", "Sequential",
           "dense_attention", "flash_route", "load_jax_params", "matmul_dtype",
           "matmul_precision", "transformer_block", "transformer_encoder"]
