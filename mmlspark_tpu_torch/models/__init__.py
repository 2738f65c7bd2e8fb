"""Neural-network models on PyTorch (the port of ``mmlspark_tpu.models``):
the named-layer module system, the transformer encoder with K5 (the
hand-written flash-attention kernel, ``csrc/flash_attn.cu``) on its
attention and K6/K7 (``csrc/flash_attn_bwd.cu``) on its gradient, the
(Bi)LSTM tagger, the ``DNNModel`` pipeline stage, and the weights
carry-over from the JAX reference. Training (``models.training``) and its
checkpoints (``models.checkpoint``) are submodules, as in the reference."""

from .attention import (
    LSTM,
    BiLSTM,
    Embed,
    LayerNorm,
    MultiHeadAttention,
    bilstm_tagger,
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

__all__ = ["BiLSTM", "DNNModel", "Dense", "Embed", "Fn", "FunctionModel",
           "LSTM", "LayerNorm", "Module", "MultiHeadAttention", "Residual",
           "Sequential", "bilstm_tagger", "dense_attention", "flash_route",
           "load_jax_params", "matmul_dtype", "matmul_precision",
           "transformer_block", "transformer_encoder"]
