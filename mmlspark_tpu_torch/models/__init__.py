"""Neural-network models on PyTorch (the port of ``mmlspark_tpu.models``):
the named-layer module system with the convolution, BatchNorm and pooling
layers, the ResNet family and its torchvision import, the transformer
encoder with K5 (the hand-written flash-attention kernel,
``csrc/flash_attn.cu``) on its attention and K6/K7
(``csrc/flash_attn_bwd.cu``) on its gradient, the switch-MoE FFN, the
(Bi)LSTM tagger, the ``DNNModel`` pipeline stage, and the weights
carry-over from the JAX reference; on a mesh, the data, FSDP and
tensor-sharded train step, ring attention and the expert-sharded MoE. Training (``models.training``) and its
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
    ring_attention,
    transformer_block,
    transformer_encoder,
)
from .convert import load_jax_params
from .dnn_model import DNNModel
from .graph_module import GraphModule, GraphNode
from .module import (
    BatchNorm,
    Conv2D,
    Dense,
    Fn,
    FunctionModel,
    GlobalAvgPool,
    MaxPool,
    Module,
    Residual,
    Sequential,
    activation_sharding,
    flatten,
    matmul_dtype,
    matmul_precision,
    relu,
)
from .moe import MoE, expert_shardings
from .resnet import build_resnet, param_shardings, resnet, resnet18, resnet50
from .torch_import import from_torch_resnet

__all__ = ["BatchNorm", "BiLSTM", "Conv2D", "DNNModel", "Dense", "Embed", "Fn",
           "activation_sharding", "ring_attention",
           "FunctionModel", "GlobalAvgPool", "GraphModule", "GraphNode", "LSTM", "LayerNorm", "MaxPool",
           "MoE", "Module", "MultiHeadAttention", "Residual", "Sequential",
           "bilstm_tagger", "build_resnet", "dense_attention",
           "expert_shardings", "flash_route", "flatten", "from_torch_resnet",
           "load_jax_params", "matmul_dtype", "matmul_precision",
           "param_shardings", "relu", "resnet", "resnet18", "resnet50",
           "transformer_block", "transformer_encoder"]
