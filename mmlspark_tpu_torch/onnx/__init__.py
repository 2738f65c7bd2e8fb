"""ONNX interchange on PyTorch (the port of ``mmlspark_tpu.onnx``): import
external checkpoints as a ``GraphModule`` that runs on the card, export the
port's native module trees; no onnx/protobuf pip deps (``proto.py``)."""

from .importer import import_onnx
from .export import export_onnx
from . import proto

__all__ = ["import_onnx", "export_onnx", "proto"]
