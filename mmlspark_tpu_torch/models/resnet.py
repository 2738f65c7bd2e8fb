"""ResNet family (the port of ``mmlspark_tpu/models/resnet.py``): NHWC,
bf16 convolutions, named layers.

The flagship DNN of the north-star path: ImageFeaturizer over a ResNet
(SURVEY §3.1, §3.5). Builders return a ``FunctionModel`` whose
``layer_names`` run head-first, ``["fc", "avgpool", "layer4", ...]``, so
``cutOutputLayers=1`` yields the pooled embedding (2048-d for ResNet-50).
Parameters are drawn from an explicit ``torch.Generator`` (other numbers
than the reference's ``jax.random``; ``convert.load_jax_params`` carries
the reference's weights over, ``torch_import.from_torch_resnet`` a
torchvision checkpoint's).

``param_shardings`` places conv and dense kernels' output channels over a
mesh's ``tensor`` axis, to serve a ResNet column-parallel under
``module.activation_sharding(mesh)``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .module import (BatchNorm, Conv2D, Dense, FunctionModel, GlobalAvgPool,
                     MaxPool, Residual, Sequential, relu)

#: head-first cut points (ImageFeaturizer's ``cutOutputLayers``)
LAYER_NAMES = ["fc", "avgpool", "layer4", "layer3", "layer2", "layer1", "stem"]


def _pad(k: int, torch_style: bool):
    """XLA "SAME" vs torch's symmetric k//2 pad: identical at stride 1, but
    at stride 2 SAME splits the remainder (0, 1) where torch pads (1, 1);
    explicit pads give exact transplant parity (torch_import.py)."""
    return ((k // 2, k // 2),) * 2 if torch_style else "SAME"


def _shortcut(in_ch: int, out_ch: int, stride: int):
    if stride == 1 and in_ch == out_ch:
        return None
    return Sequential([
        ("conv", Conv2D(out_ch, (1, 1), (stride, stride))),
        ("bn", BatchNorm()),
    ])


def _bottleneck(in_ch: int, mid_ch: int, stride: int,
                torch_padding: bool = False) -> Residual:
    out_ch = mid_ch * 4
    body = Sequential([
        ("conv1", Conv2D(mid_ch, (1, 1))),
        ("bn1", BatchNorm()),
        ("relu1", relu()),
        ("conv2", Conv2D(mid_ch, (3, 3), (stride, stride),
                         _pad(3, torch_padding))),
        ("bn2", BatchNorm()),
        ("relu2", relu()),
        ("conv3", Conv2D(out_ch, (1, 1))),
        ("bn3", BatchNorm()),
    ])
    return Residual(body, _shortcut(in_ch, out_ch, stride))


def _basic(in_ch: int, out_ch: int, stride: int,
           torch_padding: bool = False) -> Residual:
    body = Sequential([
        ("conv1", Conv2D(out_ch, (3, 3), (stride, stride),
                         _pad(3, torch_padding))),
        ("bn1", BatchNorm()),
        ("relu1", relu()),
        ("conv2", Conv2D(out_ch, (3, 3), padding=_pad(3, torch_padding))),
        ("bn2", BatchNorm()),
    ])
    return Residual(body, _shortcut(in_ch, out_ch, stride))


_CONFIGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def build_resnet(depth: int = 50, num_classes: int = 1000,
                 image_size: int = 224, channels: int = 3,
                 width: int = 64, torch_padding: bool = False) -> Sequential:
    """The module tree, without parameters (``init`` makes them)."""
    kind, blocks = _CONFIGS[depth]
    expansion = 4 if kind == "bottleneck" else 1
    layers: List[Tuple[str, Sequential]] = [
        ("stem", Sequential([
            ("conv", Conv2D(width, (7, 7), (2, 2), _pad(7, torch_padding))),
            ("bn", BatchNorm()),
            ("relu", relu()),
            ("pool", MaxPool((3, 3), (2, 2),
                             ((1, 1), (1, 1)) if torch_padding else "SAME")),
        ])),
    ]
    in_ch = width
    for i, n in enumerate(blocks):
        ch = width * (2 ** i)
        stage = []
        for j in range(n):
            stride = 2 if (i > 0 and j == 0) else 1
            if kind == "bottleneck":
                stage.append((str(j), _bottleneck(in_ch, ch, stride,
                                                  torch_padding)))
                in_ch = ch * expansion
            else:
                stage.append((str(j), _basic(in_ch, ch, stride, torch_padding)))
                in_ch = ch
        layers.append((f"layer{i + 1}", Sequential(stage)))
    layers.append(("avgpool", GlobalAvgPool()))
    layers.append(("fc", Dense(num_classes)))
    return Sequential(layers, name=f"resnet{depth}")


def resnet(depth: int = 50, num_classes: int = 1000, image_size: int = 224,
           channels: int = 3, seed: int = 0, width: int = 64) -> FunctionModel:
    """Build and initialize a ResNet FunctionModel (weights on the CPU, from
    a ``torch.Generator`` seeded with ``seed``)."""
    module = build_resnet(depth, num_classes, image_size, channels, width)
    out_shape = module.init(torch.Generator().manual_seed(seed),
                            (image_size, image_size, channels))
    if out_shape != (num_classes,):
        raise RuntimeError(
            f"resnet head produced shape {out_shape}, expected "
            f"({num_classes},) — build_resnet/init disagree")
    return FunctionModel(module, (image_size, image_size, channels),
                         list(LAYER_NAMES), f"resnet{depth}")


def resnet50(num_classes: int = 1000, image_size: int = 224,
             seed: int = 0) -> FunctionModel:
    return resnet(50, num_classes, image_size, seed=seed)


def resnet18(num_classes: int = 1000, image_size: int = 224,
             seed: int = 0) -> FunctionModel:
    return resnet(18, num_classes, image_size, seed=seed)


def param_shardings(params, mesh):
    """A ``ShardSpec`` tree for ResNet params: conv kernels
    ``[kh, kw, cin, cout]`` split cout over ``tensor``, dense kernels
    ``[din, dout]`` split dout; the vectors stay whole. On a mesh whose
    tensor axis is 1 that is whole everywhere."""
    from ..parallel.mesh import TENSOR_AXIS, ShardSpec

    def rule(leaf):
        if leaf.dim() == 4:
            return ShardSpec((None, None, None, TENSOR_AXIS), mesh)
        if leaf.dim() == 2:
            return ShardSpec((None, TENSOR_AXIS), mesh)
        return ShardSpec((), mesh)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else rule(v)
                for k, v in tree.items()}

    return walk(params)
