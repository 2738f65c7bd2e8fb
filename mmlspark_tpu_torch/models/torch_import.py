"""Import torchvision-style ResNet checkpoints into the port's NHWC
``FunctionModel`` (the port of ``mmlspark_tpu/models/torch_import.py``).

A torchvision ``resnetXX`` ``state_dict`` (an ImageNet checkpoint ``.pth``)
becomes the port's ResNet: NHWC, bf16 convolutions, name-addressable
layers, with torch's symmetric padding (``resnet._pad``) so the numbers are
the checkpoint's. Conv weights go from torch's OIHW to the module's HWIO,
the head's ``[out, in]`` to ``Dense``'s ``[in, out]``; BatchNorm's running
statistics become ``mean``/``var``. The transplant is checked against the
module's own ``init`` structure, key for key and shape for shape.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .module import FunctionModel, _flatten
from .resnet import _CONFIGS, LAYER_NAMES, build_resnet


def _to_np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def _get(sd: Dict, key: str) -> np.ndarray:
    if key not in sd:
        raise ValueError(f"state_dict has no {key!r}")
    return _to_np(sd[key]).astype(np.float32)


def _conv(sd: Dict, key: str) -> Dict[str, np.ndarray]:
    # torch OIHW -> the module's HWIO
    p = {"kernel": np.ascontiguousarray(
        np.transpose(_get(sd, key + ".weight"), (2, 3, 1, 0)))}
    if key + ".bias" in sd:
        p["bias"] = _get(sd, key + ".bias")
    return p


def _bn(sd: Dict, key: str) -> Dict[str, np.ndarray]:
    return {"scale": _get(sd, key + ".weight"), "bias": _get(sd, key + ".bias"),
            "mean": _get(sd, key + ".running_mean"),
            "var": _get(sd, key + ".running_var")}


def from_torch_resnet(state_dict, depth: int = 50,
                      num_classes: Optional[int] = None,
                      image_size: int = 224) -> FunctionModel:
    """A torchvision resnet{18,34,50,101,152} ``state_dict`` (a mapping, a
    ``.pth`` path or an ``nn.Module``) as the port's ResNet FunctionModel
    (weights on the CPU). ``num_classes`` defaults to the checkpoint's head
    width. A key or shape the module does not have raises ``ValueError``."""
    if isinstance(state_dict, (str, bytes)):
        state_dict = torch.load(state_dict, map_location="cpu",
                                weights_only=True)
    if hasattr(state_dict, "state_dict"):   # a whole nn.Module
        state_dict = state_dict.state_dict()
    sd = dict(state_dict)
    if num_classes is None:
        num_classes = int(_get(sd, "fc.weight").shape[0])

    kind, blocks = _CONFIGS[depth]
    module = build_resnet(depth, num_classes=num_classes,
                          image_size=image_size, torch_padding=True)
    params: Dict = {"stem": {"conv": _conv(sd, "conv1"), "bn": _bn(sd, "bn1")}}
    n_body_convs = 3 if kind == "bottleneck" else 2
    for i, n in enumerate(blocks):
        stage: Dict = {}
        for j in range(n):
            tk = f"layer{i + 1}.{j}"
            body: Dict = {}
            for c in range(1, n_body_convs + 1):
                body[f"conv{c}"] = _conv(sd, f"{tk}.conv{c}")
                body[f"bn{c}"] = _bn(sd, f"{tk}.bn{c}")
            block: Dict = {"body": body}
            if f"{tk}.downsample.0.weight" in sd:
                block["shortcut"] = {"conv": _conv(sd, f"{tk}.downsample.0"),
                                     "bn": _bn(sd, f"{tk}.downsample.1")}
            stage[str(j)] = block
        params[f"layer{i + 1}"] = stage
    params["fc"] = {"kernel": np.ascontiguousarray(_get(sd, "fc.weight").T),
                    "bias": _get(sd, "fc.bias")}

    # the transplant against the module's own init structure
    out_shape = module.init(torch.Generator().manual_seed(0),
                            (image_size, image_size, 3))
    want = {n: tuple(p.shape) for n, p in module.named_parameters()}
    flat = _flatten(params)
    got = {n: tuple(v.shape) for n, v in flat.items()}
    if want != got:
        diff = sorted(n for n in set(want) | set(got)
                      if want.get(n) != got.get(n))
        raise ValueError(
            f"state_dict structure does not match resnet{depth}: "
            + ", ".join(f"{n}: expected {want.get(n)}, got {got.get(n)}"
                        for n in diff[:10]))
    if out_shape != (num_classes,):
        raise ValueError(f"head mismatch: {out_shape} vs "
                         f"num_classes={num_classes}")
    with torch.no_grad():
        for n, p in module.named_parameters():
            p.copy_(torch.from_numpy(flat[n]))
    return FunctionModel(module, (image_size, image_size, 3),
                         list(LAYER_NAMES), f"resnet{depth}")
