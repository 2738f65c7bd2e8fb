"""SLIC-style superpixel clustering.

Reference: lime/Superpixel.scala:143+ — a SLIC variant clustering pixels by
(color, position) for ImageLIME's masking units. Implemented as vectorized
numpy k-means in (r,g,b,lambda*x,lambda*y) space with a fixed iteration count
(jit-friendly shape discipline; image sizes here are preprocessing-scale).

The port of ``mmlspark_tpu/lime/superpixel.py``. Each iteration's
assignment, the [pixels, centres] f64 distances and their argmin, runs on
the card (``_assign``): one elementwise op a kernel, in numpy's order
(the squares of a coordinate's differences summed in coordinate order,
then the colour term plus the weighted position term), and the first
minimum taken on ties, as ``np.argmin`` takes it; the centres' update
stays numpy on the host, every cluster's sums in one ``bincount`` a
coordinate (the reference's per-cluster means add a cluster's pixels in
the same order). So the labels are the reference's bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Transformer
from ..core.schema import ColType, ImageSchema, Schema
from ..runtime import DeviceLike, resolve_device


def _sq_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """((x[:, None, :] - c[None, :, :]) ** 2).sum(-1) with numpy's
    roundings: a coordinate's squares summed in coordinate order."""
    out = None
    for j in range(x.shape[1]):
        diff = x[:, j, None] - c[None, :, j]
        sq = diff * diff
        out = sq if out is None else out + sq
    return out


def _assign(colors: torch.Tensor, pos: torch.Tensor, centers_col: np.ndarray,
            centers_pos: np.ndarray, w2: float) -> np.ndarray:
    """Each pixel's nearest centre: ``np.argmin(d_col + w2 * d_pos, 1)``."""
    dev = colors.device
    d_col = _sq_dist(colors, torch.as_tensor(centers_col, device=dev))
    d_pos = _sq_dist(pos, torch.as_tensor(centers_pos, device=dev))
    return torch.argmin(d_col + w2 * d_pos, dim=1).cpu().numpy()


def slic(img: np.ndarray, cell_size: float = 16.0, modifier: float = 130.0,
         iters: int = 5, device: DeviceLike = None) -> np.ndarray:
    """HWC image -> int32 [H,W] superpixel labels (contiguous 0..K-1).

    ``cell_size``: target superpixel spacing in pixels; ``modifier``: color vs
    space weighting (reference Superpixel defaults 16 / 130). The
    assignments run on ``device`` (default: the card, unless ``use_device``
    asks otherwise).
    """
    dev = resolve_device(device)
    img = np.asarray(img, dtype=np.float64)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    gy = max(1, int(round(h / cell_size)))
    gx = max(1, int(round(w / cell_size)))
    ys = (np.arange(gy) + 0.5) * h / gy
    xs = (np.arange(gx) + 0.5) * w / gx
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    centers_pos = np.stack([cy.ravel(), cx.ravel()], axis=1)       # [K,2]
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pos = np.stack([yy.ravel(), xx.ravel()], axis=1).astype(np.float64)  # [P,2]
    colors = img.reshape(-1, c)                                    # [P,C]
    k = len(centers_pos)
    ci = np.clip(centers_pos[:, 0].astype(int), 0, h - 1)
    cj = np.clip(centers_pos[:, 1].astype(int), 0, w - 1)
    centers_col = img[ci, cj, :]
    space_w = modifier / cell_size

    colors_dev = torch.as_tensor(colors, device=dev)
    pos_dev = torch.as_tensor(pos, device=dev)
    labels = np.zeros(h * w, dtype=np.int64)
    for _ in range(iters):
        labels = _assign(colors_dev, pos_dev, centers_col, centers_pos,
                         space_w ** 2)
        # each centre the mean of its pixels: ``colors[labels == j].mean(0)``
        # sums a cluster's rows in pixel order, as ``bincount`` does
        counts = np.bincount(labels, minlength=k)
        live = counts > 0
        for arr, cen in ((colors, centers_col), (pos, centers_pos)):
            for c in range(arr.shape[1]):
                sums = np.bincount(labels, arr[:, c], minlength=k)
                cen[live, c] = sums[live] / counts[live]
    # compact labels
    uniq, labels = np.unique(labels, return_inverse=True)
    return labels.reshape(h, w).astype(np.int32)


class Superpixel:
    """Cluster container with masking helpers (Superpixel.scala parity)."""

    def __init__(self, labels: np.ndarray):
        self.labels = labels
        self.num_clusters = int(labels.max()) + 1 if labels.size else 0

    def mask_image(self, img: np.ndarray, states: np.ndarray,
                   background: float = 0.0) -> np.ndarray:
        """Zero out superpixels whose state is False (LIME's perturbation)."""
        keep = np.asarray(states, dtype=bool)[self.labels]
        out = np.array(img, copy=True)
        out[~keep] = background
        return out


class SuperpixelTransformer(Transformer, HasInputCol, HasOutputCol):
    """Image column -> superpixel struct column (lime/SuperpixelTransformer)."""

    cellSize = Param("cellSize", "Target superpixel spacing (px)", 16.0, ptype=float)
    modifier = Param("modifier", "Color/space weighting", 130.0, ptype=float)

    def __init__(self, **kwargs):
        kwargs.setdefault("outputCol", "superpixels")
        super().__init__(**kwargs)

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_throw("inputCol")
        out_col = self.get_or_throw("outputCol")
        cell, mod = self.get("cellSize"), self.get("modifier")

        def fn(p):
            col = p[in_col]
            out = np.empty(len(col), dtype=object)
            for i, row in enumerate(col):
                if row is None:
                    out[i] = None
                    continue
                img = ImageSchema.to_array(row) if ImageSchema.is_image(row) \
                    else np.asarray(row)
                labels = slic(img, cell, mod)
                out[i] = {"labels": labels,
                          "numClusters": int(labels.max()) + 1}
            return out

        return df.with_column(out_col, fn)
