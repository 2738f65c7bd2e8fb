"""Image kernels: decode, resize, color, geometry, filtering (the port of
``mmlspark_tpu/ops/image.py``).

The reference's OpenCV surface (opencv/ImageTransformer.scala:26-150 —
Imgproc.resize/cvtColor/blur/threshold/GaussianBlur, Core.flip) and its
JVM AWT resize, in two forms:

  - numpy per-image host ops (decode-time preprocessing, ragged inputs);
    resize goes through the native library's bilinear kernel
    (``native_loader.resize_bilinear``) where it is built, else numpy —
    host code both ways;
  - batched mirrors on ``[B, H, W, C]`` tensors for fused pipelines, on the
    tensor's device, each bit for bit its host op (see the section below);
    ``resize_batch`` is the batched resize no stage calls.

Decode uses Pillow when present, else a built-in PPM/PGM/BMP decoder.
"""

from __future__ import annotations

import io
import math
import struct
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Decode (host side; reference: io/image/ImageUtils.scala:1-159 decode via AWT)
# ---------------------------------------------------------------------------


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """bytes -> HWC uint8 RGB array, or None if undecodable (reference returns
    null rows for broken images and drops them downstream)."""
    try:
        from PIL import Image

        img = Image.open(io.BytesIO(data))
        img = img.convert("RGB")
        return np.asarray(img, dtype=np.uint8)
    except ImportError:
        pass
    except Exception:
        return None
    try:
        return _decode_builtin(data)
    except Exception:
        return None


def _decode_builtin(data: bytes) -> np.ndarray:
    if data[:2] in (b"P6", b"P5"):
        return _decode_pnm(data)
    if data[:2] == b"BM":
        return _decode_bmp(data)
    raise ValueError("unsupported image format (install Pillow for JPEG/PNG)")


def _decode_pnm(data: bytes) -> np.ndarray:
    # P6 = binary PPM (RGB), P5 = binary PGM (gray)
    parts: list = []
    idx = 0
    while len(parts) < 4:
        nl = data.index(b"\n", idx)
        line = data[idx:nl]
        idx = nl + 1
        for tok in line.split(b"#")[0].split():
            parts.append(tok)
    magic, w, h, _maxval = parts[0], int(parts[1]), int(parts[2]), int(parts[3])
    raw = np.frombuffer(data[idx:], dtype=np.uint8)
    if magic == b"P6":
        return raw[: h * w * 3].reshape(h, w, 3).copy()
    return np.repeat(raw[: h * w].reshape(h, w, 1), 3, axis=2)


def _decode_bmp(data: bytes) -> np.ndarray:
    off = struct.unpack_from("<I", data, 10)[0]
    w, h = struct.unpack_from("<ii", data, 18)
    bpp = struct.unpack_from("<H", data, 28)[0]
    if bpp != 24:
        raise ValueError("only 24-bit BMP supported in builtin decoder")
    row_size = (w * 3 + 3) & ~3
    arr = np.zeros((abs(h), w, 3), dtype=np.uint8)
    for y in range(abs(h)):
        row = np.frombuffer(data, dtype=np.uint8, count=w * 3, offset=off + y * row_size)
        arr[abs(h) - 1 - y if h > 0 else y] = row.reshape(w, 3)[:, ::-1]  # BGR->RGB
    return arr


def encode_ppm(img: np.ndarray) -> bytes:
    """HWC uint8 RGB -> binary PPM bytes (for tests / round-trips)."""
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    h, w, _ = img.shape
    return b"P6\n%d %d\n255\n" % (w, h) + img.tobytes()


# ---------------------------------------------------------------------------
# Resize
# ---------------------------------------------------------------------------


def resize(img: np.ndarray, height: int, width: int, method: str = "linear") -> np.ndarray:
    """Host-side single-image resize (C++ bilinear when built, numpy fallback)."""
    img = np.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, c = img.shape
    if (h, w) == (height, width):
        out = img
    elif method != "nearest" and img.dtype in (np.uint8, np.float32):
        from .. import native_loader

        native = native_loader.resize_bilinear(img, height, width)
        native_loader.count("resize_bilinear",
                            "numpy" if native is None else "native")
        out = native if native is not None else _resize_numpy(img, height, width)
    elif method == "nearest":
        ys = np.clip((np.arange(height) + 0.5) * h / height, 0, h - 1).astype(np.int64)
        xs = np.clip((np.arange(width) + 0.5) * w / width, 0, w - 1).astype(np.int64)
        out = img[ys][:, xs]
    else:
        out = _resize_numpy(img, height, width)
    return out[:, :, 0] if squeeze else out


def _resize_numpy(img: np.ndarray, height: int, width: int) -> np.ndarray:
    out = _bilinear(img.astype(np.float32), height, width)
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)


def _bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    h, w, c = img.shape
    # half-pixel centers (matches jax.image.resize / OpenCV INTER_LINEAR)
    ys = (np.arange(height) + 0.5) * h / height - 0.5
    xs = (np.arange(width) + 0.5) * w / width - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def resize_batch(x, height: int, width: int, method: str = "linear"):
    """Batched resize of a float [B, H, W, C] tensor on its device: the
    reference's ``jax.image.resize`` (half-pixel centres; "linear"
    antialiases when it shrinks, as a triangle filter widened by the
    scale) as ``F.interpolate`` (bilinear with ``antialias=True``;
    "nearest" as ``nearest-exact``). It agrees with the reference within a
    float32 tolerance, not bit for bit (tests/test_torch_fusion.py)."""
    v = x.permute(0, 3, 1, 2)
    if method == "nearest":
        y = F.interpolate(v, size=(height, width), mode="nearest-exact")
    else:
        y = F.interpolate(v, size=(height, width), mode="bilinear",
                          align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Geometry / color / filtering (ImageTransformer op parity)
# ---------------------------------------------------------------------------


def crop(img: np.ndarray, x: int, y: int, height: int, width: int) -> np.ndarray:
    return np.asarray(img)[y:y + height, x:x + width]


def center_crop(img: np.ndarray, height: int, width: int) -> np.ndarray:
    h, w = img.shape[:2]
    y = max((h - height) // 2, 0)
    x = max((w - width) // 2, 0)
    return crop(img, x, y, height, width)


def flip(img: np.ndarray, flip_code: int = 1) -> np.ndarray:
    """OpenCV Core.flip semantics: 0 = vertical (x-axis), >0 horizontal, <0 both."""
    if flip_code == 0:
        return np.asarray(img)[::-1].copy()
    if flip_code > 0:
        return np.asarray(img)[:, ::-1].copy()
    return np.asarray(img)[::-1, ::-1].copy()


def color_format(img: np.ndarray, code: str) -> np.ndarray:
    """cvtColor subset: 'gray'/'bgr2rgb'/'rgb2bgr'."""
    img = np.asarray(img)
    if code in ("gray", "grayscale"):
        if img.ndim == 2 or img.shape[2] == 1:
            return img
        # the weighted sum spelled out, one rounding per f32 step (the
        # reference's matvec ``@ w`` sums in the BLAS's order, which
        # differs by an ulp from this on ~0.007% of uint8 pixels and cannot
        # be mirrored on a device): the batched mirror is bit for bit this
        xf = img[..., :3].astype(np.float32)
        w = np.array([0.299, 0.587, 0.114], dtype=np.float32)
        g = (xf[..., 0] * w[0] + xf[..., 1] * w[1]) + xf[..., 2] * w[2]
        out = np.clip(np.rint(g), 0, 255).astype(img.dtype) if img.dtype == np.uint8 \
            else g.astype(img.dtype)
        return out[:, :, None]
    if code in ("bgr2rgb", "rgb2bgr"):
        return img[..., ::-1].copy()
    raise ValueError(f"Unknown color format {code!r}")


def box_blur(img: np.ndarray, kh: int, kw: int) -> np.ndarray:
    """Imgproc.blur parity: normalized box filter with edge replication."""
    img = np.asarray(img, dtype=np.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    ph, pw = kh // 2, kw // 2
    padded = np.pad(img, ((ph, kh - 1 - ph), (pw, kw - 1 - pw), (0, 0)), mode="edge")
    # separable box: cumulative sums along each axis
    cs = np.cumsum(padded, axis=0)
    rows = np.concatenate([cs[kh - 1:kh], cs[kh:] - cs[:-kh]], axis=0)
    cs = np.cumsum(rows, axis=1)
    out = np.concatenate([cs[:, kw - 1:kw], cs[:, kw:] - cs[:, :-kw]], axis=1) / (kh * kw)
    return out[:, :, 0] if squeeze else out


def gaussian_kernel_1d(sigma: float, radius: Optional[int] = None) -> np.ndarray:
    if radius is None:
        radius = max(int(math.ceil(3 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x ** 2) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: np.ndarray, sigma: float, kh: Optional[int] = None,
                  kw: Optional[int] = None) -> np.ndarray:
    """Imgproc.GaussianBlur parity: separable gaussian, edge-replicated."""
    img = np.asarray(img, dtype=np.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    kr = (kh // 2) if kh else None
    k = gaussian_kernel_1d(sigma, kr)
    r = len(k) // 2
    padded = np.pad(img, ((r, r), (0, 0), (0, 0)), mode="edge")
    out = np.zeros_like(img)
    for i, kv in enumerate(k):
        out += kv * padded[i:i + img.shape[0]]
    padded = np.pad(out, ((0, 0), (r, r), (0, 0)), mode="edge")
    out2 = np.zeros_like(img)
    for i, kv in enumerate(k):
        out2 += kv * padded[:, i:i + img.shape[1]]
    return out2[:, :, 0] if squeeze else out2


def gaussian_kernel_2d(app_width: int, sigma: float) -> np.ndarray:
    """GaussianKernel stage parity (opencv/ImageTransformer GaussianKernel)."""
    k = gaussian_kernel_1d(sigma, app_width // 2)
    return np.outer(k, k).astype(np.float32)


def threshold(img: np.ndarray, thresh: float, max_val: float,
              kind: str = "binary") -> np.ndarray:
    """Imgproc.threshold parity: binary / binary_inv / trunc / tozero / tozero_inv."""
    img = np.asarray(img, dtype=np.float32)
    if kind == "binary":
        return np.where(img > thresh, max_val, 0.0)
    if kind == "binary_inv":
        return np.where(img > thresh, 0.0, max_val)
    if kind == "trunc":
        return np.minimum(img, thresh)
    if kind == "tozero":
        return np.where(img > thresh, img, 0.0)
    if kind == "tozero_inv":
        return np.where(img > thresh, 0.0, img)
    raise ValueError(f"Unknown threshold kind {kind!r}")


# ---------------------------------------------------------------------------
# Unroll (image -> flat vector; UnrollImage.scala:28-53 parity)
# ---------------------------------------------------------------------------


def unroll_chw(img: np.ndarray, normalize: bool = False) -> np.ndarray:
    """HWC image -> flat CHW float64 vector (reference UnrollImage layout: the CNTK
    convention of channel-major flattening, UnrollImage.scala:28-53)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    out = np.moveaxis(img, -1, 0).astype(np.float64).reshape(-1)
    return out / 255.0 if normalize else out


def unroll_batch_chw(x):
    """Batched mirror of ``unroll_chw``'s layout: [B, H, W, C] -> [B,
    C*H*W] (channel-major), in ``x``'s dtype."""
    b = x.shape[0]
    return x.permute(0, 3, 1, 2).reshape(b, -1)


# ---------------------------------------------------------------------------
# Device-exact batched mirrors (pipeline fusion, core/fusion.py)
#
# Each op below reproduces its host sibling BITWISE on [B, H, W, C] tensors:
# pure value moves (crop/flip/reverse), exact casts, or the same elementwise
# IEEE-f32 expression tree, one torch op per step (no contraction across
# ops). Ops whose host path computes through f64 (resize's interpolation
# weights, the cumsum blurs) have no device mirror: the fused executor runs
# those on the host in a segment's ``prepare`` with the per-image functions
# above, which is what keeps fused == unfused exact.
# ---------------------------------------------------------------------------


def crop_batch(x, cx: int, cy: int, height: int, width: int):
    """Batched mirror of ``crop`` (numpy slicing semantics, any dtype)."""
    return x[:, cy:cy + height, cx:cx + width]


def flip_batch(x, flip_code: int = 1):
    """Batched mirror of ``flip`` (OpenCV Core.flip codes)."""
    if flip_code == 0:
        return torch.flip(x, (1,))
    if flip_code > 0:
        return torch.flip(x, (2,))
    return torch.flip(x, (1, 2))


def threshold_batch(x, thresh: float, max_val: float, kind: str = "binary"):
    """Batched mirror of ``threshold``: f32 compare + select, exact."""
    xf = x.to(torch.float32)
    t = torch.tensor(thresh, dtype=torch.float32, device=x.device)
    m = torch.tensor(max_val, dtype=torch.float32, device=x.device)
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "binary":
        return torch.where(xf > t, m, z)
    if kind == "binary_inv":
        return torch.where(xf > t, z, m)
    if kind == "trunc":
        return torch.minimum(xf, t)
    if kind == "tozero":
        return torch.where(xf > t, xf, z)
    if kind == "tozero_inv":
        return torch.where(xf > t, z, xf)
    raise ValueError(f"Unknown threshold kind {kind!r}")


def color_format_batch(x, code: str):
    """Batched mirror of ``color_format``: the gray path is the host's
    spelled-out f32 weighted sum, step for step, so the two agree bit for
    bit."""
    if code in ("gray", "grayscale"):
        if x.dim() == 3 or x.shape[-1] == 1:
            return x
        xf = x[..., :3].to(torch.float32)
        w = [torch.tensor(v, dtype=torch.float32, device=x.device)
             for v in (0.299, 0.587, 0.114)]
        g = (xf[..., 0] * w[0] + xf[..., 1] * w[1]) + xf[..., 2] * w[2]
        if x.dtype == torch.uint8:
            g = torch.clamp(torch.round(g), 0, 255).to(torch.uint8)
        else:
            g = g.to(x.dtype)
        return g[..., None]
    if code in ("bgr2rgb", "rgb2bgr"):
        return torch.flip(x, (-1,))
    raise ValueError(f"Unknown color format {code!r}")


def fix_channels_batch(x, c: int):
    """Batched mirror of the featurizer's channel fix: repeat a single
    channel up to ``c`` or slice extras off (exact value moves)."""
    if x.dim() == 3:
        x = x[:, :, :, None]
    have = x.shape[3]
    if have == c:
        return x
    if have < c:
        return x[:, :, :, :1].expand(*x.shape[:3], c)
    return x[:, :, :, :c]
