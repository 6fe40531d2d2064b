"""Host-side image helpers of the scan layouts (``io/image.py:24-113``).

Depth PNGs are 16-bit millimetres (or 0.25 mm for Matterport3D);
segmentation id-maps are 8- or 16-bit PNGs, resized to the depth
resolution with nearest-neighbour sampling so ids stay intact; colour
frames are JPEG (or PNG). All of it goes through the port's own codecs
(``io/png.py``, ``io/jpeg.py``), never PIL or cv2.

The colour readers follow the JAX package's two routes. :func:`read_rgb`
stands in for ``cv2.imread(path)``: cv2's PNG transforms and the EXIF
orientation turn (``io/exif.py``). :func:`read_rgb_pil` stands in for
PIL's ``convert("RGB")`` (debug images, GIF frames) and :func:`decode_rgb`
decodes the ``.sens`` reader's frames, both unturned as PIL leaves them.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from maskclustering_tpu_torch.io import exif
from maskclustering_tpu_torch.io.jpeg import decode_jpeg
from maskclustering_tpu_torch.io.png import (
    SIGNATURE,
    decode_png,
    decode_png_cv2,
    decode_png_rgb,
    encode_png_libpng,
    encode_png_pillow,
    read_png,
)


def read_depth_png(path: str, depth_scale: float = 1000.0) -> np.ndarray:
    """Read a 16-bit depth PNG as float32 metres:
    ``raw.astype(f32) * f32(1 / scale)``, the operation the device feed
    (``io/feed.py``) replays after a uint16 upload, so both give the same
    bits (``io/image.py:24-46``)."""
    raw = read_png(path)
    return raw.astype(np.float32) * np.float32(1.0 / depth_scale)


def read_mask_png(path: str) -> np.ndarray:
    """Read a segmentation id-map PNG unchanged (uint8 or uint16)."""
    return read_png(path)


def _grey_to_rgb(img: np.ndarray) -> np.ndarray:
    return img if img.ndim == 3 else np.repeat(img[:, :, None], 3, axis=2)


def decode_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode a colour frame's JPEG or PNG bytes to (H, W, 3) uint8 RGB,
    with no EXIF turn (the ``.sens`` reader's frames, which the JAX
    package decodes with PIL).

    JPEG decodes through ``io/jpeg.py`` on PIL's route, pixel for pixel
    what PIL's ``convert("RGB")`` gives (libjpeg-turbo's decode, PIL's CMYK
    conversion); a greyscale file is replicated to three channels, as PIL
    does. PNG keeps its route through ``io/png.py``.
    """
    if data[:2] == b"\xff\xd8":
        return _grey_to_rgb(decode_jpeg(data, name=name, reader="pil"))
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: neither a JPEG nor a PNG file")
    img = decode_png(data)
    if img.dtype != np.uint8:
        raise ValueError(f"{name}: colour frames are 8-bit, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] >= 3:
        return np.ascontiguousarray(img[:, :, :3])
    grey = img if img.ndim == 2 else img[:, :, 0]
    return np.repeat(grey[:, :, None], 3, axis=2)


def read_rgb(path: str) -> np.ndarray:
    """Read a colour frame as (H, W, 3) uint8 RGB, what the JAX package's
    ``cv2.imread`` gives (``io/image.py:49-56``): a JPEG through the port's
    decoder on cv2's route (OpenCV's CMYK conversion; a lossless greyscale
    file refused, as cv2 refuses it), a PNG of any colour type, bit depth
    and interlace through
    libpng's transforms (``decode_png_cv2``), then turned by the EXIF
    orientation of the JPEG's ``Exif`` APP1 segments or the PNG's ``eXIf``
    chunk (``io/exif.py``)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        img = _grey_to_rgb(decode_jpeg(data, name=path, reader="cv2"))
        blocks = exif.jpeg_exif_blocks(data)
    elif data[:8] == SIGNATURE:
        png = decode_png_cv2(data)
        img = png.samples
        blocks = [png.exif] if png.exif is not None else []
    else:
        raise ValueError(f"{path}: neither a JPEG nor a PNG file")
    return exif.apply_orientation(img, exif.orientation(blocks))


def read_rgb_pil(path: str) -> np.ndarray:
    """An image file as (H, W, 3) uint8, what PIL's ``Image.open(path).
    convert("RGB")`` gives (the JAX package's debug images and GIF frames):
    a PNG of any colour type and bit depth, any JPEG kind PIL reads, with
    no EXIF turn; ``NotImplementedError`` for a JPEG kind PIL refuses,
    ``ValueError`` for anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        return _grey_to_rgb(decode_jpeg(data, name=path, reader="pil"))
    return decode_png_rgb(data)


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def write_mask_png(path: str, ids: np.ndarray) -> None:
    """Write an id-map as uint8 when every id fits, else uint16: the bytes
    of the JAX package's writer (PIL's ``save``)."""
    ids = np.asarray(ids)
    _write(path, encode_png_pillow(
        ids.astype(np.uint16 if ids.max(initial=0) > 255 else np.uint8)))


def write_depth_png(path: str, depth_mm: np.ndarray) -> None:
    """Write a 16-bit depth PNG of millimetres (rounded and clipped to
    uint16 when not uint16 already): the bytes of the JAX package's writer
    (cv2's ``imwrite``)."""
    depth_mm = np.asarray(depth_mm)
    if depth_mm.dtype != np.uint16:
        depth_mm = np.clip(np.round(depth_mm), 0, 65535).astype(np.uint16)
    _write(path, encode_png_libpng(depth_mm))


def resize_nearest(img: np.ndarray, size_wh: tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize to (width, height), id-preserving.

    cv2's ``INTER_NEAREST`` index rule, in its own float64 operations:
    ``src = min(floor(dst * (1 / (dst_size / src_size))), src_size - 1)``.
    The reciprocal of the scale, not ``src_size / dst_size``: the two
    differ in the last bit at some sizes, and a product that lands on an
    integer then floors to the neighbouring source index.
    """
    w, h = size_wh
    sh, sw = img.shape[:2]
    if sh == h and sw == w:
        return img
    inv_y = 1.0 / (h / sh)
    inv_x = 1.0 / (w / sw)
    yi = np.minimum(np.floor(np.arange(h) * inv_y).astype(np.int64), sh - 1)
    xi = np.minimum(np.floor(np.arange(w) * inv_x).astype(np.int64), sw - 1)
    return img[yi[:, None], xi[None, :]]


# Pillow's Resample.c: 8-bit samples, coefficients in 32 - 8 - 2 bits
PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's ``bicubic_filter`` (a = -0.5, support 2), each operation in
    float64 in Pillow's order."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _bilinear(x: np.ndarray) -> np.ndarray:
    """Pillow's ``bilinear_filter`` (support 1)."""
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


# Pillow's filters by name: (function, support)
_FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_bilinear, 1.0)}


def resample_coefficients(in_size: int, out_size: int, kind: str = "bicubic"
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    box (0, in_size) and the filter ``kind``: (out_size,) first source
    index and (out_size, ksize) int32 fixed-point weights (zero past each
    row's taps)."""
    filt, base = _FILTERS[kind]
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = base * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) casts truncate toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    live = taps[None, :] < xmax[:, None]
    w = np.where(live, filt(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5)
                            * (1.0 / filterscale)), 0.0)
    ww = np.zeros(out_size)
    for x in range(ksize):  # summed in tap order, as Pillow does
        ww = ww + w[:, x]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    one = float(1 << PRECISION_BITS)
    kk = np.trunc(np.where(w < 0, -0.5 + w * one, 0.5 + w * one)).astype(np.int32)
    return xmin, np.where(live, kk, 0)


def _resample_axis(img: np.ndarray, out_size: int, axis: int, kind: str) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along ``axis`` (0 rows, 1 columns).

    Sums in int32 as Pillow does: a sample times a weight and their running
    sum stay below 2**31 (255 times the positive weights' sum, under 1.2).
    """
    in_size = img.shape[axis]
    first, kk = resample_coefficients(in_size, out_size, kind)
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0)).astype(np.int32)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), dtype=np.int32)
    for x in range(kk.shape[1]):
        idx = np.minimum(first + x, in_size - 1)
        acc += src[idx] * kk[:, x].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_pil(img: np.ndarray, height: int, width: int, kind: str) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize((width, height), <kind>)`` on an
    HxWxC uint8 array, ``reducing_gap=None``: two separable passes,
    horizontal then vertical, each over a support scaled by the downscale
    factor, weights normalised in float64 then rounded to fixed point at
    ``1 << 22``, the sum rounded and clamped to uint8 after each pass; an
    axis whose size does not change is not resampled."""
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1, kind)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0, kind)
    return np.ascontiguousarray(img)


def resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize((width, height), BILINEAR)`` on an
    HxWx3 uint8 array (the colour resize of ``preprocess/``)."""
    return resize_pil(img, height, width, "bilinear")
