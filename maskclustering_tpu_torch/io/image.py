"""Host-side image helpers of the scan layouts (``io/image.py:24-113``).

Depth PNGs are 16-bit millimetres (or 0.25 mm for Matterport3D);
segmentation id-maps are 8- or 16-bit PNGs, resized to the depth
resolution with nearest-neighbour sampling so ids stay intact; colour
frames are JPEG (or PNG). All of it goes through the port's own codecs
(``io/png.py``, ``io/jpeg.py``), never PIL or cv2.
"""

from __future__ import annotations

import numpy as np

from maskclustering_tpu_torch.io.jpeg import decode_jpeg
from maskclustering_tpu_torch.io.png import SIGNATURE, decode_png, read_png, write_png


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


def read_rgb(path: str) -> np.ndarray:
    """Read a colour frame as (H, W, 3) uint8 RGB (``io/image.py:49-56``).

    JPEG decodes through ``io/jpeg.py``, pixel for pixel what cv2 and PIL
    give (libjpeg-turbo's defaults); a greyscale file is replicated to three
    channels, as both do. PNG keeps its route through ``io/png.py``.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        img = decode_jpeg(data, name=path)
        return img if img.ndim == 3 else np.repeat(img[:, :, None], 3, axis=2)
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: neither a JPEG nor a PNG file")
    img = decode_png(data)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: colour frames are 8-bit, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] >= 3:
        return np.ascontiguousarray(img[:, :, :3])
    grey = img if img.ndim == 2 else img[:, :, 0]
    return np.repeat(grey[:, :, None], 3, axis=2)


def write_mask_png(path: str, ids: np.ndarray) -> None:
    """Write an id-map as uint8 when every id fits, else uint16."""
    ids = np.asarray(ids)
    write_png(path, ids.astype(np.uint16 if ids.max(initial=0) > 255 else np.uint8))


def write_depth_png(path: str, depth_mm: np.ndarray) -> None:
    """Write a 16-bit depth PNG of millimetres (rounded and clipped to
    uint16 when not uint16 already)."""
    depth_mm = np.asarray(depth_mm)
    if depth_mm.dtype != np.uint16:
        depth_mm = np.clip(np.round(depth_mm), 0, 65535).astype(np.uint16)
    write_png(path, depth_mm)


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
