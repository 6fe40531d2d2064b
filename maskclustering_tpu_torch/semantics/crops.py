"""Multi-scale mask crops for open-vocabulary feature extraction.

Copy of ``maskclustering_tpu/semantics/crops.py:17-72`` (OpenMask3D's crop
policy, reference semantics/get_open-voc_features.py:44-99): for each
representative mask, crop the RGB frame at ``CROP_SCALES`` levels (level 0
the tight mask box, level k expanded on each side by
``int(extent * 0.1) * k``, clamped to the image), then pad each crop to a
white square. The mask is nearest-resized to the colour resolution first
with the port's ``resize_nearest`` (cv2's index rule).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from maskclustering_tpu_torch.io.image import resize_nearest

CROP_SCALES = 3  # follow OpenMask3D
EXPANSION_RATIO = 0.1


def mask_to_box(mask: np.ndarray, level: int,
                expansion_ratio: float = EXPANSION_RATIO) -> Tuple[int, int, int, int]:
    """(left, top, right, bottom) of the mask box expanded for ``level``."""
    rows, cols = np.where(mask)
    if rows.size == 0:
        raise ValueError("mask_to_box called with an empty mask")
    top, bottom = int(rows.min()), int(rows.max())
    left, right = int(cols.min()), int(cols.max())
    if level == 0:
        return left, top, right, bottom
    h, w = mask.shape
    x_exp = int(abs(right - left) * expansion_ratio) * level
    y_exp = int(abs(bottom - top) * expansion_ratio) * level
    return (max(0, left - x_exp), max(0, top - y_exp),
            min(w, right + x_exp), min(h, bottom + y_exp))


def pad_to_square(image: np.ndarray, fill: int = 255) -> np.ndarray:
    """Centre an image on a white square canvas."""
    h, w = image.shape[:2]
    size = max(h, w)
    canvas = np.full((size, size, 3), fill, dtype=np.uint8)
    top = (size - h) // 2
    left = (size - w) // 2
    canvas[top:top + h, left:left + w] = image
    return canvas


def multiscale_crops(rgb: np.ndarray, mask: np.ndarray,
                     num_scales: int = CROP_SCALES) -> List[np.ndarray]:
    """``num_scales`` square crops of ``rgb`` around ``mask``."""
    if mask.shape != rgb.shape[:2]:
        mask = resize_nearest(mask.astype(np.uint8), (rgb.shape[1], rgb.shape[0])).astype(bool)
    out = []
    for level in range(num_scales):
        left, top, right, bottom = mask_to_box(mask, level)
        crop = rgb[top:bottom, left:right]
        if crop.size == 0:  # single-row/col tight box
            crop = rgb[top:bottom + 1, left:right + 1]
        out.append(pad_to_square(np.ascontiguousarray(crop)))
    return out
