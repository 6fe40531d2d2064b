"""CLIP's image preprocessing, without PIL: ``pixel_values`` bit-equal to
``transformers``' slow ``CLIPImageProcessor`` on HxWx3 uint8 images.

The steps of ``CLIPImageProcessor.preprocess``, from a checkpoint's
``preprocessor_config.json``:

1. resize so the shortest edge is ``size["shortest_edge"]``, the long edge
   ``int(short * long / short_in)`` (HF's ``get_resize_output_image_size``),
   or to ``size["height"] x size["width"]``;
2. PIL's bicubic resample (``Image.resize`` with ``reducing_gap=None``, as
   HF calls it): two separable passes, horizontal then vertical, each with
   a = -0.5 taps over a support scaled by the downscale factor, weights
   normalised in float64 then rounded to fixed point at ``1 << 22``, the sum
   rounded and clamped to uint8 after each pass; an axis whose size does not
   change is not resampled;
3. HF's centre crop (offset ``(in - out) // 2``, zero padding when the image
   is smaller than the crop);
4. ``uint8 -> float64 * rescale_factor -> float32``, then ``(x - mean) /
   std`` in float32, channels first.

The input is channels last, always: HF infers the layout from the first
image's shape, and takes a 1xNx3 or 3xNx3 image as channels first
(``ROADMAP.md`` §C).
"""

from __future__ import annotations

import json
import math
import os
from typing import Sequence, Tuple

import numpy as np

PIL_BICUBIC = 3
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


def resample_coefficients(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    box (0, in_size): (out_size,) first source index and (out_size, ksize)
    int32 fixed-point weights (zero past each row's taps)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) casts truncate toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    live = taps[None, :] < xmax[:, None]
    w = np.where(live, _bicubic(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5)
                                * (1.0 / filterscale)), 0.0)
    ww = np.zeros(out_size)
    for x in range(ksize):  # summed in tap order, as Pillow does
        ww = ww + w[:, x]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    one = float(1 << PRECISION_BITS)
    kk = np.trunc(np.where(w < 0, -0.5 + w * one, 0.5 + w * one)).astype(np.int32)
    return xmin, np.where(live, kk, 0)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along ``axis`` (0 rows, 1 columns).

    Sums in int32 as Pillow does: a sample times a weight and their running
    sum stay below 2**31 (255 times the positive weights' sum, under 1.2).
    """
    in_size = img.shape[axis]
    first, kk = resample_coefficients(in_size, out_size)
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0)).astype(np.int32)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), dtype=np.int32)
    for x in range(kk.shape[1]):
        idx = np.minimum(first + x, in_size - 1)
        acc += src[idx] * kk[:, x].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize((width, height), BICUBIC)`` on an
    HxWxC uint8 array."""
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0)
    return np.ascontiguousarray(img)


def center_crop(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """HF's ``image_transforms.center_crop`` on an HxWxC array."""
    h, w = img.shape[:2]
    top, left = (h - height) // 2, (w - width) // 2
    if top >= 0 and left >= 0:
        return img[top:top + height, left:left + width]
    nh, nw = max(height, h), max(width, w)
    canvas = np.zeros((nh, nw) + img.shape[2:], dtype=img.dtype)
    tp, lp = math.ceil((nh - h) / 2), math.ceil((nw - w) / 2)
    canvas[tp:tp + h, lp:lp + w] = img
    top, left = top + tp, left + lp
    return canvas[max(0, top):min(nh, top + height), max(0, left):min(nw, left + width)]


def _size_dict(size, default_to_square: bool) -> dict:
    """HF's ``get_size_dict`` for an int or a dict."""
    if isinstance(size, dict):
        return size
    if default_to_square:
        return {"height": int(size), "width": int(size)}
    return {"shortest_edge": int(size)}


class CLIPImageProcessor:
    """The slow ``CLIPImageProcessor`` of a ``preprocessor_config.json``."""

    def __init__(self, size=None, crop_size=None, do_resize: bool = True,
                 do_center_crop: bool = True, do_rescale: bool = True,
                 rescale_factor: float = 1 / 255, do_normalize: bool = True,
                 image_mean: Sequence[float] = (0.48145466, 0.4578275, 0.40821073),
                 image_std: Sequence[float] = (0.26862954, 0.26130258, 0.27577711),
                 resample: int = PIL_BICUBIC, **_unused):
        if resample != PIL_BICUBIC:
            raise ValueError(f"resample {resample} is not supported (only PIL's bicubic, 3)")
        self.size = _size_dict(224 if size is None else size, default_to_square=False)
        self.crop_size = _size_dict(224 if crop_size is None else crop_size,
                                    default_to_square=True)
        self.do_resize, self.do_center_crop = do_resize, do_center_crop
        self.do_rescale, self.rescale_factor = do_rescale, float(rescale_factor)
        self.do_normalize = do_normalize
        self.mean = np.asarray(image_mean, dtype=np.float32)
        self.std = np.asarray(image_std, dtype=np.float32)

    @classmethod
    def from_pretrained(cls, path: str) -> "CLIPImageProcessor":
        with open(os.path.join(path, "preprocessor_config.json")) as f:
            return cls(**json.load(f))

    def output_size(self, height: int, width: int) -> Tuple[int, int]:
        """(height, width) after the resize."""
        if "shortest_edge" not in self.size:
            return int(self.size["height"]), int(self.size["width"])
        target = int(self.size["shortest_edge"])
        short, long = (width, height) if width <= height else (height, width)
        new_long = int(target * long / short)
        return (new_long, target) if width <= height else (target, new_long)

    def preprocess_one(self, image: np.ndarray) -> np.ndarray:
        """(3, S, S) float32 pixel values of one HxWx3 uint8 image."""
        image = np.asarray(image)
        if image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8:
            raise ValueError(f"expected an HxWx3 uint8 image, got {image.shape} {image.dtype}")
        if self.do_resize:
            image = resize_bicubic(image, *self.output_size(*image.shape[:2]))
        if self.do_center_crop:
            image = center_crop(image, int(self.crop_size["height"]),
                                int(self.crop_size["width"]))
        if self.do_rescale:
            image = (image.astype(np.float64) * self.rescale_factor).astype(np.float32)
        if self.do_normalize:
            image = (image.astype(np.float32) - self.mean) / self.std
        return np.ascontiguousarray(image.transpose(2, 0, 1), dtype=np.float32)

    def __call__(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """(B, 3, S, S) float32 ``pixel_values``."""
        return np.stack([self.preprocess_one(im) for im in images])
