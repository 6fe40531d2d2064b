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

from maskclustering_tpu_torch.io.image import resize_pil

PIL_BICUBIC = 3


def resize_bicubic(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize((width, height), BICUBIC)`` on an
    HxWxC uint8 array."""
    return resize_pil(img, height, width, "bicubic")


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
