"""2D mask id-map visualisation (``visualize/mask2d.py``).

Port of the JAX package's module. :func:`vis_mask_frame` writes the
colourised id-map beside the colour frame at half scale, each mask's id
stamped in black at its centroid. The JAX package stamps the ids with
``cv2.putText`` in OpenCV's Hershey simplex font; the port has no cv2 and
no copy of the Hershey glyph table, so it draws each digit from a
seven-segment stroke table of its own (:data:`DIGIT_SEGMENTS`) in the box
the Hershey font takes at scale 1 and thickness 2: 18 pixels of advance a
digit, 21 rows above the text origin. Every pixel outside those boxes is
the JAX package's; the glyphs inside differ by design (ROADMAP.md §C).

:func:`frames_to_gif` writes the JAX function's GIF bytes through the
port's numpy copy of Pillow's quantizer, dither and GIF writer
(``io/gif.py``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from maskclustering_tpu_torch.io.gif import encode_gif
from maskclustering_tpu_torch.io.image import read_rgb_pil, resize_nearest
from maskclustering_tpu_torch.io.png import encode_png_pillow

# Hershey simplex at scale 1: a digit's advance and the rows its strokes
# span above the text origin (cv2's ``org``, the bottom-left of the text)
DIGIT_ADVANCE = 18
DIGIT_HEIGHT = 21
# seven-segment strokes of each digit, (x0, y0, x1, y1) relative to the
# origin, y up being negative: a, b, c, d, e, f, g of the usual lettering
_X0, _X1, _TOP, _MID, _BOT = 3, 14, -20, -10, -1
_SEG = {
    "a": (_X0, _TOP, _X1, _TOP), "b": (_X1, _TOP, _X1, _MID), "c": (_X1, _MID, _X1, _BOT),
    "d": (_X0, _BOT, _X1, _BOT), "e": (_X0, _MID, _X0, _BOT), "f": (_X0, _TOP, _X0, _MID),
    "g": (_X0, _MID, _X1, _MID),
}
DIGIT_SEGMENTS = {d: tuple(_SEG[s] for s in segs) for d, segs in {
    "0": "abcdef", "1": "bc", "2": "abged", "3": "abgcd", "4": "fgbc", "5": "afgcd",
    "6": "afgedc", "7": "abc", "8": "abcdefg", "9": "abcdfg"}.items()}
# the pen is 2x2 pixels: thickness 2
_PEN = 2


def create_colormap(num: int = 65536, seed: int = 1) -> np.ndarray:
    """(num, 3) uint8 colormap; index 0 is black."""
    rng = np.random.default_rng(seed)
    cmap = rng.integers(0, 256, size=(num, 3)).astype(np.uint8)
    cmap[0] = 0
    return cmap


def colorize_id_map(seg: np.ndarray, colormap: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorised palette lookup: id-map (H, W) -> (H, W, 3) uint8."""
    seg = np.asarray(seg)
    if colormap is None:
        colormap = create_colormap(int(seg.max()) + 1)
    return colormap[np.minimum(seg.astype(np.int64), len(colormap) - 1)]


def draw_label(img: np.ndarray, text: str, org: Tuple[int, int]) -> None:
    """Stamp the digits of ``text`` in black, in place, with the text's
    bottom-left at ``org`` (x, y); strokes off the image are clipped."""
    h, w = img.shape[:2]
    ox, oy = org
    for k, ch in enumerate(text):
        for x0, y0, x1, y1 in DIGIT_SEGMENTS.get(ch, ()):
            xa, xb = sorted((ox + k * DIGIT_ADVANCE + x0, ox + k * DIGIT_ADVANCE + x1))
            ya, yb = sorted((oy + y0, oy + y1))
            xa, ya = max(xa, 0), max(ya, 0)
            xb, yb = min(xb + _PEN, w), min(yb + _PEN, h)
            if xa < xb and ya < yb:
                img[ya:yb, xa:xb] = 0


def vis_mask_frame(dataset, frame_id, vis_dir: str,
                   colormap: Optional[np.ndarray] = None) -> str:
    """Colourised id-map side by side with the colour frame, half scale:
    each mask's colour and its id at its centroid, concatenated after the
    colour frame and downscaled 2x. Returns the written path."""
    seg = dataset.get_segmentation(frame_id, align_with_depth=False)
    color_seg = colorize_id_map(seg, colormap).copy()
    for mask_id in np.unique(seg):
        if mask_id == 0:
            continue
        ys, xs = np.nonzero(seg == mask_id)
        draw_label(color_seg, str(int(mask_id)), (int(xs.mean()), int(ys.mean())))
    rgb = dataset.get_rgb(frame_id)
    if rgb.shape[:2] != color_seg.shape[:2]:
        color_seg = resize_nearest(color_seg, (rgb.shape[1], rgb.shape[0]))
    combined = np.concatenate([rgb, color_seg], axis=1)
    combined = np.ascontiguousarray(combined[::2, ::2])  # half scale
    os.makedirs(vis_dir, exist_ok=True)
    path = os.path.join(vis_dir, f"{frame_id}.png")
    with open(path, "wb") as f:
        f.write(encode_png_pillow(combined))
    return path


def frames_to_gif(image_paths: Sequence[str], out_path: str, fps: int = 10) -> str:
    """Stitch frame images into an animated GIF, looping, ``fps`` frames a
    second: the first frame's median-cut palette of 256 colours for every
    frame (a GIF shows each frame with one palette), the later frames
    dithered onto it. Returns ``out_path``."""
    frames = [read_rgb_pil(p) for p in image_paths]
    if not frames:
        raise ValueError("no frames to animate")
    data = encode_gif(frames, duration=max(1, int(1000 / fps)), loop=0)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "wb") as f:
        f.write(data)
    return out_path
