"""Headless debug viewers for preprocessed scenes (``visualize/debug_viewers.py``).

Port of the JAX package's module; each writes the JAX package's files
byte for byte, through the port's PNG and PLY writers:

- :func:`depth_preview`: one frame's depth as a colour-ramped PNG and its
  backprojected cloud as a PLY;
- :func:`compare_mask_dirs`: the same-named images of two directories
  stacked with a black rule between them;
- :func:`fused_cloud_preview`: strided backprojected RGB-D frames fused
  into one coloured PLY, with a per-frame point cap.

All three take the dataset duck-type (get_depth / get_rgb /
get_intrinsics / get_extrinsic / get_frame_list).
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence

import numpy as np

from maskclustering_tpu_torch.io.image import read_rgb_pil, resize_nearest
from maskclustering_tpu_torch.io.jpeg import encode_jpeg
from maskclustering_tpu_torch.io.ply import write_ply_points
from maskclustering_tpu_torch.io.png import encode_png_pillow
from maskclustering_tpu_torch.ops.geometry import backproject_depth_np

log = logging.getLogger("maskclustering_tpu_torch")


def _backproject_frame(dataset, frame_id, max_points: Optional[int] = None,
                       rng: Optional[np.random.Generator] = None):
    """(points (M, 3), colours (M, 3) uint8) of one frame's valid depth."""
    depth = np.asarray(dataset.get_depth(frame_id), dtype=np.float64)
    intr = np.asarray(dataset.get_intrinsics(frame_id), dtype=np.float64)
    c2w = np.asarray(dataset.get_extrinsic(frame_id), dtype=np.float64)
    rgb = np.asarray(dataset.get_rgb(frame_id))
    h, w = depth.shape
    if rgb.shape[:2] != (h, w):
        rgb = resize_nearest(rgb, (w, h))
    if not np.all(np.isfinite(c2w)):
        return np.zeros((0, 3)), np.zeros((0, 3), np.uint8)
    pts, ok = backproject_depth_np(depth, intr, c2w)
    cols = rgb[ok]
    if max_points is not None and len(pts) > max_points:
        rng = rng or np.random.default_rng(0)
        idx = rng.choice(len(pts), max_points, replace=False)
        pts, cols = pts[idx], cols[idx]
    return pts, cols


def _write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png_pillow(img))


# the file extensions PIL's ``save`` writes as JPEG (its default quality 75)
_JPEG_EXTENSIONS = (".jpg", ".jpeg", ".jpe", ".jfif")


def _save_like_pil(path: str, img: np.ndarray) -> None:
    """Write ``img`` in the format PIL's ``save(path)`` picks from the
    extension, with its bytes: PNG, or JPEG at quality 75."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        _write_png(path, img)
    elif ext in _JPEG_EXTENSIONS:
        with open(path, "wb") as f:
            f.write(encode_jpeg(img, 75))
    else:
        raise ValueError(f"unknown file extension: {ext!r} (PNG and JPEG are written)")


def depth_preview(dataset, frame_id, out_dir: str) -> List[str]:
    """One frame's depth as a colour-ramped PNG + backprojected PLY."""
    os.makedirs(out_dir, exist_ok=True)
    depth = np.asarray(dataset.get_depth(frame_id), dtype=np.float64)
    dmax = float(depth.max()) or 1.0
    norm = np.clip(depth / dmax, 0.0, 1.0)
    # simple turbo-ish ramp: near = warm, far = cold, invalid = black
    r = np.clip(1.5 - np.abs(2.0 * norm - 0.5) * 2.0, 0, 1)
    g = np.clip(1.5 - np.abs(2.0 * norm - 1.0) * 2.0, 0, 1)
    b = np.clip(1.5 - np.abs(2.0 * norm - 1.5) * 2.0, 0, 1)
    img = (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)
    img[depth <= 0] = 0
    png_path = os.path.join(out_dir, f"depth_{frame_id}.png")
    _write_png(png_path, img)

    pts, cols = _backproject_frame(dataset, frame_id)
    ply_path = os.path.join(out_dir, f"depth_{frame_id}.ply")
    write_ply_points(ply_path, pts.astype(np.float32), cols)
    return [png_path, ply_path]


def compare_mask_dirs(dir_a: str, dir_b: str, out_dir: str,
                      separator_height: int = 2) -> List[str]:
    """Stack same-named images from two directories with a black rule,
    each written as PIL writes its name's format (PNG, or JPEG at quality
    75); entries that are not images (or that a side cannot decode) are
    skipped."""
    os.makedirs(out_dir, exist_ok=True)
    common = sorted(set(os.listdir(dir_a)) & set(os.listdir(dir_b)))
    written = []
    for name in common:
        try:
            a = read_rgb_pil(os.path.join(dir_a, name))
            b = read_rgb_pil(os.path.join(dir_b, name))
        except (OSError, ValueError, NotImplementedError):
            # stray non-image entries must not abort the compare
            log.debug("compare_mask_dirs: skipping non-image entry %r", name)
            continue
        out = np.zeros((a.shape[0] + separator_height + b.shape[0],
                        max(a.shape[1], b.shape[1]), 3), dtype=np.uint8)
        out[:a.shape[0], :a.shape[1]] = a
        out[a.shape[0] + separator_height:, :b.shape[1]] = b
        path = os.path.join(out_dir, name)
        _save_like_pil(path, out)
        written.append(path)
    return written


def fused_cloud_preview(dataset, out_path: str, stride: int = 1,
                        max_points_per_frame: int = 200_000,
                        frame_ids: Optional[Sequence] = None) -> str:
    """Fuse strided backprojected RGB-D frames into one coloured PLY."""
    rng = np.random.default_rng(0)
    ids = list(frame_ids) if frame_ids is not None else dataset.get_frame_list(stride)
    all_pts, all_cols = [], []
    for fid in ids:
        pts, cols = _backproject_frame(dataset, fid, max_points=max_points_per_frame, rng=rng)
        all_pts.append(pts)
        all_cols.append(cols)
    pts = np.concatenate(all_pts) if all_pts else np.zeros((0, 3))
    cols = np.concatenate(all_cols) if all_cols else np.zeros((0, 3), np.uint8)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_ply_points(out_path, pts.astype(np.float32), cols)
    return out_path
