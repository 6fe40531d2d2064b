"""Shape buckets of a scene (counterpart of ``utils/compile_cache.py:70-127``).

The JAX package pads every scene to a geometric (F_pad, N_pad) bucket so
its jit caches hit across scenes. The port has nothing to compile, but pads
exactly the same way: the padded point count decides which points
``estimate_spacing`` samples (``points[::N_pad // 2048]``), hence the
coverage voxel size and every mask-validity verdict downstream.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def bucket_size(value: int, multiple: int) -> int:
    """Geometric shape bucket: the multiple count rounded up to two
    significant bits (2^k or 3*2^(k-1))."""
    m = max(1, -(-value // multiple))
    bit = max(m.bit_length() - 2, 0)
    m = -(-m >> bit) << bit
    return m * multiple


def scene_pads(cfg, frames: int, points: int) -> Tuple[int, int]:
    """(f_pad, n_pad) of a scene under ``cfg``'s padding multiples
    (``point_shards`` joins the point multiple, as in the JAX package)."""
    n_mult = math.lcm(max(cfg.point_chunk, 1), max(getattr(cfg, "point_shards", 1), 1))
    return (bucket_size(frames, max(cfg.frame_pad_multiple, 1)),
            bucket_size(points, n_mult))


def max_seg_id(segmentations) -> int:
    """Largest mask id in a scene's id-maps (0 for an empty stack)."""
    return int(np.max(segmentations)) if np.size(segmentations) else 0
