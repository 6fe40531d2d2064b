"""Shape buckets of a scene (counterpart of ``utils/compile_cache.py:70-171``).

The JAX package pads every scene to a geometric (F_pad, N_pad) bucket so
its jit caches hit across scenes. The port has nothing to compile, but pads
exactly the same way: the padded point count decides which points
``estimate_spacing`` samples (``points[::N_pad // 2048]``), hence the
coverage voxel size and every mask-validity verdict downstream.

The per-process bucket bookkeeping (``record_shape_bucket``) is booked at
the JAX sites and counts ``compile_cache.bucket_hit`` / ``_new`` the same
way. On the card, a bucket new to the process is a cold dispatch without
a compile: the caching allocator grows to the new shapes, the kernels'
modules load on first launch and cuBLAS creates its handles. The serving
worker reports a request's new scene buckets as ``buckets_new`` and the
router's warm/cold vocabulary is built on them.
"""

from __future__ import annotations

import logging
import math
import sys
import threading
from typing import Set, Tuple

import numpy as np

from maskclustering_tpu_torch.analysis.lock_sanitizer import mct_lock

log = logging.getLogger("maskclustering_tpu_torch")

K_MAX_CEILING = 1023

# (kind, *bucket) keys this process has dispatched
_SEEN_BUCKETS: Set[Tuple] = set()
_SEEN_LOCK = mct_lock("compile_cache._SEEN_LOCK")


def bucket_size(value: int, multiple: int) -> int:
    """Geometric shape bucket: the multiple count rounded up to two
    significant bits (2^k or 3*2^(k-1))."""
    m = max(1, -(-value // multiple))
    bit = max(m.bit_length() - 2, 0)
    m = -(-m >> bit) << bit
    return m * multiple


def bucket_k_max(max_id: int, minimum: int = 63, ceiling: int = K_MAX_CEILING) -> int:
    """Smallest (2^b - 1) >= max(max_id, minimum), clamped at ``ceiling``;
    ids above k_max are dropped as background."""
    k = minimum
    while k < max_id and k < ceiling:
        k = k * 2 + 1
    if max_id > k:
        log.warning("segmentation ids up to %d exceed k_max ceiling %d; "
                    "masks with larger ids are treated as background", max_id, k)
    return k


def scene_pads(cfg, frames: int, points: int) -> Tuple[int, int]:
    """(f_pad, n_pad) of a scene under ``cfg``'s padding multiples
    (``point_shards`` joins the point multiple, as in the JAX package)."""
    n_mult = math.lcm(max(cfg.point_chunk, 1), max(getattr(cfg, "point_shards", 1), 1))
    return (bucket_size(frames, max(cfg.frame_pad_multiple, 1)),
            bucket_size(points, n_mult))


def max_seg_id(segmentations) -> int:
    """Largest mask id in a scene's id-maps (0 for an empty stack). A stack
    that is a tensor (frames rendered on the card) is reduced where it lies
    and only the scalar is read, in a named ``frames.max_id`` pull."""
    torch = sys.modules.get("torch")  # no tensor exists before torch is imported
    if torch is not None and isinstance(segmentations, torch.Tensor):
        from maskclustering_tpu_torch.analysis.transfer_guard import sanctioned_pull

        if segmentations.numel() == 0:
            return 0
        with sanctioned_pull("frames.max_id"):
            return int(segmentations.max())
    return int(np.max(segmentations)) if np.size(segmentations) else 0


def scene_bucket(cfg, frames: int, points: int, max_id: int) -> Tuple[int, int, int]:
    """The scene-level bucket key: (k_max, f_pad, n_pad). ``max_id`` is the
    scene's largest segmentation id."""
    return (bucket_k_max(max_id), *scene_pads(cfg, frames, points))


def scene_bucket_of(cfg, tensors) -> Tuple[int, int, int]:
    """``scene_bucket`` read off a SceneTensors."""
    return scene_bucket(cfg, tensors.num_frames, tensors.num_points,
                        max_seg_id(tensors.segmentations))


def record_shape_bucket(kind: str, *bucket) -> bool:
    """Record a shape bucket; returns True (and logs) if new to the process."""
    from maskclustering_tpu_torch import obs

    from maskclustering_tpu_torch.analysis import retrace_sanitizer

    key = (kind, *bucket)
    with _SEEN_LOCK:
        new = key not in _SEEN_BUCKETS
        _SEEN_BUCKETS.add(key)
        distinct = len(_SEEN_BUCKETS)
    # one bucket vocabulary with the build/launch-surface sanitizer
    retrace_sanitizer.note_bucket(new)
    if not new:
        obs.count("compile_cache.bucket_hit")
        return False
    obs.count("compile_cache.bucket_new")
    obs.gauge("compile_cache.distinct_buckets", distinct)
    log.info("new %s shape bucket: %s", kind, bucket)
    return True


def seen_shape_buckets() -> Set[Tuple]:
    with _SEEN_LOCK:
        return set(_SEEN_BUCKETS)


def seen_scene_buckets() -> Set[Tuple]:
    """Just the scene-kind (k_max, f_pad, n_pad) buckets: the serving
    vocabulary this process has dispatched (the serve worker diffs it per
    request to report cold dispatches)."""
    with _SEEN_LOCK:
        return {key[1:] for key in _SEEN_BUCKETS if key[0] == "scene"}


def reset_shape_buckets() -> None:
    with _SEEN_LOCK:
        _SEEN_BUCKETS.clear()
