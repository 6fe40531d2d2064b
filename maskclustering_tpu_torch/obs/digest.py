"""Canonical fingerprint of a scene's exported objects.

Copy of ``artifact_digest`` (+ its ``_crc``) from
``maskclustering_tpu/obs/digest.py:138-172``, so the two packages and two
devices can be compared by one hex8 string: equal digests mean the same
instances, point ids, support masks and coverages, in the same order.
"""

from __future__ import annotations

import zlib

import numpy as np


def _crc(data: bytes, seed: int = 0) -> int:
    return zlib.crc32(data, seed) & 0xFFFFFFFF


def artifact_digest(objects) -> str:
    """Hex8 fingerprint of a SceneObjects in its deterministic export order."""
    seed = _crc(np.asarray([len(objects.point_ids_list),
                            int(objects.num_points)], np.int64).tobytes())
    for pids, masks in zip(objects.point_ids_list, objects.mask_list):
        seed = _crc(np.asarray(pids, np.int64).tobytes(), seed)
        for row in masks:
            frame_id, mask_id, coverage = row[0], row[1], row[2]
            seed = _crc(str(frame_id).encode(), seed)
            seed = _crc(np.asarray([int(mask_id)], np.int64).tobytes(), seed)
            seed = _crc(np.asarray([coverage], np.float64).tobytes(), seed)
    return f"{seed:08x}"
