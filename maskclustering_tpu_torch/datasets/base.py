"""The per-scene tensor bundle the pipeline consumes (host numpy)."""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

# Sentinel coordinate for point padding: far outside any indoor scan, so a
# padded point is never inside a frustum within depth_trunc and never claimed.
PAD_COORD = 1.0e4
PAD_DISTANCE_CUTOFF = min(10.0, PAD_COORD / 100.0)


@dataclasses.dataclass
class SceneTensors:
    """Dense per-scene arrays.

    All frames share one (H, W) image size; depth is metres; extrinsics are
    camera-to-world; frames with invalid (inf/nan) poses are masked out via
    ``frame_valid`` instead of being dropped.
    """

    scene_points: np.ndarray  # (N, 3) float32
    depths: np.ndarray  # (F, H, W) float32, metres
    segmentations: np.ndarray  # (F, H, W) int32 mask id-maps aligned with depth
    intrinsics: np.ndarray  # (F, 3, 3) float32
    cam_to_world: np.ndarray  # (F, 4, 4) float32
    frame_valid: np.ndarray  # (F,) bool
    frame_ids: List  # original per-dataset frame identifiers

    @property
    def num_points(self) -> int:
        return int(self.scene_points.shape[0])

    @property
    def num_frames(self) -> int:
        return int(self.depths.shape[0])
