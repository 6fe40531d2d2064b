"""Dataset abstraction and the per-scene tensor bundle (``datasets/base.py:28-141``).

``BaseDataset`` is the loader surface every dataset implements;
``load_scene_tensors`` materialises the dense host bundle the pipeline
consumes.
"""

from __future__ import annotations

import abc
import dataclasses
import os
from typing import Dict, List, Sequence, Tuple

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


class BaseDataset(abc.ABC):
    """One posed RGB-D sequence plus its reconstructed point cloud."""

    seq_name: str
    root: str
    depth_scale: float
    image_size: Tuple[int, int]  # (width, height)

    # ---- per-frame accessors ----

    @abc.abstractmethod
    def get_frame_list(self, stride: int) -> List:
        ...

    @abc.abstractmethod
    def get_intrinsics(self, frame_id) -> np.ndarray:
        """(3,3) float intrinsic matrix at depth/image resolution."""

    @abc.abstractmethod
    def get_extrinsic(self, frame_id) -> np.ndarray:
        """(4,4) camera-to-world pose."""

    @abc.abstractmethod
    def get_depth(self, frame_id) -> np.ndarray:
        """(H,W) float32 depth in metres."""

    @abc.abstractmethod
    def get_rgb(self, frame_id) -> np.ndarray:
        ...

    @abc.abstractmethod
    def get_segmentation(self, frame_id, align_with_depth: bool = True) -> np.ndarray:
        """(H,W) integer mask id-map; 0 = background."""

    @abc.abstractmethod
    def get_scene_points(self) -> np.ndarray:
        """(N,3) reconstructed scene point cloud."""

    # ---- optional surface ----

    def get_frame_path(self, frame_id) -> Tuple[str, str]:
        raise NotImplementedError

    def get_label_features(self) -> Dict:
        """Open-vocab text features, {label: feature} (the query step)."""
        raise NotImplementedError

    def get_label_id(self) -> Tuple[Dict, Dict]:
        raise NotImplementedError

    # ---- dirs (artifact contract with the reference layout) ----

    @property
    def segmentation_dir(self) -> str:
        return os.path.join(self.root, "output", "mask")

    @property
    def object_dict_dir(self) -> str:
        return os.path.join(self.root, "output", "object")

    # ---- dense bundle for the pipeline ----

    def load_scene_tensors(self, stride: int) -> SceneTensors:
        frame_ids = self.get_frame_list(stride)
        depths, segs, intrs, poses, valid = [], [], [], [], []
        for fid in frame_ids:
            pose = np.asarray(self.get_extrinsic(fid), dtype=np.float64)
            ok = np.isfinite(pose).all()
            valid.append(bool(ok))
            poses.append(pose if ok else np.eye(4))
            depths.append(self.get_depth(fid))
            segs.append(np.asarray(self.get_segmentation(fid, align_with_depth=True),
                                   dtype=np.int32))
            intrs.append(np.asarray(self.get_intrinsics(fid), dtype=np.float32))
        return SceneTensors(
            scene_points=np.asarray(self.get_scene_points(), dtype=np.float32),
            depths=np.stack(depths).astype(np.float32),
            segmentations=np.stack(segs),
            intrinsics=np.stack(intrs).astype(np.float32),
            cam_to_world=np.stack(poses).astype(np.float32),
            frame_valid=np.asarray(valid, dtype=bool),
            frame_ids=list(frame_ids),
        )


def make_label_maps(labels: Sequence[str], ids: Sequence[int]) -> Tuple[Dict, Dict]:
    label2id = dict(zip(labels, ids))
    id2label = {v: k for k, v in label2id.items()}
    return label2id, id2label
