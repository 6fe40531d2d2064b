"""Matterport3D sequence loader.

File contract follows reference dataset/matterport.py:7-137: per-scene
``undistorted_camera_parameters/<seq>.conf`` carries per-camera intrinsics
(each shared by 6 scan directions) and per-frame GL-convention extrinsics
(columns 1,2 negated to OpenCV), depth PNGs at 0.25 mm/unit, and the
``house_segmentations/<seq>.ply`` cloud. Frame ids are indices into the
name arrays parsed from the .conf. Port of
``maskclustering_tpu/datasets/matterport.py``.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from maskclustering_tpu_torch.datasets.base import BaseDataset, make_label_maps
from maskclustering_tpu_torch.io import (
    read_depth_png,
    read_mask_png,
    read_ply_points,
    read_rgb,
    resize_nearest,
)
from maskclustering_tpu_torch.semantics.vocab import get_vocab


def parse_matterport_conf(path: str):
    """Parse a Matterport .conf: returns (rgb_names, depth_names,
    intrinsics (F,3,3), extrinsics (F,4,4) camera-to-world, OpenCV axes)."""
    intrinsics: List[np.ndarray] = []
    extrinsics: List[np.ndarray] = []
    rgb_names: List[str] = []
    depth_names: List[str] = []
    current_k = None
    with open(path) as f:
        for line in f:
            tokens = line.split()
            if not tokens:
                continue
            if tokens[0] == "intrinsics_matrix":
                vals = [float(t) for t in tokens[1:] if t]
                if len(vals) != 9:
                    raise ValueError(f"bad intrinsics_matrix line in {path}: {line!r}")
                current_k = np.asarray(vals).reshape(3, 3)
            elif tokens[0] == "scan":
                if current_k is None:
                    raise ValueError(f"scan line before intrinsics_matrix in {path}")
                depth_names.append(tokens[1])
                rgb_names.append(tokens[2])
                vals = [float(t) for t in tokens[3:] if t]
                if len(vals) != 16:
                    raise ValueError(f"bad scan line in {path}: {line!r}")
                ext = np.asarray(vals).reshape(4, 4)
                ext[:3, 1] *= -1.0  # GL -> CV: flip y and z columns
                ext[:3, 2] *= -1.0
                intrinsics.append(current_k)
                extrinsics.append(ext)
    return (
        rgb_names,
        depth_names,
        np.stack(intrinsics) if intrinsics else np.zeros((0, 3, 3)),
        np.stack(extrinsics) if extrinsics else np.zeros((0, 4, 4)),
    )


class MatterportDataset(BaseDataset):
    depth_scale = 4000.0  # 0.25 mm per unit
    image_size = (1280, 1024)
    dataset_name = "matterport3d"

    def __init__(self, seq_name: str, data_root: str = "./data") -> None:
        self.seq_name = seq_name
        self.root = os.path.join(data_root, "matterport3d", "scans", seq_name, seq_name)
        self.rgb_dir = os.path.join(self.root, "undistorted_color_images")
        self.depth_dir = os.path.join(self.root, "undistorted_depth_images")
        self.point_cloud_path = os.path.join(self.root, "house_segmentations", f"{seq_name}.ply")
        self.data_root = data_root
        conf = os.path.join(self.root, "undistorted_camera_parameters", f"{seq_name}.conf")
        self.rgb_names, self.depth_names, self._intrinsics, self._extrinsics = \
            parse_matterport_conf(conf)

    def get_frame_list(self, stride: int) -> List[int]:
        return [int(i) for i in np.arange(0, len(self.rgb_names), stride)]

    def get_intrinsics(self, frame_id) -> np.ndarray:
        return self._intrinsics[frame_id]

    def get_extrinsic(self, frame_id) -> np.ndarray:
        return self._extrinsics[frame_id]

    def get_depth(self, frame_id) -> np.ndarray:
        return read_depth_png(os.path.join(self.depth_dir, self.depth_names[frame_id]),
                              self.depth_scale)

    def get_rgb(self, frame_id) -> np.ndarray:
        return read_rgb(os.path.join(self.rgb_dir, self.rgb_names[frame_id]))

    def get_segmentation(self, frame_id, align_with_depth: bool = True) -> np.ndarray:
        stem = os.path.splitext(self.rgb_names[frame_id])[0]
        seg = read_mask_png(os.path.join(self.segmentation_dir, f"{stem}.png"))
        if align_with_depth:
            seg = resize_nearest(seg, self.image_size)
        return seg

    def get_frame_path(self, frame_id):
        stem = os.path.splitext(self.rgb_names[frame_id])[0]
        return (
            os.path.join(self.rgb_dir, self.rgb_names[frame_id]),
            os.path.join(self.segmentation_dir, f"{stem}.png"),
        )

    def get_scene_points(self) -> np.ndarray:
        return read_ply_points(self.point_cloud_path)

    def get_label_features(self):
        path = os.path.join(self.data_root, "text_features", "matterport3d.npy")
        return np.load(path, allow_pickle=True).item()

    def get_label_id(self):
        labels, ids = get_vocab("matterport3d")
        return make_label_maps(labels, ids)
