"""ScanNet (and demo) sequence loaders.

Port of ``maskclustering_tpu/datasets/scannet.py:20-115``. File-format
contract follows reference dataset/scannet.py:7-103 and dataset/demo.py —
processed dirs with color/, depth/, pose/, intrinsic/, output/mask id-map
PNGs, and a `<seq>_vh_clean_2.ply` scene cloud. PNG files go through the
port's codec (``io/png.py``).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from maskclustering_tpu_torch.datasets.base import BaseDataset, make_label_maps
from maskclustering_tpu_torch.io import (
    png_size,
    read_depth_png,
    read_mask_png,
    read_ply_points,
    read_rgb,
    resize_nearest,
)
from maskclustering_tpu_torch.semantics.vocab import get_vocab


class ScanNetDataset(BaseDataset):
    depth_scale = 1000.0
    dataset_name = "scannet"

    def __init__(self, seq_name: str, data_root: str = "./data") -> None:
        self.seq_name = seq_name
        self.root = os.path.join(data_root, "scannet", "processed", seq_name)
        self.rgb_dir = os.path.join(self.root, "color")
        self.depth_dir = os.path.join(self.root, "depth")
        self.extrinsics_dir = os.path.join(self.root, "pose")
        self.intrinsic_path = os.path.join(self.root, "intrinsic", "intrinsic_depth.txt")
        self.point_cloud_path = os.path.join(self.root, f"{seq_name}_vh_clean_2.ply")
        self.data_root = data_root
        self._intrinsics_cache = None
        self._image_size = None

    @property
    def image_size(self):
        """(width, height) of the depth stream — the alignment target for
        segmentations (reference hardcodes 640x480, dataset/scannet.py:15;
        deriving it from the data keeps non-standard resolutions working)."""
        if self._image_size is None:
            names = sorted(f for f in os.listdir(self.depth_dir)
                           if f.split(".")[0].isdigit()) \
                if os.path.isdir(self.depth_dir) else []
            if not names:
                return (640, 480)
            self._image_size = png_size(os.path.join(self.depth_dir, names[0]))
        return self._image_size

    # frame ids are integers 0..last, subsampled by stride; the id space is
    # defined by the numerically-largest color image (reference scannet.py:25-31)
    def get_frame_list(self, stride: int) -> List[int]:
        names = [f for f in os.listdir(self.rgb_dir) if f.split(".")[0].isdigit()]
        if not names:
            return []
        end = max(int(f.split(".")[0]) for f in names) + 1
        return [int(i) for i in np.arange(0, end, stride)]

    def get_intrinsics(self, frame_id) -> np.ndarray:
        if self._intrinsics_cache is None:
            m = np.loadtxt(self.intrinsic_path)
            self._intrinsics_cache = np.asarray(m[:3, :3], dtype=np.float64)
        return self._intrinsics_cache

    def get_extrinsic(self, frame_id) -> np.ndarray:
        return np.loadtxt(os.path.join(self.extrinsics_dir, f"{frame_id}.txt"))

    def get_depth(self, frame_id) -> np.ndarray:
        return read_depth_png(os.path.join(self.depth_dir, f"{frame_id}.png"), self.depth_scale)

    def get_rgb(self, frame_id) -> np.ndarray:
        return read_rgb(os.path.join(self.rgb_dir, f"{frame_id}.jpg"))

    def get_segmentation(self, frame_id, align_with_depth: bool = True) -> np.ndarray:
        seg = read_mask_png(os.path.join(self.segmentation_dir, f"{frame_id}.png"))
        if align_with_depth:
            seg = resize_nearest(seg, self.image_size)
        return seg

    def get_frame_path(self, frame_id):
        return (
            os.path.join(self.rgb_dir, f"{frame_id}.jpg"),
            os.path.join(self.segmentation_dir, f"{frame_id}.png"),
        )

    def get_scene_points(self) -> np.ndarray:
        return read_ply_points(self.point_cloud_path)

    def get_label_features(self):
        path = os.path.join(self.data_root, "text_features", "scannet.npy")
        return np.load(path, allow_pickle=True).item()

    def get_label_id(self):
        labels, ids = get_vocab("scannet")
        return make_label_maps(labels, ids)


class DemoDataset(ScanNetDataset):
    """Demo scene layout: 640px color dir + its own intrinsics file
    (reference dataset/demo.py:12,34)."""

    dataset_name = "demo"

    def __init__(self, seq_name: str, data_root: str = "./data") -> None:
        super().__init__(seq_name, data_root)
        self.root = os.path.join(data_root, "demo", seq_name)
        self.rgb_dir = os.path.join(self.root, "color_640")
        self.depth_dir = os.path.join(self.root, "depth")
        self.extrinsics_dir = os.path.join(self.root, "pose")
        # demo layout keeps intrinsics at the scene root (reference dataset/demo.py:34)
        self.intrinsic_path = os.path.join(self.root, "intrinsic_640.txt")
        self.point_cloud_path = os.path.join(self.root, f"{seq_name}_vh_clean_2.ply")
