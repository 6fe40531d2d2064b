"""TASMap (OmniGibson sim) sequence loader.

ScanNet-like processed layout with 1024x1024 frames and string frame ids
taken from the color filenames (reference dataset/tasmap.py:7-34; the
reference hardcodes a /workspace root — here the root is data_root-relative
like every other dataset). Port of ``maskclustering_tpu/datasets/tasmap.py``.
"""

from __future__ import annotations

import os
from typing import List

from maskclustering_tpu_torch.datasets.scannet import ScanNetDataset


class TASMapDataset(ScanNetDataset):
    image_size = (1024, 1024)
    dataset_name = "tasmap"

    def __init__(self, seq_name: str, data_root: str = "./data") -> None:
        super().__init__(seq_name, data_root)
        self.root = os.path.join(data_root, "tasmap", "processed", seq_name)
        self.rgb_dir = os.path.join(self.root, "color")
        self.depth_dir = os.path.join(self.root, "depth")
        self.extrinsics_dir = os.path.join(self.root, "pose")
        self.intrinsic_path = os.path.join(self.root, "intrinsic", "intrinsic_depth.txt")
        self.point_cloud_path = os.path.join(self.root, f"{seq_name}_vh_clean_2.ply")

    def get_frame_list(self, stride: int) -> List[str]:
        names = sorted(os.listdir(self.rgb_dir), key=lambda x: int(x.split(".")[0]))
        return [n.split(".")[0] for n in names][::stride]
