"""ScanNet++ (iPhone) sequence loader.

File contract follows reference dataset/scannetpp.py:113-217: COLMAP text
models (iphone/colmap/cameras.txt + images.txt) supply one shared pinhole
intrinsic and per-frame world-to-camera poses (quaternion + translation,
inverted to camera-to-world); frames are named frame_%06d; the scene cloud
is the x0.25-downsampled ``pcld_0.25/<seq>.pth`` tensor's sampled_coords.
Port of ``maskclustering_tpu/datasets/scannetpp.py``.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

import torch

from maskclustering_tpu_torch.datasets.base import BaseDataset, make_label_maps
from maskclustering_tpu_torch.io import read_depth_png, read_mask_png, read_rgb, resize_nearest
from maskclustering_tpu_torch.semantics.vocab import get_vocab


def quaternion_to_rotation(q: np.ndarray) -> np.ndarray:
    """COLMAP-convention (w, x, y, z) unit quaternion to rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def read_colmap_cameras(path: str) -> Dict[int, dict]:
    """COLMAP cameras.txt -> {camera_id: {model, width, height, params}}."""
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t = line.split()
            cams[int(t[0])] = {
                "model": t[1],
                "width": int(t[2]),
                "height": int(t[3]),
                "params": np.array([float(x) for x in t[4:]]),
            }
    return cams


def read_colmap_images(path: str) -> Dict[int, dict]:
    """COLMAP images.txt -> {image_id: {qvec, tvec, camera_id, name}}.

    Every image record is two lines; the second (2D point observations) is
    skipped.
    """
    images = {}
    with open(path) as f:
        lines = iter(f)
        for line in lines:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t = line.split()
            images[int(t[0])] = {
                "qvec": np.array([float(x) for x in t[1:5]]),
                "tvec": np.array([float(x) for x in t[5:8]]),
                "camera_id": int(t[8]),
                "name": t[9],
            }
            next(lines, None)  # skip the observations line
    return images


def colmap_intrinsics(cam: dict) -> np.ndarray:
    model, p = cam["model"], cam["params"]
    k = np.eye(3)
    if model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                 "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
        k[0, 0] = k[1, 1] = p[0]
        k[0, 2], k[1, 2] = p[1], p[2]
    elif model in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV",
                   "FOV", "THIN_PRISM_FISHEYE"):
        k[0, 0], k[1, 1] = p[0], p[1]
        k[0, 2], k[1, 2] = p[2], p[3]
    else:
        raise NotImplementedError(f"COLMAP camera model {model}")
    return k


class ScanNetPPDataset(BaseDataset):
    depth_scale = 1000.0
    image_size = (1920, 1440)
    dataset_name = "scannetpp"

    def __init__(self, seq_name: str, data_root: str = "./data") -> None:
        self.seq_name = seq_name
        self.root = os.path.join(data_root, "scannetpp", "data", seq_name)
        self.rgb_dir = os.path.join(self.root, "iphone", "rgb")
        self.depth_dir = os.path.join(self.root, "iphone", "render_depth")
        self.point_cloud_path = os.path.join(data_root, "scannetpp", "pcld_0.25", f"{seq_name}.pth")
        self.data_root = data_root

        colmap_dir = os.path.join(self.root, "iphone", "colmap")
        cameras = read_colmap_cameras(os.path.join(colmap_dir, "cameras.txt"))
        images = read_colmap_images(os.path.join(colmap_dir, "images.txt"))
        k = colmap_intrinsics(next(iter(cameras.values())))

        self.frame_id_list: List[int] = []
        self._extrinsics: Dict[int, np.ndarray] = {}
        self._intrinsics: Dict[int, np.ndarray] = {}
        for image in images.values():
            # names are frame_%06d.jpg -> integer frame id
            frame_id = int(os.path.splitext(image["name"])[0].split("_")[1])
            w2c = np.eye(4)
            w2c[:3, :3] = quaternion_to_rotation(image["qvec"])
            w2c[:3, 3] = image["tvec"]
            self.frame_id_list.append(frame_id)
            self._extrinsics[frame_id] = np.linalg.inv(w2c)
            self._intrinsics[frame_id] = k

    def get_frame_list(self, stride: int) -> List[int]:
        return self.frame_id_list[::stride]

    def get_intrinsics(self, frame_id) -> np.ndarray:
        return self._intrinsics[frame_id]

    def get_extrinsic(self, frame_id) -> np.ndarray:
        return self._extrinsics[frame_id]

    def get_depth(self, frame_id) -> np.ndarray:
        return read_depth_png(os.path.join(self.depth_dir, f"frame_{frame_id:06d}.png"),
                              self.depth_scale)

    def get_rgb(self, frame_id) -> np.ndarray:
        return read_rgb(os.path.join(self.rgb_dir, f"frame_{frame_id:06d}.jpg"))

    def get_segmentation(self, frame_id, align_with_depth: bool = True) -> np.ndarray:
        seg = read_mask_png(os.path.join(self.segmentation_dir, f"frame_{frame_id:06d}.png"))
        if align_with_depth:
            seg = resize_nearest(seg, self.image_size)
        return seg

    def get_frame_path(self, frame_id):
        return (
            os.path.join(self.rgb_dir, f"frame_{frame_id:06d}.jpg"),
            os.path.join(self.segmentation_dir, f"frame_{frame_id:06d}.png"),
        )

    def get_scene_points(self) -> np.ndarray:
        data = torch.load(self.point_cloud_path, map_location="cpu", weights_only=False)
        return np.asarray(data["sampled_coords"])

    def get_label_features(self):
        path = os.path.join(self.data_root, "text_features", "scannetpp.npy")
        return np.load(path, allow_pickle=True).item()

    def get_label_id(self):
        labels, ids = get_vocab("scannetpp")
        return make_label_maps(labels, ids)
