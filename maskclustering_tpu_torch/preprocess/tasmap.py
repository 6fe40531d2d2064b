"""TASMap (OmniGibson sim capture) -> MCT scene-layout converter
(``preprocess/tasmap.py``).

Reference tasmap/tasmap2mct_format.py: per-frame `extra_info/<frame>/`
captures (original_image.png, depth.npy in metres, pose_ori.npy holding
(position, xyzw-quaternion)) become the processed scene layout the dataset
loaders consume — color/<f>.jpg, depth/<f>.png (16-bit mm), pose/<f>.txt
(4x4 camera-to-world), intrinsic/*.txt — plus a fused, voxel-downsampled
`<scene>_vh_clean_2.ply` built by unprojecting every depth frame.

Host code, with the JAX module's bytes: colour through the port's
libjpeg-equal encoder at quality 95 and Pillow-equal bilinear resize.
Unprojection and the voxel downsample stay float64 numpy: the voxel means
sum with ``np.add.at`` in index order, which a device ``index_add_`` (its
atomics add in no fixed order) would not reproduce bit for bit.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional, Sequence, Tuple

import numpy as np

from maskclustering_tpu_torch.io.image import read_rgb, resize_bilinear, write_depth_png
from maskclustering_tpu_torch.io.jpeg import write_jpeg
from maskclustering_tpu_torch.io.ply import write_ply_points

# OmniGibson camera model (reference tasmap2mct_format.py:13-17)
OMNI_SENSOR_HEIGHT = 1024
OMNI_SENSOR_WIDTH = 1024
OMNI_FOCAL_LENGTH = 17.0
OMNI_HORIZ_APERTURE = 20.954999923706055

# Realsense D435 intrinsics for real-robot captures (tasmap2mct_format.py:35-39)
REALSENSE_INTRINSICS = (605.8658447265625, 605.128173828125,
                        429.753662109375, 237.18128967285156)


def omni_intrinsics(realsense: bool = False) -> Tuple[float, float, float, float]:
    """(fx, fy, cx, cy) from the simulator's aperture camera model."""
    if realsense:
        return REALSENSE_INTRINSICS
    vert_aperture = OMNI_SENSOR_HEIGHT / OMNI_SENSOR_WIDTH * OMNI_HORIZ_APERTURE
    fx = OMNI_SENSOR_WIDTH * OMNI_FOCAL_LENGTH / OMNI_HORIZ_APERTURE
    fy = OMNI_SENSOR_HEIGHT * OMNI_FOCAL_LENGTH / vert_aperture
    cx = OMNI_SENSOR_WIDTH * 0.5
    cy = OMNI_SENSOR_HEIGHT * 0.5
    return fx, fy, cx, cy


def quat_xyzw_to_rotmat(q: np.ndarray) -> np.ndarray:
    """(x,y,z,w) quaternion -> 3x3 rotation matrix."""
    x, y, z, w = (float(v) for v in q)
    return np.array([
        [2 * (w * w + x * x) - 1, 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 2 * (w * w + y * y) - 1, 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 2 * (w * w + z * z) - 1],
    ], dtype=np.float64)


def pose_to_extrinsic(position: np.ndarray, quat_xyzw: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Sim pose -> (world_to_cam, cam_to_world) 4x4 matrices.

    The sim camera looks along -Z with +Y up; the CV camera frame flips Y
    and Z, so the camera rows are (R@[1,0,0], R@[0,-1,0], R@[0,0,-1])
    (reference tasmap2mct_format.py:80-99). The on-disk pose txt is the
    camera-to-world matrix.
    """
    rot = quat_xyzw_to_rotmat(quat_xyzw)
    rows = np.stack([rot @ np.array([1.0, 0.0, 0.0]),
                     rot @ np.array([0.0, -1.0, 0.0]),
                     rot @ np.array([0.0, 0.0, -1.0])])
    t = -rows @ np.asarray(position, dtype=np.float64).reshape(3)
    world_to_cam = np.eye(4)
    world_to_cam[:3, :3] = rows
    world_to_cam[:3, 3] = t
    cam_to_world = np.eye(4)
    cam_to_world[:3, :3] = rows.T
    cam_to_world[:3, 3] = rows.T @ (-t)
    return world_to_cam, cam_to_world


def _unproject(depth: np.ndarray, fx, fy, cx, cy, cam_to_world: np.ndarray,
               depth_trunc: float = 20.0):
    """Depth (metres) -> (world points, valid pixel mask), vectorised."""
    h, w = depth.shape
    v, u = np.mgrid[0:h, 0:w]
    valid = (depth > 0) & (depth < depth_trunc)
    z = depth[valid]
    x = (u[valid] - cx) / fx * z
    y = (v[valid] - cy) / fy * z
    pts = np.stack([x, y, z], axis=1)
    return pts @ cam_to_world[:3, :3].T + cam_to_world[:3, 3], valid


def _voxel_downsample_colored(points: np.ndarray, colors: np.ndarray,
                              voxel_size: float):
    if len(points) == 0:
        return points, colors
    origin = points.min(axis=0)
    keys = np.floor((points - origin) / voxel_size).astype(np.int64)
    _, first, inverse, counts = np.unique(
        keys, axis=0, return_index=True, return_inverse=True, return_counts=True)
    sums = np.zeros((len(counts), 3), dtype=np.float64)
    np.add.at(sums, inverse, points)
    return sums / counts[:, None], colors[first]


def convert_tasmap_scene(
    extra_info_dir: str,
    output_dir: str,
    scene_name: str,
    realsense: bool = False,
    stride: int = 1,
    voxel_size: float = 0.005,
    buffer_size: int = 30,
    frames: Optional[Sequence[str]] = None,
) -> str:
    """Convert one capture to the MCT layout; returns the fused ply path.

    Mirrors reference tasmap2mct_format.py __main__: save_2D then
    create_downsampled_point_cloud with buffered incremental voxel
    downsampling (every `buffer_size` frames, then once at the end).
    """
    fx, fy, cx, cy = omni_intrinsics(realsense)
    for sub in ("color", "depth", "depth_npy", "pose", "intrinsic"):
        os.makedirs(os.path.join(output_dir, sub), exist_ok=True)

    if frames is None:
        frames = sorted(os.listdir(extra_info_dir))
    frames = list(frames)[::stride]

    k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    for name, mat in (("intrinsic_color", k), ("extrinsic_color", np.eye(4)),
                      ("intrinsic_depth", k), ("extrinsic_depth", np.eye(4))):
        np.savetxt(os.path.join(output_dir, "intrinsic", name + ".txt"), mat, fmt="%f")

    fused_pts, fused_cols = [], []
    buf_pts, buf_cols = [], []

    def _flush():
        nonlocal buf_pts, buf_cols
        if buf_pts:
            p, c = _voxel_downsample_colored(
                np.concatenate(buf_pts), np.concatenate(buf_cols), voxel_size)
            fused_pts.append(p)
            fused_cols.append(c)
            buf_pts, buf_cols = [], []

    for i, frame in enumerate(frames):
        fdir = os.path.join(extra_info_dir, frame)
        rgb = read_rgb(os.path.join(fdir, "original_image.png"))
        write_jpeg(os.path.join(output_dir, "color", f"{frame}.jpg"), rgb, 95)

        depth_m = np.load(os.path.join(fdir, "depth.npy")).astype(np.float32)
        shutil.copy(os.path.join(fdir, "depth.npy"),
                    os.path.join(output_dir, "depth_npy", f"{frame}.npy"))
        write_depth_png(os.path.join(output_dir, "depth", f"{frame}.png"),
                        depth_m * 1000.0)

        pose_ori = np.load(os.path.join(fdir, "pose_ori.npy"), allow_pickle=True)
        _, cam_to_world = pose_to_extrinsic(pose_ori[0], pose_ori[1])
        np.savetxt(os.path.join(output_dir, "pose", f"{frame}.txt"),
                   cam_to_world, fmt="%.6f")

        if rgb.shape[:2] != depth_m.shape:
            rgb = resize_bilinear(rgb, depth_m.shape[0], depth_m.shape[1])
        pts, valid = _unproject(depth_m, fx, fy, cx, cy, cam_to_world)
        buf_pts.append(pts)
        buf_cols.append(rgb[valid])
        if (i + 1) % buffer_size == 0:
            _flush()
    _flush()

    if fused_pts:
        pts, cols = _voxel_downsample_colored(
            np.concatenate(fused_pts), np.concatenate(fused_cols), voxel_size)
    else:
        pts = np.zeros((0, 3))
        cols = np.zeros((0, 3), dtype=np.uint8)
    ply_path = os.path.join(output_dir, f"{scene_name}_vh_clean_2.ply")
    write_ply_points(ply_path, pts, cols)
    return ply_path
