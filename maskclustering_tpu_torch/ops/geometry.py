"""Host-side (float64 numpy) camera geometry of the exact-parity path.

Copies of ``maskclustering_tpu/ops/geometry.py:89-137``. Pinhole
conventions match Open3D: pixel (u, v) at depth z unprojects to
x = (u - cx) z / fx, y = (v - cy) z / fy (no half-pixel offset), and the
camera-to-world extrinsic applies as p_world = R p_cam + t.
"""

from __future__ import annotations

import numpy as np


def backproject_depth_np(depth: np.ndarray, intrinsics: np.ndarray,
                         cam_to_world: np.ndarray, depth_trunc: float = np.inf):
    """Host pinhole backprojection: (world points (M, 3) f64, valid (H, W) bool)."""
    depth = np.asarray(depth, dtype=np.float64)
    intrinsics = np.asarray(intrinsics, dtype=np.float64)
    cam_to_world = np.asarray(cam_to_world, dtype=np.float64)
    h, w = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    v, u = np.mgrid[0:h, 0:w]
    valid = (depth > 0) & (depth <= depth_trunc)
    z = depth[valid]
    pts = np.stack([(u[valid] - cx) / fx * z, (v[valid] - cy) / fy * z, z], axis=1)
    pts = pts @ cam_to_world[:3, :3].T + cam_to_world[:3, 3]
    return pts, valid


def voxel_downsample_np(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Mean of the points in each occupied voxel of the min-corner grid
    (Open3D ``voxel_down_sample``), voxels in sorted key order."""
    points = np.asarray(points)
    if len(points) == 0:
        return points
    origin = points.min(axis=0)
    keys = np.floor((points - origin) / voxel_size).astype(np.int64)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((len(counts), 3), dtype=np.float64)
    np.add.at(sums, inverse.reshape(-1), points)
    return sums / counts[:, None]


def bboxes_overlap(amin, amax, bmin, bmax) -> bool:
    """Axis-aligned box intersection test (reference utils/geometry.py:3-7)."""
    return bool(np.all(np.asarray(amin) <= np.asarray(bmax))
                and np.all(np.asarray(bmin) <= np.asarray(amax)))
