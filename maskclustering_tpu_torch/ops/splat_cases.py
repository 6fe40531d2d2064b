"""Edge cases of the z-buffered splat, shared by the port's tests and
``chip_smoke.py``.

A case (``SPLAT_CASES``) is a dict with the inputs of
``visualize.top_images.project_zbuffer``: ``points`` (N, 3) f32,
``colors`` (N, 3) f32, ``intrinsics`` (3, 3) f32, ``cam_to_world`` (4, 4)
f32, ``height`` and ``width``. A batch (``SPLAT_BATCHES``) holds F cameras
instead, (F, 3, 3) and (F, 4, 4), as ``bboxes_by_projection`` and the
kernels' (F, 16) cameras take them: every case under three cameras, and a
frame no point lands in between two full ones. They are made with numpy
from a fixed seed or planted by hand, and aim at the kernels' structure
(``ops/cuda/splat.cu``): one thread a point in blocks of 256 looping over
the frames, integer atomics on the depth bits and the packed colour, the
box's warp and block reductions, the rounding of the pixel coordinate
(half to even, saturating conversions, NaN to 0) and of the colour
(truncation toward zero, then a clip).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

Case = Dict[str, object]

# fx = fy = 50, cx = 32, cy = 24: x = 0.1 at z = 2 lands on 34.5
_K = np.array([[50.0, 0.0, 32.0], [0.0, 50.0, 24.0], [0.0, 0.0, 1.0]], np.float32)
_H, _W = 48, 64


def _pose(rng) -> np.ndarray:
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    q *= np.sign(np.linalg.det(q))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = q
    m[:3, 3] = rng.uniform(-1, 1, 3)
    return m


def _case(points, colors, intrinsics=_K, cam_to_world=None, height=_H, width=_W) -> Case:
    points = np.asarray(points, np.float32).reshape(-1, 3)
    return {"points": points,
            "colors": np.asarray(colors, np.float32).reshape(-1, 3),
            "intrinsics": np.asarray(intrinsics, np.float32),
            "cam_to_world": (np.eye(4, dtype=np.float32) if cam_to_world is None
                             else np.asarray(cam_to_world, np.float32)),
            "height": int(height), "width": int(width)}


def _random_cloud(seed: int, n: int, height: int, width: int) -> Case:
    """Points in front of and behind a posed camera, many off the image,
    some sharing a pixel and a depth, colours a little outside [0, 1]."""
    rng = np.random.default_rng(seed)
    c2w = _pose(rng)
    fx, fy = rng.uniform(30, 600, 2)
    k = np.array([[fx, 0, rng.uniform(0, width)], [0, fy, rng.uniform(0, height)], [0, 0, 1]],
                 np.float32)
    cam = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(-0.5, 4, n)], 1)
    pts = (cam @ c2w[:3, :3].T.astype(np.float64) + c2w[:3, 3]).astype(np.float32)
    if n > 16:
        pts[n // 2:n // 2 + 8] = pts[:8]  # the same point twice: a depth tie
    cols = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    return _case(pts, cols, k, c2w, height, width)


def _cases() -> Dict[str, Case]:
    out: Dict[str, Case] = {}
    # one in front, one behind the camera, one exactly at the depth floor
    out["behind_camera"] = _case([[0, 0, -1.0], [0, 0, 2.0], [0, 0, 1e-6]], np.ones((3, 3)))
    # 50 * 0.1 / 2 + 32 = 34.5 and 50 * 0.05 / 2 + 24 = 25.25, 50 * 0.1 / 2 + 24
    # = 26.5: pixel coordinates on .5 round half to even (34, 26)
    out["half_pixel"] = _case([[0.1, 0.05, 2.0], [0.1, 0.1, 2.0], [-0.1, -0.1, 2.0],
                               [0.3, 0.3, 2.0]], np.full((4, 3), 0.5))
    # four points on one pixel (32.5 and 24.5 round to 32, 24) at one depth
    # with different colours: the largest packed code wins whole; four
    # farther points on the same pixel stay hidden
    tie = np.array([[0.02, 0.02, 2.0]] * 4 + [[0.0, 0.0, 3.0]] * 3 + [[0.0, 0.0, 2.5]],
                   np.float32)
    cols = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0.5, 0.9, 0.1],
                     [0.2, 0.2, 0.2], [0.9, 0.1, 0.1], [0.3, 0.3, 0.3], [0.1, 0.1, 0.1]],
                    np.float32)
    out["depth_ties"] = _case(tie, cols)
    # no point lands: behind, off every border, NaN
    out["all_invalid"] = _case([[0, 0, -2.0], [10.0, 0, 1.0], [-10.0, 0, 1.0], [0, 10.0, 1.0],
                                [0, -10.0, 1.0], [np.nan, 0, 1.0], [0, 0, np.nan]],
                               np.ones((7, 3)))
    # pixel coordinates past int32 (tiny depth, far off-axis): the
    # conversion saturates, and the point is off the image
    out["saturating"] = _case([[1e4, 1e4, 2e-6], [-1e4, -1e4, 2e-6], [0.0, 0.0, 2.0]],
                              np.full((3, 3), 0.25))
    # colours: truncation toward zero, then the clip; +-inf saturate
    out["colour_rounding"] = _case(
        [[0.04 * i, 0.0, 2.0] for i in range(6)],
        [[0.999, 1.0 / 255, 254.5 / 255], [-0.001, -0.5, 1.5], [np.inf, -np.inf, 0.5],
         [0.5, 0.25, 0.125], [1e10, -1e10, 0.0], [0.0039, 0.0040, 0.9999]])
    # one point, and N = 0
    out["one_point"] = _case([[0.0, 0.0, 1.0]], [[0.2, 0.4, 0.6]])
    out["no_points"] = _case(np.zeros((0, 3)), np.zeros((0, 3)))
    # clouds not a multiple of the 256-thread block, posed cameras
    out["random_1000"] = _random_cloud(3, 1000, _H, _W)
    out["random_4097"] = _random_cloud(4, 4097, 120, 160)
    # one row and one column images
    out["one_row"] = _random_cloud(5, 300, 1, 64)
    out["one_column"] = _random_cloud(6, 300, 48, 1)
    # the box's traps. A point at z = +inf lands (its pixel x is NaN, which
    # converts to column 0) but leaves +inf there: it must not widen the box
    out["z_inf_in_bounds"] = _case([[0.0, 0.0, np.inf], [0.1, 0.1, 2.0], [0.2, 0.0, 2.0]],
                                   np.full((3, 3), 0.5))
    # a NaN pixel x (fx NaN) converts to 0: every point in front lands in
    # column 0, which fills
    k_nan = _K.copy()
    k_nan[0, 0] = np.nan
    out["nan_x"] = _case([[0.1, 0.1, 2.0], [-0.2, -0.3, 1.5], [0.3, 0.2, 3.0], [0, 0, -1.0]],
                         np.full((4, 3), 0.75), k_nan)
    # every point behind the camera: no box
    out["all_behind"] = _case([[0.1, 0.1, -2.0], [0.0, 0.0, -1e-3], [-0.2, 0.3, -5.0]],
                              np.full((3, 3), 0.5))
    return out


SPLAT_CASES: Dict[str, Case] = _cases()


def _turned_round(c2w: np.ndarray) -> np.ndarray:
    """The camera rotated half a turn about its x axis: what was in front is
    behind it."""
    return (c2w @ np.diag([1.0, -1.0, -1.0, 1.0])).astype(np.float32)


def _moved_back(c2w: np.ndarray, dist: float = 0.25) -> np.ndarray:
    out = c2w.copy()
    out[:3, 3] -= np.float32(dist) * c2w[:3, 2]
    return out


def batched(case: Case) -> Case:
    """The case's points under three cameras, as the F-camera entries take
    them: ``intrinsics`` (3, 3, 3) and ``cam_to_world`` (3, 4, 4), its own
    camera, the same turned round and the same moved back along its axis."""
    c2w = case["cam_to_world"]
    out = dict(case)
    out["intrinsics"] = np.stack([case["intrinsics"]] * 3)
    out["cam_to_world"] = np.stack([c2w, _turned_round(c2w), _moved_back(c2w)])
    return out


def _batches() -> Dict[str, Case]:
    out = {name: batched(c) for name, c in SPLAT_CASES.items()}
    # a frame no point lands in between two full ones: every point is in
    # front of the first and the last camera and behind the middle one
    rng = np.random.default_rng(7)
    n = 777
    pts = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.4, 0.4, n),
                    rng.uniform(1.0, 3.0, n)], 1).astype(np.float32)
    eye = np.eye(4, dtype=np.float32)
    out["empty_between"] = _case(pts, rng.uniform(0, 1, (n, 3)), np.stack([_K] * 3),
                                 np.stack([eye, _turned_round(eye), _moved_back(eye)]))
    return out


# the F-camera cases: intrinsics (F, 3, 3), cam_to_world (F, 4, 4)
SPLAT_BATCHES: Dict[str, Case] = _batches()
