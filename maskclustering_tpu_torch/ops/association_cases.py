"""Edge cases of the dense association, shared by the port's tests and
``chip_smoke.py``.

A one-frame case (``CASES``) is a dict with the inputs of
``models.backprojection.associate_frame``: ``points`` (N, 3) f32,
``depth`` (H, W) f32, ``seg`` (H, W) i32, ``intrinsics`` (3, 3) f32,
``cam_to_world`` (4, 4) f32, ``frame_valid`` bool and the keywords
``k_max``, ``window``, ``distance_threshold``, ``depth_trunc``,
``few_points_threshold`` and ``coverage_threshold``. A scene case
(``SCENE_CASES``, and :func:`as_scene` of a one-frame case) holds the
inputs of ``associate_scene``: the same keys with a leading frame axis,
``depths``, ``segs``, ``intrinsics``, ``cam_to_world`` and
``frame_valid`` (F,). They are made with numpy from a fixed seed or
planted by hand, and aim at the CUDA kernels' structure
(``ops/cuda/associate.cu``): one thread a point in blocks of 256 that walk
a group of frames, the window walked in registers, lanes that claim one id
counted together, the shared histogram of k_max + 1 bins a frame, and the
exact rounding of the pixel coordinate and the claim distance.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

Case = Dict[str, object]

_K = np.array([[100.0, 0.0, 79.5], [0.0, 100.0, 59.5], [0.0, 0.0, 1.0]], np.float32)


def _pose(rng) -> np.ndarray:
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    q *= np.sign(np.linalg.det(q))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = q
    m[:3, 3] = rng.uniform(-1, 1, 3)
    return m


def _world(cam: np.ndarray, c2w: np.ndarray) -> np.ndarray:
    return (cam.astype(np.float64) @ c2w[:3, :3].T.astype(np.float64)
            + c2w[:3, 3]).astype(np.float32)


def _case(points, depth, seg, *, intrinsics=_K, cam_to_world=None, frame_valid=True, k_max=63,
          window=1, distance_threshold=0.05, few_points_threshold=0,
          coverage_threshold=0.0, depth_trunc=20.0) -> Case:
    return dict(points=np.ascontiguousarray(points, np.float32),
                depth=np.ascontiguousarray(depth, np.float32),
                seg=np.ascontiguousarray(seg, np.int32),
                intrinsics=np.asarray(intrinsics, np.float32),
                cam_to_world=np.eye(4, dtype=np.float32) if cam_to_world is None
                else np.asarray(cam_to_world, np.float32),
                frame_valid=bool(frame_valid), k_max=k_max, window=window,
                distance_threshold=distance_threshold, depth_trunc=depth_trunc,
                few_points_threshold=few_points_threshold,
                coverage_threshold=coverage_threshold)


def _scene(seed: int, n: int, *, h=120, w=160, ids=15, spread=1.2, **kw) -> Case:
    """Random points over (and a little past) the frustum of a posed camera,
    a noisy depth surface and random ids, so windows claim several masks."""
    rng = np.random.default_rng(seed)
    c2w = _pose(rng)
    u = rng.uniform(-spread * 10, w + spread * 10, n)
    v = rng.uniform(-spread * 10, h + spread * 10, n)
    z = rng.uniform(1.0, 3.0, n)
    cam = np.stack([(u - _K[0, 2]) * z / _K[0, 0], (v - _K[1, 2]) * z / _K[1, 1], z], 1)
    cam += rng.normal(0, 0.01, cam.shape)
    depth = rng.uniform(1.0, 3.0, (h, w))
    seg = rng.integers(0, ids + 1, (h, w))
    return _case(_world(cam, c2w), depth, seg, cam_to_world=c2w, **kw)


def _planar(seed: int, n: int, *, h=120, w=160, ids=40, **kw) -> Case:
    """Points on the plane z = 2 that the depth map also holds, seen
    head-on, so every window pixel within the radius claims."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, w, n)
    v = rng.uniform(0, h, n)
    z = np.full(n, 2.0)
    cam = np.stack([(u - _K[0, 2]) * z / _K[0, 0], (v - _K[1, 2]) * z / _K[1, 1], z], 1)
    return _case(cam, np.full((h, w), 2.0), rng.integers(1, ids + 1, (h, w)), **kw)


def _behind_camera() -> Case:
    # points at, just behind and just in front of z = 1e-6, and far behind
    case = _scene(11, 600)
    pts = case["points"]
    c2w = case["cam_to_world"]
    rng = np.random.default_rng(12)
    cam = np.stack([rng.uniform(-0.5, 0.5, 200), rng.uniform(-0.5, 0.5, 200),
                    np.tile(np.float32([-2.0, -1e-6, 0.0, 1e-6, 2e-6, 1e-7, -0.5, 1e-3]), 25)], 1)
    case["points"] = np.concatenate([pts, _world(cam, c2w)])
    return case


def _off_borders() -> Case:
    # footprints inside the image, within the window of each border and
    # corner, and far off every side
    rng = np.random.default_rng(13)
    h, w = 60, 80
    us = np.concatenate([rng.uniform(-3, w + 3, 300), [-1.4, -0.6, -2.6, w - 0.4, w + 0.6, w + 1.6],
                         rng.uniform(-500, -50, 20), rng.uniform(w + 50, w + 500, 20)])
    vs = np.concatenate([rng.uniform(-3, h + 3, 300), [-1.4, h + 0.6, -0.6, h - 0.4, -2.6, h + 1.6],
                         rng.uniform(-500, h + 500, 40)])
    z = np.full(len(us), 2.0)
    k = np.array([[100.0, 0, 39.5], [0, 100.0, 29.5], [0, 0, 1]], np.float32)
    cam = np.stack([(us - k[0, 2]) * z / k[0, 0], (vs - k[1, 2]) * z / k[1, 1], z], 1)
    seg = rng.integers(1, 30, (h, w))
    return _case(cam, np.full((h, w), 2.0), seg, intrinsics=k, distance_threshold=0.08)


def _half_pixel() -> Case:
    # footprints within a few ulps of .5 after a rotation, where the FMA of
    # x / z * fx + cx decides the pixel, seen by a radius that claims the
    # whole window, so a shifted window changes the claiming ids
    h, w = 16, 24
    rng = np.random.default_rng(14)
    c2w = _pose(rng)
    k = np.array([[50.0, 0, 11.5], [0, 50.0, 7.5], [0, 0, 1]], np.float32)
    u = rng.integers(0, w, 4000) + 0.5
    v = rng.integers(0, h, 4000) + 0.5
    z = rng.uniform(1.0, 3.0, 4000)
    cam = np.stack([(u - k[0, 2]) * z / k[0, 0], (v - k[1, 2]) * z / k[1, 1], z], 1)
    return _case(_world(cam, c2w), rng.uniform(1.0, 3.0, (h, w)), rng.integers(1, 60, (h, w)),
                 intrinsics=k, cam_to_world=c2w, distance_threshold=1.0)


def _half_pixel_exact() -> Case:
    # x / z * fx + cx exactly on .5 (fx = 2, cx = 0.5, z = 1, identity
    # pose): half to even sends 2.5 to 2 and 3.5 to 4
    h, w = 16, 24
    k = np.array([[2.0, 0, 0.5], [0, 2.0, 0.5], [0, 0, 1]], np.float32)
    ties = np.array([[x, y, 1.0] for x in (0.25, 0.75, 1.0, 1.5, 2.0, 3.0, 4.5)
                     for y in (0.25, 0.5, 1.0, 1.5, 2.5)], np.float32)
    seg = np.random.default_rng(15).integers(1, 60, (h, w))
    return _case(ties, np.ones((h, w)), seg, intrinsics=k, distance_threshold=0.75)


def _dist2_at_r2() -> Case:
    # identity pose, dyadic depth and intrinsics, so q - p is exact: offsets
    # of exactly the radius (0.25, dist2 == r2 == 0.0625) claim, one float
    # step further does not
    h, w = 8, 8
    k = np.array([[4.0, 0, 4.0], [0, 4.0, 4.0], [0, 0, 1]], np.float32)
    depth = np.full((h, w), 2.0)
    seg = np.arange(1, h * w + 1).reshape(h, w) % 50 + 1
    pts = []
    for uu in range(1, 7):
        for vv in range(1, 7):
            qx, qy = (uu - 4.0) * 2.0 / 4.0, (vv - 4.0) * 2.0 / 4.0
            pts.append([qx - 0.25, qy, 2.0])
            pts.append([qx, qy + 0.25, 2.0])
            pts.append([qx, qy, 2.25])
            pts.append([np.nextafter(np.float32(qx - 0.25), np.float32(-9)), qy, 2.0])
            pts.append([qx, qy, np.nextafter(np.float32(2.25), np.float32(9))])
    return _case(np.array(pts), depth, seg, intrinsics=k, distance_threshold=0.25)


def _dist2_near_r2() -> Case:
    # points around the backprojection (0, 0, 2) of the principal pixel
    # (identity pose, fx = depth = 2), at the radius r in random directions:
    # a^2 + b^2 of the float32 offsets lies within a few ulps of r2, so the
    # FMA of the claim distance decides which of them claim
    h, w = 64, 64
    k = np.array([[2.0, 0, 32.0], [0, 2.0, 32.0], [0, 0, 1]], np.float32)
    r = 0.0211
    theta = np.random.default_rng(21).uniform(0, 2 * np.pi, 4000)
    pts = np.stack([r * np.cos(theta), r * np.sin(theta), np.full(theta.shape, 2.0)], 1)
    seg = np.random.default_rng(22).integers(1, 60, (h, w))
    return _case(pts, np.full((h, w), 2.0), seg, intrinsics=k, distance_threshold=r)


def _k1023() -> Case:
    # ids up to 1023 and beyond it (dropped), negative ids, k_max = 1023:
    # the shared histogram holds 1024 bins
    case = _scene(15, 3000, ids=1023, k_max=1023)
    rng = np.random.default_rng(16)
    seg = case["seg"]
    seg[rng.random(seg.shape) < 0.05] = 1500
    seg[rng.random(seg.shape) < 0.05] = -3
    return case


def _k63_ids_beyond() -> Case:
    return _scene(17, 2500, ids=90, k_max=63)


def _frame_invalid() -> Case:
    case = _scene(18, 1200)
    case["frame_valid"] = False
    return case


def _depth_trunc() -> Case:
    # depths past the cut-off and zero depths never claim
    case = _scene(19, 2000, depth_trunc=2.2)
    rng = np.random.default_rng(20)
    case["depth"][rng.random(case["depth"].shape) < 0.1] = 0.0
    return case


CASES = {
    "random_w1": lambda: _scene(1, 5000),
    "random_w2": lambda: _scene(2, 5000, window=2),
    "random_w0": lambda: _scene(3, 700, window=0, distance_threshold=0.2),
    "random_w3": lambda: _scene(4, 900, window=3, h=40, w=50),
    "planar_w1": lambda: _planar(5, 6000, distance_threshold=0.05),
    "planar_w2": lambda: _planar(6, 3000, window=2, distance_threshold=0.1),
    "behind_camera": _behind_camera,
    "off_borders": _off_borders,
    "half_pixel": _half_pixel,
    "half_pixel_exact": _half_pixel_exact,
    "dist2_at_r2": _dist2_at_r2,
    "dist2_near_r2": _dist2_near_r2,
    "k_max_63_ids_beyond": _k63_ids_beyond,
    "k_max_1023": _k1023,
    "frame_invalid": _frame_invalid,
    "depth_trunc": _depth_trunc,
    "n_not_block_multiple": lambda: _scene(7, 257),
    "n_one": lambda: _scene(8, 1),
    "filters_on": lambda: _planar(9, 20000, ids=12, few_points_threshold=25,
                                  coverage_threshold=0.3, distance_threshold=0.03),
}


def association_case(name: str) -> Case:
    """The named case's inputs, made anew."""
    return CASES[name]()


_FRAME_KEYS = {"depth": ("depths", np.float32), "seg": ("segs", np.int32),
               "intrinsics": ("intrinsics", np.float32),
               "cam_to_world": ("cam_to_world", np.float32),
               "frame_valid": ("frame_valid", np.bool_)}


def _stack(frames) -> Case:
    """A scene case from one-frame cases that share their points, map size
    and keywords (those of the first frame)."""
    scene = {k: v for k, v in frames[0].items() if k not in _FRAME_KEYS}
    for key, (stacked, dtype) in _FRAME_KEYS.items():
        scene[stacked] = np.stack([np.asarray(fr[key], dtype) for fr in frames])
    return scene


def as_scene(case: Case) -> Case:
    """A one-frame case as a scene case of one frame."""
    return _stack([case])


def _with_pose(case: Case, cam_to_world, **changes) -> Case:
    return {**case, "cam_to_world": np.asarray(cam_to_world, np.float32), **changes}


def _three_frames() -> Case:
    # a valid frame, an invalid one seen from a nearby pose, and a padded
    # frame (all-zero pose, as pipeline.pad_scene_tensors pads) over real
    # maps: the padded pose claims nothing
    base = _scene(31, 3000, few_points_threshold=5, coverage_threshold=0.1)
    rng = np.random.default_rng(32)
    moved = base["cam_to_world"].copy()
    moved[:3, 3] += rng.normal(0, 0.05, 3).astype(np.float32)
    second = _with_pose(base, moved, frame_valid=False, seg=rng.integers(0, 16, (120, 160)))
    padded = _with_pose(base, np.zeros((4, 4)), frame_valid=False,
                        intrinsics=np.ones((3, 3), np.float32))
    return _stack([base, second, padded])


def _all_behind() -> Case:
    # the second camera is the first turned half a turn about its x axis:
    # every point lies behind it
    base = _scene(33, 2000)
    flip = base["cam_to_world"] @ np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    return _stack([base, _with_pose(base, flip)])


def _grid_plane(h: int, w: int, seg, **kw) -> Case:
    # one point at the backprojection of every pixel centre of a head-on
    # plane at z = 2, in row-major order: consecutive points, and so the
    # lanes of a warp, sit on consecutive pixels
    v, u = np.mgrid[0:h, 0:w]
    z = np.full(h * w, 2.0)
    cam = np.stack([(u.ravel() - _K[0, 2]) * z / _K[0, 0], (v.ravel() - _K[1, 2]) * z / _K[1, 1],
                    z], 1)
    return _case(cam, np.full((h, w), 2.0), seg, **kw)


def _one_id_block() -> Case:
    # every pixel holds one id, so every lane of every block claims it
    h, w = 32, 64
    frames = [_grid_plane(h, w, np.full((h, w), i), distance_threshold=0.05) for i in (7, 63)]
    return _stack(frames)


def _k1023_lane_ids() -> Case:
    # k_max 1023 and a different id at every pixel: no two lanes of a warp
    # claim the same id at the same window slot
    h, w = 32, 64
    ids = np.arange(h * w).reshape(h, w) % 1023 + 1
    frames = [_grid_plane(h, w, (ids + shift - 1) % 1023 + 1, k_max=1023, distance_threshold=0.05)
              for shift in (0, 500)]
    return _stack(frames)


def _frames_of(seed: int, n: int, f: int, **kw) -> Case:
    # f frames of one cloud, each seen from a pose near the first
    base = _scene(seed, n, **kw)
    rng = np.random.default_rng(seed + 1000)
    frames = [base]
    for _ in range(f - 1):
        pose = base["cam_to_world"].copy()
        pose[:3, 3] += rng.normal(0, 0.03, 3).astype(np.float32)
        frames.append(_with_pose(base, pose, depth=rng.uniform(1.0, 3.0, (120, 160)),
                                 seg=rng.integers(0, 16, (120, 160))))
    return _stack(frames)


SCENE_CASES = {
    "three_frames_invalid_padded": _three_frames,
    "all_behind_camera": _all_behind,
    "one_id_every_lane": _one_id_block,
    "k_max_1023_id_per_lane": _k1023_lane_ids,
    "n_not_block_multiple_f5": lambda: _frames_of(34, 300, 5),
    "one_frame": lambda: _frames_of(35, 1500, 1),
}


def association_scene_case(name: str) -> Case:
    """The named scene case's inputs, made anew."""
    return SCENE_CASES[name]()
