"""Edge cases of the box-and-floor renderer, shared by the port's tests and
``chip_smoke.py``.

A case (``RENDER_CASES``, by name) holds the inputs of
``utils.synthetic.render_depth_seg_device``: ``boxes`` (K, 2, 3) min and
max corners, ``poses`` (F, 4, 4) f32 camera-to-world, ``intrinsics`` (F, 3,
3) f32, ``perms`` (F, K) int32 (entry k the mask id of box k) and
``image_hw``. They aim at the kernel's structure (``ops/cuda/render.cu``):
the strict first-index tie between identical boxes (within one chunk of 8
and across chunks), a camera inside a box (``tmin`` <= 0 < ``tmax``), a box
behind the camera, ray directions with exact zero components (``safe_d``),
a floor nearer than a box (a box below the floor plane), a padded last
chunk, and frames of a blocks' ragged edge (H x W not a multiple of 256).
Since the kernel's fast path (exact quotients from one reciprocal a pixel
and axis, no NaN tests in the box loop, boxes with ``tmax`` <= 0 skipped
before their near planes) they also aim at its routing: NaN ray directions,
directions beyond its range beside ones inside it in one frame, and a box
behind the camera on the very line of a box in front of it.

:func:`random_frames` draws whole frames for the same comparisons: random
boxes, poses and focal lengths, extreme ones included.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

Case = Dict[str, object]

_H, _W = 33, 47  # odd: pixel (cx, cy) = (23, 16) is integral, its ray axis-aligned


def _intr(f: int, h: int = _H, w: int = _W) -> np.ndarray:
    fx = 1.1 * max(h, w)
    k = np.array([[fx, 0, (w - 1) / 2.0], [0, fx, (h - 1) / 2.0], [0, 0, 1.0]], np.float32)
    return np.tile(k[None], (f, 1, 1))


def _look(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    fwd = np.asarray(target, np.float64) - np.asarray(eye, np.float64)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w.astype(np.float32)


def _horizontal(eye) -> np.ndarray:
    """Looking along +y: d_world = (dx, 1, -dy) exactly, so the centre
    column's x and the centre row's z are exact zeros."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = (1, 0, 0), (0, 0, -1), (0, 1, 0)
    c2w[:3, 3] = eye
    return c2w


def _case(boxes, poses, seed: int = 0) -> Case:
    boxes = np.asarray(boxes, np.float64)
    poses = np.stack(poses).astype(np.float32)
    rng = np.random.default_rng(seed)
    perms = np.stack([rng.permutation(len(boxes)) + 1 for _ in poses]).astype(np.int32)
    return {"boxes": boxes, "poses": poses, "intrinsics": _intr(len(poses)), "perms": perms,
            "image_hw": (_H, _W)}


_BOX = [[-0.5, -0.5, 0.0], [0.5, 0.5, 0.8]]


def _cases() -> Dict[str, Case]:
    view = _look([3.0, -2.5, 2.0], [0.0, 0.0, 0.4])
    cases = {
        # the same box twice: every hit pixel ties, the lower index wins
        "identical_boxes": _case([_BOX, _BOX], [view, _look([-2.0, 3.0, 1.5], [0, 0, 0.3])]),
        # identical boxes at indices 3 and 11: the tie crosses a chunk of 8
        "tie_across_chunks": _case(
            [[[2.0 + i, 2.0, 0.0], [2.3 + i, 2.3, 0.3]] for i in range(3)] + [_BOX]
            + [[[-3.0 - i, 2.0, 0.0], [-2.7 - i, 2.3, 0.3]] for i in range(7)] + [_BOX],
            [view], seed=1),
        # the camera inside the box: tmin <= 0 < tmax, t = tmax everywhere
        "camera_inside": _case([_BOX, [[1.0, 1.0, 0.0], [1.5, 1.5, 0.5]]],
                               [_look([0.1, -0.2, 0.4], [2.0, 2.0, 0.3])]),
        # a box behind the camera only, another in front
        "box_behind": _case([[[-4.0, 3.5, 0.0], [-3.0, 4.5, 1.0]], _BOX],
                            [_look([-2.5, 2.5, 1.0], [0.0, 0.0, 0.4])]),
        # exact zero ray components in the centre column and row
        "zero_direction": _case([[[-0.4, 2.0, 0.5], [0.4, 3.0, 1.5]],
                                 [[-2.0, 4.0, -0.5], [2.0, 5.0, 0.9]]],
                                [_horizontal([0.0, 0.0, 1.0]), _horizontal([0.0, 0.0, 0.9])]),
        # a box under the floor plane: the floor is nearer wherever both are hit
        "floor_nearer": _case([[[-1.0, -1.0, -0.6], [1.0, 1.0, -0.1]], _BOX],
                              [_look([0.0, -3.0, 2.5], [0.0, 0.0, -0.3])]),
        # 11 boxes: the second chunk of 8 holds 5 padded boxes
        "padded_chunk": _case(
            [[[x, y, 0.0], [x + 0.5, y + 0.4, 0.3 + 0.1 * (i % 3)]]
             for i, (x, y) in enumerate([(a, b) for a in (-2.0, -0.7, 0.6) for b in (-2.0, -0.5, 1.0, 2.5)][:11])],
            [view, _look([-3.5, 1.0, 2.5], [0, 0, 0.2]), _look([0.5, 4.0, 1.2], [0, 0, 0.3])],
            seed=2),
        # frame 1's fx = 0: dx = +-inf, NaN in the centre column (0 / 0), so
        # every direction holds a NaN (inf * 0 in the z row); frame 0 is plain
        "nan_direction": _nan_direction_case(view),
        # frame 0, fx = 1e-11 on a horizontal camera: the centre column's rays
        # are ordinary (dx = 0), the 10 on each side beside it far larger and
        # the rest beyond 2^40 in x, so the fast path and the exact path for
        # range share warps; frame 1, R[1][0] = +inf: the centre column NaN
        # in y (0 * inf), the rest +-inf, the exact path for NaN and range
        "mixed_routes": _mixed_routes_case(),
        # a box on the backward line of sight, mirrored by an equal box in
        # front: equal |t| of opposite signs, the one behind first in index
        # order, so its tmax <= 0 must reject it
        "behind_and_front": _case(
            [[[-0.4, -3.4, 0.6], [0.4, -2.6, 1.4]], [[-0.4, 2.6, 0.6], [0.4, 3.4, 1.4]]],
            [_horizontal([0.0, 0.0, 1.0]), _look([0.0, 0.01, 1.0], [0.0, 3.0, 1.0])], seed=3),
    }
    return cases


def _nan_direction_case(view) -> Case:
    case = _case([_BOX, [[1.0, 1.0, 0.0], [1.5, 1.5, 0.5]]],
                 [view, _look([0.1, -2.8, 1.2], [0.0, 0.0, 0.4])], seed=4)
    case["intrinsics"][1, 0, 0] = 0.0
    return case


def _mixed_routes_case() -> Case:
    inf_x = _horizontal([0.5, -0.5, 0.7])
    inf_x[1, 0] = np.inf
    case = _case([[[-0.4, 2.0, 0.5], [0.4, 3.0, 1.5]], [[-9.0, 4.0, 0.0], [9.0, 5.0, 1.2]],
                  [[2.0, -1.0, 0.0], [3.0, 1.0, 2.0]]],
                 [_horizontal([0.0, 0.0, 1.0]), inf_x], seed=5)
    case["intrinsics"][0, 0, 0] = np.float32(1e-11)
    return case


def random_frames(n: int, image_hw=(_H, _W), num_boxes: int = 12, seed: int = 0) -> Case:
    """``n`` frames of ``num_boxes`` random boxes (corners in either order
    on an axis, some under the floor) seen by cameras of random position
    (three in four looking at a box, rolled at random, the fourth of any
    rotation) and random focal lengths: log-uniform over 1e-2..1e7 pixels,
    and every eighth frame one of the extremes 1e-10 (directions beyond the
    kernel's range), 1e-2 and 1e9 (nearly parallel rays)."""
    rng = np.random.default_rng(seed)
    h, w = image_hw
    lo = rng.uniform([-4, -4, -0.5], [4, 4, 1.5], (num_boxes, 3))
    size = rng.uniform(0.05, 1.5, (num_boxes, 3))
    boxes = np.stack([lo, lo + size], axis=1)
    flip = rng.random((num_boxes, 3)) < 0.2
    boxes[:, 0][flip], boxes[:, 1][flip] = boxes[:, 1][flip], boxes[:, 0][flip].copy()
    poses = np.zeros((n, 4, 4), np.float32)
    intr = np.zeros((n, 3, 3), np.float32)
    extremes = (1e-10, 1e-2, 1e9)
    for f in range(n):
        eye = rng.uniform([-5, -5, 0.2], [5, 5, 3])
        if f % 4 == 3:  # any rotation at all
            q, r = np.linalg.qr(rng.standard_normal((3, 3)))
            rot = q * np.sign(np.diag(r))
            rot[:, 0] *= np.sign(np.linalg.det(rot))
        else:  # looking at a box, rolled about the line of sight
            rot = _look(eye, boxes[rng.integers(num_boxes)].mean(axis=0))[:3, :3]
            a = rng.uniform(0, 2 * np.pi)
            roll = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
            rot = rot @ roll
        poses[f, :3, :3] = rot
        poses[f, :3, 3] = eye
        poses[f, 3, 3] = 1.0
        fx, fy = (extremes[(f // 8) % 3],) * 2 if f % 8 == 7 else 10 ** rng.uniform(-2, 7, 2)
        intr[f] = [[fx, 0, rng.uniform(0, w - 1)], [0, fy, rng.uniform(0, h - 1)], [0, 0, 1]]
    perms = np.stack([rng.permutation(num_boxes) + 1 for _ in range(n)]).astype(np.int32)
    return {"boxes": boxes, "poses": poses, "intrinsics": intr, "perms": perms,
            "image_hw": (h, w)}


RENDER_CASES: Dict[str, Case] = _cases()
