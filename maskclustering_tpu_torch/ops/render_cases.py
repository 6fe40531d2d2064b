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
    }
    return cases


RENDER_CASES: Dict[str, Case] = _cases()
